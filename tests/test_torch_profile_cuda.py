"""The self-join on the card: the matrix profile, the pruned profile and
the stream profile through the sDTW kernels' column ban, against the
same calls on the CPU.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_profile_cuda.py``. Imports no JAX. The same inputs, made
from a numpy seed, go through the port on the card (the hand-written
kernels with the ban) and on the CPU (the row scan, which the CPU tests
hold against the JAX package).

Tolerances: int32 bitwise in every ``ProfileResult`` field, the pruning
counters included; the float32 case is integer-valued, so bitwise too.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.matsa_api import matsa
from repro_torch.kernels.sdtw import LAUNCHES, reset_launches, tuned_launch
from repro_torch.kernels.sdtw.ops import sm_count
from repro_torch.search import ProfileResult, matrix_profile
from repro_torch.search.profile import profile_batch
from repro_torch.stream import StreamProfile, StreamSession

pytestmark = pytest.mark.cuda
FIELDS = [f.name for f in dataclasses.fields(ProfileResult)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _same(got, want, fields=FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)


def _only(key):
    """Every launch since the reset was ``key``, at least one."""
    torch.cuda.synchronize()
    assert LAUNCHES[key] >= 1, LAUNCHES
    assert sum(LAUNCHES.values()) == LAUNCHES[key], LAUNCHES


def level_shifted(rng, m, seg, dtype=np.int32):
    levels = rng.integers(-1500, 1500, -(-m // seg))
    return np.concatenate([lvl + rng.normal(0, 40, seg)
                           for lvl in levels])[:m].astype(dtype)


@pytest.mark.parametrize("window,m,stride,dtype,key", [
    (24, 3000, 5, np.int32, "rows_lastrow_ban"),
    (512, 20_000, 512, np.int32, "chain_lastrow_ban"),   # 39 windows
    (40, 2500, 7, np.float32, "rows_lastrow_ban"),
    (1600, 9000, 800, np.int32, "chain_lastrow_ban"),
    (2048, 14_000, 1024, np.int32, "chain_lastrow_ban"),
    (8400, 20_000, 4000, np.int32, "wavefront_lastrow_ban"),
])
def test_self_join_on_the_card_equals_cpu(window, m, stride, dtype, key,
                                          cuda):
    """``matsa(mode='self_join')`` routes through the exact profile; on
    the card every launch is the kernel's last-row capture with the ban,
    and the profile is bitwise the CPU's at the card's batch
    (``profile_batch``), the chunk counters included."""
    rng = np.random.default_rng(window + m)
    series = rng.integers(-50, 50, m).astype(dtype)
    series[m // 3:m // 3 + window] = series[100:100 + window]
    reset_launches()
    got = matsa(series, mode="self_join", window=window, stride=stride,
                device=cuda)
    _only(key)
    prof = got.profile
    batch = profile_batch(len(prof.starts), window, prof.chunk,
                          exact_kernel=True)
    want = matrix_profile(series, window, stride=stride, prune=False,
                          batch=batch, device="cpu")
    _same(prof, want)
    np.testing.assert_array_equal(got.distances.cpu().numpy(), want.nn_dist)
    assert got.distances.device.type == "cuda"


def test_batch_does_not_change_the_exact_profile(cuda):
    rng = np.random.default_rng(1)
    series = rng.integers(-50, 50, 6000).astype(np.int32)
    kw = dict(stride=16, prune=False, k=3, device=cuda)
    small = matrix_profile(series, 64, batch=32, **kw)
    whole = matrix_profile(series, 64, batch=4096, **kw)
    for f in FIELDS:
        if not f.startswith("chunks_"):
            np.testing.assert_array_equal(getattr(small, f),
                                          getattr(whole, f), err_msg=f)


def test_self_join_takes_one_rows_batch_on_the_card(cuda):
    """3,118 windows of 512, past the 12 an SM that switch the chain
    kernel for the rows kernel: ``matsa(mode='self_join')`` runs them in
    one batch, one rows K3 launch with the ban a chunk, bitwise the
    ``batch=256`` profile (13 batches, each a launch a chunk)."""
    rng = np.random.default_rng(512)
    series = rng.integers(-50, 50, 200_000).astype(np.int32)
    reset_launches()
    got = matsa(series, mode="self_join", window=512, stride=64,
                device=cuda).profile
    _only("rows_lastrow_ban")
    nw, n_chunks = len(got.starts), -(-200_000 // got.chunk)
    assert nw == 3118 and LAUNCHES["rows_lastrow_ban"] == n_chunks
    kernel = tuned_launch(256, 512, got.chunk, sms=sm_count(),
                          variant="lastrow", ban=True,
                          tune="model")[0]["kernel"]
    reset_launches()
    want = matrix_profile(series, 512, stride=64, prune=False, batch=256,
                          device=cuda)
    _only(f"{kernel}_lastrow_ban")
    assert LAUNCHES[f"{kernel}_lastrow_ban"] == -(-nw // 256) * n_chunks
    _same(got, want, [f for f in FIELDS if not f.startswith("chunks_")])


def test_pruned_profile_on_the_card_equals_cpu(cuda):
    """The pruned profile on a level-shifted series: on the card it scores
    surviving halo groups through the kernel with the ban; its counters
    and fields are bitwise the CPU's, its distances the exact profile's,
    and chunks prune."""
    rng = np.random.default_rng(2)
    series = level_shifted(rng, 12_000, 2000)
    kw = dict(stride=48, k=3, chunk=512, batch=64)
    reset_launches()
    got = matrix_profile(series, 48, device=cuda, **kw)
    _only("rows_lastrow_ban")
    _same(got, matrix_profile(series, 48, device="cpu", **kw))
    assert got.chunks_pruned > 0
    exact = matrix_profile(series, 48, prune=False, device=cuda, **kw)
    np.testing.assert_array_equal(got.nn_dist, exact.nn_dist)


@pytest.mark.parametrize("window,key", [(16, "rows_lastrow_ban"),
                                        (1600, "chain_lastrow_ban")])
def test_stream_profile_on_the_card_equals_cpu(window, key, cuda):
    """Ragged feeding with a mid-stream flush: each tile step is one
    kernel launch with the ban; the profile is the exact batch profile's
    on the card and, for the short window, the CPU stream's, bitwise (the
    long window's CPU stream would take minutes of host time)."""
    rng = np.random.default_rng(window)
    m = 6000 if window == 16 else 5000
    series = rng.integers(-40, 40, m).astype(np.int32)
    stride = 8 if window == 16 else 600
    chunk = 256 if window == 16 else 2048
    cuts = [0, 700, 1701, 2222, 4100, m]
    streams = {}
    for dev in (cuda, "cpu") if window == 16 else (cuda,):
        sp = StreamProfile(window, stride=stride, k=2, chunk=chunk,
                           device=dev)
        reset_launches()
        for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
            sp.feed(series[a:b])
            if i == 2:
                sp.flush()
        streams[str(dev)] = sp.results()
        if dev is cuda:
            _only(key)
    if "cpu" in streams:
        _same(streams["cuda"], streams["cpu"])
    batch = matrix_profile(series, window, stride=stride, k=2, chunk=chunk,
                           prune=False, device=cuda)
    for f in ("nn_dist", "nn_start", "nn_end", "motif_a", "discord_idx"):
        np.testing.assert_array_equal(getattr(streams["cuda"], f),
                                      getattr(batch, f), err_msg=f)


@pytest.mark.parametrize("spans", [False, True])
@pytest.mark.parametrize("n", [12, 1600])
def test_engine_exclusion_takes_the_kernel(spans, n, cuda):
    """``engine.sdtw`` with exclusion ranges on the card (dispatch rule 3)
    launches the ban variant and equals the CPU; an explicit
    ``impl='pallas'`` still refuses the ranges, as in the reference."""
    rng = np.random.default_rng(n)
    r = rng.integers(-50, 50, 3 * n + 500).astype(np.int32)
    starts = np.array([0, n // 2, n, 2 * n])
    q = np.stack([r[s:s + n] for s in starts])
    lo = np.maximum(starts - n // 2, 0)
    hi = starts + n + n // 2
    kernel = tuned_launch(4, n, len(r), sms=sm_count(),
                          variant="span" if spans else "plain", ban=True,
                          tune="model")[0]["kernel"]     # the default
    reset_launches()
    got = engine.sdtw(q, r, excl_lo=lo, excl_hi=hi, return_spans=spans,
                      return_positions=not spans, device=cuda)
    _only(f"{kernel}_{'span' if spans else 'plain'}_ban")
    want = engine.sdtw(q, r, excl_lo=lo, excl_hi=hi, return_spans=spans,
                       return_positions=not spans, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    with pytest.raises(ValueError, match="exclusion"):
        engine.sdtw(q, r, excl_lo=lo, excl_hi=hi, impl="pallas",
                    device=cuda)


@pytest.mark.parametrize("n,m", [(12, 312), (1600, 1900), (1600, 4000),
                                 (8400, 8700)])
def test_fully_banned_query_ends_at_column_0_on_the_card(n, m, cuda):
    """A query banned on every column: distance BIG and the end and start
    of the route the CPU (and the reference) takes for the shape — 0 on
    the row scan (M >= 2N), -1 on the wavefront schedule (M < 2N) — on
    each of the three kernels ``"auto"`` takes. Both run with
    ``tune='off'``, whose rules 5-6 are the M-against-2N rule."""
    rng = np.random.default_rng(n + m)
    r = rng.integers(-50, 50, m).astype(np.int32)
    q = np.stack([r[:n], r[100:100 + n]])
    lo = np.array([0, 0], np.int32)
    hi = np.array([2**31 - 1, 50], np.int32)
    kernel = "rows" if n <= 1536 else "chain" if n <= 8192 else "wavefront"
    reset_launches()
    got = engine.sdtw(q, r, excl_lo=lo, excl_hi=hi, return_spans=True,
                      device=cuda, tune="off")
    _only(f"{kernel}_span_ban")
    want = engine.sdtw(q, r, excl_lo=lo, excl_hi=hi, return_spans=True,
                       device="cpu", tune="off")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    end = 0 if m >= 2 * n else -1
    assert int(got[0][0]) == 2**29 and int(got[1][0]) == int(got[2][0]) == end


def test_ragged_list_takes_the_kernel_without_a_ban(cuda):
    """A ragged list passes exclusion arrays of -1: on the card every
    bucket runs the kernel, its instantiation without a ban."""
    rng = np.random.default_rng(9)
    r = rng.integers(-50, 50, 900).astype(np.int32)
    qs = [rng.integers(-50, 50, n).astype(np.int32) for n in (5, 20, 33)]
    reset_launches()
    got = engine.sdtw(qs, r, return_spans=True, device=cuda)
    _only("rows_span")
    want = engine.sdtw(qs, r, return_spans=True, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_stream_session_exclusion_takes_the_kernel(cuda):
    """``engine.stream`` with exclusion ranges: ``impl='auto'`` on the
    card is the kernel with the ban, bitwise the row-scan session's; an
    explicit ``impl='pallas'`` refuses them."""
    rng = np.random.default_rng(4)
    r = rng.integers(-60, 60, 3000).astype(np.int32)
    q = np.stack([r[200:240], r[1700:1740], r[2500:2540]])
    kw = dict(top_k=2, return_spans=True, chunk=512,
              excl_lo=np.array([150, 1650, 0]),
              excl_hi=np.array([300, 1800, 10]), device=cuda)
    auto = engine.stream(q, **kw)
    assert auto.impl == "pallas"
    reset_launches()
    for off in range(0, 3000, 700):
        auto.feed(r[off:off + 700])
    got = auto.results()
    _only("rows_lastrow_ban")
    plain = engine.stream(q, impl="rowscan", **kw)
    for off in range(0, 3000, 700):
        plain.feed(r[off:off + 700])
    want = plain.results()
    for f in ("distances", "starts", "positions"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError, match="exclusion"):
        engine.stream(q, impl="pallas", **kw)


@pytest.mark.parametrize("kw", [
    dict(top_k=2, return_spans=True),
    dict(return_spans=True),
    dict(),
    dict(top_k=2, prune=True, return_spans=True),
], ids=["topk", "spans", "plain", "pruned"])
def test_banned_session_snapshot_restores_onto_the_kernel(kw, cuda):
    """A kernel session with exclusion ranges snapshots in the row scan's
    layout (``impl='rowscan'``, the one the reference restores with its
    ranges); restored on the card it runs the kernel with the ban again,
    restored on the CPU the row scan, and both continue bitwise equal to
    the session that was never interrupted."""
    import json
    rng = np.random.default_rng(5)
    r = rng.integers(-60, 60, 3000).astype(np.int32)
    q = np.stack([r[200:240], r[1700:1740], r[2500:2540]])
    kw = dict(kw, chunk=512, excl_lo=np.array([150, 1650, 0]),
              excl_hi=np.array([300, 1800, 10]))
    whole = engine.stream(q, device=cuda, **kw)
    for off in range(0, 3000, 700):
        whole.feed(r[off:off + 700])
    src = engine.stream(q, device=cuda, **kw)
    src.feed(r[:1400])
    snap = src.snapshot()
    meta = json.loads(str(snap["meta"]))
    assert (meta["impl"], meta["auto"]) == ("rowscan", True)
    for dev, impl in ((cuda, "pallas"), ("cpu", "rowscan")):
        dst = StreamSession.restore(snap, device=dev)
        assert dst.impl == impl
        reset_launches()
        for off in range(1400, 3000, 700):
            dst.feed(r[off:off + 700])
        torch.cuda.synchronize()
        key = ("rows_lastrow_ban" if kw.get("top_k")
               else "rows_span_ban" if kw.get("return_spans")
               else "rows_plain_ban")
        if impl == "pallas" and not kw.get("prune"):
            _only(key)
        else:          # a pruned session may skip every tile of this feed
            assert sum(LAUNCHES.values()) == LAUNCHES[key], LAUNCHES
            assert impl == "pallas" or LAUNCHES[key] == 0
        got, want = dst.results(), whole.results()
        for f in ("distances", "starts", "positions"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f
            if w is not None:
                np.testing.assert_array_equal(g, w, err_msg=f)
