"""Streaming sessions on the card: the kernel route against the plain
route on the same card.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_stream_cuda.py``. Imports no JAX. The same inputs, made
from a numpy seed, stream through ``impl='pallas'`` sessions (the
hand-written kernel's chunk carry and last-row capture) and
``impl='rowscan'`` sessions (the plain PyTorch row scan), both on the
card, fed in pieces that are not multiples of the tile.

Tolerances: int32 bitwise — heaps, spans, tile counters, alerts and
snapshots. The float32 case is integer-valued, so it is bitwise too.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.kernels.sdtw import LAUNCHES, reset_launches
from repro_torch.stream import StreamSession

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _feed(s, r, piece):
    for off in range(0, len(r), piece):
        s.feed(r[off:off + piece])
    return s


def _same(got, want):
    for f in ("distances", "starts", "positions"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=f)
    for c in ("samples", "tiles_total", "tiles_pruned_kim",
              "tiles_pruned_keogh", "tiles_processed"):
        assert getattr(got, c) == getattr(want, c), c


def _events(s):
    return [(e.query, e.distance, e.start, e.end, e.tile_start, e.tile_end,
             e.hits) for e in s.alerts]


MODES = [
    dict(return_spans=True),
    dict(return_positions=True),
    dict(top_k=3, return_spans=True),
    dict(top_k=2, excl_mode="span", return_spans=True, excl_zone=4),
    dict(top_k=3, return_spans=True, alert_threshold=400),
    dict(alert_threshold=300),
    dict(top_k=2, prune=True, return_spans=True),
]


#: Every mode at N = 12 and 120 (rows kernel); three at N = 1600 (the
#: chain kernel), where the plain route's 1600-row scan is slow.
CASES = ([(n, kw) for n in (12, 120) for kw in MODES]
         + [(1600, MODES[i]) for i in (0, 2, 6)])


@pytest.mark.parametrize("n,kw", CASES,
                         ids=[f"{n}-{'-'.join(kw)}" for n, kw in CASES])
def test_stream_kernel_route_equals_plain_route(n, kw, cuda):
    rng = np.random.default_rng(n)
    m = 3000 if n < 1600 else 1800
    levels = rng.integers(-1500, 1500, m // 250 + 1)
    r = np.concatenate([lvl + rng.normal(0, 40, 250) for lvl in levels]
                       )[:m].astype(np.int32)
    q = np.stack([r[s:s + n] + rng.integers(-3, 4, n)
                  for s in rng.integers(0, m - n, 3)]).astype(np.int32)
    chunk = 256 if n < 1600 else 1024
    reset_launches()
    got = _feed(engine.stream(q, chunk=chunk, impl="pallas", device=cuda,
                              **kw), r, 333)
    res = got.results()
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) >= 1, LAUNCHES
    if kw.get("top_k") or kw.get("alert_threshold") is not None:
        kernel = "rows" if n <= 1536 else "chain"
        assert LAUNCHES[f"{kernel}_lastrow"] >= 1, LAUNCHES
    reset_launches()
    want = _feed(engine.stream(q, chunk=chunk, impl="rowscan", device=cuda,
                               **kw), r, 333)
    assert sum(LAUNCHES.values()) == 0
    _same(res, want.results())
    assert _events(got) == _events(want)
    if not kw.get("prune"):
        got.flush()
        want.flush()
        _same(got.results(), want.results())


@pytest.mark.parametrize("n,kernel,block_q", [(40, "rows", 2),
                                              (1600, "chain", 1)])
def test_stream_auto_snapshot_and_block_args_on_the_card(n, kernel, block_q,
                                                         cuda):
    """``impl='auto'`` on the card is the kernel; a snapshot restores on
    the CPU (the plain version) and back on the card and continues
    bitwise; ``block_q``/``block_m`` are accepted on a rows- and on a
    chain-kernel session (``block_m`` is the wavefront's tile and is not
    passed to their launches)."""
    rng = np.random.default_rng(5)
    r = rng.integers(-60, 60, 5000).astype(np.int32)
    q = rng.integers(-60, 60, (4, n)).astype(np.int32)
    kw = dict(chunk=512, top_k=3, return_spans=True, block_q=block_q,
              block_m=64)
    s = engine.stream(q, device=cuda, **kw)
    assert s.impl == "pallas"
    reset_launches()
    s.feed(r[:2100])
    assert LAUNCHES[f"{kernel}_lastrow"] == 4
    on_cpu = StreamSession.restore(s.snapshot(), device="cpu")
    back = StreamSession.restore(on_cpu.snapshot(), device=cuda)
    for sess in (s, on_cpu, back):
        sess.feed(r[2100:])
    _same(on_cpu.results(), s.results())
    _same(back.results(), s.results())
    whole = engine.sdtw(q, r, return_spans=True, device=cuda)
    np.testing.assert_array_equal(s.results().distances[:, 0],
                                  whole[0].cpu().numpy())
    np.testing.assert_array_equal(s.results().starts[:, 0],
                                  whole[1].cpu().numpy())
    np.testing.assert_array_equal(s.results().positions[:, 0],
                                  whole[2].cpu().numpy())


def test_stream_float32_integer_valued(cuda):
    rng = np.random.default_rng(11)
    r = rng.integers(-60, 60, 2000).astype(np.float32)
    q = rng.integers(-60, 60, (5, 33)).astype(np.float32)
    kw = dict(chunk=300, top_k=2, return_spans=True, metric="square_diff")
    got = _feed(engine.stream(q, impl="pallas", device=cuda, **kw), r, 777)
    want = _feed(engine.stream(q, impl="rowscan", device=cuda, **kw), r, 777)
    _same(got.results(), want.results())
