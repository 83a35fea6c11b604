"""repro_torch.stream (online sessions) against the JAX package.

Mirrors ``tests/test_stream.py``: any partition of the reference fed through a port
session reproduces the offline answer bitwise (int32), including ragged
batches, prune on/off, polling, flushes, alerts, snapshot/restore — and
snapshots move between the two packages in both directions. The port
runs with ``device="cpu"`` (``impl='pallas'`` is the kernel's plain
version there); the reference's Pallas sessions run in interpret mode.

Tolerances: int32 bitwise everywhere. The float32 inputs are
integer-valued, so every sum is exact and float32 is bitwise too.
"""
import json
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdtw as jsdtw
from repro.core import stream as jstream
from repro.core.sdtw import sdtw_chunked as jsdtw_chunked
from repro.search import EnvelopeCache as JEnvelopeCache
from repro.stream import StreamSession as JStreamSession
from repro_torch.core import engine as tengine
from repro_torch.search import EnvelopeCache, chunk_envelope, search_topk
from repro_torch.stream import AlertEvent, StreamSession

GOLDEN = pathlib.Path(__file__).parent / "golden" / "sdtw_stream_v1.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def stream(q, **kw):
    return tengine.stream(q, device="cpu", **kw)


def sdtw(*a, **kw):
    return tengine.sdtw(*a, device="cpu", **kw)


def _feed(session, reference, parts):
    off = 0
    for p in parts:
        session.feed(np.asarray(reference)[off:off + p])
        off += p
    assert off == len(reference)
    return session


def _same(got, want, fields=("distances", "starts", "positions")):
    """Two StreamResults (either package) agree bitwise."""
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)
    for c in ("samples", "tiles_total", "tiles_pruned_kim",
              "tiles_pruned_keogh", "tiles_processed"):
        assert getattr(got, c) == getattr(want, c), c


def _equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))


#: Partitions of a 257-sample reference that stress every boundary case:
#: one shot, tile-aligned, single samples, tiny head, unaligned runs.
PARTITIONS_257 = [[257], [32] * 8 + [1], [1] * 257, [3, 254],
                  [100, 100, 57], [64, 1, 64, 1, 127]]


@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_stream_spans_match_engine_any_partition(metric, dtype, rng):
    """Distances/starts/ends equal the reference's offline engine bitwise
    for every partition, on both impls."""
    q = rng.integers(-40, 40, (4, 10)).astype(dtype)
    r = rng.integers(-40, 40, 257).astype(dtype)
    want = [np.asarray(x) for x in jsdtw(jnp.asarray(q), jnp.asarray(r),
                                         metric=metric, return_spans=True)]
    for impl in ("rowscan", "pallas"):
        for parts in PARTITIONS_257[:4] if impl == "rowscan" \
                else PARTITIONS_257[4:]:
            res = _feed(stream(q, metric=metric, chunk=32, impl=impl,
                               return_spans=True), r, parts).results()
            _equal((res.distances, res.starts, res.positions), want)


@pytest.mark.parametrize("excl_mode", ["end", "span"])
def test_stream_topk_matches_offline(excl_mode, rng):
    """The streamed heap equals the reference's offline chunked top-K
    bitwise (and the port's ``search_topk(prune=False)``), on both
    impls, both suppression modes."""
    q = rng.integers(-8, 8, (3, 8)).astype(np.int32)   # tie-heavy range
    r = rng.integers(-8, 8, 257).astype(np.int32)
    want = [np.asarray(x) for x in jsdtw_chunked(
        jnp.asarray(q), jnp.asarray(r), chunk=32, top_k=3, excl_zone=4,
        excl_mode=excl_mode, return_spans=True)]
    sr = search_topk(q, r, k=3, chunk=32, excl_zone=4, excl_mode=excl_mode,
                     prune=False, device="cpu")
    np.testing.assert_array_equal(_np(sr.distances), want[0])
    for impl, parts in (("rowscan", [257]), ("rowscan", [13] * 19 + [10]),
                        ("pallas", [200, 57])):
        res = _feed(stream(q, chunk=32, top_k=3, excl_zone=4, impl=impl,
                           excl_mode=excl_mode, return_spans=True),
                    r, parts).results()
        _equal((res.distances, res.starts, res.positions), want)


def test_stream_results_polling_is_nondestructive(rng):
    """results() applies the buffered tail to a copy: each poll equals the
    offline answer over the samples seen so far."""
    q = rng.integers(-20, 20, (2, 6)).astype(np.int32)
    r = rng.integers(-20, 20, 90).astype(np.int32)
    for impl in ("rowscan", "pallas"):
        s = stream(q, chunk=16, impl=impl, return_spans=True)
        seen = 0
        for p in (7, 20, 3, 40, 20):
            s.feed(r[seen:seen + p])
            seen += p
            res = s.results()
            _equal((res.distances, res.starts, res.positions),
                   sdtw(q, r[:seen], return_spans=True))
            assert res.samples == seen


def test_stream_flush_midstream_keeps_streaming(rng):
    """A destructive mid-stream flush (carry exits at the true boundary)
    leaves distances/spans exact afterwards, on both impls."""
    q = rng.integers(-20, 20, (3, 7)).astype(np.int32)
    r = rng.integers(-20, 20, 123).astype(np.int32)
    want = sdtw(q, r, return_spans=True)
    for impl in ("rowscan", "pallas"):
        s = stream(q, chunk=16, impl=impl, return_spans=True)
        s.feed(r[:37]).flush()          # mid-tile boundary
        s.feed(r[37:41]).flush()        # tiny follow-up
        s.feed(r[41:])
        res = s.results()
        _equal((res.distances, res.starts, res.positions), want)


def test_stream_pallas_path_matches(rng):
    """The kernel feed path (carry entry/exit with ref_len) equals the
    offline engine bitwise, block arguments included; a positions-only
    session too."""
    q = rng.integers(-10, 10, (3, 8)).astype(np.int32)
    r = rng.integers(-10, 10, 137).astype(np.int32)
    want = sdtw(q, r, return_spans=True)
    for parts in ([137], [50, 50, 37], [9] * 15 + [2]):
        res = _feed(stream(q, chunk=32, impl="pallas", return_spans=True,
                           block_q=2, block_m=64), r, parts).results()
        _equal((res.distances, res.starts, res.positions), want)
    s = _feed(stream(q, chunk=32, impl="pallas", return_positions=True,
                     block_q=2, block_m=64), r, [137])
    res = s.results()
    _equal((res.distances, res.positions), (want[0], want[2]))
    assert res.starts is None


def test_pruned_stream_equals_exact(rng):
    """Online LB pruning skips tiles yet the heap equals the exact
    streamed heap, on both impls (the pruning counters are held to the
    reference's by ``test_snapshot_restores_across_packages``)."""
    q = rng.integers(-5, 5, (2, 8)).astype(np.int32)
    r = np.full(512, 1000, np.int32)
    r[40:60] = rng.integers(-5, 5, 20)
    r[100:130] = rng.integers(-6, 6, 30)
    r[400:420] = rng.integers(-5, 5, 20)
    want = sdtw(q, r, chunk=32, top_k=2, return_spans=True)
    parts = [50] * 10 + [12]
    for impl in ("rowscan", "pallas"):
        res = _feed(stream(q, chunk=32, top_k=2, return_spans=True,
                           prune=True, impl=impl), r, parts).results()
        assert res.tiles_pruned > 0, "workload built to prune, but nothing was"
        assert res.tiles_processed < res.tiles_total
        _equal((res.distances, res.starts, res.positions), want)


def test_pruned_stream_extends_envelope_cache(rng):
    """The streamed per-tile envelope lands in the shared cache: an
    offline ``search_topk`` afterwards hits it, and it is bitwise what
    ``chunk_envelope`` computes."""
    q = rng.integers(-30, 30, (2, 8)).astype(np.int32)
    r = rng.integers(-30, 30, 300).astype(np.int32)
    cache = EnvelopeCache()
    s = stream(q, chunk=32, top_k=2, prune=True, cache=cache,
               ref_key="live-ecg")
    _feed(s, r, [90, 90, 120]).flush()
    env = cache.peek(("live-ecg", False), 32)
    mins, maxs = chunk_envelope(r, 32)
    _equal(env, (mins, maxs))
    hits0 = cache.hits
    sr = search_topk(q, r, k=2, chunk=32, cache=cache, ref_key="live-ecg",
                     device="cpu")
    assert cache.hits == hits0 + 1
    np.testing.assert_array_equal(s.results().distances, _np(sr.distances))


def test_pruned_restore_into_fresh_cache_keeps_full_envelope(rng):
    """Restoring a pruned session into a fresh cache installs the whole
    streamed envelope prefix, not a mid-stream continuation."""
    q = rng.integers(-30, 30, (2, 8)).astype(np.int32)
    r = rng.integers(-30, 30, 192).astype(np.int32)
    s1 = stream(q, chunk=32, top_k=2, prune=True, cache=EnvelopeCache(),
                ref_key="ft")
    s1.feed(r[:96])
    fresh = EnvelopeCache()                 # "new process"
    s2 = StreamSession.restore(s1.snapshot(), cache=fresh, device="cpu")
    s2.feed(r[96:]).flush()
    _equal(fresh.peek(("ft", False), 32), chunk_envelope(r, 32))


def test_envelope_cache_survives_restreams_and_partial_streams(rng):
    """(a) A second monitor on the same ref_key must not double the entry;
    (b) an entry from a stream that stopped mid-reference must not gate
    an offline search over the full reference."""
    q = rng.integers(-30, 30, (2, 8)).astype(np.int32)
    r = rng.integers(-30, 30, 192).astype(np.int32)
    cache = EnvelopeCache()
    for _ in range(2):
        _feed(stream(q, chunk=32, top_k=2, prune=True, cache=cache,
                     ref_key="mon"), r, [192]).flush()
    assert len(cache.peek(("mon", False), 32)[0]) == 6     # not 12
    want = search_topk(q, r, k=2, chunk=32, prune=False, device="cpu")
    ok = search_topk(q, r, k=2, chunk=32, cache=cache, ref_key="mon",
                     device="cpu")
    np.testing.assert_array_equal(_np(ok.distances)[:, 0],
                                  _np(want.distances)[:, 0])
    cache2 = EnvelopeCache()
    s = stream(q, chunk=32, top_k=2, prune=True, cache=cache2,
               ref_key="half")
    s.feed(r[:96])
    assert len(cache2.peek(("half", False), 32)[0]) == 3
    res = search_topk(q, r, k=2, chunk=32, cache=cache2, ref_key="half",
                      device="cpu")
    np.testing.assert_array_equal(_np(res.distances)[:, 0],
                                  _np(want.distances)[:, 0])
    assert len(cache2.peek(("half", False), 32)[0]) == 6


def test_pruned_ragged_tile_telemetry_adds_up(rng):
    """Per-tile counters: pruned + processed == total even when ragged
    buckets disagree on whether a tile was worth the DP."""
    qs = [rng.integers(-5, 5, 4).astype(np.int32),
          rng.integers(-5, 5, 20).astype(np.int32)]
    r = np.full(512, 1000, np.int32)
    r[100:140] = rng.integers(-5, 5, 40)
    res = _feed(stream(qs, chunk=32, top_k=2, prune=True), r,
                [128] * 4).results()
    assert res.tiles_total == 16
    assert res.tiles_pruned + res.tiles_processed == res.tiles_total
    r2 = _feed(stream(qs, chunk=32), r, [512]).results()
    assert r2.tiles_processed == r2.tiles_total == 16
    with pytest.raises(ValueError, match="track spans"):
        r2.spans


@pytest.mark.parametrize("impl", ["rowscan", "pallas"])
def test_alert_threshold_fires_on_planted_pattern(impl, rng):
    """Planting query 0 verbatim fires a distance-0 alert at the right end
    column, via the callback and the log, once per triggering tile; the
    events are the reference's."""
    q = rng.integers(-50, 50, (2, 10)).astype(np.int32)
    r = rng.integers(200, 400, 200).astype(np.int32)   # far from queries
    r[150:160] = q[0]
    events = []
    s = stream(q, chunk=25, alert_threshold=0, on_alert=events.append,
               impl=impl)
    _feed(s, r, [60] * 3 + [20]).flush()
    assert s.alerts == events and len(events) == 1
    ev = events[0]
    assert isinstance(ev, AlertEvent)
    assert ev.query == 0 and ev.distance == 0 and ev.end == 159
    assert ev.tile_start <= ev.end < ev.tile_end
    events2 = []
    s2 = stream(q, chunk=25, alert_threshold=0, on_alert=events2.append,
                return_spans=True, impl=impl)
    _feed(s2, r, [200]).flush()
    assert events2 and events2[0].start == 150 and events2[0].end == 159
    # A loose threshold: many hits per tile, the reference's events.
    loose = _feed(stream(q, chunk=25, alert_threshold=2500, impl=impl,
                         return_spans=True, top_k=2), r, [70, 130])
    jloose = _feed(jstream(q, chunk=25, alert_threshold=2500, impl="rowscan",
                           return_spans=True, top_k=2), r, [70, 130])
    assert len(loose.alerts) > 2
    assert [dataclass_tuple(e) for e in loose.alerts] == \
        [dataclass_tuple(e) for e in jloose.alerts]
    _same(loose.results(), jloose.results())


def dataclass_tuple(ev):
    return (ev.query, ev.distance, ev.start, ev.end, ev.tile_start,
            ev.tile_end, ev.hits)


def test_snapshot_npz_roundtrip(tmp_path, rng):
    """snapshot() → np.savez → np.load → restore() continues bit for bit,
    and still equals the offline answer."""
    q = [rng.integers(-20, 20, L).astype(np.int32) for L in (5, 11, 7)]
    r = rng.integers(-20, 20, 150).astype(np.int32)
    s1 = stream(q, chunk=16, top_k=2, return_spans=True)
    s1.feed(r[:70])
    path = tmp_path / "session.npz"
    np.savez(path, **s1.snapshot())
    s2 = StreamSession.restore(dict(np.load(path, allow_pickle=False)),
                               device="cpu")
    s1.feed(r[70:])
    s2.feed(r[70:])
    _same(s1.results(), s2.results())
    want = sdtw(q, r, chunk=16, top_k=2, return_spans=True)
    _equal((s2.results().distances, s2.results().positions),
           (want[0], want[2]))


CROSS = [  # (impl, session kwargs): plain and pruned on both impls
    ("rowscan", dict(top_k=2, return_spans=True)),
    ("pallas", dict(top_k=2, return_spans=True, alert_threshold=30)),
    ("rowscan", dict(top_k=2, prune=True, ref_key="torch-cross")),
    ("pallas", dict(top_k=2, prune=True, return_spans=True)),
]


@pytest.mark.parametrize("impl,kw", CROSS,
                         ids=[f"{i}-{'-'.join(k)}" for i, k in CROSS])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_restores_across_packages(impl, kw, direction, rng):
    """The two packages' sessions fed the same samples snapshot the same
    keys, meta and leaves, bitwise (kernel carry layout, mid-tile buffer
    and pruning ring included), and a snapshot taken by either restores
    into the other and continues bitwise."""
    q = rng.integers(-9, 9, (2, 6)).astype(np.int32)
    r = rng.integers(-9, 9, 90).astype(np.int32)
    r[40:46] = q[1]
    kw = dict(kw, chunk=16, impl=impl)
    jkw = dict(kw, cache=JEnvelopeCache())
    kw["cache"] = EnvelopeCache()
    jsrc = _feed(jstream(q, **jkw), r[:37], [20, 17])
    tsrc = _feed(stream(q, **kw), r[:37], [20, 17])
    jsnap = {k: np.asarray(v) for k, v in jsrc.snapshot().items()}
    tsnap = tsrc.snapshot()
    assert sorted(tsnap) == sorted(jsnap)
    assert json.loads(str(tsnap["meta"])) == json.loads(str(jsnap["meta"]))
    for key in jsnap:
        if key != "meta":
            assert tsnap[key].dtype == jsnap[key].dtype, key
            np.testing.assert_array_equal(tsnap[key], jsnap[key],
                                          err_msg=key)
    src, snap = ((jsrc, jsnap) if direction == "jax_to_torch"
                 else (tsrc, tsnap))
    if direction == "jax_to_torch":
        dst = StreamSession.restore(snap, device="cpu", cache=kw["cache"])
    else:
        dst = JStreamSession.restore(snap, cache=jkw["cache"])
    src.feed(r[37:])
    dst.feed(r[37:])
    _same(dst.results(), src.results())
    assert [dataclass_tuple(e) for e in dst.alerts] == \
        [dataclass_tuple(e) for e in src.alerts
         if e.tile_start >= 32]          # the restored session's own
    if direction == "jax_to_torch":
        _same(dst.results(), _feed(stream(q, **dict(
            kw, cache=EnvelopeCache())), r, [37, 53]).results())


def test_stream_argument_validation(rng):
    q = rng.integers(-5, 5, (2, 6)).astype(np.int32)
    with pytest.raises(ValueError, match="prune=True"):
        stream(q, prune=True)
    with pytest.raises(ValueError, match="alerts"):
        stream(q, top_k=2, prune=True, alert_threshold=1)
    with pytest.raises(ValueError, match="exclusion"):
        stream(q, impl="pallas", excl_lo=1, excl_hi=3)
    with pytest.raises(ValueError, match="excl_mode"):
        stream(q, excl_mode="span")
    with pytest.raises(ValueError, match="together"):
        stream(q, excl_lo=3)
    with pytest.raises(ValueError, match="chunk"):
        stream(q, chunk=0)
    with pytest.raises(ValueError, match="impl"):
        stream(q, impl="wavefront")
    with pytest.raises(ValueError, match="n_micro"):
        stream(q, n_micro=2)
    from repro_torch.distributed import get_mesh
    from repro_torch.stream import ShardedStreamSession
    for kw in (dict(impl="sharded"), dict(mesh=get_mesh()),
               dict(mesh_shape=(1, 1))):
        assert isinstance(stream(q, **kw), ShardedStreamSession)
    s = stream(q, chunk=8)
    with pytest.raises(ValueError, match="1-D"):
        s.feed(np.zeros((2, 3), np.int32))
    s.feed(np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="dtype"):
        s.feed(np.zeros(4, np.float32))
    s2 = stream(q, chunk=8, top_k=1, prune=True)
    s2.feed(rng.integers(-5, 5, 20).astype(np.int32)).flush()
    with pytest.raises(RuntimeError, match="finalized"):
        s2.feed(np.zeros(8, np.int32))


def test_stream_auto_impl_and_excl_ranges(rng):
    """``impl='auto'`` is the row-scan loop on the CPU (the kernel only on
    a CUDA device); per-query exclusion ranges run on it and equal the
    reference's chunked engine."""
    q = rng.integers(-9, 9, (3, 6)).astype(np.int32)
    r = rng.integers(-9, 9, 70).astype(np.int32)
    assert stream(q).impl == "rowscan"
    lo, hi = np.array([0, 10, 30], np.int32), np.array([5, 40, 31], np.int32)
    res = _feed(stream(q, chunk=16, top_k=2, excl_lo=lo, excl_hi=hi,
                       excl_zone=np.array([1, 2, 3]), return_spans=True),
                r, [30, 40]).results()
    _equal((res.distances, res.starts, res.positions),
           jsdtw(jnp.asarray(q), jnp.asarray(r), impl="chunked", chunk=16,
                 top_k=2, excl_lo=jnp.asarray(lo), excl_hi=jnp.asarray(hi),
                 excl_zone=jnp.asarray([1, 2, 3]), return_spans=True))


BANNED = [  # sessions that ban: every carry layout of either impl
    dict(top_k=2, return_spans=True, excl_zone=np.array([1, 2, 3])),
    dict(return_spans=True),
    dict(return_positions=True, alert_threshold=30),
    dict(),
    dict(top_k=2, excl_mode="span"),
    dict(top_k=2, prune=True, return_spans=True),
]


@pytest.mark.parametrize("kw", BANNED,
                         ids=["-".join(k) or "plain" for k in BANNED])
def test_kernel_route_with_bans_restores_across_packages(kw, rng,
                                                         monkeypatch):
    """A session that ``impl='auto'`` runs on the kernel with exclusion
    ranges (as on the card; its plain version here) snapshots in the row
    scan's layout under ``impl='rowscan'``: the reference restores it and
    honours the ranges, the port restores it onto the kernel again, and
    both continue bitwise equal to the reference fed every sample."""
    import repro_torch.search.search as search_mod
    monkeypatch.setattr(search_mod, "_auto_engine", lambda dev: "pallas")
    q = rng.integers(-9, 9, (3, 6)).astype(np.int32)
    r = rng.integers(-9, 9, 90).astype(np.int32)
    r[40:46] = q[1]                     # an exact match inside its ban
    lo, hi = np.array([0, 38, 70], np.int32), np.array([12, 50, 71], np.int32)
    kw = dict(kw, chunk=16, excl_lo=lo, excl_hi=hi)
    src = _feed(stream(q, cache=EnvelopeCache(), **kw), r[:37], [20, 17])
    assert src.impl == "pallas"
    assert all(b.ban is not None for b in src._buckets)
    snap = src.snapshot()
    meta = json.loads(str(snap["meta"]))
    assert (meta["impl"], meta["auto"]) == ("rowscan", True)
    want = _feed(jstream(q, impl="rowscan", cache=JEnvelopeCache(), **kw),
                 r, [37, 53])
    jdst = JStreamSession.restore(snap, cache=JEnvelopeCache())
    tdst = StreamSession.restore(snap, device="cpu", cache=EnvelopeCache())
    assert tdst.impl == "pallas"
    for dst, since in ((jdst, 32), (tdst, 32), (src, 0)):
        dst.feed(r[37:])
        _same(dst.results(), want.results())
        assert [dataclass_tuple(e) for e in dst.alerts] == \
            [dataclass_tuple(e) for e in want.alerts if e.tile_start >= since]
    # The port's restore on the CPU, where 'auto' is the row scan.
    monkeypatch.undo()
    cpu = StreamSession.restore(snap, device="cpu", cache=EnvelopeCache())
    assert cpu.impl == "rowscan"
    _same(cpu.feed(r[37:]).results(), want.results())


@pytest.mark.parametrize("impl", ["rowscan", "pallas"])
def test_golden_stream_bitwise(impl):
    """The committed streaming fixture ``sdtw_stream_v1.npz``, reproduced
    bitwise by the port's sessions alone."""
    from golden.make_golden import STREAM_PARTS
    g = np.load(GOLDEN)
    for tag in ("i32", "f32"):
        q, r = g[f"{tag}_queries"], g[f"{tag}_reference"]

        def run(**kw):
            return _feed(stream(q, chunk=32, impl=impl, **kw), r,
                         STREAM_PARTS).results()

        def check(res, prefix):
            for f, key in (("distances", "dists"), ("starts", "starts"),
                           ("positions", "ends")):
                np.testing.assert_array_equal(getattr(res, f),
                                              g[f"{tag}_{prefix}{key}"],
                                              err_msg=(tag, prefix, key))

        check(run(return_spans=True), "")
        for mode in ("end", "span"):
            check(run(top_k=3, excl_zone=5, excl_mode=mode,
                      return_spans=True), f"topk_{mode}_")
        check(run(top_k=3, excl_zone=5, prune=True, return_spans=True),
              "pruned_")


# ---------------------------------------------------------------------------
# Mid-stream flush on k>1 sessions: the boundary-shift caveat
# ---------------------------------------------------------------------------

FLUSH_SHIFT_Q = np.array([0, 4, 2, 2, 3, 1], np.int32)
FLUSH_SHIFT_R = np.array(
    [4, 0, 1, 1, 2, 2, 0, 0, 0, 0, 0, 4, 0, 3, 3, 1, 1, 2, 1, 4, 0, 4,
     3, 4, 0, 1, 3, 2, 3, 3, 3, 0, 4, 2, 4, 1, 1, 4, 0, 0, 1, 3, 0, 4,
     1, 1, 2, 4, 4, 4, 1, 0, 3, 3, 3, 0, 0, 2, 1, 2, 4, 1, 2, 1, 1],
    np.int32)
FLUSH_SHIFT_CUT = 2


def _flushed_session(k, impl="rowscan"):
    s = stream(FLUSH_SHIFT_Q[None, :], chunk=16, top_k=k, impl=impl)
    s.feed(FLUSH_SHIFT_R[:FLUSH_SHIFT_CUT])
    s.flush()                               # partial tile: boundaries shift
    return s


@pytest.mark.parametrize("impl", ["rowscan", "pallas"])
def test_stream_midflush_k3_warns_and_diverges_beyond_top1(impl):
    """The reference's pinned witness: feeding after a mid-stream flush on
    a k>1 session warns, top-1 stays exact, and an entry beyond top-1
    differs from the offline run — as it does in the reference."""
    off_d, off_p = (np.asarray(x)[0] for x in jsdtw(
        jnp.asarray(FLUSH_SHIFT_Q[None, :]), jnp.asarray(FLUSH_SHIFT_R),
        impl="chunked", chunk=16, top_k=3))
    s = _flushed_session(k=3, impl=impl)
    with pytest.warns(RuntimeWarning, match="mid-stream flush"):
        s.feed(FLUSH_SHIFT_R[FLUSH_SHIFT_CUT:])
    res = s.results()
    got_d, got_p = res.distances[0], res.positions[0]
    assert got_d[0] == off_d[0] and got_p[0] == off_p[0]   # top-1 exact
    np.testing.assert_array_equal(got_d, off_d)
    assert not np.array_equal(got_p, off_p), "witness regressed"


def test_stream_midflush_warns_once_then_stays_quiet():
    s = _flushed_session(k=2)
    with pytest.warns(RuntimeWarning, match="mid-stream flush"):
        s.feed(FLUSH_SHIFT_R[FLUSH_SHIFT_CUT:30])
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # a second warning would raise
        s.feed(FLUSH_SHIFT_R[30:])
        s.results()


def test_stream_midflush_k1_silent():
    """k=1 (and aligned flushes) are exact under any partition — no
    warning may fire."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = _flushed_session(k=1)
        s.feed(FLUSH_SHIFT_R[FLUSH_SHIFT_CUT:])
        s.results()
        s2 = stream(FLUSH_SHIFT_Q[None, :], chunk=16, top_k=2)
        s2.feed(FLUSH_SHIFT_R[:32])
        s2.flush()
        s2.feed(FLUSH_SHIFT_R[32:])


def test_stream_midflush_pending_survives_snapshot():
    s = _flushed_session(k=2)
    s2 = StreamSession.restore(s.snapshot(), device="cpu")
    with pytest.warns(RuntimeWarning, match="mid-stream flush"):
        s2.feed(FLUSH_SHIFT_R[FLUSH_SHIFT_CUT:])


def test_sharded_session_single_device_mesh(rng):
    """The sharded session's feed/harvest/carry-handback path on the
    default (one-rank) mesh — the degenerate pipeline, same protocol —
    against the JAX package's; the multi-rank checks are in
    ``tests/test_torch_distributed.py``."""
    from repro.stream import ShardedStreamSession as JSharded
    from repro_torch.stream import ShardedStreamSession
    q = rng.integers(-10, 10, (3, 6)).astype(np.int32)
    r = rng.integers(-10, 10, 97).astype(np.int32)
    s = stream(q, impl="sharded", chunk=8, top_k=2, return_spans=True)
    js = jstream(jnp.asarray(q), impl="sharded", chunk=8, top_k=2,
                 return_spans=True)
    for off in range(0, 97, 23):
        s.feed(r[off:off + 23])
        js.feed(r[off:off + 23])
    res = s.results()
    _same(res, js.results(), fields=("distances", "starts", "positions"))
    want = jsdtw(jnp.asarray(q), jnp.asarray(r), chunk=8, top_k=2,
                 return_spans=True)
    for f, w in zip(("distances", "starts", "positions"), want):
        np.testing.assert_array_equal(getattr(res, f), np.asarray(w))
    s2 = ShardedStreamSession.restore(s.snapshot(), device="cpu")
    np.testing.assert_array_equal(s2.results().distances, res.distances)
    js2 = JSharded.restore(s.snapshot())
    np.testing.assert_array_equal(np.asarray(js2.results().distances),
                                  res.distances)
    sp = stream(q, impl="sharded", chunk=8)
    sp.feed(r)
    np.testing.assert_array_equal(
        sp.results().distances,
        np.asarray(jsdtw(jnp.asarray(q), jnp.asarray(r), chunk=8,
                         impl="chunked")))
    s.flush()
    with pytest.raises(RuntimeError, match="finalized"):
        s.feed(r[:8])
    for kw in (dict(), dict(top_k=2, excl_zone=np.array([1, 2, 3])),
               dict(top_k=2, prune=True)):
        qq = [q[0], q[1, :4]] if not kw else q
        with pytest.raises(ValueError) as want:
            jstream(qq if not kw else jnp.asarray(q), impl="sharded", **kw)
        with pytest.raises(ValueError) as got:
            stream(qq, impl="sharded", **kw)
        assert str(got.value) == str(want.value)
