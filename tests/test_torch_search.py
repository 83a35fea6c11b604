"""repro_torch.search (pruned top-K search) against the JAX package.

Mirrors ``tests/test_search.py`` (all but its hypothesis and ``mesh``
cases). The port runs with ``device="cpu"``: ``engine_impl='pallas'``
there is the kernel's plain version; the reference runs its Pallas kernel
in interpret mode, as its own tests do. Inputs come from a numpy seed.

Tolerances: int32 is compared bitwise — distances, positions, starts,
the ``chunks_*`` pruning counters and the bounds. The float32 inputs
here are integer- or quarter-valued, so every DP sum and every bound sum
is exact in float32 and those are bitwise too; the float64 oracle is
held to ``rtol=1e-5``.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import dtw_ref, greedy_topk, sdtw_matrix, sdtw_ref

from repro.search import lower_bounds as jlb
from repro.search import search_topk as jsearch
from repro_torch.core import engine as tengine
from repro_torch.core.request import SdtwRequest
from repro_torch.core.topk import topk_init, topk_merge, topk_select
from repro_torch.search import (EnvelopeCache, chunk_envelope, default_chunk,
                                lb_cascade, search_topk, windowed_envelope,
                                znorm, znorm_padded)
from repro_torch.search.search import DEFAULT_SPAN_FACTOR

GOLDEN = pathlib.Path(__file__).parent / "golden" / "sdtw_spans_v1.npz"
FIELDS = ("distances", "positions", "starts")
COUNTERS = ("chunks_total", "chunks_pruned_kim", "chunks_pruned_keogh",
            "chunks_processed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tsearch(*a, **kw):
    return search_topk(*a, device="cpu", **kw)


def _same(got, want, counters=True):
    """A port ``SearchResult`` equals a reference one, bitwise."""
    for f in FIELDS:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.chunk == want.chunk
    if counters:
        assert ([getattr(got, c) for c in COUNTERS]
                == [getattr(want, c) for c in COUNTERS])


def heterogeneous_reference(rng, m, seg):
    """Piecewise level-shifted noise — the regime envelope pruning targets."""
    levels = rng.integers(-1500, 1500, -(-m // seg))
    return np.concatenate([
        lvl + rng.normal(0, 40, seg) for lvl in levels])[:m].astype(np.int32)


# ---------------------------------------------------------------------------
# search_topk == the reference (and the engine)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
@pytest.mark.parametrize("chunk", [32, 64, 512])
def test_search_top1_no_prune_bitwise_vs_engine(metric, chunk, rng):
    """k=1, no pruning: the distance is ``engine.sdtw``'s and the
    position the oracle's leftmost argmin; at one chunk size and metric
    the whole result is the reference's, bitwise (one reference
    compile)."""
    q = rng.integers(-40, 40, (4, 12)).astype(np.int32)
    r = rng.integers(-40, 40, 333).astype(np.int32)
    res = _tsearch(q, r, k=1, prune=False, chunk=chunk, metric=metric)
    if chunk == 64 and metric == "abs_diff":
        _same(res, jsearch(jnp.asarray(q), jnp.asarray(r), k=1,
                           prune=False, chunk=chunk, metric=metric))
    np.testing.assert_array_equal(
        _np(res.distances)[:, 0],
        _np(tengine.sdtw(q, r, metric=metric, device="cpu")))
    pos_want = [int(np.argmin(sdtw_matrix(q[i], r, metric)[-1]))
                for i in range(4)]
    np.testing.assert_array_equal(_np(res.positions)[:, 0], pos_want)
    assert res.chunks_pruned == 0


def test_search_top1_no_prune_float32(rng):
    """float32 (quarter-valued, so exact): bitwise against the reference
    and the engine's chunked path; rtol=1e-5 against the float64
    oracle."""
    q = (rng.integers(-40, 40, (3, 9)) + 0.25).astype(np.float32)
    r = (rng.integers(-40, 40, 200) + 0.5).astype(np.float32)
    res = _tsearch(q, r, k=1, prune=False, chunk=32)
    _same(res, jsearch(jnp.asarray(q), jnp.asarray(r), k=1, prune=False,
                       chunk=32))
    want_d, want_p = tengine.sdtw(q, r, impl="chunked", chunk=32,
                                  return_positions=True, device="cpu")
    np.testing.assert_array_equal(_np(res.distances)[:, 0], _np(want_d))
    np.testing.assert_array_equal(_np(res.positions)[:, 0], _np(want_p))
    oracle = [sdtw_ref(q[i], r) for i in range(3)]
    np.testing.assert_allclose(_np(res.distances)[:, 0], oracle, rtol=1e-5)


@pytest.mark.parametrize("engine_impl", ["rowscan", "pallas"])
def test_search_pruned_top1_exact_and_prunes(engine_impl, rng):
    """Pruning on heterogeneous data: the reference's heaps and pruning
    counters bitwise, on both of the port's DP backends (the reference's
    rowscan route, whose results it documents bitwise equal to its kernel
    route; the reference's kernel route is held by
    ``test_torch_stream.py``'s pruned cross-package sessions); ≥ 1 chunk
    pruned and the top-1 distance still the engine's."""
    ref = heterogeneous_reference(rng, 1024, 128)
    n = 16
    q = np.stack([ref[250:250 + n],
                  ref[750:750 + n] + rng.integers(-2, 3, n)]).astype(
                      np.int32)
    res = _tsearch(q, ref, k=3, chunk=64, engine_impl=engine_impl)
    _same(res, jsearch(jnp.asarray(q), jnp.asarray(ref), k=3, chunk=64,
                       engine_impl="rowscan"))
    want = _np(tengine.sdtw(q, ref, device="cpu"))
    np.testing.assert_array_equal(_np(res.distances)[:, 0], want)
    assert res.chunks_pruned > 0
    assert res.chunks_pruned + res.chunks_processed == res.chunks_total


def test_search_kernel_route_equals_rowscan_route(rng):
    """The two DP backends of the port agree bitwise — pruned (halo
    groups through the kernel's last-row capture) and exact (the kernel's
    chunk-carry scan against the chunked engine), both exclusion modes."""
    ref = heterogeneous_reference(rng, 400, 50)
    q = np.stack([ref[300:308], ref[200:208] + 1, ref[50:58]])
    for prune in (True, False):
        for mode in ("end", "span"):
            kw = dict(k=3, chunk=32, prune=prune, excl_mode=mode)
            _same(_tsearch(q, ref, engine_impl="pallas", **kw),
                  _tsearch(q, ref, engine_impl="rowscan", **kw))


def test_search_topk_matches_greedy_oracle_no_prune(rng):
    """Full-k streamed heap == greedy suppression on the oracle last
    row."""
    q = rng.integers(-40, 40, (2, 8)).astype(np.int32)
    r = rng.integers(-40, 40, 150).astype(np.int32)
    k, zone = 4, 6
    res = _tsearch(q, r, k=k, prune=False, chunk=16, excl_zone=zone)
    d, p = _np(res.distances), _np(res.positions)
    for i in range(2):
        want = greedy_topk(sdtw_matrix(q[i], r)[-1], k, zone)
        for kk, (wd, wp) in enumerate(want):
            assert p[i, kk] == wp
            if wp >= 0:
                assert d[i, kk] == wd


def test_search_excl_zone_distinct_motifs(rng):
    """Two planted motifs must both surface, positions > excl_zone
    apart."""
    ref = heterogeneous_reference(rng, 2048, 256)
    n = 32
    motif = rng.integers(-3000, -2500, n).astype(np.int32)  # out-of-range
    ref[400:400 + n] = motif
    ref[1500:1500 + n] = motif + 1
    res = _tsearch(motif, ref, k=2, chunk=128)
    pos = sorted(int(x) for x in _np(res.positions))
    assert pos == [400 + n - 1, 1500 + n - 1]


def test_search_golden_spans_reproduced_bitwise():
    """``sdtw_spans_v1.npz``: the top-1 span of an exact search is the
    fixture's chunked span, and a one-tile exact top-3 search its top-K
    keys — on both DP backends (the f32 data are integer-valued)."""
    g = np.load(GOLDEN)
    for tag in ("i32", "f32"):
        q, r = g[f"{tag}_queries"], g[f"{tag}_reference"]
        for engine_impl in ("rowscan", "pallas"):
            for metric in ("abs_diff", "square_diff"):
                res = _tsearch(q, r, k=1, prune=False, chunk=32,
                               metric=metric, engine_impl=engine_impl)
                for f, key in zip(FIELDS, ("dists", "ends", "starts")):
                    np.testing.assert_array_equal(
                        _np(getattr(res, f))[:, 0],
                        g[f"{tag}_{metric}_{key}"], err_msg=(tag, f))
            res = _tsearch(q, r, k=3, excl_zone=5, prune=False, chunk=8192,
                           engine_impl=engine_impl)
            for f, key in zip(FIELDS, ("dists", "ends", "starts")):
                np.testing.assert_array_equal(_np(getattr(res, f)),
                                              g[f"{tag}_topk_{key}"])


# ---------------------------------------------------------------------------
# Lower bounds
# ---------------------------------------------------------------------------

def span_capped_best(q, r, j_range, cap, metric):
    """Brute force: cheapest alignment of the whole query ending at any
    j in j_range with warping span <= cap columns."""
    best = np.inf
    for j in j_range:
        for a in range(max(0, j - cap + 1), j + 1):
            best = min(best, dtw_ref(q, r[a:j + 1], metric))
    return best


@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
def test_lb_cascade_admissible_vs_bruteforce(metric, rng):
    """The port's bounds are the reference's, bitwise; neither exceeds the
    true cost of the best span-capped match ending in its chunk, and
    LB_Keogh dominates LB_Kim."""
    nq, n, m, chunk = 2, 5, 40, 8
    cap = DEFAULT_SPAN_FACTOR * n
    halo = -(-cap // chunk)
    for trial in range(5):
        q = rng.integers(-30, 30, (nq, n)).astype(np.int32)
        r = rng.integers(-30, 30, m).astype(np.int32)
        qlens = np.array([n, n - 2], np.int32)
        mins, maxs = chunk_envelope(torch.from_numpy(r), chunk)
        jm, jx = jlb.chunk_envelope(jnp.asarray(r), chunk)
        np.testing.assert_array_equal(_np(mins), np.asarray(jm))
        np.testing.assert_array_equal(_np(maxs), np.asarray(jx))
        kim, keogh = (_np(x) for x in lb_cascade(q, qlens, mins, maxs, halo,
                                                 metric))
        if trial == 0:
            jkim, jkeogh = jlb.lb_cascade(jnp.asarray(q), jnp.asarray(qlens),
                                          jm, jx, halo, metric)
            np.testing.assert_array_equal(kim, np.asarray(jkim))
            np.testing.assert_array_equal(keogh, np.asarray(jkeogh))
        assert np.all(kim <= keogh + 1e-4)
        for c in range(-(-m // chunk)):
            js = range(c * chunk, min(m, (c + 1) * chunk))
            for i in range(nq):
                true = span_capped_best(q[i, :qlens[i]], r, js, cap, metric)
                assert kim[i, c] <= true + 1e-6, (trial, i, c)
                assert keogh[i, c] <= true + 1e-6, (trial, i, c)


def test_lb_never_prunes_best_chunk(rng):
    """With span_cap covering the whole reference, the chunk holding the
    true best match always bounds at or below the true best distance."""
    n, m, chunk = 6, 96, 16
    halo = -(-m // chunk)
    for trial in range(20):
        q = rng.integers(-50, 50, n).astype(np.int32)
        r = rng.integers(-50, 50, m).astype(np.int32)
        if trial % 3 == 0:
            s = int(rng.integers(0, m - n))
            r[s:s + n] = q                     # planted exact match
        d, p = tengine.sdtw(q, r, return_positions=True, device="cpu")
        mins, maxs = chunk_envelope(torch.from_numpy(r), chunk)
        kim, keogh = lb_cascade(q[None, :], np.array([n], np.int32), mins,
                                maxs, halo)
        c_best = int(p) // chunk
        assert float(kim[0, c_best]) <= float(d) + 1e-6
        assert float(keogh[0, c_best]) <= float(d) + 1e-6


def test_windowed_envelope_widens_left():
    mins = torch.tensor([0., 10., -5., 3.])
    maxs = torch.tensor([1., 12., -2., 4.])
    wmin, wmax = windowed_envelope(mins, maxs, 1)
    np.testing.assert_allclose(_np(wmin), [0., 0., -5., -5.])
    np.testing.assert_allclose(_np(wmax), [1., 12., 12., 4.])


def test_znorm_matches_reference(rng):
    """Global and mask-aware z-norm within rtol=1e-6 of the reference
    (float32 moments are summed in another order)."""
    x = (100 * np.sin(np.arange(300) * 2.63)
         + rng.normal(0, 2, 300)).astype(np.float32)
    np.testing.assert_allclose(_np(znorm(x)), np.asarray(jlb.znorm(x)),
                               rtol=1e-6, atol=1e-6)
    q = rng.normal(0, 5, (3, 20)).astype(np.float32)
    lens = np.array([20, 7, 1], np.int32)
    np.testing.assert_allclose(
        _np(znorm_padded(q, lens)),
        np.asarray(jlb.znorm_padded(jnp.asarray(q), jnp.asarray(lens))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Top-K heap primitives
# ---------------------------------------------------------------------------

def test_topk_select_suppression_and_padding():
    scores = torch.tensor([[5., 3., 4., 9., 1.]])
    pos = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
    d, p, s = topk_select(scores, pos, pos - 1, 3, 1)
    # 1@4 suppresses 9@3; 3@1 suppresses 5@0 and 4@2 → only 2 matches.
    np.testing.assert_array_equal(_np(p)[0], [4, 1, -1])
    np.testing.assert_array_equal(_np(s)[0], [3, 0, -1])
    assert _np(d)[0, 2] == np.inf


def test_topk_select_span_overlap_mode():
    """excl_span suppresses on interval intersection, not end distance."""
    scores = torch.tensor([[1., 2., 3.]])
    ends = torch.tensor([10, 40, 13], dtype=torch.int32)
    starts = torch.tensor([5, 8, 12], dtype=torch.int32)
    d, p, s = topk_select(scores, ends, starts, 3, 0, excl_span=True)
    np.testing.assert_array_equal(_np(p)[0], [10, 13, -1])
    np.testing.assert_array_equal(_np(s)[0], [5, 12, -1])


def test_topk_merge_tie_prefers_heap():
    """Exact ties keep the earlier (heap/earlier-chunk) position."""
    hd, hp, hs = topk_init(1, 1, torch.float32)
    one = torch.tensor([[7.]])
    d1, p1, s1 = topk_merge(hd, hp, hs, one, torch.tensor([10]),
                            torch.tensor([8]), 1, 2)
    d2, p2, s2 = topk_merge(d1, p1, s1, one, torch.tensor([50]),
                            torch.tensor([48]), 1, 2)
    assert int(p2[0, 0]) == 10 and float(d2[0, 0]) == 7.0 \
        and int(s2[0, 0]) == 8


# ---------------------------------------------------------------------------
# Front-door plumbing
# ---------------------------------------------------------------------------

def test_envelope_cache_hits(rng):
    r = torch.from_numpy(rng.integers(-40, 40, 128).astype(np.int32))
    cache = EnvelopeCache()
    e1 = cache.envelope(r, 32, key="k")
    e2 = cache.envelope(r, 32, key="k")
    assert cache.hits == 1 and cache.misses == 1 and len(cache) == 1
    np.testing.assert_array_equal(_np(e1[0]), _np(e2[0]))
    cache.envelope(r, 16, key="k")             # different chunk → new entry
    assert cache.misses == 2
    # Fingerprint path (no key) is deterministic, and sees a mutation.
    cache.envelope(r, 32)
    cache.envelope(r, 32)
    assert cache.hits == 2 and cache.misses == 3
    r2 = r.clone()
    r2[60] += 1
    cache.envelope(r2, 32)
    assert cache.misses == 4


def test_cache_key_isolates_normalized_searches(rng):
    """A normalized and a raw search sharing ref_key must not share
    envelope entries — a stale raw envelope would mis-prune the
    normalized search (and vice versa); both stay exact."""
    ref = heterogeneous_reference(rng, 2048, 256)
    n = 32
    q = ref[900:900 + n].astype(np.int32)
    cache = EnvelopeCache()
    res_n = _tsearch(q, ref, k=1, chunk=128, normalize=True, cache=cache,
                     ref_key="shared")
    res_r = _tsearch(q, ref, k=1, chunk=128, cache=cache, ref_key="shared")
    assert cache.misses == 2 and len(cache) == 2   # no cross-contamination
    assert _np(res_r.distances)[0] == _np(tengine.sdtw(q, ref,
                                                       device="cpu"))
    zq = znorm_padded(q[None, :], np.array([n], np.int32))
    assert _np(res_n.distances)[0] == _np(tengine.sdtw(
        zq, znorm(ref), device="cpu"))[0]


def test_ragged_search_matches_per_query(rng):
    r = rng.integers(-50, 50, 200).astype(np.int32)
    ragged = [rng.integers(-50, 50, L).astype(np.int32) for L in (5, 17, 9)]
    res = _tsearch(ragged, r, k=2, prune=False, chunk=32, excl_zone=3)
    for i, q in enumerate(ragged):
        one = _tsearch(q, r, k=2, prune=False, chunk=32, excl_zone=3)
        np.testing.assert_array_equal(_np(res.distances)[i],
                                      _np(one.distances))
        np.testing.assert_array_equal(_np(res.positions)[i],
                                      _np(one.positions))
    pruned = _tsearch(ragged, r, k=2, chunk=32, excl_zone=3)
    np.testing.assert_array_equal(_np(pruned.distances)[:, 0],
                                  _np(res.distances)[:, 0])


def test_normalize_finds_scaled_motif(rng):
    """A gain/offset-shifted copy of a reference window is found after
    z-normalization."""
    ref = (100 * np.sin(np.arange(512) * 2.63)
           + rng.normal(0, 2, 512)).astype(np.float32)
    n = 40
    motif = ref[300:300 + n] * 3.0 + 2000.0    # scaled + offset copy
    res = _tsearch(motif, ref, k=1, normalize=True, chunk=64, prune=False)
    assert abs(int(res.positions[0]) - (300 + n - 1)) <= 2
    mask_aware = znorm_padded(motif[None, :], np.array([n], np.int32))
    assert abs(float(mask_aware.mean())) < 1e-5


def test_request_op_and_auto_backend(rng):
    """``SdtwRequest(op='search_topk').run()`` is ``search_topk``; on the
    CPU ``engine_impl='auto'`` is the rowscan backend; ``default_chunk``
    is the reference's."""
    from repro.search import default_chunk as jdefault_chunk
    q = rng.integers(-9, 9, (2, 6)).astype(np.int32)
    r = rng.integers(-9, 9, 100).astype(np.int32)
    req = SdtwRequest(op="search_topk", queries=q, reference=r, top_k=2,
                      chunk=32, device="cpu")
    _same(req.run(), _tsearch(q, r, k=2, chunk=32))
    _same(_tsearch(q, r, k=2, chunk=32),
          _tsearch(q, r, k=2, chunk=32, engine_impl="rowscan"))
    for m, n in ((7997, 120), (1_800_000, 512), (100, 6), (20, 3)):
        assert default_chunk(m, n) == jdefault_chunk(m, n)
    spans = _tsearch(q, r, k=2, chunk=32).spans
    assert tuple(spans.shape) == (2, 2, 2)


def test_search_arg_validation(rng):
    q = np.zeros((2, 4), np.int32)
    r = np.zeros(32, np.int32)
    for kw, msg in ((dict(k=0), "k must be"),
                    (dict(mesh=object()), "prune=False"),
                    (dict(excl_lo=1), "together"),
                    (dict(excl_zone=np.array([1, 2])), "scalar excl_zone"),
                    (dict(engine_impl="x"), "engine_impl"),
                    (dict(engine_impl="pallas", excl_lo=0, excl_hi=3),
                     "exclusion")):
        with pytest.raises(ValueError, match=msg):
            _tsearch(q, r, **kw)
    with pytest.raises(ValueError, match="qlens"):
        _tsearch([q[0]], r, qlens=[4])
    from repro.distributed import get_mesh as jget_mesh
    from repro_torch.distributed import get_mesh
    got = _tsearch(q, r, k=2, mesh=get_mesh(), prune=False)
    _same(got, jsearch(jnp.asarray(q), jnp.asarray(r), k=2,
                       mesh=jget_mesh(), prune=False))


def test_new_entry_points_default_to_cuda():
    """search_topk, stream, align and StreamSession.restore run on the
    card unless asked for the CPU, and refuse without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.stream import StreamSession
    q = np.zeros((1, 4), np.int32)
    r = np.zeros(8, np.int32)
    snap = tengine.stream(q, device="cpu").snapshot()
    for call in (lambda: search_topk(q, r), lambda: tengine.stream(q),
                 lambda: tengine.align(q, r),
                 lambda: StreamSession.restore(snap)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_search_and_stream_import_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.search, "
            "repro_torch.stream, repro_torch.core.traceback; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    src = str(pathlib.Path(__file__).parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stdout + proc.stderr
