"""repro_torch.core against repro.core on the same numpy inputs.

The port runs on the CPU (``device="cpu"`` semantics: plain PyTorch), the
reference under JAX on the CPU. Tolerances: int32 results are compared
bitwise — distances, positions, starts, top-K heaps and carries.
float32 results are bitwise too where the inputs are integer-valued
(every sum is exact below 2**24); on real-valued float32 inputs the
distances use ``rtol=1e-5`` and positions/starts are not compared,
because the port's Hillis-Steele scan and the reference's
``lax.associative_scan`` sum in different orders
(``src/repro/kernels/sdtw/sdtw.py:29-31``).
"""
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jd
from repro_torch.core import distances as td
from repro_torch.core import engine as tengine
from repro_torch.core.topk import topk_init

jsdtw = importlib.import_module("repro.core.sdtw")
tsdtw = importlib.import_module("repro_torch.core.sdtw")

GOLDEN = pathlib.Path(__file__).parent / "golden" / "sdtw_spans_v1.npz"
METRICS = ("abs_diff", "square_diff")


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(y) for y in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _equal(got, want, msg=""):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want), msg
        for g, w in zip(got, want):
            _equal(g, w, msg)
        return
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


T = torch.from_numpy
J = jnp.asarray


# ---------------------------------------------------------------------------
# Distances and the semiring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64",
                                   "float16", "bfloat16", "float32",
                                   "float64"])
@pytest.mark.parametrize("metric", METRICS)
def test_pointwise_distance_and_accumulator(dtype, metric, rng):
    q = rng.integers(-100, 100, 64)
    r = rng.integers(-100, 100, 64)
    if dtype == "bfloat16":
        tq, tr = (torch.tensor(q, dtype=torch.bfloat16),
                  torch.tensor(r, dtype=torch.bfloat16))
        jq, jr = J(q, jnp.bfloat16), J(r, jnp.bfloat16)
    else:
        tq, tr = T(q.astype(dtype)), T(r.astype(dtype))
        jq, jr = J(q.astype(dtype)), J(r.astype(dtype))
    got = td.pointwise_distance(tq, tr, metric)
    want = jd.pointwise_distance(jq, jr, metric)
    _equal(got, want)
    assert td.big(got.dtype) == jd.big(np.asarray(want).dtype)


def test_int32_wraps_like_the_reference(rng):
    """Squares and differences beyond int32 wrap in two's complement."""
    q = np.array([2**30, -2**31, 50000, -7], np.int32)
    r = np.array([-2**30, 1, -50000, 2**31 - 1], np.int32)
    for metric in METRICS:
        _equal(td.pointwise_distance(T(q), T(r), metric),
               jd.pointwise_distance(J(q), J(r), metric), metric)


@pytest.mark.parametrize("impl", ["rowscan", "wavefront"])
@pytest.mark.parametrize("spans", [False, True])
def test_row0_beyond_int_big_mirrors_each_schedule(impl, spans):
    """A one-sample query whose every distance exceeds INT_BIG: the row
    scan reports min(d0) unsaturated at its column, the wavefront BIG at
    -1 — the port mirrors each schedule, as the reference's own two
    differ (a known reference behaviour, ROADMAP.md §3)."""
    q = np.array([[2**29 + 100, 3, 4], [7, 1, 2]], np.int32)
    r = np.array([0, -1, 2, 5, 1], np.int32)
    qlens = np.array([1, 1], np.int32)
    kw = dict(return_spans=spans, return_positions=not spans)
    got = tsdtw.sdtw_batch(T(q), T(r), T(qlens), "abs_diff", impl, **kw)
    want = jsdtw.sdtw_batch(J(q), J(r), J(qlens), "abs_diff", impl, **kw)
    _equal(got, want, impl)
    assert (int(got[0][0]) > td.INT_BIG) == (impl == "rowscan")


def test_semiring_ops_bitwise(rng):
    BIG = td.INT_BIG
    vals = rng.integers(0, BIG + 1, (6, 40)).astype(np.int32)
    vals[:, :5] = BIG
    starts = rng.integers(0, 8, (6, 40)).astype(np.int32)
    a, u, s = (vals[0], vals[1], starts[0])
    a2, u2, s2 = (vals[2], vals[3], starts[1])
    _equal(td.sat_add(T(a), T(u)), jd.sat_add(J(a), J(u)))
    _equal(td.lex_min(T(a), T(s), T(a2), T(s2)),
           jd.lex_min(J(a), J(s), J(a2), J(s2)))
    _equal(td.tropical_combine((T(a), T(u)), (T(a2), T(u2))),
           jd.tropical_combine((J(a), J(u)), (J(a2), J(u2))))
    _equal(td.tropical_combine_span((T(a), T(u), T(s)),
                                    (T(a2), T(u2), T(s2))),
           jd.tropical_combine_span((J(a), J(u), J(s)),
                                    (J(a2), J(u2), J(s2))))
    assert (td.INT_BIG, td.INT_FAR, td.METRICS) == (jd.INT_BIG, jd.INT_FAR,
                                                     jd.METRICS)


def test_tropical_scan_matches_associative_scan(rng):
    from jax import lax
    a = rng.integers(0, 60, (3, 37)).astype(np.int32)
    u = rng.integers(0, 400, (3, 37)).astype(np.int32)
    s = rng.integers(0, 9, (3, 37)).astype(np.int32)
    ga, gu, gs = tsdtw.tropical_scan(T(a), T(u), T(s))
    wa, wu, ws = lax.associative_scan(jd.tropical_combine_span,
                                      (J(a), J(u), J(s)), axis=1)
    _equal([ga, gu, gs], [wa, wu, ws])


# ---------------------------------------------------------------------------
# In-core schedules
# ---------------------------------------------------------------------------

def _batch_inputs(rng, dtype, nq=5, n=9, m=48):
    q = rng.integers(-40, 40, (nq, n)).astype(dtype)
    r = rng.integers(-40, 40, m).astype(dtype)
    qlens = np.array([n, 1, 4, 7, 2][:nq], np.int32)
    lo = np.array([-1, 10, 0, 30, 5][:nq], np.int32)
    hi = np.array([-1, 20, 6, 48, 6][:nq], np.int32)
    return q, r, qlens, lo, hi


@pytest.mark.parametrize("impl", ["rowscan", "wavefront"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("mode", ["dist", "positions", "spans"])
def test_sdtw_batch_matches_reference(impl, metric, dtype, mode, rng):
    q, r, qlens, lo, hi = _batch_inputs(rng, dtype)
    kw = dict(return_positions=mode == "positions",
              return_spans=mode == "spans")
    got = tsdtw.sdtw_batch(T(q), T(r), T(qlens), metric, impl, T(lo), T(hi),
                           **kw)
    want = jsdtw.sdtw_batch(J(q), J(r), J(qlens), metric, impl, J(lo), J(hi),
                            **kw)
    _equal(got, want, f"{impl} {metric} {mode}")


@pytest.mark.parametrize("fn", ["sdtw_rowscan", "sdtw_wavefront"])
def test_single_query_schedules(fn, rng):
    q = rng.integers(-40, 40, 11).astype(np.int32)
    r = rng.integers(-40, 40, 60).astype(np.int32)
    for kw in ({}, dict(qlen=6, return_position=True),
               dict(excl_lo=12, excl_hi=30, return_spans=True)):
        _equal(getattr(tsdtw, fn)(T(q), T(r), **kw),
               getattr(jsdtw, fn)(J(q), J(r), **kw), f"{fn} {kw}")


@pytest.mark.parametrize("impl", ["rowscan", "wavefront"])
def test_float32_real_valued_within_tolerance(impl, rng):
    q = rng.normal(0, 10, (4, 12)).astype(np.float32)
    r = rng.normal(0, 10, 90).astype(np.float32)
    got = tsdtw.sdtw_batch(T(q), T(r), impl=impl).numpy()
    want = np.asarray(jsdtw.sdtw_batch(J(q), J(r), impl=impl))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# The chunk carry, top-K and the chunked schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("lastrow", [False, True])
def test_rowscan_chunk_matches_reference(track, lastrow, rng):
    q = rng.integers(-40, 40, 8).astype(np.int32)
    r = rng.integers(-40, 40, 24).astype(np.int32)
    bcol = rng.integers(0, 300, 8).astype(np.int32)
    bstart = rng.integers(0, 50, 8).astype(np.int32) if track else None
    kw = dict(qlen=5, j0=40, m_total=60, excl_lo=45, excl_hi=50,
              return_lastrow=lastrow, clen=17)
    got = tsdtw.sdtw_rowscan_chunk(
        T(q), T(r), T(bcol), torch.tensor(250, dtype=torch.int32),
        bstart=None if bstart is None else T(bstart), **kw)
    want = jsdtw.sdtw_rowscan_chunk(
        J(q), J(r), J(bcol), jnp.int32(250),
        bstart=None if bstart is None else J(bstart), **kw)
    _equal(got, want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(return_positions=True),
    dict(return_spans=True),
    dict(top_k=3),
    dict(top_k=3, return_spans=True, excl_zone=4),
    dict(top_k=2, return_spans=True, excl_mode="span"),
], ids=["dist", "pos", "spans", "topk", "topk_spans", "topk_span_mode"])
def test_sdtw_chunked_matches_reference(metric, dtype, kw, rng):
    q, r, qlens, lo, hi = _batch_inputs(rng, dtype, m=100)
    got = tsdtw.sdtw_chunked(T(q), T(r), T(qlens), metric, 16, T(lo), T(hi),
                             **kw)
    want = jsdtw.sdtw_chunked(J(q), J(r), J(qlens), metric, 16, J(lo), J(hi),
                              **kw)
    _equal(got, want, str(kw))


@pytest.mark.parametrize("track", [False, True])
def test_chunk_batch_topk_and_fold_lastrow(track, rng):
    q, r, qlens, lo, hi = _batch_inputs(rng, np.int32, m=32)
    nq, n = q.shape
    zone = np.full(nq, 2, np.int32)
    tcarry = (tsdtw.sdtw_carry_init(nq, n, torch.int32, track)
              + topk_init(nq, 3, torch.int32))
    jcarry = (jsdtw.sdtw_carry_init(nq, n, jnp.int32, track)
              + jsdtw.topk_init(nq, 3, jnp.int32))
    got = tsdtw.sdtw_chunk_batch_topk(T(q), T(r), T(qlens), tcarry, 0, 32,
                                      "abs_diff", T(lo), T(hi), 3, T(zone),
                                      track_start=track, return_lastrow=True)
    want = jsdtw.sdtw_chunk_batch_topk(J(q), J(r), J(qlens), jcarry, 0, 32,
                                       "abs_diff", J(lo), J(hi), 3, J(zone),
                                       track_start=track,
                                       return_lastrow=True)
    _equal(got, want)
    # Fold the candidate row into the merged heap, as a kernel consumer does.
    heap = [np.array(h) for h in (want[3:6] if track else want[2:5])]
    lrow = np.array(want[6] if track else want[5])
    lst = np.array(want[7]) if track else None
    _equal(tsdtw.topk_fold_lastrow([T(h) for h in heap], T(lrow),
                                   None if lst is None else T(lst), 32, 3,
                                   T(zone), excl_span=track),
           jsdtw.topk_fold_lastrow([J(h) for h in heap], J(lrow),
                                   None if lst is None else J(lst), 32, 3,
                                   J(zone), excl_span=track))


def test_default_zone_and_self_join_helpers(rng):
    qlens = np.array([1, 2, 9, 16], np.int32)
    _equal(tsdtw.default_excl_zone(T(qlens)),
           jsdtw.default_excl_zone(J(qlens)))
    r = rng.integers(-50, 50, 40).astype(np.int32)
    _equal(tsdtw.self_join_windows(T(r), 8, 3),
           [np.asarray(x) for x in jsdtw.self_join_windows(J(r), 8, 3)])
    starts = np.arange(0, 33, 3, dtype=np.int32)
    _equal(tsdtw.self_join_exclusion(T(starts), 8),
           jsdtw.self_join_exclusion(J(starts), 8))


def test_oracle_copy_is_verbatim():
    here = pathlib.Path(__file__).parents[1] / "src"
    assert ((here / "repro_torch" / "core" / "sdtw_ref.py").read_text()
            == (here / "repro" / "core" / "sdtw_ref.py").read_text())


# ---------------------------------------------------------------------------
# The golden fixture, reproduced by the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["i32", "f32"])
def test_golden_spans_reproduced_bitwise(tag):
    """Every key of ``sdtw_spans_v1.npz`` from the port's engine. The f32
    fixture data are integer-valued, so its sums are exact and the float32
    keys are bitwise too."""
    g = np.load(GOLDEN)
    q, r = g[f"{tag}_queries"], g[f"{tag}_reference"]
    for metric in METRICS:
        _equal(tengine.sdtw(q, r, metric=metric, impl="chunked", chunk=32,
                            return_spans=True, device="cpu"),
               [g[f"{tag}_{metric}_{k}"] for k in ("dists", "starts",
                                                    "ends")], metric)
        _equal(tengine.sdtw(q, r, metric=metric, impl="rowscan",
                            return_spans=True, device="cpu"),
               [g[f"{tag}_{metric}_rowscan_{k}"]
                for k in ("dists", "starts", "ends")], metric)
    _equal(tengine.sdtw(q, r, top_k=3, excl_zone=5, return_spans=True,
                        device="cpu"),
           [g[f"{tag}_topk_{k}"] for k in ("dists", "starts", "ends")])
