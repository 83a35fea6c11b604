"""repro_torch's engine, request and ``matsa()`` against the JAX package.

The port runs with ``device="cpu"`` (its plain PyTorch versions: the
kernel impl runs the kernel's plain version); the reference runs under
JAX on the CPU. Both default to ``tune='model'``, whose CPU decisions
are the same in both packages (and int32 answers do not depend on
tuning). int32 results are compared bitwise.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import matsa as jmatsa
from repro.core import matsa_api as jmatsa_api
from repro_torch.core import engine as tengine
from repro_torch.core import matsa as tmatsa
from repro_torch.core import matsa_api as tmatsa_api
from repro_torch.core.request import SdtwRequest


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(y) for y in x]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want, msg=""):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), msg
        for g, w in zip(got, want):
            _equal(g, w, msg)
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (
        msg, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _tsdtw(*a, **kw):
    return tengine.sdtw(*a, device="cpu", **kw)


def _jsdtw(*a, **kw):
    return jengine.sdtw(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x
                          for x in a], **kw)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,kw", [
    ((8, 16, 4096), {}),
    ((8, 64, 100), {}),
    ((8, 16, tengine.CHUNK_THRESHOLD), {}),
    ((8, 16, 64), dict(chunk=16)),
    ((8, 16, 4096), dict(top_k=2)),
    ((8, 16, 4096), dict(has_exclusion=True)),
    ((8, 16, tengine.CHUNK_THRESHOLD), dict(has_exclusion=True)),
])
def test_cpu_dispatch_is_the_reference_rule(shape, kw):
    assert (tengine.choose_impl(*shape, backend="cpu", **kw)
            == jengine.choose_impl(*shape, backend="cpu", tune="off", **kw))


def test_cuda_dispatch_rule_3():
    """Rule 3 reads "the tensors are on a CUDA device → the kernel", with
    exclusion zones as the kernel's per-query ban; the structural rules
    before it hold."""
    ci = tengine.choose_impl
    assert ci(8, 16, 4096, backend="cuda") == "pallas"
    assert ci(8, 16, tengine.CHUNK_THRESHOLD, backend="cuda") == "pallas"
    assert ci(8, 16, 4096) == "pallas"                  # the card's default
    assert ci(8, 16, 4096, backend="cuda", chunk=64) == "chunked"
    assert ci(8, 16, 4096, backend="cuda", top_k=3) == "chunked"
    assert ci(8, 16, 4096, backend="cuda", has_exclusion=True) == "pallas"
    assert ci(8, 16, 4096, backend="cuda", mesh=object()) == "sharded"
    # Tuning leaves rule 3 structural: the oracle decides the launch.
    assert tengine.choose_impl_explained(
        8, 16, 4096, backend="cuda", tune="model")[:2] == ("pallas",
                                                           "structural")


# ---------------------------------------------------------------------------
# engine.sdtw on every ported path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(20261017)
    q = rng.integers(-40, 40, (4, 8)).astype(np.int32)
    r = rng.integers(-40, 40, 70).astype(np.int32)
    qlens = np.array([8, 3, 1, 6], np.int32)
    return q, r, qlens


@pytest.mark.parametrize("impl,kw", [
    ("auto", {}), ("rowscan", {}), ("wavefront", {}), ("pallas", {}),
    ("pallas", dict(chunk=16)), ("chunked", dict(chunk=16)),
], ids=["auto", "rowscan", "wavefront", "pallas", "pallas_chunk",
        "chunked"])
@pytest.mark.parametrize("mode", ["dist", "positions", "spans"])
def test_engine_paths_match_reference(impl, kw, mode, batch):
    q, r, qlens = batch
    out = dict(return_positions=mode == "positions",
               return_spans=mode == "spans")
    _equal(_tsdtw(q, r, qlens, impl=impl, **kw, **out),
           _jsdtw(q, r, qlens, impl=impl, **kw, **out), f"{impl} {mode}")


@pytest.mark.parametrize("spans", [False, True])
def test_streamed_kernel_slice_loops_match_reference(spans, batch):
    """The device-side slice loop and the host loop chain the kernel
    carry exactly like the reference's host loop (chunk < M, ragged
    tail)."""
    q, r, qlens = batch
    tq, tr, tl = map(torch.from_numpy, (q, r, qlens))
    want = jengine._pallas_host_loop(jnp.asarray(q), jnp.asarray(r),
                                     jnp.asarray(qlens), "abs_diff", 16,
                                     return_positions=True,
                                     return_spans=spans)
    _equal(tengine._pallas_scan_streamed(
        tq, tr, tl, "abs_diff", chunk=16, block_q=None, block_m=None,
        return_positions=True, return_spans=spans), want)
    _equal(tengine._pallas_host_loop(tq, tr, tl, "abs_diff", 16,
                                     return_positions=True,
                                     return_spans=spans), want)


@pytest.mark.parametrize("kw", [
    dict(top_k=3), dict(top_k=2, return_spans=True, excl_zone=3),
    dict(top_k=2, excl_mode="span"),
    dict(excl_lo=np.array([10, -1, 0, 40], np.int32),
         excl_hi=np.array([30, -1, 8, 70], np.int32), return_spans=True),
], ids=["topk", "topk_spans", "topk_span_mode", "exclusion"])
def test_engine_topk_and_exclusion_match_reference(kw, batch):
    q, r, qlens = batch
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    _equal(_tsdtw(q, r, qlens, **kw), _jsdtw(q, r, qlens, **jkw), str(kw))


def test_single_query_returns_scalar(batch):
    q, r, _ = batch
    got = _tsdtw(q[0], r, return_spans=True)
    assert all(g.ndim == 0 for g in got)
    _equal(got, _jsdtw(q[0], r, return_spans=True))


def test_ragged_buckets_match_reference(rng):
    lengths = [3, 17, 5, 40, 16, 1]
    qs = [rng.integers(-30, 30, n).astype(np.int32) for n in lengths]
    qs[1] = qs[1].astype(np.int16)
    r = rng.integers(-30, 30, 90).astype(np.int32)
    assert tengine.bucketize(lengths) == jengine.bucketize(lengths)
    for blen, idxs in tengine.bucketize(lengths).items():
        _equal(list(tengine.pad_ragged_bucket(qs, idxs, blen)),
               list(jengine.pad_ragged_bucket(qs, idxs, blen)))
    for kw in ({}, dict(return_spans=True), dict(top_k=2)):
        _equal(_tsdtw(qs, r, **kw),
               _jsdtw(qs, jnp.asarray(r), **kw), str(kw))
    with pytest.raises(ValueError, match="empty"):
        tengine.bucketize([3, 0])


def test_ragged_list_on_a_cuda_backend_takes_the_kernel(rng, monkeypatch):
    """A ragged list passes exclusion arrays of -1 to every bucket. On a
    CUDA backend ``impl='auto'`` now resolves each bucket to the kernel,
    which reads the empty ranges as no ban. Here the dispatch is asked as
    for the card, and the kernel's CPU stand-in runs; the answers are the
    reference's."""
    import repro_torch.kernels.sdtw.ops as ops
    chosen, bans = [], []
    real_choose = tengine.choose_impl_explained
    real_plain = ops.sdtw_kernel_plain

    def as_on_the_card(*a, **kw):
        if kw["backend"] != "cuda" and "top_k" in kw:   # the dispatch
            decision = real_choose(*a, **dict(kw, backend="cuda"))
            chosen.append((kw["has_exclusion"], decision[0]))
            return decision
        return real_choose(*a, **kw)

    def plain(*a):
        bans.append(a[-2:])
        return real_plain(*a)
    monkeypatch.setattr(tengine, "choose_impl_explained", as_on_the_card)
    monkeypatch.setattr(ops, "sdtw_kernel_plain", plain)
    qs = [rng.integers(-30, 30, n).astype(np.int32) for n in (3, 17, 40)]
    r = rng.integers(-30, 30, 90).astype(np.int32)
    got = _tsdtw(qs, r, return_spans=True)
    assert chosen == [(True, "pallas")] * 3
    assert bans == [(None, None)] * 3
    _equal(got, _jsdtw(qs, jnp.asarray(r), return_spans=True))


@pytest.mark.parametrize("m,route", [(60, "rowscan"), (14, "wavefront")])
@pytest.mark.parametrize("mode", ["positions", "spans"])
def test_fully_banned_rows_on_the_kernel_route_answer_as_the_row_scan(
        mode, m, route, rng, monkeypatch):
    """Exclusion ranges under ``impl='auto'`` take the kernel on a CUDA
    backend, where the reference's rule 3 passes them on to its rules
    4-6. Where those pick the row scan (M ≥ 2N), a query banned on every
    column reports end (and start) 0, the row scan's argmin over an
    all-BIG row, not the kernel's -1; where they pick the wavefront
    (M < 2N), -1 as it does. Every output, fully banned rows included,
    equals the JAX package's ``engine.sdtw``. Here the dispatch is asked
    as for the card, and the kernel's CPU stand-in runs; both packages run
    with ``tune='off'``, whose rules 5-6 pick the route named."""
    import repro_torch.kernels.sdtw.ops as ops
    chosen, banned = [], []
    real_choose = tengine.choose_impl_explained
    real_plain = ops.sdtw_kernel_plain

    def as_on_the_card(*a, **kw):
        if "top_k" in kw:                       # the dispatch
            chosen.append(real_choose(*a, **dict(kw, backend="cuda"))[0])
            return real_choose(*a, **dict(kw, backend="cuda"))
        return real_choose(*a, **kw)

    def plain(*a):
        banned.append(a[-1] is not None)
        return real_plain(*a)
    monkeypatch.setattr(tengine, "choose_impl_explained", as_on_the_card)
    monkeypatch.setattr(ops, "sdtw_kernel_plain", plain)
    q = rng.integers(-30, 30, (5, 9)).astype(np.int32)
    r = rng.integers(-30, 30, m).astype(np.int32)
    assert jengine.choose_impl(5, 9, m, backend="cpu", tune="off",
                               has_exclusion=True) == route
    lo = np.array([0, 2, 0, 10, -5], np.int32)
    hi = np.array([2**31 - 1, 5, m, 12, 100], np.int32)     # 3 fully banned
    kw = dict(return_positions=mode == "positions",
              return_spans=mode == "spans", tune="off")
    got = _tsdtw(q, r, excl_lo=lo, excl_hi=hi, **kw)
    assert chosen == ["pallas"] and banned == [True]
    want = _jsdtw(q, r, excl_lo=jnp.asarray(lo), excl_hi=jnp.asarray(hi),
                  **kw)
    _equal(got, want)
    assert (got[0][[0, 2, 4]] == 2**29).all()
    assert (got[-1][[0, 2, 4]] == (0 if route == "rowscan" else -1)).all()


# ---------------------------------------------------------------------------
# The request surface
# ---------------------------------------------------------------------------

_REJECTED = [
    (dict(impl="vibes"), ValueError),
    (dict(excl_lo=5), ValueError),
    (dict(impl="rowscan", chunk=8), ValueError),
    (dict(impl="wavefront", chunk=8), ValueError),
    (dict(impl="rowscan", top_k=2), ValueError),
    (dict(impl="pallas", top_k=2), ValueError),
    (dict(top_k=0), ValueError),
    (dict(excl_mode="span"), ValueError),
    (dict(excl_mode="nope"), ValueError),
    (dict(tune="fast"), ValueError),
    (dict(impl="pallas", excl_lo=1, excl_hi=3), ValueError),
    (dict(n_micro=2), ValueError),
]


@pytest.mark.parametrize("kw,exc", _REJECTED,
                         ids=[str(k) for k, _ in _REJECTED])
def test_validation_messages_match_reference(kw, exc):
    q = np.zeros((2, 4), np.int32)
    r = np.zeros(16, np.int32)
    with pytest.raises(exc) as want:
        jengine.sdtw(jnp.asarray(q), jnp.asarray(r), **kw)
    with pytest.raises(exc) as got:
        _tsdtw(q, r, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(mesh_shape=(1, 1), impl="pallas"),
    dict(mesh_shape=(1, 1), impl="rowscan"),
    dict(mesh_shape=(1, 1), impl="chunked"),
    dict(mesh_shape=(1, 1), mesh="m"),
    dict(mesh_shape=(2,)),
    dict(mesh_shape=(1, 1), top_k=2, return_positions=True),
    dict(op="search_topk", top_k=1, mesh_shape=(1, 1)),
    dict(op="search_topk", top_k=1, prune=True, mesh_shape=(1, 1)),
], ids=str)
def test_sharded_options_validate_as_in_the_reference(kw):
    """The sharded engine's front-door checks (a mesh with an in-core or
    single-device impl, with pruning, with both ``mesh`` and
    ``mesh_shape``, a shape the world cannot hold) raise the JAX
    package's messages."""
    from repro.core.request import SdtwRequest as JRequest
    if kw.get("mesh") == "m":
        from repro.distributed import get_mesh as jget_mesh
        from repro_torch.distributed import get_mesh
        jkw, tkw = dict(kw, mesh=jget_mesh()), dict(kw, mesh=get_mesh())
    else:
        jkw = tkw = kw
    with pytest.raises(ValueError) as want:
        JRequest(queries=jnp.zeros((1, 4), jnp.int32),
                 reference=jnp.zeros(8, jnp.int32), **jkw).run()
    with pytest.raises(ValueError) as got:
        SdtwRequest(queries=np.zeros((1, 4), np.int32),
                    reference=np.zeros(8, np.int32), device="cpu",
                    **tkw).run()
    assert str(got.value) == str(want.value)


def test_request_priority_and_tenant_as_in_the_reference(batch):
    """``priority`` and ``tenant`` are validated request fields, as in the
    reference, and ``run()`` ignores them; a bool priority or an
    unhashable tenant raises the reference's message."""
    q, r, _ = batch
    req = SdtwRequest.from_kwargs(queries=q, reference=r, priority=2,
                                  tenant="a", device="cpu")
    assert (req.priority, req.tenant) == (2, "a")
    _equal(req.run(), _tsdtw(q, r))
    for kw in (dict(priority=True), dict(priority=1.5), dict(tenant=[1])):
        with pytest.raises(ValueError) as want:
            jengine.SdtwRequest.from_kwargs(queries=jnp.asarray(q),
                                            reference=jnp.asarray(r),
                                            **kw).run()
        with pytest.raises(ValueError) as got:
            SdtwRequest.from_kwargs(queries=q, reference=r, device="cpu",
                                    **kw).run()
        assert str(got.value) == str(want.value)


def test_request_equals_kwargs_and_rejects_unknown(batch):
    q, r, qlens = batch
    req = SdtwRequest.from_kwargs(queries=q, reference=r, qlens=qlens,
                                  return_spans=True, device="cpu")
    _equal(req.run(), _tsdtw(q, r, qlens, return_spans=True))
    with pytest.raises(ValueError, match="unknown"):
        SdtwRequest.from_kwargs(queries=q, refrence=r)


# ---------------------------------------------------------------------------
# matsa(mode="query_filtering")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
def test_matsa_query_filtering_matches_reference(metric, rng):
    q = rng.integers(-40, 40, (6, 10)).astype(np.int32)
    r = rng.integers(-40, 40, 80).astype(np.int32)
    sizes = np.array([10, 4, 7, 1, 9, 10])
    want = jmatsa(r, q, query_sizes=sizes, dist_metric=metric)
    thr = int(np.median(np.asarray(want.distances)))
    want = jmatsa(r, q, query_sizes=sizes, dist_metric=metric,
                  anomaly_threshold=thr)
    got = tmatsa(r, q, query_sizes=sizes, dist_metric=metric,
                 anomaly_threshold=thr, device="cpu")
    _equal(got.distances, want.distances)
    _equal(got.anomalies, want.anomalies)
    assert got.window_starts is None and got.profile is None
    plain = tmatsa(r, q[0], device="cpu")
    assert plain.anomalies is None and plain.distances.shape == (1,)


def test_matsa_synthetic_human_like_slice_matches_reference():
    """A few queries of the Human shape from the same seed and generator."""
    rng = np.random.default_rng(5)
    ref = tmatsa_api.synthetic_timeseries(rng, 600)
    q = np.stack([tmatsa_api.synthetic_timeseries(rng, 120)
                  for _ in range(3)])
    _equal(tmatsa(ref, q, device="cpu").distances, jmatsa(ref, q).distances)


def test_matsa_long_queries_match_reference(rng):
    """Queries longer than the rows kernel's 1536 samples (and than the
    shared memory of a wavefront block): ``matsa()`` answers as the JAX
    package does."""
    ref = rng.integers(-50, 50, 80).astype(np.int32)
    qs = rng.integers(-50, 50, (2, 5000)).astype(np.int32)
    _equal(tmatsa(ref, qs, anomaly_threshold=9000, device="cpu").distances,
           jmatsa(jnp.asarray(ref), jnp.asarray(qs),
                  anomaly_threshold=9000).distances)


def test_matsa_errors():
    r = np.zeros(32, np.int32)
    for kw, match in ((dict(mode="nope"), "mode"),
                      (dict(mode="self_join"), "window"),
                      (dict(mode="query_filtering"), "queries")):
        with pytest.raises(ValueError, match=match):
            tmatsa(r, device="cpu", **kw)
    from repro.distributed import get_mesh as jget_mesh
    from repro_torch.distributed import get_mesh
    r = np.arange(32, dtype=np.int32) % 7
    _equal(tmatsa(r, mode="self_join", window=8, mesh=get_mesh(),
                  device="cpu").distances,
           jmatsa(jnp.asarray(r), mode="self_join", window=8,
                  mesh=jget_mesh()).distances)


def test_workload_shapes_and_generator_match_reference():
    assert (tmatsa_api.load_real_workload_shapes()
            == jmatsa_api.load_real_workload_shapes())
    for seed, size, dtype in ((5, 512, np.int32), (6, 64, np.float32)):
        np.testing.assert_array_equal(
            tmatsa_api.synthetic_timeseries(np.random.default_rng(seed),
                                            size, dtype=dtype),
            jmatsa_api.synthetic_timeseries(np.random.default_rng(seed),
                                            size, dtype=dtype))


# ---------------------------------------------------------------------------
# The card is the default; the package stands alone
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q = np.zeros((1, 4), np.int32)
    r = np.zeros(8, np.int32)
    for call in (lambda: tmatsa(r, q), lambda: tengine.sdtw(q, r),
                 lambda: SdtwRequest(queries=q, reference=r).run()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_import_pulls_in_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.core.engine, "
            "repro_torch.kernels.sdtw.ops, repro_torch.kernels.sdtw._build; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    src = str(pathlib.Path(__file__).parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stdout + proc.stderr
