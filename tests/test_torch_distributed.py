"""repro_torch.distributed (the sharded sDTW engine on torch.distributed)
and the sharded stream session against the JAX package.

Single process: the mirror of ``tests/test_sharded_builder.py`` at world
1 (no process group: the mesh is this process alone, as the JAX package
on one device sees a one-device mesh), the front doors' sharded
validation (messages equal to the JAX package's), and snapshots moving
between the two packages in both directions.

Multi-rank: ``tests/_torch_distributed_check.py`` starts 8 gloo ranks on
the CPU in a subprocess (``torch.multiprocessing``, a file rendezvous
under ``tmp_path``) on the meshes of ``tests/test_distributed.py::
test_distributed_sdtw_mesh_shapes`` and a 1-D ``("ref",)`` mesh; every
rank's answers are held against the JAX package's single-device
``sdtw_chunked`` and ``StreamSession`` computed here (the JAX package's
own test holds its sharded path equal to those on these meshes); on
the (2, 4) mesh the JAX package's own sharded session, on 8 forced host
devices in a subprocess, snapshots the same stream and restores the
port's snapshot.

Tolerances: int32 bitwise; float32 within ``rtol=1e-5``, the reference
check's tolerance (its inputs are integer-valued, so the port's float32
is in fact bitwise too).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sdtw_sharded as jshmod
from repro.core import engine as jengine
from repro.core import matsa as jmatsa
from repro.core.sdtw import sdtw_chunked as jchunked
from repro.core.sdtw_ref import sdtw_ref
from repro.distributed import get_mesh as jget_mesh
from repro.distributed import pipeline_axes as jpipeline_axes
from repro.search import search_topk as jsearch
from repro.stream import ShardedStreamSession as JSharded
from repro.stream import StreamSession as JStreamSession
import repro_torch.distributed.sdtw_sharded as shmod
from repro_torch.core import align, engine, matsa
from repro_torch.distributed import get_mesh, pipeline_axes
from repro_torch.distributed.sdtw_sharded import (_cache_size,
                                                  clear_pipeline_cache,
                                                  default_mesh,
                                                  make_schedule,
                                                  sdtw_sharded)
from repro_torch.search import search_topk
from repro_torch.stream import ShardedStreamSession
from repro_torch.tune import resolve_n_micro, tuned_n_micro

from _torch_distributed_check import make_case, run_ranks

RNG = np.random.default_rng(7)
QS = RNG.integers(-40, 40, (5, 6)).astype(np.int32)
R = RNG.integers(-40, 40, (97,)).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(y) for y in x]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want, msg=""):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want), msg
        for g, w in zip(got, want):
            _equal(g, w, msg)
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (
        msg, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _tsdtw(*a, **kw):
    return engine.sdtw(*a, device="cpu", **kw)


def _jsdtw(*a, **kw):
    return jengine.sdtw(*[jnp.asarray(x) if isinstance(x, np.ndarray)
                          else x for x in a], **kw)


def _raises_like(exc, port, ref):
    """``port()`` raises ``exc`` with the message ``ref()`` raises."""
    with pytest.raises(exc) as want:
        ref()
    with pytest.raises(exc) as got:
        port()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# get_mesh / pipeline_axes at world 1
# ---------------------------------------------------------------------------

def test_get_mesh_shapes():
    assert len(jax.devices()) == 1
    m = get_mesh()
    assert m.axis_names == ("mp",) and m.shape["mp"] == 1
    m = get_mesh((1, -1))
    assert m.axis_names == ("dp", "mp")
    assert m.shape["dp"] == 1 and m.shape["mp"] == 1
    m = get_mesh(1)                          # int → (-1, k), redco-style
    assert m.shape == {"dp": 1, "mp": 1}
    m = get_mesh((-1,), ("ref",))
    assert m.axis_names == ("ref",)
    for args in ((), ((1, -1),), (1,), ((-1,), ("ref",))):
        want = jget_mesh(*args)
        got = get_mesh(*args)
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape)
    assert get_mesh((1, -1)) is get_mesh((1, 1))    # groups made once
    assert get_mesh().coords() == {"mp": 0}


@pytest.mark.parametrize("args", [
    ((1, 1, 1),), ((-1, -1),), ((0, 1),), ((3, 7),), ((-1, 4),),
    ((1, -1), ("only_one",))], ids=str)
def test_get_mesh_rejects_bad_shapes(args):
    _raises_like(ValueError, lambda: get_mesh(*args),
                 lambda: jget_mesh(*args))


def test_pipeline_axes_resolution():
    assert pipeline_axes(default_mesh("ref")) == (None, "ref")
    assert pipeline_axes(get_mesh((1, -1))) == ("dp", "mp")
    assert pipeline_axes(get_mesh()) == (None, "mp")
    m = get_mesh((1, -1), ("rows", "ref"))
    assert pipeline_axes(m, ref_axis="ref") == ("rows", "ref")
    _raises_like(ValueError,
                 lambda: pipeline_axes(get_mesh((1, -1)), dp_axis="nope"),
                 lambda: jpipeline_axes(jget_mesh((1, -1)), dp_axis="nope"))
    _raises_like(ValueError,
                 lambda: pipeline_axes(get_mesh((1, -1), ("a", "b"))),
                 lambda: jpipeline_axes(jget_mesh((1, -1), ("a", "b"))))


# ---------------------------------------------------------------------------
# make_schedule
# ---------------------------------------------------------------------------

def test_make_schedule_defaults_and_packing():
    for nq, nm in ((5, None), (5, 5), (3, 2)):
        got = make_schedule(get_mesh((1, -1)), nq=nq, n_micro=nm)
        want = jshmod.make_schedule(jget_mesh((1, -1)), nq=nq, n_micro=nm)
        assert (got.dp_axis, got.mp_axis, got.n_dp, got.n_mp, got.n_micro,
                got.mb, got.nq) == (want.dp_axis, want.mp_axis, want.n_dp,
                                    want.n_mp, want.n_micro, want.mb,
                                    want.nq)
    sched = make_schedule(get_mesh((1, -1)), nq=5, n_micro=2)
    packed = sched.pack(torch.from_numpy(QS))
    assert packed.shape == (sched.slots, sched.mb, QS.shape[1])
    _equal(packed, jshmod.make_schedule(jget_mesh((1, -1)), nq=5,
                                        n_micro=2).pack(jnp.asarray(QS)))
    _equal(sched.unpack(packed), QS)
    _equal(sched.pack(torch.arange(5, dtype=torch.int32), fill=-1)
           .reshape(-1), np.array([0, 1, 2, 3, 4, -1], np.int32))


@pytest.mark.parametrize("nq,n_micro", [(3, 5), (3, 0), (1, None)])
def test_make_schedule_rejects_excess_n_micro(nq, n_micro):
    mesh, jmesh = get_mesh(), jget_mesh()
    if n_micro is None:                      # the default clamps
        assert make_schedule(mesh, nq=nq).n_micro == 1
        return
    _raises_like(ValueError,
                 lambda: make_schedule(mesh, nq=nq, n_micro=n_micro),
                 lambda: jshmod.make_schedule(jmesh, nq=nq, n_micro=n_micro))


# ---------------------------------------------------------------------------
# sharded == the JAX package's sharded path on the one-rank mesh
# ---------------------------------------------------------------------------

def _both_sharded(kind, **kw):
    """The port's and the JAX package's ``sdtw_sharded`` on ``kind``'s
    mesh, on QS and R."""
    t_mesh, j_mesh = ((default_mesh("ref"), jshmod.default_mesh("ref"))
                      if kind == "1d_ref" else
                      (get_mesh((1, -1)), jget_mesh((1, -1))))
    got = sdtw_sharded(QS, R, mesh=t_mesh, device="cpu", **kw)
    want = jshmod.sdtw_sharded(jnp.asarray(QS), jnp.asarray(R), mesh=j_mesh,
                               **kw)
    return got, want


@pytest.mark.parametrize("kind", ["1d_ref", "2d_dp_mp"])
@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_sharded_matches_chunked_bitwise(kind, route, monkeypatch):
    """Batch, top-K in both modes, positions and spans equal the JAX
    package's sharded path (and so its chunked path). ``kernel`` drives
    each rank's segment through the kernel's chunk carry (its plain
    version on these CPU tensors): one launch a segment, the last row
    folded ``chunk`` columns at a time."""
    if route == "kernel":
        monkeypatch.setattr(shmod, "_kernel_route", lambda device: True)
    for kw in (dict(chunk=8), dict(chunk=8, return_positions=True),
               dict(chunk=8, return_spans=True),
               dict(chunk=8, top_k=1, return_spans=True),
               dict(chunk=8, top_k=3, excl_zone=4, excl_mode="end",
                    return_spans=True),
               dict(chunk=8, top_k=3, excl_zone=4, excl_mode="span",
                    return_spans=True),
               dict(chunk=8, top_k=3), dict(chunk=32, top_k=2,
                                            excl_lo=np.full(5, 20),
                                            excl_hi=np.full(5, 60))):
        got, want = _both_sharded(kind, **kw)
        _equal(got, want, str(kw))
    want = jchunked(jnp.asarray(QS), jnp.asarray(R), chunk=8, top_k=3,
                    excl_zone=4, return_spans=True)
    _equal(_both_sharded(kind, chunk=8, top_k=3, excl_zone=4,
                         return_spans=True)[0], want)


def test_sharded_n_micro_invariance():
    mesh = default_mesh("ref")
    want = sdtw_sharded(QS, R, chunk=8, mesh=mesh, device="cpu")
    for nm in (1, 2, 5):                     # 5 == nq: ragged tail gone
        got = sdtw_sharded(QS, R, chunk=8, mesh=mesh, n_micro=nm,
                           device="cpu")
        _equal(got, want, f"n_micro={nm}")
        _equal(got, jshmod.sdtw_sharded(jnp.asarray(QS), jnp.asarray(R),
                                        chunk=8, n_micro=nm))


def test_tuned_n_micro_as_in_the_reference():
    from repro.tune import resolve_n_micro as jresolve
    from repro.tune import tuned_n_micro as jtuned
    for nq, n_dp, n_mp in ((5, 1, 1), (17, 2, 4), (1, 1, 8), (256, 1, 4)):
        assert tuned_n_micro(nq, n_dp, n_mp) == jtuned(nq, n_dp, n_mp)
        for mode in ("off", "model"):
            assert (resolve_n_micro(nq, n_dp, n_mp, n=6, m=97,
                                    backend="cpu", mode=mode)
                    == jresolve(nq, n_dp, n_mp, n=6, m=97, mode=mode))


# ---------------------------------------------------------------------------
# engine front-door knobs + validation
# ---------------------------------------------------------------------------

def test_engine_mesh_shape_knob():
    want = _jsdtw(QS, R, chunk=8, mesh_shape=(1, -1))
    _equal(_tsdtw(QS, R, chunk=8, mesh_shape=(1, -1)), want)
    _equal(_tsdtw(QS, R, chunk=8), want)
    _equal(_tsdtw(QS, R, chunk=8, impl="sharded"), want)
    got, dec = _tsdtw(QS, R, chunk=8, mesh_shape=(1, -1), explain=True)
    _, jdec = _jsdtw(QS, R, chunk=8, mesh_shape=(1, -1), explain=True)
    assert (dec.impl, dec.source, dec.reason, dec.config) == (
        jdec.impl, jdec.source, jdec.reason, jdec.config)
    _raises_like(ValueError,
                 lambda: _tsdtw(QS, R, mesh=get_mesh(), mesh_shape=(1, -1)),
                 lambda: _jsdtw(QS, R, mesh=jget_mesh(), mesh_shape=(1, -1)))
    # ragged lists shard bucket by bucket
    qs = [QS[0], QS[1, :4], QS[2, :3]]
    _equal(_tsdtw(qs, R, chunk=8, mesh_shape=(1, -1), top_k=2,
                  return_spans=True),
           _jsdtw([np.asarray(q) for q in qs], R, chunk=8,
                  mesh_shape=(1, -1), top_k=2, return_spans=True))


_SHARDED_REJECTED = [
    dict(n_micro=2),
    dict(mesh_shape=(1, -1), top_k=2, excl_zone=np.arange(5)),
    dict(mesh_shape=(1, -1), top_k=2, return_positions=True),
    dict(mesh_shape=(1, -1), n_micro=6),
    dict(mesh_shape=(1, -1), impl="pallas"),
    dict(mesh_shape=(1, -1), impl="rowscan"),
    dict(mesh_shape=(1, -1), impl="wavefront"),
    dict(mesh_shape=(1, -1), impl="chunked"),
    dict(mesh_shape=(3, 1)),
    dict(impl="sharded", excl_zone=np.arange(5), top_k=2),
]


@pytest.mark.parametrize("kw", _SHARDED_REJECTED, ids=str)
def test_engine_sharded_validation(kw):
    _raises_like(ValueError, lambda: _tsdtw(QS, R, **kw),
                 lambda: _jsdtw(QS, R, **kw))


@pytest.mark.parametrize("kw", [
    dict(n_micro=2), dict(mesh_shape=(1, 1), prune=True, top_k=1),
    dict(impl="sharded", alert_threshold=3.0),
    dict(impl="sharded", ref_key="k"), dict(impl="sharded", span_cap=8),
    dict(impl="sharded", excl_zone=np.arange(5), top_k=2),
    dict(impl="sharded", excl_mode="x", top_k=2),
    dict(mesh_shape=(1, 1), mesh="a stub")], ids=str)
def test_stream_sharded_validation(kw):
    if "mesh" in kw:
        kw = dict(kw, mesh=object())
    _raises_like(ValueError, lambda: engine.stream(QS, device="cpu", **kw),
                 lambda: jengine.stream(jnp.asarray(QS), **kw))


@pytest.mark.parametrize("kw", [
    dict(), dict(prune=True), dict(excl_zone=np.array([1, 2])),
    dict(excl_mode="span", excl_zone=2), dict(excl_lo=5, excl_hi=40)],
    ids=str)
def test_search_mesh_validation_and_route(kw):
    """``search_topk(mesh=)`` refuses pruning with the reference's message
    and, with ``prune=False``, equals its result."""
    kw = {"prune": False, **kw}
    port = lambda: search_topk(QS, R, k=2, mesh=get_mesh(), device="cpu",
                               **kw)
    ref = lambda: jsearch(jnp.asarray(QS), jnp.asarray(R), k=2,
                          mesh=jget_mesh(), **kw)
    if kw["prune"] or np.ndim(kw.get("excl_zone", 0)):
        _raises_like(ValueError, port, ref)
        return
    got, want = port(), ref()
    for f in ("distances", "positions", "starts"):
        _equal(getattr(got, f), getattr(want, f), f)
    assert (got.chunk, got.chunks_total, got.chunks_processed) == (
        want.chunk, want.chunks_total, want.chunks_processed)


def test_matsa_and_align_on_a_mesh():
    ref = np.random.default_rng(3).integers(-50, 50, 300).astype(np.int32)
    got = matsa(ref, QS, mesh=get_mesh(), device="cpu")
    want = jmatsa(jnp.asarray(ref), jnp.asarray(QS), mesh=jget_mesh())
    _equal(got.distances, want.distances)
    sj = matsa(ref, mode="self_join", window=16, stride=16, mesh=get_mesh(),
               device="cpu")
    jsj = jmatsa(jnp.asarray(ref), mode="self_join", window=16, stride=16,
                 mesh=jget_mesh())
    _equal(sj.distances, jsj.distances)
    got = align(QS, ref, mesh=get_mesh(), device="cpu")
    want = jengine.align(jnp.asarray(QS), jnp.asarray(ref), mesh=jget_mesh())
    for g, w in zip(got, want):
        assert (g.distance, g.start, g.end) == (w.distance, w.start, w.end)
        _equal(g.path, w.path)


# ---------------------------------------------------------------------------
# bounded pipeline cache
# ---------------------------------------------------------------------------

def test_pipeline_cache_bounded_and_fingerprint_keyed(monkeypatch):
    def run(**kw):
        return sdtw_sharded(QS, R, chunk=8, device="cpu", **kw)
    clear_pipeline_cache()
    assert _cache_size() == 0
    run()
    assert _cache_size() == 1
    run()                                    # same config: no new entry
    assert _cache_size() == 1
    run(mesh=default_mesh("ref"))            # an equal mesh: same entry
    assert _cache_size() == 1
    run(top_k=2)                             # new config: new entry
    assert _cache_size() == 2
    monkeypatch.setattr(shmod, "PIPELINE_CACHE_MAX", 2)
    run(top_k=3)                             # eviction keeps it bounded
    assert _cache_size() == 2
    clear_pipeline_cache()
    assert _cache_size() == 0
    with pytest.raises(ValueError, match="entry"):
        shmod.build_pipeline(get_mesh(), dp_axis=None, mp_axis="mp",
                             metric="abs_diff", chunk=8, n_micro=1,
                             entry="x")


# ---------------------------------------------------------------------------
# ShardedStreamSession on a (1, 1) mesh, and across packages
# ---------------------------------------------------------------------------

def _same(got, want, fields=("distances", "starts", "positions")):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        _equal(g, w, f)
    assert (got.samples, got.tiles_total) == (want.samples, want.tiles_total)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_sharded_session_on_2d_mesh_matches_single_process(route,
                                                           monkeypatch):
    if route == "kernel":
        monkeypatch.setattr(shmod, "_kernel_route", lambda device: True)
    for kw in (dict(top_k=2, return_spans=True),
               dict(top_k=3, excl_zone=4, excl_mode="span"), dict(),
               dict(return_positions=True)):
        sh = ShardedStreamSession(QS, mesh=get_mesh((1, -1)), chunk=8,
                                  device="cpu", **kw)
        jsh = JSharded(jnp.asarray(QS), mesh=jget_mesh((1, -1)), chunk=8,
                       **kw)
        sp = JStreamSession(jnp.asarray(QS), chunk=8, **kw)
        for off in range(0, R.shape[0], 17):
            for s in (sh, jsh, sp):
                s.feed(R[off:off + 17])
        _same(sh.results(), jsh.results())
        _equal(sh.results().distances, sp.results().distances)
        # snapshot → restore keeps the (dp, mp) layout
        sh2 = ShardedStreamSession.restore(sh.snapshot(),
                                           mesh=get_mesh((1, -1)),
                                           device="cpu")
        _same(sh2.results(), sh.results())
        for s in (sh, jsh):
            s.flush()
        _same(sh.results(), jsh.results())
        with pytest.raises(RuntimeError, match="finalized"):
            sh.feed(R[:8])
    snap = sh.snapshot()
    meta = json.loads(str(snap["meta"]))
    snap["meta"] = np.array(json.dumps(dict(meta, ndev=2)))
    _raises_like(ValueError,
                 lambda: ShardedStreamSession.restore(snap, device="cpu"),
                 lambda: JSharded.restore(snap))


def _snap_np(snap):
    return {k: np.asarray(v) for k, v in snap.items()}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_sharded_snapshot_restores_across_packages(direction):
    """A sharded session snapshotted mid-stream by one package restores
    in the other and continues bitwise; the snapshots themselves are
    equal, leaf by leaf."""
    kw = dict(chunk=8, top_k=3, return_spans=True, excl_zone=3)
    port = engine.stream(QS, mesh=get_mesh(), device="cpu", **kw)
    ref = jengine.stream(jnp.asarray(QS), mesh=jget_mesh(), **kw)
    for s in (port, ref):
        s.feed(R[:45])
    psnap, jsnap = _snap_np(port.snapshot()), _snap_np(ref.snapshot())
    assert json.loads(str(psnap["meta"])) == json.loads(str(jsnap["meta"]))
    assert sorted(psnap) == sorted(jsnap)
    for k in psnap:
        if k != "meta":
            _equal(psnap[k], jsnap[k], k)
    if direction == "port_to_jax":
        moved = JSharded.restore(psnap, mesh=jget_mesh())
    else:
        moved = ShardedStreamSession.restore(jsnap, mesh=get_mesh(),
                                             device="cpu")
    for s in (moved, port, ref):
        s.feed(R[45:])
    _same(moved.results(), ref.results())
    _same(port.results(), ref.results())


def test_sharded_session_rejections_as_in_the_reference():
    for kw in (dict(excl_zone=np.arange(5), top_k=2), dict(excl_mode="x"),
               dict(chunk=0)):
        _raises_like(ValueError,
                     lambda: ShardedStreamSession(QS, device="cpu", **kw),
                     lambda: JSharded(jnp.asarray(QS), **kw))
    _raises_like(ValueError,
                 lambda: ShardedStreamSession([QS[0], QS[1]], device="cpu"),
                 lambda: JSharded([QS[0], QS[1]]))
    s = ShardedStreamSession(QS, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        s.feed(np.zeros((2, 2), np.int32))
    s.feed(R[:5])
    with pytest.raises(ValueError, match="dtype"):
        s.feed(R[:5].astype(np.float32))


# ---------------------------------------------------------------------------
# 8 gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _expected(case):
    """The JAX package's single-device answers for ``check_sdtw``."""
    j = {k: jnp.asarray(v) for k, v in case.items()}
    want = {}
    for dt in ("int32", "float32"):
        want[f"batch_{dt}"] = np.array(
            [sdtw_ref(case[f"q8_{dt}"][i], case[f"r8_{dt}"])
             for i in range(8)]).astype(dt)
    cd, cp = jchunked(j["q9"], j["r9"], chunk=8, top_k=3, excl_zone=4)
    want["topk_d"], want["topk_p"] = cd, cp
    want["pos_d"], want["pos_p"] = cd[:, 0], cp[:, 0]
    for name, x in zip("dse", jchunked(j["q10"], j["r10"], chunk=8,
                                       return_spans=True)):
        want[f"spans_{name}"] = x
    for mode in ("end", "span"):
        for name, x in zip("dse", jchunked(j["q10"], j["r10"], chunk=8,
                                           top_k=3, excl_zone=4,
                                           excl_mode=mode,
                                           return_spans=True)):
            want[f"topk_spans_{mode}_{name}"] = x
    r11 = case["r11"]
    sp = JStreamSession(j["q11"], chunk=4)
    for off in range(0, 97, 17):
        sp.feed(r11[off:off + 17])
    want["stream_plain"] = sp.results().distances
    for mode in ("end", "span"):
        sp = JStreamSession(j["q11"], chunk=4, top_k=3, excl_zone=4,
                            excl_mode=mode, return_spans=True)
        for off in range(0, 97, 13):
            sp.feed(r11[off:off + 13])
        res = sp.results()
        for f in ("distances", "starts", "positions"):
            want[f"stream_{mode}_{f}"] = getattr(res, f)
    sp = JStreamSession(j["q11"], chunk=4, top_k=3, return_spans=True)
    sp.feed(r11[:64])
    sp.feed(r11[64:])
    res = sp.results()
    for tag in ("live", "restored"):
        for f in ("distances", "starts", "positions"):
            want[f"snap_{tag}_{f}"] = getattr(res, f)
    sweep = jchunked(j["q12"], j["r12"], chunk=8, top_k=3, excl_zone=4,
                     return_spans=True)
    for nm in case["sweep"].tolist():
        for name, x in zip("dse", sweep):
            want[f"sweep{nm}_{name}"] = x
    return {k: np.asarray(v) for k, v in want.items()}


#: The JAX package's sharded session on 8 forced host devices (a
#: subprocess, as ``tests/test_distributed.py`` runs it): it snapshots
#: mid-stream on a (2, 4) mesh and restores the port's snapshot there.
_JAX_SHARDED_SESSION = """
import json, sys
import jax.numpy as jnp
import numpy as np
from repro.distributed import get_mesh
from repro.stream import ShardedStreamSession
case, port_snap = dict(np.load(sys.argv[1])), dict(np.load(sys.argv[2]))
mesh = get_mesh((2, 4))
s = ShardedStreamSession(jnp.asarray(case["q11"]), mesh=mesh, chunk=4,
                         top_k=3, return_spans=True)
s.feed(case["r11"][:64])
out = {"snapshot_" + k: np.asarray(v) for k, v in s.snapshot().items()}
moved = ShardedStreamSession.restore(port_snap, mesh=mesh)
moved.feed(case["r11"][64:])
res = moved.results()
for f in ("distances", "starts", "positions"):
    out["moved_" + f] = np.asarray(getattr(res, f))
np.savez(sys.argv[3], **out)
"""


def _jax_sharded_session(tmp_path, case, port_snap):
    np.savez(tmp_path / "jcase.npz", **case)
    np.savez(tmp_path / "psnap.npz", **port_snap)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1]
                            / "src")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED_SESSION,
         str(tmp_path / "jcase.npz"), str(tmp_path / "psnap.npz"),
         str(tmp_path / "jout.npz")], env=env, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(tmp_path / "jout.npz"))


_MESHES = [((8,), ("ref",), (1, 2, 4, 8, 16), False),
           ((1, 8), None, (1, 2, 4, 8, 16), False),
           ((2, 4), None, (1, 2, 4, 8), False),
           ((4, 2), None, (1, 2, 4), False),
           ((2, 4), None, (1, 2, 4, 8), True)]


@pytest.mark.parametrize(
    "shape,axes,sweep,kernel", _MESHES,
    ids=["8_ref", "1x8", "2x4", "4x2", "2x4_kernel_route"])
def test_sharded_engine_and_stream_on_8_gloo_ranks(tmp_path, shape, axes,
                                                   sweep, kernel):
    """Every rank's answers — batch (int32 and float32), top-K and
    positions, spans and the span heap in both modes, the sharded stream
    in both modes with snapshot and restore, the n_micro sweep on 17
    queries — equal the JAX package's single-device answers."""
    case = make_case(sweep)
    ranks = run_ranks(case, tmp_path, 8, shape, axes=axes, kernel=kernel)
    want = _expected(case)
    for r, got in enumerate(ranks):
        for key, w in want.items():
            g = got[key]
            assert g.dtype == w.dtype and g.shape == w.shape, (r, key)
            if w.dtype == np.float32:
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           err_msg=f"rank {r} {key}")
            else:
                np.testing.assert_array_equal(g, w,
                                              err_msg=f"rank {r} {key}")
        for key in got:
            if key.startswith("snapshot_"):
                _equal(got[key], ranks[0][key], f"rank {r} {key}")
    if shape == (2, 4) and not kernel:
        # Across packages at 8 ranks: the JAX package's snapshot of the
        # same session equals the port's leaf by leaf, and it restores the
        # port's and continues bitwise.
        port_snap = {k[len("snapshot_"):]: v for k, v in ranks[0].items()
                     if k.startswith("snapshot_")}
        jout = _jax_sharded_session(tmp_path, case, port_snap)
        for key, w in jout.items():
            if key == "snapshot_meta":
                assert (json.loads(str(ranks[0][key]))
                        == json.loads(str(w)))
            elif key.startswith("snapshot_"):
                _equal(ranks[0][key], w, key)
            else:
                _equal(w, want["snap_live_" + key[len("moved_"):]], key)
