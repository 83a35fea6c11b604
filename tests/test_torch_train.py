"""The port's training path (``repro_torch.optim``, the local gradient
compression of ``repro_torch.distributed.collectives``, the differentiable
``models`` forward with remat, ``repro_torch.train``) against the JAX
package's, on the CPU.

Both packages start from one state: the reference's ``init_train_state``
at a fixed key, carried across by ``train_state_from_jax``; batches are
made with numpy from a seed. Tolerances, each stated where it is used:
  * the schedule and AdamW on identical inputs: ``rtol=1e-6`` (float32
    rounding in ``pow``/``cos`` and the norm's summation order);
  * int8 quantisation and error feedback: bitwise (the layers of a
    stacked leaf share its scale, as in the reference's tree);
  * one fp32 train step of every arch at ``reduced()`` size: loss, ``ce``,
    ``aux`` and ``grad_norm`` within ``rtol=1e-5``, every gradient leaf
    within ``GRAD_TOL`` of its largest magnitude (measured at most
    4.5e-5 for the hybrid, ~1e-6 elsewhere); the AdamW update is held on
    the reference's own gradients, since at step 1 it is about
    g/|g| a leaf and a near-zero gradient's sign would flip a parameter
    by 2·lr;
  * remat none/full/dots: equal losses and gradients (``rtol=1e-6``);
  * microbatches 2 against 1: parameters within ``atol=1e-5``, as
    ``tests/test_models.py`` holds the reference.
The reference's step is jitted once per test.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro import optim as jopt
from repro.distributed import collectives as jcol
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jinit_state
from repro.train import make_train_step as jmake_step
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch import optim as topt
from repro_torch.distributed import Axes
from repro_torch.distributed import collectives as tcol
from repro_torch.train import TrainConfig, make_eval_step, make_train_step

KEY = jax.random.PRNGKey(0)
B, S = 2, 16
ARCHS = sorted(jconfigs.all_archs())
JRUN32 = jm.RunConfig(remat="none", compute_dtype=jnp.float32,
                      cache_dtype=jnp.float32)
TRUN32 = tm.RunConfig(remat="none", compute_dtype=torch.float32,
                      cache_dtype=torch.float32)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
#: A gradient leaf's largest difference from the reference's, as a share
#: of the reference leaf's largest magnitude (fp32, reduced configs).
GRAD_TOL = 2e-4


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def both(name, tcfg_kw=None):
    """The reduced arch in both packages, the reference's train state and
    the port's, started from it."""
    jcfg = jconfigs.get_arch(name).reduced()
    tcfg = tconfigs.get_arch(name).reduced()
    kw = dict(opt=OPT, **(tcfg_kw or {}))
    jtc = JTrainConfig(opt=jopt.OptConfig(**kw.pop("opt")), **kw)
    jstate = jinit_state(jcfg, jm.init_lm(jcfg, KEY), jtc)
    return jcfg, tcfg, jstate, tm.train_state_from_jax(tcfg, to_np(jstate),
                                                       "cpu")


def make_batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "stub":
        batch["embeddings"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def named(tcfg, tree):
    """A reference parameter-shaped tree as the port's named tensors."""
    return {n: p.detach() for n, p in
            tm.lm_from_jax(tcfg, to_np(tree), "cpu").named_parameters()}


def t2n(x):
    return x.detach().numpy()


def grads_of(cfg, lm, batch, run):
    names, leaves = zip(*lm.named_parameters())
    loss, _ = tm.loss_fn(cfg, lm, batch, run)
    g = torch.autograd.grad(loss, leaves, allow_unused=True,
                            materialize_grads=True)
    return loss, dict(zip(names, g))


def assert_grads_close(got, want, tol=GRAD_TOL):
    assert set(got) == set(want)
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-12), (n, err)


# ---------------------------------------------------------------------------
# The optimizer.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=7, min_lr_frac=0.0),
    dict(lr=1e-3, warmup_steps=2, total_steps=50)])
def test_schedule_equals_reference(kw):
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.array([jopt.schedule(jopt.OptConfig(**kw), jnp.asarray(t))
                     for t in steps])
    got = np.array([float(topt.schedule(topt.OptConfig(**kw),
                                        torch.tensor(t))) for t in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)     # float32 cos


def random_tree(rng, scale=1.0):
    return {"a": (scale * rng.normal(size=(5, 7))).astype(np.float32),
            "b": (scale * rng.normal(size=(3,))).astype(np.float32),
            "c": (scale * rng.normal(size=(2, 3, 4))).astype(np.float32)}


def test_clip_by_global_norm_equals_reference():
    g = random_tree(np.random.default_rng(1), 3.0)
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in
                                       g.items()}, 1.0)
    tc, tn = topt.clip_by_global_norm({k: torch.tensor(v) for k, v in
                                       g.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(t2n(tc[k]), np.asarray(jc[k]), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_equals_reference(clip):
    """Three steps on identical gradients (clipped or not): parameters,
    moments, step and stats."""
    rng = np.random.default_rng(2)
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip, warmup_steps=1,
               total_steps=10)
    p0 = random_tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jo, to = jopt.init_opt(jp), topt.init_opt(tp)
    for _ in range(3):
        g = random_tree(rng, 2.0)
        jp, jo, js = jopt.adamw_update(jopt.OptConfig(**cfg), jp,
                                       {k: jnp.asarray(v) for k, v in
                                        g.items()}, jo)
        tp, to, ts = topt.adamw_update(topt.OptConfig(**cfg), tp,
                                       {k: torch.tensor(v) for k, v in
                                        g.items()}, to)
        assert to["step"].dtype == torch.int32
        assert int(to["step"]) == int(jo["step"])
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6)
        for k in p0:
            np.testing.assert_allclose(t2n(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                np.testing.assert_allclose(t2n(to[mom][k]),
                                           np.asarray(jo[mom][k]),
                                           rtol=1e-6, atol=1e-9)


def test_adamw_minimises_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    opt = topt.init_opt(params)
    cfg = topt.OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                         total_steps=200, min_lr_frac=1.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}     # d/dw w²
        params, opt, _ = topt.adamw_update(cfg, params, grads, opt)
    assert float(params["w"].abs().max()) < 1e-2


def test_weight_decay_shrinks_params():
    params = {"w": torch.ones(3)}
    opt = topt.init_opt(params)
    cfg = topt.OptConfig(lr=0.1, weight_decay=0.5, warmup_steps=0)
    params2, _, _ = topt.adamw_update(cfg, params, {"w": torch.zeros(3)}, opt)
    assert float(params2["w"][0]) < 1.0


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert np.isclose(float(norm), 20.0)
    assert np.isclose(float(topt.global_norm(clipped)), 1.0, rtol=1e-5)


def test_schedule_shape():
    cfg = topt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    s = lambda t: float(topt.schedule(cfg, torch.tensor(t)))
    assert s(0) < s(9) <= 1.0           # warmup rising
    assert abs(s(10) - 1.0) < 0.1       # peak
    assert s(99) < 0.2                  # decayed
    assert s(99) >= 0.1 * 1.0 - 1e-6    # floor


def test_adamw_groups_bound_the_temporaries(monkeypatch):
    """The in-place update over groups of tensors equals one group."""
    rng = np.random.default_rng(3)
    p0, g = random_tree(rng), random_tree(rng)
    out = []
    for cap in (1 << 26, 8):
        monkeypatch.setattr(topt.adamw, "GROUP_ELEMENTS", cap)
        p = {k: torch.tensor(v) for k, v in p0.items()}
        out.append(topt.adamw_update(topt.OptConfig(lr=0.1), p,
                                     {k: torch.tensor(v) for k, v in
                                      g.items()}, topt.init_opt(p)))
    assert len(list(topt.adamw._groups(list(out[0][0].values()), 8))) == 3
    for k in p0:
        assert torch.equal(out[0][0][k], out[1][0][k])
        assert torch.equal(out[0][1]["v"][k], out[1][1]["v"][k])


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "tiny"])
def test_quantize_int8_bitwise(case):
    rng = np.random.default_rng(4)
    g = {"normal": rng.normal(0, 1, 1000),
         # exact halves of the scale: round half to even on both sides
         "ties": np.arange(-127.5, 128.0, 0.5) * (2.0 / 127.0),
         "zeros": np.zeros(16),
         "tiny": rng.normal(0, 1e-14, 64)}[case].astype(np.float32)
    jq, js = jcol.quantize_int8(jnp.asarray(g))
    tq, ts = tcol.quantize_int8(torch.tensor(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(t2n(tq), np.asarray(jq))
    assert np.asarray(js).tobytes() == t2n(ts).tobytes()
    np.testing.assert_array_equal(
        t2n(tcol.dequantize_int8(tq, ts)),
        np.asarray(jcol.dequantize_int8(jq, js)))


def test_compress_with_feedback_three_steps_bitwise():
    rng = np.random.default_rng(5)
    shapes = {"w": (16, 9), "b": (9,)}
    jfb = jcol.init_feedback({k: jnp.zeros(s) for k, s in shapes.items()})
    tfb = tcol.init_feedback({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in shapes.items()}
        jd, jfb = jcol.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jfb)
        td, tfb = tcol.compress_with_feedback(
            {k: torch.tensor(v) for k, v in g.items()}, tfb)
        for k in shapes:
            np.testing.assert_array_equal(t2n(td[k]), np.asarray(jd[k]))
            np.testing.assert_array_equal(t2n(tfb[k]), np.asarray(jfb[k]))


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(0, 1, 512).astype(np.float32))
    q, s = tcol.quantize_int8(g)
    deq = tcol.dequantize_int8(q, s)
    assert float((deq - g).abs().max()) <= float(s) / 2 + 1e-7


def test_error_feedback_is_unbiased_over_steps():
    """With a constant gradient, error feedback makes the *sum* of delivered
    gradients converge to the sum of true gradients."""
    rng = np.random.default_rng(1)
    g = {"w": torch.tensor(rng.normal(0, 1, 256).astype(np.float32))}
    fb = tcol.init_feedback(g)
    delivered = torch.zeros_like(g["w"])
    n = 50
    for _ in range(n):
        deq, fb = tcol.compress_with_feedback(g, fb)
        delivered = delivered + deq["w"]
    assert float((delivered / n - g["w"]).abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# One train step of every arch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_train_step_equals_reference(name):
    """Loss, metrics and every gradient leaf against JAX's
    ``value_and_grad``; the port's AdamW on the reference's gradients
    against the reference's update; the port's step against its own
    gradients and update."""
    jcfg, tcfg, jstate, state = both(name)
    batch = make_batch(jcfg)
    ocfg = jopt.OptConfig(**OPT)

    @jax.jit
    def ref(params, opt, b):
        (loss, met), g = jax.value_and_grad(
            lambda p: jm.loss_fn(jcfg, p, b, None, JRUN32),
            has_aux=True)(params)
        new_p, new_opt, stats = jopt.adamw_update(ocfg, params, g, opt)
        return loss, met, g, new_p, stats

    jloss, jmet, jg, jnew, jstats = ref(jstate["params"], jstate["opt"],
                                        jbatch(batch))
    lm = state["params"]
    _, grads = grads_of(tcfg, lm, batch, TRUN32)
    assert_grads_close(grads, named(tcfg, jg))

    step = make_train_step(tcfg, TRUN32, TrainConfig(opt=topt.OptConfig(
        **OPT)))
    before = {n: p.detach().clone() for n, p in lm.named_parameters()}
    new, met = step(state, batch)
    assert new["params"] is lm and int(new["opt"]["step"]) == 1
    assert set(met) == {"ce", "aux", "loss", "grad_norm", "lr"}
    assert not any(v.requires_grad for v in met.values())
    for k, want in (("loss", jloss), ("ce", jmet["ce"]),
                    ("aux", jmet["aux"]), ("grad_norm", jstats["grad_norm"]),
                    ("lr", jstats["lr"])):
        np.testing.assert_allclose(float(met[k]), float(want), rtol=1e-5,
                                   atol=1e-7, err_msg=k)

    # The port's step is its AdamW on its own gradients, bitwise.
    own = {n: p.clone() for n, p in before.items()}
    topt.adamw_update(topt.OptConfig(**OPT), own, grads,
                      topt.init_opt(own))
    for n, p in lm.named_parameters():
        assert torch.equal(p.detach(), own[n]), n
    # The port's AdamW on the reference's gradients == the reference.
    again = {n: p.clone() for n, p in before.items()}
    topt.adamw_update(topt.OptConfig(**OPT), again, named(tcfg, jg),
                      topt.init_opt(again))
    for n, want in named(tcfg, jnew).items():
        np.testing.assert_allclose(t2n(again[n]), t2n(want), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_eval_step_and_axes():
    jcfg, tcfg, jstate, state = both("llama3.2-1b")
    batch = make_batch(jcfg, seed=6)
    want = jm.loss_fn(jcfg, jstate["params"], jbatch(batch), None, JRUN32)[0]
    got = make_eval_step(tcfg, TRUN32)(state["params"], batch)
    assert not got["loss"].requires_grad
    np.testing.assert_allclose(float(got["loss"]), float(want), rtol=1e-6)
    # Axes without a mesh are the mesh-free path, as in the reference.
    axes = Axes.from_mesh(None)
    again = make_eval_step(tcfg, TRUN32, axes)(state["params"], batch)
    assert torch.equal(again["loss"], got["loss"])
    _, met = make_train_step(tcfg, TRUN32, TrainConfig(), axes=axes)(
        state, batch)
    np.testing.assert_allclose(float(met["loss"]), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Remat, microbatches, int8 error feedback.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "mamba2-780m", "zamba2-2.7b"])
def test_remat_matches_no_remat(name):
    """none/full/dots: the same loss and gradients (the dense/MoE block,
    the SSM block and the hybrid group are the rematerialised bodies)."""
    cfg = tconfigs.get_arch(name).reduced()
    batch = make_batch(cfg, seed=7)
    out = []
    for remat in ["none", "full", "dots"]:
        lm = tm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        lm.requires_grad_(True)
        run = dataclasses.replace(TRUN32, remat=remat)
        out.append(grads_of(cfg, lm, batch, run))
    for loss, grads in out[1:]:
        np.testing.assert_allclose(loss.item(), out[0][0].item(), rtol=1e-6)
        for n, g in grads.items():
            np.testing.assert_allclose(t2n(g), t2n(out[0][1][n]), rtol=1e-6,
                                       atol=1e-9, err_msg=n)


def test_remat_policies_recompute_what_they_say():
    """The backward recomputes a body's matmuls under ``full`` and keeps
    them under ``dots`` (as without remat), counted in matmul FLOPs
    (``FlopCounterMode``, which sees what each policy runs); an unknown
    policy raises."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = tconfigs.get_arch("llama3.2-1b").reduced()
    lm = tm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    lm.requires_grad_(True)
    batch = make_batch(cfg)
    flops = {}
    for remat in ["none", "full", "dots"]:
        loss, _ = tm.loss_fn(cfg, lm, batch,
                             dataclasses.replace(TRUN32, remat=remat))
        with FlopCounterMode(display=False) as count:
            loss.backward()
        flops[remat] = count.get_flop_counts()["Global"]
    d, f, t = cfg.d_model, cfg.d_ff, B * S
    qkvo = 2 * d * cfg.resolved_head_dim * (2 * cfg.n_heads
                                            + 2 * cfg.n_kv_heads)
    # a block's unbatched products but the last (w_down: no backward
    # needs its output, and the recompute stops once it has what it needs)
    body = t * (qkvo + 2 * 2 * d * f)
    mm = torch.ops.aten.mm
    assert flops["full"][mm] == flops["none"][mm] + cfg.n_layers * body
    assert flops["dots"][mm] == flops["none"][mm], flops
    assert flops["dots"][torch.ops.aten.bmm] == \
        flops["full"][torch.ops.aten.bmm] > flops["none"][torch.ops.aten.bmm]
    with pytest.raises(ValueError):
        tm.RunConfig(remat="everything").checkpoint(lambda x: x)(1)


def test_microbatch_accumulation_matches_full_batch():
    """microbatches=2 against 1 (the reference's own check), and the
    accumulated metrics against the reference's ``lax.scan``."""
    jcfg, tcfg, jstate, _ = both("llama3.2-1b")
    batch = make_batch(jcfg, seed=8, b=4)
    out = {}
    for k in (1, 2):
        state = tm.train_state_from_jax(tcfg, to_np(jstate), "cpu")
        tc = TrainConfig(opt=topt.OptConfig(lr=1e-3), microbatches=k)
        out[k] = make_train_step(tcfg, TRUN32, tc)(state, batch)
    for (n, a), (_, b) in zip(out[1][0]["params"].named_parameters(),
                              out[2][0]["params"].named_parameters()):
        np.testing.assert_allclose(t2n(a), t2n(b), atol=1e-5, err_msg=n)
    jtc = JTrainConfig(opt=jopt.OptConfig(lr=1e-3), microbatches=2)
    _, jmet = jax.jit(jmake_step(jcfg, JRUN32, jtc))(jstate, jbatch(batch))
    for k, v in jmet.items():
        np.testing.assert_allclose(float(out[2][1][k]), float(v), rtol=1e-5,
                                   err_msg=k)


def test_compress_stacked_leaves_bitwise():
    """Named gradients of an ``LM`` quantise as the reference's stacked
    leaves do: one scale for every layer of ``blocks/attn/wq``."""
    jcfg, tcfg, jstate, state = both("zamba2-2.7b")
    rng = np.random.default_rng(9)
    jg = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 1, p.shape)
                                            .astype(np.float32)),
                      jstate["params"])
    jfb = jax.tree.map(lambda p: 0.01 * p, jg)
    jd, jfb2 = jcol.compress_with_feedback(jg, jfb)
    td, tfb2 = tcol.compress_with_feedback(named(tcfg, jg), named(tcfg, jfb))
    for got, want in ((td, named(tcfg, jd)), (tfb2, named(tcfg, jfb2))):
        assert set(got) == set(want)
        for n, w in want.items():
            assert torch.equal(got[n], w), n


def test_int8_ef_three_steps_equal_reference():
    """Three ``int8_ef`` steps, each from the reference's state carried
    across: metrics within ``rtol=1e-5``; the feedback buffers within
    1e-3 of a quantum (the leaf's scale, 2·max|feedback|) but for near
    ties of the rounding, at most 1e-4 of the elements (measured ≤ 2 of
    78,144) and each within one quantum; the parameters within 1e-4
    (measured 3.3e-5), or 2·lr where a tie moved a gradient by a
    quantum."""
    kw = {"grad_compression": "int8_ef"}
    jcfg, tcfg, jstate, _ = both("llama3.2-1b", kw)
    jtc = JTrainConfig(opt=jopt.OptConfig(**OPT), **kw)
    jstep = jax.jit(jmake_step(jcfg, JRUN32, jtc))
    step = make_train_step(tcfg, TRUN32, TrainConfig(
        opt=topt.OptConfig(**OPT), **kw))
    for i in range(3):
        batch = make_batch(jcfg, seed=10 + i)
        state = tm.train_state_from_jax(tcfg, to_np(jstate), "cpu")
        assert set(state) == {"params", "opt", "feedback"}
        jstate, jmet = jstep(jstate, jbatch(batch))
        state, met = step(state, batch)
        for k, v in jmet.items():
            np.testing.assert_allclose(float(met[k]), float(v), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        ties = total = 0
        for n, want in named(tcfg, jstate["feedback"]).items():
            quantum = 2 * float(want.abs().max()) + 1e-30
            d = (state["feedback"][n] - want).abs()
            assert float(d.max()) <= 1.001 * quantum, (i, n)
            ties += int((d > 1e-3 * quantum).sum())
            total += d.numel()
        assert ties <= 1e-4 * total, (i, ties, total)
        got = dict(state["params"].named_parameters())
        moved = 0
        for n, want in named(tcfg, jstate["params"]).items():
            d = (got[n].detach() - want).abs()
            assert float(d.max()) <= 2 * OPT["lr"], (i, n)
            moved += int((d > 1e-4).sum())
        assert moved <= 1e-4 * total, (i, moved)


def test_training_imports_no_jax_and_no_reference():
    """The training packages, the sharded LM's included, import neither
    ``jax`` nor ``repro``."""
    root = pathlib.Path(__file__).parents[1] / "src" / "repro_torch"
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b(?!_torch)",
                     re.M)
    mods = ["optim", "train", "checkpoint", "ft", "launch/train.py",
            "launch/mesh.py", "launch/specs.py", "distributed/sharding.py",
            "distributed/collectives.py", "distributed/pipeline.py",
            "models"]
    for m in mods:
        files = ([root / m] if m.endswith(".py")
                 else sorted((root / m).rglob("*.py")))
        for f in files:
            assert not bad.search(f.read_text()), f
    code = ("import sys, repro_torch.optim, repro_torch.train, "
            "repro_torch.checkpoint, repro_torch.ft, "
            "repro_torch.launch.train, repro_torch.launch.specs, "
            "repro_torch.distributed.pipeline; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(root.parent)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
