"""The port's sharded LM (``repro_torch.distributed`` ``Axes``,
``compressed_psum``, ``pipeline``; ``launch.{mesh,specs}``; the models,
the train step, the checkpoint and ``launch.train`` under a mesh) against
the JAX package, on the CPU.

In process: the port's sharding rules (``launch.specs.tree_specs``) equal
the reference's PartitionSpecs leaf by leaf for every reduced arch's train
state on a (2, 2) and a (2, 2, 2) mesh (the reference's on an
``AbstractMesh``, which needs no devices), ``Axes`` equals the
reference's, and the mesh builders check their shapes.

On 8 gloo ranks (``tests/_torch_sharded_lm_check.py``, one spawn for
every section) the sections of ``tests/_distributed_check.py`` that the
installed jax cannot run (it builds Explicit-axis meshes): the
reference asserts that sharded equals mesh-free, so each is held
against the JAX package's mesh-free
answer on the same numpy-seeded inputs and weights, at the reference's
tolerances:
  * sharded ``loss_fn`` on (2, 2) (and the hybrid's, whose SSM layers
    the reference constrains too): ``rtol=2e-5``; greedy tokens through
    the sharded prefill and decode (a dense and a MoE arch): equal;
  * MoE a2a and replicated paths on (2, 2), ``n_experts=4, topk=2,
    cf=4.0`` (nothing drops): ``atol=2e-5``; aux, a mean of per-shard aux
    values, within ``rtol=1e-5`` of the reference's per-shard formula and
    ``rtol=0.1`` of its global aux on the reference check's input;
  * ``compressed_psum`` on (8,): bitwise the reference's under
    ``jax.vmap(axis_name="d")``, and within one quantisation step of the
    mean;
  * ``pad_heads`` on (2, 4) (kv = 2 heads, 4-way axis): ``rtol=2e-5``;
  * the multi-pod (2, 2, 2) train step: loss and gradient norm
    ``rtol=2e-5``; the moments and the update itself against the JAX
    mesh-free step's (``MOMENT_RTOL``, ``UPDATE_ATOL``);
  * the elastic restore (2, 2, 2) → (4, 2) and one finite step; the
    checkpoint restores in the JAX package bitwise;
  * GPipe on (4,) ``("stage",)``: ``atol=1e-5`` against the sequential
    run.
And ``python -m repro_torch.launch.train --mesh 2x2`` on 4 gloo ranks
against the JAX launcher's ``--mesh 1x1`` run with the same flags and
weights (``--data tsa``, a failure and a restore), both in fp32: losses
within ``rtol=2e-5``.
"""
import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import models as jm
from repro import optim as jopt
from repro.distributed import Axes as JAxes
from repro.distributed import collectives as jcol
from repro.launch import specs as jspecs
from repro.launch import train as jlaunch
from repro.models import moe as jmoe
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jinit_state
from repro.train import make_train_step as jmake_step
from repro.train import serve_step as jserve
from repro_torch import models as tm
from repro_torch.configs import all_archs, get_arch
from repro_torch.distributed import Axes, Mesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import tree_specs
from repro_torch.models.layers import Init
from repro_torch.train import TrainConfig, init_train_state

from _torch_sharded_lm_check import flatten, run_ranks

KEY = jax.random.PRNGKey(0)
JRUN = jm.RunConfig(remat="none", attn_mode="dense",
                    compute_dtype=jnp.float32)
#: The multi-pod train step's first update against the JAX mesh-free
#: step's. The moments m = (1 - b1)·g and v = (1 - b2)·g² within
#: MOMENT_RTOL of each leaf's largest |value| (the gradient's summation
#: order differs). The update itself (updated master - master), about
#: ±lr = 2e-5 an element at step 1, within UPDATE_ATOL = lr / 200, where
#: the reference's gradient is above GRAD_FLOOR of its leaf's largest:
#: 10× the gradient's tolerance, so its sign is the reference's (below,
#: g/|g| may flip; at most MAX_EXCLUDED of the elements are there).
MOMENT_RTOL, UPDATE_ATOL, GRAD_FLOOR, MAX_EXCLUDED = 1e-5, 1e-7, 1e-4, 0.01


# ---------------------------------------------------------------------------
# In process: the sharding rules and the mesh builders.
# ---------------------------------------------------------------------------

def _norm(entry):
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 \
        else entry


def _port_mesh(shape, names):
    """A port mesh of ``shape`` (no process group needed for the rules)."""
    def nest(a):
        return tuple(nest(x) for x in a) if a.ndim > 1 else \
            tuple(a.tolist())
    return Mesh(tuple(names), nest(np.arange(np.prod(shape)).reshape(shape)))


def _ref_specs(name, mesh_shape, names, mode):
    jcfg = jconfigs.get_arch(name).reduced()
    jtc = JTrainConfig(grad_compression="int8_ef")
    shapes = jax.eval_shape(
        lambda: jinit_state(jcfg, jm.init_lm(jcfg, KEY), jtc))
    jaxes = JAxes.from_mesh(AbstractMesh(mesh_shape, names))
    specs = jspecs.tree_specs(shapes, jaxes, mode)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(p)
            for path, p in flat}, shapes


@pytest.mark.parametrize("mesh_shape,names", [
    ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))])
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_tree_specs_equal_reference_for_every_arch(mesh_shape, names, mode):
    axes = Axes.from_mesh(_port_mesh(mesh_shape, names))
    for name in sorted(all_archs()):
        cfg = get_arch(name).reduced()
        want, _ = _ref_specs(name, mesh_shape, names, mode)
        lm = tm.LM(cfg, Init(torch.device("meta")))
        state = init_train_state(cfg, lm, TrainConfig(
            grad_compression="int8_ef"))
        got = tree_specs(state, axes, mode)
        seen = set()
        for path, spec in got.items():
            if "blocks" in path:
                at = path.index("blocks")
                key = path[:at + 1] + path[at + 2:]
                spec = (None,) + spec
            else:
                key = path
            assert tuple(map(_norm, spec)) == tuple(map(_norm, want[key])), (
                name, path, spec, want[key])
            seen.add(key)
        assert seen == set(want), (name, set(want) ^ seen)


def test_axes_equal_reference():
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model")),
                         ((4,), ("stage",)), ((2, 4), ("data", "model"))):
        got = Axes.from_mesh(_port_mesh(shape, names))
        want = JAxes.from_mesh(AbstractMesh(shape, names))
        assert (got.dp, got.tp, got.sp) == (want.dp, want.tp, want.sp)
        assert got.tp_size == want.tp_size
        for n in (0, 3, 4, 10, 40):
            assert got.tp_if_divisible(n) == want.tp_if_divisible(n)
        for dims in (("dp", None, "tp"), ("sp", "tp"), ("tp", "dp", None),
                     (None,), ()):
            assert tuple(map(_norm, got.spec(*dims))) == \
                tuple(map(_norm, want.spec(*dims))), dims
    none = Axes.from_mesh(None)
    assert none == Axes(mesh=None, dp=(), tp=None, sp=None)
    assert none.tp_size == 1 and none.sharding("dp") is None
    x = torch.ones(2, 3)
    assert none.constrain(x, "dp", None) is x and none.place(x, "dp") is x


def test_mesh_builders_check_their_shapes():
    m = tmesh.make_mesh((1, 1), ("data", "model"))
    assert m.shape == {"data": 1, "model": 1} and m.ranks.tolist() == [[0]]
    assert tmesh.make_mesh((1,), ("stage",)).shape == {"stage": 1}
    assert tmesh.make_mesh((1, 1, 1), ("pod", "data", "model")).axis_names \
        == ("pod", "data", "model")
    for multi_pod, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        with pytest.raises(ValueError) as got:
            tmesh.make_production_mesh(multi_pod=multi_pod)
        with pytest.raises(ValueError) as want:
            jax.make_mesh(shape, ("pod", "data", "model")[-len(shape):])
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tmesh.make_mesh((1, 1), ("data",))
    with pytest.raises(ValueError):
        tmesh.make_mesh((0,), ("stage",))
    assert tmesh.get_mesh().shape == {"mp": 1}
    with pytest.raises(RuntimeError, match="process group"):
        m.device_mesh("cpu")


# ---------------------------------------------------------------------------
# 8 gloo ranks: sections 1-7 of tests/_distributed_check.py.
# ---------------------------------------------------------------------------

def _case():
    """The inputs and the JAX package's weights, as numpy."""
    rng = np.random.default_rng(21)
    cfg = jconfigs.get_arch("llama3.2-1b").reduced()
    case = {"batch/tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32),
            "batch/labels": rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)}
    params = jm.init_lm(cfg, KEY)
    state = jinit_state(cfg, params, JTrainConfig(opt=jopt.OptConfig(
        lr=1e-3)))
    case.update(flatten(jax.tree.map(np.asarray, params), "params"))
    case.update(flatten(jax.tree.map(np.asarray, state["opt"]), "opt"))
    hcfg = jconfigs.get_arch("zamba2-2.7b").reduced()
    case.update(flatten(jax.tree.map(np.asarray, jm.init_lm(hcfg, KEY)),
                        "hybrid_params"))
    mcfg = dataclasses.replace(
        jconfigs.get_arch("qwen3-moe-30b-a3b").reduced(), n_experts=4,
        topk=2, capacity_factor=4.0)
    case.update(flatten(jax.tree.map(np.asarray, jm.init_lm(mcfg, KEY)),
                        "moe_params"))
    case["moe_x"] = rng.normal(size=(2, 8, mcfg.d_model)).astype(np.float32)
    # the input tests/_distributed_check.py:88 draws for its aux check
    case["moe_x_ref"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (2, 8, mcfg.d_model), jnp.float32))
    case["psum_vals"] = rng.normal(size=(8, 64)).astype(np.float32)
    case["gen_prompt"] = rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32)
    case["pp_w"] = (0.3 * rng.normal(size=(8, 16, 16))).astype(np.float32)
    case["pp_x"] = rng.normal(size=(6, 4, 16)).astype(np.float32)
    return case, cfg, params, state, hcfg, mcfg


def _key(prefix, name):
    """A rank's key of a state tensor named ``name`` under ``prefix``."""
    return prefix + "/" + name.replace(".", "/")


def _per_shard_aux(moe, x):
    """The a2a path's aux on (2, 2) as the reference's ``shard_map`` body
    computes it: each shard's Switch aux over its tokens (batch over
    data, sequence over model), averaged."""
    auxs = [jmoe._route(x[bi:bi + 1, si * 4:(si + 1) * 4].reshape(
        -1, x.shape[-1]), moe["router"], 4, 2)[2]
        for bi in range(2) for si in range(2)]
    return float(np.mean(auxs))


def test_sharded_lm_on_8_gloo_ranks(tmp_path):
    case, cfg, params, state, hcfg, mcfg = _case()
    ranks = run_ranks(case, tmp_path, 8)
    r0 = ranks[0]
    batch = {k: jnp.asarray(case[f"batch/{k}"]) for k in ("tokens",
                                                          "labels")}
    loss_ref = float(jm.loss_fn(cfg, params, batch, None, JRUN)[0])

    # 1. sharded loss == mesh-free; the hybrid's too
    for r in range(4):
        np.testing.assert_allclose(float(ranks[r]["loss_2x2"]), loss_ref,
                                   rtol=2e-5)
        hybrid = jm.init_lm(hcfg, KEY)
        np.testing.assert_allclose(
            float(ranks[r]["loss_hybrid"]),
            float(jm.loss_fn(hcfg, hybrid, batch, None, JRUN)[0]), rtol=2e-5)

    # serving: greedy tokens through the sharded prefill and decode ==
    # the JAX package's mesh-free generate
    jrun = dataclasses.replace(JRUN, cache_dtype=jnp.float32)
    prompt = jnp.asarray(case["gen_prompt"])
    for tag, gcfg, gparams in (("llama", cfg, params),
                               ("moe", mcfg, jm.init_lm(mcfg, KEY))):
        want = np.asarray(jserve.generate(gcfg, gparams, prompt, 4, jrun))
        for r in range(4):
            np.testing.assert_array_equal(ranks[r][f"generate_{tag}"], want,
                                          err_msg=tag)

    # 2/3. MoE a2a and replicated paths == mesh-free
    moe = jax.tree.map(lambda p: p[0], jm.init_lm(mcfg, KEY)["blocks"])["moe"]
    x = jnp.asarray(case["moe_x"])
    out_ref, aux_ref = jmoe.moe_mlp(moe, mcfg, x, None)
    out_ref_d, _ = jmoe.moe_mlp(moe, mcfg, x[:, :1], None)
    x_ref = jnp.asarray(case["moe_x_ref"])
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["moe_a2a"], out_ref, atol=2e-5)
        np.testing.assert_allclose(ranks[r]["moe_rep"], out_ref_d,
                                   atol=2e-5)
        # aux is the reference shard_map's mean of per-shard aux values
        # (each of 4 tokens here); near the global aux only with more
        # tokens a shard, so the rtol=0.1 of the reference check holds on
        # that check's own input.
        for key, xx in (("moe_a2a_aux", x), ("moe_ref_aux", x_ref)):
            np.testing.assert_allclose(float(ranks[r][key]),
                                       _per_shard_aux(moe, xx), rtol=1e-5)
        np.testing.assert_allclose(
            float(ranks[r]["moe_ref_aux"]),
            float(jmoe.moe_mlp(moe, mcfg, x_ref, None)[1]), rtol=0.1)

    # 4. compressed_psum == the reference's under vmap, bitwise
    vals = jnp.asarray(case["psum_vals"])
    want = jax.vmap(lambda v: jcol.compressed_psum(v, "d"),
                    axis_name="d")(vals)
    scale = float(jnp.max(jnp.abs(vals))) / 127.0
    for r in range(8):
        np.testing.assert_array_equal(ranks[r]["psum"], np.asarray(want[r]))
        assert float(np.max(np.abs(ranks[r]["psum"]
                                   - case["psum_vals"].mean(0)))) < scale

    # 4b. pad_heads on (2, 4)
    assert cfg.n_kv_heads % 4 != 0
    for r in range(8):
        np.testing.assert_allclose(float(ranks[r]["loss_pad"]), loss_ref,
                                   rtol=2e-5)

    # 5. multi-pod train step == the JAX mesh-free step
    tcfg = JTrainConfig(opt=jopt.OptConfig(lr=1e-3))
    state2, met = jax.jit(jmake_step(cfg, JRUN, tcfg, None))(state, batch)
    for r in range(8):
        np.testing.assert_allclose(float(ranks[r]["pod_loss"]),
                                   float(met["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(ranks[r]["pod_grad_norm"]),
                                   float(met["grad_norm"]), rtol=2e-5)
    cfg_t = get_arch("llama3.2-1b").reduced()
    before = tm.train_state_from_jax(cfg_t, jax.tree.map(np.asarray, state),
                                     "cpu")
    after = tm.train_state_from_jax(cfg_t, jax.tree.map(np.asarray, state2),
                                    "cpu")
    masters = dict(before["params"].named_parameters())
    excluded = total = 0
    for n, p in after["params"].named_parameters():
        for mom in ("m", "v"):
            want_mom = after["opt"][mom][n].numpy()
            np.testing.assert_allclose(
                r0[_key(f"pod_state/opt/{mom}", n)], want_mom, rtol=0,
                atol=MOMENT_RTOL * np.abs(want_mom).max(), err_msg=(mom, n))
        grad = np.abs(after["opt"]["m"][n].numpy())     # (1 - b1)·|g|
        sure = grad > GRAD_FLOOR * grad.max()
        master = masters[n].detach().numpy()
        np.testing.assert_allclose(
            (r0[_key("pod_state/params", n)] - master)[sure],
            (p.detach().numpy() - master)[sure], rtol=0, atol=UPDATE_ATOL,
            err_msg=n)
        excluded, total = excluded + int((~sure).sum()), total + grad.size
    assert excluded <= MAX_EXCLUDED * total, (excluded, total)
    assert int(r0["pod_state/opt/step"]) == 1 == int(state2["opt"]["step"])
    for r in range(8):
        for k in r0:
            if k.startswith("pod_state/"):
                np.testing.assert_array_equal(ranks[r][k], r0[k], err_msg=k)

    # 6. elastic restore onto (4, 2): the saved state, then a finite step;
    # the checkpoint restores in the JAX package bitwise
    assert "Shard" in str(r0["elastic_placements"])
    for k in r0:
        if k.startswith("restored/"):
            np.testing.assert_array_equal(
                r0[k], r0["pod_state/" + k[len("restored/"):]], err_msg=k)
    for r in range(8):
        assert np.isfinite(float(ranks[r]["elastic_loss"]))
    back, extra, _ = jckpt.restore(str(tmp_path / "ckpt"), state)
    assert extra == {"step": 0}
    port = tm.train_state_from_jax(get_arch("llama3.2-1b").reduced(),
                                   jax.tree.map(np.asarray, back), "cpu")
    for n, p in port["params"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      r0[_key("pod_state/params", n)])
    for n, t in port["opt"]["m"].items():
        np.testing.assert_array_equal(t.numpy(),
                                      r0[_key("pod_state/opt/m", n)])

    # 7. GPipe == sequential
    seq = jnp.asarray(case["pp_x"])
    for i in range(8):
        seq = jnp.tanh(seq @ case["pp_w"][i])
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["pipeline"], np.asarray(seq),
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# launch.train --mesh 2x2 on 4 gloo ranks.
# ---------------------------------------------------------------------------

def test_launch_train_mesh_2x2_matches_reference(tmp_path, capsys,
                                                 monkeypatch):
    """``launch.train --mesh 2x2`` (reduced, ``--data tsa``, a failure at
    step 2 restored from the step-1 checkpoint) prints the losses of the
    JAX launcher's ``--mesh 1x1`` run with the same flags and weights.
    Both compute in fp32 (the launchers' bf16 losses differ between the
    packages by ~5e-5 without a mesh, the packages' bf16 rounding; the
    JSON rounds to 4 decimals)."""
    flags = ["--preset", "reduced", "--data", "tsa", "--fail-at", "2",
             "--ckpt-every", "1", "--steps", "4", "--seq-len", "32",
             "--global-batch", "4"]
    cfg = jconfigs.get_arch("llama3.2-1b").reduced()
    params = jm.init_lm(cfg, jax.random.PRNGKey(0))     # the launcher's
    case = flatten(jax.tree.map(np.asarray, params), "params")
    got = run_ranks(case, tmp_path / "t", 4, launch_argv=flags + [
        "--mesh", "2x2", "--device", "cpu", "--ckpt", str(tmp_path / "tck")])
    monkeypatch.setattr(sys, "argv", ["train", *flags, "--mesh", "1x1",
                                      "--ckpt", str(tmp_path / "jck")])
    monkeypatch.setattr(jlaunch, "RunConfig", functools.partial(
        jm.RunConfig, compute_dtype=jnp.float32))
    jlaunch.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("arch", "steps", "restarts"):
        assert got[k] == want[k], k
    assert got["restarts"] == 1
    for k in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=k)
