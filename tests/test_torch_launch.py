"""The port's launch layer — the roofline (``launch/roofline.py``), the
cell builder (``launch/specs.py``) and the dry run (``launch/dryrun.py``)
— against the JAX package's, on the CPU.

In process:
  * ``model_flops`` equals the reference's float for all 40 (arch ×
    shape) cells; ``roofline(..., hw=V5E)``, ``kernel_roofline`` and the
    HLO-text ``collective_bytes`` equal the reference's; the H100 is the
    default, and ``roofline_fraction`` divides by the peak the terms were
    priced with (a deliberate difference: the reference always divides
    by V5E's);
  * ``input_specs`` (shapes and dtypes) and ``run_config_for`` equal the
    reference's for every cell;
  * a 2-layer reduced llama decode with a ``float8_e4m3fn`` cache equals
    the reference's with its fp8 cache (``FP8_TOL``).

In subprocesses (``tests/_torch_launch_check.py``; a fake world is a
process's default process group):
  * on a fake world of 512 ranks, the batch and cache spec trees (both kv
    layouts), the train-state specs and the ``_maybe_fp8_cache``
    decisions of every cell on the (16, 16) and (2, 16, 16) production
    meshes equal the reference's on ``AbstractMesh``, and each rank's
    train-state bytes, summed over its DTensor shards, equal the sum
    over the reference's PartitionSpecs;
  * a fake (1, 1) run and a real CPU run of one 2-layer reduced train
    step count the same flops;
  * on 4 gloo ranks, prefill and decode on caches placed by every
    layout of ``cache_spec_tree``, and the SSM stacks' loss and
    gradients, equal the unsharded run (``GLOO_TOL``);
  * ``python -m repro_torch.launch.dryrun --device cpu`` returns ``ok``
    for llama3.2-1b train_4k and qwen1.5-32b decode_32k (fp8 cache) on
    (16, 16) and ``skipped`` for a quadratic arch's long_500k.
"""
import dataclasses
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
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro import models as jm
from repro.distributed import Axes as JAxes
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.optim import OptConfig as JOptConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jinit_state
from repro_torch import models as tm
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs

from test_torch_lm_serve import cache_close
from test_torch_models import serve_both

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in sorted(jconfigs.all_archs()) for s in SHAPES]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: fp8 cache, bf16 compute, 2-layer reduced llama against the reference.
#: Measured: logits 7.3e-3 (the bf16-cache run 5.5e-3, held at 2e-2 in
#: ``test_torch_lm_serve.py``); 4-6 % of the cache entries one e4m3 step
#: apart (the bf16 K/V they round from differ in their last bits), 0.25
#: at the largest magnitude 3.5: held at one step at the largest
#: magnitude, an eighth of it.
FP8_TOL = {"logits": 2e-2, "cache": 1 / 8}
#: Sharded against unsharded on 4 gloo ranks, fp32 compute: caches'
#: logits (measured ≤ 1.5e-6 at fp32, ≤ 1.5e-5 with the fp8 cache) and
#: leaves (fp32: ≤ 2.1e-5 absolute; fp8: one fp8 step, at most an eighth
#: of the leaf's largest magnitude); the SSM stacks' loss (≤ 4.8e-7 at
#: ~5.5) and gradients (≤ 9.3e-6 of their largest magnitude).
GLOO_TOL = {"logits": 1e-4, "cache_fp32": 1e-4, "fp8_step": 1 / 8,
            "loss": 1e-5, "grad": 1e-4}


@pytest.fixture
def one_thread():
    """Keep a test's own ops on one thread beside the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    return res


def _check(mode, where, timeout=300):
    res = _run([str(ROOT / "tests" / "_torch_launch_check.py"), mode,
                str(where)], timeout)
    errs = "".join(p.read_text() for p in pathlib.Path(where).parent.glob(
        "**/*.err")) if mode == "gloo" else ""
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:] + errs


# ---------------------------------------------------------------------------
# The roofline.
# ---------------------------------------------------------------------------

def test_model_flops_equals_reference_for_every_cell():
    assert len(CELLS) == 40
    for a, s in CELLS:
        want = jroof.model_flops(jconfigs.get_arch(a), jconfigs.SHAPES[s])
        got = troof.model_flops(get_arch(a), SHAPES[s])
        assert got == want, (a, s, got, want)


def test_roofline_at_v5e_and_kernel_roofline_equal_reference():
    args = (3.1e14, 7.7e11, 4.4e10, 5.5e16, 256)
    want = jroof.roofline(*args).to_dict()
    got = troof.roofline(*args, hw=troof.V5E).to_dict()
    assert {k: got[k] for k in want} == want
    for kw in ({"cells_per_s": 2e12, "hbm_bw": 3.35e12},
               {"cells_per_s": 1e9, "hbm_bw": 1e9}, {"cells_per_s": 0.0}):
        for cells, nbytes in ((1e12, 1e9), (0.0, 4e9)):
            want = jroof.kernel_roofline(cells, nbytes, **kw)
            got = troof.kernel_roofline(
                cells, nbytes, **dict({"hbm_bw": jroof.V5E["hbm_bw"]}, **kw))
            assert got == want, (cells, nbytes, kw)
    from repro_torch.tune import cost
    assert cost.kernel_roofline is troof.kernel_roofline


def test_h100_is_the_default_and_roofline_fraction_uses_its_peak():
    """The deliberate difference: the reference divides by V5E's peak
    whatever ``hw`` priced the terms."""
    h = troof.H100
    assert (h["peak_flops"], h["hbm_bw"], h["ici_bw"], h["hbm_bytes"]) == \
        (989e12, 3.35e12, 50e9, 80e9)
    t = troof.roofline(989e12, 3.35e12, 50e9, 989e12 * 256, 256)
    assert np.isclose(t.compute_s, 1.0) and np.isclose(t.memory_s, 1.0)
    assert np.isclose(t.collective_s, 1.0)
    assert np.isclose(t.roofline_fraction, 1.0)
    ref = jroof.roofline(989e12, 3.35e12, 50e9, 989e12 * 256, 256,
                         hw=dict(peak_flops=989e12, hbm_bw=3.35e12,
                                 ici_bw=50e9))
    assert np.isclose(ref.roofline_fraction, 989e12 / 197e12)
    assert troof.kernel_roofline(0.0, 3.35e12, cells_per_s=1.0) == \
        (1.0, "memory")


def test_collective_parser_equals_reference():
    hlo = """
  %ag = bf16[4,1024]{1,0} all-gather(bf16[2,1024]{1,0} %x), replica_groups={}
  %ar.1 = f32[128]{0} all-reduce(f32[128]{0} %y), to_apply=%sum
  %ars = f32[64]{0} all-reduce-start(f32[64]{0} %z)
  %ard = f32[64]{0} all-reduce-done(f32[64]{0} %ars)
  %t = (f32[32]{0}, f32[32]{0}) all-to-all(f32[32]{0} %a, f32[32]{0} %b)
  %cp = u32[2]{0} collective-permute(u32[2]{0} %c)
  %rs = bf16[8,16]{1,0} reduce-scatter(bf16[64,16]{1,0} %d)
"""
    assert troof.collective_bytes(hlo) == jroof.collective_bytes(hlo)
    assert troof.collective_bytes(hlo)["bytes"]["all-reduce"] == \
        128 * 4 + 64 * 4


def test_local_counter_counts_a_plain_collective():
    """The MoE's plain ``dist.all_to_all_single`` (a c10d op, which no
    DTensor op issues) is counted with the bytes it writes."""
    res = _run(["-c", (
        "import json, torch, torch.distributed as dist\n"
        "from repro_torch.launch import dryrun, roofline\n"
        "dryrun.init_fake_world(4)\n"
        "c = roofline.LocalCounter()\n"
        "with c:\n"
        "    out = torch.empty(8, 16)\n"
        "    dist.all_to_all_single(out, torch.ones(8, 16))\n"
        "    dist.all_reduce(torch.ones(4))\n"
        "    torch.ones(2, 3) @ torch.ones(3, 5)\n"
        "print(json.dumps([c.collectives(), c.flops]))\n")])
    assert res.returncode == 0, res.stderr[-3000:]
    coll, flops = json.loads(res.stdout.strip().splitlines()[-1])
    assert coll["bytes"]["all-to-all"] == 8 * 16 * 4
    assert coll["counts"] == {"all-reduce": 1, "all-gather": 0,
                              "reduce-scatter": 0, "all-to-all": 1,
                              "collective-permute": 0}
    assert flops == 2 * 2 * 3 * 5


# ---------------------------------------------------------------------------
# The cell builder.
# ---------------------------------------------------------------------------

def test_input_specs_and_run_config_equal_reference():
    fields = ("remat", "attn_mode", "attn_chunk", "scan_layers",
              "pad_heads")
    for a, s in CELLS:
        jcfg, tcfg = jconfigs.get_arch(a), get_arch(a)
        want = jspecs.input_specs(jcfg, jconfigs.SHAPES[s], jm.RunConfig())
        got = tspecs.input_specs(tcfg, SHAPES[s], tm.RunConfig())
        assert set(got) == set(want), (a, s)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == w.shape, (a, s, k)
            assert str(got[k].dtype)[6:] == str(w.dtype), (a, s, k)
    for s in SHAPES:
        for over in (None, {"attn_mode": "triangular", "remat": "dots"}):
            want = jspecs.run_config_for(jconfigs.SHAPES[s], over)
            got = tspecs.run_config_for(SHAPES[s], over)
            assert all(getattr(got, f) == getattr(want, f) for f in fields)
            assert got.compute_dtype == torch.bfloat16
            assert got.cache_dtype == torch.bfloat16


def test_build_cell_stand_ins_hold_no_storage():
    """Meta stand-ins; serving cells hold bf16 parameters only."""
    from repro_torch.distributed import Axes
    cfg = get_arch("qwen1.5-32b")
    for s, kind in (("train_4k", "train_step"),
                    ("prefill_32k", "prefill_step"),
                    ("decode_32k", "serve_step")):
        cell = tspecs.build_cell(cfg, SHAPES[s], Axes())
        assert cell.description == f"{kind} {cfg.name} {s}"
        leaves = [t for t in troof._leaves(cell.args)]
        assert leaves and all(t.device.type == "meta" for t in leaves)
        if kind != "train_step":
            params = cell.args[0]
            assert {p.dtype for p in params.parameters()} == \
                {torch.bfloat16}
            assert params.compute_params(torch.bfloat16) is params


def _ref_cell(a, s, mesh):
    jcfg = jconfigs.get_arch(a)
    shape = jconfigs.SHAPES[s]
    axes = JAxes.from_mesh(AbstractMesh(*mesh))
    run = jspecs.run_config_for(shape)
    cache = jax.eval_shape(lambda: jm.init_cache(
        jcfg, shape.global_batch, shape.seq_len, run))
    flat = lambda tree: {  # noqa: E731
        "/".join(str(getattr(k, "key", k)) for k in path): [
            list(e) if isinstance(e, tuple) else e for e in spec]
        for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x,
                                               jax.sharding.PartitionSpec))[0]}
    return {"batch": flat(jspecs.batch_spec_tree(jcfg, shape, axes)),
            "cache": {lay: flat(jspecs.cache_spec_tree(jcfg, shape, axes,
                                                       cache, lay))
                      for lay in ("dh", "seq")},
            "fp8": jspecs._maybe_fp8_cache(
                jcfg, shape, dataclasses.replace(axes, mesh=_Devices(mesh)),
                run).cache_dtype == jnp.float8_e4m3fn}


class _Devices:
    """What ``_maybe_fp8_cache`` reads of a mesh (``devices.size``), which
    an ``AbstractMesh`` does not implement."""

    def __init__(self, mesh):
        self.devices = np.zeros(mesh[0])


def _ref_state(a, mesh):
    jcfg = jconfigs.get_arch(a)
    axes = JAxes.from_mesh(AbstractMesh(*mesh))
    shapes = jax.eval_shape(lambda: jinit_state(
        jcfg, jm.init_lm(jcfg, jax.random.PRNGKey(0)),
        JTrainConfig(opt=JOptConfig())))
    specs = jspecs.tree_specs(shapes, axes, "train")
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    flat_l = jax.tree_util.tree_leaves(shapes)
    out, nbytes = {}, 0
    for (path, spec), leaf in zip(flat_s, flat_l):
        out["/".join(str(getattr(k, "key", k)) for k in path)] = [
            list(e) if isinstance(e, tuple) else e for e in spec]
        parts = 1
        for e in spec:
            for name in (e if isinstance(e, tuple) else (e,)):
                if name is not None:
                    parts *= dict(zip(mesh[1], mesh[0]))[name]
        nbytes += leaf.size * leaf.dtype.itemsize // parts
    return out, nbytes


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _norm(spec):
    return [e[0] if isinstance(e, list) and len(e) == 1 else e
            for e in spec]


@pytest.fixture(scope="module")
def port_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "specs.json"
    _check("specs", out)
    return json.loads(out.read_text())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_trees_and_fp8_equal_reference_on_a_fake_world(port_specs,
                                                            mesh):
    n_fp8 = 0
    for a, s in CELLS:
        got = port_specs[f"{mesh}/{a}/{s}"]
        want = _ref_cell(a, s, MESHES[mesh])
        assert {k: _norm(v) for k, v in got["batch"].items()} == \
            {k: _norm(v) for k, v in want["batch"].items()}, (a, s)
        for lay in ("dh", "seq"):
            assert {k: _norm(v) for k, v in
                    _flatten(got["cache"][lay]).items()} == \
                {k: _norm(v) for k, v in want["cache"][lay].items()}, \
                (a, s, lay)
        assert got["fp8"] == want["fp8"], (a, s)
        n_fp8 += got["fp8"]
    assert port_specs[f"{mesh}/qwen1.5-32b/decode_32k"]["fp8"]
    assert n_fp8 >= 1


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_state_specs_and_rank_bytes_equal_reference(port_specs, mesh):
    for a in sorted(jconfigs.all_archs()):
        got = port_specs[f"{mesh}/{a}/train_4k"]
        want, nbytes = _ref_state(a, MESHES[mesh])
        assert {k: _norm(v) for k, v in got["state"].items()} == \
            {k: _norm(v) for k, v in want.items()}, a
        assert got["state_bytes"] == nbytes, (a, got["state_bytes"], nbytes)


# ---------------------------------------------------------------------------
# The fp8 cache, sharded caches, and the dry run.
# ---------------------------------------------------------------------------

def test_fp8_cache_decode_equals_reference():
    logits, caches = serve_both(
        "llama3.2-1b", jm.RunConfig(remat="none",
                                    cache_dtype=jnp.float8_e4m3fn),
        tm.RunConfig(cache_dtype=torch.float8_e4m3fn))
    from test_torch_models import close
    for what, got, want in logits:
        close(got, want, atol=FP8_TOL["logits"], rtol=0, what=what)
    for what, got, want in caches:
        assert got["k"].dtype == torch.float8_e4m3fn
        cache_close(got, want, FP8_TOL["cache"], what + ": ")


def test_fake_and_real_runs_count_the_same_flops(tmp_path):
    out = tmp_path / "flops.json"
    _check("flops", out)
    got = json.loads(out.read_text())
    assert got["fake"] == got["real"] > 0
    assert np.isfinite(got["loss"])
    mem = got["memory"]
    assert mem["live_bytes"] >= mem["argument_bytes"] > 0
    assert mem["alias_bytes"] > 0        # the state is updated in place


def test_sharded_caches_equal_unsharded_on_4_gloo_ranks(tmp_path,
                                                        one_thread):
    _check("gloo", tmp_path / "gloo", timeout=400)
    got = json.loads((tmp_path / "gloo" / "gloo.json").read_text())
    assert len(got) == 13
    for key, r in got.items():
        if key.endswith("/grads"):
            assert r["loss"] <= GLOO_TOL["loss"], (key, r)
            assert r["grad"] <= GLOO_TOL["grad"] * r["grad_scale"], (key, r)
            continue
        assert r["logits"] <= GLOO_TOL["logits"], (key, r)
        for k, d in r["cache"].items():
            if "float8" in key and k != "pos":
                assert d <= GLOO_TOL["fp8_step"] * r["cache_scale"][k], \
                    (key, k, r)
            else:
                assert d <= GLOO_TOL["cache_fp32"], (key, k, r)


@pytest.mark.parametrize("arch,shape,status", [
    ("llama3.2-1b", "train_4k", "ok"),
    ("qwen1.5-32b", "decode_32k", "ok"),
    ("phi3-medium-14b", "long_500k", "skipped")])
def test_dryrun_cli_on_the_cpu(tmp_path, arch, shape, status, one_thread):
    res = _run(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                "--shape", shape, "--acct", "extrapolated", "--device",
                "cpu", "--out", str(tmp_path)])
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rec = json.loads((tmp_path / f"16x16__{arch}__{shape}.json")
                     .read_text())
    assert rec["status"] == status, rec
    assert res.stdout.strip().splitlines()[-1] == (
        "done: ok=1 err=0 skipped=0" if status == "ok" else
        "done: ok=0 err=0 skipped=1")
    if status == "skipped":
        assert rec["reason"].startswith("full-attention arch")
        return
    mem = rec["memory_analysis_scanned"]
    assert mem["live_bytes"] > 0 and "fits_80gb_hbm" in mem
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["roofline"]["n_chips"] == 256
    assert rec["roofline"]["peak_flops"] == 989e12
    assert rec["roofline"]["model_flops"] == troof.model_flops(
        get_arch(arch), SHAPES[shape])
    if shape == "decode_32k":          # 40 kv heads, 5.5 TB of bf16 KV
        assert rec["run_config"]["cache_dtype"] == "float8_e4m3fn"
