"""The LM training path on the card, against the CPU.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_train_cuda.py``. Imports no JAX. Each family's arch,
cut to 2 layers at full width (the hybrid to one group of
``attn_every`` layers), takes one fp32 train step (remat full) on the
card and on the CPU from the same weights and batch; TF32 stays off, so
the two differ only in summation order: loss and grad norm within
``rtol=1e-4``, each gradient leaf within 1e-3 of its largest magnitude
(``chip_smoke.py`` phase 20's tolerances). Then the train step is
deterministic on the card: a run resumed from a checkpoint after an
injected failure, and a second run from the same seed, end with the
same state bitwise (bf16 compute, remat, the MoE's accumulating index
backward included); a step waits for the host nowhere (CUDA's sync
debug mode raises on any synchronising call); and the sharded step on a
one-rank NCCL (1, 1) mesh equals the unsharded one bitwise.
"""
import dataclasses

import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.ft import FailureInjector, RunnerConfig, TrainingRunner
from repro_torch.models.layers import Init
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

pytestmark = pytest.mark.cuda

FAMILIES = ["llama3.2-1b", "granite-moe-1b-a400m", "mamba2-780m",
            "zamba2-2.7b", "musicgen-large"]
TCFG = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=4))
RUN32 = tm.RunConfig(compute_dtype=torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def cut(name):
    cfg = get_arch(name)
    return dataclasses.replace(cfg, n_layers=max(2, cfg.attn_every))


def batch_for(cfg, gen, dev, b=2, s=32):
    batch = {"labels": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev)}
    if cfg.frontend == "stub":
        batch["embeddings"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                          device=dev)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                        device=dev)
    return batch


def tensors(state):
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.nn.Module):
            v = dict(v.named_parameters())
        if isinstance(v, dict):
            out.update({f"{k}/{p}": t for p, t in tensors(v).items()})
        else:
            out[k] = v.detach().cpu()
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_card_equals_cpu_at_fp32(cuda, name):
    cfg = cut(name)
    gen = torch.Generator(device=cuda).manual_seed(20)
    card = tm.init_lm(cfg, gen, cuda)
    cpu = tm.LM(cfg, Init(torch.device("cpu")))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = batch_for(cfg, gen, cuda)
    out = []
    for lm, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        b = {k: v.to(dev) for k, v in batch.items()}
        state = init_train_state(cfg, lm, TCFG)
        names, leaves = zip(*lm.named_parameters())
        loss, _ = tm.loss_fn(cfg, lm, b, RUN32)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        state, met = make_train_step(cfg, RUN32, TCFG)(state, b)
        assert state["opt"]["step"].device.type == dev.type
        out.append((met, {n: g.cpu() for n, g in zip(names, grads)}))
    (mc, gc), (mp, gp) = out
    for k in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(mc[k].cpu(), mp[k], rtol=1e-4, atol=0)
    for n, g in gp.items():
        err = float((gc[n] - g).abs().max())
        assert err <= 1e-3 * float(g.abs().max()), (n, err)


def run(cfg, dev, root, fail=(), steps=3):
    data = SyntheticLM(DataConfig(seed=5, seq_len=64, global_batch=2,
                                  vocab=cfg.vocab,
                                  embeddings_dim=cfg.d_model
                                  if cfg.frontend == "stub" else 0))
    lm = tm.init_lm(cfg, torch.Generator(device=dev).manual_seed(21), dev)
    runner = TrainingRunner(
        make_train_step(cfg, tm.RunConfig(), TCFG), data,
        init_train_state(cfg, lm, TCFG), str(root),
        RunnerConfig(total_steps=steps, ckpt_every=2),
        injector=FailureInjector(fail))
    out = runner.run()
    return tensors(out["state"]), out["restarts"]


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mamba2-780m"])
def test_resume_is_bitwise_on_the_card(cuda, tmp_path, name):
    cfg = cut(name)
    a, _ = run(cfg, cuda, tmp_path / "a")
    b, restarts = run(cfg, cuda, tmp_path / "b", fail=(2,))
    assert restarts == 1 and a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name,remat", [("llama3.2-1b", "full"),
                                        ("granite-moe-1b-a400m", "dots"),
                                        ("zamba2-2.7b", "full")])
def test_two_runs_from_one_seed_are_bitwise_equal(cuda, name, remat):
    cfg = cut(name)
    runs = []
    for _ in range(2):
        lm = tm.init_lm(cfg, torch.Generator(device=cuda).manual_seed(22),
                        cuda)
        state = init_train_state(cfg, lm, TCFG)
        step = make_train_step(cfg, tm.RunConfig(remat=remat), TCFG)
        gen = torch.Generator(device=cuda).manual_seed(23)
        for _ in range(2):
            state, _ = step(state, batch_for(cfg, gen, cuda, b=4, s=128))
        runs.append(tensors(state))
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.parametrize("name,k", [("llama3.2-1b", 1),
                                    ("granite-moe-1b-a400m", 2),
                                    ("zamba2-2.7b", 1)])
def test_train_step_makes_no_host_sync(cuda, name, k):
    cfg = cut(name)
    gen = torch.Generator(device=cuda).manual_seed(24)
    tcfg = dataclasses.replace(TCFG, microbatches=k,
                               grad_compression="int8_ef")
    state = init_train_state(cfg, tm.init_lm(cfg, gen, cuda), tcfg)
    step = make_train_step(cfg, tm.RunConfig(), tcfg)
    batch = batch_for(cfg, gen, cuda, b=4, s=64)
    state, _ = step(state, batch)                # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, met = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.device.type == "cuda" for v in met.values())


@pytest.fixture
def world1(cuda):
    """A one-rank NCCL process group for the test, destroyed after it."""
    import socket

    import torch.distributed as dist
    from repro_torch.distributed import init_multi_host
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_multi_host(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_world1_sharded_step_equals_the_unsharded_step(cuda, world1, name):
    """The sharded code path on a (1, 1) ``("data", "model")`` mesh
    (DTensor state, ``Axes.from_mesh``; the MoE through its all-to-all)
    takes the unsharded step's loss and masters bitwise (bf16, remat
    full)."""
    from repro_torch.distributed import Axes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import device_put, tree_shardings
    cfg = cut(name)
    axes = Axes.from_mesh(make_mesh((1, 1), ("data", "model")))
    out = []
    for a in (None, axes):
        lm = tm.init_lm(cfg, torch.Generator(device=cuda).manual_seed(25),
                        cuda)
        state = init_train_state(cfg, lm, TCFG)
        if a is not None:
            state = device_put(state, tree_shardings(state, a, "train"))
        batch = batch_for(cfg, torch.Generator(device=cuda).manual_seed(26),
                          cuda, b=4, s=64)
        state, met = make_train_step(cfg, tm.RunConfig(), TCFG, a)(state,
                                                                    batch)
        out.append((met["loss"].cpu(), {
            n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
            .detach().cpu() for n, p in state["params"].named_parameters()}))
        del state, lm
    (la, pa), (lb, pb) = out
    assert torch.equal(la, lb), (float(la), float(lb))
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
