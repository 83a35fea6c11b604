"""The LM serving path on the card, against the CPU.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_lm_cuda.py``. Imports no JAX. Each family's arch, cut to
2 layers at full width (the hybrid to one group of ``attn_every``
layers), serves 2 prompts of 32 tokens and 4 decode steps at fp32 on the
card and on the CPU with the same weights; TF32 stays off, so the two
differ only in summation order: logits within ``atol=1e-3`` and cache
leaves within 0.1 % of their largest magnitude (measured on an H100, in
``chip_smoke.py`` phase 19's same check: logits at most 4.4e-5 at a
scale of 3-5, cache leaves 8.4e-6 of their largest). Served tokens (bf16,
greedy) are the same from run to run on the card.
"""
import dataclasses

import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.models.layers import Init
from repro_torch.train import generate

pytestmark = pytest.mark.cuda

FAMILIES = ["llama3.2-1b", "granite-moe-1b-a400m", "mamba2-780m",
            "zamba2-2.7b", "musicgen-large"]
RUN32 = tm.RunConfig(compute_dtype=torch.float32, cache_dtype=torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def cut(name):
    cfg = get_arch(name)
    return dataclasses.replace(cfg, n_layers=max(2, cfg.attn_every))


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("name", FAMILIES)
def test_card_equals_cpu_at_fp32(cuda, name):
    cfg = cut(name)
    gen = torch.Generator(device=cuda).manual_seed(19)
    card = tm.init_lm(cfg, gen, cuda)
    cpu = tm.LM(cfg, Init(torch.device("cpu")))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    if cfg.frontend == "stub":
        batch = {"embeddings": torch.randn((2, 32, cfg.d_model),
                                           generator=gen, device=cuda)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32),
                                         generator=gen, device=cuda)}
    steps = torch.randint(0, cfg.vocab, (4, 2), generator=gen, device=cuda)
    out = []
    for lm, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        b = {k: v.to(dev) for k, v in batch.items()}
        full, _ = tm.forward(cfg, lm, b, RUN32)
        logits, cache = tm.prefill(cfg, lm, b, 37, RUN32)
        seen = [full, logits]
        for tok in steps:
            logits, cache = tm.decode_step(cfg, lm, tok.to(dev), cache,
                                           RUN32)
            seen.append(logits)
        assert all(x.device.type == dev.type for x in seen)
        out.append(([x.cpu() for x in seen],
                    {k: v.cpu() for k, v in leaves(cache)}))
    (lc, cc), (lp, cp) = out
    for got, want in zip(lc, lp):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    assert torch.equal(cc.pop("pos"), cp.pop("pos"))
    for k, want in cp.items():
        assert cc[k].dtype == want.dtype
        err = (cc[k].float() - want.float()).abs().max()
        assert err <= 1e-3 * want.float().abs().max(), (k, float(err))


@pytest.mark.parametrize("name", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b"])
def test_served_tokens_are_deterministic(cuda, name):
    cfg = cut(name)
    lm = tm.init_lm(cfg, torch.Generator(device=cuda).manual_seed(7), cuda)
    prompt = torch.randint(0, cfg.vocab, (4, 64), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(8))
    runs = [generate(cfg, lm, prompt, 16, tm.RunConfig()) for _ in range(3)]
    assert runs[0].device.type == "cuda"
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
