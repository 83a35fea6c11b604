"""The port's LM serving path against the JAX package's, on the CPU:
every arch at bf16, greedy generation, the data pipeline that feeds it
(``SyntheticLM``, and ``TSAFilteredLM``'s sDTW filter through the port's
``matsa``) and the ``serve_lm`` driver.

Weights come from the JAX package's ``init_lm`` through ``lm_from_jax``
(see ``tests/test_torch_models.py``, which holds the fp32 comparison).
Sampled tokens are not compared: the port samples from a
``torch.Generator``, which cannot reproduce ``jax.random.categorical``.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.data import pipeline as jpipe
from repro.train import serve_step as jserve
from repro_torch import models as tm
from repro_torch.data import pipeline as tpipe
from repro_torch.train import generate, make_prefill_step, make_serve_step
from test_torch_models import (ARCHS, JRUN32, TRUN32, both, close,
                               serve_both)

#: bf16 tolerances, measured on these inputs (largest difference of the
#: port's bf16 run from the reference's): logits 1.4e-2 (mamba2's third
#: decode step; the others ≤ 9.5e-3), held at 2e-2; cache leaves ≤ 1.1 %
#: of the leaf's largest magnitude, held at 3 %. The hybrid (zamba2,
#: three shared-block groups around six SSM layers) amplifies rounding:
#: logits 4.2e-2 and cache leaves 6.6 % (``shared_k``), held at 0.1 and
#: 15 %; the reference's own bf16 logits differ from its fp32 ones by
#: 7.4e-2 there.
BF16_TOL = {"logits": 2e-2, "cache": 0.03}
BF16_TOL_HYBRID = {"logits": 0.1, "cache": 0.15}


def cache_close(got, want, frac, tag=""):
    for k, w in want.items():
        if isinstance(w, dict):
            cache_close(got[k], w, frac, tag + k + "/")
            continue
        w = np.asarray(w.astype(jnp.float32))
        g = got[k].float().numpy()
        assert g.shape == w.shape and str(got[k].dtype)[6:] == str(
            want[k].dtype), tag + k
        assert np.abs(g - w).max() <= frac * max(np.abs(w).max(), 1e-6), \
            (tag + k, np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("name", ARCHS)
def test_arch_equals_the_reference_at_bf16(name):
    tol = BF16_TOL_HYBRID if name == "zamba2-2.7b" else BF16_TOL
    logits, caches = serve_both(name, jm.RunConfig(remat="none"),
                                tm.RunConfig())
    for what, got, want in logits:
        close(got, want, atol=tol["logits"], rtol=0, what=what)
    for what, got, want in caches:
        cache_close(got, want, tol["cache"], what + ": ")


@pytest.mark.parametrize("name", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "mamba2-780m", "zamba2-2.7b"])
def test_generate_greedy_equals_the_reference(name):
    """8 greedy steps at fp32 (a dense, a moe, an ssm and a hybrid arch):
    the same tokens."""
    jcfg, tcfg, jp, lm = both(name)
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 12)) \
        .astype(np.int32)
    want = jserve.generate(jcfg, jp, jnp.asarray(prompt), 8, JRUN32)
    got = generate(tcfg, lm, torch.as_tensor(prompt), 8, TRUN32)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_steps_and_sampling():
    """``make_prefill_step``/``make_serve_step`` as ``generate`` uses them;
    sampling is reproducible from a ``torch.Generator`` seed (not equal to
    the reference's draws), and the compute copy of the weights is made
    once per prefill and reused by the decode steps."""
    jcfg, cfg, jp, lm = both("llama3.2-1b")
    prompt = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 12)))
    run = tm.RunConfig()
    logits, cache = make_prefill_step(cfg, run, 20)(lm, {"tokens": prompt})
    copy = lm.compute_params(run.compute_dtype)
    assert copy is not lm and copy.final_norm.dtype == torch.bfloat16
    tok = torch.argmax(logits, -1).to(torch.int32)
    tok2, _, cache = make_serve_step(cfg, run)(lm, tok, cache)
    assert lm.compute_params(run.compute_dtype) is copy     # reused
    assert torch.equal(cache["pos"], torch.full((2,), 13, dtype=torch.int32))
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        draws.append(generate(cfg, lm, prompt, 6, run, generator=g,
                              sample=True))
    assert torch.equal(draws[0], draws[1])
    assert ((draws[0] >= 0) & (draws[0] < cfg.vocab)).all()
    make_prefill_step(cfg, run, 20)(lm, {"tokens": prompt})
    assert lm.compute_params(run.compute_dtype) is not copy  # refreshed


# ---------------------------------------------------------------------------
# The data pipeline.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emb", [0, 24])
def test_synthetic_lm_bitwise(emb):
    kw = dict(seed=3, seq_len=32, global_batch=4, vocab=101,
              embeddings_dim=emb)
    want = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    got = tpipe.SyntheticLM(tpipe.DataConfig(**kw))
    for step, shard, n in ((0, 0, 1), (5, 1, 2)):
        a, b = got.batch_at(step, shard, n), want.batch_at(step, shard, n)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 7])
def test_tsa_filtered_lm_bitwise(seed):
    """The sDTW filter through the port's ``matsa`` on the CPU keeps the
    same windows: tokens and labels bitwise, the filter's counts equal."""
    kw = dict(seed=seed, seq_len=64, global_batch=4, vocab=97)
    want = jpipe.TSAFilteredLM(jpipe.DataConfig(**kw))
    got = tpipe.TSAFilteredLM(tpipe.DataConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.reference, want.reference)
    for step in (0, 3):
        a, b = got.batch_at(step), want.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].shape == (4, 64)
            np.testing.assert_array_equal(a[k], b[k])
    assert got.filter_stats == want.filter_stats


def test_tsa_filtered_lm_threshold_and_short_window():
    """An explicit threshold, and a window shorter than ``seq_len + 1``
    (tokens tiled), as the reference."""
    kw = dict(seed=2, seq_len=40, global_batch=2, vocab=50)
    want = jpipe.TSAFilteredLM(jpipe.DataConfig(**kw), anomaly_threshold=0.0,
                               window=16).batch_at(1)
    got = tpipe.TSAFilteredLM(tpipe.DataConfig(**kw), anomaly_threshold=0.0,
                              window=16, device="cpu").batch_at(1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_serve_lm_cli_prints_the_reference_keys():
    src = str(pathlib.Path(__file__).parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
         "zamba2-2.7b", "--preset", "reduced", "--batch", "2",
         "--prompt-len", "8", "--gen", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"arch", "batch", "prefill_ms", "decode_ms_per_token",
            "tokens_per_s", "sample_output"} <= set(out)
    assert out["arch"] == "zamba2-2.7b" and out["batch"] == 2
    assert out["device"] == "cpu" and len(out["sample_output"]) == 4


def test_moe_greedy_decode_at_full_width_equals_the_reference():
    """granite-moe-1b-a400m cut to 2 layers at full width (32 experts, top
    8, vocab 49,155), fp32, 8 prompts of 16, 8 greedy steps: the same
    tokens in both packages. At decode a batch of 8 has capacity
    ceil(8·8·1.25/32) = 3 a expert, so slots drop in both alike."""
    import dataclasses
    import jax
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    name = "granite-moe-1b-a400m"
    jcfg = dataclasses.replace(jconfigs.get_arch(name), n_layers=2)
    tcfg = dataclasses.replace(tconfigs.get_arch(name), n_layers=2)
    jp = jm.init_lm(jcfg, jax.random.PRNGKey(0))
    lm = tm.lm_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(19).integers(0, jcfg.vocab, (8, 16)) \
        .astype(np.int32)
    want = np.asarray(jserve.generate(jcfg, jp, jnp.asarray(prompt), 8,
                                      JRUN32))
    got = generate(tcfg, lm, torch.as_tensor(prompt), 8, TRUN32).numpy()
    np.testing.assert_array_equal(got, want)
