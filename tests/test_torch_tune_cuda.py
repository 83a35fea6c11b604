"""The autotuner on the card: tuned launches against the hand-set policy.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_tune_cuda.py``. Imports no JAX. The same seeded inputs
run under ``tune='off'`` (the hand-set launch policies), ``'model'`` (the
oracle: the shipped ``h100.json`` table, else the cost model) and
``'measure'`` (a measured search on the card first).

Tolerances: int32 bitwise; the float32 cases are integer-valued, so they
are bitwise too.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.kernels.sdtw import ops
from repro_torch.tune import (DispatchDecision, bucket_key,
                              clear_tuning_cache, default_table, resolve)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    clear_tuning_cache()
    yield torch.device("cuda")
    clear_tuning_cache()


def _flat(x):
    if isinstance(x, tuple):
        return [z for y in x for z in _flat(y)]
    return [x.cpu().numpy()]


def _same(a, b):
    a, b = _flat(a), _flat(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


SHAPES = [  # (nq, n, m, dtype): rows, chain and wavefront shapes
    (64, 120, 2000, np.int32),
    (8, 512, 6000, np.int32),
    (3, 2000, 3000, np.int32),
    (2, 9000, 2500, np.int32),
    (16, 64, 1000, np.float32),
]


@pytest.mark.parametrize("nq,n,m,dtype", SHAPES)
@pytest.mark.parametrize("mode", [dict(), dict(return_spans=True),
                                  dict(return_positions=True)])
def test_tuned_answers_are_bitwise_the_hand_set_ones(cuda, nq, n, m, dtype,
                                                     mode):
    rng = np.random.default_rng(nq * n + m)
    q = rng.integers(-50, 50, (nq, n)).astype(dtype)
    r = rng.integers(-50, 50, m).astype(dtype)
    want = engine.sdtw(q, r, tune="off", **mode)
    for tune in ("model", "measure"):
        _same(engine.sdtw(q, r, tune=tune, **mode), want)


@pytest.mark.parametrize("variant", ["plain", "span", "lastrow"])
def test_sdtw_cuda_tuned_launch_equals_off_with_bans(cuda, variant):
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.integers(-50, 50, (40, 300)).astype(np.int32),
                        device=cuda)
    r = torch.as_tensor(rng.integers(-50, 50, 4000).astype(np.int32),
                        device=cuda)
    lo = torch.as_tensor(rng.integers(0, 3000, 40).astype(np.int32),
                         device=cuda)
    kw = dict(return_spans=variant != "plain", return_positions=True,
              return_lastrow=variant == "lastrow", excl_lo=lo,
              excl_hi=lo + 600, device=cuda)
    want = ops.sdtw_cuda(q, r, tune="off", **kw)
    for tune in ("model", "measure"):
        _same(ops.sdtw_cuda(q, r, tune=tune, **kw), want)


def test_measure_records_the_bucket_in_the_process_table(cuda):
    """A measured search on a small bucket lands in the process table
    with ``source='measured'``, timed against the hand-set launch."""
    rng = np.random.default_rng(3)
    q = rng.integers(-50, 50, (32, 100)).astype(np.int32)
    r = rng.integers(-50, 50, 3000).astype(np.int32)
    key = bucket_key("h100", "abs_diff", "int32", 32, 100, 3000, "plain")
    engine.sdtw(q, r, tune="measure")
    entry = default_table("h100").get(key)
    assert entry is not None and entry.source == "measured"
    assert entry.kernel in ops.KERNELS and entry.score_us > 0
    res = resolve(32, 100, 3000, backend="h100", mode="model")
    assert res.source == "table:measured"


def test_explain_on_the_card_reports_the_launch(cuda):
    rng = np.random.default_rng(5)
    q = rng.integers(-50, 50, (16, 200)).astype(np.int32)
    r = rng.integers(-50, 50, 5000).astype(np.int32)
    out, dec = engine.sdtw(q, r, explain=True)
    assert isinstance(dec, DispatchDecision)
    assert (dec.impl, dec.source) == ("pallas", "structural")
    assert set(dec.config) == {"kernel", "rows", "warps", "block_q",
                               "block_m", "source"}
    assert dec.config["source"] in ("model", "table:model",
                                    "table:measured")
    assert dec.candidates
    _same(out, engine.sdtw(q, r, tune="off"))
    _, off = engine.sdtw(q, r, tune="off", explain=True)
    assert off.config["source"] == "legacy"
    assert {k: off.config[k] for k in ("kernel", "rows", "block_q")} == {
        k: v for k, v in ops.launch_config(
            16, 200, 5000, sms=ops.sm_count()).items()
        if k in ("kernel", "rows", "block_q")}


def test_explicit_knobs_win_over_the_oracle(cuda):
    """``kernel=``, ``rows=`` and ``block_q=`` given by the caller are
    launched as given whatever the oracle says, with the same answers."""
    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.integers(-50, 50, (24, 200)).astype(np.int32),
                        device=cuda)
    r = torch.as_tensor(rng.integers(-50, 50, 3000).astype(np.int32),
                        device=cuda)
    want = ops.sdtw_cuda(q, r, return_spans=True, tune="off")
    for forced in (dict(kernel="rows", rows=8, block_q=2),
                   dict(kernel="chain", rows=4, block_q=1),
                   dict(kernel="wavefront", block_q=1, block_m=128)):
        cfg, _ = ops.tuned_launch(24, 200, 3000, sms=ops.sm_count(),
                                  variant="span", tune="model", **forced)
        assert {k: cfg[k] for k in forced} == forced
        ops.reset_launches()
        _same(ops.sdtw_cuda(q, r, return_spans=True, tune="model",
                            **forced), want)
        assert ops.LAUNCHES[f"{forced['kernel']}_span"] == 1


def test_sm_count_reads_the_current_device(cuda):
    """``torch.device('cuda')`` has no index; the SM count is then the
    current device's."""
    with torch.cuda.device(0):
        assert ops.sm_count() == ops.sm_count(0) == \
            torch.cuda.get_device_properties(0).multi_processor_count
