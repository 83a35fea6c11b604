"""The hand-written CUDA sDTW kernel against its plain PyTorch version.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernel_cuda.py``. Imports no JAX: the same inputs, made
from a seed with numpy, go through ``sdtw_cuda`` on the card (the kernel)
and on the CPU (the plain version).

Tolerances: int32 bitwise, and float32 bitwise too, because the inputs
are integer-valued and every sum stays exact below 2**24; one float32
case on real-valued inputs uses ``rtol=1e-5`` for distances (summation
order differs between the kernel's direct recurrence and the plain
version's prefix scan) and compares no positions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.sdtw import LAUNCHES, reset_launches, sdtw_cuda

pytestmark = pytest.mark.cuda

SHAPES = [  # (B, N, M, block_q, block_m)
    (1, 1, 1, None, None),
    (3, 5, 17, 2, 8),
    (4, 9, 70, None, 16),
    (5, 12, 257, 4, 64),
    (8, 33, 1030, None, None),
    (6, 120, 500, None, None),
    (2, 700, 900, None, 64),
    (2, 1536, 2000, None, None),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _flat(z)]
    return [x]


def _both(args, kwargs, cuda):
    got = _flat(sdtw_cuda(*args, **kwargs, device=cuda))
    torch.cuda.synchronize()
    want = _flat(sdtw_cuda(*args, **kwargs, device="cpu"))
    assert len(got) == len(want)
    return [g.cpu().numpy() for g in got], [w.numpy() for w in want]


@pytest.mark.parametrize("b,n,m,bq,bm", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
@pytest.mark.parametrize("mode", ["plain", "span", "lastrow",
                                  "span_lastrow"])
def test_kernel_equals_plain(b, n, m, bq, bm, dtype, metric, mode, cuda):
    rng = np.random.default_rng(b * 1000 + n + m)
    q = rng.integers(-40, 40, (b, n)).astype(dtype)
    r = rng.integers(-40, 40, m).astype(dtype)
    qlens = rng.integers(1, n + 1, b).astype(np.int32)
    qlens[0] = n
    kwargs = dict(block_q=bq, block_m=bm, return_carry=True,
                  return_positions=True, ref_offset=5,
                  return_spans=mode.startswith("span"),
                  return_lastrow=mode.endswith("lastrow"))
    got, want = _both((q, r, qlens, metric), kwargs, cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lead,rlen", [(0, 40), (3, 64), (5, 5), (0, 0),
                                       (10, 70)])
def test_kernel_lead_len_window(lead, rlen, cuda):
    rng = np.random.default_rng(lead * 100 + rlen)
    q = rng.integers(-40, 40, (4, 9)).astype(np.int32)
    r = rng.integers(-40, 40, 70).astype(np.int32)
    got, want = _both((q, r, np.array([9, 1, 4, 7], np.int32)), dict(
        return_spans=True, return_carry=True, return_lastrow=True,
        ref_lead=lead, ref_len=rlen, ref_offset=100), cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("track", [False, True])
def test_kernel_carry_chaining_equals_one_launch(track, cuda):
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.integers(-40, 40, (5, 33)).astype(np.int32))
    r = torch.from_numpy(rng.integers(-40, 40, 1000).astype(np.int32))
    whole = sdtw_cuda(q, r, return_spans=track, return_positions=True,
                      return_carry=True, device=cuda)
    carry = None
    for off in range(0, 1000, 300):
        _, carry = sdtw_cuda(q, r[off:off + 300], carry=carry,
                             ref_offset=off, return_carry=True,
                             track_start=track, device=cuda)
    for g, w in zip(_flat(carry), _flat(whole[1])):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_kernel_block_policy_invariance(cuda):
    rng = np.random.default_rng(11)
    q = rng.integers(-40, 40, (7, 40)).astype(np.int32)
    r = rng.integers(-40, 40, 600).astype(np.int32)
    outs = [_flat(sdtw_cuda(q, r, block_q=bq, block_m=bm, return_spans=True,
                            return_carry=True, device=cuda))
            for bq, bm in [(1, 8), (2, 64), (7, 256), (3, 1000)]]
    for o in outs[1:]:
        for g, w in zip(o, outs[0]):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_kernel_float32_real_valued(cuda):
    rng = np.random.default_rng(13)
    q = rng.normal(0, 10, (6, 50)).astype(np.float32)
    r = rng.normal(0, 10, 800).astype(np.float32)
    got = sdtw_cuda(q, r, device=cuda).cpu().numpy()
    want = sdtw_cuda(q, r, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kernel_counts_launches_and_raises(cuda):
    reset_launches()
    q = torch.zeros((2, 4), dtype=torch.int32)
    r = torch.zeros(16, dtype=torch.int32)
    sdtw_cuda(q, r, device=cuda)
    sdtw_cuda(q, r, return_spans=True, device=cuda)
    sdtw_cuda(q, r, return_lastrow=True, device=cuda)
    assert LAUNCHES == {"sdtw_plain": 1, "sdtw_span": 1, "sdtw_lastrow": 1}
    with pytest.raises(ValueError, match="up to"):
        sdtw_cuda(torch.zeros((1, 5000), dtype=torch.int32), r, device=cuda)
