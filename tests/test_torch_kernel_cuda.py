"""The hand-written CUDA sDTW kernels against their plain PyTorch version.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernel_cuda.py``. Imports no JAX: the same inputs, made
from a seed with numpy, go through ``sdtw_cuda`` on the card (the rows,
chain and wavefront kernels, forced by ``kernel=``) and on the CPU (the
plain version of all three).

Tolerances: int32 bitwise, and float32 bitwise too, because the inputs
are integer-valued and every sum stays exact below 2**24; one float32
case on real-valued inputs uses ``rtol=1e-5`` for distances (summation
order differs between the kernel's direct recurrence and the plain
version's prefix scan) and compares no positions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.sdtw import (CHAIN_MAX_N, LAUNCHES, ROWS_MAX_N,
                                      reset_launches, sdtw_cuda)
from repro_torch.kernels.sdtw import ops
from repro_torch.kernels.sdtw.ops import ROWS_PER_LANE

pytestmark = pytest.mark.cuda
KERNELS = ["rows", "chain", "wavefront"]

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
    kwargs = {k: v for k, v in kwargs.items() if k != "kernel"}
    torch.cuda.synchronize()
    want = _flat(sdtw_cuda(*args, **kwargs, device="cpu"))
    assert len(got) == len(want)
    return [g.cpu().numpy() for g in got], [w.numpy() for w in want]


@pytest.mark.parametrize("b,n,m,bq,bm", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
@pytest.mark.parametrize("mode", ["plain", "span", "lastrow",
                                  "span_lastrow"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_equals_plain(b, n, m, bq, bm, dtype, metric, mode, kernel,
                             cuda):
    rng = np.random.default_rng(b * 1000 + n + m)
    q = rng.integers(-40, 40, (b, n)).astype(dtype)
    r = rng.integers(-40, 40, m).astype(dtype)
    qlens = rng.integers(1, n + 1, b).astype(np.int32)
    qlens[0] = n
    if kernel != "wavefront":                    # the wavefront's tile
        bm = None
    kwargs = dict(block_q=bq, block_m=bm, return_carry=True, kernel=kernel,
                  return_positions=True, ref_offset=5,
                  return_spans=mode.startswith("span"),
                  return_lastrow=mode.endswith("lastrow"))
    got, want = _both((q, r, qlens, metric), kwargs, cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rows", ROWS_PER_LANE)
@pytest.mark.parametrize("mode", ["plain", "span", "lastrow",
                                  "span_lastrow"])
def test_rows_kernel_every_r_and_ragged_lengths(rows, mode, cuda):
    """Every R the rows kernel is built for, at an N it does not divide
    (where R > 1; the policy picks R there), with ragged lengths: some
    queries end on a lane's last slot (the fixed harvest), the others
    anywhere (the generic harvest), and two have no last row (qlen 0 and
    N + 1)."""
    n = 32 * rows - 3
    assert ops.resolve_rows(9, n, sms=132)[1] == rows
    rng = np.random.default_rng(rows)
    q = rng.integers(-40, 40, (9, n)).astype(np.int32)
    r = rng.integers(-40, 40, 300).astype(np.int32)
    qlens = np.array([n, rows, 2 * rows, 1, n - 1, max(1, n // 2), 0, n + 1,
                      rng.integers(1, n + 1)], np.int32)
    got, want = _both((q, r, qlens), dict(
        kernel="rows", return_carry=True, ref_offset=3,
        return_positions=True, return_spans=mode.startswith("span"),
        return_lastrow=mode.endswith("lastrow")), cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


#: Per-query banned global column ranges for a slice at offset 100 of 70
#: columns: across either edge, inside, outside, empty, everything.
BANS = [(90, 130), (150, 400), (110, 112), (0, 50), (120, 120),
        (0, 2**31 - 1), (169, 170), (100, 170)]


@pytest.mark.parametrize("lead,rlen", [(0, 70), (6, 50)])
@pytest.mark.parametrize("dtype,metric", [(np.int32, "abs_diff"),
                                          (np.int32, "square_diff"),
                                          (np.float32, "abs_diff")])
@pytest.mark.parametrize("mode", ["plain", "span", "lastrow",
                                  "span_lastrow"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_bans_equal_plain(lead, rlen, dtype, metric, mode, kernel,
                                 cuda):
    """The ban instantiations, every variant, against the plain version
    with the same bans, with a carry in; they count under ``_ban``."""
    rng = np.random.default_rng(len(mode) + rlen)
    b = len(BANS)
    q = rng.integers(-40, 40, (b, 21)).astype(dtype)
    r = rng.integers(-40, 40, 70).astype(dtype)
    qlens = rng.integers(1, 22, b).astype(np.int32)
    lo = np.array([x for x, _ in BANS], np.int32)
    hi = np.array([y for _, y in BANS], np.int32)
    _, carry = sdtw_cuda(q, rng.integers(-40, 40, 30).astype(dtype), qlens,
                         metric, return_carry=True, ref_offset=70,
                         track_start=mode.startswith("span"), device="cpu")
    reset_launches()
    got, want = _both((q, r, qlens, metric), dict(
        carry=[c.to(cuda) for c in carry], return_carry=True,
        return_positions=True, return_spans=mode.startswith("span"),
        return_lastrow=mode.endswith("lastrow"), ref_offset=100,
        ref_lead=lead, ref_len=rlen, excl_lo=lo, excl_hi=hi, kernel=kernel),
        cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    var = "lastrow" if mode.endswith("lastrow") else mode.split("_")[0]
    assert LAUNCHES[f"{kernel}_{var}_ban"] == 1, LAUNCHES


@pytest.mark.parametrize("lead,rlen", [(0, 40), (3, 64), (5, 5), (0, 0),
                                       (10, 70)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_lead_len_window(lead, rlen, kernel, cuda):
    rng = np.random.default_rng(lead * 100 + rlen)
    q = rng.integers(-40, 40, (4, 9)).astype(np.int32)
    r = rng.integers(-40, 40, 70).astype(np.int32)
    got, want = _both((q, r, np.array([9, 1, 4, 7], np.int32)), dict(
        return_spans=True, return_carry=True, return_lastrow=True,
        ref_lead=lead, ref_len=rlen, ref_offset=100, kernel=kernel), cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_carry_chaining_equals_one_launch(track, kernel, cuda):
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.integers(-40, 40, (5, 33)).astype(np.int32))
    r = torch.from_numpy(rng.integers(-40, 40, 1000).astype(np.int32))
    whole = sdtw_cuda(q, r, return_spans=track, return_positions=True,
                      return_carry=True, device=cuda, kernel=kernel)
    carry = None
    for off in range(0, 1000, 300):
        _, carry = sdtw_cuda(q, r[off:off + 300], carry=carry,
                             ref_offset=off, return_carry=True,
                             track_start=track, device=cuda, kernel=kernel)
    for g, w in zip(_flat(carry), _flat(whole[1])):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_block_policy_invariance(kernel, cuda):
    """Queries per block and the staged tile (wavefront) change nothing in
    the answer; the rows kernel also equals the wavefront."""
    rng = np.random.default_rng(11)
    q = rng.integers(-40, 40, (7, 40)).astype(np.int32)
    r = rng.integers(-40, 40, 600).astype(np.int32)
    tiles = [8, 64, 256, 1000] if kernel == "wavefront" else [None] * 4
    outs = [_flat(sdtw_cuda(q, r, block_q=bq, block_m=bm, return_spans=True,
                            return_carry=True, device=cuda, kernel=kernel))
            for bq, bm in zip([1, 2, 7, 3], tiles)]
    if kernel != "wavefront":
        outs.append(_flat(sdtw_cuda(q, r, return_spans=True,
                                    return_carry=True, device=cuda,
                                    kernel="wavefront")))
    for o in outs[1:]:
        for g, w in zip(o, outs[0]):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_float32_real_valued(kernel, cuda):
    rng = np.random.default_rng(13)
    q = rng.normal(0, 10, (6, 50)).astype(np.float32)
    r = rng.normal(0, 10, 800).astype(np.float32)
    got = sdtw_cuda(q, r, device=cuda, kernel=kernel).cpu().numpy()
    want = sdtw_cuda(q, r, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kernel_counts_launches_and_raises(cuda):
    reset_launches()
    q = torch.zeros((2, 4), dtype=torch.int32)
    r = torch.zeros(16, dtype=torch.int32)
    for kernel in ("auto", "chain", "wavefront"):
        sdtw_cuda(q, r, device=cuda, kernel=kernel)
        sdtw_cuda(q, r, return_spans=True, device=cuda, kernel=kernel)
        sdtw_cuda(q, r, return_lastrow=True, device=cuda, kernel=kernel)
    want = dict.fromkeys(LAUNCHES, 0)      # the "_ban" keys stay at 0
    want.update(rows_plain=1, rows_span=1, rows_lastrow=1,
                chain_plain=1, chain_span=1, chain_lastrow=1,
                wavefront_plain=1, wavefront_span=1, wavefront_lastrow=1)
    assert LAUNCHES == want
    with pytest.raises(ValueError, match="up to"):
        sdtw_cuda(torch.zeros((1, ROWS_MAX_N + 1), dtype=torch.int32), r,
                  device=cuda, kernel="rows")
    with pytest.raises(ValueError, match="up to"):
        sdtw_cuda(torch.zeros((1, CHAIN_MAX_N + 1), dtype=torch.int32), r,
                  device=cuda, kernel="chain")
    for kernel in ("rows", "chain"):
        with pytest.raises(ValueError, match="block_m"):
            sdtw_cuda(q, r, block_m=16, device=cuda, kernel=kernel)


@pytest.mark.parametrize("kernel,block_q", [("auto", None),
                                            ("wavefront", None),
                                            ("wavefront", 2)])
@pytest.mark.parametrize("mode", ["plain", "span_lastrow"])
def test_long_query_equals_plain(kernel, block_q, mode, cuda):
    """N = 5000 runs on the chain kernel ("auto": 10 warps of 512 rows)
    and, forced, on the wavefront kernel: one query a block in shared
    memory, two a block through the global scratch."""
    rng = np.random.default_rng(5000)
    q = rng.integers(-40, 40, (3, 5000)).astype(np.int32)
    r = rng.integers(-40, 40, 700).astype(np.int32)
    reset_launches()
    got, want = _both((q, r, np.array([5000, 4321, 1], np.int32)), dict(
        block_q=block_q, return_carry=True, return_positions=True,
        return_spans=mode.startswith("span"), kernel=kernel,
        return_lastrow=mode.endswith("lastrow")), cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ran = "chain" if kernel == "auto" else kernel
    assert sum(v for k, v in LAUNCHES.items() if k.startswith(ran)) == 1


def test_scratch_launches_in_bounded_slices(monkeypatch, cuda):
    """A scratch limit of one block (two queries) splits a batch of five
    queries into three launches, with the answer of one launch."""
    rng = np.random.default_rng(3)
    q = rng.integers(-40, 40, (5, 5000)).astype(np.int32)
    r = rng.integers(-40, 40, 300).astype(np.int32)
    kw = dict(block_q=2, return_spans=True, return_carry=True,
              device=cuda, kernel="wavefront")
    whole = _flat(sdtw_cuda(q, r, **kw))
    monkeypatch.setattr(ops, "SCRATCH_LIMIT",
                        ops.smem_bytes(5000, 2, 0, True))
    reset_launches()
    sliced = _flat(sdtw_cuda(q, r, **kw))
    assert LAUNCHES["wavefront_span"] == 3
    for g, w in zip(sliced, whole):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


# ---------------------------------------------------------------------------
# The chain kernel: one query across W warps of a block, the warps chained
# through mbarrier-guarded rings in shared memory.
# ---------------------------------------------------------------------------

#: (B, N, M, block_q): N across 2 to 16 warps, R = 4, 8 and 16, N not a
#: multiple of 32·R, chunks of 32 columns wrapping the 4-slot ring (M >
#: 128) and not (M < 32), two queries a block.
CHAIN_SHAPES = [
    (5, 129, 300, None),      # R = 4, W = 2, one row in the last warp
    (4, 1000, 700, None),     # R = 4, W = 8
    (3, 1537, 200, None),     # R = 4, W = 13
    (2, 33, 20, 2),           # W = 1, M < one chunk, 2 queries a block
    (3, 600, 31, 2),          # W = 5, M < one chunk
    (2, 4000, 250, None),     # R = 8, W = 16: 512 threads
    (2, CHAIN_MAX_N, 150, None),  # R = 16, W = 16
]


@pytest.mark.parametrize("b,n,m,bq", CHAIN_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "span", "lastrow",
                                  "span_lastrow"])
@pytest.mark.parametrize("ban", [False, True])
def test_chain_kernel_equals_plain(b, n, m, bq, mode, ban, cuda):
    """Every variant, with and without the ban, ragged lengths (a last row
    in every warp position, none at all), masks and a carry in, against
    the plain version; it counts under ``chain_<variant>[_ban]``."""
    rng = np.random.default_rng(b * n + m)
    q = rng.integers(-40, 40, (b, n)).astype(np.int32)
    r = rng.integers(-40, 40, m).astype(np.int32)
    qlens = rng.integers(0, n + 2, b).astype(np.int32)
    qlens[0] = n
    span = mode.startswith("span")
    _, carry = sdtw_cuda(q, rng.integers(-40, 40, 40).astype(np.int32),
                         qlens, return_carry=True, ref_offset=60,
                         track_start=span, device="cpu")
    bans = {}
    if ban:
        lo = rng.integers(50, 100 + m, b)
        bans = dict(excl_lo=lo.astype(np.int32),
                    excl_hi=(lo + rng.integers(0, 80, b)).astype(np.int32))
    reset_launches()
    got, want = _both((q, r, qlens), dict(
        carry=[c.to(cuda) for c in carry], return_carry=True, block_q=bq,
        return_positions=True, return_spans=span, ref_offset=100,
        ref_lead=3, ref_len=m - 2, return_lastrow=mode.endswith("lastrow"),
        kernel="chain", **bans), cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    var = "lastrow" if mode.endswith("lastrow") else mode
    assert LAUNCHES[f"chain_{var}{'_ban' if ban else ''}"] == 1, LAUNCHES


@pytest.mark.parametrize("dtype,metric", [(np.int32, "square_diff"),
                                          (np.float32, "abs_diff"),
                                          (np.float32, "square_diff")])
@pytest.mark.parametrize("mode", ["plain", "span_lastrow"])
def test_chain_kernel_types_and_metrics(dtype, metric, mode, cuda):
    rng = np.random.default_rng(17)
    q = rng.integers(-40, 40, (4, 900)).astype(dtype)
    r = rng.integers(-40, 40, 400).astype(dtype)
    got, want = _both((q, r, np.array([900, 899, 256, 1], np.int32),
                       metric), dict(
        return_carry=True, return_positions=True, ref_offset=9,
        return_spans=mode.startswith("span"), kernel="chain",
        return_lastrow=mode.endswith("lastrow")), cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("track", [False, True])
def test_chain_carry_chaining_with_bans_across_slices(track, cuda):
    """Three slices through the carry, with bans across the slice edges,
    equal one launch over the whole reference."""
    rng = np.random.default_rng(23)
    q = torch.from_numpy(rng.integers(-40, 40, (5, 1700)).astype(np.int32))
    r = torch.from_numpy(rng.integers(-40, 40, 1000).astype(np.int32))
    lo = np.array([250, 580, 0, 900, 0], np.int32)
    hi = np.array([350, 620, 310, 1000, 2**31 - 1], np.int32)
    kw = dict(excl_lo=lo, excl_hi=hi, device=cuda, kernel="chain")
    whole = sdtw_cuda(q, r, return_spans=track, return_positions=True,
                      return_carry=True, **kw)
    carry = None
    for off in range(0, 1000, 300):
        _, carry = sdtw_cuda(q, r[off:off + 300], carry=carry,
                             ref_offset=off, return_carry=True,
                             track_start=track, **kw)
    for g, w in zip(_flat(carry), _flat(whole[1])):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("mode", ["plain", "span", "span_lastrow"])
def test_chain_equals_wavefront_at_n_5000(mode, cuda):
    """The two long-query kernels agree on every query and output at
    N = 5000 (the chain kernel at R = 16 and 10 warps)."""
    rng = np.random.default_rng(55)
    q = torch.from_numpy(rng.integers(-40, 40, (12, 5000)).astype(np.int32))
    r = torch.from_numpy(rng.integers(-40, 40, 3000).astype(np.int32))
    qlens = torch.tensor([5000, 4999, 4096, 512, 1, 0] * 2, dtype=torch.int32)
    outs = [_flat(sdtw_cuda(q, r, qlens, return_carry=True,
                            return_positions=True, device=cuda,
                            return_spans=mode.startswith("span"),
                            return_lastrow=mode.endswith("lastrow"),
                            kernel=kernel))
            for kernel in ("chain", "wavefront")]
    for g, w in zip(*outs):
        assert torch.equal(g, w)
