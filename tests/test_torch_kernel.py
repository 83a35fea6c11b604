"""The port's sDTW kernel wrapper on the CPU against the Pallas kernel.

``repro_torch.kernels.sdtw.sdtw_cuda(device="cpu")`` runs the kernel's
plain PyTorch version; ``repro.kernels.sdtw.sdtw_pallas`` runs in interpret
mode, as ``tests/test_sdtw_kernel.py`` runs it. Same numpy inputs from a
seed. Tolerances: int32 bitwise in every output (distances, positions,
starts, carries, last rows); float32 bitwise on the integer-valued inputs
used here (sums exact below 2**24), ``rtol=1e-5`` on distances for
real-valued inputs. The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_kernel_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sdtw import pallas_carry_init, sdtw_pallas
from repro_torch.kernels.sdtw import (MAX_N, carry_from_numpy,
                                      carry_to_numpy, kernel_carry_init,
                                      resolve_blocks, sdtw_cuda,
                                      sdtw_kernel_plain)

# The (B, N, M, block_q, block_m) sweep of tests/test_sdtw_kernel.py.
SHAPES = [
    (1, 1, 1, 1, 8),
    (3, 5, 17, 2, 8),
    (4, 9, 70, 2, 16),
    (5, 12, 257, 4, 64),
    (8, 33, 1030, 8, 256),
]


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _flat(z)]
    return [x]


def _equal(got, want, msg=""):
    got, want = _flat(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype, (msg, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=msg)


@pytest.mark.parametrize("b,n,m,bq,bm", SHAPES)
@pytest.mark.parametrize("dtype,metric", [(np.int32, "abs_diff"),
                                          (np.int32, "square_diff"),
                                          (np.float32, "abs_diff")])
@pytest.mark.parametrize("spans", [False, True])
def test_plain_version_matches_pallas(b, n, m, bq, bm, dtype, metric, spans,
                                      rng):
    """Every return mode at once: result, carry and last row; plain
    variant with positions, span variant with starts."""
    q = rng.integers(-40, 40, (b, n)).astype(dtype)
    r = rng.integers(-40, 40, m).astype(dtype)
    qlens = rng.integers(1, n + 1, b).astype(np.int32)
    kw = dict(return_positions=not spans, return_spans=spans,
              return_carry=True, return_lastrow=True, ref_offset=3)
    want = sdtw_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(qlens),
                       metric, block_q=bq, block_m=bm, **kw)
    got = sdtw_cuda(q, r, qlens, metric, device="cpu", **kw)
    _equal(got, want)


@pytest.mark.parametrize("lead,rlen", [(0, 40), (5, 64), (6, 6), (0, 0)])
def test_lead_len_window_and_empty_slice(lead, rlen, rng):
    q = rng.integers(-40, 40, (4, 9)).astype(np.int32)
    r = rng.integers(-40, 40, 64).astype(np.int32)
    qlens = np.array([9, 1, 4, 7], np.int32)
    carry = pallas_carry_init(4, 9, jnp.int32, track_start=True)
    kw = dict(ref_lead=lead, ref_len=rlen, ref_offset=20, return_spans=True,
              return_carry=True, return_lastrow=True)
    want = sdtw_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(qlens),
                       block_q=2, block_m=16, carry=carry, **kw)
    got = sdtw_cuda(q, r, qlens, carry=carry_from_numpy(
        [np.asarray(c) for c in carry], "cpu"), device="cpu", **kw)
    _equal(got, want)


@pytest.mark.parametrize("track", [False, True])
def test_jax_carry_continues_in_the_port(track, rng):
    """A stream started in JAX over the first half of the reference
    continues in the port over the second half, and the port's carry goes
    back to JAX: both equal JAX's whole-reference answer bitwise."""
    q = rng.integers(-40, 40, (5, 11)).astype(np.int32)
    r = rng.integers(-40, 40, 120).astype(np.int32)
    qlens = np.array([11, 3, 7, 1, 9], np.int32)
    qj, ql = jnp.asarray(q), jnp.asarray(qlens)
    kw = dict(return_carry=True, track_start=track, block_q=2, block_m=16)
    _, whole = sdtw_pallas(qj, jnp.asarray(r), ql, **kw)
    _, half = sdtw_pallas(qj, jnp.asarray(r[:50]), ql, **kw)
    _, port = sdtw_cuda(q, r[50:], qlens, carry=carry_from_numpy(
        [np.asarray(c) for c in half], "cpu"), ref_offset=50,
        return_carry=True, track_start=track, device="cpu")
    _equal(port, whole)
    _, back = sdtw_pallas(qj, jnp.asarray(r[50:]), ql, carry=carry_to_numpy(
        sdtw_cuda(q, r[:50], qlens, return_carry=True, track_start=track,
                  device="cpu")[1]), ref_offset=50, **kw)
    _equal(_flat(back), whole)


def test_legacy_pair_carry_and_fresh_carry(rng):
    q = rng.integers(-40, 40, (3, 6)).astype(np.int32)
    r = rng.integers(-40, 40, 30).astype(np.int32)
    fresh = kernel_carry_init(3, 6, torch.int32, device="cpu")
    _equal(fresh, pallas_carry_init(3, 6, jnp.int32))
    _equal(kernel_carry_init(3, 6, torch.float32, True, "cpu"),
           pallas_carry_init(3, 6, jnp.float32, True))
    pair = (jnp.full((3, 6), 7, jnp.int32), jnp.full((3,), 500, jnp.int32))
    want = sdtw_pallas(jnp.asarray(q), jnp.asarray(r), carry=pair,
                       return_positions=True, return_carry=True)
    got = sdtw_cuda(q, r, carry=(torch.full((3, 6), 7, dtype=torch.int32),
                                 torch.full((3,), 500, dtype=torch.int32)),
                    return_positions=True, return_carry=True, device="cpu")
    _equal(got, want)


def test_bf16_inputs_accumulate_in_float32(rng):
    q = rng.integers(-8, 8, (2, 6)).astype(np.float32)
    r = rng.integers(-8, 8, 40).astype(np.float32)
    want = sdtw_pallas(jnp.asarray(q, jnp.bfloat16),
                       jnp.asarray(r, jnp.bfloat16), block_q=2, block_m=16)
    got = sdtw_cuda(torch.tensor(q, dtype=torch.bfloat16),
                    torch.tensor(r, dtype=torch.bfloat16), device="cpu")
    _equal(got, want)


def test_float32_real_valued_within_tolerance(rng):
    q = rng.normal(0, 10, (4, 12)).astype(np.float32)
    r = rng.normal(0, 10, 90).astype(np.float32)
    want = np.asarray(sdtw_pallas(jnp.asarray(q), jnp.asarray(r)))
    got = sdtw_cuda(q, r, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_plain_version_is_the_cpu_path(rng):
    q = torch.from_numpy(rng.integers(-40, 40, (3, 7)).astype(np.int32))
    r = torch.from_numpy(rng.integers(-40, 40, 50).astype(np.int32))
    b, n = q.shape
    best = torch.full((b,), 2**29, dtype=torch.int32)
    pos = torch.full((b,), -1, dtype=torch.int32)
    bcol = torch.full((b, n), 2**29, dtype=torch.int32)
    raw = sdtw_kernel_plain(q, r, torch.full((b,), n, dtype=torch.int32),
                            "abs_diff", bcol, best, pos)
    d, p = sdtw_cuda(q, r, return_positions=True, device="cpu")
    assert torch.equal(raw[0], d) and torch.equal(raw[1], p)


def test_resolve_blocks_hopper_policy():
    bq, tile, tpq, ring = resolve_blocks(131072, 7997, n=120)
    assert (bq, tpq) == (4, 128) and ring >= 120 + tile
    assert ring & (ring - 1) == 0
    assert resolve_blocks(3, 100, n=120)[0] == 3
    bq, _, tpq, _ = resolve_blocks(16, 10**6, n=1536, span=True)
    assert (bq, tpq) == (1, 512)
    assert resolve_blocks(8, 64, 2, 32, n=33) == (2, 32, 64, 128)
    with pytest.raises(ValueError, match="up to"):
        resolve_blocks(1, 64, n=MAX_N + 1)
    with pytest.raises(ValueError, match="shared memory"):
        resolve_blocks(64, 64, 2, 64, n=4096, span=True)


def test_wrapper_validation(rng):
    q = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="metric"):
        sdtw_cuda(q, np.zeros(8, np.int32), metric="l7", device="cpu")
    with pytest.raises(ValueError, match="ref_len"):
        sdtw_cuda(q, np.zeros(8, np.int32), ref_len=9, device="cpu")
    with pytest.raises(ValueError, match="carry"):
        sdtw_cuda(q, np.zeros(8, np.int32), carry=(1,), device="cpu")
    with pytest.raises(ValueError, match="3 or 5"):
        carry_from_numpy((np.zeros(1),), "cpu")


def test_card_is_the_default_device():
    """``device=None`` means the CUDA device: where none is present the
    wrapper refuses instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sdtw_cuda(np.zeros((1, 4), np.int32), np.zeros(8, np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernel_carry_init(1, 4, torch.int32)
