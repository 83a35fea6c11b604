"""The port's sDTW kernel wrapper on the CPU against the Pallas kernel.

``repro_torch.kernels.sdtw.sdtw_cuda(device="cpu")`` runs the kernel's
plain PyTorch version; ``repro.kernels.sdtw.sdtw_pallas`` runs in interpret
mode, as ``tests/test_sdtw_kernel.py`` runs it. Same numpy inputs from a
seed. Tolerances: int32 bitwise in every output (distances, positions,
starts, carries, last rows); float32 bitwise on the integer-valued inputs
used here (sums exact below 2**24), ``rtol=1e-5`` on distances for
real-valued inputs. The CUDA kernels themselves are held against the
plain version on the card by ``tests/test_torch_kernel_cuda.py``; here the
launch policy that picks between them is checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sdtw import (sdtw_batch, sdtw_carry_init,
                             sdtw_chunk_batch_topk)
from repro.core.topk import topk_init
from repro.kernels.sdtw import pallas_carry_init, sdtw_pallas
from repro_torch.core.matsa_api import load_real_workload_shapes
from repro_torch.kernels.sdtw import (CHAIN_MAX_N, LAUNCHES, ROWS_MAX_N,
                                      carry_from_numpy, carry_to_numpy,
                                      choose_kernel,
                                      kernel_carry_init, resolve_blocks,
                                      resolve_chain, resolve_rows, sdtw_cuda,
                                      sdtw_kernel_plain)
from repro_torch.kernels.sdtw import ops
from repro_torch.kernels.sdtw.ops import (CHAIN_MAX_WARPS, CHAIN_ROWS,
                                          CHAIN_WARPS_PER_SM,
                                          ROWS_PER_LANE, SCRATCH_LIMIT,
                                          kernel_bans, scratch_batch,
                                          smem_bytes, variant)

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


#: Table V shape → (R, lanes in use) of the rows kernel.
TABLE_V_ROWS = {"Human": (4, 30), "Song": (7, 29), "Penguin": (25, 32),
                "Seismology": (2, 32), "Power": (48, 32), "ECG": (16, 32)}


def test_resolve_blocks_hopper_policy():
    """Every Table V shape runs on the rows kernel, R rows a lane with
    32·R within 1.15·N; longer queries run on the wavefront kernel, whose
    rows and diagonals move to a global scratch past shared memory."""
    for name, w in load_real_workload_shapes().items():
        n, b = w["query_size"], w["num_queries"]
        assert choose_kernel(n) == "rows", name
        warps, rows = resolve_rows(b, n, sms=132)
        assert (rows, -(-n // rows)) == TABLE_V_ROWS[name], name
        assert n <= 32 * rows <= 1.15 * n, name
        assert warps == 4 and -(-b // warps) >= 132, name
    assert resolve_rows(256, 512, sms=132) == (1, 16)   # ECG-cut: 256 blocks
    assert resolve_rows(600, 120, sms=132) == (4, 4)
    assert resolve_rows(8, 64, 2, sms=132) == (2, 2)
    # Every R the kernel is built for is reached, at an N it does not
    # divide (the generic harvest) where R > 1.
    for rows in ROWS_PER_LANE:
        assert resolve_rows(1, 32 * rows - 3, sms=132)[1] == rows

    bq, tile, tpq, ring, scratch = resolve_blocks(131072, 7997, n=120)
    assert (bq, tpq, scratch) == (4, 128, False) and ring >= 120 + tile
    assert ring & (ring - 1) == 0
    assert resolve_blocks(3, 100, n=120)[0] == 3
    bq, _, tpq, _, scratch = resolve_blocks(16, 10**6, n=1536, span=True)
    assert (bq, tpq, scratch) == (1, 512, False)
    assert resolve_blocks(8, 64, 2, 32, n=33) == (2, 32, 64, 128, False)
    # N = 5000 runs on the chain kernel, and on the wavefront kernel when
    # forced: one query a block still fits in shared memory (172,768
    # bytes in span mode), two do not; past CHAIN_MAX_N the wavefront is
    # the "auto" choice.
    assert choose_kernel(5000) == "chain"
    assert choose_kernel(CHAIN_MAX_N + 1) == "wavefront"
    bq, _, tpq, _, scratch = resolve_blocks(4, 3000, n=5000, span=True)
    assert (bq, tpq, scratch) == (1, 512, False)
    assert resolve_blocks(4, 3000, 2, n=5000, span=True)[4]
    assert smem_bytes(5000, 1, 8192, True) == 172_768
    # At one query a block the scratch starts at N = 7132 (span mode) and
    # N = 10433 (plain).
    for n, span in ((7132, True), (10_433, False)):
        assert not resolve_blocks(1, 3000, n=n - 1, span=span)[4]
        assert resolve_blocks(1, 3000, n=n, span=span)[4]
    assert resolve_blocks(4, 3000, n=12_000)[4]
    assert resolve_blocks(64, 64, 2, 64, n=4096, span=True)[4]


def test_kernel_choice_and_rows_validation():
    assert choose_kernel(1) == choose_kernel(ROWS_MAX_N) == "rows"
    assert choose_kernel(ROWS_MAX_N + 1) == "chain"
    assert choose_kernel(10, "wavefront") == "wavefront"
    with pytest.raises(ValueError, match="kernel must be"):
        choose_kernel(10, "pallas")
    with pytest.raises(ValueError, match="up to"):
        choose_kernel(ROWS_MAX_N + 1, "rows")
    with pytest.raises(ValueError, match="up to"):
        resolve_rows(1, ROWS_MAX_N + 1, sms=132)
    with pytest.raises(ValueError, match="queries per block"):
        resolve_rows(1, 120, block_q=9, sms=132)
    with pytest.raises(ValueError, match="kernel must be"):
        sdtw_cuda(np.zeros((1, 4), np.int32), np.zeros(8, np.int32),
                  kernel="bogus", device="cpu")


def test_wavefront_scratch_is_bounded():
    """The global scratch of one launch stays within SCRATCH_LIMIT, in
    whole blocks, whatever the batch; a block too large for it raises."""
    for n, bq, span in ((5000, 1, False), (48_000, 1, True), (4096, 2, True)):
        step = scratch_batch(n, bq, span)
        assert step % bq == 0 and step >= bq
        assert step // bq * smem_bytes(n, bq, 0, span) <= SCRATCH_LIMIT
    with pytest.raises(ValueError, match="scratch"):
        scratch_batch(SCRATCH_LIMIT // 16 + 1, 1, False)


@pytest.mark.parametrize("spans", [False, True])
def test_long_query_matches_pallas(spans, rng):
    """N = 5000, past the shared memory of a wavefront block: the plain
    version equals the Pallas kernel bitwise, last row and carry too."""
    q = rng.integers(-40, 40, (2, 5000)).astype(np.int32)
    r = rng.integers(-40, 40, 64).astype(np.int32)
    qlens = np.array([5000, 3777], np.int32)
    kw = dict(return_positions=not spans, return_spans=spans,
              return_carry=True, return_lastrow=True, ref_offset=11)
    want = sdtw_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(qlens),
                       **kw)
    got = sdtw_cuda(q, r, qlens, device="cpu", kernel="wavefront", **kw)
    _equal(got, want)


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


# ---------------------------------------------------------------------------
# The per-query column ban (the kernels' BAN instantiations) against the
# reference's row scan with excl_lo/excl_hi, which bans by BIG distances.
# Values are compared bitwise; a start lane only where its value is below
# BIG (the reference leaves the start of a saturated cell unspecified).
# ---------------------------------------------------------------------------

INT_FAR = 2**31 - 1
#: (j0, M, ref_lead, ref_len, bans): a slice of global columns
#: [j0, j0 + M); each query's [lo, hi) in global columns.
BAN_SLICES = {
    # Bans across both slice edges, inside, before, after, empty, all.
    "slice_edge": (40, 64, 0, 64, [(20, 50), (95, 130), (50, 60), (0, 30),
                                   (104, 200), (55, 55), (0, INT_FAR)]),
    # A halo group: starts left of the reference (negative j0, ref_lead).
    "negative_j0": (-24, 72, 24, 72, [(-10, 5), (0, 8), (30, 47), (-50, -30),
                                      (20, 20), (47, 48), (0, INT_FAR)]),
    # A right-padded tail slice (ref_len < M) with a ban past its end.
    "tail": (64, 48, 0, 30, [(70, 100), (90, 200), (60, 66), (93, 94),
                             (10, 12), (64, 94), (0, INT_FAR)]),
}


def _masked_equal(g, w, vals, msg):
    """Start lanes equal where their values are below BIG."""
    live = np.asarray(vals) < np.asarray(vals).dtype.type(
        2**29 if np.asarray(vals).dtype.kind == "i" else np.inf)
    np.testing.assert_array_equal(np.asarray(g)[live], np.asarray(w)[live],
                                  err_msg=msg)


@pytest.mark.parametrize("case", sorted(BAN_SLICES))
@pytest.mark.parametrize("dtype,metric", [(np.int32, "abs_diff"),
                                          (np.int32, "square_diff"),
                                          (np.float32, "abs_diff")])
def test_plain_version_bans_match_rowscan_chunk(case, dtype, metric, rng):
    """One slice with a carry in: the last row, the boundary column and the
    harvest of the plain version with bans equal the reference's
    ``sdtw_chunk_batch_topk`` (k = 1) with the same global excl_lo/excl_hi,
    masks and carry."""
    j0, m, lead, rlen, bans = BAN_SLICES[case]
    b, n = len(bans), 7
    q = rng.integers(-30, 30, (b, n)).astype(dtype)
    r = rng.integers(-30, 30, m).astype(dtype)
    qlens = np.array([7, 1, 4, 7, 6, 2, 7], np.int32)
    lo = np.array([x for x, _ in bans], np.int32)
    hi = np.array([y for _, y in bans], np.int32)
    acc = jnp.float32 if dtype == np.float32 else jnp.int32
    # A carry from an earlier slice (no ban there), in both layouts.
    prev = rng.integers(-30, 30, 20).astype(dtype)
    _, c_prev = sdtw_pallas(jnp.asarray(q), jnp.asarray(prev),
                            jnp.asarray(qlens), metric, return_carry=True,
                            track_start=True, ref_offset=j0 - 20)
    bcol, bstart = np.asarray(c_prev[0]), np.asarray(c_prev[1])
    if lead:                         # a halo group starts from a fresh carry
        bcol, bstart = (np.asarray(x) for x in sdtw_carry_init(
            b, n, acc, track_start=True)[:2])
    j_carry = (jnp.asarray(bcol), jnp.asarray(bstart),
               jnp.full((b,), 2**29 if acc == jnp.int32 else jnp.inf, acc))
    want = sdtw_chunk_batch_topk(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qlens),
        j_carry + topk_init(b, 1, acc), j0, j0 + rlen, metric,
        jnp.asarray(lo), jnp.asarray(hi), 1, jnp.zeros((b,), jnp.int32),
        track_start=True, clen=rlen if 0 < rlen < m else None,
        return_lastrow=True)
    w_bcol, w_bstart, _, w_d, w_p, w_s, w_lrow, w_lstart = (
        np.asarray(x) for x in want)
    fresh = kernel_carry_init(b, n, torch.from_numpy(r).dtype, True, "cpu")
    carry = (torch.tensor(bcol), torch.tensor(bstart)) + fresh[2:]
    (d, s, e), (g_bcol, g_bstart, *_), g_lrow, g_lstart = sdtw_cuda(
        q, r, qlens, metric, carry=carry, return_spans=True,
        return_carry=True, return_lastrow=True, ref_offset=j0,
        ref_len=rlen, ref_lead=lead, excl_lo=lo, excl_hi=hi, device="cpu")
    live = slice(lead, rlen)
    np.testing.assert_array_equal(g_lrow[:, live].numpy(), w_lrow[:, live])
    _masked_equal(g_lstart[:, live], w_lstart[:, live], w_lrow[:, live],
                  "last-row starts")
    if rlen:
        np.testing.assert_array_equal(g_bcol.numpy(), w_bcol)
        _masked_equal(g_bstart, w_bstart, w_bcol, "boundary starts")
    np.testing.assert_array_equal(d.numpy(), w_d[:, 0])
    np.testing.assert_array_equal(e.numpy(), w_p[:, 0])
    np.testing.assert_array_equal(s.numpy(), w_s[:, 0])
    assert d[-1] == big_of(d) and e[-1] == -1       # the fully banned row


def big_of(t):
    return 2**29 if not t.dtype.is_floating_point else float("inf")


@pytest.mark.parametrize("spans", [False, True])
@pytest.mark.parametrize("kernel", ["rows", "chain", "wavefront"])
def test_plain_version_bans_match_rowscan_whole(spans, kernel, rng):
    """The whole reference in one call: distances, ends (and starts) with a
    per-query ban equal the reference's ``sdtw_batch(impl='rowscan')``
    with ``excl_lo``/``excl_hi``, self-join bands and a fully banned row
    among them; the same call in slices through the carry agrees."""
    r = rng.integers(-40, 40, 150).astype(np.int32)
    starts = np.array([0, 30, 61, 100, 137])
    w = 12
    q = np.stack([r[s:s + w] if s + w <= 150 else np.zeros(w, np.int32)
                  for s in starts])
    lo = np.maximum(starts - w // 2, 0).astype(np.int32)
    hi = (starts + w + w // 2).astype(np.int32)
    lo[-1], hi[-1] = 0, INT_FAR
    want = sdtw_batch(jnp.asarray(q), jnp.asarray(r), None, "abs_diff",
                      "rowscan", jnp.asarray(lo), jnp.asarray(hi),
                      return_positions=not spans, return_spans=spans)
    got = sdtw_cuda(q, r, excl_lo=lo, excl_hi=hi, return_positions=not spans,
                    return_spans=spans, kernel=kernel, device="cpu")
    # The fully banned row saturates: the kernel contract keeps its end
    # (and start) at -1 where the row scan reports column 0 (unspecified
    # in the reference); every other query is compared bitwise.
    assert got[0][-1] == 2**29 and (got[-1][-1] == -1).all()
    _equal([g[:-1] for g in got], [w[:-1] for w in want])
    carry = None
    for off in range(0, 150, 64):
        sl = np.zeros(64, np.int32)
        cl = min(64, 150 - off)
        sl[:cl] = r[off:off + cl]
        _, carry = sdtw_cuda(q, sl, carry=carry, ref_offset=off, ref_len=cl,
                             excl_lo=lo, excl_hi=hi, return_carry=True,
                             track_start=spans, device="cpu")
    chained = (carry[2], carry[4], carry[3]) if spans else (carry[1],
                                                             carry[2])
    _equal(chained, got)


def test_kernel_bans_normalization():
    """Empty ranges for every query launch without a ban; a scalar range
    applies to every query; a lone bound or a wrong shape raises. The ban
    instantiations count under their own ``LAUNCHES`` keys."""
    assert kernel_bans(None, None, 3, "cpu") is None
    assert kernel_bans(np.full(3, -1), np.full(3, -1), 3, "cpu") is None
    assert kernel_bans(np.array([5, 0, 2]), np.array([5, 0, 1]), 3,
                       "cpu") is None
    lo, hi = kernel_bans(4, 9, 3, "cpu")
    assert lo.tolist() == [4] * 3 and hi.tolist() == [9] * 3
    assert lo.dtype == torch.int32 and lo.is_contiguous()
    with pytest.raises(ValueError, match="together"):
        kernel_bans(1, None, 3, "cpu")
    with pytest.raises(ValueError, match="scalars or"):
        kernel_bans(np.zeros(2), np.ones(2), 3, "cpu")
    assert variant(True, True, "rows", True) == "rows_lastrow_ban"
    assert variant(False, False, "wavefront") == "wavefront_plain"
    assert {k for k in LAUNCHES if k.endswith("_ban")} == {
        f"{k}_{v}_ban" for k in ("rows", "chain", "wavefront")
        for v in ("plain", "span", "lastrow")}


# ---------------------------------------------------------------------------
# The chain kernel's launch policy (``csrc/sdtw_chain.cu``: one query
# across the warps of a block), checked here; the kernel itself is held
# against the plain version on the card (tests/test_torch_kernel_cuda.py).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 33, 120, 512, 1537, 1600, 2048, 4000,
                               4096, 5000, 8191, CHAIN_MAX_N])
@pytest.mark.parametrize("b", [1, 64, 256, 131_072])
def test_resolve_chain_covers_n(b, n):
    """W warps of 32·R rows cover n with every warp holding a row, within
    the 16 warps a block takes; queries share a block only where the
    batch still gives every SM a block."""
    warps, rows, block_q = resolve_chain(b, n, sms=132)
    assert rows in CHAIN_ROWS and 1 <= warps <= CHAIN_MAX_WARPS == 16
    assert 32 * rows * (warps - 1) < n <= 32 * rows * warps
    assert 1 <= block_q and block_q * warps <= CHAIN_MAX_WARPS
    assert block_q == 1 or b // block_q >= 132


def test_resolve_chain_policy():
    """The slack rule: among the R whose W·max(1, b / sms) warps give each
    SM in use ``CHAIN_WARPS_PER_SM`` warps, the least W·(R + 4) rows a
    step, else the R with the most warps — the picks the H100 measured
    fastest (PERF.md §6)."""
    assert resolve_chain(256, 2048, sms=132) == (8, 8, 1)     # self-join
    assert resolve_chain(64, 4096, sms=132) == (16, 8, 1)     # spans
    assert resolve_chain(256, 512, sms=132) == (4, 4, 1)      # ECG-cut
    assert resolve_chain(8, 5000, sms=132) == (10, 16, 1)     # only R = 16
    assert resolve_chain(62, 1600, sms=132) == (13, 4, 1)
    assert resolve_chain(1, CHAIN_MAX_N, sms=132) == (16, 16, 1)
    assert resolve_chain(131_072, 120, sms=132) == (1, 4, 4)  # Human
    assert resolve_chain(1000, 120, sms=132) == (1, 4, 4)
    assert resolve_chain(3, 120, 7, sms=132) == (1, 4, 7)
    with pytest.raises(ValueError, match="up to"):
        resolve_chain(1, CHAIN_MAX_N + 1, sms=132)
    with pytest.raises(ValueError, match="queries per block"):
        resolve_chain(4, 4096, 2, sms=132)
    with pytest.raises(ValueError, match="queries per block"):
        resolve_chain(4, 100, 0, sms=132)


@pytest.mark.parametrize("n,auto", [(ROWS_MAX_N, "rows"),
                                    (ROWS_MAX_N + 1, "chain"),
                                    (CHAIN_MAX_N, "chain"),
                                    (CHAIN_MAX_N + 1, "wavefront")])
def test_choose_kernel_thresholds(n, auto):
    """``"auto"`` at both thresholds; a forced kernel past its limit
    raises, the wavefront takes any N."""
    assert ROWS_MAX_N == 1536 and CHAIN_MAX_N == 8192
    assert choose_kernel(n) == auto
    assert choose_kernel(n, "wavefront") == "wavefront"
    for kernel, limit in (("rows", ROWS_MAX_N), ("chain", CHAIN_MAX_N)):
        if n <= limit:
            assert choose_kernel(n, kernel) == kernel
        else:
            with pytest.raises(ValueError, match=f"{kernel} kernel takes"):
                choose_kernel(n, kernel)


@pytest.mark.parametrize("b,n,auto", [
    (256, 512, "chain"),            # ECG-cut: 4 warps a query
    (256, 1536, "chain"),
    (131_072, 120, "rows"),         # Human: the rows kernel fills the card
    (4224, 512, "rows"),            # 32 warps an SM already
    (CHAIN_WARPS_PER_SM * 132 - 1, 512, "chain"),
    (CHAIN_WARPS_PER_SM * 132, 512, "rows"),
    (8, 120, "rows"),               # one warp a query either way
    (8, 129, "chain"),
    (8, 1537, "chain"),
    (1, CHAIN_MAX_N + 1, "wavefront"),
])
def test_choose_kernel_by_batch_on_the_card(b, n, auto):
    """With the batch and the SM count (as ``sdtw_cuda`` passes them for a
    CUDA tensor), ``"auto"`` takes the chain kernel for a batch too small
    for the rows kernel's one warp a query to fill the SMs, where the
    chain splits each query; a forced kernel is kept."""
    assert choose_kernel(n, "auto", b, 132) == auto
    assert choose_kernel(n, "wavefront", b, 132) == "wavefront"
    if n <= ROWS_MAX_N:
        assert choose_kernel(n, "rows", b, 132) == "rows"
        assert choose_kernel(n) == "rows"


def test_chain_launch_keys():
    """Every variant of the chain kernel, with and without the ban, has
    its own launch count, set to 0 with the others."""
    keys = {f"chain_{v}{b}" for v in ("plain", "span", "lastrow")
            for b in ("", "_ban")}
    assert keys <= set(LAUNCHES)
    assert len(LAUNCHES) == 18
    assert variant(True, False, "chain", True) == "chain_span_ban"
    LAUNCHES["chain_lastrow"] += 3
    ops.reset_launches()
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("kernel", ["rows", "chain"])
def test_block_m_refused_off_the_wavefront(kernel):
    """``block_m`` is the wavefront's staged tile: a rows or chain launch
    refuses it before it touches the card."""
    with pytest.raises(ValueError, match=f"the {kernel} kernel stages none"):
        ops.launch_config(2, 600, 64, sms=132, kernel=kernel, block_m=16)
