"""Wrapper around the hand-written Hopper sDTW kernel.

``sdtw_cuda`` is the port's counterpart of ``repro.kernels.sdtw.ops
.sdtw_pallas``: the same arguments, return modes and return order
``res[, new_carry][, lastrow[, lastrow_starts]]``, including the chunk
carry — ``(bcol (B, N), best (B,), pos (B,))``, or in span mode the
5-tuple ``(bcol, bstart, best, pos, start)`` — that streams a reference
of any length through fixed launches, and the ``ref_offset`` /
``ref_len`` / ``ref_lead`` slice masks.

Dispatch: tensors on a CUDA device launch the kernel of ``csrc/sdtw.cu``
(built at first use by ``_build``); tensors on the CPU run its plain
PyTorch version (``sdtw.sdtw_kernel_plain``). There is no fallback: a
CUDA call that cannot launch raises.

Each launch adds one to ``LAUNCHES[variant]``, where the variant is
``sdtw_plain`` (K1), ``sdtw_span`` (K2, start lane) or ``sdtw_lastrow``
(K3, last-row capture, with or without the start lane).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.distances import (INT_FAR, METRICS, accum_dtype, big,
                                        result_dtype)
from repro_torch.device import as_tensor, resolve_device
from . import _build
from .sdtw import sdtw_kernel_plain

#: Threads a block aims for: queries of up to 512 rows share a block.
BLOCK_THREADS = 512
#: Reference samples staged into shared memory per tile.
DEFAULT_TILE = 256
#: Largest query length the kernel takes. Its shared memory grows with N
#: (4·N bytes for the query and 12·N for three diagonals, 12·N more for
#: their start lanes in span mode, plus the reference ring); N = 4096 in
#: span mode needs 147,456 of the block's 232,448 bytes.
MAX_N = 4096
#: Dynamic shared memory one block can have on Hopper.
SMEM_LIMIT = 232_448

LAUNCHES = {"sdtw_plain": 0, "sdtw_span": 0, "sdtw_lastrow": 0}


def reset_launches():
    """Set every launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def variant(track: bool, lastrow: bool) -> str:
    """The kernel variant (``LAUNCHES`` key) a call launches."""
    if lastrow:
        return "sdtw_lastrow"
    return "sdtw_span" if track else "sdtw_plain"


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def smem_bytes(n: int, block_q: int, ring: int, span: bool) -> int:
    """Shared memory of one block (``smem_bytes`` in ``csrc/sdtw.cu``)."""
    return 4 * (ring + block_q * n * (7 if span else 4))


def resolve_blocks(b: int, m: int, block_q=None, block_m=None, *, n: int,
                   span: bool = False):
    """The Hopper launch policy for a (b, n) batch against m columns.

    Returns ``(block_q, block_m, threads_per_query, ring)``: queries per
    block, reference samples staged per tile, threads per query (rows
    beyond it loop), and the shared reference ring (a power of two of at
    least ``n + block_m`` samples). ``None`` picks the defaults: one warp
    multiple of threads per query up to ``BLOCK_THREADS``, as many
    queries per block as fill ``BLOCK_THREADS``, ``DEFAULT_TILE``.
    The reference's TPU knobs (``scan_scheme``, ``row_tile``,
    ``interpret``) have no counterpart here. Raises ``ValueError`` when N
    exceeds ``MAX_N`` or the block does not fit in shared memory.
    """
    if n > MAX_N:
        raise ValueError(f"the CUDA sDTW kernel takes queries of up to "
                         f"{MAX_N} samples, got N={n}")
    tpq = min(_ceil_to(max(n, 1), 32), BLOCK_THREADS)
    if block_q is None:
        block_q = max(1, min(BLOCK_THREADS // tpq, b))
    if block_m is None:
        block_m = DEFAULT_TILE
    if block_q < 1 or block_m < 1 or block_q * tpq > 1024:
        raise ValueError(f"invalid block shape block_q={block_q}, "
                         f"block_m={block_m} for N={n}")
    ring = _pow2_at_least(n + block_m)
    need = smem_bytes(n, block_q, ring, span)
    if need > SMEM_LIMIT:
        raise ValueError(f"block_q={block_q}, block_m={block_m} at N={n} "
                         f"needs {need} bytes of shared memory; the limit "
                         f"is {SMEM_LIMIT}")
    return block_q, block_m, tpq, ring


def kernel_carry_init(b: int, n: int, dtype, track_start: bool = False,
                      device=None):
    """Fresh kernel chunk carry for a (b, N) batch: ``(bcol, best, pos)``
    or, with ``track_start``, ``(bcol, bstart, best, pos, start)`` —
    exactly what ``sdtw_cuda(return_carry=True)`` emits."""
    dev = resolve_device(device)
    acc = accum_dtype(dtype)
    bcol = torch.full((b, n), big(acc), dtype=acc, device=dev)
    best = torch.full((b,), big(acc), dtype=acc, device=dev)
    pos = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if not track_start:
        return bcol, best, pos
    return (bcol, torch.full((b, n), INT_FAR, dtype=torch.int32, device=dev),
            best, pos, torch.full((b,), -1, dtype=torch.int32, device=dev))


def carry_from_numpy(carry, device=None):
    """The JAX package's chunk carry — the 3-tuple ``(bcol, best, pos)`` or
    the 5-tuple ``(bcol, bstart, best, pos, start)`` as numpy arrays — as
    the port's tensors on ``device``, so a stream started in JAX continues
    here."""
    if len(carry) not in (3, 5):
        raise ValueError(f"carry must have 3 or 5 elements, got {len(carry)}")
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.array(x)).to(dev)
                 for x in carry)


def carry_to_numpy(carry):
    """The port's chunk carry as numpy arrays, in the JAX package's layout."""
    return tuple(x.detach().cpu().numpy() for x in carry)


def _lib():
    lib = _build.load("sdtw")
    if not getattr(lib, "_repro_bound", False):
        lib.sdtw_launch.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 15
                                    + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.sdtw_launch.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _launch_cuda(q, r, qlens, metric, bcol, best, pos, bstart, start,
                 ref_offset, rlen, ref_lead, want_lastrow, block_q, block_m):
    """Allocate the outputs and launch the kernel on the current stream."""
    track = bstart is not None
    b, n = q.shape
    m = r.shape[0]
    acc = q.dtype
    dev = q.device
    bq, tile, tpq, ring = resolve_blocks(b, m, block_q, block_m, n=n,
                                         span=track)

    def empty(shape, dtype, on=True):
        return torch.empty(shape, dtype=dtype, device=dev) if on else None

    outs = (empty((b,), acc), empty((b,), torch.int32),
            empty((b,), torch.int32, track), empty((b, n), acc),
            empty((b, n), torch.int32, track), empty((b, m), acc, want_lastrow),
            empty((b, m), torch.int32, want_lastrow and track))
    if b == 0:
        return outs

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = _lib().sdtw_launch(
            int(acc.is_floating_point), int(metric == "square_diff"),
            int(track), int(want_lastrow), ptr(q), ptr(r), ptr(qlens),
            ptr(bcol), ptr(bstart), ptr(best), ptr(pos), ptr(start),
            *[ptr(o) for o in outs], b, n, m, int(ref_offset), int(rlen),
            int(ref_lead), bq, tpq, tile, ring,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sdtw CUDA kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[variant(track, want_lastrow)] += 1
    return outs


def sdtw_cuda(queries, reference, qlens=None, metric: str = "abs_diff",
              block_q: int | None = None, block_m: int | None = None,
              carry=None, return_carry: bool = False, ref_offset=0,
              return_positions: bool = False, return_spans: bool = False,
              track_start: bool = False, ref_len=None, ref_lead=0,
              return_lastrow: bool = False, device=None):
    """Batched sDTW through the hand-written kernel: queries (B, N),
    reference (M,) → (B,) distances.

    Inputs are moved to ``device`` (default the CUDA device; ``"cpu"``
    runs the plain version). ``block_q``/``block_m`` override the launch
    policy of ``resolve_blocks``. ``carry`` continues a previous call's
    ``return_carry=True`` state (a 5-tuple selects span mode; a legacy
    ``(bcol, best)`` pair seeds positions at -1). ``ref_offset`` is the
    global column of ``reference[0]``, so reported positions are global;
    only the first ``ref_len`` columns are real (the carry exits at
    ``ref_len - 1``; ``ref_len <= 0`` passes the carry through); the first
    ``ref_lead`` columns are masked (a fresh carry is assumed).

    Returns the distances, ``(dists, ends)`` with ``return_positions``, or
    ``(dists, starts, ends)`` with ``return_spans``; then the new carry
    with ``return_carry``; then the (B, M) last row (BIG where masked),
    and in span mode its start lane, with ``return_lastrow``.
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{METRICS}")
    dev = resolve_device(device)
    queries = as_tensor(queries, dev)
    reference = as_tensor(reference, dev)
    if queries.ndim != 2 or reference.ndim != 1:
        raise ValueError(f"queries must be (B, N) and reference (M,), got "
                         f"{tuple(queries.shape)} and "
                         f"{tuple(reference.shape)}")
    b, n = queries.shape
    m = reference.shape[0]
    if m == 0:
        raise ValueError("reference must be non-empty")
    rlen = m if ref_len is None else int(ref_len)
    if rlen > m:
        raise ValueError(f"ref_len={rlen} exceeds the reference's {m} "
                         f"columns")
    acc = accum_dtype(result_dtype(queries, reference))
    BIG = big(acc)

    carry = tuple(carry) if carry is not None else ()
    track = return_spans or track_start or len(carry) == 5
    bstart = pos = start = None
    if len(carry) == 5:
        bcol, bstart, best, pos, start = carry
    elif len(carry) == 3:
        bcol, best, pos = carry
    elif len(carry) == 2:
        bcol, best = carry
    elif len(carry) == 0:
        bcol = torch.full((b, n), BIG, dtype=acc, device=dev)
        best = torch.full((b,), BIG, dtype=acc, device=dev)
    else:
        raise ValueError(f"carry must have 2, 3 or 5 elements, got "
                         f"{len(carry)}")
    if pos is None:
        pos = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if track:
        if bstart is None:
            bstart = torch.full((b, n), INT_FAR, dtype=torch.int32,
                                device=dev)
        if start is None:
            start = torch.full((b,), -1, dtype=torch.int32, device=dev)

    def prep(t, dtype):
        return None if t is None else as_tensor(t, dev, dtype).contiguous()

    q = prep(queries, acc)
    r = prep(reference, acc)
    qlens = (torch.full((b,), n, dtype=torch.int32, device=dev)
             if qlens is None else prep(qlens, torch.int32))
    bcol, best = prep(bcol, acc), prep(best, acc)
    pos, bstart, start = (prep(pos, torch.int32), prep(bstart, torch.int32),
                          prep(start, torch.int32))

    if dev.type == "cuda":
        outs = _launch_cuda(q, r, qlens, metric, bcol, best, pos, bstart,
                            start, ref_offset, rlen, ref_lead,
                            return_lastrow, block_q, block_m)
    else:
        outs = sdtw_kernel_plain(q, r, qlens, metric, bcol, best, pos,
                                 bstart, start, int(ref_offset), rlen,
                                 int(ref_lead), return_lastrow)
    dist, end_pos, start_out, bcol_out, bstart_out, lastrow, lstart = outs

    if return_spans:
        res = (dist, start_out, end_pos)
    elif return_positions:
        res = (dist, end_pos)
    else:
        res = dist
    extras = []
    if return_carry:
        extras.append((bcol_out, bstart_out, dist, end_pos, start_out)
                      if track else (bcol_out, dist, end_pos))
    if return_lastrow:
        extras.append(lastrow)
        if track:
            extras.append(lstart)
    return (res, *extras) if extras else res
