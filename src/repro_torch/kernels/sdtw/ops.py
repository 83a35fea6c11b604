"""Wrapper around the hand-written Hopper sDTW kernels.

``sdtw_cuda`` is the port's counterpart of ``repro.kernels.sdtw.ops
.sdtw_pallas``: the same arguments, return modes and return order
``res[, new_carry][, lastrow[, lastrow_starts]]``, including the chunk
carry — ``(bcol (B, N), best (B,), pos (B,))``, or in span mode the
5-tuple ``(bcol, bstart, best, pos, start)`` — that streams a reference
of any length through fixed launches, and the ``ref_offset`` /
``ref_len`` / ``ref_lead`` slice masks. One thing the TPU kernel lacks:
a banned column range per query, ``[excl_lo[b], excl_hi[b])`` in global
columns (the self-join's trivial-match zone, which the reference's row
scan applies as BIG distances), so that exclusion zones run on the card.

Three kernels compute the same function (``kernel=``):

  * ``rows`` (``csrc/sdtw_rows.cu``): one warp per query, ``R`` rows per
    lane in registers, a skewed sweep with no shared memory and no
    barrier; queries of up to ``ROWS_MAX_N`` samples;
  * ``chain`` (``csrc/sdtw_chain.cu``): one query across the ``W`` warps
    of a block, each warp the rows kernel's sweep over its ``32·R`` rows,
    the warps handing their bottom row down through mbarrier-guarded
    rings in shared memory; queries of up to ``CHAIN_MAX_N`` samples;
  * ``wavefront`` (``csrc/sdtw.cu``): one block per ``block_q`` queries
    walking the anti-diagonals through shared memory, or through a global
    scratch when a block's rows do not fit there; any N.

``kernel="auto"`` takes the rows kernel up to ``ROWS_MAX_N`` (the chain
kernel for a small batch on the card), the chain kernel up to
``CHAIN_MAX_N`` and the wavefront kernel beyond (``choose_kernel``).
Dispatch: tensors on a CUDA device launch the chosen
kernel (built at first use by ``_build``); tensors on the CPU run the
plain PyTorch version of all three (``sdtw.sdtw_kernel_plain``). There is
no fallback: a CUDA call that cannot launch raises.

Each launch adds one to ``LAUNCHES["<kernel>_<variant>"]``, where the
variant is ``plain`` (K1), ``span`` (K2, start lane) or ``lastrow`` (K3,
last-row capture, with or without the start lane), with ``_ban`` appended
for the instantiations with the ban.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.distances import (INT_FAR, METRICS, accum_dtype, big,
                                        result_dtype)
from repro_torch.device import as_tensor, resolve_device
from . import _build
from .sdtw import sdtw_kernel_plain

KERNELS = ("rows", "chain", "wavefront")
#: Rows per lane the rows kernel is built for (``pick_rows`` in
#: ``csrc/sdtw_rows.cu``): a warp covers up to 32·R query rows.
ROWS_PER_LANE = (1, 2, 4, 7, 8, 16, 25, 32, 48)
#: Longest query the rows kernel takes.
ROWS_MAX_N = 32 * ROWS_PER_LANE[-1]
#: Warps (queries) per block of the rows kernel: the default and the most.
ROWS_WARPS = 4
ROWS_MAX_WARPS = 8
#: Rows per lane the chain kernel is built for (``pick_rows`` in
#: ``csrc/sdtw_chain.cu``), and the most warps a block (so a query)
#: takes: 512 threads of up to 128 registers fill the SM's 65,536.
CHAIN_ROWS = (4, 8, 16)
CHAIN_MAX_WARPS = 16
#: Longest query the chain kernel takes: 16 warps of 32 lanes of 16 rows.
CHAIN_MAX_N = 32 * CHAIN_ROWS[-1] * CHAIN_MAX_WARPS
#: Warps an SM in use should hold before the chain policy takes fewer,
#: longer warps, and a step's overhead in cells (the loop's per-step
#: instructions over a cell's: a larger R shares it over more rows). Both
#: fitted on the H100 (PERF.md §6).
CHAIN_WARPS_PER_SM = 12
CHAIN_STEP_ROWS = 4
#: Threads a wavefront block aims for: queries of up to 512 rows share it.
BLOCK_THREADS = 512
#: Reference samples staged into shared memory per tile.
DEFAULT_TILE = 256
#: Dynamic shared memory one block can have on Hopper. A wavefront block
#: needs 4·N bytes for the query and 12·N for three diagonals (12·N more
#: for their start lanes in span mode), plus the reference ring; past
#: this the rows and diagonals move to a global scratch.
SMEM_LIMIT = 232_448
#: Most global scratch one wavefront launch allocates; longer batches
#: launch in slices.
SCRATCH_LIMIT = 1 << 30

LAUNCHES = {f"{k}_{v}{b}": 0 for k in KERNELS
            for v in ("plain", "span", "lastrow") for b in ("", "_ban")}


def reset_launches():
    """Set every launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def variant(track: bool, lastrow: bool, kernel: str,
            ban: bool = False) -> str:
    """The ``LAUNCHES`` key of a launch of ``kernel`` in this mode."""
    var = "lastrow" if lastrow else "span" if track else "plain"
    return f"{kernel}_{var}{'_ban' if ban else ''}"


def kernel_bans(excl_lo, excl_hi, b: int, device, test_device=False):
    """Per-query banned column ranges as a pair of contiguous (b,) int32
    tensors on ``device`` — or ``None`` when none is given or every range
    is empty, so that a launch runs the instantiation without a ban.
    Scalars apply to every query. Ranges that come from the host are
    tested for free; ranges already on a CUDA device are tested only with
    ``test_device`` (one synchronisation, which a loop over slices pays
    once, before it, and not at every launch)."""
    if excl_lo is None and excl_hi is None:
        return None
    if excl_lo is None or excl_hi is None:
        raise ValueError("excl_lo and excl_hi must be given together")
    lo, hi = (torch.as_tensor(x, dtype=torch.int32) for x in (excl_lo,
                                                              excl_hi))
    lo, hi = (x.expand(b) if x.ndim == 0 else x for x in (lo, hi))
    if lo.shape != (b,) or hi.shape != (b,):
        raise ValueError(f"excl_lo and excl_hi must be scalars or ({b},), "
                         f"got {tuple(lo.shape)} and {tuple(hi.shape)}")
    if ((lo.device.type == "cpu" or test_device)
            and not bool((hi > lo).any())):
        return None
    return lo.to(device).contiguous(), hi.to(device).contiguous()


def choose_kernel(n: int, kernel: str = "auto", b=None, sms=None) -> str:
    """The kernel a (b, n) batch runs on: ``kernel`` itself when forced,
    else the rows kernel up to ``ROWS_MAX_N``, the chain kernel up to
    ``CHAIN_MAX_N`` and the wavefront beyond — with one exception, where
    the batch and the card's SM count are given: a batch of b <
    ``CHAIN_WARPS_PER_SM``·sms queries of up to ``ROWS_MAX_N`` samples,
    whose one warp a query leaves the SMs short of warps, runs on the
    chain kernel when that splits each query across several warps: on
    the H100 the chain kernel was 1.1-1.7× faster at ECG-cut's 256
    queries and on the self-join's batches of 256 windows of 512, the
    rows kernel at Human's 131,072 (PERF.md §6). The answers are the
    same. Raises ``ValueError`` for an unknown name or a query too long
    for the forced kernel."""
    if kernel == "auto":
        if n > ROWS_MAX_N:
            return "chain" if n <= CHAIN_MAX_N else "wavefront"
        if (b is not None and sms is not None
                and b < CHAIN_WARPS_PER_SM * sms
                and resolve_chain(b, n, sms=sms)[0] > 1):
            return "chain"
        return "rows"
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be 'auto' or one of {KERNELS}, got "
                         f"{kernel!r}")
    if kernel == "rows" and n > ROWS_MAX_N:
        raise ValueError(f"the rows kernel takes queries of up to "
                         f"{ROWS_MAX_N} samples, got N={n}")
    if kernel == "chain" and n > CHAIN_MAX_N:
        raise ValueError(f"the chain kernel takes queries of up to "
                         f"{CHAIN_MAX_N} samples, got N={n}")
    return kernel


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(index=None) -> int:
    """Streaming multiprocessors of CUDA device ``index``; ``None`` (a
    ``torch.device("cuda")`` without an index) reads the current device,
    so that a worker pinned with ``torch.cuda.device`` sees its own
    card."""
    return _sm_count(torch.cuda.current_device() if index is None
                     else index)


def resolve_rows(b: int, n: int, block_q=None, *, sms: int, rows=None):
    """The rows kernel's launch policy for a (b, n) batch on a card of
    ``sms`` SMs.

    Returns ``(warps, rows)``: queries (warps) per block and R, the rows
    per lane: the smallest R of ``ROWS_PER_LANE`` that covers n in 32
    lanes and divides n with 32·R ≤ 1.15·n (so row n - 1 is a lane's last
    slot and the harvest reads a fixed register), else the smallest that
    covers n. ``block_q=None`` takes ``ROWS_WARPS`` warps per block, fewer
    when b is small so the grid still covers the card's SMs; ``rows``
    forces R (the tuner's choice).
    Raises ``ValueError`` for a query, an R or a block the kernel does not
    take.
    """
    n = max(int(n), 1)
    cover = [r for r in ROWS_PER_LANE if 32 * r >= n]
    if not cover:
        raise ValueError(f"the rows kernel takes queries of up to "
                         f"{ROWS_MAX_N} samples, got N={n}")
    if rows is not None and rows not in cover:
        raise ValueError(f"the rows kernel takes R in {cover} at N={n}, got "
                         f"rows={rows}")
    fit = [r for r in cover if n % r == 0 and 32 * r <= 1.15 * n]
    if block_q is None:
        block_q = max(1, min(ROWS_WARPS, b // sms))
    if not 1 <= block_q <= ROWS_MAX_WARPS:
        raise ValueError(f"the rows kernel takes 1 to {ROWS_MAX_WARPS} "
                         f"queries per block, got block_q={block_q}")
    return block_q, rows if rows is not None else (fit or cover)[0]


def resolve_chain(b: int, n: int, block_q=None, *, sms: int, rows=None):
    """The chain kernel's launch policy for a (b, n) batch on a card of
    ``sms`` SMs.

    Returns ``(warps, rows, block_q)``: W, the warps of one query (each
    owns 32·R rows), R, the rows per lane, and the queries per block.
    A query is one block, so b queries keep min(b, sms) SMs busy with
    W·max(1, b / sms) warps each. Among the R of ``CHAIN_ROWS`` that give
    those SMs ``CHAIN_WARPS_PER_SM`` warps, the one with the least issue,
    W·(R + ``CHAIN_STEP_ROWS``) rows a step (slack rows and per-step
    overhead), ties to an R that divides n (row n - 1 is then a lane's
    last slot and the harvest reads a fixed register); when none gives
    that many, the R with the most warps. ``rows`` forces R (the tuner's
    choice).
    ``block_q=None`` puts queries of fewer than 4 warps several to a block
    (at most 4 warps, and no fewer blocks than SMs). Raises ``ValueError``
    for a query longer than ``CHAIN_MAX_N``, an R or a block the kernel
    does not take.
    """
    n = max(int(n), 1)
    cover = [(r, -(-n // (32 * r))) for r in CHAIN_ROWS
             if -(-n // (32 * r)) <= CHAIN_MAX_WARPS]
    if not cover:
        raise ValueError(f"the chain kernel takes queries of up to "
                         f"{CHAIN_MAX_N} samples, got N={n}")
    if rows is not None:
        cover = [c for c in cover if c[0] == rows]
        if not cover:
            raise ValueError(f"the chain kernel takes R in {CHAIN_ROWS} "
                             f"with at most {CHAIN_MAX_WARPS} warps at "
                             f"N={n}, got rows={rows}")
    busy = [c for c in cover
            if c[1] * max(1.0, b / sms) >= CHAIN_WARPS_PER_SM]
    rows, warps = (min(busy, key=lambda c: (c[1] * (c[0] + CHAIN_STEP_ROWS),
                                            n % c[0] != 0))
                   if busy else max(cover, key=lambda c: c[1]))
    if block_q is None:
        block_q = max(1, min(4 // warps, b // sms))
    if block_q < 1 or block_q * warps > CHAIN_MAX_WARPS:
        raise ValueError(f"the chain kernel takes 1 to "
                         f"{CHAIN_MAX_WARPS // warps} queries per block at "
                         f"N={n}, got block_q={block_q}")
    return warps, rows, block_q


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def smem_bytes(n: int, block_q: int, ring: int, span: bool) -> int:
    """Bytes of one wavefront block's layout (``smem_bytes`` in
    ``csrc/sdtw.cu``): in shared memory, or with ``ring=0`` in the
    global scratch."""
    return 4 * (ring + block_q * n * (7 if span else 4))


def resolve_blocks(b: int, m: int, block_q=None, block_m=None, *, n: int,
                   span: bool = False):
    """The wavefront kernel's launch policy for a (b, n) batch against m
    columns.

    Returns ``(block_q, block_m, threads_per_query, ring, scratch)``:
    queries per block, reference samples staged per tile, threads per
    query (rows beyond it loop), the shared reference ring (a power of two
    of at least ``n + block_m`` samples), and whether the block's query
    rows and diagonals live in a global scratch because they do not fit in
    ``SMEM_LIMIT`` bytes of shared memory (the reference is then read from
    device memory and the ring is unused). ``None`` picks the defaults:
    one warp multiple of threads per query up to ``BLOCK_THREADS``, as
    many queries per block as fill ``BLOCK_THREADS``, ``DEFAULT_TILE``.
    The reference's TPU knobs (``scan_scheme``, ``row_tile``,
    ``interpret``) have no counterpart here. Raises ``ValueError`` for a
    block shape the kernel does not take.
    """
    tpq = min(_ceil_to(max(n, 1), 32), BLOCK_THREADS)
    if block_q is None:
        block_q = max(1, min(BLOCK_THREADS // tpq, b))
    if block_m is None:
        block_m = DEFAULT_TILE
    if block_q < 1 or block_m < 1 or block_q * tpq > 1024:
        raise ValueError(f"invalid block shape block_q={block_q}, "
                         f"block_m={block_m} for N={n}")
    ring = _pow2_at_least(n + block_m)
    scratch = smem_bytes(n, block_q, ring, span) > SMEM_LIMIT
    return block_q, block_m, tpq, ring, scratch


def launch_config(b: int, n: int, m: int, *, sms: int, kernel="auto",
                  rows=None, block_q=None, block_m=None, span=False) -> dict:
    """The launch a (b, n) batch against m columns gets from the hand-set
    policies (``choose_kernel``, then ``resolve_rows`` / ``resolve_chain``
    / ``resolve_blocks``), with the given knobs forced: ``{"kernel",
    "rows", "warps", "block_q", "block_m"}`` — R, the warps of one query
    (the wavefront's: its threads a query / 32) and the queries a block;
    ``block_m`` is the wavefront's staged tile (``None`` on the others,
    which raise when one is given, as ``rows`` does on the wavefront).
    This is ``tune='off'``'s launch, and the autotuner's candidates."""
    kernel = choose_kernel(n, kernel, b, sms)
    if kernel != "wavefront" and block_m is not None:
        raise ValueError(f"block_m is the wavefront kernel's staged tile; "
                         f"the {kernel} kernel stages none")
    if kernel == "rows":
        block_q, rows = resolve_rows(b, n, block_q, sms=sms, rows=rows)
        warps = 1
    elif kernel == "chain":
        warps, rows, block_q = resolve_chain(b, n, block_q, sms=sms,
                                             rows=rows)
    else:
        if rows is not None:
            raise ValueError("rows= is R of the rows and chain kernels; the "
                             "wavefront kernel's threads a query decide it")
        block_q, block_m, tpq, _, _ = resolve_blocks(b, m, block_q, block_m,
                                                     n=n, span=span)
        rows, warps = -(-max(int(n), 1) // tpq), tpq // 32
    return {"kernel": kernel, "rows": rows, "warps": warps,
            "block_q": block_q, "block_m": block_m}


def tuned_launch(b: int, n: int, m: int, *, sms: int, kernel="auto",
                 rows=None, block_q=None, block_m=None, variant="plain",
                 ban=False, metric="abs_diff", dtype="int32", tune="off"):
    """``launch_config`` with the unset knobs from the autotuner: under
    ``tune='model'`` or ``'measure'`` the ``repro_torch.tune`` oracle's
    decision for this bucket and launch ``variant`` (``'plain'``,
    ``'span'``, ``'lastrow'``) fills the kernel (when ``kernel='auto'``)
    and, for that kernel, R, the queries a block and the tile; explicit
    knobs always win, and ``tune='off'`` is the hand-set policy exactly.
    A bucket's decision that does not fit this shape (R or the kernel
    chosen for a shorter query of the same bucket) gives way to the
    hand-set policy. Returns ``(config, resolution)``; the resolution
    (``tune.Resolution``) is ``None`` under ``'off'``."""
    span = variant != "plain"
    if tune == "off":
        return launch_config(b, n, m, sms=sms, kernel=kernel, rows=rows,
                             block_q=block_q, block_m=block_m,
                             span=span), None
    from repro_torch.tune import resolve
    res = resolve(b, n, m, backend="h100", metric=metric, dtype=dtype,
                  mode=tune, variant=variant, ban=ban)
    c = res.config
    tk = c.kernel if kernel == "auto" else kernel
    tuned = dict(kernel=tk, rows=rows, block_q=block_q, block_m=block_m)
    if tk == c.kernel:
        tuned["rows"] = c.rows if rows is None and tk != "wavefront" \
            else rows
        tuned["block_q"] = c.block_q if block_q is None else block_q
        tuned["block_m"] = (c.block_m if block_m is None
                            and tk == "wavefront" else block_m)
    try:
        return launch_config(b, n, m, sms=sms, span=span, **tuned), res
    except ValueError:
        return launch_config(b, n, m, sms=sms, kernel=kernel, rows=rows,
                             block_q=block_q, block_m=block_m,
                             span=span), res


def scratch_batch(n: int, block_q: int, span: bool) -> int:
    """Queries one wavefront launch with a global scratch takes: a
    multiple of ``block_q`` whose scratch stays within ``SCRATCH_LIMIT``."""
    per_block = smem_bytes(n, block_q, 0, span)
    if per_block > SCRATCH_LIMIT:
        raise ValueError(f"N={n} needs {per_block} bytes of scratch per "
                         f"block; the limit is {SCRATCH_LIMIT}")
    return SCRATCH_LIMIT // per_block * block_q


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


def _lib(name: str):
    """The loaded library of ``csrc/<name>.cu`` with its entry bound."""
    lib = _build.load(name)
    if not getattr(lib, "_repro_bound", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        if name == "sdtw":
            lib.sdtw_launch.argtypes = [i] * 4 + [p] * 17 + [i] * 10 + [p] * 2
            lib.sdtw_launch.restype = i
        elif name == "sdtw_chain":
            lib.sdtw_chain_launch.argtypes = ([i] * 3 + [p] * 17 + [i] * 9
                                              + [p])
            lib.sdtw_chain_launch.restype = i
        else:
            lib.sdtw_rows_launch.argtypes = [i] * 3 + [p] * 17 + [i] * 8 + [p]
            lib.sdtw_rows_launch.restype = i
        lib._repro_bound = True
    return lib


def _launch_cuda(q, r, qlens, metric, bcol, best, pos, bstart, start,
                 ref_offset, rlen, ref_lead, want_lastrow, cfg, bans=None):
    """Allocate the outputs and launch ``cfg["kernel"]`` (``"rows"``,
    ``"chain"`` or ``"wavefront"``; ``cfg`` from ``launch_config``) on the
    current stream — its instantiation with the ban when ``bans``
    (``kernel_bans``) is given; the wavefront kernel in batch slices when
    its global scratch would exceed ``SCRATCH_LIMIT``."""
    track = bstart is not None
    b, n = q.shape
    m = r.shape[0]
    acc = q.dtype
    dev = q.device
    kernel, rows, bq = cfg["kernel"], cfg["rows"], cfg["block_q"]
    warps = bq if kernel == "rows" else cfg["warps"]
    if kernel == "wavefront":
        bq, tile, tpq, ring, scratch = resolve_blocks(
            b, m, bq, cfg["block_m"], n=n, span=track)

    def empty(shape, dtype, on=True):
        return torch.empty(shape, dtype=dtype, device=dev) if on else None

    outs = (empty((b,), acc), empty((b,), torch.int32),
            empty((b,), torch.int32, track), empty((b, n), acc),
            empty((b, n), torch.int32, track), empty((b, m), acc, want_lastrow),
            empty((b, m), torch.int32, want_lastrow and track))
    if b == 0:
        return outs
    batched = ((q, qlens, bcol, bstart, best, pos, start) + outs
               + (bans if bans is not None else (None, None)))
    flags = (int(acc.is_floating_point), int(metric == "square_diff"),
             int(track))
    scalars = (m, int(ref_offset), int(rlen), int(ref_lead))

    def ptrs(lo, hi):
        p = [None if t is None else t[lo:hi].data_ptr() for t in batched]
        return p[:1] + [r.data_ptr()] + p[1:]

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel != "wavefront":
            slices = [(0, b)]
        else:
            step = scratch_batch(n, bq, track) if scratch else b
            slices = [(lo, min(b, lo + step)) for lo in range(0, b, step)]
            blocks = -(-min(step, b) // bq)
            buf = (torch.empty(blocks * smem_bytes(n, bq, 0, track),
                               dtype=torch.uint8, device=dev)
                   if scratch else None)
        for lo, hi in slices:
            if kernel == "rows":
                err = _lib("sdtw_rows").sdtw_rows_launch(
                    *flags, *ptrs(lo, hi), hi - lo, n, *scalars, rows,
                    warps, stream)
            elif kernel == "chain":
                err = _lib("sdtw_chain").sdtw_chain_launch(
                    *flags, *ptrs(lo, hi), hi - lo, n, *scalars, rows,
                    warps, bq, stream)
            else:
                err = _lib("sdtw").sdtw_launch(
                    *flags, int(want_lastrow), *ptrs(lo, hi), hi - lo, n,
                    *scalars, bq, tpq, tile, ring,
                    None if buf is None else buf.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"sdtw {kernel} CUDA kernel launch failed "
                                   f"with CUDA error {err}")
            LAUNCHES[variant(track, want_lastrow, kernel,
                             bans is not None)] += 1
    return outs


@obs.spanned("sdtw")
def sdtw_cuda(queries, reference, qlens=None, metric: str = "abs_diff",
              block_q: int | None = None, block_m: int | None = None,
              carry=None, return_carry: bool = False, ref_offset=0,
              return_positions: bool = False, return_spans: bool = False,
              track_start: bool = False, ref_len=None, ref_lead=0,
              return_lastrow: bool = False, device=None,
              kernel: str = "auto", excl_lo=None, excl_hi=None,
              rows: int | None = None, tune: str = "off"):
    """Batched sDTW through the hand-written kernels: queries (B, N),
    reference (M,) → (B,) distances.

    Inputs are moved to ``device`` (default the CUDA device; ``"cpu"``
    runs the plain version). ``kernel`` picks the CUDA kernel: ``"auto"``
    (``choose_kernel``), ``"rows"``, ``"chain"`` or ``"wavefront"``; the
    CPU runs the plain version whatever it says. ``block_q`` overrides the
    queries per block of each kernel's policy (``resolve_rows``,
    ``resolve_chain``, ``resolve_blocks``), ``rows`` the rows and chain
    kernels' R, ``block_m`` the wavefront's staged tile (a CUDA launch of
    the rows or chain kernel raises if it is given). ``tune`` is the
    reference's ``sdtw_pallas(tune=)``: ``'off'`` (the default, as there)
    keeps the hand-set policies; ``'model'`` and ``'measure'`` fill the
    unset knobs — the kernel too, under ``kernel="auto"`` — from the
    ``repro_torch.tune`` oracle (``tuned_launch``); explicit knobs always
    win, and the answers do not depend on it. ``carry`` continues a
    previous call's ``return_carry=True`` state (a 5-tuple selects span
    mode; a legacy ``(bcol, best)`` pair seeds positions at -1).
    ``ref_offset`` is the global column of ``reference[0]``, so reported
    positions are global; only the first ``ref_len`` columns are real (the
    carry exits at ``ref_len - 1``; ``ref_len <= 0`` passes the carry
    through); the first ``ref_lead`` columns are masked (a fresh carry is
    assumed). ``excl_lo``/``excl_hi`` ((B,) or scalars, global columns)
    mask query b's columns ``[excl_lo[b], excl_hi[b])`` as well; ranges
    from the host that are empty for every query launch the instantiation
    without a ban (``kernel_bans``, which a slice loop calls once for
    ranges on the card).

    Returns the distances, ``(dists, ends)`` with ``return_positions``, or
    ``(dists, starts, ends)`` with ``return_spans``; then the new carry
    with ``return_carry``; then the (B, M) last row (BIG where masked),
    and in span mode its start lane, with ``return_lastrow``.

    Each call runs under the span ``repro_torch.sdtw``
    (``repro_torch.obs``).
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
    if dev.type != "cuda":
        choose_kernel(n, kernel, b)     # the kernel's name and limits
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
    bans = kernel_bans(excl_lo, excl_hi, b, dev)

    if dev.type == "cuda":
        cfg, _ = tuned_launch(
            b, n, m, sms=sm_count(dev.index), kernel=kernel, rows=rows,
            block_q=block_q, block_m=block_m,
            variant=("lastrow" if return_lastrow else "span" if track
                     else "plain"),
            ban=bans is not None, metric=metric,
            dtype=str(acc).removeprefix("torch."), tune=tune)
        outs = _launch_cuda(q, r, qlens, metric, bcol, best, pos, bstart,
                            start, ref_offset, rlen, ref_lead,
                            return_lastrow, cfg, bans)
    else:
        lo, hi = bans if bans is not None else (None, None)
        outs = sdtw_kernel_plain(q, r, qlens, metric, bcol, best, pos,
                                 bstart, start, int(ref_offset), rlen,
                                 int(ref_lead), return_lastrow, lo, hi)
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
