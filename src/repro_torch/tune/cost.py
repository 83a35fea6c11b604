"""The analytical stage of the autotuner: a per-config ``KernelCostModel``.

Counterpart of ``repro.tune.cost``. Every execution regime is priced in
microseconds from the per-backend constants of
``repro_torch.core.platforms``:

  * on the CPU family (``'interpret'``, the reference's constants), the
    in-core schedules and the chunked stream, term for term as the
    reference prices them — ``rowscan`` (N sequential row steps over the
    (nq, M) live row, inflating past the cache knee), ``wavefront``
    (N+M-1 anti-diagonal steps over nq·N cells) and ``chunked`` (row-scan
    economics per tile plus a per-tile cost) — so CPU routes rank as the
    JAX package ranks them;
  * on the card (``'h100'``), one launch of a hand-written CUDA kernel
    (``cuda_us``), in place of the reference's pallas grid: a warp sweeps
    the reference one column a step, ``rows`` cells a lane, issuing
    ``rows · cell_instr + step_instr`` warp-instructions a step; an SM
    issues for the warps it holds, but never faster than ``sat_warps``
    of them can hide the step's latency; the busiest SM sets the time;
    the memory term comes from the two-term ``kernel_roofline``.
    ``cuda_candidates`` ranks the launches the wrappers take — rows /
    chain / wavefront × R × queries per block — and rejects what they
    reject (``ops.resolve_rows`` / ``resolve_chain`` / ``resolve_blocks``
    raise for N past a kernel's limit, more than 16 warps a block, more
    than 8 rows-kernel queries a block, more than 1,024 threads).

The model's absolute numbers are rough; only its *ranking* is consumed,
and ``repro_torch.tune.validate`` holds it against measured rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.platforms import (BackendModel, CudaBackendModel,
                                        backend_model)
from repro_torch.launch.roofline import kernel_roofline

#: Launch variants a CUDA tuning decision is keyed on: K1 (distance and
#: end), K2 (the start lane) and K3 (the last-row capture).
VARIANTS = ("plain", "span", "lastrow")


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """Knobs a tuning decision may set — the reference's fields, plus the
    card's: ``kernel`` (``'rows'``, ``'chain'`` or ``'wavefront'``),
    ``rows`` (R, the rows a lane), ``warps`` (the warps of one query: 1 on
    the rows kernel, W on the chain kernel, threads/32 on the wavefront)
    with ``block_q`` (queries a block) and ``block_m`` (the wavefront's
    staged tile). ``None`` means "not applicable"; the oracle only fills
    knobs the caller left unset."""
    impl: Optional[str] = None
    block_q: Optional[int] = None
    block_m: Optional[int] = None
    scan_scheme: Optional[str] = None
    row_tile: Optional[int] = None
    chunk: Optional[int] = None
    n_micro: Optional[int] = None
    kernel: Optional[str] = None
    rows: Optional[int] = None
    warps: Optional[int] = None
    score_us: Optional[float] = None
    source: str = "model"          # 'model' | 'measured' | 'default'

    def to_json(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_json(cls, d: dict) -> "TunedConfig":
        """Unknown fields are ignored, so tables load across packages."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _pow2_bucket(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def bucket_key(backend: str, metric: str, dtype: str, nq: int, n: int,
               m: int, variant: Optional[str] = None) -> str:
    """The (backend, metric, dtype, pow-2 shape bucket) table key, as in
    the reference; CUDA decisions append their launch ``variant``."""
    key = (f"{backend}/{metric}/{dtype}/b{_pow2_bucket(max(1, nq))}"
           f"/n{_pow2_bucket(max(1, n))}/m{_pow2_bucket(max(1, m))}")
    return key if variant is None else f"{key}/{variant}"


def launch_label(cfg: dict) -> str:
    """Compact name of a CUDA launch configuration (``explain``)."""
    return (f"{cfg['kernel']}/R{cfg['rows']}/W{cfg['warps']}"
            f"/bq{cfg['block_q']}")


class KernelCostModel:
    """Prices engine configurations for one backend (see module doc)."""

    #: chunk sizes the chunked oracle ranks.
    CHUNK_CANDIDATES = (4096, 8192, 16384, 32768, 65536, 131072)
    #: queries a block the CUDA oracle tries (the policy's pick is added).
    BLOCK_Q_CANDIDATES = (1, 2, 4, 8)

    def __init__(self, backend="interpret"):
        self.backend = (backend if isinstance(backend, (BackendModel,
                                                        CudaBackendModel))
                        else backend_model(backend))

    # -- the CPU family (the reference's terms) -------------------------

    def _scan_elem(self, live_elems: int) -> float:
        be = self.backend
        over = max(0.0, math.log2(max(1, live_elems) / be.cache_elems))
        return be.scan_elem_us * (1.0 + 0.25 * over)

    def rowscan_us(self, nq: int, n: int, m: int) -> float:
        be = self.backend
        return be.call_fixed_us + n * (
            be.row_step_fixed_us + self._scan_elem(nq * m) * nq * m)

    def wavefront_us(self, nq: int, n: int, m: int) -> float:
        be = self.backend
        steps = n + m - 1
        return be.call_fixed_us + steps * (
            be.wf_step_fixed_us + be.wf_elem_us * nq * n)

    def chunked_us(self, nq: int, n: int, m: int, chunk: int) -> float:
        be = self.backend
        n_chunks = -(-m // chunk)
        per_row = be.row_step_fixed_us \
            + self._scan_elem(nq * chunk) * nq * chunk
        return (be.call_fixed_us + n_chunks * be.chunk_fixed_us
                + n_chunks * n * per_row)

    def rank_impls(self, nq: int, n: int, m: int,
                   impls=("wavefront", "rowscan")) -> list:
        """Ranked ``[(impl, predicted_us), ...]``, cheapest first."""
        price = {"rowscan": self.rowscan_us, "wavefront": self.wavefront_us,
                 "chunked": lambda *s: self.chunked_us(
                     *s, self.best_chunk(*s))}
        scored = [(impl, price[impl](nq, n, m)) for impl in impls
                  if impl in price]
        scored.sort(key=lambda t: t[1])
        return scored

    def chunk_candidates(self, nq: int, n: int, m: int) -> list:
        """Ranked ``[(chunk, predicted_us), ...]`` for the chunked path."""
        cands = sorted({min(c, _pow2_bucket(m))
                        for c in self.CHUNK_CANDIDATES})
        scored = [(c, self.chunked_us(nq, n, m, c)) for c in cands]
        scored.sort(key=lambda t: t[1])
        return scored

    def best_chunk(self, nq: int, n: int, m: int) -> int:
        return self.chunk_candidates(nq, n, m)[0][0]

    def pallas_us(self, nq: int, n: int, m: int, block_q: int,
                  block_m: int, scan_scheme: str, row_tile: int,
                  span: bool = False) -> float:
        """The reference's interpret-mode Pallas kernel, priced as the
        reference prices it (``inf`` past the VMEM budget). The port runs
        no such kernel; ``validate`` uses this term to hold the CPU family
        against the reference's committed baseline rows, which time it."""
        be = self.backend
        words = (block_q * (6 * block_m + 5 * n) if span
                 else block_q * (3 * block_m + 3 * n))
        if words > be.vmem_budget_words:
            return float("inf")
        q_tiles = -(-nq // block_q)
        m_tiles = -(-max(m, block_m) // block_m)
        tiles = q_tiles * m_tiles
        cells = (q_tiles * block_q) * n * (m_tiles * block_m)
        passes = math.log2(max(2, block_q * block_m))
        elem = be.pallas_elem_us + be.pallas_pass_us * passes \
            * be.scheme_cost_mult(scan_scheme)
        hbm_bytes = 4 * (q_tiles * m + m_tiles * block_q * n)
        hbm_us = kernel_roofline(0, hbm_bytes, cells_per_s=1.0,
                                 hbm_bw=be.hbm_bw_bytes_per_s)[0] * 1e6
        rt_mult = 1.0 + 0.02 * max(0, 8 // max(1, row_tile) - 1)
        return (be.call_fixed_us + tiles * be.tile_fixed_us
                + tiles * n * be.pallas_row_fixed_us * rt_mult
                + cells * elem + hbm_us)

    # -- the card (one CUDA kernel launch) ------------------------------

    def cuda_us(self, kernel: str, nq: int, n: int, m: int, rows: int,
                warps: int, block_q: int, variant: str = "plain",
                ban: bool = False) -> float:
        """One launch of ``kernel`` over (nq, n) queries and m columns:
        R = ``rows`` cells a lane, ``warps`` warps a query, ``block_q``
        queries a block, K1/K2/K3 by ``variant``. ``ban`` is accepted for
        the wrappers' signature; the fitted runs put the ban's cost within
        the model's error (PERF.md §6), so it is not priced."""
        be = self.backend
        t = be.terms(kernel)
        blocks = -(-max(1, nq) // block_q)
        # Warps on the busiest SM; below sat_warps the step's latency, not
        # the issue rate, sets the pace.
        w_sm = -(-blocks // be.sms) * block_q * warps
        fill = n if kernel == "wavefront" else t.fill_steps * warps
        issue = (m + fill) * (rows * t.cell(variant) + t.step_instr) \
            * max(w_sm, t.sat_warps)
        hbm = 4 * (nq * n + m + 2 * 2 * nq * n
                   + (2 * nq * m if variant == "lastrow" else 0))
        s, _ = kernel_roofline(issue, hbm, cells_per_s=be.issue_per_sm,
                               hbm_bw=be.hbm_bw_bytes_per_s)
        return s * 1e6

    def cuda_candidates(self, nq: int, n: int, m: int,
                        variant: str = "plain", ban: bool = False) -> list:
        """Ranked ``[(config, predicted_us), ...]`` over the launches the
        CUDA wrappers take for a (nq, n) batch against m columns; each
        config a dict of ``kernel``, ``rows``, ``warps``, ``block_q``,
        ``block_m``. The wrapper's ``tune='off'`` policy is always a
        candidate, and wins ties."""
        from repro_torch.kernels.sdtw import ops
        sms = self.backend.sms
        configs = [self.cuda_policy(nq, n, m, variant)]
        for kernel in ops.KERNELS:
            for rows in self._rows_for(kernel, n):
                for bq in self.BLOCK_Q_CANDIDATES:
                    if bq > max(1, nq):
                        continue
                    try:
                        cfg = ops.launch_config(
                            nq, n, m, sms=sms, kernel=kernel, rows=rows,
                            block_q=bq, span=variant != "plain")
                    except ValueError:
                        continue
                    if cfg not in configs:
                        configs.append(cfg)
        scored = [(c, self.cuda_us(c["kernel"], nq, n, m, c["rows"],
                                   c["warps"], c["block_q"], variant, ban))
                  for c in configs]
        # A stable sort: the policy (first) wins ties.
        scored.sort(key=lambda t: t[1])
        return scored

    def cuda_policy(self, nq: int, n: int, m: int,
                    variant: str = "plain") -> dict:
        """The hand-set (``tune='off'``) launch on this backend's card."""
        from repro_torch.kernels.sdtw import ops
        return ops.launch_config(nq, n, m, sms=self.backend.sms,
                                 span=variant != "plain")

    @staticmethod
    def _rows_for(kernel: str, n: int):
        """R values worth a launch at N: the rows kernel's two smallest
        that cover N, each chain R whose warps fit a block, and the
        wavefront's own (None: its threads a query decide)."""
        from repro_torch.kernels.sdtw import ops
        if kernel == "rows":
            return [r for r in ops.ROWS_PER_LANE if 32 * r >= n][:2]
        if kernel == "chain":
            return [r for r in ops.CHAIN_ROWS
                    if -(-n // (32 * r)) <= ops.CHAIN_MAX_WARPS]
        return [None]


def tuned_n_micro(nq: int, n_dp: int, n_mp: int) -> int:
    """Pipeline-fill microbatch count: as many microbatches per dp row as
    the systolic depth can overlap (``n_mp``) without any slot being pure
    padding — the fill/drain bubble is ``(n_mp - 1) / (n_micro + n_mp -
    1)`` of the schedule, so more (real) microbatches amortize it. Mirrors
    ``distributed.sdtw_sharded.make_schedule``'s default so the engine
    can report (and the table can override) the choice explicitly."""
    return max(1, min(n_mp, -(-max(1, nq) // n_dp)))


_MODELS: dict = {}


def get_cost_model(backend: str) -> KernelCostModel:
    """Process-cached ``KernelCostModel`` per backend name."""
    if backend not in _MODELS:
        _MODELS[backend] = KernelCostModel(backend)
    return _MODELS[backend]
