"""MATSA analytic performance/energy model (the paper's in-house simulator).

A copy of ``repro.core.pum_model`` (pure Python), kept in the port so that
``repro_torch`` imports nothing of the JAX package.

The paper evaluates MATSA with an in-house simulator that takes (workload
characteristics, MRAM device characteristics) and returns execution time and
energy (§IV-A, Fig. 8). This module reproduces that model from the
architecture description in §III.

Cost derivation (per DP cell, W-bit operands, abs_diff metric)
--------------------------------------------------------------
MATSA computes each cell with the §III-E step sequence, built from the §III-C
PUM operations. Bit-serial add/sub takes "two memory cycles per bit, divided
into four half cycles": [read+sum, write sum, read+carry, write carry] →
2 reads + 2 writes per bit. Column-lock-step control means every column takes
the *worst-case* path of data-dependent ops (e.g. abs always pays the
invert+increment).

  step                      reads            writes
  1a. subtract (dist)       2W               2W
  1b. absolute value        1 + W + 2W       W + 2W      (sign, invert, +1)
  2.  min3 = 2×(sub+select) 2(2W + W)        2(2W + W)
  3.  add (d + min)         2W               2W
  4-5. 2× diagonal copy     2W               2W          (RSA reg transfer/bit)
  6.  vertical copy         W                W           (paired half cycles)
  7.  query diagonal copy   W                W

  total (W=32):             reads = 545      writes = 544

``square_diff`` replaces 1a-1b by a bit-serial multiply (W shifted adds):
reads += 2W² - (3W+1+ ...), modelled as mult = 2W² reads + 2W² writes.

Schedule model (§III-D/E)
-------------------------
With C compute columns and reference length M: replication factor
R = max(1, C // M) (reference replicated to process R queries concurrently);
if M > C the reference is processed in ceil(M/C) sequential column-batches.
The wavefront computes one cell per column per macro-step; with query
pipelining (Fig. 7b) a replica group retires one query every N macro-steps
after a single M-step fill:

  macro_steps = ceil(n_q * N * M / C) + min(M, C) - 1     (work-conserving)
  t_cell      = reads * t_rd + writes * t_wr
  exec_time   = macro_steps * t_cell
  energy      = n_q * N * M * e_cell

The schedule is *work-conserving*: queries are re-packed into idle columns
both across replicas (C // M granularity) and across reference column-batches
(M > C). The paper's Fig. 13 shows "almost-ideal scaling" with column count
(Key Observation 6), which is only achievable work-conservingly; a
ceil-granular variant is kept for comparison (``work_conserving=False``) and
costs ~10% at the paper's dataset shapes — see EXPERIMENTS.md §Paper-validation.

Energy interpretation: Table III read/write energies are charged per
word-line activation (a bit-step activates rows shared across all columns;
2 activations per bit-step, W bit-steps per word op → 2·bits/W word-level
activations per cell ≈ 34r + 34w). This interpretation reproduces the
paper's Table VI energy ratios to within 1% and its Fig. 10 read/write split
(42/58 model vs 45/55 paper); charging per-bit instead would make MATSA
*lose* to the GPU on energy, contradicting every energy claim in the paper —
the full hypothesis trail is in EXPERIMENTS.md.

Latency/energy parameters default to the paper's bold operating point
(Table III: rd 5ns / wr 10ns, rd 50pJ / wr 70pJ).

Calibration note (recorded in EXPERIMENTS.md): the paper's Fig. 9 endpoint
ratios (4.7× / 6.5× for 10× read / write latency) imply an effective
read:write *count* ratio of ≈0.7:1, while Fig. 10's 45/55 energy split
implies ≈1.15:1 at the 50/70pJ point. A single linear model cannot satisfy
both; our first-principles counts (545:544 ≈ 1:1) sit between them, and we
report both presets.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MramParams:
    """MRAM device operating point (Table III)."""
    read_ns: float = 5.0
    write_ns: float = 10.0
    read_pj: float = 50.0
    write_pj: float = 70.0


# Table III sweep values.
SWEEP = dict(
    read_ns=(1, 3, 5, 10, 20),
    write_ns=(1, 3, 5, 10, 20),
    read_pj=(20, 50, 100),
    write_pj=(30, 70, 400),
    num_crossbars=(128, 256, 512, 1024, 2048, 4096),
)

CROSSBAR_DIM = 256  # 256x256 cells (Table III)


@dataclasses.dataclass(frozen=True)
class OpCounts:
    reads: int
    writes: int

    @staticmethod
    def derive(width: int = 32, metric: str = "abs_diff",
               preset: str = "first_principles") -> "OpCounts":
        w = width
        if metric == "abs_diff":
            dist_r, dist_w = 2 * w + (1 + w + 2 * w), 2 * w + (w + 2 * w)
        elif metric == "square_diff":
            dist_r, dist_w = 2 * w * w, 2 * w * w  # bit-serial multiply
        else:
            raise ValueError(metric)
        min3_r = min3_w = 2 * (2 * w + w)
        add_r = add_w = 2 * w
        copy_r = copy_w = 2 * w + w + w  # 2 diag + 1 vertical + query diag
        r = dist_r + min3_r + add_r + copy_r
        wr = dist_w + min3_w + add_w + copy_w
        if preset == "first_principles":
            return OpCounts(r, wr)
        if preset == "fig9_calibrated":
            # Fig. 9 endpoint ratios imply reads:writes ≈ 0.7:1.
            return OpCounts(int(round(0.7 * wr)), wr)
        raise ValueError(preset)


@dataclasses.dataclass(frozen=True)
class MatsaVersion:
    """One of the paper's three system versions (§III-F / §IV-A)."""
    name: str
    compute_crossbars: int
    memory_crossbars: int

    @property
    def compute_columns(self) -> int:
        return self.compute_crossbars * CROSSBAR_DIM


MATSA_EMBEDDED = MatsaVersion("matsa-embedded", 128, 896)      # 32K columns
MATSA_PORTABLE = MatsaVersion("matsa-portable", 1024, 7168)    # 256K columns
MATSA_HPC = MatsaVersion("matsa-hpc", 4096, 28672)             # 1M columns
VERSIONS = {v.name: v for v in (MATSA_EMBEDDED, MATSA_PORTABLE, MATSA_HPC)}


@dataclasses.dataclass(frozen=True)
class Workload:
    ref_size: int
    query_size: int
    num_queries: int
    metric: str = "abs_diff"
    width: int = 32


@dataclasses.dataclass(frozen=True)
class SimResult:
    exec_time_s: float
    energy_j: float
    macro_steps: int
    cells: int
    read_time_frac: float
    read_energy_frac: float
    throughput_cells_per_s: float


def simulate(workload: Workload,
             columns: int,
             params: MramParams = MramParams(),
             counts: OpCounts | None = None,
             work_conserving: bool = True) -> SimResult:
    """Analytic MATSA simulation: (workload, device) → (time, energy)."""
    if counts is None:
        counts = OpCounts.derive(workload.width, workload.metric)
    n, m, nq = workload.query_size, workload.ref_size, workload.num_queries
    c = columns
    w = workload.width

    t_cell = (counts.reads * params.read_ns + counts.writes * params.write_ns) * 1e-9
    # Per-word-line-activation energy: 2 activations/bit-step, W steps/word.
    e_cell = (2.0 * counts.reads / w * params.read_pj
              + 2.0 * counts.writes / w * params.write_pj) * 1e-12

    cells = nq * n * m
    if work_conserving:
        macro_steps = math.ceil(cells / c) + min(m, c) - 1
    else:
        replication = max(1, c // m)
        col_batches = math.ceil(m / c)
        macro_steps = (math.ceil(nq / replication) * n * col_batches
                       + min(m, c) - 1)

    exec_time = macro_steps * t_cell
    energy = cells * e_cell

    rd_t = counts.reads * params.read_ns
    wr_t = counts.writes * params.write_ns
    rd_e = counts.reads * params.read_pj
    wr_e = counts.writes * params.write_pj
    return SimResult(
        exec_time_s=exec_time,
        energy_j=energy,
        macro_steps=macro_steps,
        cells=cells,
        read_time_frac=rd_t / (rd_t + wr_t),
        read_energy_frac=rd_e / (rd_e + wr_e),
        throughput_cells_per_s=cells / exec_time if exec_time else float("inf"),
    )


def endurance_writes_per_cell(params: MramParams = MramParams(),
                              years: float = 10.0,
                              counts: OpCounts | None = None) -> float:
    """§IV-B endurance estimate: writes per cell over `years` of 24/7 use.

    A cell in the working set is written once per per-bit write phase of the
    ops that touch its column slice; the paper estimates ≈4e9 writes over ten
    years for 5/10ns cells. We model: each macro-step writes `writes` bits
    spread over the ~160-cell working slice of a column (4 vectors × 32b +
    aux), i.e. writes/macro-step/cell ≈ counts.writes / 160.
    """
    if counts is None:
        counts = OpCounts.derive()
    t_cell = (counts.reads * params.read_ns + counts.writes * params.write_ns) * 1e-9
    steps = years * 365.25 * 24 * 3600 / t_cell
    return steps * counts.writes / 160.0
