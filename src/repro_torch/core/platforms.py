"""Baseline platform models (CPU / GPU / FPGA / PNM) for Table VI, and the
cost constants of the port's execution backends.

The first half is a copy of ``repro.core.platforms``: the paper's
baselines as analytic (cells/s, watts) models (``PlatformModel``,
``PLATFORMS``, ``PAPER_TABLE6``), anchored to the paper's §II-D
characterization and public specs (derivation trail in the reference's
module docstring). They are independent of the MATSA model, so Table VI
ratios are a genuine cross-check of ``pum_model``.

The second half prices this repo's own execution backends for the
autotuner (``repro_torch.tune.cost``):

  * ``INTERPRET_BACKEND`` (``BackendModel``) — the reference's XLA-CPU
    constants, kept unchanged as the port's CPU family so that CPU routes
    (row scan vs wavefront, chunk size) decide exactly as the JAX package
    does. The CPU is the test path, not a performance target: these are
    fits of the reference's interpret-mode runs, not of PyTorch on a CPU.
  * ``H100_BACKEND`` (``CudaBackendModel``) — the three hand-written CUDA
    kernels on an NVIDIA H100, with terms fitted from H100 runs (see the
    constant's comment). The reference's TPU family has no counterpart
    here: its constants are TPU v5e numbers.
"""
from __future__ import annotations

import dataclasses

from .pum_model import Workload


@dataclasses.dataclass(frozen=True)
class PlatformModel:
    name: str
    cells_per_s: float        # sustained sDTW DP-cell throughput
    watts: float              # average package power during the kernel
    peak_gintops: float       # platform peak (for roofline reporting)
    ai_intop_per_byte: float  # measured arithmetic intensity (paper §II-D)
    note: str = ""

    def exec_time_s(self, w: Workload) -> float:
        return w.num_queries * w.query_size * w.ref_size / self.cells_per_s

    def energy_j(self, w: Workload) -> float:
        return self.exec_time_s(w) * self.watts

    def energy_per_cell_j(self) -> float:
        return self.watts / self.cells_per_s

    def utilization(self, ops_per_cell: float = 8.0) -> float:
        return self.cells_per_s * ops_per_cell / (self.peak_gintops * 1e9)


@dataclasses.dataclass(frozen=True)
class BackendModel:
    """Per-term execution-cost constants (microseconds per event) of the
    in-core and chunked schedules on one backend — the reference's
    ``BackendModel`` field for field. The pallas terms (``tile_fixed_us``
    … ``vmem_budget_words``) are carried with the copy; the port prices
    no interpret-mode kernel with them (its CPU kernel route is the
    plain PyTorch version, which has no block knobs)."""
    name: str
    call_fixed_us: float         # per-dispatch overhead of one call
    row_step_fixed_us: float     # per sequential DP row step (rowscan)
    scan_elem_us: float          # per accumulator element per row scan
    wf_step_fixed_us: float      # per anti-diagonal step (wavefront)
    wf_elem_us: float            # per (query-row) element per wavefront step
    chunk_fixed_us: float        # per reference tile (chunked streaming)
    cache_elems: int             # live-row working-set knee (elements)
    tile_fixed_us: float
    pallas_row_fixed_us: float
    pallas_elem_us: float
    pallas_pass_us: float
    scheme_mult: tuple
    hbm_bw_bytes_per_s: float
    vmem_budget_words: int

    def scheme_cost_mult(self, scheme: str) -> float:
        return dict(self.scheme_mult)[scheme]


#: XLA-CPU fits of the reference (``repro.core.platforms
#: .INTERPRET_BACKEND``), kept so that CPU routes decide as the JAX package
#: does: rowscan ~0.027 us/elem/row + ~60 us/row-step; wavefront
#: ~0.004 us/elem/step + ~0.4 us/step.
INTERPRET_BACKEND = BackendModel(
    name="interpret", call_fixed_us=500.0, row_step_fixed_us=60.0,
    scan_elem_us=0.027, wf_step_fixed_us=0.4, wf_elem_us=0.004,
    chunk_fixed_us=200.0, cache_elems=1 << 17, tile_fixed_us=150.0,
    pallas_row_fixed_us=30.0, pallas_elem_us=0.01, pallas_pass_us=0.013,
    scheme_mult=(("assoc", 1.0), ("shift", 1.6)),
    hbm_bw_bytes_per_s=20e9, vmem_budget_words=1 << 21)


@dataclasses.dataclass(frozen=True)
class CudaKernelTerms:
    """One CUDA sDTW kernel's cost terms. A warp sweeps the reference one
    column a step, ``rows`` cells a lane; a step issues ``rows ·
    cell_instr[variant] + step_instr`` warp-instructions. ``sat_warps``
    is how many warps an SM must hold to hide the step's latency (below
    it the SM runs as if it held that many); ``fill_steps`` the steps a
    warp spends outside the reference (the skew of its 32 lanes; the
    chain kernel's warps start one after another). A launch's fixed cost
    is below what the fitted runs resolve (a fit with one leaves the
    error and the ranking unchanged), so it has no term."""
    cell_instr: tuple            # (('plain', x), ('span', y), ('lastrow', z))
    step_instr: float
    sat_warps: float
    fill_steps: float

    def cell(self, variant: str) -> float:
        return dict(self.cell_instr)[variant]


@dataclasses.dataclass(frozen=True)
class CudaBackendModel:
    """Cost constants of the hand-written CUDA kernels on one card."""
    name: str
    sms: int                     # streaming multiprocessors
    issue_per_sm: float          # int32 warp-instructions a second an SM
    hbm_bw_bytes_per_s: float    # device memory rate
    kernels: tuple               # (('rows', CudaKernelTerms), ...)

    def terms(self, kernel: str) -> CudaKernelTerms:
        return dict(self.kernels)[kernel]


#: NVIDIA H100 80GB HBM3 at its 700 W power limit. ``sms`` is the card's
#: count, ``issue_per_sm`` its 64 int32 lanes an SM (2 warp-instructions
#: a clock) at the 1,980 MHz SM clock that ``nvidia-smi`` reads there, and
#: the memory rate the published 3.35 TB/s. The per-kernel terms are a
#: least-squares fit (``python -m repro_torch.tune.validate --fit``) of
#: the kernel times in ``repro_torch/tune/tables/h100_rows.json``,
#: recorded on that card by ``python -m repro_torch.tune.tuner --backend
#: h100``; the fill steps are the kernels' own (31 for the lanes' skew,
#: and 32 a warp down the chain kernel's ring).
H100_BACKEND = CudaBackendModel(
    name="h100", sms=132, issue_per_sm=2 * 1.98e9,
    hbm_bw_bytes_per_s=3.35e12,
    kernels=(
        ("rows", CudaKernelTerms(
            cell_instr=(("plain", 4.802), ("span", 13.607),
                        ("lastrow", 13.808)),
            step_instr=22.795, sat_warps=7.5, fill_steps=31.0)),
        ("chain", CudaKernelTerms(
            cell_instr=(("plain", 4.379), ("span", 11.997),
                        ("lastrow", 12.663)),
            step_instr=33.413, sat_warps=9.5, fill_steps=32.0)),
        ("wavefront", CudaKernelTerms(
            cell_instr=(("plain", 13.886), ("span", 28.230),
                        ("lastrow", 30.690)),
            step_instr=68.866, sat_warps=37.5, fill_steps=0.0)),
    ))

BACKENDS = {b.name: b for b in (INTERPRET_BACKEND, H100_BACKEND)}


def backend_model(name: str):
    """The cost-constant set for a tuning backend: ``'h100'`` for the
    CUDA kernels, ``'interpret'`` (also every other name) for the CPU."""
    return BACKENDS.get(name, INTERPRET_BACKEND)


CPU_ARM = PlatformModel(
    "cpuarm", cells_per_s=0.133e9, watts=24.8, peak_gintops=40.0,
    ai_intop_per_byte=0.55,
    note="4-core ARM @2.5GHz, LPDDR4; ZSim+Ramulator+McPAT in the paper")
CPU_I7 = PlatformModel(
    "cpui7", cells_per_s=3.09e9, watts=134.0, peak_gintops=614.0,
    ai_intop_per_byte=0.55,
    note="6C/12T i7 @3.2GHz AVX2, DDR4; RAPL-measured in the paper")
CPU_XEON = PlatformModel(
    "cpuxeon", cells_per_s=16.7e9, watts=769.0, peak_gintops=6900.0,
    ai_intop_per_byte=0.55,
    note="2×18C Xeon Gold 6154 AVX-512, 768GB DDR4; memory-bound (§II-D)")
GPU = PlatformModel(
    "gpu", cells_per_s=19.9e9, watts=342.0, peak_gintops=15700.0,
    ai_intop_per_byte=0.55,
    note="V100 32GB HBM; §II-D measures ~1% of peak INT throughput")
FPGA = PlatformModel(
    "fpga", cells_per_s=0.49e9, watts=49.0, peak_gintops=600.0,
    ai_intop_per_byte=0.55,
    note="Alveo U50, 8 HLS compute units, <7% of peak (§II-D)")
UPMEM = PlatformModel(
    "upmem", cells_per_s=19.4e9, watts=210.0, peak_gintops=146.0,
    ai_intop_per_byte=3.0,
    note="2560 DPUs @425MHz; compute-bound (§II-D); energy = 0.63× GPU")

PLATFORMS = {p.name: p for p in
             (CPU_ARM, CPU_I7, CPU_XEON, GPU, FPGA, UPMEM)}

# Paper Table VI — the claims the simulator is validated against.
PAPER_TABLE6 = {
    ("matsa-embedded", "cpuarm"): (30.20, 45.67),
    ("matsa-portable", "cpui7"): (10.41, 10.65),
    ("matsa-portable", "fpga"): (65.01, 24.58),
    ("matsa-hpc", "cpuxeon"): (7.35, 11.29),
    ("matsa-hpc", "upmem"): (6.31, 2.65),
    ("matsa-hpc", "gpu"): (6.15, 4.21),
}
