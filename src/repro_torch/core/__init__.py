"""The port's core: the semiring, the sDTW schedules, the engine
(``sdtw``, ``align``, ``stream``), the alignment traceback, the top-K
heaps and the matrix profile's motif/discord reductions, and the
``matsa()`` front door (query filtering and self-join), and the
evaluation models (the MATSA simulator and the baseline platforms)."""
from .distances import METRICS, pointwise_distance
from .engine import align, choose_impl, sdtw, stream
from .matsa_api import (MatsaResult, load_real_workload_shapes, matsa,
                        synthetic_timeseries)
from .platforms import PAPER_TABLE6, PLATFORMS, PlatformModel
from .pum_model import (MATSA_EMBEDDED, MATSA_HPC, MATSA_PORTABLE, SWEEP,
                        VERSIONS, MramParams, OpCounts, SimResult, Workload,
                        endurance_writes_per_cell, simulate)
from .request import SdtwRequest, StreamRequest
from .sdtw import (sdtw_batch, sdtw_chunked, sdtw_rowscan, sdtw_wavefront,
                   self_join_exclusion, self_join_windows)
from .sdtw_ref import dtw_ref, sdtw_matrix, sdtw_ref
from .topk import (discord_select, mutual_nearest_pairs, topk_init,
                   topk_merge, topk_select)
from .traceback import AlignResult, check_path, path_cost, traceback_path

__all__ = [
    "sdtw", "align", "stream", "choose_impl", "sdtw_chunked",
    "SdtwRequest", "StreamRequest",
    "AlignResult", "traceback_path", "path_cost", "check_path",
    "METRICS", "pointwise_distance",
    "MatsaResult", "matsa", "load_real_workload_shapes",
    "synthetic_timeseries",
    "MramParams", "OpCounts", "Workload", "SimResult", "simulate",
    "endurance_writes_per_cell", "SWEEP", "VERSIONS",
    "MATSA_EMBEDDED", "MATSA_PORTABLE", "MATSA_HPC",
    "PLATFORMS", "PAPER_TABLE6", "PlatformModel",
    "sdtw_batch", "sdtw_rowscan", "sdtw_wavefront", "self_join_windows",
    "self_join_exclusion",
    "sdtw_ref", "sdtw_matrix", "dtw_ref",
    "topk_init", "topk_merge", "topk_select",
    "mutual_nearest_pairs", "discord_select",
]
