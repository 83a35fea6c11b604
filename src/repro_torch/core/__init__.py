"""The port's core: the semiring, the sDTW schedules, the engine
(``sdtw``, ``align``, ``stream``), the alignment traceback, the top-K
heaps and the matrix profile's motif/discord reductions, and the
``matsa()`` front door (query filtering and self-join)."""
from .distances import METRICS, pointwise_distance
from .engine import align, choose_impl, sdtw, stream
from .matsa_api import (MatsaResult, load_real_workload_shapes, matsa,
                        synthetic_timeseries)
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
    "sdtw_batch", "sdtw_rowscan", "sdtw_wavefront", "self_join_windows",
    "self_join_exclusion",
    "sdtw_ref", "sdtw_matrix", "dtw_ref",
    "topk_init", "topk_merge", "topk_select",
    "mutual_nearest_pairs", "discord_select",
]
