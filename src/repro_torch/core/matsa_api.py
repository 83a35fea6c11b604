"""MATSA host interface (paper Listing 1) in PyTorch.

Counterpart of ``repro.core.matsa_api``: arrays in,
``MatsaResult(distances, anomalies)`` out, in both of the paper's modes:
query filtering (Algorithm 1) and the self-join (every window of the
reference against the reference, with its trivial-match zone banned).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import as_tensor, resolve_device
from . import engine
from .sdtw import self_join_exclusion, self_join_windows

MODES = ("query_filtering", "self_join")


@dataclasses.dataclass
class MatsaResult:
    distances: torch.Tensor                 # (n_queries,) sDTW distance
    anomalies: Optional[torch.Tensor]       # (n_queries,) bool, if threshold
    window_starts: Optional[torch.Tensor] = None  # self_join only
    profile: Optional[object] = None              # self_join only


@obs.spanned("matsa")
def matsa(reference, queries=None, query_sizes=None, *,
          mode: str = "query_filtering", dist_metric: str = "abs_diff",
          anomaly_threshold=None, window: int = None, stride: int = 1,
          exclusion: bool = True, impl: str = "auto", chunk: int = None,
          mesh=None, device=None) -> MatsaResult:
    """Run TSA over a reference, per the paper's host API.

    query_filtering: ``queries`` (n_queries, max_len) padded array compared
    against ``reference``; ``query_sizes`` gives true lengths.
    self_join: sliding windows of size ``window`` (stride ``stride``) of the
    reference against the reference itself; ``exclusion`` bans the trivial
    self-match zone (window ± window/2, in samples).

    An ``anomaly_threshold`` marks queries whose best-alignment distance
    exceeds it (discords, §II-A). The distances come from
    ``repro_torch.core.engine.sdtw`` (``impl``, ``chunk`` and ``mesh``
    pass straight through); on the card that is the hand-written sDTW
    kernel, with the exclusion zones as its per-query column ban. With a
    ``mesh`` the call is SPMD: every rank of the mesh makes it with the
    same arguments and gets the whole result.
    ``device`` is where it runs (``None``: the CUDA device). Each call
    runs under the span ``repro_torch.matsa`` (``repro_torch.obs``).

    Self-join with ``exclusion=True``, ``impl='auto'`` and no ``mesh``
    routes through ``repro_torch.search.profile.matrix_profile`` (exact,
    ``prune=False``; on the card every window in one batch where a memory
    budget admits them all, else the fewest equal batches that fit it:
    ``profile_batch``); the distances are the direct route's bitwise, and
    ``MatsaResult.profile`` carries the whole matrix profile (spans, motif
    pairs, discords).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    window_starts = None
    if mode == "self_join":
        if window is None:
            raise ValueError("self_join mode requires window=")
        dev = resolve_device(device)
        if exclusion and impl == "auto" and mesh is None:
            from repro_torch.search.profile import matrix_profile
            prof = matrix_profile(reference, window, stride=stride,
                                  metric=dist_metric, chunk=chunk,
                                  prune=False, device=dev)
            distances = torch.from_numpy(prof.nn_dist).to(dev)
            return MatsaResult(
                distances=distances,
                anomalies=_anomalies(distances, anomaly_threshold),
                window_starts=torch.from_numpy(prof.starts).to(
                    dev, torch.int32),
                profile=prof)
        reference = as_tensor(reference, dev)
        queries, window_starts = self_join_windows(reference, window, stride)
        nq = queries.shape[0]
        qlens = torch.full((nq,), window, dtype=torch.int32, device=dev)
        if exclusion:
            excl_lo, excl_hi = self_join_exclusion(window_starts.cpu(),
                                                   window)
        else:
            excl_lo = excl_hi = torch.full((nq,), -1, dtype=torch.int32)
    else:
        if queries is None:
            raise ValueError("query_filtering mode requires queries=")
        dev = resolve_device(device)
        queries = as_tensor(queries, dev)
        if queries.ndim == 1:
            queries = queries[None, :]
        nq = queries.shape[0]
        qlens = (torch.full((nq,), queries.shape[1], dtype=torch.int32,
                            device=dev)
                 if query_sizes is None else as_tensor(query_sizes, dev,
                                                       torch.int32))
        excl_lo = excl_hi = None
    distances = engine.sdtw(queries, reference, qlens, metric=dist_metric,
                            impl=impl, chunk=chunk, mesh=mesh,
                            excl_lo=excl_lo, excl_hi=excl_hi, device=dev)
    return MatsaResult(distances=distances,
                       anomalies=_anomalies(distances, anomaly_threshold),
                       window_starts=window_starts)


def _anomalies(distances, threshold):
    """Distances above ``threshold`` (discords), or None without one."""
    if threshold is None:
        return None
    return distances > torch.as_tensor(
        threshold, device=distances.device).to(distances.dtype)


def load_real_workload_shapes():
    """Table V of the paper: the six real-world workload shapes."""
    return {
        "Human":      dict(ref_size=7_997,     query_size=120,  num_queries=131_072),
        "Song":       dict(ref_size=20_234,    query_size=200,  num_queries=65_536),
        "Penguin":    dict(ref_size=109_842,   query_size=800,  num_queries=32_768),
        "Seismology": dict(ref_size=1_727_990, query_size=64,   num_queries=16_384),
        "Power":      dict(ref_size=1_754_985, query_size=1536, num_queries=16_384),
        "ECG":        dict(ref_size=1_800_000, query_size=512,  num_queries=16_384),
    }


def synthetic_timeseries(rng: np.random.Generator, size: int,
                         anomaly_rate: float = 0.01, dtype=np.int32):
    """Synthetic sensor stream: smooth base signal + sparse anomalies
    (numpy, so both packages see the same data from one seed)."""
    t = np.arange(size)
    base = (1000 * np.sin(2 * np.pi * t / 97.0)
            + 400 * np.sin(2 * np.pi * t / 31.0)
            + rng.normal(0, 20, size))
    n_anom = max(1, int(size * anomaly_rate / 64))
    starts = rng.integers(0, max(1, size - 64), n_anom)
    for s in starts:
        base[s:s + 64] += rng.normal(0, 800, min(64, size - s))
    return base.astype(dtype)
