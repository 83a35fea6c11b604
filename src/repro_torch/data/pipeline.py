"""Deterministic, shard-aware, resumable data pipeline (the JAX package's
``data/pipeline.py``; ``SyntheticLM`` is a copy, pure numpy).

Every batch is a pure function of (seed, step) — no iterator state to
checkpoint, so restart/elastic-resume just continues at the right step and
reproduces the exact stream (the fault-tolerance integration test relies on
this). Generation is numpy (host-side), mirroring a real ingestion pipeline
feeding device buffers.

Two sources:
  * SyntheticLM      — token/label batches (or embedding batches for the
                       stub-frontend archs).
  * TSAFilteredLM    — the paper's Fig. 2 flow: a synthetic sensor stream is
                       windowed, scored with sDTW against a reference motif
                       (repro_torch.core.matsa), and only anomalous windows —
                       the interesting ones — are quantised into tokens for
                       the model. TSA acts as the cheap filter in front of the
                       expensive model, exactly the deployment the paper
                       motivates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import matsa, synthetic_timeseries
from ..device import resolve_device, to_numpy


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 128
    global_batch: int = 8
    vocab: int = 256
    embeddings_dim: int = 0     # >0 → produce embedding batches (stub frontends)


class SyntheticLM:
    """Markov-ish synthetic token stream (stateless; batch = f(seed, step))."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b_local = cfg.global_batch // num_shards
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[0, 0, step, shard]))
        if cfg.embeddings_dim:
            emb = rng.normal(0, 1, (b_local, cfg.seq_len, cfg.embeddings_dim))
            labels = rng.integers(0, cfg.vocab, (b_local, cfg.seq_len))
            return {"embeddings": emb.astype(np.float32),
                    "labels": labels.astype(np.int32)}
        # structured stream: noisy sinusoid quantised to the vocab — gives
        # the model something learnable (examples show loss decreasing).
        t = np.arange(cfg.seq_len + 1)[None, :] + rng.integers(
            0, 10_000, (b_local, 1))
        wave = (np.sin(2 * np.pi * t / 17.0) + np.sin(2 * np.pi * t / 5.0))
        noise = rng.normal(0, 0.1, wave.shape)
        toks = np.clip(((wave + noise + 2.2) / 4.4 * (cfg.vocab - 1)), 0,
                       cfg.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TSAFilteredLM:
    """sDTW-filtered sensor stream → token batches (paper Fig. 2).

    Windows whose best-alignment distance against the reference motif exceeds
    the threshold (anomalies/discords) are kept for the model; normal windows
    are discarded before any expensive compute. The filter is the port's
    ``matsa`` on ``device`` (None: the CUDA device, where it runs the sDTW
    kernel; ``"cpu"``: the plain versions).
    """

    def __init__(self, cfg: DataConfig, anomaly_threshold: float = None,
                 window: Optional[int] = None, device=None):
        self.cfg = cfg
        self.window = window or cfg.seq_len
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        self.reference = synthetic_timeseries(rng, 4096, anomaly_rate=0.0,
                                              dtype=np.float32)
        self.threshold = anomaly_threshold
        self.filter_stats = {"seen": 0, "kept": 0}

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        cfg = self.cfg
        b_local = cfg.global_batch // num_shards
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed + 1, counter=[0, 0, step, shard]))
        keep = []
        # Oversample windows; sDTW-filter down to the anomalous ones.
        while len(keep) < b_local:
            n_cand = max(2 * b_local, 8)
            series = synthetic_timeseries(rng, n_cand * self.window,
                                          anomaly_rate=0.5, dtype=np.float32)
            wins = series[:n_cand * self.window].reshape(n_cand, self.window)
            res = matsa(self.reference, wins,
                        dist_metric="abs_diff", device=self.device)
            d = to_numpy(res.distances)
            thr = self.threshold if self.threshold is not None else \
                float(np.median(d))
            self.filter_stats["seen"] += n_cand
            for i in np.argsort(-d):
                if d[i] > thr and len(keep) < b_local:
                    keep.append(wins[i])
                    self.filter_stats["kept"] += 1
        x = np.stack(keep)                                 # (b, window)
        lo, hi = np.percentile(x, [1, 99])
        toks = np.clip((x - lo) / max(hi - lo, 1e-9), 0, 1)
        toks = (toks * (cfg.vocab - 1)).astype(np.int32)
        toks = toks[:, :cfg.seq_len + 1]
        if toks.shape[1] < cfg.seq_len + 1:
            reps = -(-(cfg.seq_len + 1) // toks.shape[1])
            toks = np.tile(toks, (1, reps))[:, :cfg.seq_len + 1]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
