"""The benchmark's data, made from ``--seed`` on the device in a few large
calls (the program never sees the seed, only these tensors).

A series is a train of quasi-periodic cycles (heart beats for ECG, gait
cycles for Human activity): each cycle has its own length and gain, its
shape is a sum of Gaussian waves over the cycle's phase, a share of the
cycles take an anomalous shape, and white noise and a slow baseline
wander are added before rounding to int32. Queries are windows cut from
the series at seeded offsets, with their own noise, a baseline drift
across the window and, for a share of them, an artifact burst. Every
parameter comes from the configuration's file; the draws depend only on
the seed and the configuration, so every seed makes the same sizes.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named draw of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _waves(phase, waves):
    """Sum of Gaussian waves ``[center, width, amplitude]`` over phase."""
    out = torch.zeros_like(phase)
    for c, w, a in waves:
        out += a * torch.exp(-0.5 * ((phase - c) / w) ** 2)
    return out


def series(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's reference series: (ref_size,) int32 on
    ``device``."""
    sig = cfg["signal"]
    m = int(cfg["ref_size"])
    g = generator(seed, device, 1)
    period, jit = float(sig["period"]), float(sig["period_jitter"])
    n_cycles = int(m / (period * (1 - jit))) + 2
    u = torch.rand((n_cycles, 3), generator=g, device=device,
                   dtype=torch.float64)
    lengths = period * (1 + jit * (2 * u[:, 0] - 1))
    starts = torch.cumsum(lengths, 0) - lengths
    gain = 1 + float(sig["gain_jitter"]) * (2 * u[:, 1] - 1)
    odd = u[:, 2] < float(sig["anomaly_share"])
    t = torch.arange(m, device=device, dtype=torch.float64)
    k = torch.searchsorted(starts, t, right=True) - 1
    phase = (t - starts[k]) / lengths[k]
    shape = torch.where(odd[k], _waves(phase, sig["anomaly_waves"]),
                        _waves(phase, sig["waves"]))
    noise = torch.randn((m,), generator=g, device=device,
                        dtype=torch.float64)
    wander_phase = float(torch.rand((1,), generator=g, device=device)[0])
    wander = float(sig["wander"]) * torch.sin(
        2 * math.pi * (t / float(sig["wander_period"]) + wander_phase))
    x = gain[k] * shape + float(sig["noise"]) * noise + wander
    return torch.round(x).to(torch.int32)


def queries(cfg: dict, ref: torch.Tensor, seed: int,
            count=None) -> torch.Tensor:
    """``count`` (default ``num_queries``) queries of ``query_size`` cut
    from ``ref``: (count, query_size) int32 on ``ref``'s device."""
    qc = cfg["queries"]
    n = int(cfg["query_size"])
    q = int(cfg["num_queries"] if count is None else count)
    m = ref.shape[0]
    dev = ref.device
    g = generator(seed, dev, 2)
    offs = torch.randint(0, m - n + 1, (q,), generator=g, device=dev)
    col = torch.arange(n, device=dev)
    x = ref[offs[:, None] + col[None, :]].to(torch.float64)
    u = torch.rand((q, 4), generator=g, device=dev, dtype=torch.float64)
    ramp = col.to(torch.float64)[None, :] / max(1, n - 1)
    x += float(qc["drift"]) * (2 * u[:, :1] - 1) * ramp
    x += float(qc["noise"]) * torch.randn((q, n), generator=g, device=dev,
                                          dtype=torch.float64)
    width = float(qc["artifact_width"])
    at = u[:, 1:2] * (n - width)
    burst = (col[None, :] >= at) & (col[None, :] < at + width) \
        & (u[:, 2:3] < float(qc["artifact_share"]))
    x += burst * float(qc["artifact"]) * torch.randn(
        (q, n), generator=g, device=dev, dtype=torch.float64)
    return torch.round(x).to(torch.int32)
