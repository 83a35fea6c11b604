"""The self-join: ``matsa(mode='self_join', exclusion=True)`` over the
whole series, which routes through the matrix profile; each call returns
every window's nearest-neighbour distance and span on the host."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import datagen, reference, yardstick

#: Distances and spans are exact in int32: any difference is a fault.
EXACT = 0


class Door:
    answer = "span"

    def __init__(self, program, cfg, mix, seed, device):
        self.p = program
        self.dev = device
        self.metric = cfg["metric"]
        self.series = datagen.series(cfg, seed, device)
        self.window = int(mix["window"])
        self.stride = int(mix["stride"])
        self.zone = int(mix["exclusion_zone"])
        self.mix = mix
        m = self.series.shape[0]
        self.starts = np.arange(0, m - self.window + 1, self.stride)
        self._cells = yardstick.selfjoin_cells(len(self.starts), self.window,
                                               m)

    def _run(self, series):
        res = self.p.matsa(series, mode="self_join", window=self.window,
                           stride=self.stride, exclusion=True,
                           dist_metric=self.metric, device=self.dev)
        prof = res.profile
        return (np.array(prof.nn_dist), np.array(prof.nn_start),
                np.array(prof.nn_end))

    def warm_up(self):
        # A segment whose windows fill the same batch shapes as the series.
        w = int(self.mix["warm_windows"])
        self._run(self.series[:(w - 1) * self.stride + self.window])

    def call(self, i):
        return self._run(self.series), self._cells

    def check(self, records, seed, lanes=32):
        rng = np.random.default_rng([int(seed) % 2**64, 13])
        nw = len(self.starts)
        last = records[-1][0]
        top = np.argsort(-last.astype(np.int64), kind="stable")
        top = top[:int(self.mix["sample_discords"])]
        rest = np.setdiff1d(np.arange(nw), top)
        pick = np.union1d(top, reference.stratified(
            rng, rest, int(self.mix["sample"])))
        s = torch.as_tensor(self.starts[pick], device=self.dev)
        wins = self.series[s[:, None] + torch.arange(self.window,
                                                     device=self.dev)]
        lo = (s - self.zone).clamp(min=0)
        hi = s + self.window + self.zone
        d, e, st = (x.cpu().numpy() for x in reference.sdtw_scan(
            wins, self.series, ban_lo=lo, ban_hi=hi, spans=True))
        if lanes != 32:
            ctrl = reference.sdtw_scan(wins, self.series, ban_lo=lo,
                                       ban_hi=hi, lanes=lanes)
            cd, ce = (x.cpu().numpy() for x in ctrl[:2])
        dist_bad = span_bad = 0
        for nn_d, nn_s, nn_e in records:
            if lanes == 32:
                gd, gs, ge = nn_d[pick], nn_s[pick], nn_e[pick]
            else:   # the control in the program's place (no start lane)
                gd, gs, ge = cd, st, ce
            dist_bad += int(np.sum(gd != d))
            span_bad += int(np.sum((gs != st) | (ge != e)))
        return {"distance_mismatches": (dist_bad, EXACT),
                "span_mismatches": (span_bad, EXACT)}


# Faults planted in the door's path, to see ``correct`` come out false:
# the CPU tests plant them at a tiny size, ``control.py --fault <name>``
# on the card at a cell's own size. Each takes ``patch(owner, name,
# value)``, a ``setattr`` the caller may undo.


def alter_profile(patch):
    """The self-join's answer altered where it is made: one window's
    nearest-neighbour distance + 1."""
    from repro_torch.search import profile
    mp = profile.matrix_profile

    def altered(*a, **kw):
        res = mp(*a, **kw)
        res.nn_dist = res.nn_dist.copy()
        res.nn_dist[0] += 1
        return res
    patch(profile, "matrix_profile", altered)


def half_profile(patch):
    """Half of the self-join's windows left out, the first half's answers
    in their place."""
    from repro_torch.search import profile
    mp = profile.matrix_profile

    def half(*a, **kw):
        res = mp(*a, **kw)
        h = (len(res.nn_dist) + 1) // 2
        for f in ("nn_dist", "nn_start", "nn_end"):
            x = getattr(res, f).copy()
            x[h:] = x[:len(x) - h]
            setattr(res, f, x)
        return res
    patch(profile, "matrix_profile", half)


#: The faults this door's path can have.
FAULTS = (alter_profile, half_profile)


def make(program, cfg, mix, seed, device):
    return Door(program, cfg, mix, seed, device)
