"""Query filtering: ``matsa(mode='query_filtering', anomaly_threshold=)``
calls, each with every query of the configuration (Table V's one batch),
against the configuration's series, which stays on the device; the
queries are handed over from the host on every call, as a filter's
callers hand them.

The check compares a sample of the answered queries drawn from the seed,
one from each run of neighbours (``reference.stratified``), as many as
the mix's ``reference_cells`` (the DP cells the reference may walk a
run) allow, and every query where that many cells hold them all."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import datagen, reference, yardstick

#: Distances and flags are exact in int32: any difference is a fault.
EXACT = 0


class Door:
    answer = "distance"

    def __init__(self, program, cfg, mix, seed, device):
        self.p = program
        self.dev = device
        self.metric = cfg["metric"]
        self.threshold = int(cfg["anomaly_threshold"])
        self.series = datagen.series(cfg, seed, device)
        self.queries = datagen.queries(cfg, self.series, seed).cpu().numpy()
        self.nq, self.n = self.queries.shape
        self.sample = min(self.nq, int(mix["reference_cells"])
                          // (self.n * self.series.shape[0]))
        self._memo = {}
        self._cells = yardstick.filter_cells(self.nq, self.n,
                                             self.series.shape[0])

    def warm_up(self):
        self.call(0)

    def call(self, i):
        res = self.p.matsa(self.series, self.queries,
                           mode="query_filtering", dist_metric=self.metric,
                           anomaly_threshold=self.threshold, device=self.dev)
        return (res.distances.cpu().numpy(),
                res.anomalies.cpu().numpy()), self._cells

    def check(self, records, seed, lanes=32):
        rng = np.random.default_rng([int(seed) % 2**64, 11])
        pick = reference.stratified(rng, np.arange(self.nq), self.sample)
        want = self._reference(pick, lanes)
        truth = self._reference(pick, 32)
        dist_bad = flag_bad = 0
        for d, flags in records:
            if lanes == 32:
                got_d, got_f = d[pick], flags[pick]
            else:   # the control in the program's place
                got_d = want
                got_f = got_d > self.threshold
            dist_bad += int(np.sum(got_d != truth))
            flag_bad += int(np.sum(got_f != (truth > self.threshold)))
        return {"distance_mismatches": (dist_bad, EXACT),
                "flag_mismatches": (flag_bad, EXACT)}

    def _reference(self, pick, lanes):
        """The reference distances of queries ``pick``, in blocks that
        fit; kept, so that the control's check walks the int32 DP once."""
        key = (pick.tobytes(), lanes)
        if key not in self._memo:
            block = max(1, (1 << 26) // self.series.shape[0])
            out = []
            for b0 in range(0, len(pick), block):
                q = torch.from_numpy(self.queries[pick[b0:b0 + block]]).to(
                    self.dev)
                out.append(reference.sdtw_scan(q, self.series,
                                               lanes=lanes)[0].cpu())
            self._memo[key] = torch.cat(out).numpy()
        return self._memo[key]


# Faults planted in the door's path, to see ``correct`` come out false:
# the CPU tests plant them at a tiny size, ``control.py --fault <name>``
# on the card at a cell's own size. Each takes ``patch(owner, name,
# value)``, a ``setattr`` the caller may undo.


def alter_distances(patch):
    """The filter's answer altered where it is made: one distance + 1."""
    from repro_torch.core import engine
    sdtw = engine.sdtw

    def altered(*a, **kw):
        out = sdtw(*a, **kw).clone()
        out[0] += 1
        return out
    patch(engine, "sdtw", altered)


def half_batch(patch):
    """Half of the filter's batch left out, its answers repeated in the
    other half's place."""
    from repro_torch.core import engine
    sdtw = engine.sdtw

    def half(queries, reference, qlens=None, **kw):
        h = (len(queries) + 1) // 2
        out = sdtw(queries[:h], reference,
                   None if qlens is None else qlens[:h], **kw)
        return torch.cat([out, out])[:len(queries)]
    patch(engine, "sdtw", half)


#: The faults this door's path can have.
FAULTS = (alter_distances, half_batch)


def make(program, cfg, mix, seed, device):
    return Door(program, cfg, mix, seed, device)
