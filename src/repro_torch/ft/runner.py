"""Fault-tolerant training runner in PyTorch (the JAX package's
``ft/runner.py``): checkpoint/restart, failure injection, straggler
watchdog, deterministic resume.

The runner treats a training step as a transaction: on any step failure
(device loss, preemption — simulated via an injectable ``FailureInjector``)
it restores the newest complete checkpoint and replays from there. Because
the data pipeline is a pure function of (seed, step) (data/pipeline.py),
and the train step's kernels are deterministic on one device, the
recovered run is bit-identical to an uninterrupted one — asserted by the
tests on the CPU and on the card. As in the reference, with no checkpoint
yet the run starts again at step 0 from the state it holds: the last
good one, since a step that fails before its update's first in-place
write leaves the state as it was. A failure after that write
(``optim.TornStateError``: the JAX package's jitted step cannot fail
half way) is never continued: the runner restores the newest
checkpoint, or, with none, raises.

Ranks that step one sharded state together (``group``) agree on every
step's outcome with one MAX all-reduce of three flags (failed, torn,
done): a step that failed on one rank fails on all. When every rank
failed before its first write the state is the last good one everywhere,
as above; when some rank tore its part, or finished the step while
another failed, the state is mixed and is treated as torn.

Straggler mitigation: per-step wall-times feed an EWMA; steps slower than
``straggler_factor``× the EWMA are logged and counted (on real fleets this
signal drives hot-spare promotion / data re-assignment; here it is exercised
by injecting artificial delays).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .. import checkpoint as ckpt
from ..device import as_tensor
from ..distributed.collectives import wire_device
from ..optim import TornStateError

log = logging.getLogger("repro_torch.ft")


class FailureInjector:
    """Deterministically raise at given steps (once each) — simulates
    preemption/node loss for the restart tests."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    ckpt_every: int = 10
    keep_last: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 10


class TrainingRunner:
    def __init__(self, train_step: Callable, data, state, ckpt_dir: str,
                 cfg: RunnerConfig = RunnerConfig(),
                 injector: Optional[FailureInjector] = None,
                 shard: int = 0, num_shards: int = 1,
                 delay_hook: Optional[Callable[[int], float]] = None,
                 group=None):
        self.train_step = train_step
        self.group = group
        self.data = data
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.cfg = cfg
        self.injector = injector
        self.shard, self.num_shards = shard, num_shards
        self.delay_hook = delay_hook
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []
        self.restarts = 0
        self._ewma = None

    # -- persistence ------------------------------------------------------
    def _save(self, step: int):
        ckpt.save(self.ckpt_dir, step, self.state,
                  extra={"step": step}, keep_last=self.cfg.keep_last)

    def _restore(self) -> int:
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return 0
        self.state, extra, _ = ckpt.restore(self.ckpt_dir, self.state)
        log.warning("restored checkpoint at step %d", step)
        return extra["step"] + 1 if "step" in extra else step + 1

    # -- watchdog ---------------------------------------------------------
    def _watch(self, step: int, dt: float):
        if self._ewma is None:
            self._ewma = dt
        if dt > self.cfg.straggler_factor * self._ewma and step > 2:
            self.straggler_steps.append(step)
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        step, dt, self._ewma)
        self._ewma = 0.9 * self._ewma + 0.1 * dt

    # -- one step ---------------------------------------------------------
    def _step(self, step: int):
        """Step ``step`` on this rank → (metrics, seconds); raises as every
        rank of ``group`` agrees."""
        error, metrics = None, None
        t0 = time.perf_counter()
        try:
            if self.delay_hook is not None:
                time.sleep(self.delay_hook(step))
            if self.injector is not None:
                self.injector.maybe_fail(step)
            batch = self.data.batch_at(step, self.shard, self.num_shards)
            dev = self.state["params"].device
            batch = {k: as_tensor(v, dev) for k, v in batch.items()}
            self.state, metrics = self.train_step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
        except RuntimeError as e:
            error = e
        dt = time.perf_counter() - t0
        if self.group is not None:
            error = self._agree(step, error)
        if error is not None:
            raise error
        return metrics, dt

    def _agree(self, step: int, error):
        """The step's outcome on every rank of ``group``: None when every
        rank finished it, else the error to raise here."""
        flags = torch.tensor(
            [error is not None, isinstance(error, TornStateError),
             error is None], dtype=torch.int32,
            device=wire_device(self.state["params"].device, self.group))
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self.group)
        failed, torn, done = flags.tolist()
        if not failed:
            return None
        if torn or done:
            mixed = TornStateError(
                f"step {step} failed on {'this' if error else 'another'} "
                f"rank after some rank wrote its part of the update: the "
                f"sharded train state is torn")
            mixed.__cause__ = error
            return mixed
        return error

    # -- main loop --------------------------------------------------------
    def run(self) -> dict:
        step = self._restore() if ckpt.latest_step(self.ckpt_dir) is not None \
            else 0
        while step < self.cfg.total_steps:
            try:
                metrics, dt = self._step(step)
                self._watch(step, dt)
                self.metrics_log.append({"step": step, **metrics})
                if (step + 1) % self.cfg.ckpt_every == 0:
                    self._save(step)
                step += 1
            except RuntimeError as e:
                self.restarts += 1
                log.warning("step %d failed (%s); restart %d", step, e,
                            self.restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                if isinstance(e, TornStateError) and \
                        ckpt.latest_step(self.ckpt_dir) is None:
                    raise RuntimeError(
                        f"step {step} failed half way through its update "
                        f"and there is no checkpoint to restore: the train "
                        f"state is torn, not continuing") from e
                step = self._restore()
        self._save(self.cfg.total_steps - 1)
        return {"state": self.state, "metrics": self.metrics_log,
                "restarts": self.restarts,
                "stragglers": self.straggler_steps}
