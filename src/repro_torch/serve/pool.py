"""Device pool: coalesced groups multiplexed over an explicit device set.

Counterpart of ``repro.serve.pool``: one worker thread per device
binding, so that

  * groups drained from one window run **concurrently across devices**,
    and
  * the host-side work of a group — merging trimmed queries before the
    call, slicing the batched result back per client and resolving
    futures after it — runs on the worker threads, off the drain thread.

A worker bound to a CUDA device runs its groups under
``torch.cuda.device(dev)`` on a ``torch.cuda.Stream`` of its own (the
kernels launch on the current stream), so a request on the default
device (``device=None``) lands on the worker's card; it waits for its
stream before it delivers, so a client reading a result from any thread
or stream sees it complete. A ``'cpu'`` binding runs its groups as they
are (their requests name ``device='cpu'``).

Device selection (``devices=``):

  * ``None``  — one worker on the current device (no pinning; the
    default);
  * ``'all'`` — one worker pinned to each visible CUDA device;
  * ``int n`` — the first n CUDA devices;
  * an explicit sequence of devices (``torch.device`` or strings such as
    ``'cuda:0'`` or ``'cpu'``; duplicates allowed: two workers sharing one
    card overlap host slicing with the kernels).

``'all'`` and an int raise when no CUDA device is present, as
``resolve_device`` does: there is no CPU fallback.

Routing is **shape-affine** (``pick_device``): a group's first landing
on a device builds and tunes its launch shape there
(``batcher.group_shape``), so a process-global warm map remembers which
devices have run each shape and the pool prefers the least-loaded warm
one, growing onto a cold idle device only under a real backlog and one
cold landing at a time per shape (the reference's policy, unchanged).

Correctness: a group runs start-to-finish on one worker and the DP is
integer (int32), so pooled answers are bitwise identical to a
single-device drain (pinned by ``tests/test_torch_serve.py``).
"""
from __future__ import annotations

import collections
import contextlib
import queue as _stdqueue
import threading

import torch

from repro_torch.device import resolve_device

from . import batcher

__all__ = ["DevicePool", "clear_affinity_cache", "pick_device"]

# Built kernels and tuning decisions are process-global, so the warm map
# is too: a fresh pool over the same devices inherits every placement
# already run — a bounded LRU.
AFFINITY_CACHE_MAX = 1024
_affinity_lock = threading.Lock()
_warm_devices: "collections.OrderedDict" = collections.OrderedDict()
_growing: set = set()          # shapes with a cold landing in flight


def clear_affinity_cache():
    """Drop the process-global shape→devices warm map (tests)."""
    with _affinity_lock:
        _warm_devices.clear()
        _growing.clear()


def _mark_warm(shape, device):
    with _affinity_lock:
        _warm_devices.setdefault(shape, set()).add(device)
        _warm_devices.move_to_end(shape)
        while len(_warm_devices) > AFFINITY_CACHE_MAX:
            _warm_devices.popitem(last=False)


def resolve_devices(devices):
    """Normalize the ``devices=`` config into a list of worker bindings
    (``None`` = the current device, i.e. no pinning)."""
    if devices is None:
        return [None]
    if devices == "all" or isinstance(devices, int):
        resolve_device(None)            # raises without a CUDA device
        local = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        if devices == "all":
            return local
        if not 1 <= devices <= len(local):
            raise ValueError(
                f"devices={devices} but only {len(local)} local "
                f"device(s) are visible; pass 1..{len(local)}, 'all', "
                "or an explicit device sequence")
        return local[:devices]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices= must name at least one device "
                         "(or None for the process default)")
    return out


@contextlib.contextmanager
def pinned(dev, stream=None):
    """Run under a worker binding: a CUDA device made current, with
    ``stream`` (one of the worker's own) current on it; anything else
    as is."""
    if dev is None or dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


# A warm device must have this many groups in flight/queued before the
# pool pays a cold landing to spread the shape: load 1 is every burst's
# steady state (one group per window), load >= 2 is a real backlog.
GROW_LOAD = 2


def pick_device(loads, warm, growing=False):
    """Shape-affinity routing policy (pure; caller holds the lock).

    ``loads`` is the per-device in-flight group count; ``warm`` the set
    of device indices that have already run this group's shape;
    ``growing`` is True while a previous cold landing of this shape is
    still in flight.

      * never-seen shape            → globally least-loaded device;
      * least-loaded warm device is
        below ``GROW_LOAD``         → that device (free cache reuse);
      * warm backlogged, cold idle,
        and not already growing     → lowest cold idle index (grow the
                                      warm set under pressure — pay one
                                      cold landing to add parallelism);
      * otherwise                   → least-loaded warm device (queueing
                                      beats a cold build and tune).

    The ``growing`` gate caps cold landings at one in flight per shape,
    and ``GROW_LOAD`` demands a real backlog first, as in the
    reference: otherwise a slow first landing keeps its device busy and
    every next same-shape group "grows" onto yet another cold device.

    Ties break on the lowest index for determinism."""
    if warm:
        w = min(warm, key=lambda i: (loads[i], i))
        if loads[w] < GROW_LOAD or growing:
            return w
        for i, load in enumerate(loads):
            if load == 0 and i not in warm:
                return i
        return w
    return min(range(len(loads)), key=lambda i: (loads[i], i))


class DevicePool:
    """Per-device worker threads executing coalesced request groups."""

    def __init__(self, devices=None, *, name: str = "repro-torch-serve-dev"):
        self._devices = resolve_devices(devices)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0           # groups submitted, not yet finished
        self._loads = [0] * len(self._devices)
        self._queues = [_stdqueue.SimpleQueue() for _ in self._devices]
        self._closed = False
        self._threads = []
        for i, dev in enumerate(self._devices):
            t = threading.Thread(target=self._worker, args=(i, dev),
                                 name=f"{name}{i}", daemon=True)
            t.start()
            self._threads.append(t)

    @property
    def devices(self) -> list:
        return list(self._devices)

    @property
    def size(self) -> int:
        return len(self._devices)

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, group, telemetry=None):
        """Route one coalesced group to a worker (shape-affine, see
        ``pick_device``). Every member future is guaranteed an answer
        (``execute_group``'s contract); returns immediately."""
        with self._lock:
            if self._closed:
                raise RuntimeError("device pool is closed")
            shape = batcher.group_shape(group)
            with _affinity_lock:
                warm_devs = _warm_devices.setdefault(shape, set())
                _warm_devices.move_to_end(shape)
                while len(_warm_devices) > AFFINITY_CACHE_MAX:
                    _warm_devices.popitem(last=False)
                warm = {i for i, d in enumerate(self._devices)
                        if d in warm_devs}
                i = pick_device(self._loads, warm,
                                growing=shape in _growing)
                cold = i not in warm
                if cold:
                    _growing.add(shape)
                warm_devs.add(self._devices[i])
            self._loads[i] += 1
            self._inflight += 1
        self._queues[i].put((group, telemetry, shape if cold else None))

    def warmup(self, request) -> int:
        """Run ``request`` on every pool device (its kernels built, its
        launch tuned) and prime the affinity map, so that no client pays
        a shape's first landing. Runs sequentially and blocks until done.
        Returns the number of devices warmed."""
        with self._lock:
            if self._closed:
                raise RuntimeError("device pool is closed")
        p = batcher.Pending(request=request, future=None, trace=None)
        shape = batcher.group_shape([p])
        for dev in self._devices:
            with pinned(dev):
                request.run()
                batcher.wait_for_card(request)
            _mark_warm(shape, dev)
        return len(self._devices)

    def join(self):
        """Block until every submitted group has finished executing."""
        with self._idle:
            self._idle.wait_for(lambda: self._inflight == 0)

    def close(self, *, wait: bool = True):
        """Stop the workers (after finishing queued work when ``wait``)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for q in self._queues:
            q.put(None)
        if wait:
            for t in self._threads:
                t.join(timeout=10.0)

    # ------------------------------------------------------------------
    # workers
    # ------------------------------------------------------------------

    def _worker(self, i: int, dev):
        stream = (torch.cuda.Stream(device=dev)
                  if dev is not None and dev.type == "cuda" else None)
        while True:
            task = self._queues[i].get()
            if task is None:
                return
            group, telemetry, cold_shape = task
            try:
                with pinned(dev, stream):
                    batcher.execute_group(group, telemetry=telemetry)
            except Exception as exc:                     # noqa: BLE001
                # execute_group never raises by contract; this is a
                # last-ditch guard so a pool bug can never orphan
                # admitted futures.
                batcher.fail_group(group, exc, telemetry=telemetry)
            finally:
                if cold_shape is not None:
                    with _affinity_lock:
                        _growing.discard(cold_shape)
                with self._idle:
                    self._loads[i] -= 1
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.notify_all()

    def __enter__(self) -> "DevicePool":
        return self

    def __exit__(self, *exc):
        self.close()
