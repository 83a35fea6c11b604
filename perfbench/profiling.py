"""What the traced run reads from ``torch.profiler``: the device's busy
intervals, the benchmark's spans, the host's operations, and the
breakdown the result line carries."""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

#: Device activities that keep the card busy.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host activities that can say what the host was doing in an idle gap.
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: The benchmark's own spans (``record_function``).
WINDOW, CALL = "perfbench.window", "perfbench.call"
#: Characters kept of an operation's name in the breakdown.
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    """Intervals in ns on the profiler's clock."""
    window: tuple                 # (start, end) of the measured window
    calls: list                   # [(start, end)] of each call's span
    device: list                  # [(start, end, name, kind)]
    host: list                    # [(start, end, name)]
    _cache: tuple = dataclasses.field(default=None, repr=False)

    @property
    def kernels(self):
        return [d for d in self.device if d[3] == "kernel"]

    def busy(self, lo=None, hi=None):
        """Length of the union of device intervals inside [lo, hi)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        merged, starts = self._merged()
        # Intervals that end after lo and start before hi.
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        j = bisect.bisect_left(starts, hi)
        total = 0
        for s, e in merged[i:j]:
            total += max(0, min(e, hi) - max(s, lo))
        return total

    def _merged(self):
        """The union of the device intervals, sorted, and their starts."""
        if self._cache is None:
            merged = []
            for s, e, _, _ in sorted(self.device):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._cache = (merged, [m[0] for m in merged])
        return self._cache

    def gaps(self):
        """The idle intervals of the device inside the window."""
        lo, hi = self.window
        out, at = [], lo
        for s, e in self._merged()[0]:
            if e <= lo or s >= hi:
                continue
            if s > at:
                out.append((at, min(s, hi)))
            at = max(at, e)
        if at < hi:
            out.append((at, hi))
        return out


def _kind(ev) -> str:
    """The kineto activity type of an event, told from its device and
    name."""
    name = ev.name()
    on_card = "CUDA" in str(ev.device_type())
    if ev.is_user_annotation() or name in (WINDOW, CALL):
        return "gpu_user_annotation" if on_card else "user_annotation"
    if not on_card:
        return "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def read(prof) -> Trace | None:
    """The trace of a ``torch.profiler.profile`` that ran the window, or
    None when it holds no window span."""
    window, calls, device, host = None, [], [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if kind in DEVICE_KINDS:
            device.append((s, e, name, kind))
        elif kind == "user_annotation" and name == WINDOW:
            window = (s, e)
        elif kind == "user_annotation" and name == CALL:
            calls.append((s, e))
        elif kind in HOST_KINDS:
            host.append((s, e, name))
    if window is None:
        return None
    calls.sort()
    host.sort()
    return Trace(window=window, calls=calls, device=device, host=host)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time summed by what the host was doing (the innermost host operation
    over the gap's middle; ``python`` inside a call where none was
    recorded, ``between calls`` outside the calls), each in seconds."""
    ops = defaultdict(int)
    lo, hi = trace.window
    for s, e, name, _ in trace.device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            ops[name] += e - s
    idle = defaultdict(int)
    # Sweep the gaps' middles and the host events in time order with a
    # stack of the open events; nested events leave the innermost on top.
    stack, k, host = [], 0, trace.host
    call_starts = [c[0] for c in trace.calls]
    for g0, g1 in trace.gaps():
        mid = (g0 + g1) // 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        if stack:
            label = stack[-1][2]
        elif _inside(trace.calls, call_starts, mid):
            label = "python"
        else:
            label = "between calls"
        idle[label] += g1 - g0

    def top_of(d):
        return [[k[:NAME_CHARS], v / 1e9] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}


def _inside(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < spans[i][1]
