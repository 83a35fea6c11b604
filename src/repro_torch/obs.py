"""Spans the port records for a profiler, at the places where a call's
work happens, and only while a profiler records.

``span(name)`` is a context manager. While a profiler records on the
calling thread, it enters ``torch.profiler.record_function(
"repro_torch.<name>")``: under ``torch.profiler.profile`` the span lands
on the profiler's clock beside the device's events, and under
``torch.autograd.profiler.emit_nvtx()`` it becomes an NVTX range for
``nsys``. Otherwise it returns one shared context that does nothing:
one check, no new object, no timestamp. There is no switch, exporter or
clock of its own. ``spanned(name)`` puts a whole function under a span.

The spans, and the call sites they sit at:

  * ``matsa``: ``core.matsa_api.matsa``, the front door, whole;
  * ``stage``: ``device.as_tensor`` when it moves data from the host or
    another device onto the target device;
  * ``sdtw``: ``kernels.sdtw.ops.sdtw_cuda``, one kernel call's host
    work, whole;
  * ``profile.batch``: one iteration of ``search.profile.matrix_profile``'s
    batch loop.
"""
from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "repro_torch."
#: Whether a profiler records on this thread (``torch.profiler.profile``
#: or ``emit_nvtx``): the one check a span costs when none does.
recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """The span ``repro_torch.<name>`` while a profiler records, else a
    shared context that does nothing."""
    if not recording():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorate a function so that each call runs under ``span(name)``."""
    def wrap(fn):
        label = PREFIX + name

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return inner
    return wrap
