"""The program's own spans in a traced run, for the readers of the
metrics that read them: ``repro_torch.<name>`` ranges that
``repro_torch.obs`` records through ``record_function`` while the
profiler runs, which ``profiling.read`` keeps among the host events."""


def intervals(run, name):
    """The union of the spans called ``name`` in the run's trace, clipped
    to the window, as sorted [start, end] pairs in ns (a span inside
    another counts once; spans that only touch stay apart). None without
    a trace or without such a span in the window."""
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.window
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e, n in tr.host
                       if n == name and e > lo and s < hi):
        if merged and s < merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged or None
