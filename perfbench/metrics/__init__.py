"""Per-layer metrics, one reader module each, found by the metric's name
in BENCHMARK.json. A module's ``read(run)`` takes the traced run (a
``harness.Run``: its calls, cells, launch counts and ``trace``, the
``profiling.Trace`` or None) and returns the metric's value, or None
when it finds nothing to read; ``UNIT`` is its unit."""
