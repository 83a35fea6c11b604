"""The readers of the program's spans on hand-made traces: their values
on known intervals, spans clipped at the window's edges, spans inside
spans counted once, and None where the span is absent."""
import pytest

from perfbench import harness, profiling
from perfbench.metrics import (door_host_ms_per_call, launch_host_us,
                               stage_ms_per_call)

MS = 1_000_000   # ns
US = 1_000


def run_of(host, device=(), calls=((0, 100 * MS),), window=(0, 100 * MS)):
    """A traced run of ``len(calls)`` calls whose trace holds ``host``
    [(start, end, name)] and device intervals [(start, end)]."""
    trace = profiling.Trace(
        window=window, calls=sorted(calls),
        device=[(s, e, "kernel", "kernel") for s, e in device],
        host=sorted(host))
    return harness.Run(answer="distance", calls=len(calls), trace=trace)


def test_door_host_is_the_idle_inside_the_door_span():
    # Two calls; each door span 40 ms, the device busy 30 and 35 of it.
    run = run_of(
        host=[(5 * MS, 45 * MS, "repro_torch.matsa"),
              (50 * MS, 90 * MS, "repro_torch.matsa"),
              (46 * MS, 49 * MS, "aten::copy_")],
        device=[(10 * MS, 40 * MS), (52 * MS, 87 * MS), (45 * MS, 50 * MS)],
        calls=[(0, 49 * MS), (49 * MS, 100 * MS)])
    assert door_host_ms_per_call.read(run) == pytest.approx((10 + 5) / 2)


def test_stage_is_the_staging_time_a_call():
    run = run_of(
        host=[(1 * MS, 4 * MS, "repro_torch.stage"),
              (20 * MS, 22 * MS, "repro_torch.stage"),
              (0, 30 * MS, "repro_torch.matsa")],
        calls=[(0, 50 * MS), (50 * MS, 100 * MS)])
    assert stage_ms_per_call.read(run) == pytest.approx(5 / 2)


def test_launch_host_is_the_mean_sdtw_span():
    run = run_of(host=[(t * MS, t * MS + d * US, "repro_torch.sdtw")
                       for t, d in ((1, 20), (2, 30), (3, 40), (4, 50))])
    assert launch_host_us.read(run) == pytest.approx(35)


@pytest.mark.parametrize("reader,name,scale", [
    (stage_ms_per_call, "repro_torch.stage", MS),
    (launch_host_us, "repro_torch.sdtw", US),
    (door_host_ms_per_call, "repro_torch.matsa", MS)])
def test_spans_are_clipped_to_the_window(reader, name, scale):
    # Window [10, 90) ms: a span from 5 to 15 counts 5 ms, one from 85 to
    # 120 counts 5 ms, one wholly outside counts nothing.
    run = run_of(host=[(5 * MS, 15 * MS, name), (85 * MS, 120 * MS, name),
                       (95 * MS, 99 * MS, name)],
                 window=(10 * MS, 90 * MS), calls=[(10 * MS, 90 * MS)])
    want = {stage_ms_per_call: 10, door_host_ms_per_call: 10,
            launch_host_us: 5}[reader]
    assert reader.read(run) * scale / MS == pytest.approx(want)


@pytest.mark.parametrize("reader,name", [
    (stage_ms_per_call, "repro_torch.stage"),
    (launch_host_us, "repro_torch.sdtw"),
    (door_host_ms_per_call, "repro_torch.matsa")])
def test_nested_spans_count_once(reader, name):
    flat = run_of(host=[(10 * MS, 20 * MS, name)])
    nested = run_of(host=[(10 * MS, 20 * MS, name),
                          (12 * MS, 15 * MS, name),
                          (16 * MS, 20 * MS, name)])
    assert reader.read(nested) == pytest.approx(reader.read(flat))


@pytest.mark.parametrize("reader", [stage_ms_per_call, launch_host_us,
                                    door_host_ms_per_call])
@pytest.mark.parametrize("host", [
    [],                                            # the parent's program
    [(0, 10 * MS, "perfbench.call"), (1 * MS, 2 * MS, "aten::copy_"),
     (2 * MS, 3 * MS, "repro_torch.other")],       # other spans only
    "no trace"])
def test_a_reader_finds_nothing_without_its_span(reader, host):
    run = run_of(host=[] if host == "no trace" else host)
    if host == "no trace":
        run.trace = None
    assert reader.read(run) is None


def test_the_new_entries_name_these_readers():
    bench = harness.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    for base in ("door_host_ms_per_call", "stage_ms_per_call",
                 "launch_host_us"):
        for cell_suffix, moves in (("", "gcups"), (".human", "gcups.human")):
            m = names[base + cell_suffix]
            assert m["source"] == "program_span" and m["moves"] == moves
            assert harness.reader(m["name"]).UNIT == m["unit"]
