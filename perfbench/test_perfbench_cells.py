"""Every cell's code path at a tiny size on the CPU: correct as it is,
not correct with the control or with a fault planted in the program,
and loading neither JAX nor the JAX package. The tiny size is data: the
``cpu_test`` object of the cell's configuration and of its traffic mix,
so that a cell is added as files and BENCHMARK.json entries alone."""
import copy
import importlib
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 2**31 + 977


def sources(bench, cell):
    """The files of a cell's configuration and traffic mix, each with its
    kind."""
    w = {w["name"]: w for w in bench["workloads"]}[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return {conf["file"]: "config",
            f"perfbench/traffic/{w['traffic']}.json": "mix"}


def tiny(cell):
    """A cell's overrides at its CPU test size: the ``cpu_test`` of its
    configuration and of its mix. Queries long enough that distances
    pass the control's int16 ceiling, as they do at full size."""
    _, cfg, mix = harness.cell_files(harness.load_benchmark(), cell)
    return {"config": cfg["cpu_test"], "mix": mix["cpu_test"]}


BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
#: The cells that run here; one whose configuration or mix has no
#: ``cpu_test`` fails ``test_every_file_carries_a_smaller_cpu_test``
#: alone, which names the file.
SIZED = [c for c in CELLS if all("cpu_test" in part for part in
                                 harness.cell_files(BENCH, c)[1:])]


def run(cell, trace=0, seed=SEED, control=False):
    return harness.run_cell(cell, seed, 0.3, trace, device="cpu",
                            overrides=tiny(cell), control=control)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", SIZED)
def test_cell_is_correct(cell, trace):
    result, checks = run(cell, trace)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    if not trace:   # every end-to-end metric the cell reports (the
        # per-layer ones read the card's trace, which the CPU lacks)
        bench = harness.load_benchmark()
        want = {m["name"] for m in harness.reported(bench["end_to_end"],
                                                    cell)}
        assert set(result["metrics"]) == want and len(want) >= 2


@pytest.mark.parametrize("cell", SIZED)
def test_control_is_not_correct(cell):
    result, checks, control = run(cell, control=True)
    assert result["correct"], checks
    assert not harness.passes(control), control


def _faults():
    return [(c, f) for c in SIZED for f in importlib.import_module(
        "perfbench.doors." + harness.cell_files(BENCH, c)[2]["door"]).FAULTS]


FAULTS = _faults()


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_in_the_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    result, checks = run(cell)
    assert not result["correct"], checks


def test_a_run_loads_neither_jax_nor_the_jax_package():
    script = (
        "import sys\n"
        "from perfbench import harness\n"
        "from perfbench.test_perfbench_cells import SIZED, tiny\n"
        "for cell in SIZED:\n"
        "    harness.run_cell(cell, 5, 0.2, 1, device='cpu',\n"
        "                     overrides=tiny(cell))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "repro_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_same_seed_same_data_other_seed_other_data():
    from perfbench import datagen
    cfg = json.loads((ROOT / "perfbench/configs/ecg.json").read_text())
    small = cfg["cpu_test"]
    cfg.update(small)
    a, b = datagen.series(cfg, 2**33 + 1, "cpu"), datagen.series(
        cfg, 2**33 + 1, "cpu")
    c = datagen.series(cfg, 2**33 + 2, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    q = datagen.queries(cfg, a, 2**33 + 1)
    assert q.shape == (small["num_queries"], small["query_size"])
    assert q.dtype == torch.int32
    assert np.abs(q.numpy()).max() < 2**31


def check_cpu_test(name, kind, data):
    """That a configuration's or mix's file carries a ``cpu_test`` that
    cuts it: keys of the file, with numbers of the same type. A
    configuration's numbers are the cell's sizes, each cut. A mix's are
    its door's parameters and not each a size (the self-join's ``sample``
    counts windows compared: here all of them), so a mix is cut as a
    whole, the product of its values; an empty one runs as it is."""
    assert "cpu_test" in data, (
        f"{name} has no 'cpu_test': the sizes its cells run at in the "
        "CPU tests")
    small = data["cpu_test"]
    assert set(small) <= set(data), (
        f"{name}: 'cpu_test' names keys the file lacks: "
        f"{sorted(set(small) - set(data))}")
    assert all(type(v) in (int, float) and type(v) is type(data[k])
               and v > 0 for k, v in small.items()), f"{name}: {small}"
    if kind == "config":
        assert small and all(v < data[k] for k, v in small.items()), (
            f"{name}: 'cpu_test' {small} cuts not every size")
    elif small:
        assert math.prod(small.values()) < math.prod(
            data[k] for k in small), f"{name}: 'cpu_test' {small} cuts nothing"


FILES = {f: kind for c in CELLS for f, kind in sources(BENCH, c).items()}


@pytest.mark.parametrize("name", sorted(FILES))
def test_every_file_carries_a_smaller_cpu_test(name):
    check_cpu_test(name, FILES[name],
                   json.loads((ROOT / name).read_text()))


def _benchmark_files():
    return {p: p.read_bytes() for p in [ROOT / "BENCHMARK.json",
                                        *(ROOT / "perfbench").rglob("*")]
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_of_a_new_mix_is_files_and_entries_only(tmp_path,
                                                      monkeypatch):
    """A throwaway benchmark beside the repository: BENCHMARK.json with
    one more cell, of a new mix for the filter's door with its own
    ``cpu_test``, and a metric of its own by suffix. The cell takes its
    CPU size, runs, is correct, and its door's faults and control read
    not correct, with no file of the benchmark edited."""
    before = _benchmark_files()
    for part in ("configs", "traffic"):
        shutil.copytree(ROOT / "perfbench" / part,
                        tmp_path / "perfbench" / part)
    mix = {"door": "matsa_filter",
           "about": "the filter's batch, its check sampling an eighth of "
                    "filter_all's reference cells",
           "reference_cells": 29500000000,
           "cpu_test": {"reference_cells": 64 * 48 * 800}}
    (tmp_path / "perfbench/traffic/filter_eighth.json").write_text(
        json.dumps(mix))
    cell = "human.filter_eighth"
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({
        "name": cell, "config": "human", "traffic": "filter_eighth",
        "chips": 1, "why": "a throwaway cell of the CPU tests"})
    bench["end_to_end"].append({
        "name": "gcups.eighth", "unit": "Gcell/s", "better": "higher",
        "bound": 0.12, "source": "host_clock", "workloads": [cell]})
    bench["per_layer"].append({
        "name": "kernel_roofline.eighth", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels",
        "moves": "gcups.eighth", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", tmp_path)

    check_cpu_test("filter_eighth.json", "mix", mix)
    assert tiny(cell) == {"config": json.loads(
        (ROOT / "perfbench/configs/human.json").read_text())["cpu_test"],
        "mix": mix["cpu_test"]}
    result, checks, control = run(cell, control=True)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"gcups.eighth", "setup_s"}
    assert not harness.passes(control), control
    for fault in importlib.import_module(
            "perfbench.doors.matsa_filter").FAULTS:
        with monkeypatch.context() as m:
            fault(m.setattr)
            result, checks = run(cell)
        assert not result["correct"], (fault.__name__, checks)
    assert _benchmark_files() == before


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, checks = harness.run_cell(cell, SEED, 1.0, 0, device="cuda")
    assert result["correct"], checks
