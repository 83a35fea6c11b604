"""Every cell's code path at a tiny size on the CPU: correct as it is,
not correct with the control or with a fault planted in the program,
and loading neither JAX nor the JAX package."""
import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]

#: The configurations and mixes cut so that a cell runs in seconds here
#: and every answer is compared; queries long enough that distances pass
#: the control's int16 ceiling, as they do at full size.
TINY_CONFIG = {"ecg": {"ref_size": 3000, "query_size": 64,
                       "num_queries": 64},
               "human": {"ref_size": 800, "query_size": 48,
                         "num_queries": 64}}
TINY_MIX = {"filter_all": {"reference_cells": 64 * 64 * 3000},
            "selfjoin": {"window": 64, "stride": 64, "exclusion_zone": 32,
                         "warm_windows": 5, "sample": 64}}
SEED = 2**31 + 977


def tiny(cell):
    w = {w["name"]: w for w in harness.load_benchmark()["workloads"]}[cell]
    return {"config": TINY_CONFIG[w["config"]],
            "mix": TINY_MIX[w["traffic"]]}


def run(cell, trace=0, seed=SEED, control=False):
    return harness.run_cell(cell, seed, 0.3, trace, device="cpu",
                            overrides=tiny(cell), control=control)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
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


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result, checks, control = run(cell, control=True)
    assert result["correct"], checks
    assert not harness.passes(control), control


def _faults():
    bench = harness.load_benchmark()
    return [(w["name"], f) for w in bench["workloads"]
            for f in importlib.import_module(
                "perfbench.doors."
                + harness.cell_files(bench, w["name"])[2]["door"]).FAULTS]


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
        "from perfbench.test_perfbench_cells import tiny\n"
        "for cell in harness.load_benchmark()['workloads']:\n"
        "    harness.run_cell(cell['name'], 5, 0.2, 1, device='cpu',\n"
        "                     overrides=tiny(cell['name']))\n"
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
    cfg.update(TINY_CONFIG["ecg"])
    a, b = datagen.series(cfg, 2**33 + 1, "cpu"), datagen.series(
        cfg, 2**33 + 1, "cpu")
    c = datagen.series(cfg, 2**33 + 2, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    q = datagen.queries(cfg, a, 2**33 + 1)
    assert q.shape == (64, 64) and q.dtype == torch.int32
    assert np.abs(q.numpy()).max() < 2**31


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, checks = harness.run_cell(cell, SEED, 1.0, 0, device="cuda")
    assert result["correct"], checks
