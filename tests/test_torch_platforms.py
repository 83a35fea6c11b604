"""The port's evaluation models against the JAX package's.

``repro_torch.core.pum_model`` (the MATSA simulator) and
``repro_torch.core.platforms`` (the paper's baseline platforms) are
copies; here they give the reference's results exactly on the same
inputs, and the reference's claims (Table VI, Key Observations 3-6,
endurance, platform sanity) are checked on the port's copies as
``tests/test_pum_model.py`` and ``tests/test_platforms_api.py`` check
them on the reference. The card's cost family (``H100_BACKEND``) shares
nothing with the reference's TPU family.
"""
import dataclasses
import statistics

import numpy as np
import pytest

from repro.core import platforms as jplat
from repro.core import pum_model as jpum
from repro_torch.core import (PAPER_TABLE6, PLATFORMS, VERSIONS, MramParams,
                              OpCounts, Workload, endurance_writes_per_cell,
                              load_real_workload_shapes, simulate)
from repro_torch.core import platforms as tplat
from repro_torch.core import pum_model as tpum

WORKLOADS = [(131072, 8192, 8192), (1_800_000, 512, 16384), (7997, 120, 1),
             (65536, 4096, 4096), (100, 8, 3)]
COLUMNS = [32768, 131072, 1_048_576]


@pytest.mark.parametrize("shape", WORKLOADS)
@pytest.mark.parametrize("cols", COLUMNS)
@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
@pytest.mark.parametrize("conserving", [True, False])
def test_simulate_equals_the_reference(shape, cols, metric, conserving):
    got = tpum.simulate(tpum.Workload(*shape, metric=metric), cols,
                        work_conserving=conserving)
    want = jpum.simulate(jpum.Workload(*shape, metric=metric), cols,
                         work_conserving=conserving)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("preset", [None, "fig9_calibrated"])
@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
def test_op_counts_and_params_equal_the_reference(preset, metric):
    kw = dict(metric=metric) if preset is None else dict(preset=preset)
    assert (dataclasses.asdict(tpum.OpCounts.derive(**kw))
            == dataclasses.asdict(jpum.OpCounts.derive(**kw)))
    w = (131072, 8192, 8192)
    p = dict(read_ns=3.0, write_ns=7.0)
    got = tpum.simulate(tpum.Workload(*w), 131072, tpum.MramParams(**p),
                        tpum.OpCounts.derive(**kw))
    want = jpum.simulate(jpum.Workload(*w), 131072, jpum.MramParams(**p),
                         jpum.OpCounts.derive(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_versions_sweep_and_endurance_equal_the_reference():
    assert ({k: dataclasses.asdict(v) for k, v in tpum.VERSIONS.items()}
            == {k: dataclasses.asdict(v) for k, v in jpum.VERSIONS.items()})
    assert tpum.SWEEP == jpum.SWEEP
    for years in (1, 10):
        assert (tpum.endurance_writes_per_cell(years=years)
                == jpum.endurance_writes_per_cell(years=years))


@pytest.mark.parametrize("name", sorted(jplat.PLATFORMS))
@pytest.mark.parametrize("shape", WORKLOADS)
def test_platform_model_equals_the_reference(name, shape):
    t, j = tplat.PLATFORMS[name], jplat.PLATFORMS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    wt, wj = tpum.Workload(*shape), jpum.Workload(*shape)
    assert t.exec_time_s(wt) == j.exec_time_s(wj)
    assert t.energy_j(wt) == j.energy_j(wj)
    assert t.energy_per_cell_j() == j.energy_per_cell_j()
    assert t.utilization() == j.utilization()


def test_paper_table6_and_cpu_family_equal_the_reference():
    assert tplat.PAPER_TABLE6 == jplat.PAPER_TABLE6
    assert (dataclasses.asdict(tplat.INTERPRET_BACKEND)
            == dataclasses.asdict(jplat.INTERPRET_BACKEND))


def test_the_card_family_is_not_the_tpu_family():
    """The port keeps no TPU constants: ``'tpu'`` is no backend of its,
    and no term of the card's family equals a TPU v5e constant."""
    assert set(tplat.BACKENDS) == {"interpret", "h100"}
    assert not hasattr(tplat, "TPU_BACKEND")
    h100 = tplat.backend_model("h100")
    assert h100.sms == 132 and h100.hbm_bw_bytes_per_s == 3.35e12
    assert h100.hbm_bw_bytes_per_s != jplat.TPU_BACKEND.hbm_bw_bytes_per_s
    assert {k for k, _ in h100.kernels} == {"rows", "chain", "wavefront"}
    assert tplat.backend_model("cpu") is tplat.INTERPRET_BACKEND


def _ratios(version, platform):
    v, p = VERSIONS[version], PLATFORMS[platform]
    sp, en = [], []
    for s in load_real_workload_shapes().values():
        w = Workload(s["ref_size"], s["query_size"], s["num_queries"])
        r = simulate(w, v.compute_columns)
        sp.append(p.exec_time_s(w) / r.exec_time_s)
        en.append(p.energy_j(w) / r.energy_j)
    return statistics.geometric_mean(sp), statistics.geometric_mean(en)


@pytest.mark.parametrize("pair", sorted(PAPER_TABLE6))
def test_table6_within_tolerance(pair):
    """Speedups within 15%, energy within 5% of the paper's Table VI."""
    sp, en = _ratios(*pair)
    want_sp, want_en = PAPER_TABLE6[pair]
    assert abs(sp / want_sp - 1) < 0.15, (pair, sp, want_sp)
    assert abs(en / want_en - 1) < 0.05, (pair, en, want_en)


def test_key_observations_3_to_6():
    w = Workload(131072, 8192, 8192)
    assert simulate(w, 131072).read_time_frac < 0.5           # Obs 3
    counts = OpCounts.derive(preset="fig9_calibrated")

    def t(rd, wr):
        return simulate(w, 131072, MramParams(read_ns=rd, write_ns=wr),
                        counts).exec_time_s
    assert abs(t(10, 1) / t(1, 1) - 4.7) < 0.3
    assert abs(t(1, 10) / t(1, 1) - 6.5) < 0.4
    assert 0.35 < simulate(w, 131072).read_energy_frac < 0.5  # Obs 4
    base = simulate(Workload(65536, 4096, 4096), 131072)      # Obs 5
    both = simulate(Workload(131072, 8192, 4096), 131072)
    assert abs(both.exec_time_s / base.exec_time_s - 4) < 0.1
    assert abs(both.energy_j / base.energy_j - 4) < 1e-6
    t1, t2 = simulate(w, 131072), simulate(w, 262144)         # Obs 6
    assert 1.9 < t1.exec_time_s / t2.exec_time_s < 2.05
    assert t1.energy_j == t2.energy_j


def test_endurance_conclusion():
    writes_10y = endurance_writes_per_cell(years=10)
    assert writes_10y < 1e15
    assert 1e5 / (writes_10y / (10 * 365.25 * 24 * 3600)) < 24 * 3600


W0 = Workload(ref_size=10_000, query_size=100, num_queries=64)


@pytest.mark.parametrize("name", sorted(PLATFORMS))
@pytest.mark.parametrize("dim", ["ref_size", "query_size", "num_queries"])
def test_platform_linear_and_under_peak(name, dim):
    p = PLATFORMS[name]
    w2 = dataclasses.replace(W0, **{dim: getattr(W0, dim) * 2})
    assert np.isclose(p.exec_time_s(w2), 2 * p.exec_time_s(W0))
    assert np.isclose(p.energy_j(w2), 2 * p.energy_j(W0))
    u = p.utilization()
    assert (0.9 < u < 1.1) if name == "upmem" else (0 < u <= 0.1)


def test_upmem_energy_beats_gpu():
    ratio = (PLATFORMS["upmem"].energy_per_cell_j()
             / PLATFORMS["gpu"].energy_per_cell_j())
    assert abs(ratio - 0.63) < 0.02
