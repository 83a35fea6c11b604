"""The port's autotuner against the JAX package's, on the CPU.

Mirrors ``tests/test_tune.py``: table persistence (and tables loading
across the two packages), the oracle (precedence, the LRU, the CPU
family deciding exactly as the reference decides), the card's launch
oracle (candidates the wrappers take, the hand-set launch under
``tune='off'``, the shipped ``h100.json`` and its ranking gate on the
committed H100 rows), bitwise safety — int32 answers equal across
``tune='off'``/``'model'``/``'measure'`` and equal to the JAX package's —
and ``explain``. The port runs with ``device="cpu"``; the reference on
JAX's CPU.
"""
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.tune import TunedConfig as JTunedConfig
from repro.tune import TuningTable as JTuningTable
from repro.tune import clear_tuning_cache as jclear
from repro.tune import resolve as jresolve
from repro.tune.tuner import DEFAULT_RECORD_SHAPES as J_RECORD_SHAPES
from repro_torch.core import engine as tengine
from repro_torch.core.request import SdtwRequest
from repro_torch.kernels.sdtw import ops
from repro_torch.tune import (DispatchDecision, KernelCostModel,
                              TunedConfig, TuningTable, bucket_key,
                              cache_info, cache_keys, clear_tuning_cache,
                              default_table, get_cost_model,
                              pretune_request, resolve, tuned_chunk)
from repro_torch.tune import tuner as ttuner
from repro_torch.tune.validate import load_rows, validate_ranking

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
BASELINE = os.path.join(ROOT, "BENCH_baseline.json")
TABLES = os.path.join(ROOT, "src", "repro_torch", "tune", "tables")


@pytest.fixture(autouse=True)
def _fresh_lru():
    clear_tuning_cache()
    jclear()
    yield
    clear_tuning_cache()
    jclear()


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(y) for y in x]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _tsdtw(*a, **kw):
    return tengine.sdtw(*a, device="cpu", **kw)


def _jsdtw(*a, **kw):
    return jengine.sdtw(*[jnp.asarray(x) if isinstance(x, np.ndarray)
                          else x for x in a], **kw)


# ---------------------------------------------------------------------------
# 1. TuningTable persistence
# ---------------------------------------------------------------------------

def test_table_round_trip(tmp_path):
    t = TuningTable("h100", provenance="test")
    key = bucket_key("h100", "abs_diff", "int32", 4, 32, 1024, "span")
    cfg = TunedConfig(impl="pallas", kernel="chain", rows=4, warps=2,
                      block_q=1, score_us=123.0, source="measured")
    t.put(key, cfg)
    path = str(tmp_path / "t.json")
    t.save(path)
    back = TuningTable.load(path, "h100")
    assert len(back) == 1 and back.get(key) == cfg
    assert back.provenance == "test"
    assert key.endswith("/b4/n32/m1024/span")


@pytest.mark.parametrize("content,match", [
    ({"schema": "repro.tune/v999", "backend": "h100", "entries": {}},
     "schema"),
    ("{not json at all", "unreadable"),
])
def test_table_bad_files_recover(tmp_path, content, match):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        f.write(content if isinstance(content, str) else json.dumps(content))
    with pytest.warns(UserWarning, match=match):
        assert len(TuningTable.load(path, "h100")) == 0
    assert len(TuningTable.load(str(tmp_path / "nope.json"))) == 0


def test_table_malformed_entry_dropped(tmp_path):
    good = bucket_key("interpret", "abs_diff", "int32", 2, 16, 256)
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"schema": "repro.tune/v1", "backend": "interpret",
                   "entries": {good: {"impl": "wavefront"},
                               "bad": "not a dict"}}, f)
    with pytest.warns(UserWarning, match="entr"):
        t = TuningTable.load(path, "interpret")
    assert len(t) == 1 and t.get(good).impl == "wavefront"


def test_tables_load_across_packages(tmp_path):
    """Same schema both ways: the reference's loader keeps its fields of
    a card entry (it ignores ``kernel``/``rows``/``warps``), the port's
    loader reads the reference's tables whole."""
    cfg = TunedConfig(impl="pallas", kernel="rows", rows=4, warps=1,
                      block_q=4, score_us=7.0, source="measured")
    t = TuningTable("h100", provenance="x")
    t.put("h100/abs_diff/int32/b8/n16/m64/plain", cfg)
    path = str(tmp_path / "h.json")
    t.save(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = JTuningTable.load(path, "h100")
    got = back.get("h100/abs_diff/int32/b8/n16/m64/plain")
    assert got == JTunedConfig(impl="pallas", block_q=4, score_us=7.0,
                               source="measured")
    jt = JTuningTable("interpret")
    jt.put("k", JTunedConfig(impl="wavefront", block_q=2, block_m=256,
                             scan_scheme="assoc", row_tile=1, chunk=4096,
                             n_micro=2, score_us=1.0, source="model"))
    jpath = str(tmp_path / "j.json")
    jt.save(jpath)
    assert (TuningTable.load(jpath).get("k").to_json()
            == jt.get("k").to_json())


def test_tuned_config_json_round_trip():
    cfg = TunedConfig(impl="pallas", kernel="wavefront", rows=1, warps=16,
                      block_q=2, block_m=256, source="model")
    assert TunedConfig.from_json(cfg.to_json()) == cfg
    assert "chunk" not in cfg.to_json()
    assert TunedConfig.from_json({"impl": "rowscan", "unknown": 1}) == \
        TunedConfig(impl="rowscan")


def test_shipped_tables_load():
    for backend in ("interpret", "h100"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = default_table(backend)
        assert len(t) > 0, backend
        assert all(k.startswith(backend + "/") for k in t.keys())
    with open(os.path.join(TABLES, "interpret.json")) as f:
        port = json.load(f)
    with open(os.path.join(ROOT, "src", "repro", "tune", "tables",
                           "interpret.json")) as f:
        assert port == json.load(f)


def test_shipped_h100_table_names_its_card_and_launches_validly():
    """Recorded on the card (its provenance names the card and power
    limit) at ``H100_RECORD_SHAPES``: each shape's launch under
    ``tune='model'`` is its measured entry; at the bucket's largest shape,
    where the entry's R or kernel may not fit, the launch is still one
    the wrappers take."""
    t = TuningTable.load(os.path.join(TABLES, "h100.json"), "h100")
    assert "H100" in t.provenance and " W" in t.provenance
    assert len(t) == len(ttuner.H100_RECORD_SHAPES)
    for nq, n, m, variant, ban in ttuner.H100_RECORD_SHAPES:
        c = t.get(bucket_key("h100", "abs_diff", "int32", nq, n, m,
                             variant))
        assert c.source == "measured" and c.impl == "pallas"
        cfg, res = ops.tuned_launch(nq, n, m, sms=132, variant=variant,
                                    ban=ban, tune="model")
        assert res.source == "table:measured"
        assert cfg == {"kernel": c.kernel, "rows": c.rows, "warps": c.warps,
                       "block_q": c.block_q, "block_m": c.block_m}
        nb = 1 << (n - 1).bit_length()
        cfg, _ = ops.tuned_launch(nq, nb, m, sms=132, variant=variant,
                                  ban=ban, tune="model")
        assert ops.launch_config(
            nq, nb, m, sms=132, kernel=cfg["kernel"],
            rows=None if cfg["kernel"] == "wavefront" else cfg["rows"],
            block_q=cfg["block_q"], block_m=cfg["block_m"],
            span=variant != "plain") == cfg


def test_h100_ranking_agrees_with_the_committed_rows():
    """The gate ``python -m repro_torch.tune.validate`` runs: the card's
    model orders the kernel times recorded on the H100 like the
    measurement, over at least 3 pairs."""
    rows = load_rows(os.path.join(TABLES, "h100_rows.json"))
    agree, total, report = validate_ranking(rows, backend="h100")
    assert total >= 3
    assert agree / total >= 0.6, "\n".join(report)


def test_interpret_ranking_agrees_with_the_committed_baseline():
    with open(BASELINE) as f:
        rows = json.load(f)
    agree, total, report = validate_ranking(rows, backend="interpret")
    assert total >= 3 and agree / total >= 0.6, "\n".join(report)


# ---------------------------------------------------------------------------
# 2. The oracle
# ---------------------------------------------------------------------------

def test_lru_caches_resolutions():
    resolve(4, 32, 1024, backend="cpu")
    info0 = cache_info()
    resolve(4, 32, 1024, backend="cpu")
    resolve(3, 20, 600, backend="cpu")              # same pow-2 bucket
    info1 = cache_info()
    assert info1["hits"] >= info0["hits"] + 2
    assert info1["misses"] == info0["misses"]


@pytest.mark.parametrize("shape", J_RECORD_SHAPES)
def test_cpu_resolution_equals_the_reference(shape):
    """On the CPU family, the port's oracle gives the reference's
    ``TunedConfig`` (the shipped table's measured entries overlaying the
    model) and its in-core ranking."""
    got = resolve(*shape, backend="cpu")
    want = jresolve(*shape, backend="cpu")
    assert got.source == want.source
    g = got.config.to_json()
    assert not {"kernel", "rows", "warps"} & set(g)
    assert g == want.config.to_json()
    assert got.candidates == want.candidates


@pytest.mark.parametrize("shape", [(4, 32, 4096), (4, 32, 60), (8, 16, 700),
                                   (2, 100, 150), (16, 8, 9000)])
@pytest.mark.parametrize("tune", ["off", "model"])
def test_cpu_choose_impl_equals_the_reference(shape, tune):
    got = tengine.choose_impl_explained(*shape, backend="cpu", tune=tune)
    want = jengine.choose_impl_explained(*shape, backend="cpu", tune=tune)
    assert got == want
    assert tengine.choose_impl(*shape, backend="cpu", tune=tune,
                               chunk=64) == "chunked"
    assert tengine.choose_impl(4, 32, 1 << 18, backend="cpu",
                               tune=tune) == "chunked"


def test_card_rule_3_stays_structural_under_tuning():
    for tune in ("off", "model", "measure"):
        assert tengine.choose_impl_explained(
            4, 32, 4096, backend="cuda", tune=tune)[:2] == ("pallas",
                                                           "structural")


@pytest.mark.parametrize("shape", [(131072, 120, 7997), (256, 512, 1 << 20),
                                   (64, 4096, 1 << 20), (3, 9000, 3000),
                                   (4224, 1536, 30720), (1, 1, 5)])
@pytest.mark.parametrize("variant", ["plain", "span", "lastrow"])
def test_card_candidates_are_launches_the_wrappers_take(shape, variant):
    """Every candidate is a launch ``launch_config`` accepts: no rows
    kernel past ``ROWS_MAX_N``, no chain query of more than 16 warps, no
    wavefront block past 1,024 threads; the hand-set launch is among
    them, and ties go to it."""
    nq, n, m = shape
    ranked = get_cost_model("h100").cuda_candidates(nq, n, m, variant)
    configs = [c for c, _ in ranked]
    off = ops.launch_config(nq, n, m, sms=132, span=variant != "plain")
    assert off in configs
    for c in configs:
        assert ops.launch_config(
            nq, n, m, sms=132, kernel=c["kernel"],
            rows=None if c["kernel"] == "wavefront" else c["rows"],
            block_q=c["block_q"], block_m=c["block_m"],
            span=variant != "plain") == c
        assert c["kernel"] != "rows" or n <= ops.ROWS_MAX_N
        assert c["kernel"] != "chain" or c["warps"] * c["block_q"] <= 16
    us = [u for _, u in ranked]
    assert us == sorted(us) and all(u > 0 for u in us)
    tied = [c for c, u in ranked if u == us[0]]
    assert off not in tied or tied[0] == off


def test_tune_off_is_the_hand_set_launch_and_explicit_knobs_win():
    sms = 132
    for b, n, m in ((131072, 120, 7997), (256, 512, 1_800_000),
                    (64, 4096, 1_800_000), (3, 9000, 3000)):
        cfg, res = ops.tuned_launch(b, n, m, sms=sms, tune="off")
        assert res is None and cfg == ops.launch_config(b, n, m, sms=sms)
        cfg, res = ops.tuned_launch(b, n, m, sms=sms, tune="model")
        assert res is not None and cfg["kernel"] == res.config.kernel
    cfg, _ = ops.tuned_launch(131072, 120, 7997, sms=sms, kernel="chain",
                              rows=8, block_q=2, tune="model")
    assert (cfg["kernel"], cfg["rows"], cfg["block_q"]) == ("chain", 8, 2)
    with pytest.raises(ValueError, match="the rows kernel stages none"):
        ops.tuned_launch(64, 120, 7997, sms=sms, kernel="rows", block_m=64,
                         tune="model")


def test_card_oracle_reads_the_shipped_table():
    t = default_table("h100")
    key = next(iter(t.keys()))
    b, n, m = (int(p[1:]) for p in key.split("/")[3:6])
    res = resolve(b, n, m, backend="cuda", variant=key.split("/")[-1])
    assert res.source == "table:measured"
    assert res.config.kernel == t.get(key).kernel


def test_cost_model_sanity():
    model = get_cost_model("interpret")
    assert model.best_chunk(4, 32, 1 << 18) in \
        KernelCostModel.CHUNK_CANDIDATES
    assert tuned_chunk(4, 32, 1 << 18, backend="cpu") in \
        KernelCostModel.CHUNK_CANDIDATES
    assert tuned_chunk(4, 32, 1 << 18, backend="cuda") is None
    assert ttuner.canonical_backend(None) == "h100"
    assert ttuner.canonical_backend(torch.device("cpu")) == "interpret"
    assert ttuner.canonical_backend("cuda") == "h100"


def test_pretune_primes_the_lru():
    rng = np.random.default_rng(0)
    qs = [rng.integers(-50, 50, (L,)).astype(np.int32) for L in (10, 33, 70)]
    ref = rng.integers(-50, 50, (512,)).astype(np.int32)
    assert pretune_request(SdtwRequest(queries=qs, reference=ref,
                                       device="cpu")) == 3
    assert len(cache_keys()) >= 3
    assert all(k[0].startswith("interpret/") for k in cache_keys())
    clear_tuning_cache()
    assert pretune_request(SdtwRequest(queries=qs, reference=ref,
                                       tune="off", device="cpu")) == 0
    assert len(cache_keys()) == 0
    q2 = torch.as_tensor(rng.integers(-50, 50, (6, 40)).astype(np.int32))
    assert pretune_request(SdtwRequest(queries=q2, reference=ref,
                                       device="cpu")) == 1


# ---------------------------------------------------------------------------
# 3. Bitwise safety + explain
# ---------------------------------------------------------------------------

def _mk(rng, nq=3, n=24, m=700):
    return (rng.integers(-60, 60, (nq, n)).astype(np.int32),
            rng.integers(-60, 60, (m,)).astype(np.int32))


@pytest.mark.parametrize("metric", ["abs_diff", "square_diff"])
@pytest.mark.parametrize("impl", ["auto", "rowscan", "wavefront", "pallas",
                                  "chunked"])
def test_tuned_bitwise_invariance(rng, metric, impl):
    """tune='off'/'model' across impl x metric: identical int32 results
    on every path, equal to the JAX package's."""
    q, r = _mk(rng)
    kw = dict(metric=metric, impl=impl)
    if impl == "chunked":
        kw["chunk"] = 128
    want = _jsdtw(q, r, **kw)
    for tune in ("off", "model"):
        _equal(_tsdtw(q, r, tune=tune, **kw), want)


@pytest.mark.parametrize("kw", [dict(return_spans=True),
                                dict(return_positions=True),
                                dict(top_k=3, chunk=256),
                                dict(top_k=2, chunk=256, return_spans=True,
                                     excl_mode="span"),
                                dict(top_k=2)])
def test_tuned_bitwise_spans_and_topk(rng, kw):
    q, r = _mk(rng, m=2048)
    want = _jsdtw(q, r, **kw)
    for tune in ("off", "model"):
        _equal(_tsdtw(q, r, tune=tune, **kw), want)


def test_tuned_bitwise_ragged(rng):
    qs = [rng.integers(-60, 60, n).astype(np.int32) for n in (10, 33, 70)]
    r = rng.integers(-60, 60, 700).astype(np.int32)
    want = _jsdtw(qs, jnp.asarray(r))
    for tune in ("off", "model"):
        _equal(_tsdtw(qs, r, tune=tune), want)


@pytest.mark.parametrize("kw", [dict(), dict(return_spans=True),
                                dict(return_positions=True),
                                dict(top_k=2), dict(impl="pallas")])
def test_measured_tuning_is_bitwise_and_recorded(rng, kw):
    """tune='measure' times the in-core schedules on the CPU once for a
    bucket the shipped table lacks (a small one: the search runs each
    schedule four times), records the winner in the process table, and
    answers bitwise as 'off' and as the JAX package."""
    q = rng.integers(-60, 60, (2, 16)).astype(np.int32)
    r = rng.integers(-60, 60, 100).astype(np.int32)
    key = bucket_key("interpret", "abs_diff", "int32", 2, 16, 100)
    assert key not in TuningTable.load(os.path.join(TABLES,
                                                    "interpret.json"))
    want = _jsdtw(q, r, **kw)
    for tune in ("off", "measure"):
        _equal(_tsdtw(q, r, tune=tune, **kw), want)
    entry = default_table("interpret").get(key)
    assert entry is not None and entry.source == "measured"
    assert entry.impl in ("rowscan", "wavefront")


def test_explain_decision_contents(rng):
    q, r = _mk(rng)
    out, dec = _tsdtw(q, r, explain=True)
    jout, jdec = _jsdtw(q, r, explain=True)
    assert isinstance(dec, DispatchDecision)
    assert (dec.impl, dec.source, dec.reason, dec.candidates,
            dec.score_us) == (jdec.impl, jdec.source, jdec.reason,
                              jdec.candidates, jdec.score_us)
    assert dec.token() == jdec.token()
    _equal(out, jout)
    _, dec2 = _tsdtw(q, r, impl="rowscan", explain=True)
    assert (dec2.impl, dec2.source) == ("rowscan", "explicit")
    long_r = np.tile(r, 400)[: 1 << 18]
    _, dec3 = _tsdtw(q, long_r, explain=True)
    _, jdec3 = _jsdtw(q, long_r, explain=True)
    assert dec3.impl == "chunked" and dec3.config == jdec3.config
    _, dec4 = _tsdtw(q, r, impl="pallas", explain=True)
    assert dec4.config == {"kernel": "plain"}
    with pytest.raises(ValueError) as got:
        _tsdtw([q[0]], r, explain=True)
    with pytest.raises(ValueError) as want:
        _jsdtw([q[0]], r, explain=True)
    assert str(got.value) == str(want.value)


def test_defaults_are_the_reference_defaults():
    assert SdtwRequest().tune == "model" == \
        jengine.SdtwRequest().tune
    import inspect
    assert (inspect.signature(tengine.sdtw).parameters["tune"].default
            == "model")


def test_tune_validated_at_the_door():
    q, r = np.zeros((1, 4), np.int32), np.zeros(8, np.int32)
    with pytest.raises(ValueError) as got:
        _tsdtw(q, r, tune="bogus")
    with pytest.raises(ValueError) as want:
        _jsdtw(q, r, tune="bogus")
    assert str(got.value) == str(want.value)


def test_explain_rejected_by_serve():
    from repro_torch.serve import Router
    q, r = _mk(np.random.default_rng(0), nq=2, n=16, m=256)
    with Router(auto_dispatch=False) as router:
        with pytest.raises(ValueError, match="explain"):
            router.submit(SdtwRequest(queries=q, reference=r,
                                      explain=True, device="cpu"))


def test_router_warmup_pretunes(rng):
    from repro_torch.serve import Router
    q, r = _mk(rng, nq=2, n=16, m=256)
    with Router(auto_dispatch=False, devices=["cpu"]) as router:
        router.warmup(queries=q, reference=r, device="cpu")
        assert len(cache_keys()) >= 1
        fut = router.submit(queries=q, reference=r, device="cpu")
        router.drain()
        _equal(fut.result(), _jsdtw(q, r))
