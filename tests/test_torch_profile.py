"""repro_torch's matrix profile against the JAX package's, on the CPU.

Mirrors ``tests/test_profile.py`` case by case (its hypothesis variants
are covered by the seeded sweeps here): ``matrix_profile``,
``StreamProfile`` and ``matsa(mode="self_join")`` on both of its routes.
The same numpy inputs from a seed go through the JAX package and the
port (``device="cpu"``: the row scan, as the reference runs there).

Tolerances: int32 is compared bitwise in every ``ProfileResult`` field —
the per-window distances, spans and neighbour indices, the motif and
discord selections and the pruning counters. Integer-valued float32 is
bitwise too (every DP sum is exact in float32); real-valued float32 is
held to ``rtol=1e-5`` on the distances, with the valid mask equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_profile import (_check_selection_invariants,
                          assert_profile_matches_oracle, oracle_profile)

from repro.core.matsa_api import matsa as jmatsa
from repro.search import search_topk as jsearch
from repro.search.profile import matrix_profile as jprofile
from repro.stream import StreamProfile as JStreamProfile
from repro_torch.core.distances import big
from repro_torch.core.matsa_api import matsa
from repro_torch.search import ProfileResult, matrix_profile, search_topk
from repro_torch.search import profile as profile_mod
from repro_torch.search.profile import profile_batch
from repro_torch.stream import StreamProfile

FIELDS = [f.name for f in dataclasses.fields(ProfileResult)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tprofile(*a, **kw):
    return matrix_profile(*a, device="cpu", **kw)


def _tstream(*a, **kw):
    return StreamProfile(*a, device="cpu", **kw)


def _same(got, want):
    """Every ``ProfileResult`` field bitwise, dtypes included."""
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype,
                                                               w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)


def _feed_partitioned(sp, series, cuts, flush_at=()):
    edges = [0] + sorted(cuts) + [len(series)]
    for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
        sp.feed(series[a:b])
        if i in flush_at:
            sp.flush()
    return sp


def _stream_vs_batch(sp, series, stride=1):
    """The port's streamed profile equals the JAX batch profile of the same
    series (``prune=False``), field by field — the chunk counters are the
    stream's own tile counts, compared with the port's batch profile."""
    got = sp.results()
    want = jprofile(series, sp.window, stride=stride, prune=False,
                    chunk=sp.chunk, excl_zone=sp.zone, k=sp.k)
    for f in ("starts", "nn_dist", "nn_start", "nn_end", "nn_window",
              "motif_a", "motif_b", "motif_dist", "discord_idx",
              "discord_dist"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    return got


# ---------------------------------------------------------------------------
# Batch profile against the reference (and its oracle)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2, 3, 5])
@pytest.mark.parametrize("prune", [False, True])
def test_profile_matches_reference(stride, prune, rng):
    series = rng.integers(-30, 30, 97).astype(np.int32)
    kw = dict(stride=stride, prune=prune, chunk=16, batch=7)
    got = _tprofile(series, 8, **kw)
    _same(got, jprofile(series, 8, **kw))
    assert_profile_matches_oracle(got, series, exact_spans=not prune)


def test_profile_square_diff_and_default_zone(rng):
    series = rng.integers(-9, 9, 64).astype(np.int32)
    kw = dict(metric="square_diff", prune=False, chunk=16)
    got = _tprofile(series, 6, **kw)
    assert got.excl_zone == 3
    _same(got, jprofile(series, 6, **kw))


def test_profile_custom_zone(rng):
    series = rng.integers(-20, 20, 80).astype(np.int32)
    kw = dict(excl_zone=11, prune=False, chunk=16)
    _same(_tprofile(series, 8, **kw), jprofile(series, 8, **kw))


def test_profile_batch_size_invariant(rng):
    """``batch`` is memory only: unpruned, batch=3 and batch=1000 agree
    bitwise on everything; pruned, on the distances. Each equals the
    reference at the same batch."""
    series = rng.integers(-30, 30, 90).astype(np.int32)
    for prune in (False, True):
        small = _tprofile(series, 8, prune=prune, chunk=16, batch=3)
        huge = _tprofile(series, 8, prune=prune, chunk=16, batch=1000)
        _same(small, jprofile(series, 8, prune=prune, chunk=16, batch=3))
        np.testing.assert_array_equal(small.nn_dist, huge.nn_dist)
        if not prune:
            for f in ("nn_start", "nn_end", "nn_window", "motif_a",
                      "discord_idx"):
                np.testing.assert_array_equal(getattr(small, f),
                                              getattr(huge, f), err_msg=f)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_profile_other_dtypes(dtype, rng):
    """Integer-valued float32 and int16 series: bitwise, as int32."""
    series = rng.integers(-25, 25, 70).astype(dtype)
    kw = dict(stride=2, prune=True, chunk=16, k=2)
    _same(_tprofile(series, 7, **kw), jprofile(series, 7, **kw))


def test_profile_real_valued_float32_within_tolerance(rng):
    """Real-valued float32: the DP sums may round in another order, so the
    distances are held to rtol=1e-5 and the valid mask exactly."""
    series = rng.normal(0, 10, 80).astype(np.float32)
    got = _tprofile(series, 8, stride=3, prune=False, chunk=16)
    want = jprofile(series, 8, stride=3, prune=False, chunk=16)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_allclose(got.nn_dist, want.nn_dist, rtol=1e-5)


def test_profile_validates_args():
    s = np.zeros(32, np.int32)
    for args, kw in (((s.reshape(4, 8), 4), {}), ((s, 33), {}),
                     ((s, 4), dict(stride=0)), ((s, 4), dict(k=0)),
                     ((s, 4), dict(batch=0)), ((s, 4), dict(excl_zone=-1))):
        with pytest.raises(ValueError) as want:
            jprofile(*args, **kw)
        with pytest.raises(ValueError) as got:
            _tprofile(*args, **kw)
        assert str(got.value) == str(want.value)


# The window budget of one (40 windows of 8, chunk 16) on the kernel route.
_WINDOW_BYTES = (profile_mod._COLUMN_BYTES * 16
                 + profile_mod._ROW_BYTES * 8)


@pytest.mark.parametrize("budget,want", [
    (None, 40),     # all in one batch
    (40, 40),       # exactly the cap
    (39, 20),       # 2 equal batches
    (7, 7),         # 7 x 5 + 5
    (1, 1),
], ids=["one-batch", "at-cap", "two-equal", "six-equal", "one-window"])
def test_profile_batch_rule(budget, want, monkeypatch):
    """``profile_batch``: the exact profile on the kernel route takes every
    window in one batch under the memory budget, else the fewest equal
    batches that fit it; anything else keeps 256."""
    if budget is not None:
        monkeypatch.setattr(profile_mod, "BATCH_BUDGET_BYTES",
                            budget * _WINDOW_BYTES)
    got = profile_batch(40, 8, 16, exact_kernel=True)
    assert got == want
    if budget is not None:      # no more batches than the cap needs
        assert got <= budget and -(-40 // got) == -(-40 // budget)
    assert profile_batch(40, 8, 16, exact_kernel=False) == 256


@pytest.mark.parametrize("route,prune,batch,want", [
    ("pallas", False, None, 293),       # the exact profile on the kernel
    ("pallas", True, None, 256),        # pruned
    ("rowscan", False, None, 256),      # the row scan
    ("rowscan", True, None, 256),
    ("pallas", False, 100, 100),        # an explicit batch wins
    ("rowscan", True, 1000, 1000),
], ids=["exact-kernel", "pruned-kernel", "exact-rowscan", "pruned-rowscan",
        "explicit-kernel", "explicit-huge"])
def test_profile_default_batch_by_route(route, prune, batch, want, rng,
                                        monkeypatch):
    """``matrix_profile``'s batch as its ``repro_torch.profile.batch``
    spans count it, 293 windows of 8: the exact profile on the kernel
    route in one batch, ``prune=True`` and the row scan in batches of
    256, an explicit ``batch`` as given; every field the reference's at
    that batch, the chunk counters included."""
    import repro_torch.search.search as search_mod
    from test_torch_obs import traced
    series = rng.integers(-30, 30, 300).astype(np.int32)
    kw = dict(prune=prune, chunk=64)
    monkeypatch.setattr(search_mod, "_auto_engine", lambda dev: route)
    got, spans = traced(lambda: _tprofile(series, 8, batch=batch, **kw))
    assert [s[0] for s in spans].count(
        "repro_torch.profile.batch") == -(-293 // want)
    _same(got, jprofile(series, 8, batch=want, **kw))


# ---------------------------------------------------------------------------
# matsa(mode="self_join"): the profile route and the direct route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2, 3, 5, 8])
def test_matsa_self_join_stride_exclusion_units(stride, rng):
    """The trivial-match band is in samples whatever the stride, on both
    routes: the profile route (``impl='auto'``) carries the whole profile,
    the direct route (``impl='chunked'``) the engine's distances; both
    equal the reference's."""
    series = rng.integers(-25, 25, 73).astype(np.int32)
    w = 8
    routed = matsa(series, mode="self_join", window=w, stride=stride,
                   anomaly_threshold=40, device="cpu")
    want = jmatsa(series, mode="self_join", window=w, stride=stride,
                  anomaly_threshold=40)
    _same(routed.profile, want.profile)
    for f in ("distances", "window_starts", "anomalies"):
        np.testing.assert_array_equal(getattr(routed, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    starts, dist, _, _ = oracle_profile(series, w, stride)
    finite = np.isfinite(dist)
    np.testing.assert_array_equal(routed.distances.numpy()[finite],
                                  dist[finite])

    legacy = matsa(series, mode="self_join", window=w, stride=stride,
                   impl="chunked", chunk=16, device="cpu")
    jlegacy = jmatsa(series, mode="self_join", window=w, stride=stride,
                     impl="chunked", chunk=16)
    assert legacy.profile is None
    np.testing.assert_array_equal(legacy.distances.numpy(),
                                  np.asarray(jlegacy.distances))
    np.testing.assert_array_equal(legacy.window_starts.numpy(), starts)


@pytest.mark.parametrize("impl,exclusion", [("rowscan", True),
                                            ("wavefront", False),
                                            ("auto", False)])
def test_matsa_self_join_direct_routes(impl, exclusion, rng):
    """The direct route with an in-core schedule, and without exclusion
    (``exclusion=False`` bans nothing: each window then matches itself)."""
    series = rng.integers(-25, 25, 50).astype(np.int32)
    kw = dict(mode="self_join", window=6, stride=4, impl=impl,
              exclusion=exclusion)
    got = matsa(series, device="cpu", **kw)
    want = jmatsa(series, **kw)
    assert got.profile is None
    np.testing.assert_array_equal(got.distances.numpy(),
                                  np.asarray(want.distances))
    if not exclusion:
        assert (got.distances.numpy() == 0).all()


@pytest.mark.parametrize("route", ["rowscan", "kernel"])
def test_matsa_self_join_long_windows_match_reference(route, monkeypatch):
    """Windows longer than the rows kernel's 1,536 samples (on the card,
    the chain kernel's with its ban): ``matsa(mode="self_join")`` with
    1,600-sample windows on 6,000 samples, on the CPU's row scan and
    through the kernel route as on the card, equals the JAX package's
    profile bitwise."""
    import repro_torch.search.search as search_mod
    rng = np.random.default_rng(1600)
    series = rng.integers(-50, 50, 6000).astype(np.int32)
    series[3500:5100] = series[300:1900] + rng.integers(-2, 3, 1600)
    if route == "kernel":
        monkeypatch.setattr(search_mod, "_auto_engine", lambda dev: "pallas")
    kw = dict(mode="self_join", window=1600, stride=1600)
    got = matsa(series, device="cpu", **kw)
    want = jmatsa(series, **kw)
    _same(got.profile, want.profile)
    np.testing.assert_array_equal(got.distances.numpy(),
                                  np.asarray(want.distances))


def test_search_topk_padding_exact_when_k_exceeds_matches(rng):
    q = rng.integers(-10, 10, (2, 6)).astype(np.int32)
    r = rng.integers(-10, 10, 20).astype(np.int32)
    kw = dict(k=8, chunk=16, prune=False, excl_zone=50)
    res = search_topk(q, r, device="cpu", **kw)
    want = jsearch(jnp.asarray(q), jnp.asarray(r), **kw)
    for f in ("distances", "positions", "starts"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(want, f)))
    d = res.distances.numpy()
    assert (d[:, 1:] == big(res.distances.dtype)).all()
    assert (res.positions.numpy()[:, 1:] == -1).all()
    assert (res.starts.numpy()[:, 1:] == -1).all()


def test_profile_fully_banned_windows_masked():
    """m=14, w=8, zone=4: windows starting at 2, 3, 4 ban every column and
    come back invalid with the canonical padding, never a motif or a
    discord."""
    series = (np.arange(14, dtype=np.int32) % 5) * 3
    kw = dict(excl_zone=4, prune=False, chunk=16, k=4)
    prof = _tprofile(series, 8, **kw)
    _same(prof, jprofile(series, 8, **kw))
    np.testing.assert_array_equal(
        prof.valid, [True, True, False, False, False, True, True])
    inv = ~prof.valid
    assert (prof.nn_start[inv] == -1).all() and (prof.nn_end[inv] == -1).all()
    assert (prof.nn_window[inv] == -1).all()
    assert (prof.nn_dist[inv] == big(torch.int32)).all()
    banned = set(np.flatnonzero(inv))
    assert not banned & {x for a, b, _ in prof.motifs for x in (a, b)}
    assert not banned & {i for i, _ in prof.discords}


@pytest.mark.parametrize("seed", range(6))
def test_motif_discord_invariants_sweep(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(40, 120))
    w = int(rng.integers(4, 10))
    stride = int(rng.integers(1, 4))
    series = rng.integers(-15, 15, m).astype(np.int32)
    kw = dict(stride=stride, k=3, prune=bool(seed % 2), chunk=16)
    prof = _tprofile(series, w, **kw)
    _same(prof, jprofile(series, w, **kw))
    _check_selection_invariants(prof)


def test_planted_motif_found():
    rng = np.random.default_rng(7)
    series = rng.integers(-40, 40, 120).astype(np.int32)
    pat = np.array([5, -30, 30, -30, 30, 5, 17, -17], np.int32)
    series[10:18] = pat
    series[90:98] = pat
    kw = dict(k=2, prune=False, chunk=16)
    prof = _tprofile(series, 8, **kw)
    _same(prof, jprofile(series, 8, **kw))
    a, b, d = prof.motifs[0]
    assert {prof.starts[a], prof.starts[b]} == {10, 90} and d == 0.0


# ---------------------------------------------------------------------------
# StreamProfile: bitwise the batch profile, any partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 4])
def test_stream_profile_vs_batch_bitwise(stride, rng):
    series = rng.integers(-20, 20, 101).astype(np.int32)
    sp = _tstream(8, stride=stride, chunk=16, k=2)
    sp.feed(series)
    got = _stream_vs_batch(sp, series, stride)
    jsp = JStreamProfile(8, stride=stride, chunk=16, k=2)
    jsp.feed(series)
    _same(got, jsp.results())


@pytest.mark.parametrize("seed", range(5))
def test_stream_profile_random_partitions(seed):
    """Random feed partitions with random mid-stream flushes: bitwise the
    batch profile, and the reference's stream fed the same way."""
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(60, 140))
    series = rng.integers(-25, 25, m).astype(np.int32)
    ncuts = int(rng.integers(1, 6))
    cuts = sorted(rng.choice(np.arange(1, m), ncuts, replace=False).tolist())
    flush_at = set(rng.integers(0, ncuts + 1, 2).tolist())
    sp = _feed_partitioned(_tstream(8, chunk=16), series, cuts, flush_at)
    got = _stream_vs_batch(sp, series)
    if seed == 0:
        _same(got, _feed_partitioned(JStreamProfile(8, chunk=16), series,
                                     cuts, flush_at).results())


def test_stream_profile_peek_is_stable(rng):
    series = rng.integers(-20, 20, 77).astype(np.int32)
    sp = _tstream(8, chunk=16)
    sp.feed(series[:50])
    a = sp.results()
    b = sp.results()
    _same(a, b)
    sp.feed(series[50:])
    _stream_vs_batch(sp, series)


def test_stream_profile_vs_oracle(rng):
    """Per-sample feeding against the brute-force banned-column oracle."""
    series = rng.integers(-15, 15, 59).astype(np.int32)
    sp = _tstream(6, chunk=16)
    for x in series:
        sp.feed(np.asarray([x], np.int32))
    assert_profile_matches_oracle(sp.results(), series)


def test_stream_profile_validates():
    sp = _tstream(4, chunk=16)
    with pytest.raises(ValueError, match="1-D"):
        sp.feed(np.zeros((2, 2), np.int32))
    sp.feed(np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="dtype"):
        sp.feed(np.zeros(4, np.float32))
    for kw in (dict(window=0), dict(window=4, stride=0),
               dict(window=4, k=0), dict(window=4, excl_zone=-1)):
        with pytest.raises(ValueError) as want:
            JStreamProfile(**kw)
        with pytest.raises(ValueError) as got:
            _tstream(**kw)
        assert str(got.value) == str(want.value)


def test_stream_profile_empty_and_short():
    sp = _tstream(8, chunk=16)
    res = sp.results()
    assert res.starts.shape == (0,)
    assert res.motifs == [] and res.discords == []
    _same(res, JStreamProfile(8, chunk=16).results())
    sp.feed(np.arange(5, dtype=np.int32))
    assert sp.results().starts.shape == (0,)
    assert sp.windows_admitted == 0


# ---------------------------------------------------------------------------
# The card's route (the kernel with its column ban) through the kernel's
# plain version: the same profiles bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prune", [False, True])
def test_profile_through_the_kernel_route(prune, rng, monkeypatch):
    """``engine_impl='auto'`` as on the card: every batch scores through
    the kernel's last-row capture with each window's band as its ban —
    bitwise the row-scan profile, pruning counters included."""
    import repro_torch.kernels.sdtw.ops as ops
    import repro_torch.search.search as search_mod
    series = rng.integers(-30, 30, 120).astype(np.int32)
    kw = dict(stride=3, prune=prune, chunk=16, batch=9, k=2)
    want = _tprofile(series, 8, **kw)
    banned = []
    plain = ops.sdtw_kernel_plain
    monkeypatch.setattr(search_mod, "_auto_engine", lambda dev: "pallas")
    monkeypatch.setattr(ops, "sdtw_kernel_plain", lambda *a: (
        banned.append(a[-1] is not None), plain(*a))[1])
    _same(_tprofile(series, 8, **kw), want)
    assert banned and all(banned)


@pytest.mark.parametrize("budget", [None, 10])
def test_profile_kernel_route_default_batch(budget, rng, monkeypatch):
    """The exact profile on the kernel route at the default ``batch``:
    38 windows in one batch, or (a budget of 10 windows) 4 batches of
    10, 10, 10 and 8 — one ``repro_torch.profile.batch`` span each,
    bitwise the ``batch=3`` profile on every field but the chunk
    counters (summed over batches), and every field of the reference's
    at the same batch."""
    import repro_torch.search.search as search_mod
    from test_torch_obs import traced
    series = rng.integers(-30, 30, 120).astype(np.int32)
    kw = dict(stride=3, prune=False, chunk=16, k=2)
    nw = (120 - 8) // 3 + 1
    if budget is not None:
        monkeypatch.setattr(profile_mod, "BATCH_BUDGET_BYTES",
                            budget * _WINDOW_BYTES)
    monkeypatch.setattr(search_mod, "_auto_engine", lambda dev: "pallas")
    small = _tprofile(series, 8, batch=3, **kw)
    got, spans = traced(lambda: _tprofile(series, 8, **kw))
    b = profile_batch(nw, 8, 16, exact_kernel=True)
    assert b == (nw if budget is None else 10)
    assert [s[0] for s in spans].count(
        "repro_torch.profile.batch") == -(-nw // b)
    for f in FIELDS:
        if not f.startswith("chunks_"):
            np.testing.assert_array_equal(getattr(got, f), getattr(small, f),
                                          err_msg=f)
    _same(got, jprofile(series, 8, batch=b, **kw))


def test_stream_profile_through_the_kernel_route(rng):
    """``StreamProfile``'s card step (one kernel launch with the ban,
    folded into the k = 1 heap) through the plain version: the same
    profile as the row-scan step, with a mid-stream flush and growth past
    the first capacity."""
    series = rng.integers(-20, 20, 160).astype(np.int32)
    sp = _tstream(6, stride=2, chunk=16, k=2)
    sp._kernel = True
    _feed_partitioned(sp, series, [37, 90], flush_at={1})
    assert sp.windows_admitted > 16
    _stream_vs_batch(sp, series, stride=2)
