"""The port's serving tier on the CPU, against offline calls of the port
and of the JAX package.

Mirrors ``tests/test_serve.py`` test for test, with every request on
``device="cpu"`` (the plain PyTorch versions) and CPU worker bindings.
The load-bearing gate: for any interleaving of concurrent clients, the
router's answers are bitwise int32-identical to the port's offline
calls — and so to ``repro.core.engine.sdtw`` on the same numpy inputs —
so coalescing, pooling, priority scheduling and in-window dedup are
invisible to every tenant.
"""
import concurrent.futures
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro_torch.core import engine
from repro_torch.core.request import SdtwRequest
from repro_torch.search import search_topk
from repro_torch.serve import (AdmissionQueue, DevicePool, QueueFull, Router,
                               RouterConfig, StreamSessionPool, Telemetry)
from repro_torch.serve import batcher

CPU = "cpu"


def _mk(rng, nq, n, m=300):
    q = rng.integers(-40, 40, (nq, n)).astype(np.int32)
    r = rng.integers(-40, 40, m).astype(np.int32)
    return q, r


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


def _offline(q, r, **kw):
    return engine.sdtw(q, r, device=CPU, **kw)


def _reference(q, r, **kw):
    conv = (lambda x: [jnp.asarray(y) for y in x]
            if isinstance(x, list) else jnp.asarray(x))
    return jengine.sdtw(conv(q), jnp.asarray(r), **kw)


def _router(**kw):
    return Router(RouterConfig(**{"auto_dispatch": False, **kw}))


# ---------------------------------------------------------------------------
# coalescing == offline, bitwise
# ---------------------------------------------------------------------------

def test_coalesced_window_equals_offline_per_client(rng):
    r = rng.integers(-40, 40, 300).astype(np.int32)
    clients = [rng.integers(-40, 40, (nq, 12)).astype(np.int32)
               for nq in (2, 3, 1, 4)]
    router = _router()
    kw = dict(top_k=2, excl_zone=4, return_spans=True)
    futs = [router.submit(queries=q, reference=r, device=CPU, **kw)
            for q in clients]
    assert router.drain() == len(clients)
    stats = router.stats()
    assert stats.dispatches == 1
    assert stats.mean_batch_requests == len(clients)
    for q, f in zip(clients, futs):
        got = f.result(timeout=0)
        _equal(got, _offline(q, r, **kw))
        _equal(got, _reference(q, r, **kw))
    router.close()


def test_concurrent_clients_bitwise_and_counted(rng):
    r = rng.integers(-40, 40, 256).astype(np.int32)
    clients = [rng.integers(-40, 40, (2, 10)).astype(np.int32)
               for _ in range(6)]
    results = [None] * len(clients)
    with Router(window_ms=5.0) as router:
        def worker(i):
            results[i] = router.sdtw(clients[i], r, device=CPU)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(clients))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = router.stats()
    assert stats.completed == len(clients)
    assert stats.errors == 0
    assert stats.dispatches <= len(clients)
    for q, got in zip(clients, results):
        _equal(got, _offline(q, r))
        _equal(got, _reference(q, r))


def test_single_query_clients_unwrap_like_offline(rng):
    r = rng.integers(-40, 40, 200).astype(np.int32)
    qs = [rng.integers(-40, 40, n).astype(np.int32) for n in (7, 12, 9)]
    router = _router()
    futs = [router.submit(queries=q, reference=r, device=CPU) for q in qs]
    router.drain()
    assert router.stats().dispatches == 1
    for q, f in zip(qs, futs):
        got = f.result(timeout=0)
        assert tuple(got.shape) == ()
        _equal(got, _offline(q, r))
        _equal(got, _reference(q, r))
    router.close()


def test_search_coalescing_equals_offline_batched(rng):
    r = rng.integers(-40, 40, 600).astype(np.int32)
    qa = [rng.integers(-40, 40, 16).astype(np.int32) for _ in range(2)]
    qb = [rng.integers(-40, 40, 16).astype(np.int32) for _ in range(3)]
    router = _router()
    fa = router.submit(queries=qa, reference=r, op="search_topk", top_k=2,
                       ref_key="feed", device=CPU)
    fb = router.submit(queries=qb, reference=r, op="search_topk", top_k=2,
                       ref_key="feed", device=CPU)
    router.drain()
    assert router.stats().dispatches == 1
    want = search_topk(qa + qb, r, 2, ref_key="feed", cache=router.cache,
                       device=CPU)
    for f in ("distances", "positions", "starts"):
        merged = torch.cat([getattr(fa.result(timeout=0), f),
                            getattr(fb.result(timeout=0), f)])
        _equal(merged, getattr(want, f))
    router.close()


def test_incompatible_requests_do_not_coalesce(rng):
    """Different semantics (metric), references or devices split."""
    q, r = _mk(rng, 2, 8)
    r2 = rng.integers(-40, 40, 300).astype(np.int32)
    router = _router()
    f1 = router.submit(queries=q, reference=r, device=CPU)
    f2 = router.submit(queries=q, reference=r, metric="square_diff",
                       device=CPU)
    f3 = router.submit(queries=q, reference=r2, device=CPU)
    router.drain()
    assert router.stats().dispatches == 3
    _equal(f1.result(timeout=0), _reference(q, r))
    _equal(f2.result(timeout=0), _reference(q, r, metric="square_diff"))
    _equal(f3.result(timeout=0), _reference(q, r2))
    a = SdtwRequest(queries=q, reference=r, device=CPU)
    b = SdtwRequest(queries=q, reference=r, device="meta")
    assert "cpu" in a.coalesce_key("r")
    assert a.coalesce_key("r") != b.coalesce_key("r")
    router.close()


def test_per_query_exclusion_arrays_never_coalesce(rng):
    r = rng.integers(-40, 40, 200).astype(np.int32)
    q1 = rng.integers(-40, 40, (2, 8)).astype(np.int32)
    q2 = rng.integers(-40, 40, (2, 8)).astype(np.int32)
    lo, hi = np.array([3, 5]), np.array([9, 12])
    router = _router()
    f1 = router.submit(queries=q1, reference=r, excl_lo=lo, excl_hi=hi,
                       device=CPU)
    f2 = router.submit(queries=q2, reference=r, excl_lo=lo, excl_hi=hi,
                       device=CPU)
    router.drain()
    assert router.stats().dispatches == 2
    for q, f in ((q1, f1), (q2, f2)):
        _equal(f.result(timeout=0),
               _reference(q, r, excl_lo=jnp.asarray(lo),
                          excl_hi=jnp.asarray(hi)))
    router.close()


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_backpressure_reject_policy(rng):
    q, r = _mk(rng, 1, 6)
    router = _router(max_queue=2, admission="reject")
    router.submit(queries=q, reference=r, device=CPU)
    router.submit(queries=q, reference=r, device=CPU)
    with pytest.raises(QueueFull, match="full"):
        router.submit(queries=q, reference=r, device=CPU)
    assert router.stats().rejected == 1
    router.drain()
    assert router.stats().completed == 2
    router.close()


def test_backpressure_block_timeout(rng):
    q, r = _mk(rng, 1, 6)
    router = _router(max_queue=1, admission="block", block_timeout_s=0.05)
    router.submit(queries=q, reference=r, device=CPU)
    with pytest.raises(QueueFull, match="blocking"):
        router.submit(queries=q, reference=r, device=CPU)
    router.drain()
    router.close()


def test_invalid_requests_refused_at_the_door(rng):
    q, r = _mk(rng, 2, 6)
    router = _router()
    with pytest.raises(ValueError) as served:
        router.submit(queries=q, reference=r, excl_lo=5, device=CPU)
    with pytest.raises(ValueError) as offline:
        _offline(q, r, excl_lo=5)
    with pytest.raises(ValueError) as ref:
        _reference(q, r, excl_lo=5)
    assert str(served.value) == str(offline.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown SdtwRequest argument"):
        router.submit(queries=q, reference=r, topk=2)
    assert router.drain() == 0
    router.close()


def test_execution_errors_propagate_to_every_member(rng):
    q, r = _mk(rng, 2, 8)
    router = _router()
    bad = np.zeros((2, 2, 2), np.int32)
    f1 = router.submit(queries=bad, reference=r, device=CPU)
    router.drain()
    with pytest.raises(Exception):
        f1.result(timeout=0)
    assert router.stats().errors == 1
    router.close()


# ---------------------------------------------------------------------------
# shared state across tenants
# ---------------------------------------------------------------------------

def test_envelope_cache_shared_across_tenants(rng):
    q, r = _mk(rng, 2, 16, m=600)
    router = _router()
    for _ in range(2):
        f = router.submit(queries=q, reference=r, op="search_topk",
                          top_k=1, ref_key="shared-feed", device=CPU)
        router.drain()
        f.result(timeout=0)
    assert router.cache.hits >= 1
    router.close()


def test_session_pool_churn_and_snapshot_restore(rng):
    ref = rng.integers(-40, 40, 512).astype(np.int32)
    qa = rng.integers(-40, 40, (2, 16)).astype(np.int32)
    qb = rng.integers(-40, 40, (3, 16)).astype(np.int32)
    qc = rng.integers(-40, 40, (1, 16)).astype(np.int32)
    kw = dict(chunk=64, top_k=2, device=CPU)

    pool = StreamSessionPool()
    pool.attach("feed", "a", queries=qa, **kw)
    pool.attach("feed", "b", queries=qb, **kw)
    for i in range(0, 256, 128):
        assert pool.feed("feed", ref[i:i + 128]) == 2
    pool.attach("feed", "c", queries=qc, **kw)
    with pytest.raises(ValueError, match="already attached"):
        pool.attach("feed", "a", queries=qa, **kw)
    res_b = pool.detach("feed", "b")
    db, _ = _reference(qb, ref[:256], top_k=2, chunk=64)
    _equal(res_b.distances, db)

    snaps = pool.snapshot("feed")
    assert sorted(snaps) == ["a", "c"]
    pool.feed("feed", ref[256:])
    live = pool.finalize("feed")
    pool.restore("feed-replay", snaps, device=CPU)
    pool.feed("feed-replay", ref[256:])
    replay = pool.finalize("feed-replay")
    for t in ("a", "c"):
        _equal(live[t].distances, replay[t].distances)
    da, _ = _reference(qa, ref, top_k=2, chunk=64)
    _equal(live["a"].distances, da)
    dc, _ = _reference(qc, ref[256:], top_k=2, chunk=64)
    _equal(live["c"].distances, dc)


# ---------------------------------------------------------------------------
# lifecycle regressions: once admitted, always answered
# ---------------------------------------------------------------------------

def test_close_without_drain_fails_queued_futures(rng):
    q, r = _mk(rng, 2, 8)
    router = _router()
    futs = [router.submit(queries=q, reference=r, device=CPU)
            for _ in range(3)]
    router.close(drain=False)
    for f in futs:
        with pytest.raises(RuntimeError,
                           match="router closed before dispatch"):
            f.result(timeout=1.0)
    stats = router.stats()
    assert stats.unserved_on_close == 3
    assert stats.completed == 0


def test_cancelled_future_does_not_poison_group(rng):
    r = rng.integers(-40, 40, 300).astype(np.int32)
    clients = [rng.integers(-40, 40, (2, 10)).astype(np.int32)
               for _ in range(3)]
    router = _router()
    futs = [router.submit(queries=q, reference=r, device=CPU)
            for q in clients]
    assert futs[1].cancel()
    router.drain()
    for i in (0, 2):
        _equal(futs[i].result(timeout=0), _reference(clients[i], r))
    stats = router.stats()
    assert stats.cancelled == 1
    assert stats.errors == 0
    assert stats.completed == 2
    router.close()


def test_cancelled_mid_window_under_load(rng):
    r = rng.integers(-40, 40, 256).astype(np.int32)
    clients = [rng.integers(-40, 40, (1, 8 + i)).astype(np.int32)
               for i in range(8)]
    with Router(window_ms=20.0) as router:
        futs = [router.submit(queries=q, reference=r, device=CPU)
                for q in clients]
        cancelled = [f.cancel() for f in futs[::2]]
        for i, f in enumerate(futs):
            if i % 2 == 0 and cancelled[i // 2]:
                assert f.cancelled()
                continue
            _equal(f.result(timeout=30.0), _offline(clients[i], r))


def test_telemetry_bounded_ring():
    from repro_torch.serve import RequestTrace
    tel = Telemetry(window=16)
    for _ in range(100):
        t = RequestTrace(op="sdtw", nq=2)
        t.mark_dispatch(batch_requests=1, batch_queries=2)
        t.mark_complete()
        tel.record_complete(t)
    snap = tel.snapshot()
    assert snap.completed == 100
    assert snap.queries_served == 200
    assert snap.latency_samples == 16
    assert snap.sample_window == 16
    assert np.isfinite(snap.p50_latency_us)
    assert np.isfinite(snap.mean_latency_us)
    with pytest.raises(ValueError, match="window"):
        Telemetry(window=0)


def test_submit_vs_close_race_every_future_answered(rng):
    q, r = _mk(rng, 1, 6)
    want = _offline(q, r)
    futs, errs, lock = [], [], threading.Lock()
    router = Router(RouterConfig(window_ms=1.0, max_queue=8,
                                 admission="reject"))

    def submitter():
        for _ in range(10):
            try:
                f = router.submit(queries=q, reference=r, device=CPU)
                with lock:
                    futs.append(f)
            except (QueueFull, RuntimeError) as e:
                with lock:
                    errs.append(e)

    threads = [threading.Thread(target=submitter) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    router.close(drain=False)
    for t in threads:
        t.join(timeout=60)
    answered = 0
    for f in futs:
        try:
            _equal(f.result(timeout=30.0), want)
            answered += 1
        except (QueueFull, RuntimeError, concurrent.futures.CancelledError):
            pass
    stats = router.stats()
    assert answered == stats.completed
    assert stats.completed + stats.unserved_on_close \
        + stats.shed + len(errs) >= len(futs) + len(errs)


# ---------------------------------------------------------------------------
# priorities, quotas, aging, shedding
# ---------------------------------------------------------------------------

def test_priority_drain_order_strict():
    q = AdmissionQueue(8, aging_s=None)
    q.put("lo", priority=0)
    q.put("hi", priority=5)
    q.put("mid", priority=2)
    q.put("hi2", priority=5)
    assert q.drain() == ["hi", "hi2", "mid", "lo"]


def test_priority_aging_admits_starved_tenants():
    q = AdmissionQueue(8, aging_s=0.01)
    q.put("starved-lo", priority=0)
    time.sleep(0.06)
    q.put("fresh-hi", priority=3)
    assert q.drain() == ["starved-lo", "fresh-hi"]
    q2 = AdmissionQueue(8, aging_s=None)
    q2.put("lo", priority=0)
    time.sleep(0.02)
    q2.put("hi", priority=3)
    assert q2.drain() == ["hi", "lo"]


def test_tenant_quota_rejects_overrun(rng):
    q, r = _mk(rng, 1, 6)
    router = _router(tenant_quota=2)
    router.submit(queries=q, reference=r, tenant="greedy", device=CPU)
    router.submit(queries=q, reference=r, tenant="greedy", device=CPU)
    with pytest.raises(QueueFull, match="quota"):
        router.submit(queries=q, reference=r, tenant="greedy", device=CPU)
    router.submit(queries=q, reference=r, tenant="other", device=CPU)
    assert router.stats().rejected == 1
    router.drain()
    assert router.stats().completed == 3
    router.close()


def test_reject_shed_lowest_priority_first(rng):
    q, r = _mk(rng, 1, 6)
    router = _router(max_queue=2, admission="reject", aging_s=None)
    f_old = router.submit(queries=q, reference=r, priority=0, device=CPU)
    f_new = router.submit(queries=q, reference=r, priority=0, device=CPU)
    f_hi = router.submit(queries=q, reference=r, priority=5, device=CPU)
    with pytest.raises(QueueFull, match="shed"):
        f_new.result(timeout=1.0)
    with pytest.raises(QueueFull, match="full"):
        router.submit(queries=q, reference=r, priority=0, device=CPU)
    router.drain()
    want = _reference(q, r)
    _equal(f_old.result(timeout=0), want)
    _equal(f_hi.result(timeout=0), want)
    stats = router.stats()
    assert stats.shed == 1 and stats.rejected == 1
    assert stats.completed == 2
    router.close()


def test_reject_storm_under_priority_shed_accounting(rng):
    q, r = _mk(rng, 1, 6)
    want = _offline(q, r)
    router = _router(max_queue=4, admission="reject", aging_s=None)
    futs, sync_rejects, lock = [], [0], threading.Lock()
    stop = threading.Event()

    def drainer():
        while not stop.is_set():
            router.drain()
            time.sleep(0.002)
        router.drain()

    def submitter(prio):
        for _ in range(12):
            try:
                f = router.submit(queries=q, reference=r, priority=prio,
                                  device=CPU)
                with lock:
                    futs.append(f)
            except QueueFull:
                with lock:
                    sync_rejects[0] += 1

    d = threading.Thread(target=drainer)
    d.start()
    threads = [threading.Thread(target=submitter, args=(p,))
               for p in (0, 1, 2, 0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    d.join(timeout=60)
    assert not d.is_alive()
    completed = shed = 0
    for f in futs:
        try:
            _equal(f.result(timeout=30.0), want)
            completed += 1
        except QueueFull:
            shed += 1
    stats = router.stats()
    assert completed + shed + sync_rejects[0] == 4 * 12
    assert stats.completed == completed
    assert stats.shed == shed
    assert stats.rejected == sync_rejects[0]
    router.close()


# ---------------------------------------------------------------------------
# in-window dedup
# ---------------------------------------------------------------------------

def test_dedup_identical_requests_share_call_and_result(rng):
    r = rng.integers(-40, 40, 300).astype(np.int32)
    q = rng.integers(-40, 40, (2, 12)).astype(np.int32)
    other = rng.integers(-40, 40, (3, 12)).astype(np.int32)
    router = _router()
    f1 = router.submit(queries=q, reference=r, ref_key="feed", device=CPU)
    f2 = router.submit(queries=torch.as_tensor(q.copy()), reference=r,
                       ref_key="feed", device=CPU)
    f3 = router.submit(queries=other, reference=r, ref_key="feed",
                       device=CPU)
    router.drain()
    stats = router.stats()
    assert stats.dispatches == 1
    assert stats.deduped == 1
    assert stats.completed == 3
    g1, g2 = f1.result(timeout=0), f2.result(timeout=0)
    assert g1 is g2
    _equal(g1, _reference(q, r))
    _equal(f3.result(timeout=0), _reference(other, r))
    router.close()


def test_dedup_respects_content_and_shape(rng):
    r = rng.integers(-40, 40, 200).astype(np.int32)
    q1 = rng.integers(-40, 40, (1, 8)).astype(np.int32)
    q2 = q1 + 1
    router = _router()
    fa = router.submit(queries=q1, reference=r, ref_key="k", device=CPU)
    fb = router.submit(queries=q2, reference=r, ref_key="k", device=CPU)
    fc = router.submit(queries=q1[0], reference=r, ref_key="k", device=CPU)
    router.drain()
    assert router.stats().deduped == 0
    _equal(fa.result(timeout=0), _reference(q1, r))
    _equal(fb.result(timeout=0), _reference(q2, r))
    got_c = fc.result(timeout=0)
    assert tuple(got_c.shape) == ()
    _equal(got_c, _reference(q1[0], r))
    router.close()


def test_dedup_can_be_disabled(rng):
    q, r = _mk(rng, 2, 8)
    router = _router(dedup=False)
    f1 = router.submit(queries=q, reference=r, device=CPU)
    f2 = router.submit(queries=q.copy(), reference=r, device=CPU)
    router.drain()
    assert router.stats().deduped == 0
    assert f1.result(timeout=0) is not f2.result(timeout=0)
    _equal(f1.result(timeout=0), f2.result(timeout=0))
    router.close()


# ---------------------------------------------------------------------------
# device pool
# ---------------------------------------------------------------------------

def test_device_pool_bitwise_equal_to_single_device_drain(rng):
    r = rng.integers(-40, 40, 300).astype(np.int32)
    clients = [rng.integers(-40, 40, (nq, 10 + nq)).astype(np.int32)
               for nq in (1, 2, 3, 4, 2)]

    def serve_all(devices):
        router = _router(devices=devices)
        futs = [router.submit(queries=q, reference=r, metric=m, device=CPU)
                for q in clients for m in ("abs_diff", "square_diff")]
        router.drain()
        out = [f.result(timeout=0) for f in futs]
        router.close()
        return out

    single = serve_all(None)
    pooled = serve_all([CPU, CPU, CPU])
    for s, p in zip(single, pooled):
        _equal(s, p)
    for (q, m), s in zip([(q, m) for q in clients
                          for m in ("abs_diff", "square_diff")], single):
        _equal(s, _reference(q, r, metric=m))


def test_device_pool_resolution_and_lifecycle():
    """``'all'`` and an int name CUDA devices: without a card they raise,
    as ``resolve_device`` does (no CPU fallback); CPU bindings are
    explicit."""
    with DevicePool(None) as pool:
        assert pool.size == 1 and pool.devices == [None]
    with DevicePool([CPU, "cpu"]) as pool:
        assert pool.size == 2
        assert pool.devices == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        for devices in ("all", 1):
            with pytest.raises(RuntimeError, match="CUDA device"):
                DevicePool(devices)
    with pytest.raises(ValueError, match="at least one"):
        DevicePool([])
    pool = DevicePool(None)
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit([], None)


def test_device_pool_affinity_policy():
    from repro_torch.serve.pool import pick_device
    assert pick_device([0, 0, 0], ()) == 0
    assert pick_device([2, 1, 2], ()) == 1
    assert pick_device([0, 0, 0], {1}) == 1
    assert pick_device([1, 0, 1], {1, 2}) == 1
    assert pick_device([1, 0, 0], {0}) == 0
    assert pick_device([2, 0, 0], {0}) == 1
    assert pick_device([0, 2, 2], {1, 2}) == 0
    assert pick_device([3, 4, 3], {1, 2}) == 2
    assert pick_device([9, 2, 2], {1}) == 1
    assert pick_device([2, 0, 0], {0}, growing=True) == 0
    assert pick_device([0, 2, 2], {1, 2}, growing=True) == 1


def test_router_warmup_primes_every_device(rng):
    from repro_torch.serve import pool as pool_mod
    pool_mod.clear_affinity_cache()
    r = rng.integers(-40, 40, 256).astype(np.int32)
    qs = [rng.integers(-40, 40, 16).astype(np.int32) for _ in range(4)]
    with Router(devices=[CPU, CPU], auto_dispatch=False) as router:
        assert router.warmup(queries=qs, reference=r, device=CPU) == 2
        req = SdtwRequest.from_kwargs(queries=qs, reference=r, device=CPU)
        shape = batcher.group_shape(
            [batcher.Pending(request=req, future=None, trace=None)])
        assert set(router._pool.devices) <= pool_mod._warm_devices[shape]
        fut = router.submit(queries=qs, reference=r, device=CPU)
        router.drain()
        _equal(fut.result(timeout=60), _reference(qs, r))
    pool_mod.clear_affinity_cache()


# ---------------------------------------------------------------------------
# adaptive window
# ---------------------------------------------------------------------------

def test_adaptive_window_closes_early_when_bucket_fills(rng):
    r = rng.integers(-40, 40, 200).astype(np.int32)
    q = rng.integers(-40, 40, (4, 8)).astype(np.int32)
    expect = _offline(q, r)
    with Router(window_ms=2000.0, window_full_queries=4) as router:
        t0 = time.monotonic()
        got = router.sdtw(q, r, device=CPU)
        elapsed = time.monotonic() - t0
        stats = router.stats()
    assert elapsed < 1.5, f"window did not close early ({elapsed:.2f}s)"
    assert stats.window_early_closes >= 1
    _equal(got, expect)


def test_queue_wait_weight_primitive():
    q = AdmissionQueue(8)
    q.put("a", weight=3)
    assert q.wait_weight(3, time.monotonic() + 5.0)
    assert not q.wait_weight(4, time.monotonic() + 0.02)
    assert q.pending_weight() == 3

    def late_put():
        time.sleep(0.02)
        q.put("b", weight=5)

    t = threading.Thread(target=late_put)
    t.start()
    assert q.wait_weight(8, time.monotonic() + 5.0)
    t.join(timeout=10)


def test_router_open_stream_and_stats(rng):
    ref = rng.integers(-40, 40, 256).astype(np.int32)
    q = rng.integers(-40, 40, (2, 8)).astype(np.int32)
    with _router() as router:
        router.open_stream("sensor", "t0", queries=q, chunk=32, top_k=2,
                           device=CPU)
        assert router.feed("sensor", ref) == 1
        res = router.sessions.finalize("sensor")["t0"]
        d, _ = _reference(q, ref, top_k=2, chunk=32)
        _equal(res.distances, d)
        snap = router.stats()
        assert snap.completed == snap.dispatches == 0


# ---------------------------------------------------------------------------
# where the data lives
# ---------------------------------------------------------------------------

def test_batcher_keys_tensors_without_reading_the_reference(rng):
    """The reference is keyed by ``ref_key`` or identity (plus shape,
    dtype and device) and never read; queries are flattened to host
    arrays (CPU tensors as views)."""
    q, r = _mk(rng, 3, 8)
    rt = torch.as_tensor(r)
    req = SdtwRequest(queries=torch.as_tensor(q), reference=rt,
                      ref_key="k", device=CPU)
    assert batcher.ref_fingerprint(req) == ("k", (300,), "int32", "cpu")
    anon = SdtwRequest(queries=q, reference=r, device=CPU)
    assert batcher.ref_fingerprint(anon) == (("id", id(r)), (300,),
                                             "int32", "host")
    entries, single = batcher.query_entries(req)
    assert not single and len(entries) == 3
    assert all(isinstance(e, np.ndarray) for e in entries)
    np.testing.assert_array_equal(np.stack(entries), q)
