"""The serving tier on the card: served answers against offline calls.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_serve_cuda.py``. Imports no JAX. Clients submit the
same seeded inputs to a ``Router`` on the card and call the offline
front doors on the card themselves; every served int32 answer equals the
offline one bitwise.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.search import search_topk
from repro_torch.serve import Router, RouterConfig
from repro_torch.tune import cache_keys, clear_tuning_cache

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _same(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.device.type == want.device.type == "cuda"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("devices", [None, "all", ["cuda:0", "cuda:0"]])
@pytest.mark.parametrize("kw", [dict(), dict(return_spans=True),
                                dict(top_k=2)])
def test_served_window_equals_offline_on_the_card(cuda, devices, kw):
    rng = np.random.default_rng(11)
    r = rng.integers(-40, 40, 5000).astype(np.int32)
    clients = [rng.integers(-40, 40, (nq, n)).astype(np.int32)
               for nq, n in ((64, 120), (32, 120), (8, 100), (16, 300))]
    with Router(RouterConfig(auto_dispatch=False, devices=devices)) as rt:
        futs = [rt.submit(queries=q, reference=r, **kw) for q in clients]
        rt.drain()
        assert rt.stats().dispatches == 1
        for q, f in zip(clients, futs):
            _same(f.result(timeout=60), engine.sdtw(q, r, **kw))


def test_concurrent_clients_on_the_card(cuda):
    """Client threads through the auto-dispatching router, queries and
    the reference on the card: fewer dispatches than requests, every
    answer bitwise the client's own offline call."""
    rng = np.random.default_rng(12)
    ref = torch.as_tensor(rng.integers(-40, 40, 8000).astype(np.int32),
                          device=cuda)
    clients = [torch.as_tensor(rng.integers(-40, 40, (256, 120)).astype(
        np.int32), device=cuda) for _ in range(16)]
    results = [None] * len(clients)
    with Router(window_ms=20.0, window_full_queries=2048) as rt:
        rt.warmup(queries=clients[0], reference=ref, ref_key="feed")

        def worker(i):
            results[i] = rt.sdtw(clients[i], ref, ref_key="feed")
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(clients))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = rt.stats()
    assert stats.completed == len(clients) and stats.errors == 0
    assert stats.dispatches < len(clients)
    for q, got in zip(clients, results):
        _same(got, engine.sdtw(q, ref))


def test_served_search_and_stream_on_the_card(cuda):
    rng = np.random.default_rng(13)
    r = rng.integers(-40, 40, 20000).astype(np.int32)
    qa = [rng.integers(-40, 40, 64).astype(np.int32) for _ in range(3)]
    qb = [rng.integers(-40, 40, 64).astype(np.int32) for _ in range(2)]
    with Router(RouterConfig(auto_dispatch=False)) as rt:
        fa = rt.submit(queries=qa, reference=r, op="search_topk", top_k=3,
                       ref_key="feed")
        fb = rt.submit(queries=qb, reference=r, op="search_topk", top_k=3,
                       ref_key="feed")
        rt.drain()
        want = search_topk(qa + qb, r, 3, ref_key="feed", cache=rt.cache)
        got = torch.cat([fa.result(timeout=60).distances,
                         fb.result(timeout=60).distances])
        _same(got, want.distances)
        q = rng.integers(-40, 40, (4, 64)).astype(np.int32)
        rt.open_stream("sensor", "t0", queries=q, top_k=2)
        for i in range(0, len(r), 3000):
            rt.feed("sensor", r[i:i + 3000])
        res = rt.sessions.finalize("sensor")["t0"]
        d, p = engine.sdtw(q, r, top_k=2)
        for got, want in ((res.distances, d), (res.positions, p)):
            want = want.cpu().numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_warmup_pretunes_on_the_card(cuda):
    clear_tuning_cache()
    rng = np.random.default_rng(14)
    r = rng.integers(-40, 40, 3000).astype(np.int32)
    qs = [rng.integers(-40, 40, n).astype(np.int32) for n in (30, 100, 500)]
    with Router(auto_dispatch=False, devices="all") as rt:
        assert rt.warmup(queries=qs, reference=r) == torch.cuda.device_count()
        assert any(k[0].startswith("h100/") for k in cache_keys())
        fut = rt.submit(queries=qs, reference=r)
        rt.drain()
        _same(fut.result(timeout=60), engine.sdtw(qs, r))
