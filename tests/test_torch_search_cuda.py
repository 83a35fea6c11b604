"""Pruned search and alignment on the card: the kernel route against the
plain route on the same card.

Runs only where a CUDA device is present (the ``cuda`` marker; the
fixture skips elsewhere): ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_search_cuda.py``. Imports no JAX. The same inputs, made
from a numpy seed, go through ``search_topk(engine_impl='pallas')`` — the
hand-written kernel's last-row capture — and ``engine_impl='rowscan'``
(the plain PyTorch row scan) on the card; ``align`` runs the kernel's
span variant on the card and its plain version on the CPU.

Tolerances: int32 bitwise — heaps, starts, positions, pruning counters,
paths. The float32 case is integer-valued, so it is bitwise too.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.traceback import check_path, path_cost
from repro_torch.kernels.sdtw import (LAUNCHES, choose_kernel, reset_launches,
                                      tuned_launch)
from repro_torch.kernels.sdtw.ops import sm_count
from repro_torch.search import search_topk

pytestmark = pytest.mark.cuda
FIELDS = ("distances", "positions", "starts")
COUNTERS = ("chunks_total", "chunks_pruned_kim", "chunks_pruned_keogh",
            "chunks_processed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _same(got, want):
    for f in FIELDS:
        g, w = getattr(got, f).cpu(), getattr(want, f).cpu()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f)
    assert ([getattr(got, c) for c in COUNTERS]
            == [getattr(want, c) for c in COUNTERS])


def level_shifted(rng, m, seg, dtype=np.int32):
    levels = rng.integers(-1500, 1500, -(-m // seg))
    return np.concatenate([lvl + rng.normal(0, 40, seg)
                           for lvl in levels])[:m].astype(dtype)


CASES = [  # (nq, n, m, seg, k, chunk, prune, excl_mode, metric, dtype)
    (5, 24, 3000, 300, 3, 128, True, "end", "abs_diff", np.int32),
    (5, 24, 3000, 300, 3, 128, False, "end", "abs_diff", np.int32),
    (4, 40, 2500, 500, 2, None, True, "span", "square_diff", np.int32),
    (3, 120, 8000, 1000, 3, 1024, True, "end", "abs_diff", np.int32),
    (6, 17, 1500, 150, 4, 64, True, "end", "abs_diff", np.float32),
    (2, 1600, 2500, 1000, 2, 1024, True, "end", "abs_diff", np.int32),
]


@pytest.mark.parametrize("case", CASES, ids=[
    f"n{c[1]}-m{c[2]}-k{c[4]}-{'pruned' if c[6] else 'exact'}-{c[7]}-"
    f"{c[8]}-{np.dtype(c[9]).name}" for c in CASES])
def test_search_kernel_route_equals_plain_route(case, cuda):
    nq, n, m, seg, k, chunk, prune, mode, metric, dtype = case
    rng = np.random.default_rng(n * 7 + m)
    ref = level_shifted(rng, m, seg, dtype)
    starts = rng.integers(0, m - n, nq)
    q = np.stack([ref[s:s + n] for s in starts])
    q[1:] += rng.integers(-3, 4, (nq - 1, n)).astype(dtype)
    kw = dict(k=k, chunk=chunk, prune=prune, excl_mode=mode, metric=metric,
              device=cuda)
    reset_launches()
    got = search_topk(q, ref, engine_impl="pallas", **kw)
    torch.cuda.synchronize()
    kernel = choose_kernel(n, "auto", nq, sm_count(0))
    assert kernel == ("rows" if n <= 120 else "chain")
    assert LAUNCHES[f"{kernel}_lastrow"] >= 1, LAUNCHES
    assert sum(LAUNCHES.values()) == LAUNCHES[f"{kernel}_lastrow"]
    reset_launches()
    want = search_topk(q, ref, engine_impl="rowscan", **kw)
    assert sum(LAUNCHES.values()) == 0, "the plain route launched a kernel"
    _same(got, want)
    assert got.distances.device.type == "cuda"
    if prune and n <= 120:
        exact = engine.sdtw(q, ref, metric=metric, device=cuda)
        np.testing.assert_array_equal(got.distances[:, 0].cpu().numpy(),
                                      exact.cpu().numpy())


def test_search_auto_takes_the_kernel_on_the_card(cuda):
    """``engine_impl='auto'`` on the card is the kernel, for a padded
    batch and a ragged list; exclusion ranges take the kernel too, as its
    column ban, and equal the rowscan route."""
    rng = np.random.default_rng(3)
    ref = level_shifted(rng, 2000, 250)
    q = np.stack([ref[100:132], ref[900:932]])
    reset_launches()
    auto = search_topk(q, ref, k=2, chunk=128, device=cuda)
    assert LAUNCHES["rows_lastrow"] >= 1
    _same(auto, search_topk(q, ref, k=2, chunk=128, engine_impl="pallas",
                            device=cuda))
    reset_launches()
    ragged = search_topk([q[0, :20], q[1]], ref, k=2, chunk=128,
                         device=cuda)
    assert LAUNCHES["rows_lastrow"] >= 1
    _same(ragged, search_topk([q[0, :20], q[1]], ref, k=2, chunk=128,
                              engine_impl="rowscan", device=cuda))
    reset_launches()
    excl = dict(excl_lo=np.array([0, 880]), excl_hi=np.array([150, 950]))
    banned = search_topk(q, ref, k=2, chunk=128, device=cuda, **excl)
    assert LAUNCHES["rows_lastrow_ban"] >= 1
    assert sum(LAUNCHES.values()) == LAUNCHES["rows_lastrow_ban"]
    _same(banned, search_topk(q, ref, k=2, chunk=128, engine_impl="rowscan",
                              device=cuda, **excl))


@pytest.mark.parametrize("n", [7, 120, 512])
def test_align_on_the_card_equals_cpu(n, cuda):
    """``align`` on the card launches the span variant and traces back the
    paths the CPU run (the plain version) traces; each path replays its
    distance."""
    rng = np.random.default_rng(n)
    ref = rng.integers(-50, 50, 4 * n + 200).astype(np.int32)
    q = rng.integers(-50, 50, (4, n)).astype(np.int32)
    q[0] = ref[100:100 + n]
    reset_launches()
    got = engine.align(q, ref, device=cuda)
    kernel = tuned_launch(4, n, len(ref), sms=sm_count(), variant="span",
                          tune="model")[0]["kernel"]    # align's default
    assert LAUNCHES[f"{kernel}_span"] >= 1, LAUNCHES
    want = engine.align(q, ref, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.distance, g.start, g.end) == (w.distance, w.start, w.end)
        np.testing.assert_array_equal(g.path, w.path)
        assert check_path(g.path, g.start, g.end, n)
        assert path_cost(q[i], ref, g.path) == g.distance
    assert (got[0].distance, got[0].start) == (0, 100)
