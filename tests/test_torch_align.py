"""repro_torch's alignment (``engine.align`` and its traceback) against the
JAX package.

Mirrors the traceback cases of ``tests/test_spans_paths.py`` (lines
164-243). The port runs with ``device="cpu"``; ``impl='pallas'`` there
is the kernel's plain version (span variant). Inputs come from a numpy
seed. Tolerances: int32 bitwise — spans, paths and the replayed path
cost against the reported distance. The float32 inputs are
integer-valued, so float32 is bitwise too.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import sdtw_path

from repro.core import align as jalign
from repro.core import traceback as jtraceback
from repro.core.distances import INT_BIG
from repro_torch.core import engine as tengine
from repro_torch.core.traceback import (AlignResult, check_path, path_cost,
                                        traceback_path)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "sdtw_spans_v1.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def align(*a, **kw):
    return tengine.align(*a, device="cpu", **kw)


def _same_result(got, want):
    assert isinstance(got, AlignResult)
    assert (got.start, got.end) == (want.start, want.end)
    assert got.distance == want.distance
    assert np.asarray(got.distance).dtype == np.asarray(want.distance).dtype
    if want.path is None:
        assert got.path is None
    else:
        assert got.path.dtype == want.path.dtype
        np.testing.assert_array_equal(got.path, want.path)


@pytest.mark.parametrize("impl", ["auto", "pallas", "chunked"])
def test_align_replays_distance_bitwise(impl, rng):
    """align(): the recovered path is structurally valid, is the oracle's
    pinned-window traceback and the reference's path, and its cost
    reproduces the engine distance bitwise (int32 and float32)."""
    for dtype in (np.int32, np.float32):
        q = rng.integers(-10, 10, (3, 7)).astype(dtype)
        r = rng.integers(-10, 10, 80).astype(dtype)
        kw = dict(chunk=16) if impl == "chunked" else {}
        results = align(q, r, impl=impl, trace_chunk=5, **kw)
        d, s, e = (x.numpy() for x in tengine.sdtw(
            q, r, impl=impl, return_spans=True, device="cpu", **kw))
        for i, ar in enumerate(results):
            assert (ar.start, ar.end) == (int(s[i]), int(e[i]))
            assert check_path(ar.path, ar.start, ar.end, 7)
            assert path_cost(q[i], r, ar.path) == d[i]
            np.testing.assert_array_equal(
                ar.path, sdtw_path(q[i], r, ar.start, ar.end))
        if impl == "auto":
            for got, want in zip(results, jalign(
                    jnp.asarray(q), jnp.asarray(r), trace_chunk=5)):
                _same_result(got, want)


def test_traceback_chunk_invariance(rng):
    """The checkpointed block replay produces the identical path for any
    block width, and the reference's traceback the same path."""
    q = rng.integers(-10, 10, 9).astype(np.int32)
    r = rng.integers(-10, 10, 64).astype(np.int32)
    _, s, e = tengine.sdtw(q, r, return_spans=True, device="cpu")
    paths = [traceback_path(q, r, int(s), int(e), chunk=c)
             for c in (1, 3, 7, 64, 10**6)]
    assert check_path(paths[0], int(s), int(e), 9)
    for p in paths[1:]:
        np.testing.assert_array_equal(paths[0], p)
    np.testing.assert_array_equal(
        paths[0], jtraceback.traceback_path(q, r, int(s), int(e), chunk=3))


def test_traceback_chunk1_boundary_diagonal_keeps_start_cell():
    """With chunk=1 every move crosses a block boundary; a diagonal step
    landing on (0, start) must still replay block 0 and keep the path's
    first cell."""
    q = np.asarray([0, 5], np.int32)
    r = np.asarray([9, 9, 0, 5, 9], np.int32)   # exact match at [2, 3]
    want = np.asarray([[0, 2], [1, 3]], np.int64)
    for c in (1, 2, 64):
        p = traceback_path(q, r, 2, 3, chunk=c)
        np.testing.assert_array_equal(p, want, err_msg=f"chunk={c}")
        assert check_path(p, 2, 3, 2)
        assert int(path_cost(q, r, p)) == 0


def test_align_exact_subsequence_is_diagonal(rng):
    """A planted exact match aligns 1:1: span == the planted window and
    the path is the pure diagonal; a single 1-D query gives one
    AlignResult."""
    r = rng.integers(-50, 50, 100).astype(np.int32)
    q = r[37:59]
    ar = align(q, r)
    assert (int(ar.distance), ar.start, ar.end) == (0, 37, 58)
    want = np.stack([np.arange(22), np.arange(37, 59)], axis=1)
    np.testing.assert_array_equal(ar.path, want)


def test_align_saturated_match_has_no_span(rng):
    """Every alignment saturates the int32 lattice: align reports
    (-1, -1, None), as the reference does, on the kernel's plain version
    too."""
    q = np.full((6,), -10_000, np.int32)
    r = np.full((48,), 10_000, np.int32)
    for impl in ("auto", "pallas"):
        ar = align(q, r, metric="square_diff", impl=impl)
        assert int(ar.distance) == INT_BIG
        assert ar.start == -1 and ar.end == -1 and ar.path is None
    _same_result(ar, jalign(jnp.asarray(q), jnp.asarray(r),
                            metric="square_diff"))


def test_align_ragged_and_qlens_match_reference(rng):
    """Ragged lists (bucketed; never the kernel) and padded batches with
    qlens trace back the reference's paths."""
    r = rng.integers(-20, 20, 120).astype(np.int32)
    qs = [rng.integers(-20, 20, L).astype(np.int32) for L in (3, 9, 17)]
    for got, want in zip(align(qs, r, trace_chunk=4),
                         jalign([jnp.asarray(x) for x in qs],
                                jnp.asarray(r), trace_chunk=4)):
        _same_result(got, want)
    padded = np.zeros((3, 17), np.int32)
    for i, x in enumerate(qs):
        padded[i, :len(x)] = x
    lens = np.array([3, 9, 17], np.int32)
    got = align(padded, r, lens, impl="pallas")
    for g, x in zip(got, qs):
        assert check_path(g.path, g.start, g.end, len(x))
        assert path_cost(x, r, g.path) == g.distance


def test_align_golden_spans_bitwise():
    """``sdtw_spans_v1.npz``: align's spans are the fixture's row-scan
    spans, and every path replays its distance (the f32 data are
    integer-valued)."""
    g = np.load(GOLDEN)
    for tag in ("i32", "f32"):
        q, r = g[f"{tag}_queries"], g[f"{tag}_reference"]
        for metric in ("abs_diff", "square_diff"):
            res = align(q, r, metric=metric, impl="pallas")
            np.testing.assert_array_equal(
                [a.distance for a in res], g[f"{tag}_{metric}_rowscan_dists"])
            np.testing.assert_array_equal(
                [a.start for a in res], g[f"{tag}_{metric}_rowscan_starts"])
            np.testing.assert_array_equal(
                [a.end for a in res], g[f"{tag}_{metric}_rowscan_ends"])
            for i, a in enumerate(res):
                assert path_cost(q[i], r, a.path, metric) == a.distance


def test_traceback_rejects_bad_span(rng):
    q = rng.integers(-5, 5, 4).astype(np.int32)
    r = rng.integers(-5, 5, 16).astype(np.int32)
    with pytest.raises(ValueError, match="span"):
        traceback_path(q, r, 5, 3)
    with pytest.raises(ValueError, match="span"):
        traceback_path(q, r, -1, 3)
    from repro_torch.distributed import get_mesh
    _same_result(align(q, r, mesh=get_mesh()), align(q, r))


def test_traceback_copy_is_the_reference():
    """The port's traceback module is the reference's, but for its
    docstrings: the same code, line for line."""
    src = pathlib.Path(__file__).parents[1] / "src"

    def code(path):
        lines = (src / path).read_text().split('"""')
        return [x for i, x in enumerate(lines) if i % 2 == 0]

    assert code("repro_torch/core/traceback.py") == \
        code("repro/core/traceback.py")
