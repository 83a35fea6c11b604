"""The benchmark's plain reference held against a loop written straight
from the definition, and against the port's CPU path, at tiny sizes."""
import numpy as np
import pytest
import torch

from perfbench import reference as R


def naive(q, r, lo=-1, hi=-1, ceiling=None):
    """sDTW by the definition: values, starts (ties to the smaller
    start), the leftmost end; cells saturate at ``ceiling`` if given."""
    n, m = len(q), len(r)
    cap = R.INT_BIG if ceiling is None else ceiling
    V = np.zeros((n, m), np.int64)
    S = np.zeros((n, m), np.int64)

    def d(i, j):
        if lo <= j < hi:
            return cap
        return min(abs(int(q[i]) - int(r[j])), cap)
    for j in range(m):
        V[0, j], S[0, j] = d(0, j), j
    for i in range(1, n):
        for j in range(m):
            cands = [(V[i - 1, j], S[i - 1, j])]
            if j:
                cands += [(V[i - 1, j - 1], S[i - 1, j - 1]),
                          (V[i, j - 1], S[i, j - 1])]
            v, s = min(cands)
            V[i, j], S[i, j] = min(d(i, j) + v, cap), s
    e = int(np.argmin(V[-1]))
    return int(V[-1, e]), e, int(S[-1, e]), V[-1]


def _case(rng, amp=50):
    n, m = int(rng.integers(1, 7)), int(rng.integers(1, 30))
    q = rng.integers(-amp, amp, (3, n))
    r = rng.integers(-amp, amp, m)
    lo = rng.integers(-1, m, 3)
    hi = lo + rng.integers(0, 8, 3)
    lo[0] = hi[0] = -1
    return q, r, lo, hi


@pytest.fixture(params=[None, 4], ids=["whole_rows", "segments_of_4"])
def segment(request, monkeypatch):
    """Rows scanned whole, or as segments of 4 columns (a row of the
    cases here spans up to 8 of them, the last one cut short)."""
    if request.param:
        monkeypatch.setattr(R, "SEGMENT", request.param)


@pytest.mark.parametrize("seed", range(6))
def test_scan_matches_the_definition(seed, segment):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        q, r, lo, hi = _case(rng)
        m = len(r)
        t = [torch.tensor(x) for x in (q, r, lo, hi)]
        whole = R.sdtw_scan(t[0], t[1], ban_lo=t[2], ban_hi=t[3], spans=True)
        sliced = R.sdtw_scan(t[0], t[1], ban_lo=t[2], ban_hi=t[3],
                             spans=True, chunk=int(rng.integers(1, m + 1)))
        for k in range(3):
            v, e, s, _ = naive(q[k], r, lo[k], hi[k])
            if v >= R.INT_BIG:
                continue
            for out in (whole, sliced):
                assert (int(out[0][k]), int(out[1][k]),
                        int(out[2][k])) == (v, e, s)


@pytest.mark.parametrize("seed", range(3))
def test_control_is_the_recurrence_in_saturating_int16(seed, segment):
    rng = np.random.default_rng(100 + seed)
    for _ in range(8):
        q, r, lo, hi = _case(rng, amp=6000)
        t = [torch.tensor(x) for x in (q, r, lo, hi)]
        got = R.sdtw_scan(t[0], t[1], ban_lo=t[2], ban_hi=t[3], lanes=16,
                          chunk=int(rng.integers(1, len(r) + 1)))
        for k in range(3):
            v, e, _, _ = naive(q[k], r, lo[k], hi[k], ceiling=R.BIG16)
            assert int(got[0][k]) == v
            if v < R.BIG16:
                assert int(got[1][k]) == e


def test_scan_matches_the_port_on_the_cpu():
    from repro_torch.core import engine
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.integers(-3000, 3000, (5, 9)), dtype=torch.int32)
    r = torch.tensor(rng.integers(-3000, 3000, 200), dtype=torch.int32)
    lo = torch.tensor([-1, 10, 50, 0, 120], dtype=torch.int32)
    hi = torch.tensor([-1, 30, 90, 40, 180], dtype=torch.int32)
    d, s, e = engine.sdtw(q, r, excl_lo=lo, excl_hi=hi, return_spans=True,
                          device="cpu")
    got = R.sdtw_scan(q, r, ban_lo=lo, ban_hi=hi, spans=True)
    assert torch.equal(got[0], d.long())
    assert torch.equal(got[1], e.long())
    assert torch.equal(got[2], s.long())


def test_a_stratified_sample_takes_one_from_each_run():
    rng = np.random.default_rng(5)
    items = np.arange(10, 1010)
    got = R.stratified(rng, items, 100)
    assert np.array_equal((got - 10) // 10, np.arange(100))
    assert np.array_equal(R.stratified(rng, items, 5000), items)
