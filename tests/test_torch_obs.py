"""The port's spans (``repro_torch.obs``) on the CPU: off, they cost one
check and never enter ``record_function``; on, under
``torch.profiler.profile``, each call site gives its spans in the
expected number and nesting; and the answers are the same either way.
"""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core.matsa_api import matsa
from repro_torch.device import as_tensor
from repro_torch.kernels.sdtw import sdtw_cuda
from repro_torch.search.profile import DEFAULT_BATCH, matrix_profile

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _series(m=240, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(-500, 500, m).astype(np.int32)


def _queries(nq=4, n=16, seed=4):
    rng = np.random.default_rng(seed)
    return rng.integers(-500, 500, (nq, n)).astype(np.int32)


def call_matsa():
    res = matsa(torch.from_numpy(_series()), _queries(),
                mode="query_filtering", anomaly_threshold=2000,
                device="cpu")
    return res.distances.numpy(), res.anomalies.numpy()


def call_matrix_profile(window=16, stride=8, batch=10):
    res = matrix_profile(_series(), window, stride=stride, batch=batch,
                         prune=False, device="cpu")
    return res.nn_dist, res.nn_start, res.nn_end


def call_sdtw_cuda():
    d, s, e = sdtw_cuda(_queries(), _series(), return_spans=True,
                        device="cpu")
    return d.numpy(), s.numpy(), e.numpy()


CALLS = {"matsa": call_matsa, "matrix_profile": call_matrix_profile,
         "sdtw_cuda": call_sdtw_cuda}


def traced(fn):
    """``fn()``'s result and the ``repro_torch.*`` spans it recorded, as
    [(name, start_ns, end_ns)] in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(obs.PREFIX)),
                   key=lambda s: s[1])
    return out, spans


def names(spans):
    return [s[0] for s in spans]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_off_a_span_never_enters_record_function(call, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not obs.recording()
    assert obs.span("x") is obs.span("y")     # one shared no-op context
    CALLS[call]()


@pytest.mark.parametrize("call", sorted(CALLS))
def test_traced_answers_equal_untraced(call):
    plain = CALLS[call]()
    got, spans = traced(CALLS[call])
    assert spans
    for g, p in zip(got, plain, strict=True):
        assert g.dtype == p.dtype and np.array_equal(g, p)


def test_matsa_gives_one_door_span_with_one_stage_inside():
    _, spans = traced(call_matsa)
    door = [s for s in spans if s[0] == "repro_torch.matsa"]
    stage = [s for s in spans if s[0] == "repro_torch.stage"]
    assert len(door) == 1 and len(stage) == 1
    assert door[0][1] <= stage[0][1] and stage[0][2] <= door[0][2]
    assert names(spans).count("repro_torch.sdtw") == 0   # the CPU engine


@pytest.mark.parametrize("window,stride,batch", [(16, 8, 10), (16, 8, 28),
                                                  (16, 8, 64), (24, 5, 7),
                                                  (16, 1, None)])
def test_matrix_profile_gives_a_span_a_batch(window, stride, batch):
    nw = (_series().shape[0] - window) // stride + 1
    _, spans = traced(lambda: call_matrix_profile(window, stride, batch))
    batches = [s for s in spans if s[0] == "repro_torch.profile.batch"]
    # The CPU's row scan takes 256 windows a batch by default.
    resolved = DEFAULT_BATCH if batch is None else batch
    assert len(batches) == math.ceil(nw / resolved)
    # The batches follow one another; each stages its windows.
    assert all(a[2] <= b[1] for a, b in zip(batches, batches[1:]))
    stages = [s for s in spans if s[0] == "repro_torch.stage"]
    for b in batches:
        assert any(b[1] <= s[1] and s[2] <= b[2] for s in stages)


@pytest.mark.parametrize("calls", [1, 3])
def test_each_sdtw_cuda_call_gives_one_span(calls):
    def run():
        return [call_sdtw_cuda() for _ in range(calls)]
    _, spans = traced(run)
    assert names(spans).count("repro_torch.sdtw") == calls


@pytest.mark.parametrize("x,stages", [
    (torch.arange(6, dtype=torch.int32), 0),       # already on the device
    (np.arange(6, dtype=np.int32), 1),             # from the host
    ([1, 2, 3], 1)])                               # a Python value
@pytest.mark.parametrize("dtype", [None, torch.int64])
def test_as_tensor_stages_only_what_it_moves(x, stages, dtype):
    got, spans = traced(lambda: as_tensor(x, CPU, dtype))
    assert names(spans) == ["repro_torch.stage"] * stages
    assert torch.equal(got, torch.as_tensor(x).to(dtype=dtype))
