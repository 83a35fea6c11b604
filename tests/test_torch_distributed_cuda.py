"""The sharded sDTW engine on the card (marker ``cuda``; the ``cuda``
fixture skips elsewhere):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_distributed_cuda.py

One card holds one NCCL rank only, so the NCCL path runs at world 1 (the
pipeline has one stage), and the multi-rank path runs two gloo ranks on
the one card (carries staged through the host). Both hold every answer
of the check body (``tests/_torch_distributed_check.py``) bitwise against
the port's CPU answers, which ``tests/test_torch_distributed.py`` holds
against the JAX package, and show that each rank launched the CUDA
kernels: K1 (distances), K2 (top-1 spans, the kernel's own best) and K3
(top-K heaps from the last-row capture).
"""
import numpy as np
import pytest
import torch

from _torch_distributed_check import check_sdtw, make_case, run_ranks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels.sdtw import _build
    _build.build()                  # before any rank loads the libraries
    return torch.device("cuda")


def _cpu_answers(case):
    from repro_torch.distributed import get_mesh
    return check_sdtw(get_mesh(), case, "cpu")


def _same(got, want):
    for key, w in want.items():
        if key.startswith(("snapshot_", "launch_")):
            continue
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def _launched(got):
    counts = dict(zip(got["launch_keys"].tolist(),
                      got["launch_counts"].tolist()))
    for var in ("plain", "span", "lastrow"):
        assert sum(v for k, v in counts.items()
                   if k.endswith(var) or k.endswith(f"{var}_ban")), (var,
                                                                     counts)


def test_one_nccl_rank_equals_the_cpu_answers(cuda):
    import socket

    import torch.distributed as dist
    from repro_torch.core import engine
    from repro_torch.distributed import get_mesh, init_multi_host
    case = make_case((1, 2, 4, 8, 16))
    want = _cpu_answers(case)
    rng = np.random.default_rng(5)
    q = rng.integers(-40, 40, (9, 33)).astype(np.int32)
    r = rng.integers(-40, 40, 3000).astype(np.int32)
    kw = dict(chunk=512, top_k=3, return_spans=True,
              excl_lo=np.arange(9) * 200, excl_hi=np.arange(9) * 200 + 300)
    banned = engine.sdtw(q, r, device="cpu", mesh=get_mesh(), **kw)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_multi_host(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        got = check_sdtw(get_mesh(), case, "cuda")
        got_banned = engine.sdtw(q, r, mesh=get_mesh(), **kw)
    finally:
        dist.destroy_process_group()
    _same(got, want)
    _launched(got)
    for g, w in zip(got_banned, banned):
        assert torch.equal(g.cpu(), w)


def test_two_gloo_ranks_on_the_card(cuda, tmp_path):
    case = make_case((1, 2, 4, 8, 16))
    want = _cpu_answers(case)
    ranks = run_ranks(case, tmp_path, 2, (1, 2), device="cuda", timeout=600)
    for got in ranks:
        _same(got, want)
        _launched(got)
