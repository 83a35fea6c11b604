"""Production mesh builders (the JAX package's ``launch/mesh.py``).

A mesh is a grid of ``torch.distributed`` ranks
(``repro_torch.distributed.sharding.Mesh``): building one is collective
(every rank of the world calls it with the same arguments) and needs as
many ranks as the grid holds.
"""
from __future__ import annotations

from ..distributed.sharding import get_mesh
from ..distributed.sharding import make_mesh as _make_mesh

__all__ = ["make_production_mesh", "make_mesh", "get_mesh"]


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; "pod" is the
    pure-DP cross-pod axis (lowest bandwidth → hierarchical gradient
    reduction). Raises when the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes):
    """Arbitrary mesh (tests / examples), e.g. ((1, 2), ("data", "model")),
    over the first ranks of the world."""
    return _make_mesh(tuple(shape), tuple(axes))
