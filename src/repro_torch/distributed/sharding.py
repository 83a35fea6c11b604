"""Meshes of ranks for the sharded sDTW engine, on ``torch.distributed``.

Counterpart of the sDTW half of ``repro.distributed.sharding``
(``get_mesh``, ``pipeline_axes``, ``init_multi_host``). JAX runs one
controller over ``jax.devices()``; PyTorch runs one process per device.
So a ``Mesh`` here is a grid of global ranks of the default process
group, and the world size plays the part of ``len(jax.devices())``: with
no process group initialised, the world is the calling process alone, as
a JAX process with one device sees a one-device mesh.

Every sharded call is SPMD: every rank of the mesh calls the same entry
point with the same arguments, in the same order, and every rank gets
back the whole, replicated answer. ``get_mesh`` itself is collective: it
creates the process group of every line of the grid along each axis
(``dist.new_group``, which every rank of the world must call, members or
not, in the same order), once per grid and world — later calls return the
same ``Mesh``.

``Axes`` and ``tree_shardings`` belong to the LM stack and are not part
of this module (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (mp,) or (dp, mp) grid of global ranks with named axes, and the
    process group of every line of the grid along each axis (keyed
    ``(axis, index of the line)``; ``None`` when no process group is
    initialised). Equal meshes have equal ``axis_names`` and ``grid``."""
    axis_names: tuple
    grid: tuple                   # nested tuples of global ranks
    groups: dict = dataclasses.field(default=None, compare=False,
                                     hash=False, repr=False)

    @property
    def ranks(self) -> np.ndarray:
        """The grid of global ranks as an int array."""
        return np.array(self.grid, dtype=np.int64)

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.ranks.shape))

    def coords(self, rank: Optional[int] = None) -> dict:
        """``{axis name: index}`` of ``rank`` (default: this process).
        Raises ``ValueError`` for a rank outside the mesh."""
        rank = this_rank() if rank is None else int(rank)
        hit = np.argwhere(self.ranks == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in hit[0])))

    def line(self, axis: str, rank: Optional[int] = None) -> list:
        """The global ranks along ``axis`` through ``rank`` (default: this
        process), in axis order."""
        at = self.coords(rank)
        ax = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == ax else at[name]
                    for i, name in enumerate(self.axis_names))
        return [int(r) for r in self.ranks[idx]]

    def group(self, axis: str, rank: Optional[int] = None):
        """The process group of ``line(axis, rank)``; ``None`` without a
        process group."""
        if self.groups is None:
            return None
        return self.groups[axis, tuple(self.line(axis, rank))]


def this_rank() -> int:
    """This process's global rank (0 when no process group exists)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """Ranks in the default process group (1 when none exists)."""
    return dist.get_world_size() if dist.is_initialized() else 1


#: ``(axis_names, grid) -> (world group, Mesh)``: the groups of a grid are
#: created once per process group (``get_mesh`` is called by every front
#: door that resolves ``mesh_shape=``).
_MESHES: dict = {}


def _with_groups(axis_names: tuple, grid: np.ndarray) -> Mesh:
    world = dist.group.WORLD if dist.is_initialized() else None
    key = (axis_names, tuple(grid.flatten().tolist()), grid.shape)
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is world:
        return hit[1]
    nested = tuple(tuple(x) if isinstance(x, list) else x
                   for x in grid.tolist())
    groups = None
    if world is not None:
        groups = {}
        for ax, name in enumerate(axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
            for line in lines.tolist():
                groups[name, tuple(line)] = dist.new_group(sorted(line))
    mesh = Mesh(axis_names, nested, groups)
    _MESHES[key] = (world, mesh)
    return mesh


def get_mesh(shape=None, axis_names: Optional[Sequence[str]] = None, *,
             ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh for the sharded sDTW engine, redco-style.

    ``shape`` may be:
      * None        — all ranks on one systolic axis ``("mp",)``
      * an int k    — ``(-1, k)``: k-way reference sharding, data-parallel
                      over the rest
      * a tuple     — explicit ``(mp,)`` or ``(dp, mp)``; at most one entry
                      may be ``-1`` (inferred from the rank count)

    ``axis_names`` defaults to ``("mp",)`` / ``("dp", "mp")`` to match the
    tuple length. ``ranks`` restricts the mesh to a subset of the global
    ranks (default: every rank of the default process group, or this
    process alone when none is initialised). Collective: every rank of the
    world calls it with the same arguments. The shape rules and messages
    are the reference's, with ranks in the place of devices.
    """
    rks = (list(range(world_size())) if ranks is None
           else [int(r) for r in ranks])
    ndev = len(rks)
    if shape is None:
        shape = (ndev,)
    elif isinstance(shape, int):
        shape = (-1, shape)
    else:
        shape = tuple(int(s) for s in shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"mesh shape must be (mp,) or (dp, mp), got "
                         f"{shape!r}")
    if sum(1 for s in shape if s == -1) > 1:
        raise ValueError(f"at most one -1 wildcard allowed in mesh shape, "
                         f"got {shape!r}")
    if any(s == 0 or s < -1 for s in shape):
        raise ValueError(f"mesh shape entries must be positive or -1, got "
                         f"{shape!r}")
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        if known == 0 or ndev % known != 0:
            raise ValueError(f"cannot infer -1 in mesh shape {shape!r}: "
                             f"{ndev} devices not divisible by {known}")
        shape = tuple(ndev // known if s == -1 else s for s in shape)
    total = 1
    for s in shape:
        total *= s
    if total != ndev:
        raise ValueError(f"mesh shape {shape!r} needs {total} devices, "
                         f"have {ndev}")
    if axis_names is None:
        axis_names = ("mp",) if len(shape) == 1 else ("dp", "mp")
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"axis_names {axis_names!r} does not match mesh "
                         f"shape {shape!r}")
    return _with_groups(axis_names, np.array(rks, np.int64).reshape(shape))


def pipeline_axes(mesh: Mesh, ref_axis: str = "ref",
                  dp_axis: Optional[str] = None):
    """Resolve (dp_axis, mp_axis) for the sharded sDTW pipeline.

    The systolic (reference-sharded) axis is ``ref_axis`` if the mesh has
    it, else ``"mp"``, else the sole axis of a 1-D mesh. The data-parallel
    axis is ``dp_axis`` if given, else the single remaining axis (None for
    a 1-D mesh). Ambiguous or missing axes raise.
    """
    names = tuple(mesh.axis_names)
    if ref_axis in names:
        mp = ref_axis
    elif "mp" in names:
        mp = "mp"
    elif len(names) == 1:
        mp = names[0]
    else:
        raise ValueError(f"cannot pick a systolic axis from mesh axes "
                         f"{names!r}: pass ref_axis= naming one of them")
    rest = tuple(n for n in names if n != mp)
    if dp_axis is not None:
        if dp_axis not in rest:
            raise ValueError(f"dp_axis {dp_axis!r} not in mesh axes "
                             f"{names!r} (systolic axis is {mp!r})")
        return dp_axis, mp
    if len(rest) == 0:
        return None, mp
    if len(rest) == 1:
        return rest[0], mp
    raise ValueError(f"mesh has several non-systolic axes {rest!r}; pass "
                     f"dp_axis= naming the data-parallel one")


def init_multi_host(coordinator_address: str, num_processes: int,
                    process_id: int, *, backend: Optional[str] = None):
    """Join the world of ``num_processes`` ranks as rank ``process_id``
    (``dist.init_process_group``), then build meshes with ``get_mesh``.

    ``coordinator_address`` is ``host:port`` (or a full ``init_method``
    such as ``tcp://host:port`` or ``file:///path``); ``backend`` defaults
    to ``"nccl"`` when a CUDA device is present, else ``"gloo"``. With a
    CUDA device the rank's current device becomes ``local_rank %
    device_count`` (``local_rank`` from ``$LOCAL_RANK``, else
    ``process_id``). A failed rendezvous raises. Returns
    ``(rank, world size)``.
    """
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    method = (coordinator_address if "://" in coordinator_address
              else f"tcp://{coordinator_address}")
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()
