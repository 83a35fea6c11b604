"""Meshes of ranks and the LM's logical sharding rules, on
``torch.distributed`` (the JAX package's ``distributed/sharding.py``).

JAX runs one controller over ``jax.devices()``; PyTorch runs one process
per device. So a ``Mesh`` here is a grid of global ranks of the default
process group, and the world size plays the part of
``len(jax.devices())``: with no process group initialised, the world is
the calling process alone, as a JAX process with one device sees a
one-device mesh. ``get_mesh`` builds the sharded sDTW engine's (mp,) and
(dp, mp) meshes with the reference's shape rules; ``make_mesh`` any grid
of named axes (``("pod", "data", "model")``, ``("stage",)``, ...).

Every sharded call is SPMD: every rank of the mesh calls the same entry
point with the same arguments, in the same order, and every rank gets
back the whole, replicated answer. ``get_mesh`` itself is collective: it
creates the process group of every line of the grid along each axis
(``dist.new_group``, which every rank of the world must call, members or
not, in the same order), once per grid and world — later calls return the
same ``Mesh``.

The LM's axis conventions are the reference's: batch over the
data-parallel axes (``"pod"``, ``"data"``), heads, d_ff, experts and
d_inner over the tensor-parallel axis (``"model"``), vocab over
``"model"``. Every model function takes ``axes`` (an ``Axes``); with no
mesh each helper is a no-op, as in the reference. Under a mesh the
sharded arrays are DTensors over the mesh's ``DeviceMesh`` (made once per
grid and device type from the mesh's own groups): like a ``jax.Array``
under a ``NamedSharding`` a DTensor keeps global semantics, so a sharded
answer is the mesh-free one up to reduction order. ``Axes.spec`` is the
reference's ``PartitionSpec`` as a tuple, ``placements`` turns it into
DTensor placements, and ``constrain`` is ``DTensor.redistribute`` (the
identity on a plain tensor). Constants that meet sharded activations
(positions, masks, zero states) become replicated DTensors
(``replicated``); serving, which builds no graph, runs in
``Axes.context()``, where plain tensors count as replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of global ranks with named axes, and the process group of
    every line of the grid along each axis (keyed ``(axis, ranks of the
    line)``; ``None`` when no process group is initialised). Equal meshes
    have equal ``axis_names`` and ``grid``."""
    axis_names: tuple
    grid: tuple                   # nested tuples of global ranks
    groups: dict = dataclasses.field(default=None, compare=False,
                                     hash=False, repr=False)
    _device_meshes: dict = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False)

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

    def line(self, axis, rank: Optional[int] = None) -> list:
        """The global ranks along ``axis`` (a name, or a tuple of adjacent
        names taken together, row-major) through ``rank`` (default: this
        process), in axis order."""
        at = self.coords(rank)
        names = axis if isinstance(axis, tuple) else (axis,)
        idx = tuple(slice(None) if name in names else at[name]
                    for name in self.axis_names)
        return [int(r) for r in self.ranks[idx].reshape(-1)]

    @property
    def dtensor_dims(self) -> tuple:
        """The dims of the mesh's ``DeviceMesh``: its axes, with the
        data-parallel axes ("pod", "data") merged into one when both are
        there, side by side (a spec always names them together, and a
        tensor dim sharded over two mesh dims sends DTensor's planner into
        a search that takes minutes)."""
        names = self.axis_names
        dp = [i for i, n in enumerate(names) if n in _DATA_AXES]
        if len(dp) < 2 or dp != list(range(dp[0], dp[0] + len(dp))):
            return names
        return names[:dp[0]] + (names[dp[0]:dp[-1] + 1],) + names[dp[-1] + 1:]

    def group(self, axis: str, rank: Optional[int] = None):
        """The process group of ``line(axis, rank)``; ``None`` without a
        process group."""
        if self.groups is None:
            return None
        return self.groups[axis, tuple(self.line(axis, rank))]

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def device_mesh(self, device_type: str = "cuda"):
        """This process's ``DeviceMesh`` of the grid for tensors on
        ``device_type``, over the mesh's own line groups (made once per
        device type; creating it is not collective). Raises without a
        process group, or on a rank outside the mesh."""
        hit = self._device_meshes.get(device_type)
        if hit is not None:
            return hit
        if self.groups is None:
            raise RuntimeError("a sharded computation needs an initialised "
                               "process group (init_multi_host), also at "
                               "world 1")
        from torch.distributed.device_mesh import DeviceMesh
        dims = self.dtensor_dims
        groups = [self.group(d) for d in dims]
        shape = [math.prod(self.shape[n] for n in
                           (d if isinstance(d, tuple) else (d,)))
                 for d in dims]
        dm = DeviceMesh.from_group(
            groups, device_type,
            torch.as_tensor(self.ranks.reshape(shape), dtype=torch.int),
            mesh_dim_names=tuple("_".join(d) if isinstance(d, tuple) else d
                                 for d in dims))
        self._device_meshes[device_type] = dm
        return dm


def this_rank() -> int:
    """This process's global rank (0 when no process group exists)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """Ranks in the default process group (1 when none exists)."""
    return dist.get_world_size() if dist.is_initialized() else 1


#: The data-parallel axes of the LM's meshes (``Axes.dp``).
_DATA_AXES = ("pod", "data")

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
    def nest(x):
        return tuple(nest(y) for y in x) if isinstance(x, list) else x
    nested = nest(grid.tolist())
    groups = None
    if world is not None:
        groups = {}
        merged = tuple(d for d in Mesh(axis_names, nested).dtensor_dims
                       if isinstance(d, tuple))
        for dim in axis_names + merged:
            ax = [axis_names.index(n)
                  for n in (dim if isinstance(dim, tuple) else (dim,))]
            lines = np.moveaxis(grid, ax, list(range(-len(ax), 0))).reshape(
                -1, math.prod(grid.shape[i] for i in ax))
            for line in lines.tolist():
                groups[dim, tuple(line)] = dist.new_group(sorted(line))
    mesh = Mesh(axis_names, nested, groups)
    _MESHES[key] = (world, mesh)
    return mesh


def make_mesh(shape, axis_names, *,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of any named axes over the first ``prod(shape)`` ranks of
    ``ranks`` (default: the world), in row-major order, as
    ``jax.make_mesh`` takes the first devices. Collective, like
    ``get_mesh``. Raises when there are too few ranks."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape entries must be positive, got "
                         f"{shape!r}")
    if len(axis_names) != len(shape) or len(set(axis_names)) != len(shape):
        raise ValueError(f"axis_names {axis_names!r} does not match mesh "
                         f"shape {shape!r}")
    rks = (list(range(world_size())) if ranks is None
           else [int(r) for r in ranks])
    size = math.prod(shape)
    if size > len(rks):
        raise ValueError(f"Number of devices {len(rks)} must be >= the "
                         f"product of mesh_shape {shape}")
    return _with_groups(axis_names,
                        np.array(rks[:size], np.int64).reshape(shape))


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


# ---------------------------------------------------------------------------
# The LM's logical sharding rules (DP / TP / EP / SP over a mesh).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Axes:
    """Mesh axis handles threaded through every model function."""
    mesh: Optional[Mesh] = None
    dp: tuple = ("data",)        # ("pod", "data") on the multi-pod mesh
    tp: Optional[str] = "model"
    sp: Optional[str] = "data"   # sequence-parallel axis for long KV

    @staticmethod
    def from_mesh(mesh: Optional[Mesh]) -> "Axes":
        if mesh is None:
            return Axes(mesh=None, dp=(), tp=None, sp=None)
        names = mesh.axis_names
        dp = tuple(n for n in names if n in _DATA_AXES)
        tp = "model" if "model" in names else None
        sp = "data" if "data" in names else None
        return Axes(mesh=mesh, dp=dp, tp=tp, sp=sp)

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp is None:
            return 1
        return self.mesh.shape[self.tp]

    def tp_if_divisible(self, n: int):
        """TP axis name iff it evenly divides n (the reference's guard: a
        head count the axis does not divide is left replicated)."""
        return self.tp if (self.tp and n and n % self.tp_size == 0) else None

    def spec(self, *dims) -> tuple:
        """The reference's PartitionSpec as a tuple, dropping axes absent
        from the mesh.

        dims entries: None | "dp" | "tp" | "sp" | explicit axis name/tuple.
        """
        out = []
        for d in dims:
            if d == "dp":
                out.append(self.dp if self.dp else None)
            elif d == "tp":
                out.append(self.tp)
            elif d == "sp":
                out.append(self.sp)
            else:
                out.append(d)
        return tuple(out)

    def placements(self, spec: tuple) -> tuple:
        """DTensor placements (one a dim of the mesh's ``DeviceMesh``) of a
        ``spec`` tuple: the mesh axis named in the entry of tensor dim i
        shards dim i (an entry naming several axes shards the dim over
        them, the first outermost, as a PartitionSpec does: the merged
        data-parallel dim); the other dims replicate."""
        dims = self.mesh.dtensor_dims
        out = [Replicate()] * len(dims)
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            if names in dims:
                out[dims.index(names)] = Shard(i)
                continue
            for name in names:
                if name not in dims:
                    raise ValueError(f"{name!r} alone: the mesh shards "
                                     f"over {dims} together")
                out[dims.index(name)] = Shard(i)
        return tuple(out)

    def sharding(self, *dims, device=None):
        """``(DeviceMesh, placements)`` of ``dims`` for tensors on
        ``device`` (default: the CUDA device), or None without a mesh."""
        if self.mesh is None:
            return None
        dev = torch.device("cuda" if device is None else device)
        return (self.mesh.device_mesh(dev.type),
                self.placements(self.spec(*dims)))

    def constrain(self, x, *dims):
        """``DTensor.redistribute`` to ``dims`` if a mesh is active and
        ``x`` is a DTensor, else identity. A dim the named axes do not
        divide stays replicated (GSPMD pads such a dim; DTensor cannot
        flatten one)."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh,
                              self.placements(self._even(x.shape, dims)))

    def place(self, x, *dims):
        """A global tensor (the same on every rank, as SPMD arguments are)
        as a DTensor sharded by ``dims``: each rank keeps its own part, no
        message. A DTensor is redistributed; without a mesh, identity. A
        dim the axes do not divide stays replicated."""
        if self.mesh is None:
            return x
        if isinstance(x, DTensor):
            return self.constrain(x, *dims)
        return distribute_tensor(x.contiguous(),
                                 self.mesh.device_mesh(x.device.type),
                                 self.placements(self._even(x.shape, dims)),
                                 src_data_rank=None)

    def _even(self, shape, dims) -> tuple:
        """``spec(*dims)`` without the axes that do not divide their dim."""
        return tuple(d if d is None or shape[i] % self._size(d) == 0
                     else None for i, d in enumerate(self.spec(*dims)))

    def _size(self, entry) -> int:
        names = entry if isinstance(entry, tuple) else (entry,)
        return math.prod(self.mesh.shape[n] for n in names)

    def context(self):
        """The context a no-grad sharded computation (serving) runs in:
        plain tensors mixed with DTensors count as replicated. A null
        context without a mesh, or inside another such context. (The
        switch is per thread, and a backward runs on the autograd
        engine's threads: code that builds a graph converts its plain
        tensors with ``replicated`` instead.)"""
        if self.mesh is None or \
                DTensor._op_dispatcher._allow_implicit_replication:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()


def context(axes: Optional[Axes]):
    """``axes.context()``, or a null context for ``axes=None``."""
    return contextlib.nullcontext() if axes is None else axes.context()


def replicated(t, like):
    """The plain tensor ``t`` (the same on every rank) as a replicated
    DTensor on the mesh of the DTensor ``like``; ``t`` itself when
    ``like`` is a plain tensor. For constants (positions, masks, zero
    states) that meet sharded activations in code that builds a graph."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    dm = like.device_mesh
    return DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                              run_check=False)


def full(x):
    """The whole tensor of a DTensor (a collective), a plain tensor as it
    is. fp8 parts travel as their bytes (gloo gathers no fp8)."""
    if not isinstance(x, DTensor):
        return x
    if x.element_size() == 1 and x.dtype.is_floating_point:
        raw = DTensor.from_local(x.to_local().view(torch.uint8),
                                 x.device_mesh, x.placements,
                                 run_check=False, shape=x.shape,
                                 stride=x.stride())
        return raw.full_tensor().view(x.dtype)
    return x.full_tensor()


def unshard(x, dim: int):
    """``x`` with tensor dim ``dim`` gathered whole on every rank (other
    dims keep their placements); a plain tensor as it is. For ops whose
    DTensor rule cannot take that dim sharded."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements)
    return x.redistribute(x.device_mesh, pl)


def shards(x, dim: int) -> int:
    """Into how many parts tensor dim ``dim`` of ``x`` is split (1 for a
    plain tensor)."""
    if not isinstance(x, DTensor):
        return 1
    dim = dim % x.ndim
    return math.prod(x.device_mesh.size(i)
                     for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == dim)


def local(x):
    """This rank's part of a DTensor; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _GradPlacedAs(torch.autograd.Function):
    """Identity on a DTensor whose backward places the gradient as the
    DTensor is placed."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and g.placements != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_placed_as(x):
    """``x``, whose gradient is redistributed on its way back to ``x``'s
    own placements (a plain tensor as it is): where DTensor's backward
    would otherwise meet the gradient in a placement that the next op's
    rule cannot take, or plan around it with a gather."""
    return _GradPlacedAs.apply(x) if isinstance(x, DTensor) else x


def local_part(x, grad_placements=None):
    """``x.to_local(grad_placements)`` for code that computes on local
    parts under autograd. The local gradient is made contiguous on its way
    back: DTensor wraps it with the global tensor's (contiguous) strides,
    and a later view of a permuted local gradient would fail."""
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad_placements))


def pad(x, pads):
    """``F.pad(x, pads)`` (constant zeros) that takes DTensors: the padded
    dims are gathered whole and each rank pads its own part (DTensor's
    rule for the pad gives placements of the wrong length on torch
    2.11)."""
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(x, pads)
    shape = list(x.shape)
    for i in range(0, len(pads), 2):
        if pads[i] or pads[i + 1]:
            dim = x.ndim - 1 - i // 2
            x = unshard(x, dim)
            shape[dim] += pads[i] + pads[i + 1]
    out = torch.nn.functional.pad(local_part(x), pads)
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=tuple(shape),
                              stride=contiguous_strides(shape))


def local_ranges(x) -> tuple:
    """``(start, stop)`` of this rank's part of each dim of ``x`` (whole
    dims for a plain tensor and for replicated dims)."""
    if not isinstance(x, DTensor):
        return tuple((0, n) for n in x.shape)
    return _ranges(x.shape, x.device_mesh, x.placements)


def _ranges(shape, dm, placements) -> tuple:
    """This rank's ``(start, stop)`` of each dim of a tensor of ``shape``
    placed by ``placements`` on ``dm``, as ``torch.chunk`` splits (mesh
    dims outer to inner)."""
    ranges = [(0, int(n)) for n in shape]
    coord = dm.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            lo, hi = ranges[d]
            size = -(-(hi - lo) // dm.size(i))
            start = min(lo + coord[i] * size, hi)
            ranges[d] = (start, min(start + size, hi))
    return tuple(ranges)


def sharded_zeros(shape, dtype, device, sharding):
    """A zero DTensor of global ``shape`` placed by ``sharding`` (a
    ``(DeviceMesh, placements)`` pair; a plain zero tensor for None),
    each rank making its own part only."""
    if sharding is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    dm, pl = sharding
    part = torch.zeros([hi - lo for lo, hi in _ranges(shape, dm, pl)],
                       dtype=dtype, device=device)
    return DTensor.from_local(part, dm, pl, run_check=False,
                              shape=tuple(shape),
                              stride=contiguous_strides(shape))


def write_block(dst, src):
    """``dst.copy_(src)`` for a ``src`` every rank holds whole (a plain
    tensor): a DTensor ``dst`` takes this rank's block of it, no
    message."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    idx = tuple(slice(lo, hi) for lo, hi in local_ranges(dst))
    dst.to_local().copy_(src[idx])


def all_reduce(t, op: str, dm, mesh_dim: int):
    """``t`` reduced (``"sum"`` or ``"max"``) over one dim of the
    DeviceMesh ``dm``: a plain tensor, the same on that dim's ranks."""
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(t, op, (dm, mesh_dim))
    return out.wait() if hasattr(out, "wait") else out


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, out = 1, []
    for n in reversed(shape):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


def like(local_part, ref):
    """``local_part`` as a DTensor placed as the DTensor ``ref`` is (no
    message); ``local_part`` itself when ``ref`` is a plain tensor."""
    if not isinstance(ref, DTensor):
        return local_part
    return DTensor.from_local(local_part, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def partial_over(x, reduce_op: str = "sum"):
    """The placements under which this rank's part of ``x`` is its share
    of a ``reduce_op`` over the dims ``x`` is sharded on (replicated dims
    stay replicated): for one message per group of same-placed leaves."""
    return tuple(Partial(reduce_op) if isinstance(p, Shard) else Replicate()
                 for p in x.placements)


def tree_shardings(axes: Axes, spec_tree, device=None):
    """Map a tree (dicts) of spec-dim tuples to ``(DeviceMesh,
    placements)`` pairs (None mesh → None)."""
    if axes.mesh is None:
        return None

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return axes.sharding(*t, device=device)
    return go(spec_tree)
