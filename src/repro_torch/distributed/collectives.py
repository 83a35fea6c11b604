"""The sharded sDTW pipeline's collectives on ``torch.distributed``.

Counterparts of ``repro.distributed.collectives.neighbor_perm`` and
``psum_harvest``: the left-to-right systolic hand-off of the chunk carry
(``lax.ppermute`` there, one ``dist.batch_isend_irecv`` a tick here) and
the harvest of the last stage's results onto every rank. The gradient
compression of that module: ``quantize_int8``, ``dequantize_int8``,
``compress_with_feedback`` (the train step's ``int8_ef`` mode, on plain
or sharded gradients), ``init_feedback``, and the int8 all-reduce
``compressed_psum``.

A message is the carry's leaves packed into one byte buffer, so a tick
moves one tensor each way. The wire is ``wire_device``: the tensors' own
device under NCCL, the host under gloo (whose send and recv take CPU
tensors only) — host staging is gloo's transport, the compute stays on
the rank's device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.convert import stacked_leaves
from ..optim.adamw import named
from .sharding import Mesh, like, local, partial_over, this_rank


def neighbor_perm(n: int):
    """The systolic hand-off as (source, destination) stage pairs: stage i
    sends to i + 1; the last stage's output leaves the pipeline and stage
    0 receives nothing (it enters each microbatch itself)."""
    return [(i, i + 1) for i in range(n - 1)]


def wire_device(device: torch.device, group=None) -> torch.device:
    """Where a message to or from ``group`` travels: ``device`` under
    NCCL, the host under every other backend."""
    if dist.get_backend(group) == "nccl":
        return device
    return torch.device("cpu")


def pack(leaves: Sequence[torch.Tensor], wire: torch.device) -> torch.Tensor:
    """The leaves' bytes, concatenated into one uint8 tensor on ``wire``."""
    return torch.cat([x.detach().contiguous().reshape(-1).view(torch.uint8)
                      .to(wire) for x in leaves])


def unpack(buf: torch.Tensor, template: Sequence[torch.Tensor], device,
           lead: tuple = ()) -> tuple:
    """Inverse of ``pack``: leaves shaped ``lead + leaf.shape`` and typed
    like ``template``'s, on ``device``."""
    out, at = [], 0
    for x in template:
        shape = lead + tuple(x.shape)
        nbytes = x.element_size()
        for s in shape:
            nbytes *= s
        out.append(buf[at:at + nbytes].to(device).view(x.dtype)
                   .reshape(shape))
        at += nbytes
    return tuple(out)


def nbytes(template: Sequence[torch.Tensor], lead: tuple = ()) -> int:
    n = 1
    for s in lead:
        n *= s
    return n * sum(x.numel() * x.element_size() for x in template)


def hand_off(mesh: Mesh, mp_axis: str, send: Optional[tuple],
             recv: bool, template: Sequence[torch.Tensor], device):
    """One tick of the systolic hand-off along ``mp_axis``: this rank
    sends ``send`` (carry leaves, or ``None``) to its right-hand
    neighbour and, with ``recv``, receives the left-hand neighbour's
    leaves (typed and shaped like ``template``). Both ops go out in one
    ``batch_isend_irecv``, so edge ranks (stage 0 posts no recv, the last
    stage no send) never block on a partner. Returns the received leaves
    on ``device``, or ``None``."""
    line = mesh.line(mp_axis)
    d = line.index(this_rank())
    ops, buf = [], None
    wire = wire_device(device) if (send is not None or recv) else None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, pack(send, wire), line[d + 1]))
    if recv:
        buf = torch.empty(nbytes(template), dtype=torch.uint8, device=wire)
        ops.append(dist.P2POp(dist.irecv, buf, line[d - 1]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if buf is None else unpack(buf, template, device)


def psum_harvest(outs: Optional[tuple], template: Sequence[torch.Tensor],
                 mesh: Mesh, mp_axis: str, dp_axis: Optional[str],
                 n_keep: int, device) -> tuple:
    """Collect the last pipeline stage's results onto every rank.

    ``outs`` are the last stage's in-window results — leaves of
    ``(n_keep,) + template leaf shape``, microbatch μ at index μ — and
    ``None`` on every other stage. The last stage broadcasts them within
    its mp row; then the rows' results are gathered over the dp axis in
    row order (the reference's out-spec concatenation), so every rank
    returns leaves of ``(n_dp * n_keep,) + leaf shape`` on ``device``."""
    lead = (n_keep,)
    size = nbytes(template, lead)
    row = mesh.line(mp_axis)
    if len(row) > 1:
        group = mesh.group(mp_axis)
        wire = wire_device(device, group)
        buf = (pack(outs, wire) if outs is not None
               else torch.empty(size, dtype=torch.uint8, device=wire))
        dist.broadcast(buf, src=row[-1], group=group)
        outs = unpack(buf, template, device, lead)
    if dp_axis is None or mesh.shape[dp_axis] == 1:
        return tuple(outs)
    column = mesh.line(dp_axis)
    group = mesh.group(dp_axis)
    wire = wire_device(device, group)
    parts = [torch.empty(size, dtype=torch.uint8, device=wire)
             for _ in column]
    dist.all_gather(parts, pack(outs, wire), group=group)
    # all_gather fills in group-rank order, which is sorted global rank.
    by_rank = dict(zip(sorted(column), parts))
    rows = [unpack(by_rank[r], template, device, lead) for r in column]
    return tuple(torch.cat([rw[i] for rw in rows]) for i in range(len(template)))


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback (local part).
# ---------------------------------------------------------------------------

def quantize_int8(g):
    """Symmetric per-tensor int8. Returns (q int8, scale f32).

    ``torch.round`` rounds half to even as ``jnp.round`` does, so q and
    the scale equal the reference's bitwise."""
    g = g.float()
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    return _to_int8(g, scale), scale


def _to_int8(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_with_feedback(grads: dict, feedback: dict):
    """Quantise named gradients with error feedback.

    Returns (dequantised grads — what the wire would deliver on a
    1-device reduction —, new feedback buffers), both dicts under the
    gradients' names. The scale is per tensor of the reference's tree:
    the layers of a stacked leaf (``blocks.<l>.attn.wq`` for every l)
    share one, the largest magnitude over all of them, as the reference
    quantises its stacked ``blocks/attn/wq``. Sharded gradients (DTensors
    placed as their feedback is) share the global largest magnitude: each
    rank quantises its own part against it."""
    names = list(grads)
    deq, new_fb = {}, {}
    for idx in stacked_leaves([n.split(".") for n in names]).values():
        members = [names[i] for i in (idx if isinstance(idx, list)
                                      else [idx])]
        corrected = {n: local(grads[n]).float() + local(feedback[n])
                     for n in members}
        tops = torch.stack([torch.max(torch.abs(c))
                            for c in corrected.values()])
        ref = grads[members[0]]
        if isinstance(ref, DTensor):
            tops = DTensor.from_local(tops, ref.device_mesh,
                                      partial_over(ref, "max"),
                                      run_check=False).full_tensor()
        scale = torch.clamp(tops.max(), min=1e-12) / 127.0
        for n, c in corrected.items():
            d = dequantize_int8(_to_int8(c, scale), scale)
            deq[n], new_fb[n] = like(d, grads[n]), like(c - d, grads[n])
    return deq, new_fb


def compressed_psum(g, group=None):
    """int8-quantised all-reduce mean of ``g`` over ``group`` (the
    reference's ``compressed_psum`` over an axis; default: the world).

    Two-phase: (1) agree on a global scale (a MAX all-reduce of the local
    max-abs — a 4-byte collective), (2) quantise against the SHARED scale
    and sum in int32 (no overflow below 2^23 participants), then divide
    by the group's size. Summing int8 values quantised with heterogeneous
    per-rank scales would be wrong — the per-rank scale is lost in the
    integer accumulation. Wire cost: 4 bytes per grad element (int32)
    here + 4 bytes per tensor. Without a process group the group is this
    process alone."""
    g = g.float()
    top = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    if not dist.is_initialized():
        scale = top / 127.0
        return _to_int8(g, scale).float() * scale / 1.0
    wire = wire_device(g.device, group)
    top = top.to(wire)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    scale = top.to(g.device) / 127.0
    acc = _to_int8(g, scale).to(torch.int32).to(wire)
    dist.all_reduce(acc, group=group)
    n = float(dist.get_world_size(group))
    return acc.to(g.device).float() * scale / n


def init_feedback(params) -> dict:
    """Zero fp32 feedback buffers named and placed as ``params`` (an
    ``nn.Module``'s parameters or a dict of tensors)."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in named(params).items()}
