"""Roofline terms of a cell (the JAX package's ``launch/roofline.py``),
priced for an NVIDIA H100.

Hardware models, each under the reference's keys:
  * ``H100`` (the default): one H100 SXM5 — 989 TFLOP/s dense bf16, 3.35
    TB/s HBM, 80 GB of it (``hbm_bytes``, the dry run's fit check), and
    ``ici_bw`` = 50 GB/s, the rate of the slowest link a collective of
    the (16, 16) production mesh crosses. Both of its axes span more than
    one 8-GPU NVLink domain, so that link is InfiniBand NDR: 400 Gb/s, 50
    GB/s a GPU. Inside one domain NVLink 4 gives 450 GB/s a direction;
    the single collective term prices every collective at the slower
    rate, as the reference's one ICI term does. Datasheet rates: no
    collective rate was measured (the machine at hand holds one card).
  * ``V5E``: TPU v5e, the reference's — 197 TFLOP/s bf16, 819 GB/s HBM,
    ~50 GB/s a link ICI.

Accounting conventions (recorded with every dry-run record):
  * flops and bytes are per rank: the counts of the rank's own local ops
    (``LocalCounter``, which sees the ops under DTensor's dispatch), as
    the reference's cost analysis runs on the partitioned module. The
    compute term is flops / peak_flops.
  * bytes accessed are the unfused sum, over the rank's local ops, of the
    bytes each reads and writes (views move nothing); eager PyTorch runs
    op by op, so this is the traffic of the program as written.
  * collective bytes are the result sizes of each all-reduce /
    all-gather / reduce-scatter / all-to-all / collective-permute, from
    XLA HLO text (``collective_bytes``) or from the torch collectives a
    rank issues (``LocalCounter.collectives``); term = bytes / ici_bw.
  * MODEL_FLOPS is the analytic useful work (6·N·D dense training /
    2·N_active·D forward + exact-causal attention + SSD terms); the ratio
    MODEL_FLOPS / (ranks · flops per rank) exposes remat, padding and
    masked-half waste.

One deliberate difference: ``roofline_fraction`` divides by the peak of
the hardware the terms were priced with, where the reference always
divides by V5E's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import weakref
from typing import Optional

V5E = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
H100 = dict(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=50e9,
            hbm_bytes=80e9)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*((?:\([^=]*?\))|(?:[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

#: The reference's five collective kinds.
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _collective_record(out: dict, counts: dict) -> dict:
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


def collective_bytes(hlo_text: str) -> dict:
    """Per-chip bytes moved by each collective type in XLA HLO text
    (result-shape proxy; ``-done`` halves of async pairs are skipped)."""
    out = {k: 0 for k in KINDS}
    counts = {k: 0 for k in KINDS}
    for m in _COLL_RE.finditer(hlo_text):
        shape_txt, op, phase = m.groups()
        if phase == "-done":
            continue
        out[op] += _shape_bytes(shape_txt)
        counts[op] += 1
    return _collective_record(out, counts)


#: torch collective ops → the reference's kinds: the functional ops
#: DTensor issues, and the c10d ops of plain ``torch.distributed`` calls
#: (the MoE's ``dist.all_to_all_single`` and ``dist.all_reduce``).
_TORCH_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::alltoall_": "all-to-all",
}

#: Ops that read and write nothing.
_NO_TRAFFIC = {"prim::device", "aten::detach", "aten::alias",
               "aten::lift_fresh", "_c10d_functional::wait_tensor"}


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _collective_out_bytes(name: str, args, out) -> int:
    """The result bytes of one collective: its output, or for the
    in-place c10d ops the tensors they write (their first argument)."""
    if name.startswith("c10d::"):
        return sum(_nbytes(t) for t in _tensors(args[0]))
    return sum(_nbytes(t) for t in _tensors(out))


class LocalCounter:
    """What one rank's local ops do, counted in a ``TorchDispatchMode``
    that lets every op on a DTensor pass to DTensor's dispatch and counts
    the plain ops it issues on the rank's local tensors (a mode entered
    above DTensor — ``FlopCounterMode`` — sees the global op instead).

    Counts, per rank: ``flops`` (``torch.utils.flop_counter``'s formulas,
    the ones ``FlopCounterMode`` uses), ``bytes_accessed`` (each non-view
    op's input and output bytes), the collectives' result bytes by the
    reference's kinds, and live storage: ``track`` registers the storages
    of tensors that exist already (a step's arguments), every op output
    on a storage not seen yet adds it, a storage's release takes it off,
    and ``peak_bytes`` is the most that was live at once.

    DTensor's sharding propagation runs ops of its own on global shapes
    (fake or meta) to infer output metadata; ``planning()`` marks that
    span, and ops inside it are not counted. Use as a context manager.
    """

    def __init__(self):
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes = {k: 0 for k in KINDS}
        self.coll_counts = {k: 0 for k in KINDS}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}
        self._planning = 0
        self._mode = None

    # -- storage tracking --------------------------------------------------
    def _key(self, t):
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return None, None
        return st._cdata, st

    def _add(self, t):
        key, st = self._key(t)
        if key is None or key in self._live:
            return
        nb = st.nbytes()
        self._live[key] = nb
        self.live_bytes += nb
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key):
        nb = self._live.pop(key, None)
        if nb is not None:
            self.live_bytes -= nb

    def track(self, tree) -> int:
        """Count the storages of the tensors of ``tree`` (dicts, lists,
        tuples, ``nn.Module`` parameters, DTensors by their local parts)
        as live; returns their bytes."""
        before = self.live_bytes
        for t in _leaves(tree):
            self._add(t)
        return self.live_bytes - before

    def storages(self, tree) -> dict:
        """``{storage key: bytes}`` of the distinct storages of ``tree``'s
        tensors."""
        out = {}
        for t in _leaves(tree):
            key, st = self._key(t)
            if key is not None:
                out[key] = st.nbytes()
        return out

    # -- counting ----------------------------------------------------------
    @contextlib.contextmanager
    def planning(self):
        """Context for DTensor's sharding propagation: nothing counted."""
        self._planning += 1
        try:
            yield
        finally:
            self._planning -= 1

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        name = func._schema.name
        kind = _TORCH_COLLECTIVES.get(name)
        if kind is not None:
            self.coll_bytes[kind] += _collective_out_bytes(name, args, out)
            self.coll_counts[kind] += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._add(t)

    def collectives(self) -> dict:
        """The ``collective_bytes`` record of the counted collectives."""
        return _collective_record(dict(self.coll_bytes),
                                  dict(self.coll_counts))

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if not counter._planning:
                    counter._count(func, args, kwargs, out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False


def _leaves(tree):
    """The plain tensors of ``tree``: a DTensor by its local part, an
    ``nn.Module`` by its parameters."""
    import torch
    from torch import nn
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        for p in tree.parameters():
            yield from _leaves(p)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    coll_bytes_per_chip: float
    n_chips: int
    peak_flops: float = H100["peak_flops"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops_per_chip * self.n_chips
        return self.model_flops / total if total else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flops / (chips · peak · bound_time),
        at the peak of the hardware the terms were priced with."""
        denom = self.n_chips * self.peak_flops * self.bound_time_s
        return self.model_flops / denom if denom else float("nan")

    def to_dict(self):
        return {**dataclasses.asdict(self),
                "dominant": self.dominant,
                "bound_time_s": self.bound_time_s,
                "useful_flops_ratio": self.useful_flops_ratio,
                "roofline_fraction": self.roofline_fraction}


def roofline(flops_per_chip: float, bytes_per_chip: float,
             coll_bytes_per_chip: float, model_flops: float,
             n_chips: int, hw=None) -> RooflineTerms:
    hw = hw or H100
    return RooflineTerms(
        compute_s=flops_per_chip / hw["peak_flops"],
        memory_s=bytes_per_chip / hw["hbm_bw"],
        collective_s=coll_bytes_per_chip / hw["ici_bw"],
        model_flops=model_flops,
        hlo_flops_per_chip=flops_per_chip,
        hlo_bytes_per_chip=bytes_per_chip,
        coll_bytes_per_chip=coll_bytes_per_chip,
        n_chips=n_chips,
        peak_flops=hw["peak_flops"])


def kernel_roofline(cells: float, hbm_bytes: float, *,
                    cells_per_s: float, hbm_bw: Optional[float] = None):
    """Two-term roofline bound for one sDTW kernel configuration.

    Unlike :func:`roofline` (terms of a whole step), this prices an
    *analytic* configuration before anything runs — the autotuner
    (``repro_torch.tune.cost``) calls it per candidate: ``cells`` DP
    cells at the backend's sustained ``cells_per_s`` versus ``hbm_bytes``
    of streaming traffic at ``hbm_bw`` (default: the H100's). Returns
    ``(bound_time_s, dominant)`` where dominant is 'compute' or 'memory'.
    """
    hbm_bw = H100["hbm_bw"] if hbm_bw is None else hbm_bw
    compute_s = cells / cells_per_s if cells_per_s else 0.0
    memory_s = hbm_bytes / hbm_bw if hbm_bw else 0.0
    return (max(compute_s, memory_s),
            "compute" if compute_s >= memory_s else "memory")


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS per cell
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """Useful-work FLOPs for one step of this cell (whole mesh)."""
    b, s = shape.global_batch, shape.seq_len
    v, d = cfg.vocab, cfg.d_model
    n_active = cfg.active_param_count()
    # Embedding lookups are gather (0 flops); logits matmul is real.
    n_mm = n_active - (0 if cfg.tie_embeddings else v * d)

    n_attn = 0
    if cfg.n_heads:
        n_attn = (cfg.n_layers if cfg.family != "hybrid"
                  else cfg.n_layers // cfg.attn_every)
    hd = cfg.resolved_head_dim
    attn_fwd_per_tok = 2 * (s / 2) * cfg.n_heads * hd * 2 * n_attn \
        if shape.kind != "decode" else 0   # exact causal: S/2 avg context

    ssd_fwd_per_tok = 0.0
    if cfg.has_ssm:
        L, n_state, di = cfg.ssm_chunk, cfg.ssm_state, cfg.d_inner
        # G=CBᵀ, scores·X, state-in, y_inter per layer
        ssd_fwd_per_tok = (2 * L * n_state + 2 * L * di
                           + 4 * n_state * di) * cfg.n_layers

    if shape.kind == "train":
        tokens = b * s
        return (6 * n_mm + 3 * (attn_fwd_per_tok + ssd_fwd_per_tok)) * tokens
    if shape.kind == "prefill":
        tokens = b * s
        return (2 * n_mm + attn_fwd_per_tok + ssd_fwd_per_tok) * tokens
    # decode: context-length attention + recurrent SSD update
    attn_dec = 4 * s * cfg.n_heads * hd * n_attn if cfg.n_heads else 0
    ssd_dec = 6 * cfg.d_inner * cfg.ssm_state * cfg.n_layers \
        if cfg.has_ssm else 0
    return (2 * n_mm + attn_dec + ssd_dec) * b
