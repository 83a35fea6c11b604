"""The request objects behind the port's front doors — one argument
surface.

Counterpart of ``repro.core.request``: a frozen ``SdtwRequest`` holds an
offline call's arguments — ``op='sdtw'`` (``engine.sdtw``) or
``op='search_topk'`` (``repro_torch.search.search_topk``) — and
``validate()`` runs the front-door checks with the reference's messages;
``run()`` dispatches. ``StreamRequest`` is ``engine.stream``'s argument
surface; ``open()`` returns the ``StreamSession`` or, with a mesh, the
``ShardedStreamSession``. ``coalesce_key()`` is the serve tier's batching
key (``repro_torch.serve``). A mesh is ``repro_torch.distributed.Mesh``,
a grid of ranks; ``mesh_shape=`` builds one over the default process
group (``resolve_mesh``).

Argument semantics (as in the reference):

  * ``excl_zone`` — top-K suppression radius between reported matches;
    ``None`` derives it per query (half the true length with
    ``excl_mode='end'``, 0 with ``'span'``); a scalar applies to all; a
    per-query ``(nq,)`` array is honoured by the chunked path and stream
    sessions (the search layer takes scalars).
  * ``excl_lo``/``excl_hi`` — banned reference column range (self-join
    exclusion); given together or not at all.
  * ``top_k``/``k`` — matches per query; the search front door spells it
    ``k``.
  * ``tune`` — ``'model'`` (the default), ``'measure'`` or ``'off'``:
    where unset performance knobs come from (``repro_torch.tune``); int32
    answers do not depend on it.
  * ``device`` — where the call runs: ``None`` means the CUDA device,
    ``"cpu"`` the plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

IMPLS = ("auto", "rowscan", "wavefront", "pallas", "chunked", "sharded")
STREAM_IMPLS = ("auto", "rowscan", "pallas", "sharded")
SEARCH_ENGINE_IMPLS = ("auto", "rowscan", "pallas")
EXCL_MODES = ("end", "span")
OPS = ("sdtw", "search_topk")
TUNE_MODES = ("model", "measure", "off")


def resolve_mesh(mesh, mesh_shape):
    """``mesh_shape=`` builds the (dp, mp) mesh via the distributed layer
    (collective: every rank resolves it)."""
    if mesh_shape is None:
        return mesh
    if mesh is not None:
        raise ValueError("pass either mesh= (a prebuilt jax Mesh) or "
                         "mesh_shape= (built for you), not both")
    from repro_torch.distributed.sharding import get_mesh
    return get_mesh(mesh_shape)


def _check_forced_impl(impl: str, *, mesh, chunk, top_k):
    """Explicit precedence for forced impls: reject contradictory args."""
    if impl in ("rowscan", "wavefront"):
        if mesh is not None:
            raise ValueError(
                f"impl={impl!r} is an in-core path but mesh= requests the "
                "sharded driver; drop mesh= or use impl='sharded'/'auto'")
        if chunk is not None:
            raise ValueError(
                f"impl={impl!r} runs in-core and would ignore chunk=; drop "
                "chunk= or use impl='chunked'/'pallas' for streaming")
        if top_k is not None:
            raise ValueError(
                f"impl={impl!r} does not carry a top-K heap; top_k= runs on "
                "the chunked/sharded streaming paths (impl='auto' routes it)")
    elif impl == "pallas":
        if mesh is not None:
            raise ValueError(
                "impl='pallas' is single-device; drop mesh= or use "
                "impl='sharded'/'auto'")
        if top_k is not None:
            raise ValueError(
                "impl='pallas' reports the single best match "
                "(return_positions/return_spans); offline top_k= runs on "
                "the chunked/sharded streaming paths — the kernel's "
                "last-row capture serves top-K via repro.search "
                "(engine_impl='pallas') and streaming sessions")
    elif impl == "chunked" and mesh is not None:
        raise ValueError(
            "impl='chunked' is single-device; drop mesh= or use "
            "impl='sharded'/'auto'")


def _check_sharded_args(*, mesh, impl, n_micro, excl_zone, top_k,
                        return_positions):
    """Reject options the sharded path cannot honour."""
    sharded = mesh is not None or impl == "sharded"
    if n_micro is not None and not sharded:
        raise ValueError("n_micro= schedules the sharded systolic "
                         "pipeline; pass mesh=/mesh_shape= (or "
                         "impl='sharded') or drop n_micro=")
    if not sharded:
        return
    if excl_zone is not None and np.ndim(excl_zone) != 0:
        raise ValueError("the sharded driver takes a scalar excl_zone (or "
                         "None for the per-query default); per-query zone "
                         "arrays run on the single-device chunked path "
                         "(drop mesh=)")
    if return_positions and top_k is not None:
        raise ValueError("top_k= already returns (dists, positions) on "
                         "the sharded driver; return_positions=True adds "
                         "nothing there — drop it (or use return_spans=)")


def _mesh_fingerprint(mesh):
    """Hashable identity of a mesh for coalesce keys — axis names and
    ranks, as the sharded pipeline cache keys it."""
    if mesh is None:
        return None
    try:
        return (tuple(mesh.axis_names),
                tuple(int(r) for r in np.ravel(mesh.ranks)))
    except AttributeError:                     # test doubles / stubs
        return ("mesh", id(mesh))


@dataclasses.dataclass(frozen=True)
class SdtwRequest:
    """One offline call, as data: ``op='sdtw'`` (the engine) or
    ``op='search_topk'`` (the pruned search layer; its fields ``prune``,
    ``span_cap``, ``normalize``, ``cache``, ``ref_key`` and
    ``engine_impl`` are ignored by ``op='sdtw'``). ``impl='pallas'`` and
    ``engine_impl='pallas'`` name the repo's hand-written sDTW kernel
    (CUDA on the card, its plain version on the CPU). ``run()``
    validates and executes — the path the keyword front doors take."""
    queries: Any = None
    reference: Any = None
    qlens: Any = None
    metric: str = "abs_diff"
    impl: str = "auto"
    chunk: Optional[int] = None
    excl_lo: Any = None
    excl_hi: Any = None
    mesh: Any = None
    mesh_shape: Any = None
    ref_axis: str = "ref"
    n_micro: Optional[int] = None
    top_k: Optional[int] = None
    return_positions: bool = False
    return_spans: bool = False
    excl_zone: Any = None
    excl_mode: str = "end"
    block_q: Optional[int] = None
    block_m: Optional[int] = None
    tune: str = "model"
    explain: bool = False
    op: str = "sdtw"
    device: Any = None
    # --- serve-tier-only -------------------------------------------------
    # Scheduling metadata, as in the reference: ``priority`` (an int,
    # higher drains sooner) and ``tenant`` (hashable, keys quotas) are
    # validated and ignored by ``run()``; ``repro_torch.serve``'s
    # admission queue reads them.
    priority: int = 0
    tenant: Any = None
    # --- search_topk-only ------------------------------------------------
    prune: bool = True
    span_cap: Optional[int] = None
    normalize: bool = False
    cache: Any = None
    ref_key: Any = None
    engine_impl: str = "auto"

    @classmethod
    def from_kwargs(cls, **kwargs) -> "SdtwRequest":
        """Build a request from a kwargs dict, rejecting unknown keys."""
        _reject_unknown(cls, kwargs)
        return cls(**kwargs)

    def validate(self) -> "SdtwRequest":
        """Run every front-door check; returns ``self``."""
        if self.op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {self.op!r}")
        if not isinstance(self.priority, int) \
                or isinstance(self.priority, bool):
            raise ValueError(f"priority must be an int (higher drains "
                             f"sooner), got {self.priority!r}")
        try:
            hash(self.tenant)
        except TypeError:
            raise ValueError(f"tenant must be hashable (it keys per-tenant "
                             f"quotas), got {type(self.tenant).__name__}") \
                from None
        if self.tune not in TUNE_MODES:
            raise ValueError(f"tune must be one of {TUNE_MODES}, got "
                             f"{self.tune!r}")
        if self.op == "search_topk":
            return self._validate_search()
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{self.impl!r}")
        if self.excl_mode not in EXCL_MODES:
            raise ValueError(f"excl_mode must be one of {EXCL_MODES}, got "
                             f"{self.excl_mode!r}")
        if (self.excl_lo is None) != (self.excl_hi is None):
            raise ValueError("excl_lo and excl_hi must be given together "
                             "(a one-sided zone would silently ban nothing)")
        if self.top_k is not None and (not isinstance(self.top_k, int)
                                       or self.top_k < 1):
            raise ValueError(f"top_k must be a positive int, got "
                             f"{self.top_k!r}")
        if isinstance(self.queries, (list, tuple)) and self.qlens is not None:
            raise ValueError("qlens is implied by ragged (list) queries")
        if self.excl_mode == "span" and self.top_k is None:
            raise ValueError("excl_mode='span' only affects top-K "
                             "suppression; pass top_k= (k=1 selection "
                             "never suppresses)")
        mesh = resolve_mesh(self.mesh, self.mesh_shape)
        _check_forced_impl(self.impl, mesh=mesh, chunk=self.chunk,
                           top_k=self.top_k)
        _check_sharded_args(mesh=mesh, impl=self.impl, n_micro=self.n_micro,
                            excl_zone=self.excl_zone, top_k=self.top_k,
                            return_positions=self.return_positions)
        return self

    def _validate_search(self) -> "SdtwRequest":
        # The search front door spells top_k as ``k`` and keeps its own
        # message wording, as in the reference.
        if self.top_k is None or not isinstance(self.top_k, int) \
                or self.top_k < 1:
            raise ValueError(f"k must be a positive int, got {self.top_k!r}")
        if self.excl_mode not in EXCL_MODES:
            raise ValueError(f"excl_mode must be 'end' or 'span', got "
                             f"{self.excl_mode!r}")
        if (self.excl_lo is None) != (self.excl_hi is None):
            raise ValueError("excl_lo and excl_hi must be given together "
                             "(a one-sided zone would silently ban nothing)")
        if self.excl_zone is not None and np.ndim(self.excl_zone) != 0:
            raise ValueError("search_topk takes a scalar excl_zone (or "
                             "None for the per-query default); per-query "
                             "zone arrays run on engine.sdtw's chunked "
                             "path")
        mesh = resolve_mesh(self.mesh, self.mesh_shape)
        if mesh is not None and self.prune:
            raise ValueError("mesh= runs the sharded engine over every "
                             "chunk; pass prune=False explicitly (the LB "
                             "cascade is single-process)")
        if self.engine_impl not in SEARCH_ENGINE_IMPLS:
            raise ValueError(f"engine_impl must be 'auto', 'rowscan' or "
                             f"'pallas', got {self.engine_impl!r}")
        has_excl = self.excl_lo is not None or self.excl_hi is not None
        if self.engine_impl == "pallas" and has_excl:
            raise ValueError("the pallas kernel does not support per-query "
                             "exclusion zones; use engine_impl='rowscan'")
        if isinstance(self.queries, (list, tuple)) and self.qlens is not None:
            raise ValueError("qlens is implied by ragged (list) queries")
        return self

    def normalized(self) -> "SdtwRequest":
        """Validate and return the canonical form: ``mesh_shape`` resolved
        to a mesh, so dispatch and coalescing see one field."""
        self.validate()
        if self.mesh_shape is None:
            return self
        return dataclasses.replace(
            self, mesh=resolve_mesh(self.mesh, self.mesh_shape),
            mesh_shape=None)

    def run(self):
        """Validate and execute — identical to calling the keyword front
        door (``engine.sdtw`` / ``search_topk``)."""
        req = self.normalized()
        if req.op == "search_topk":
            from repro_torch.search import search as search_mod
            return search_mod._execute_search(req)
        from repro_torch.core import engine
        return engine._execute_sdtw(req)

    def coalesce_key(self, ref_id=None):
        """Hashable key under which requests may share one batched engine
        call (the reference's, with the device folded in: a CPU request
        and a card request never merge): everything that selects a launch
        or changes per-query semantics except the queries themselves, the
        reference folded in via ``ref_id``. Per-query exclusion arrays key
        by object identity, so such requests never coalesce."""
        from repro_torch.device import resolve_device
        return (self.op, self.metric, self.impl, self.chunk,
                self.top_k, self.return_positions, self.return_spans,
                self.excl_mode, self.block_q, self.block_m, self.tune,
                self.ref_axis, self.n_micro,
                _mesh_fingerprint(resolve_mesh(self.mesh, self.mesh_shape)),
                str(resolve_device(self.device)),
                _scalar_or_id(self.excl_zone),
                _scalar_or_id(self.excl_lo), _scalar_or_id(self.excl_hi),
                bool(self.prune) if self.op == "search_topk" else None,
                self.span_cap if self.op == "search_topk" else None,
                bool(self.normalize) if self.op == "search_topk" else None,
                self.engine_impl if self.op == "search_topk" else None,
                ref_id)


def _scalar_or_id(val):
    """Coalesce-key component for a possibly-array argument: scalars
    coalesce by value, arrays never coalesce across requests."""
    if val is None:
        return None
    if np.ndim(val) == 0:
        return ("s", float(val))
    return ("a", id(val))


def _reject_unknown(cls, kwargs):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kwargs) - fields)
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} argument(s) {unknown}; valid "
            f"arguments are {sorted(fields)}")


@dataclasses.dataclass(frozen=True)
class StreamRequest:
    """One streaming session, as data — ``engine.stream``'s argument
    surface. ``open()`` validates and returns the live ``StreamSession``,
    exactly as the keyword front door would. ``device`` is where the
    session's queries and carries live (``None``: the CUDA device)."""
    queries: Any = None
    qlens: Any = None
    metric: str = "abs_diff"
    impl: str = "auto"
    chunk: Optional[int] = None
    mesh: Any = None
    mesh_shape: Any = None
    ref_axis: str = "ref"
    n_micro: Optional[int] = None
    top_k: Optional[int] = None
    excl_zone: Any = None
    excl_mode: str = "end"
    return_spans: bool = False
    return_positions: bool = False
    excl_lo: Any = None
    excl_hi: Any = None
    prune: bool = False
    span_cap: Optional[int] = None
    alert_threshold: Any = None
    on_alert: Any = None
    cache: Any = None
    ref_key: Any = None
    block_q: Optional[int] = None
    block_m: Optional[int] = None
    device: Any = None

    @classmethod
    def from_kwargs(cls, **kwargs) -> "StreamRequest":
        """Build a request from a kwargs dict, rejecting unknown keys."""
        _reject_unknown(cls, kwargs)
        return cls(**kwargs)

    def validate(self) -> "StreamRequest":
        """Front-door checks for ``engine.stream``: the sharded-session
        rejections (pruning, alerts, the envelope cache and ``span_cap``
        are single-process), then the session-argument checks, in the
        reference's order."""
        if self.impl not in STREAM_IMPLS:
            raise ValueError(
                f"impl must be 'auto', 'rowscan', 'pallas' or 'sharded' "
                f"for streaming, got {self.impl!r}")
        mesh = resolve_mesh(self.mesh, self.mesh_shape)
        if self.n_micro is not None and mesh is None \
                and self.impl != "sharded":
            raise ValueError("n_micro= schedules the sharded systolic "
                             "pipeline; pass mesh=/mesh_shape= (or "
                             "impl='sharded') or drop n_micro=")
        if mesh is not None or self.impl == "sharded":
            if self.prune:
                raise ValueError("mesh= streams every chunk; the LB cascade "
                                 "is single-process (drop prune=True)")
            if self.alert_threshold is not None or self.on_alert is not None:
                raise ValueError("alerts are single-process; drop mesh=")
            if self.cache is not None or self.ref_key is not None:
                raise ValueError("the envelope cache is built by the "
                                 "single-process pruning path; "
                                 "cache=/ref_key= have no effect on a "
                                 "sharded session (drop them or drop "
                                 "mesh=)")
            if self.span_cap is not None:
                raise ValueError("span_cap= only bounds the pruned path; a "
                                 "sharded session streams every chunk "
                                 "exactly")
            return self
        return self.validate_session()

    def validate_session(self) -> "StreamRequest":
        """The single-process session checks — ``StreamSession.__init__``
        delegates here, so a directly constructed session and the
        ``engine.stream`` front door cannot drift."""
        if self.excl_mode not in EXCL_MODES:
            raise ValueError(f"excl_mode must be one of {EXCL_MODES}, got "
                             f"{self.excl_mode!r}")
        if self.top_k is not None and (not isinstance(self.top_k, int)
                                       or self.top_k < 1):
            raise ValueError(f"top_k must be a positive int, got "
                             f"{self.top_k!r}")
        if self.excl_mode == "span" and self.top_k is None \
                and not self.return_spans:
            raise ValueError("excl_mode='span' only affects top-K "
                             "suppression; pass top_k=")
        if (self.excl_lo is None) != (self.excl_hi is None):
            raise ValueError("excl_lo and excl_hi must be given together")
        if self.prune and self.top_k is None:
            raise ValueError("prune=True reports the top-K heap only; "
                             "pass top_k=")
        if self.prune and self.alert_threshold is not None:
            raise ValueError("alerts need every tile's candidate row, "
                             "which pruning skips; use prune=False for a "
                             "threshold monitor")
        if self.impl == "pallas" and self.excl_lo is not None:
            raise ValueError("the pallas kernel does not support "
                             "exclusion zones; use impl='rowscan'")
        if self.chunk is not None and int(self.chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {int(self.chunk)}")
        return self

    def open(self):
        """Validate and open the session — identical to
        ``engine.stream(**kwargs)``. A mesh (or ``impl='sharded'``) opens
        the ``ShardedStreamSession``. Otherwise ``impl='auto'`` takes the
        kernel on a CUDA device (top-K heaps, alerts and pruning all score
        on its last-row capture; per-query exclusion ranges are its column
        ban), and the rowscan tile loop elsewhere."""
        from repro_torch.device import resolve_device
        from repro_torch.stream import ShardedStreamSession, StreamSession
        self.validate()
        mesh = resolve_mesh(self.mesh, self.mesh_shape)
        if mesh is not None or self.impl == "sharded":
            return ShardedStreamSession(
                self.queries, qlens=self.qlens, metric=self.metric,
                mesh=mesh, axis=self.ref_axis, chunk=self.chunk,
                n_micro=self.n_micro, top_k=self.top_k,
                excl_zone=self.excl_zone, excl_mode=self.excl_mode,
                return_spans=self.return_spans,
                return_positions=self.return_positions,
                excl_lo=self.excl_lo, excl_hi=self.excl_hi,
                device=resolve_device(self.device))
        return StreamSession(
            self.queries, qlens=self.qlens, metric=self.metric,
            chunk=self.chunk, impl=self.impl, top_k=self.top_k,
            excl_zone=self.excl_zone, excl_mode=self.excl_mode,
            return_spans=self.return_spans,
            return_positions=self.return_positions,
            excl_lo=self.excl_lo, excl_hi=self.excl_hi, prune=self.prune,
            span_cap=self.span_cap, alert_threshold=self.alert_threshold,
            on_alert=self.on_alert, cache=self.cache, ref_key=self.ref_key,
            block_q=self.block_q, block_m=self.block_m,
            device=resolve_device(self.device))
