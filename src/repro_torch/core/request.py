"""The request object behind ``engine.sdtw`` — one argument surface.

Counterpart of ``repro.core.request`` for ``op='sdtw'``: a frozen
``SdtwRequest`` holds the call's arguments, ``validate()`` runs the
front-door checks with the reference's messages, and ``run()`` dispatches
to ``engine._execute_sdtw``. What later slices of the port bring raises
``NotImplementedError`` naming its item in ``ROADMAP.md`` (queue 1):
meshes and ``impl='sharded'`` (item 12), ``op='search_topk'`` (item 8),
tuning modes other than ``'off'`` and ``explain=True`` (item 11; int32
answers do not depend on tuning). ``StreamRequest`` waits for item 9.

Argument semantics (as in the reference):

  * ``excl_zone`` — top-K suppression radius between reported matches;
    ``None`` derives it per query (half the true length with
    ``excl_mode='end'``, 0 with ``'span'``); a scalar applies to all; a
    per-query ``(nq,)`` array is honoured by the chunked path.
  * ``excl_lo``/``excl_hi`` — banned reference column range (self-join
    exclusion); given together or not at all.
  * ``device`` — where the call runs: ``None`` means the CUDA device,
    ``"cpu"`` the plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

IMPLS = ("auto", "rowscan", "wavefront", "pallas", "chunked", "sharded")
EXCL_MODES = ("end", "span")
OPS = ("sdtw", "search_topk")
TUNE_MODES = ("model", "measure", "off")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"item {item})")


def _check_forced_impl(impl: str, *, chunk, top_k):
    """Explicit precedence for forced impls: reject contradictory args."""
    if impl in ("rowscan", "wavefront"):
        if chunk is not None:
            raise ValueError(
                f"impl={impl!r} runs in-core and would ignore chunk=; drop "
                "chunk= or use impl='chunked'/'pallas' for streaming")
        if top_k is not None:
            raise ValueError(
                f"impl={impl!r} does not carry a top-K heap; top_k= runs on "
                "the chunked/sharded streaming paths (impl='auto' routes it)")
    elif impl == "pallas" and top_k is not None:
        raise ValueError(
            "impl='pallas' reports the single best match "
            "(return_positions/return_spans); offline top_k= runs on "
            "the chunked/sharded streaming paths — the kernel's "
            "last-row capture serves top-K via repro.search "
            "(engine_impl='pallas') and streaming sessions")


@dataclasses.dataclass(frozen=True)
class SdtwRequest:
    """One offline sDTW call, as data. ``impl='pallas'`` names the
    repo's hand-written sDTW kernel (CUDA on the card, its plain version
    on the CPU). ``run()`` validates and executes — the path
    ``engine.sdtw`` takes."""
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
    tune: str = "off"
    explain: bool = False
    op: str = "sdtw"
    device: Any = None

    @classmethod
    def from_kwargs(cls, **kwargs) -> "SdtwRequest":
        """Build a request from a kwargs dict, rejecting unknown keys."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(kwargs) - fields)
        if unknown:
            raise ValueError(
                f"unknown {cls.__name__} argument(s) {unknown}; valid "
                f"arguments are {sorted(fields)}")
        return cls(**kwargs)

    def validate(self) -> "SdtwRequest":
        """Run every front-door check; returns ``self``."""
        if self.op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {self.op!r}")
        if self.tune not in TUNE_MODES:
            raise ValueError(f"tune must be one of {TUNE_MODES}, got "
                             f"{self.tune!r}")
        if self.op == "search_topk":
            raise _not_ported("op='search_topk' (pruned search)", 8)
        if self.tune != "off":
            raise _not_ported(f"tune={self.tune!r} (no fitted H100 cost "
                              f"model yet)", 11)
        if self.explain:
            raise _not_ported("explain=True", 11)
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{self.impl!r}")
        if (self.mesh is not None or self.mesh_shape is not None
                or self.impl == "sharded"):
            raise _not_ported("the sharded driver (mesh=, mesh_shape=, "
                              "impl='sharded')", 12)
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
        _check_forced_impl(self.impl, chunk=self.chunk, top_k=self.top_k)
        if self.n_micro is not None:
            raise ValueError("n_micro= schedules the sharded systolic "
                             "pipeline; pass mesh=/mesh_shape= (or "
                             "impl='sharded') or drop n_micro=")
        return self

    def run(self):
        """Validate and execute — identical to calling ``engine.sdtw``."""
        from repro_torch.core import engine
        return engine._execute_sdtw(self.validate())
