"""Architecture + shape configuration system (a copy of the JAX package's
``configs/base.py``, with no JAX import).

Every assigned architecture is a frozen ``ArchConfig``; every assigned input
shape is a ``ShapeSpec``. The dry-run iterates the full cross product;
smoke tests use ``reduced()`` configs of the same family.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                   # dense FF dim (per-expert dim for MoE)
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (Zamba2-style): one shared attention block every `attn_every`
    # SSM layers (shared weights across invocations)
    attn_every: int = 0
    # modality frontend: "none" (token ids) | "stub" (precomputed embeddings)
    frontend: str = "none"
    tie_embeddings: bool = True
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.n_heads == 0:
            return 0
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs only (SSM / hybrid). Pure full-attention archs
        skip long_500k — recorded in DESIGN.md §Arch-applicability."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        hd = self.resolved_head_dim
        per_layer = 0
        attn = 0
        if self.n_heads:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            attn = q + kv + o + (self.n_heads * hd + 2 * self.n_kv_heads * hd
                                 if self.qkv_bias else 0)
        dense_ff = 3 * d * self.d_ff          # SwiGLU gate/up/down
        ssm = 0
        if self.has_ssm:
            di, st, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            ssm = (d * (2 * di + 2 * st + nh)      # in_proj (z,x,B,C,dt)
                   + self.ssm_conv * (di + 2 * st)  # conv
                   + 2 * nh                         # A, D
                   + di                             # gated norm
                   + di * d)                        # out_proj
        if self.family == "ssm":
            per_layer = ssm + 2 * d               # norms
        elif self.family == "hybrid":
            per_layer = ssm + 2 * d
            n_groups = self.n_layers // self.attn_every
            n += attn + dense_ff + 2 * d          # one shared block
        elif self.has_moe:
            per_layer = (attn + d * self.n_experts                 # router
                         + self.n_experts * 3 * d * self.d_ff + 2 * d)
        else:
            per_layer = attn + dense_ff + 2 * d
        n += self.n_layers * per_layer + d        # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of n_experts)."""
        if not self.has_moe:
            return self.param_count()
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        moe_active = self.n_layers * self.topk * 3 * self.d_model * self.d_ff
        return full - moe_all + moe_active

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, self.attn_every or 2),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=96 if self.d_ff else 0,
            vocab=256,
            head_dim=16 if self.n_heads else 0,
            n_experts=min(self.n_experts, 4),
            topk=min(self.topk, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.has_ssm else self.ssm_head_dim,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from . import ALL_ARCHS  # noqa: F401 — populate registry
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchConfig]:
    from . import ALL_ARCHS  # noqa: F401
    return dict(_REGISTRY)


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skips long_500k for quadratic archs
    (and records the skip) unless include_skipped."""
    out = []
    for name, cfg in all_archs().items():
        for sname, shape in SHAPES.items():
            skip = (sname == "long_500k" and not cfg.supports_long_context)
            if include_skipped or not skip:
                out.append((cfg, shape, skip))
    return out
