"""Mamba2 — the state-space duality (SSD) layer in PyTorch (the JAX
package's ``models/ssm.py``) [arXiv:2405.21060].

A full sequence runs the chunked SSD algorithm: within a chunk the
recurrence is evaluated in its quadratic "dual" form (batched products);
across chunks a loop carries the SSM state. Decode is the recurrence, one
token at a time (O(1) state per token).

Simplifications shared with the reference: n_groups = 1 (B/C shared
across heads), no dt clamping, the depthwise conv as a shift-sum.

Recurrence (per head h, state size N, head dim P):
    h_t = exp(A_h·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t        h: (P, N)
    y_t = C_t · h_t + D_h · x_t
followed by a gated RMSNorm (y ⊙ silu(z)) and the output projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Shard

from ..distributed.sharding import contiguous_strides, local_part
from ..distributed.sharding import pad as pad_
from ..distributed.sharding import replicated
from .layers import Init, rms_norm


class SSM(nn.Module):
    """``init_ssm``'s parameters."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        h, w = cfg.n_ssm_heads, cfg.ssm_conv
        self.in_proj = init.normal((d, 2 * di + 2 * n + h), d)
        self.conv_x = init.normal((w, di), w)
        self.conv_b = init.normal((w, n), w)
        self.conv_c = init.normal((w, n), w)
        self.dt_bias = init.zeros(h)
        self.A_log = init.const(torch.log(torch.linspace(1.0, 16.0, h)))
        self.D = init.ones(h)
        self.norm_w = init.ones(di)
        self.out_proj = init.normal((di, d), di)


def init_ssm(cfg, generator, device=None) -> SSM:
    return SSM(Init(device, generator), cfg)


def _split_proj(cfg, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di],
            proj[..., 2 * di:2 * di + n], proj[..., 2 * di + n:2 * di + 2 * n],
            proj[..., 2 * di + 2 * n:])


def _causal_conv(x, w, state=None):
    """Depthwise causal conv via shift-sum. x: (B, S, C), w: (W, C).

    state: (B, W-1, C) trailing context from previous tokens (decode); when
    given, returns (out, new_state)."""
    width = w.shape[0]
    if state is None:
        pad = replicated(torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                                     dtype=x.dtype, device=x.device), x)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
              for i in range(width))
    if state is None:
        return F.silu(out)
    return F.silu(out), xp[:, -(width - 1):]


def _ssd_chunked(cfg, xh, dt, a, b, c):
    """Chunked SSD scan.

    xh: (B,S,H,P), dt/a: (B,S,H) fp32 (a = A·dt ≤ 0), b/c: (B,S,N) fp32.
    Returns y: (B,S,H,P) plus the final state (B,H,P,N).
    """
    bs, s, h, p = xh.shape
    n = b.shape[-1]
    L = min(cfg.ssm_chunk, s)
    s_orig = s
    if s % L:
        # Pad with identity steps (dt=0 → a=0, zero input → state preserved,
        # padded outputs sliced off below).
        pad = L - s % L
        xh = pad_(xh, (0, 0, 0, 0, 0, pad))
        dt, a, b, c = (pad_(t, (0, 0, 0, pad)) for t in (dt, a, b, c))
        s = xh.shape[1]
    nc = s // L
    xc = xh.reshape(bs, nc, L, h, p).float()
    dtc = dt.reshape(bs, nc, L, h)
    ac = a.reshape(bs, nc, L, h)
    bc = b.reshape(bs, nc, L, n)
    cc = c.reshape(bs, nc, L, n)

    cs = torch.cumsum(ac, dim=2)                     # inclusive (B,nc,L,H)
    seg_end = cs[:, :, -1:, :]                       # total chunk decay

    # ---- intra-chunk (quadratic dual form) ----
    g = torch.einsum("bctn,bcsn->bcts", cc, bc)      # (B,nc,L,L)
    darg = cs[:, :, :, None, :] - cs[:, :, None, :, :]            # t,s,H
    tri = replicated(torch.tril(torch.ones((L, L), dtype=torch.bool,
                                           device=xh.device)), xh)
    decay = torch.exp(torch.where(tri[None, None, :, :, None], darg, -1e30))
    scores = g[..., None] * decay * dtc[:, :, None, :, :]         # (B,nc,t,s,H)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", scores, xc)

    # ---- per-chunk input state (contribution entering the carried state) ----
    w_in = torch.exp(seg_end - cs) * dtc             # (B,nc,L,H)
    state_in = torch.einsum("bcsh,bcshp,bcsn->bchpn", w_in, xc, bc)

    # ---- loop over chunks: prefix states ----
    seg_decay = torch.exp(seg_end[:, :, 0, :])       # (B,nc,H)
    hcur = replicated(torch.zeros((bs, h, p, n), dtype=torch.float32,
                                  device=xh.device), xh)
    prefix = []
    for j in range(nc):
        prefix.append(hcur)                          # state BEFORE chunk j
        hcur = seg_decay[:, j, :, None, None] * hcur + state_in[:, j]
    hprefix = torch.stack(prefix, dim=1)             # (B,nc,H,P,N)

    # ---- inter-chunk: y_inter[t] = exp(cs_t) · C_t · h_chunk_start ----
    y_inter = torch.einsum("bctn,bchpn->bcthp", cc, hprefix) * \
        torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(bs, s, h, p)[:, :s_orig]
    return y, hcur


def _ssd_per_block(cfg, xh, dt, a, b, c, axes):
    """``_ssd_chunked`` on each rank's block of batch and heads. The scan
    is independent across both, so under a mesh each rank runs it on its
    rows (over the data axes) and heads (over the model axis when it
    divides them); ``b`` and ``c``, shared by the heads, are whole over
    the model axis, and a rank's gradient for them is its heads' share
    of the sum. DTensor's own rules for the scan's products (on torch
    2.11) cannot flatten the split heads into their batch dims."""
    if not isinstance(xh, DTensor):
        return _ssd_chunked(cfg, xh, dt, a, b, c)
    th = axes.tp_if_divisible(cfg.n_ssm_heads)
    xh = axes.constrain(xh, "dp", None, th, None)
    dt, a = (axes.constrain(t, "dp", None, th) for t in (dt, a))
    b, c = (axes.constrain(t, "dp", None, None) for t in (b, c))
    model = (axes.mesh.dtensor_dims.index(axes.tp)
             if th is not None else None)
    shared = tuple(Partial() if i == model else q
                   for i, q in enumerate(b.placements))
    y, hfin = _ssd_chunked(
        cfg, *(local_part(t) for t in (xh, dt, a)),
        *(local_part(t, shared) for t in (b, c)))
    dm = xh.device_mesh
    hpl = tuple(Shard(1) if isinstance(q, Shard) and q.dim == 2 else q
                for q in xh.placements)
    hshape = (xh.shape[0], xh.shape[2], xh.shape[3], b.shape[-1])
    return (DTensor.from_local(y.contiguous(), dm, xh.placements,
                               run_check=False, shape=xh.shape,
                               stride=contiguous_strides(xh.shape)),
            DTensor.from_local(hfin.contiguous(), dm, hpl, run_check=False,
                               shape=hshape,
                               stride=contiguous_strides(hshape)))


def ssm_forward(params, cfg, x, state=None, axes=None):
    """Full-sequence SSD layer. x: (B,S,d) → (B,S,d).

    state: optional dict(h, conv) for serving; when given, returns
    (out, new_state) with ``conv`` the last W-1 pre-conv inputs and ``h``
    this sequence's final state from zero (the given ``h`` is not read,
    as in the reference)."""
    bs, s, d = x.shape
    h, p = cfg.n_ssm_heads, cfg.ssm_head_dim
    proj = x @ params.in_proj
    z, xs_raw, b_raw, c_raw, dt = _split_proj(cfg, proj)
    xs = _causal_conv(xs_raw, params.conv_x)
    b = _causal_conv(b_raw, params.conv_b)
    c = _causal_conv(c_raw, params.conv_c)
    if axes is not None:
        tdi = axes.tp_if_divisible(cfg.d_inner)
        xs = axes.constrain(xs, "dp", None, tdi)
        z = axes.constrain(z, "dp", None, tdi)
        # split over the heads as dt_bias is (in_proj splits d_model over
        # the model axis, so dt comes out a sum over it, which DTensor on
        # torch 2.11 cannot meet a split dt_bias with)
        dt = axes.constrain(dt, "dp", None,
                            axes.tp_if_divisible(cfg.n_ssm_heads))

    dtf = F.softplus(dt.float() + params.dt_bias.float())
    a = -torch.exp(params.A_log.float()) * dtf                   # (B,S,H)
    xh = xs.reshape(bs, s, h, p)
    y, hfin = _ssd_per_block(cfg, xh, dtf, a, b.float(), c.float(), axes)
    y = y + params.D.float()[None, None, :, None] * xh.float()
    y = y.reshape(bs, s, h * p).to(x.dtype)
    y = rms_norm(y * F.silu(z), params.norm_w, cfg.norm_eps)
    out = y @ params.out_proj
    if state is None:
        return out
    tail = torch.cat([xs_raw, b_raw, c_raw], dim=-1)[:, -(cfg.ssm_conv - 1):]
    return out, dict(state, h=hfin, conv=tail.to(state["conv"].dtype))


def ssm_decode_step(params, cfg, x, state, axes=None):
    """Single-token recurrence. x: (B,1,d); state: {h (B,H,P,N) fp32,
    conv (B, W-1, d_inner+2N)} → (out (B,1,d), new_state). Under a mesh
    (``axes``) dt is split over the heads as dt_bias is
    (``ssm_forward``)."""
    bs = x.shape[0]
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner
    proj = x @ params.in_proj
    z, xs, b, c, dt = _split_proj(cfg, proj)
    if axes is not None:
        dt = axes.constrain(dt, "dp", None,
                            axes.tp_if_divisible(cfg.n_ssm_heads))

    conv_state = state["conv"]                      # (B, W-1, di+2n)
    xs, sx = _causal_conv(xs, params.conv_x, conv_state[..., :di])
    b, sb = _causal_conv(b, params.conv_b, conv_state[..., di:di + n])
    c, sc = _causal_conv(c, params.conv_c, conv_state[..., di + n:])
    new_conv = torch.cat([sx, sb, sc], dim=-1)

    dtf = F.softplus(dt.float() + params.dt_bias.float())       # (B,1,H)
    decay = torch.exp(-torch.exp(params.A_log.float()) * dtf)
    xh = xs.reshape(bs, h, p).float()
    bf = b[:, 0].float()                            # (B,N)
    cf = c[:, 0].float()
    hs = decay[:, 0, :, None, None] * state["h"] + \
        (dtf[:, 0, :, None, None] * xh[..., None]) * bf[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", cf, hs)
    y = y + params.D.float()[None, :, None] * xh
    y = y.reshape(bs, 1, h * p).to(x.dtype)
    y = rms_norm(y * F.silu(z), params.norm_w, cfg.norm_eps)
    return y @ params.out_proj, {"h": hs, "conv": new_conv}


def init_ssm_state(cfg, batch: int, dtype=torch.bfloat16, device=None):
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "h": torch.zeros((batch, h, p, n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
    }
