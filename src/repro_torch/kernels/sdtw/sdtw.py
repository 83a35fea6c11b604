"""Plain PyTorch version of the sDTW kernel.

``sdtw_kernel_plain`` computes exactly what the three hand-written Hopper
kernels (``csrc/sdtw_rows.cu``, ``csrc/sdtw_chain.cu`` and ``csrc/sdtw.cu``)
compute — the contract of the reference's Pallas kernel
``repro.kernels.sdtw.sdtw._sdtw_kernel`` under ``sdtw_pallas`` — with
stock tensor operations: a loop over the N query rows, each row solved
over the whole reference by a (min,+) prefix scan
(``repro_torch.core.sdtw.tropical_scan``). The CPU tests run it against
the JAX package, and ``chip_smoke.py`` holds the CUDA kernels against it
on the card. The ``sdtw_cuda`` wrapper runs it for tensors that lie on
the CPU; nothing runs it for CUDA tensors.

The contract, per query b with carry ``(bcol, best, pos[, bstart,
start])`` and scalars ``ref_offset``, ``ref_len``, ``ref_lead``:

  * all N rows are computed, padded rows (``i >= qlen``) included, since
    the returned boundary column covers every row;
  * columns ``< ref_lead`` or ``>= ref_len`` are masked to BIG (start
    lane INT_FAR), and so is query b's banned range of global columns
    ``[excl_lo[b], excl_hi[b])`` when one is given (the reference's row
    scan sets banned distances to BIG, so its values there are BIG too);
  * row 0 is a free start (``S[0, j] = d``, start = global column
    ``ref_offset + j``) and ignores the carry; row i ≥ 1 enters column 0
    from ``bcol[i]`` (left) and ``bcol[i - 1]`` (diagonal);
  * row ``qlen - 1`` is the last row: its minimum improves ``best`` only
    on strict improvement, at its leftmost column (global position), so
    earlier slices win ties; in span mode its start lane gives ``start``;
  * the boundary column exits at column ``ref_len - 1``; with
    ``ref_len <= 0`` the carry passes through unchanged;
  * ``want_lastrow`` also returns row ``qlen - 1`` per column (BIG where
    masked) and, in span mode, its start lane.

int32 accumulation saturates against INT_BIG and is bitwise equal to the
kernels' direct recurrence (saturating min-plus is exactly associative);
float32 differs from the kernels only in summation order. One lane is
order-dependent: the start of a cell whose value saturates at BIG
(unspecified in the reference too) may differ between the scan and the
direct recurrence; masked columns are forced to INT_FAR in both.
"""
from __future__ import annotations

import torch

from repro_torch.core.distances import INT_FAR, big, lex_min, sat_add
from repro_torch.core.sdtw import shift_right, tropical_scan


def _distance(q, r, metric):
    d = q - r
    return torch.abs(d) if metric == "abs_diff" else d * d


def sdtw_kernel_plain(q, r, qlens, metric, bcol, best, pos, bstart=None,
                      start=None, ref_offset: int = 0, ref_len: int = None,
                      ref_lead: int = 0, want_lastrow: bool = False,
                      excl_lo=None, excl_hi=None):
    """The kernel's raw contract on tensors in the accumulator dtype.

    Args:
      q:      (B, N) queries, already in the accumulator dtype.
      r:      (M,) reference, already in the accumulator dtype.
      qlens:  (B,) int32 true query lengths.
      bcol, best, pos: the carry in — (B, N) acc, (B,) acc, (B,) int32.
      bstart, start:   the span-mode carry lanes (B, N), (B,) int32;
                       passing ``bstart`` selects span mode.
      ref_offset, ref_len, ref_lead: the slice's global column offset,
                       its true length and its masked lead (Python ints).
      want_lastrow:    also return row ``qlen - 1``.
      excl_lo, excl_hi: (B,) int32 banned global column range per query,
                       or ``None``.

    Returns ``(best, pos, start, bcol_out, bstart_out, lastrow,
    lastrow_start)``; the span-mode and last-row entries are ``None`` when
    not requested.
    """
    track = bstart is not None
    acc = q.dtype
    BIG = big(acc)
    b, n = q.shape
    m = r.shape[0]
    rlen = m if ref_len is None else int(ref_len)
    dev = q.device
    j = torch.arange(m, device=dev)[None, :]
    col_ok = (j >= int(ref_lead)) & (j < rlen)
    gcol = (int(ref_offset) + j).to(torch.int32)
    if excl_lo is not None:
        col_ok = col_ok & ~((gcol >= excl_lo.reshape(b, 1))
                            & (gcol < excl_hi.reshape(b, 1)))
    hrow = qlens.to(torch.int32).reshape(b, 1) - 1
    exit_col = min(max(rlen - 1, 0), m - 1)

    s = sstart = None
    lrow = torch.full((b, m), BIG, dtype=acc, device=dev)
    lstart = torch.full((b, m), INT_FAR, dtype=torch.int32, device=dev)
    exits, sexits = [], []
    for i in range(n):
        d = torch.where(col_ok, _distance(q[:, i:i + 1], r[None, :], metric),
                        BIG)
        if i == 0:                                   # free-start row
            s = d
            sstart = torch.where(col_ok, gcol, INT_FAR).expand(b, m)
        else:
            prev_sh = shift_right(s, bcol[:, i - 1:i])
            if track:
                mn, mns = lex_min(prev_sh, shift_right(sstart,
                                                        bstart[:, i - 1:i]),
                                  s, sstart)
                a_p, u_p, su_p = tropical_scan(d, sat_add(d, mn), mns)
                s, sstart = lex_min(u_p, su_p, sat_add(a_p, bcol[:, i:i + 1]),
                                    bstart[:, i:i + 1])
                sstart = torch.where(col_ok, sstart, INT_FAR)
            else:
                a_p, u_p, _ = tropical_scan(d, sat_add(d, torch.minimum(prev_sh,
                                                                        s)))
                s = torch.minimum(u_p, sat_add(a_p, bcol[:, i:i + 1]))
            s = torch.where(col_ok, s, BIG)
        at_last = hrow == i
        lrow = torch.where(at_last, s, lrow)
        if track:
            lstart = torch.where(at_last, sstart, lstart)
        exits.append(s[:, exit_col].clone())      # not a view: frees s
        if track:
            sexits.append(sstart[:, exit_col].clone())

    if rlen > 0:
        bcol_out = torch.stack(exits, dim=1)
        bstart_out = torch.stack(sexits, dim=1) if track else None
    else:                                            # empty slice
        bcol_out = bcol.clone()
        bstart_out = bstart.clone() if track else None

    row_min = lrow.min(dim=1, keepdim=True).values
    cand = torch.where(lrow == row_min, gcol, INT_FAR).min(dim=1,
                                                           keepdim=True).values
    improve = (row_min < best[:, None])[:, 0]
    best_out = torch.minimum(best, row_min[:, 0])
    pos_out = torch.where(improve, cand[:, 0], pos)
    start_out = None
    if track:
        cand_start = torch.where(gcol == cand, lstart, INT_FAR).min(dim=1).values
        start_out = torch.where(improve, cand_start, start)
    if not want_lastrow:
        return best_out, pos_out, start_out, bcol_out, bstart_out, None, None
    return (best_out, pos_out, start_out, bcol_out, bstart_out, lrow,
            lstart if track else None)
