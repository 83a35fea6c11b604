"""Validate the cost model's *ranking* against measured rows, and fit the
card's constants to them.

Counterpart of ``repro.tune.validate``: the analytical stage is trusted
for ordering only, so every pair of measured rows of the *same shape*
must be ordered the same way by the model (ties in either ordering count
as agreement), with the reference's gate of a pairwise agreement of at
least 0.6 over at least 3 pairs.

Row families:

  * ``--backend h100``: the kernel times ``python -m
    repro_torch.tune.tuner --backend h100 --rows-out`` records on the card
    (``tables/h100_rows.json``: ``{"provenance", "rows": [{kernel, rows,
    warps, block_q, block_m, variant, ban, nq, n, m, us}, ...]}``), paired
    within one (variant, ban, nq, n, m) shape and priced by
    ``KernelCostModel.cuda_us``;
  * ``--backend interpret``: the reference's ``BENCH_baseline.json``
    rows, read as the reference reads them — ``sdtw_kernel/
    {rowscan_tropical|wavefront_paper_faithful|pallas_interpret}_b{B}_n{N}
    _m{M}`` (the in-core ranking; the pallas row at the reference's
    interpret default blocks) and ``engine_chunked_b{B}_n{N}_m{M}_c{C}``
    (the chunk ranking).

Usage::

    python -m repro_torch.tune.validate src/repro_torch/tune/tables/h100_rows.json \\
        --backend h100 --min-agreement 0.6 --min-pairs 3
    python -m repro_torch.tune.validate src/repro_torch/tune/tables/h100_rows.json \\
        --backend h100 --fit        # least-squares terms for H100_BACKEND
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import re

import numpy as np

from .cost import KernelCostModel, get_cost_model

_INCORE_RE = re.compile(
    r"sdtw_kernel/(rowscan_tropical|wavefront_paper_faithful|"
    r"pallas_interpret)_b(\d+)_n(\d+)_m(\d+)$")
_CHUNK_RE = re.compile(
    r"sdtw_kernel/engine_chunked_b(\d+)_n(\d+)_m(\d+)_c(\d+)$")
_IMPL_OF = {"rowscan_tropical": "rowscan",
            "wavefront_paper_faithful": "wavefront",
            "pallas_interpret": "pallas"}
#: The reference's interpret-mode kernel defaults (``repro.kernels.sdtw
#: .ops.resolve_blocks`` with ``interpret=True``): at most 32 queries a
#: block, a tile covering the reference up to 2**21 elements a block.
_INTERPRET_MAX_BLOCK_Q, _INTERPRET_ELEM_BUDGET = 32, 1 << 21


def _interpret_pallas_us(model, b: int, n: int, m: int) -> float:
    bq = max(1, min(_INTERPRET_MAX_BLOCK_Q, b))
    budget = max(16, _INTERPRET_ELEM_BUDGET // bq)
    bm = min(max(16, 1 << max(0, m - 1).bit_length()),
             1 << (budget.bit_length() - 1))
    return model.pallas_us(b, n, m, bq, bm, "assoc", 1)


def _interpret_groups(rows, model) -> dict:
    groups: dict = {}
    for row in rows:
        name, us = row["name"], float(row["us_per_call"])
        m1 = _INCORE_RE.match(name)
        if m1:
            impl = _IMPL_OF[m1.group(1)]
            b, n, m = (int(m1.group(i)) for i in (2, 3, 4))
            mu = (model.rowscan_us(b, n, m) if impl == "rowscan"
                  else model.wavefront_us(b, n, m) if impl == "wavefront"
                  else _interpret_pallas_us(model, b, n, m))
            groups.setdefault(("incore", b, n, m), []).append(
                (mu, us, name))
            continue
        m2 = _CHUNK_RE.match(name)
        if m2:
            b, n, m, c = (int(m2.group(i)) for i in (1, 2, 3, 4))
            groups.setdefault(("chunk", b, n, m), []).append(
                (model.chunked_us(b, n, m, c), us, name))
    return groups


def _label(row: dict) -> str:
    return (f"{row['kernel']}/R{row['rows']}/W{row['warps']}"
            f"/bq{row['block_q']} {row['variant']}{'+ban' * row['ban']} "
            f"{row['nq']}x{row['n']}x{row['m']}")


def _cuda_groups(rows, model) -> dict:
    groups: dict = {}
    for row in rows:
        mu = model.cuda_us(row["kernel"], row["nq"], row["n"], row["m"],
                           row["rows"], row["warps"], row["block_q"],
                           row["variant"], row["ban"])
        key = (row["variant"], row["ban"], row["nq"], row["n"], row["m"])
        groups.setdefault(key, []).append((mu, row["us"], _label(row)))
    return groups


def extract_pairs(rows, backend: str = "interpret", model=None):
    """Comparable (model_us, measured_us, label) entries grouped by
    shape; returns the flat list of intra-group pairs."""
    model = model or get_cost_model(backend)
    groups = (_cuda_groups(rows, model) if backend == "h100"
              else _interpret_groups(rows, model))
    pairs = []
    for members in groups.values():
        pairs.extend(itertools.combinations(members, 2))
    return pairs


def validate_ranking(rows, *, backend: str = "interpret", model=None):
    """Pairwise-majority check. Returns ``(agree, total, report)``."""
    pairs = extract_pairs(rows, backend, model)
    agree, report = 0, []
    for (mu_a, us_a, name_a), (mu_b, us_b, name_b) in pairs:
        model_sign = (mu_a > mu_b) - (mu_a < mu_b)
        meas_sign = (us_a > us_b) - (us_a < us_b)
        ok = model_sign == 0 or meas_sign == 0 or model_sign == meas_sign
        agree += ok
        report.append(
            f"{'ok       ' if ok else 'DISAGREES'} {name_a} vs {name_b}: "
            f"model {mu_a:.0f}us vs {mu_b:.0f}us, measured "
            f"{us_a:.0f}us vs {us_b:.0f}us")
    return agree, len(pairs), report


def load_rows(path: str) -> list:
    """The measured rows of a file: a bench row list (CPU) or the card's
    ``{"rows": [...]}`` record."""
    with open(path) as f:
        raw = json.load(f)
    return raw["rows"] if isinstance(raw, dict) else raw


def fit_cuda(rows, base=None, sat_grid=np.arange(1.0, 64.5, 0.5)):
    """Least-squares fit of the card's per-kernel terms to measured rows:
    for each kernel, over a grid of ``sat_warps``, the cell instructions
    of each variant and the step instructions that minimise the relative
    error of ``cuda_us`` (linear in them once ``sat_warps`` is fixed; the
    memory term is left out), and the best ``sat_warps``. Returns a new
    ``CudaBackendModel`` and the fitted model's median relative error
    over the rows."""
    from repro_torch.core.platforms import H100_BACKEND, CudaKernelTerms
    from .cost import VARIANTS
    be = base or H100_BACKEND
    kernels = []
    for kernel, terms in be.kernels:
        krows = [r for r in rows if r["kernel"] == kernel]
        if not krows:
            kernels.append((kernel, terms))
            continue
        best = None
        for sat in sat_grid:
            # time_us = (m + fill) · max(w_sm, sat) / issue
            #           · (rows · cell[variant] + step), each row / time_us
            a = []
            for r in krows:
                blocks = -(-r["nq"] // r["block_q"])
                w_sm = -(-blocks // be.sms) * r["block_q"] * r["warps"]
                fill = (r["n"] if kernel == "wavefront"
                        else terms.fill_steps * r["warps"])
                scale = (r["m"] + fill) * max(w_sm, sat) / be.issue_per_sm \
                    * 1e6
                row = [0.0] * (len(VARIANTS) + 1)
                row[VARIANTS.index(r["variant"])] = r["rows"] * scale
                row[-1] = scale
                a.append([v / r["us"] for v in row])
            a = np.asarray(a)
            coef, *_ = np.linalg.lstsq(a, np.ones(len(a)), rcond=None)
            err = float(np.median(np.abs(a @ coef - 1.0)))
            if best is None or err < best[0]:
                best = (err, sat, coef)
        _, sat, coef = best
        cells = tuple((v, float(coef[i]) if any(
            r["variant"] == v for r in krows) else terms.cell(v))
            for i, v in enumerate(VARIANTS))
        kernels.append((kernel, CudaKernelTerms(
            cell_instr=cells, step_instr=float(coef[-1]),
            sat_warps=float(sat), fill_steps=terms.fill_steps)))
    fitted = dataclasses.replace(be, kernels=tuple(kernels))
    model = KernelCostModel(fitted)
    rel = [abs(model.cuda_us(r["kernel"], r["nq"], r["n"], r["m"],
                             r["rows"], r["warps"], r["block_q"],
                             r["variant"], r["ban"]) / r["us"] - 1)
           for r in rows]
    return fitted, float(np.median(rel))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("baseline", help="measured rows (JSON)")
    ap.add_argument("--backend", default="interpret")
    ap.add_argument("--min-agreement", type=float, default=0.6,
                    help="required pairwise-majority fraction")
    ap.add_argument("--min-pairs", type=int, default=3,
                    help="fail if fewer comparable pairs are found")
    ap.add_argument("--fit", action="store_true",
                    help="print the card's terms fitted to the rows")
    args = ap.parse_args(argv)
    rows = load_rows(args.baseline)
    if args.fit:
        fitted, err = fit_cuda(rows)
        for kernel, terms in fitted.kernels:
            print(f"{kernel}: {terms}")
        print(f"median relative error {err:.3f} over {len(rows)} rows")
        return
    agree, total, report = validate_ranking(rows, backend=args.backend)
    for line in report:
        print("  " + line)
    frac = agree / total if total else 0.0
    print(f"cost-model ranking: {agree}/{total} pairs agree "
          f"({frac:.0%}; need >= {args.min_agreement:.0%} over >= "
          f"{args.min_pairs} pairs)")
    if total < args.min_pairs:
        raise SystemExit(
            f"only {total} comparable pairs found (need "
            f"{args.min_pairs}) — did the row names drift?")
    if frac < args.min_agreement:
        raise SystemExit(
            f"cost-model ranking disagrees with the measured rows: "
            f"{agree}/{total} = {frac:.0%} < {args.min_agreement:.0%}")
    print("cost-model ranking gate passed")


if __name__ == "__main__":
    main()
