"""LM serving driver: batched prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch mamba2-780m \
        --preset reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on the CUDA device unless ``--device`` names another. Prints one
JSON line with the JAX package's keys (``arch``, ``batch``,
``prefill_ms``, ``decode_ms_per_token``, ``tokens_per_s``,
``sample_output``) and the device it ran on. Times are host-clock spans
that end in a device synchronise.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models import RunConfig, init_lm, prefill
from ..train import make_serve_step


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    run = RunConfig(remat="none")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_lm(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    max_len = args.prompt_len + args.gen + 1

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, {"tokens": prompts}, max_len, run)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    serve = make_serve_step(cfg, run, sample=args.sample)
    tok = torch.argmax(logits, -1).to(torch.int32)
    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        tok, _, cache = serve(params, tok, cache, gen)
        outs.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = torch.stack(outs, 1).cpu()
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch,
        "prefill_ms": round(t_prefill * 1e3, 1),
        "decode_ms_per_token": round(t_decode * 1e3 / max(args.gen - 1, 1), 2),
        "tokens_per_s": round(args.batch * (args.gen - 1)
                              / max(t_decode, 1e-9), 1),
        "sample_output": [int(x) for x in out[0][:8]],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }))


if __name__ == "__main__":
    main()
