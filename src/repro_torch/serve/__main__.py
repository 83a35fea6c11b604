"""``python -m repro_torch.serve`` — closed-loop offered-load driver for
the serving tier, on the card by default.

Spawns N closed-loop client threads (each submits, waits for its
result, repeats) against one ``Router``, then dumps the telemetry
snapshot as JSON, with the device the requests ran on. Counterpart of
``python -m repro.serve``; ``--device cpu`` runs the plain PyTorch
versions.

Example::

    python -m repro_torch.serve --clients 8 --requests 16 --qlen 128 \
        --reflen 4096 --op sdtw --window-ms 5 --stats-json stats.json
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device

from .queue import QueueFull
from .router import Router, RouterConfig


def _make_workload(rng, *, nq, qlen, reflen):
    reference = rng.standard_normal(reflen).astype(np.float32)
    queries = [rng.standard_normal((nq, qlen)).astype(np.float32)
               for _ in range(8)]
    return reference, queries


def run_load(router: Router, *, clients: int, requests: int, op: str,
             top_k, nq: int, qlen: int, reflen: int, seed: int = 0,
             priority_classes: int = 1, device=None):
    """Closed-loop load: each client thread submits ``requests`` calls
    back-to-back (tenant ``client{ci}``, priority ``ci %
    priority_classes``) to run on ``device`` (``None``: the card).
    Returns (completed, rejected)."""
    rng = np.random.default_rng(seed)
    reference, query_pool = _make_workload(rng, nq=nq, qlen=qlen,
                                           reflen=reflen)
    completed = [0] * clients
    rejected = [0] * clients

    def client(ci: int):
        for r in range(requests):
            q = query_pool[(ci + r) % len(query_pool)]
            try:
                if op == "search_topk":
                    router.search_topk(q, reference, k=top_k or 1,
                                       ref_key="bench-ref",
                                       tenant=f"client{ci}",
                                       priority=ci % priority_classes,
                                       device=device)
                else:
                    router.sdtw(q, reference, top_k=top_k,
                                tenant=f"client{ci}",
                                priority=ci % priority_classes,
                                device=device)
                completed[ci] += 1
            except QueueFull:
                rejected[ci] += 1

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(completed), sum(rejected)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Closed-loop offered load against the sDTW serving "
                    "router; prints a telemetry snapshot as JSON.")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent closed-loop clients (default 4)")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client (default 8)")
    ap.add_argument("--op", choices=("sdtw", "search_topk"),
                    default="sdtw")
    ap.add_argument("--top-k", type=int, default=None,
                    help="top-K matches per query (default: distance only)")
    ap.add_argument("--nq", type=int, default=4,
                    help="queries per request (default 4)")
    ap.add_argument("--qlen", type=int, default=128)
    ap.add_argument("--reflen", type=int, default=4096)
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="base microbatch coalescing window (default 2 ms; "
                         "the window adapts — closes early when "
                         "--window-full queries are pending, stretches to "
                         "--window-max-ms under light load)")
    ap.add_argument("--window-max-ms", type=float, default=None,
                    help="stretch bound for the adaptive window "
                         "(default 8 x --window-ms)")
    ap.add_argument("--window-full", type=int, default=64,
                    help="pending-query count that closes a window early "
                         "(a pow-2 bucket target; default 64)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission queue depth (default 256)")
    ap.add_argument("--admission", choices=("block", "reject"),
                    default="block")
    ap.add_argument("--device", type=str, default=None,
                    help="where the requests run: unset for the card "
                         "(an error without one), or 'cpu'")
    ap.add_argument("--devices", type=str, default=None,
                    help="device pool: 'all', an int (first-N CUDA "
                         "devices), or unset for the current device")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="spread clients over N priority classes "
                         "(client i gets priority i %% N; default 1)")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max pending requests per tenant (default none)")
    ap.add_argument("--no-dedup", action="store_true",
                    help="disable in-window identical-request dedup")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats-json", type=str, default=None,
                    help="also write the snapshot to this path")
    args = ap.parse_args(argv)

    devices = args.devices
    if devices is not None and devices != "all":
        devices = int(devices)
    config = RouterConfig(max_queue=args.max_queue,
                          window_ms=args.window_ms,
                          window_max_ms=args.window_max_ms,
                          window_full_queries=args.window_full,
                          admission=args.admission,
                          devices=devices,
                          tenant_quota=args.tenant_quota,
                          dedup=not args.no_dedup)
    with Router(config) as router:
        completed, rejected = run_load(
            router, clients=args.clients, requests=args.requests,
            op=args.op, top_k=args.top_k, nq=args.nq, qlen=args.qlen,
            reflen=args.reflen, seed=args.seed,
            priority_classes=max(1, args.priority_classes),
            device=args.device)
        snap = router.stats().as_dict()
    dev = resolve_device(args.device)
    snap["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")
    snap["offered"] = args.clients * args.requests
    snap["client_completed"] = completed
    snap["client_rejected"] = rejected
    out = json.dumps(snap, indent=2, sort_keys=True)
    print(out)
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
