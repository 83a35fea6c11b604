"""The readings that a cell's limits are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>]

For each seed, in one process: the cell's set-up, a short window of the
program at the cell's own size and load, and then the numbers compared
twice: the program's answers against the plain reference (the lower
reading), and the control's in their place (the reference in int16
lanes, ``reference.BIG16``; the upper reading). One JSON line a seed.
With ``--fault``, one of the ``FAULTS`` of the cell's front door
(``perfbench/doors/<door>.py``) is planted in the program first, and its
answers must read not correct.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402

import importlib  # noqa: E402

from perfbench import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    if args.fault:
        _, _, mix = harness.cell_files(harness.load_benchmark(),
                                       args.workload)
        door = importlib.import_module(f"perfbench.doors.{mix['door']}")
        fault = {f.__name__: f for f in door.FAULTS}
        if args.fault not in fault:
            ap.error(f"--fault: one of {sorted(fault)}")
        fault[args.fault](setattr)
    for seed in args.seeds:
        res, checks, ctrl = harness.run_cell(
            args.workload, seed, args.seconds, 0, device="cuda",
            control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "program": {k: v for k, (v, _) in checks.items()},
            "control": {k: v for k, (v, _) in ctrl.items()},
            "limits": {k: lim for k, (_, lim) in checks.items()},
            "program_correct": res["correct"],
            "control_correct": harness.passes(ctrl),
            "calls": res["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
