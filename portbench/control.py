"""Readings that set the check's limits, at a cell's own size on the card:
the numbers the check compares for the program and for a planted fault or
the control (the reference in bfloat16 in the program's place).

    python3 portbench/control.py --workload k1000-bulk --seeds 11,12,13 --seconds 2 --fault control

prints one line of compared numbers a seed. Without ``--fault`` it reads
the program itself. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)

    from portbench import harness

    fault = args.fault or None  # by name, so that every rank of a cell on several cards plants it
    harness.configure_process(ROOT)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False, root=ROOT, fault=fault)
        nums = {k: v["value"] for k, v in out["checks"].items()}
        print(json.dumps({"workload": args.workload, "fault": args.fault or "none", "seed": seed,
                          "correct": out["correct"], "checks": nums, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
