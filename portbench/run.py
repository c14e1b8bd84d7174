"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output, and each number the check compared beside its limit as the
last lines of standard error. Exits non-zero, printing no result, without
enough CUDA devices for the cell, if JAX or the JAX package is loaded on any
rank, or if a rank of a cell on several cards fails, dies or stops
answering (``ranks.py``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.Bench(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    harness.configure_process(ROOT)
    several = cell["chips"] > 1
    if several:  # Ctrl-C ends this process at once; the other ranks end with it
        signal.signal(signal.SIGINT, signal.SIG_DFL)
    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), root=ROOT, t_start=T_START,
                          hard_exit=several)
    except RuntimeError as exc:
        print(f"run failed: {exc}", file=sys.stderr, flush=True)
        if several:
            os._exit(1)
        return 1
    print(json.dumps(out), flush=True)
    if several:  # no teardown of the process groups that could wait on a rank
        sys.stderr.flush()
        os._exit(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
