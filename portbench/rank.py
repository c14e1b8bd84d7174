"""One rank other than 0 of a run on several cards: started by rank 0
(``ranks.Ranks``) with the run's arguments and its own rank, store and
parent; never by hand. Writes nothing to standard output."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name in ("--workload", "--root", "--bench-dir", "--device", "--store"):
        ap.add_argument(name, required=True)
    for name in ("--seed", "--trace", "--rank", "--world", "--parent"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    from portbench import ranks

    ranks.die_with_parent(args.parent)
    import torch

    from portbench import harness

    harness.configure_process(Path(args.root))
    device = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device(args.device)
    try:
        group = ranks.join(args.rank, args.world, device, args.store)
        harness.follow(args.workload, args.seed, args.seconds, bool(args.trace), root=Path(args.root),
                       bench_dir=Path(args.bench_dir), group=group, fault=args.fault, t_start=T_START)
    except BaseException:  # noqa: BLE001 - rank 0 sees this rank exit non-zero and stops the run
        print(f"rank {args.rank}: failed\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        os._exit(1)
    sys.stderr.flush()
    os._exit(0)  # no teardown that could wait on another rank: rank 0 has every reading


if __name__ == "__main__":
    sys.exit(main())
