"""A tiny copy of the benchmark's files, run on the CPU: what its own tests drive."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

TINY_SEED = 2**31 + 17


def _edit(path: Path, **updates) -> None:
    data = json.loads(path.read_text())
    for key, value in updates.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data))


def make_tiny(dest: Path) -> tuple[Path, Path]:
    """A copy of BENCHMARK.json and this directory under ``dest``, every cell
    cut to a corpus the CPU builds in a second. Returns (root, bench dir)."""
    bench = dest / "portbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    # a corpus large enough that the traversal visits a fifth of it, so a
    # shuffled document order shows in recall
    _edit(bench / "configs" / "msmarco-splade-k1000.json", corpus={"n_docs": 8192, "vocab": 512, "n_topics": 8},
          query={"k": 50, "gamma": 12, "gamma0": 2})
    _edit(bench / "mixes" / "bulk-64.json", max_qps=2000, warmup_calls=1)
    # recall at this tiny point: 0.57-0.63 with the program's clustering,
    # 0.31-0.37 with a shuffled order (the cell's own limit is the chip's)
    limits = json.loads((bench / "workloads" / "k1000-bulk.json").read_text())["check"]["limits"]
    _edit(bench / "workloads" / "k1000-bulk.json",
          check={"sample": 24, "extra_rows": 16, "limits": dict(limits, recall_shortfall=0.5)})
    return dest, bench


def run_tiny(tiny, cell: str, seconds: float = 0.3, fault=None, seed: int = TINY_SEED) -> dict:
    from portbench import harness

    root, bench = tiny
    return harness.run(cell, seed, seconds, False, root=root, device="cpu", bench_dir=bench, fault=fault,
                       check_modules=False)
