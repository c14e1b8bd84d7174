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


SHARDED_CELL = "k1000-bulk-2rank"


def add_sharded_cell(tiny) -> str:
    """A cell of 2 ranks in the tiny copy: its configuration the tiny
    k1000 one served as a shard set through the program's process-group
    front end (build ``group_cut``), checked shard by shard (reference
    ``lsp_shards``). Returns the cell's name."""
    root, bench = tiny
    cfg = json.loads((bench / "configs" / "msmarco-splade-k1000.json").read_text())
    cfg.update(name="tiny-shards", build="group_cut", reference="lsp_shards")
    (bench / "configs" / "tiny-shards.json").write_text(json.dumps(cfg))
    cell = json.loads((bench / "workloads" / "k1000-bulk.json").read_text())
    cell.update(name=SHARDED_CELL, config="tiny-shards", chips=2)
    (bench / "workloads" / f"{SHARDED_CELL}.json").write_text(json.dumps(cell))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-shards", "source": cfg["source"], "file": "portbench/configs/tiny-shards.json",
                            "reduced": cfg["reduced"], "why": "a shard set served by the process group"})
    spec["workloads"].append({"name": SHARDED_CELL, "config": "tiny-shards", "traffic": "bulk-64", "chips": 2,
                              "why": "the process-group path"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(SHARDED_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return SHARDED_CELL
