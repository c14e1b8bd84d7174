"""BENCHMARK.json and the files it names: the contract's form, discovery by
name, and the rule that nothing here imports JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    for word in SPEC["command"][1:]:
        assert ".." not in word and not word.startswith("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    full = 2 + 14 * 24
    assert full * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(group):
    entries = SPEC[group]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group in ("configs", "workloads") or key == "layer" and key in e:
                assert LINE.match(e[key]), e[key]


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"] not in files
        files.add(c["file"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and k in data for k in c["reduced"])
        assert data["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])


def test_workloads_and_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"} and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        mine = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_every_name_has_its_file():
    from portbench import harness

    bench = harness.Bench(ROOT)
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        mix = bench.mix(cell["traffic"])
        assert (HERE / "traffic" / f"{mix['driver']}.py").exists()
        bench.config(cell["config"])
        assert {"index_mismatches", "order_violations", "id_score_err",
                "ids_differ"} <= set(cell["check"]["limits"]) <= set(harness.COMPARED)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]).read)


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_import_rule(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if "reference" in path.relative_to(HERE).parts:
        assert tops <= {"__future__", "typing", "warnings", "numpy", "torch", "math"}, tops


def test_top_level_names_compared_whole():
    from portbench import harness

    assert "repro_torch" not in [m for m in ("repro_torch", "repro_torch.api") if m.split(".")[0] in harness.FORBIDDEN]
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")


def test_cell_added_as_files_only(tiny_bench, tmp_path):
    """A later cell, mix and metric are new files and new entries: nothing
    that exists is edited, and the run reports the new metric."""
    from portbench import harness
    from portbench.tiny import TINY_SEED

    root, bench = tiny_bench
    new_root = tmp_path / "root"
    shutil.copytree(root, new_root)
    nb = new_root / "portbench"
    (nb / "mixes" / "bulk-32.json").write_text(json.dumps({"driver": "bulk", "batch": 32, "max_qps": 2000,
                                                           "warmup_calls": 1}))
    cell = json.loads((nb / "workloads" / "k1000-bulk.json").read_text())
    cell.update(name="k1000-bulk32", traffic="bulk-32")
    (nb / "workloads" / "k1000-bulk32.json").write_text(json.dumps(cell))
    (nb / "metrics" / "calls_per_s.py").write_text("def read(run):\n    return run.rec.calls / run.rec.window_s\n")
    spec = json.loads((new_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "k1000-bulk32", "config": "msmarco-splade-k1000", "traffic": "bulk-32",
                              "chips": 1, "why": "a later cell"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["k1000-bulk32"]})
    (new_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run("k1000-bulk32", TINY_SEED, 0.5, False, root=new_root, device="cpu", bench_dir=nb,
                      check_modules=False)
    assert out["correct"] and set(out["metrics"]) == {"calls_per_s", "setup_s"}
