"""Whole runs of each cell at a tiny size on the CPU (the harness's look for
a chip skipped), with the check's control and each planted fault making
``correct`` come out false; the trace's reduction; the command's refusals."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import faults
from portbench.tiny import run_tiny

ROOT = Path(__file__).resolve().parents[1]


def test_tiny_run_is_correct(tiny_bench, cell="k1000-bulk"):
    import gc

    import torch

    threads = torch.get_num_threads()
    out = run_tiny(tiny_bench, cell)
    assert torch.get_num_threads() == threads and gc.get_freeze_count() == 0  # the caller's process as it was
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert all(v["value"] > 0 for k, v in out["metrics"].items())
    assert out["checks"]["index_mismatches"]["value"] == 0


def test_reduce_reads_the_window():
    from portbench import trace

    ev = [("spin_kernel(long)", 100, 101), ("k_a", 150, 250), ("Memcpy DtoH", 240, 300), ("k_b", 400, 450),
          ("k_a", 420, 430), ("spin_kernel(long)", 1100, 1101), ("k_late", 1200, 1300), ("k_early", 10, 90)]
    r = trace.reduce(ev)
    assert r["window_s"] == pytest.approx(1000e-9) and r["busy_s"] == pytest.approx((150 + 50) * 1e-9)
    assert r["kernels"] == 3
    assert dict(r["idle_gaps"]) == pytest.approx({"after window start / before k_a": 50e-9,
                                                  "after Memcpy DtoH / before k_b": 100e-9,
                                                  "after k_a / before window end": 650e-9})
    assert r["device_ops"][0][0] == "k_a" and r["device_ops"][0][1] == pytest.approx(110e-9)
    assert trace.reduce(ev[1:5]) is None


def test_op_rooflines_match_calls_to_kernels():
    import torch

    from portbench import trace, work

    class Ops:
        sbmax_kernel = boundsum_gather_kernel = doc_score_fwd_kernel = staticmethod(lambda *a: None)

    calls = trace.OpCalls(Ops, keep=1)
    packed = torch.zeros((4, 4), dtype=torch.int32)
    args = (packed, torch.tensor([[1]], dtype=torch.int32), torch.tensor([[1.0]]), 4, 4)
    with calls:
        Ops.sbmax_kernel(*args)
        Ops.sbmax_kernel(*args)
    events = [(0, 1000, "sbmax_kernel(unsigned int const*)"), (2000, 5000, "sbmax_kernel(unsigned int const*)")]
    least, device = trace.op_rooflines(calls, events)["sbmax"]
    assert device == pytest.approx(1e-6) and least == work.least_seconds(*work.sbmax_work(*args))
    assert trace.op_rooflines(calls, events[:1]) == {}


def test_forbidden_modules_named_whole(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in harness.forbidden_modules()


def _command(cwd: Path, *args: str):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "k1000-bulk", "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_command_refuses_without_a_card():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_command_fails_with_only_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run fails before it prints anything: the program is not there.
    (The harness's look for a card is skipped, as on a machine with one.)"""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json, sys; from pathlib import Path; from portbench import harness; "
            "print(json.dumps(harness.run('k1000-bulk', 3, 0.2, False, root=Path('.'), device='cpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


@pytest.mark.parametrize("fault", ["control", "alter_answer", "half_batch", "stale_index"])
def test_fault_is_caught(tiny_bench, fault):
    out = run_tiny(tiny_bench, "k1000-bulk", fault=faults.FAULTS[fault])
    failed = [n for n, v in out["checks"].items() if v["value"] > v["limit"]]
    assert not out["correct"] and failed, out["checks"]
    if fault == "control":
        assert out["checks"]["id_score_err"]["value"] > out["checks"]["id_score_err"]["limit"]


def test_shuffled_order_fails_recall_alone(tiny_bench):
    """A document order no better than chance passes every check of the
    index and the traversal, and fails recall against exhaustive scoring."""
    out = run_tiny(tiny_bench, "k1000-bulk", fault=faults.FAULTS["shuffled_order"])
    failed = [n for n, v in out["checks"].items() if v["value"] > v["limit"]]
    assert not out["correct"] and failed == ["recall_shortfall"], out["checks"]


@pytest.fixture(scope="module")
def tiny_sharded(tmp_path_factory):
    """A tiny copy of the benchmark with a 2-rank cell served through the
    program's process-group front end."""
    from portbench.tiny import add_sharded_cell, make_tiny

    tiny = make_tiny(tmp_path_factory.mktemp("portbench2"))
    return tiny, add_sharded_cell(tiny)


def _run_sharded(tiny_sharded, fault=None, seconds: float = 0.3):
    from portbench import harness
    from portbench.tiny import TINY_SEED

    (root, bench), cell = tiny_sharded
    return harness.run(cell, TINY_SEED, seconds, False, root=root, device="cpu", bench_dir=bench, fault=fault,
                       check_modules=False)


def test_sharded_run_is_correct(tiny_sharded):
    """Two ranks over gloo, each serving its shard through GroupFrontEnd and
    Follower; the check judges both shards and the responses against the
    union. The caller's process keeps no process group."""
    import torch.distributed as dist

    out = _run_sharded(tiny_sharded)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2 and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks" and set(out["metrics"]) == {"qps", "setup_s"}
    assert not dist.is_initialized()


@pytest.mark.parametrize("fault", ["alter_answer", "stale_shard", "no_exchange"])
def test_sharded_fault_is_caught(tiny_sharded, fault, monkeypatch):
    """An answer altered on rank 0, rank 1's shard left stale, and the
    exchange between the ranks left out each turn ``correct`` false."""
    from repro_torch.distributed import sharded

    monkeypatch.setattr(sharded, "all_gather_cat", sharded.all_gather_cat)  # no_exchange replaces it here
    out = _run_sharded(tiny_sharded, fault=fault)
    failed = [n for n, v in out["checks"].items() if v["value"] > v["limit"]]
    assert not out["correct"] and failed, out["checks"]
    if fault == "stale_shard":
        assert out["checks"]["index_mismatches"]["value"] > 0


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[-1][:1] != "Z"
    except OSError:
        return False


def test_killed_rank_ends_the_run(tiny_sharded):
    """Rank 1 killed inside a 20 s window: the run, as the command runs it,
    exits non-zero long before the window's end, prints no result, and
    leaves no rank behind."""
    import re
    import time

    from portbench.tiny import TINY_SEED

    (root, bench), cell = tiny_sharded
    code = ("import sys; from pathlib import Path; from portbench import harness; "
            f"harness.run({cell!r}, {TINY_SEED}, 20.0, False, root=Path({str(root)!r}), device='cpu', "
            f"bench_dir=Path({str(bench)!r}), fault='kill_rank', hard_exit=True); print('result')")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    took = time.monotonic() - t0
    assert out.returncode != 0 and out.stdout.strip() == "", (out.returncode, out.stdout, out.stderr[-2000:])
    assert "rank 1 exited" in out.stderr and took < 60, (took, out.stderr[-2000:])
    pids = [int(p) for p in re.findall(r"pids \[([\d, ]+)\]", out.stderr)[0].split(",")]
    assert not [p for p in pids if _alive(p)]
