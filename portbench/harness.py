"""One run of one cell: set-up, the measured window, the check, the result line.

Everything is found by name under this directory:

* the cell ``workloads/<name>.json``: its configuration, its traffic mix,
  its chips and the check's sample size and limits;
* the configuration ``configs/<name>.json``: corpus, index build, query
  point, and by name its build recipe (``"build"``, ``builds/<name>.py``;
  ``local`` without one) and its check (``"reference"``,
  ``reference/<name>.py``; ``lsp`` without one);
* the traffic mix ``mixes/<name>.json``: a driver (``traffic/<driver>.py``)
  and its parameters;
* each metric ``metrics/<name>.py``, with ``read(run) -> float | None``; the
  cell reports the metrics that BENCHMARK.json gives it (end-to-end ones with
  ``--trace 0``, per-layer ones with ``--trace 1``).

A cell on P > 1 chips runs one process a rank (``ranks.py``): rank 0 is the
calling process, draws its slice of the corpus, builds, drives the traffic
and prints; the others build their part and follow it (``follow``). A later
cell, mix, metric, build recipe or check is new files and a new entry in
BENCHMARK.json; nothing here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import gen, ranks, work

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
# the numbers ``check`` works out; a cell's ``check.limits`` names those it compares
COMPARED = ("index_mismatches", "order_violations", "id_score_err", "ids_differ", "recall_shortfall")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark's files, found by name under ``bench_dir`` (this
    directory) and ``BENCHMARK.json`` at ``root``."""

    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        cell = load_json(self.dir / "workloads" / f"{name}.json")
        entry = next((w for w in self.spec["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"cell {name!r} is not in BENCHMARK.json")
        for key in ("config", "traffic", "chips"):
            if cell[key] != entry[key]:
                raise ValueError(f"cell {name!r}: {key} is {cell[key]!r} in its file, {entry[key]!r} in BENCHMARK.json")
        return cell

    def config(self, name: str) -> dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def mix(self, name: str) -> dict:
        return load_json(self.dir / "mixes" / f"{name}.json")

    def driver(self, name: str):
        return load_module(self.dir / "traffic" / f"{name}.py", f"portbench_traffic_{name}")

    def build(self, cfg: dict):
        """The configuration's build recipe (``builds/<name>.py``)."""
        name = cfg.get("build", "local")
        return load_module(self.dir / "builds" / f"{name}.py", "portbench_build_" + _ident(name))

    def reference(self, cfg: dict):
        """The configuration's check (``reference/<name>.py``)."""
        name = cfg.get("reference", "lsp")
        return load_module(self.dir / "reference" / f"{name}.py", "portbench_reference_" + _ident(name))

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        return load_module(path, "portbench_metric_" + _ident(metric))


def _ident(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def configure_process(root: Path) -> None:
    """What a run's process is given before anything else (the commands call
    it; ``run`` leaves the calling process's settings alone): every build and
    kernel cache of the program at a fixed path inside the checkout (the
    program's own CUDA libraries go to ``build/kernels``), and one intra-op
    thread, so no pool spins beside the caller."""
    os.environ["TRITON_CACHE_DIR"] = str(Path(root) / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(Path(root) / "build" / "torch_extensions")
    torch.set_num_threads(1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GcPauses:
    """The interpreter's collections in the window: count, total and longest
    pause by generation (a ``gc.callbacks`` entry)."""

    def __init__(self):
        self.started = {}
        self.by_gen = {0: [], 1: [], 2: []}

    def __call__(self, phase, info):
        if phase == "start":
            self.started[info["generation"]] = time.perf_counter()
        elif info["generation"] in self.started:
            self.by_gen[info["generation"]].append(time.perf_counter() - self.started.pop(info["generation"]))

    def summary(self) -> str:
        parts = [f"gen {g}: {len(v)} in {sum(v) * 1e3:.1f} ms, longest {max(v, default=0) * 1e3:.1f} ms"
                 for g, v in self.by_gen.items()]
        return "garbage collections in the window: " + "; ".join(parts) + f" (tracked {len(gc.get_objects())})"


def settle() -> None:
    """The end of set-up: the objects set-up made (modules, the index, the
    query pool) leave the interpreter's collector until the window closes,
    as a long-lived server freezes them after start-up. Without it every
    full collection walks them: 100-240 ms pauses inside a serving window."""
    gc.collect()
    gc.freeze()


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that the cell gives a limit, against it; the others are
    only shown on standard error."""
    shown = {name: {"value": nums[name], "limit": limits[name]} for name in limits}
    ok = all(nums[name] <= limits[name] for name in limits)
    return ok, shown


def card_power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return "; ".join(out.stdout.split("\n")).strip("; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _context(bench: Bench, workload: str, seed: int, seconds: float, group: ranks.Group):
    """What every rank sets up first: the cell's files, the CUDA context,
    and the rank's slice of the corpus drawn on its device."""
    import repro_torch.api  # noqa: F401  (the program under test: a checkout without it fails here)

    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    device = group.device
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group.stage("imports and the CUDA context")
    spec = gen.CorpusSpec.from_config(cfg)
    shard = (group.rank, group.size) if group.size > 1 else None
    corpus = gen.make_corpus(spec, seed, device, shard=shard)
    host = gen.corpus_to_host(corpus)
    group.stage("the corpus on the device and its host copy")
    return SimpleNamespace(cell=cell, cfg=cfg, mix=mix, spec=spec, corpus=corpus, host=host, device=device,
                           seed=seed, seconds=seconds, rank=group.rank, shard=shard, build=bench.build(cfg),
                           reference=bench.reference(cfg))


def _log_stages(stages, t_start: float) -> None:
    prev = t_start
    for name, t in stages:
        log(f"set-up: {name} {t - prev:.3f} s")
        prev = t


def _setup(bench: Bench, workload: str, seed: int, seconds: float, fault, t_start: float, group: ranks.Group):
    """Rank 0's set-up, everything before the window: the corpus drawn on the
    device, the build, the traffic driver's queries and warm-up. Returns the
    run's namespace and ``setup_s``."""
    ctx = _context(bench, workload, seed, seconds, group)
    ctx.driver = bench.driver(ctx.mix["driver"])
    early = getattr(fault, "early", False)
    if early:
        fault(ctx)
    ctx.retr = ctx.build.build(ctx, group)
    if not group.is_built:
        raise RuntimeError(f"the build recipe {ctx.cfg.get('build', 'local')!r} never called group.built()")
    if group.ranks is not None:
        group.ranks.end()
    del ctx.host
    _sync(ctx.device)
    with group.waiting("the traffic's queries and warm-up", 2 * ranks.WAIT_S):
        ctx.driver.prepare(ctx)
    if fault is not None and not early:
        fault(ctx)
    _sync(ctx.device)
    settle()
    group.stage("queries and warm-up")
    _log_stages(group.stages, t_start)
    return ctx, time.perf_counter() - t_start


def _measure(ctx, trace: bool, group: ranks.Group):
    """The window, under the profiler when ``trace``: (the traffic driver's record,
    the trace's reduction or None, the kernels' rooflines). The other ranks
    mark the window's edges on their traces when rank 0 does."""
    from repro_torch.core import ops as core_ops

    from portbench import trace as tr

    if not trace:
        return ctx.driver.window(ctx), None, {}
    edges = group.store is not None
    calls = tr.OpCalls(core_ops)
    with tr.Tracer() as tracer:
        tracer.mark()
        if edges:
            group.store.set("window_open", "1")
        with calls:
            rec = ctx.driver.window(ctx)
        if edges:
            group.store.set("window_closed", "1")
        tracer.mark()
    events = tracer.events()
    reduced = tr.reduce(events)
    marks = sum(1 for name, _, _ in events if tr.MARKER in name)
    log(f"trace: {len(events)} device records, {marks} window markers"
        + ("" if reduced else "; fewer than two, so no per-layer metric is read"))
    return rec, reduced, (tr.op_rooflines(calls, reduced["events"]) if reduced else {})


def _fault(fault):
    """A fault passed by name (``faults.FAULTS``) or as a function."""
    if isinstance(fault, str):
        from portbench import faults

        return faults.FAULTS[fault]
    return fault


def run(workload: str, seed: int, seconds: float, trace: bool, *, root: Path, device=None,
        bench_dir: Path = HERE, t_start: float | None = None, fault=None, check_modules: bool = True,
        hard_exit: bool = False) -> dict:
    """One run; returns the result line's object. ``device`` None means the
    first CUDA device (rank r of a cell on P > 1 chips takes device r of the
    same kind). ``fault`` (tests, ``control.py``), a function or the name of
    one in ``faults.FAULTS`` (a name where the cell has P > 1 ranks), is
    called with a rank's namespace: on rank 0 after set-up (before the build
    where it is marked ``early``), on the others before they build and
    follow, to break the timed path underneath. ``hard_exit``
    (the command) ends the process at a fault of another rank."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root, bench_dir)
    size = bench.cell(workload)["chips"]
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if size == 1:
        return _lead(bench, workload, seed, seconds, trace, _fault(fault), t_start, check_modules,
                     ranks.Group(0, 1, device))
    if fault is not None and not isinstance(fault, str):
        raise ValueError("a run on several ranks takes its fault by name (faults.FAULTS)")
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", repr(float(seconds)), "--trace",
            str(int(trace)), "--root", str(root), "--bench-dir", str(bench_dir), "--device", device.type]
    watch = ranks.Ranks(size, argv + (["--fault", fault] if fault else []), hard=hard_exit)
    try:
        group = ranks.join(0, size, device, watch.store_path, ranks=watch)
        group.stage("the other ranks started and the process group joined")
        return _lead(bench, workload, seed, seconds, trace, _fault(fault), t_start, check_modules, group)
    except Exception as exc:
        if watch.failed is not None:
            raise RuntimeError(watch.failed) from exc
        raise
    finally:
        watch.stop()
        if not hard_exit:  # the command's process ends here: no teardown that could wait on a rank
            ranks.leave()


def _lead(bench: Bench, workload: str, seed: int, seconds: float, trace: bool, fault, t_start: float,
          check_modules: bool, group: ranks.Group) -> dict:
    """Rank 0: set-up, the window, the readings of every rank, the check, and
    the result line's object."""
    device = group.device
    ctx, setup_s = _setup(bench, workload, seed, seconds, fault, t_start, group)
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    with group.waiting("the window", seconds + ranks.WAIT_S):
        rec, reduced, rooflines = _measure(ctx, trace, group)
    gc.callbacks.remove(pauses)
    peak = _peak(device)

    # what every rank served is read, then freed: the check runs once the peak is read
    gc.unfreeze()
    leaves = ctx.build.leaves(ctx, group)
    ctx.driver.stop(ctx)
    if hasattr(ctx.build, "close"):
        with group.waiting("closing the other ranks"):
            ctx.build.close(ctx, group)
    del ctx.retr
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with group.waiting("every rank's readings"):
        readings = group.gather({"peak": peak, "trace": reduced, "stages": group.stages})

    run_ns = SimpleNamespace(setup_s=setup_s, rec=rec, trace=reduced, traces=[r["trace"] for r in readings],
                             rooflines=rooflines)
    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.reader(m["name"]).read(run_ns)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            log(f"metric {m['name']}: nothing to read in this run")
    log(f"card: {card_power() if device.type == 'cuda' else 'none (CPU run)'}; rooflines are read against "
        f"{work.HBM_BYTES_PER_S / 1e12:.2f} TB/s and {work.FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s float32")
    for line in rec.notes + [pauses.summary()]:
        log(line)
    for r, got in enumerate(readings[1:], 1):
        t = got["trace"]
        log(f"rank {r}: memory peak {got['peak']} bytes; set-up " + ", ".join(
            f"{name} {t1 - t0:.3f} s" for (name, t1), (_, t0) in zip(got["stages"][1:], got["stages"]))
            + (f"; traced window {t['window_s']:.3f} s, busy {t['busy_s']:.3f} s" if t else ""))

    t_check = time.perf_counter()
    nums = ctx.reference.check(ctx.cell, ctx.cfg, ctx.corpus, leaves, rec.sample_queries, rec.sample_responses,
                               seed, group=group)
    correct, shown = judge(nums, ctx.cell["check"]["limits"])
    for name in nums.keys() - shown.keys():
        log(f"{name} = {nums[name]!r} (not compared in this cell)")
    log(f"check: {len(rec.sample_queries)} sampled responses and the index, in "
        f"{time.perf_counter() - t_check:.1f} s")
    with group.waiting("every rank's loaded modules"):
        loaded = group.gather(forbidden_modules())
    group.finish()

    # an answer that never came is for the check too
    out = {"correct": bool(correct) and rec.answered > 0 and rec.failed == 0, "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                      "count": group.size, "memory_peak_bytes": int(max(r["peak"] for r in readings))}}
    if reduced:
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    bad = {r: mods for r, mods in enumerate(loaded) if mods and (r or check_modules)}
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {bad} (by rank)")
    out["checks"] = shown
    for name, v in shown.items():
        log(f"check {name} = {v['value']!r} (limit {v['limit']!r})")
    return out


def _follow_trace(group: ranks.Group):
    """The device trace of another rank, from the barrier after every
    rank's build until it stops following, with markers where rank 0 opens
    and closes its window."""
    from datetime import timedelta

    from portbench import trace as tr

    tracer = tr.Tracer()
    tracer.__enter__()

    def edges():
        torch.cuda.set_device(group.device)
        for key in ("window_open", "window_closed"):
            try:
                group.store.wait([key], timedelta(seconds=ranks.FOLLOW_S))
            except RuntimeError:
                return
            tracer.mark()

    threading.Thread(target=edges, name="portbench-edges", daemon=True).start()
    return tracer


def follow(workload: str, seed: int, seconds: float, trace: bool, *, root: Path, bench_dir: Path,
           group: ranks.Group, fault=None, t_start: float) -> None:
    """A rank other than 0: its slice of the corpus, its part of the build,
    serving rank 0 until it closes (the recipe's ``follow``), then its
    readings and its part of the check."""
    bench = Bench(root, bench_dir)
    ctx = _context(bench, workload, seed, seconds, group)
    if fault is not None:
        _fault(fault)(ctx)
    tracer = []

    def after_built():
        del ctx.host
        settle()
        if trace and group.device.type == "cuda":
            tracer.append(_follow_trace(group))

    group.after_built = after_built
    ctx.build.follow(ctx, group)
    reduced = None
    if tracer:
        tracer[0].__exit__(None, None, None)
        reduced = _reduce_follower(tracer[0].events())
    peak = _peak(group.device)
    gc.unfreeze()
    leaves = ctx.build.leaves(ctx, group)
    del ctx.retr
    if group.device.type == "cuda":
        torch.cuda.empty_cache()
    group.gather({"peak": peak, "trace": reduced, "stages": [("process start", t_start)] + group.stages})
    ctx.reference.check(ctx.cell, ctx.cfg, ctx.corpus, leaves, [], [], seed, group=group)
    group.gather(forbidden_modules())
    group.finish()


def _reduce_follower(events):
    """A follower's trace reduced, without its list of device records."""
    from portbench import trace as tr

    reduced = tr.reduce(events)
    if reduced is not None:
        reduced.pop("events")
    return reduced
