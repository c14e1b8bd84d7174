"""One run of one cell: set-up, the measured window, the check, the result line.

Everything is found by name under this directory:

* the cell ``workloads/<name>.json``: its configuration, its traffic mix,
  its chips and the check's sample size and limits;
* the configuration ``configs/<name>.json``: corpus, index build, query point;
* the traffic mix ``mixes/<name>.json``: a driver (``traffic/<driver>.py``)
  and its parameters;
* each metric ``metrics/<name>.py``, with ``read(run) -> float | None``; the
  cell reports the metrics that BENCHMARK.json gives it (end-to-end ones with
  ``--trace 0``, per-layer ones with ``--trace 1``).

A later cell, mix or metric is new files and a new entry in BENCHMARK.json;
nothing here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench import gen, work
from portbench.reference import lsp as ref_lsp

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

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        return load_module(path, "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


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


def build_retriever(cfg: dict, corpus_host, device):
    """The program under test: ``Retriever.build`` at the configuration's
    index build and query point."""
    from repro_torch.api import Retriever
    from repro_torch.core.config import DynamicParams, StaticConfig
    from repro_torch.index.builder import IndexBuildConfig

    ix, q = cfg["index"], cfg["query"]
    build_cfg = IndexBuildConfig(b=ix["b"], c=ix["c"], bound_bits=ix["bound_bits"], doc_bits=ix["doc_bits"])
    scfg = StaticConfig(variant=q["variant"], gamma=q["gamma"], gamma0=q["gamma0"], k_max=q["k"])
    params = DynamicParams(k=q["k"], mu=q["mu"], eta=q["eta"], beta=q["beta"])
    return Retriever.build(corpus_host, scfg, build_cfg=build_cfg, params=params, device=device)


def port_leaves(index) -> dict:
    """The leaves of the program's index that the traversal reads, as plain
    tensors: what the check judges."""
    out = {"remap": index.doc_remap, "fwdq_tids": index.docs_fwdq.tids, "fwdq_ws": index.docs_fwdq.ws,
           "fwdq_scales": index.docs_fwdq.scales}
    for name, pb in (("blk", index.blk_bounds), ("sb", index.sb_bounds)):
        out.update({f"{name}_words": pb.packed, f"{name}_scale": pb.scale, f"{name}_bits": pb.bits,
                    f"{name}_granule": pb.granule_words})
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check(cell: dict, cfg: dict, corpus, leaves: dict, queries: list, responses: list, seed: int) -> dict:
    """The compared numbers of a run: the program's index against the
    reference's derivation, and a sample of its responses (``responses[i]``:
    ids and scores served for ``queries[i]``) against the reference's
    traversal and against exhaustive scoring."""
    ix, q = cfg["index"], cfg["query"]
    k = q["k"]
    order_bad = ref_lsp.order_mismatches(leaves["remap"], corpus.doc_ptr.numel() - 1, ix["b"], ix["c"])
    if order_bad:  # nothing else can be laid out against a broken order
        return {"index_mismatches": order_bad, "order_violations": 0, "id_score_err": 1.0, "ids_differ": 1.0,
                "recall_shortfall": 1.0}
    rng = np.random.default_rng(gen.stream(seed, 9))
    extra = rng.choice(corpus.vocab, size=min(corpus.vocab, cell["check"]["extra_rows"]), replace=False)
    rows = torch.from_numpy(np.unique(np.concatenate([extra] + [t for t, _ in queries]).astype(np.int64)))
    ref = ref_lsp.derive(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab, leaves["remap"], ix["b"], ix["c"],
                         ix["bound_bits"], ix["doc_bits"], rows)
    nums = {"index_mismatches": ref_lsp.index_mismatches(ref, leaves)}
    ref_ids, ref_scores = ref_lsp.search(ref, queries, k=k, gamma=q["gamma"], gamma0=q["gamma0"],
                                         beta=q["beta"], eta=q["eta"])
    got_ids = torch.full((len(responses), k), -1, dtype=torch.int64)
    got_scores = torch.full((len(responses), k), ref_lsp.NEG, dtype=torch.float32)
    for i, (ids, scores) in enumerate(responses):
        got_ids[i, : len(ids)] = torch.from_numpy(np.asarray(ids, np.int64))
        got_scores[i, : len(scores)] = torch.from_numpy(np.asarray(scores, np.float32))
    rescored = ref_lsp.score_ids(ref, queries, got_ids)
    nums.update(ref_lsp.compare(got_ids, got_scores, ref_ids, ref_scores, rescored))
    oracle = ref_lsp.exhaustive_topk(ref, corpus.doc_ptr, corpus.tids, corpus.ws, ix["doc_bits"], queries, k)
    nums["recall_shortfall"] = ref_lsp.recall_shortfall(got_ids, oracle)
    log(f"recall@{k} against exhaustive scoring of the same quantized documents, {len(queries)} sampled "
        f"queries: {1.0 - nums['recall_shortfall']:.6f}")
    return nums


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
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _setup(bench: Bench, workload: str, seed: int, seconds: float, device, fault, t_start: float):
    """Everything before the window: the corpus drawn on the device, the
    program's index build, the traffic driver's queries and warm-up. Returns the
    run's namespace and ``setup_s``."""
    import repro_torch.api  # noqa: F401  (the program under test: a checkout without it fails here)

    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    driver = bench.driver(mix["driver"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    stages = [("imports and the CUDA context", time.perf_counter())]
    spec = gen.CorpusSpec.from_config(cfg)
    corpus = gen.make_corpus(spec, seed, device)
    host = gen.corpus_to_host(corpus)
    stages.append(("the corpus on the device and its host copy", time.perf_counter()))
    retr = build_retriever(cfg, host, device)
    _sync(device)
    stages.append(("Retriever.build", time.perf_counter()))
    ctx = SimpleNamespace(cell=cell, cfg=cfg, mix=mix, driver=driver, spec=spec, corpus=corpus, retr=retr,
                          device=device, seed=seed, seconds=seconds)
    driver.prepare(ctx)
    if fault is not None:
        fault(ctx)
    _sync(device)
    settle()
    stages.append(("queries and warm-up", time.perf_counter()))
    prev = t_start
    for name, t in stages:
        log(f"set-up: {name} {t - prev:.3f} s")
        prev = t
    return ctx, time.perf_counter() - t_start


def _measure(ctx, trace: bool):
    """The window, under the profiler when ``trace``: (the traffic driver's record,
    the trace's reduction or None, the kernels' rooflines)."""
    from repro_torch.core import ops as core_ops

    from portbench import trace as tr

    if not trace:
        return ctx.driver.window(ctx), None, {}
    calls = tr.OpCalls(core_ops)
    with tr.Tracer() as tracer:
        tracer.mark()
        with calls:
            rec = ctx.driver.window(ctx)
        tracer.mark()
    events = tracer.events()
    reduced = tr.reduce(events)
    marks = sum(1 for name, _, _ in events if tr.MARKER in name)
    log(f"trace: {len(events)} device records, {marks} window markers"
        + ("" if reduced else "; fewer than two, so no per-layer metric is read"))
    return rec, reduced, (tr.op_rooflines(calls, reduced["events"]) if reduced else {})


def run(workload: str, seed: int, seconds: float, trace: bool, *, root: Path, device=None,
        bench_dir: Path = HERE, t_start: float | None = None, fault=None, check_modules: bool = True) -> dict:
    """One run; returns the result line's object. ``device`` None means the
    first CUDA device. ``fault`` (tests, ``control.py``) is called with the
    run's namespace after set-up, to break the timed path underneath."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root, bench_dir)
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    ctx, setup_s = _setup(bench, workload, seed, seconds, device, fault, t_start)
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    rec, reduced, rooflines = _measure(ctx, trace)
    gc.callbacks.remove(pauses)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    run_ns = SimpleNamespace(setup_s=setup_s, rec=rec, trace=reduced, rooflines=rooflines)
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

    # the check, once the window has closed, the peak is read and the program's state is freed
    gc.unfreeze()
    leaves = port_leaves(ctx.retr.index)
    ctx.driver.stop(ctx)
    del ctx.retr
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = check(ctx.cell, ctx.cfg, ctx.corpus, leaves, rec.sample_queries, rec.sample_responses, seed)
    correct, shown = judge(nums, ctx.cell["check"]["limits"])
    for name in nums.keys() - shown.keys():
        log(f"{name} = {nums[name]!r} (not compared in this cell)")
    log(f"check: {len(rec.sample_queries)} sampled responses and the index, in "
        f"{time.perf_counter() - t_check:.1f} s")

    # an answer that never came is for the check too
    out = {"correct": bool(correct) and rec.answered > 0 and rec.failed == 0, "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if reduced:
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    if check_modules:
        bad = forbidden_modules()
        if bad:
            raise RuntimeError(f"modules of JAX or the JAX package are loaded: {bad}")
    out["checks"] = shown
    for name, v in shown.items():
        log(f"check {name} = {v['value']!r} (limit {v['limit']!r})")
    return out
