"""Dry run: build every (arch x shape x mesh) cell and count its step, with
nothing allocated; and ``measure_cell``, which runs one cell on a card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multipod # 2x16x16 mesh

The port of the JAX package's ``launch/dryrun.py``, with its flags. XLA
lowers and compiles each cell for the mesh and reports what the compiled
program holds and moves per device; eager PyTorch compiles nothing and has
no SPMD partitioner. So the record holds what one pass of the global step
over ``meta`` tensors can say (``launch/op_counts.py``), on the mesh's shape
(``MeshShape``: no process group, no card):

  memory.argument_bytes / output_bytes  per rank: the largest rank's sum of
      ``NamedSharding.shard_shape`` bytes over the in- / out-shardings
  cost                 the global step's flops, bytes and major bytes
  cost_adjusted        the same divided by n_devices (per device, the field
      a roofline reads, as JAX's is)
  op_stats             op counts by name (each op is a launch)

``temp_bytes``, ``peak_bytes`` and ``collectives`` are null, with the reason:
a meta pass plans no buffers, and the collectives that GSPMD would insert
have no eager counterpart. An LM train cell counts micro-batches 1 and 2 and
extrapolates to its ``grad_accum`` (every later micro-batch dispatches the
same ops as the second); the record says so.

Records go to results/dryrun_torch/<mesh>/<arch>__<shape>.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.common.tree_utils import flatten_with_paths
from repro_torch.configs.base import all_arch_names, get_arch
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.op_counts import OpCounter
from repro_torch.launch.specs import Cell, build_cell, lm_accum

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")
NO_BUFFERS = "a meta pass allocates nothing and eager PyTorch plans no buffers"
NO_COLLECTIVES = ("eager PyTorch has no SPMD partitioner: the all-gathers and reduce-scatters GSPMD would "
                  "insert have no counterpart to count")


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """The shape of ``launch.mesh.make_production_mesh``, without its ranks."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def shard_bytes(tree, shardings) -> int:
    """Per rank: each tensor leaf's ``shard_shape`` bytes under the placement
    at the same path of ``shardings`` (a placement alone covers one leaf)."""
    placed = flatten_with_paths(shardings)
    total = 0
    for path, leaf in flatten_with_paths(tree).items():
        if isinstance(leaf, torch.Tensor):
            total += math.prod(placed[path].shard_shape(tuple(leaf.shape))) * leaf.element_size()
    return total


def _is_micro_batched(cell: Cell) -> bool:
    """An LM train cell: its step runs lm_accum micro-batches."""
    arch = get_arch(cell.arch)
    return cell.kind == "train_step" and arch.family == "lm" and lm_accum(arch) > 1


def count_cell(cell: Cell) -> tuple[dict, dict, object, str]:
    """One meta pass of the step: (cost, op_stats, outputs, how it was counted)."""
    if not _is_micro_batched(cell):
        with OpCounter() as c:
            out = cell.fn(*cell.args)
        return c.record(), c.op_stats(), out, "one pass of the global step"
    accum = lm_accum(get_arch(cell.arch))
    counts = []
    for m in (1, 2):
        with OpCounter() as c:
            out = cell.fn(*cell.args, micro_batches=m)
        counts.append(c)
    one, two = counts
    cost = {k: v + (accum - 1) * (two.record()[k] - v) for k, v in one.record().items()}
    ops = {name: one.ops[name] + (accum - 1) * (n - one.ops[name]) for name, n in two.ops.items()}
    stats = {"n_ops": sum(ops.values()), "n_view_ops": one.n_views + (accum - 1) * (two.n_views - one.n_views),
             "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return cost, stats, out, (f"micro-batches 1 and 2 of {accum} counted, extrapolated to {accum} "
                              "(every later micro-batch dispatches the ops of the second)")


def _arg_signature(cell: Cell) -> tuple:
    return tuple((p, tuple(t.shape), t.dtype) for p, t in flatten_with_paths(cell.args).items())


def _run(arch_name: str, shape_name: str, multi_pod: bool, out_dir: str, counted=None) -> tuple[dict, tuple]:
    """run_cell's body. ``counted``: (mesh name, argument signature, count_cell's
    result) of the same step on another mesh, used again where this cell's
    arguments have the same shapes (the same global step). Returns (record,
    this cell's counted)."""
    arch = get_arch(arch_name)
    mesh = production_mesh_shape(multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    record = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name, "n_devices": mesh.size,
              "status": "unknown"}
    if shape_name in arch.skip_shapes:
        record.update(status="skipped", reason=arch.skip_shapes[shape_name], total_s=0.0)
        _write(record, out_dir)
        return record, counted
    try:
        cell = build_cell(arch, shape_name, mesh)
        t_build = time.time() - t0
        sig = _arg_signature(cell)
        if counted is not None and counted[1] == sig:
            cost, op_stats, out, how = counted[2]
            how = f"{how}; on the {counted[0]} mesh, whose cell has these arguments"
        else:
            cost, op_stats, out, how = count_cell(cell)
            counted = (mesh_name, sig, (cost, op_stats, out, how))
        record.update(
            status="ok",
            kind=cell.kind,
            note=cell.note,
            build_s=round(t_build, 2),
            count_s=round(time.time() - t0 - t_build, 2),
            memory={
                "argument_bytes": shard_bytes(cell.args, cell.in_shardings),
                "output_bytes": shard_bytes(out, cell.out_shardings),
                "temp_bytes": None,
                "peak_bytes": None,
                "reason": NO_BUFFERS,
                "scope": "per rank: the largest rank's NamedSharding.shard_shape bytes",
            },
            cost={**cost, "scope": "the global step", "counted": how},
            cost_adjusted={**{k: v / mesh.size for k, v in cost.items()},
                           "scope": f"per device: the global counts divided by n_devices ({mesh.size})"},
            collectives=None,
            collectives_reason=NO_COLLECTIVES,
            op_stats=op_stats,
        )
    except Exception as e:  # noqa: BLE001 - a cell that fails is recorded, and the run goes on
        record.update(status="failed", error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc()[-2000:])
    finally:
        record["total_s"] = round(time.time() - t0, 2)
    _write(record, out_dir)
    return record, counted


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, out_dir: str) -> dict:
    return _run(arch_name, shape_name, multi_pod, out_dir)[0]


def run_cell_on_both_meshes(arch_name: str, shape_name: str, out_root: str) -> dict:
    """run_cell on (data 16, model 16) and (pod 2, data 16, model 16), into
    ``out_root/<mesh>``; the step is counted once where both cells' arguments
    have the same shapes (all but the GNN cells, whose edges pad to the mesh
    size). Returns {mesh name: record}."""
    out, counted = {}, None
    for multi_pod in (False, True):
        mesh_name = "2x16x16" if multi_pod else "16x16"
        out[mesh_name], counted = _run(arch_name, shape_name, multi_pod, os.path.join(out_root, mesh_name), counted)
    return out


def _write(record: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{record['arch']}__{record['shape']}.json"), "w") as f:
        json.dump(record, f, indent=2, default=str)


# ===================================================================== on a card
def _ids(vocab_sizes, shape, generator, device) -> torch.Tensor:
    """int32 ids of ``shape`` [..., F], column f drawn below vocab_sizes[f]."""
    vocab = torch.tensor(vocab_sizes, dtype=torch.float64, device=device)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    return torch.floor(u * vocab).to(torch.int32)


def _mind_index_arrays(cell: Cell, n_cand: int, generator, device) -> tuple:
    """The seven inputs of mind's retrieval cell from seeded candidates, in the
    cell's own layout: candidates drawn inside its quantizer's range
    (``MIND_ZERO`` + [0, 15] x ``MIND_SCALE``), built by ``build_dense_index``
    at that fixed quantizer with the superblocks aligned to the shard count,
    cut by ``shard_dense_index`` and stacked shard by shard."""
    from repro_torch.core.lsp_dense import DenseIndexConfig, build_dense_index, shard_dense_index
    from repro_torch.launch.specs import MIND_B, MIND_BITS, MIND_C, MIND_SCALE, MIND_ZERO

    n_shards, np_l, d = cell.args[4].shape
    x_in = MIND_ZERO + ((1 << MIND_BITS) - 1) * MIND_SCALE * torch.rand((n_cand, d), generator=generator,
                                                                        device=device)
    cfg = DenseIndexConfig(b=MIND_B, c=MIND_C, bits=MIND_BITS, ns_align=n_shards)
    shards = shard_dense_index(build_dense_index(x_in, cfg, device, scale_zero=(MIND_SCALE, MIND_ZERO)), n_shards)
    if shards[0].cands.shape[0] != np_l:
        raise ValueError(f"the built shards hold {shards[0].cands.shape[0]} rows, the cell {np_l}")

    def stack(part):
        return torch.stack([part(s) for s in shards])

    return (
        stack(lambda s: s.sb.max_packed), stack(lambda s: s.sb.min_packed),
        stack(lambda s: s.blk.max_packed), stack(lambda s: s.blk.min_packed),
        stack(lambda s: s.cands), stack(lambda s: s.remap),
        torch.randn((cell.args[6].shape[0], d), generator=generator, device=device),
    )


def draw_args(cell: Cell, device, generator, arch=None) -> tuple:
    """Seeded inputs of ``cell`` on ``device``, valid for its step: the
    parameters from the port's ``init_*`` on ``generator`` (a generator of
    ``device``), ids inside their vocabularies, masks, and for mind's
    retrieval a dense index of seeded candidates in the cell's layout.
    ``arch`` is the config the cell was built from (default: its registered
    arch)."""
    from repro_torch.optim.adafactor import Adafactor

    arch = arch or get_arch(cell.arch)
    g = dict(generator=generator, device=device)
    a = cell.args
    if arch.family == "lm":
        from repro_torch.models.stacked import init_decode_state_stacked, init_lm_stacked

        cfg = arch.lm
        params = init_lm_stacked(cfg, generator, device=device)
        if cell.kind == "train_step":
            tokens = torch.randint(0, cfg.vocab, tuple(a[2].shape), dtype=torch.int32, **g)
            labels = torch.randint(0, cfg.vocab, tuple(a[3].shape), dtype=torch.int32, **g)
            return params, Adafactor().init(params), tokens, labels
        if cell.kind == "prefill_step":
            return params, torch.randint(0, cfg.vocab, tuple(a[1].shape), dtype=torch.int32, **g)
        bsz = a[1].shape[0]
        max_len = a[2].caches[0].k.shape[2]
        state = init_decode_state_stacked(cfg, bsz, max_len, device=device)
        state = state._replace(pos=torch.full_like(state.pos, max_len // 2))
        return params, torch.randint(0, cfg.vocab, (bsz, 1), dtype=torch.int32, **g), state
    if arch.family == "gnn":
        from repro_torch.models.schnet import init_schnet

        cfg = arch.gnn
        if cell.shape == "molecule" or a[2].dim() == 3:  # batched molecular graphs
            b, n, in_dim = a[2].shape
            e = a[4].shape[1]
            params = init_schnet(cfg, in_dim, 1, generator, device=device)
            z = torch.nn.functional.one_hot(torch.randint(0, in_dim, (b, n), **g), in_dim).to(torch.float32)
            return (params, Adafactor().init(params), z, 2.0 * torch.randn((b, n, 3), **g),
                    torch.randint(0, n, (b, e), dtype=torch.int32, **g),
                    torch.randint(0, n, (b, e), dtype=torch.int32, **g),
                    torch.rand((b, e), **g) < 0.9, torch.randn((b,), **g))
        n_nodes, d_feat = a[2].shape
        n_edges, n_out = a[3].shape[0], a[7].shape[0]
        n_classes = a[0].w_read2.shape[1]
        params = init_schnet(cfg, d_feat, n_classes, generator, device=device)
        return (params, Adafactor().init(params), torch.randn((n_nodes, d_feat), **g),
                torch.randint(0, n_nodes, (n_edges,), dtype=torch.int32, **g),
                torch.randint(0, n_nodes, (n_edges,), dtype=torch.int32, **g),
                cfg.cutoff * torch.rand((n_edges,), **g), torch.rand((n_edges,), **g) < 0.95,
                torch.randint(0, n_classes, (n_out,), dtype=torch.int32, **g), torch.rand((n_out,), **g) < 0.5)

    import repro_torch.models.recsys as R

    rc = arch.recsys
    init = R.init_dlrm if arch.name.startswith("dlrm") else R.init_din if arch.name == "din" else R.init_mind
    if cell.kind == "retrieve_step" and arch.name == "mind":
        return _mind_index_arrays(cell, cell.fn.n_cands, generator, device)
    params = init(rc, generator, device=device)
    if cell.kind == "retrieve_step":
        if arch.name == "din":
            n, f = a[1].shape
            hl = a[2].shape[0]
            return (params, _ids(rc.vocab_sizes, (n, f), generator, device),
                    _ids(rc.vocab_sizes, (hl, f), generator, device), torch.rand((hl,), **g) < 0.8)
        return (params, torch.randn((1, rc.n_dense), **g), _ids(rc.vocab_sizes, (1, rc.n_sparse), generator, device),
                _ids(rc.vocab_sizes[:1], (a[3].shape[0], 1), generator, device)[:, 0])
    arrays = a[2] if cell.kind == "train_step" else a[1]
    batch = {}
    for k, v in arrays.items():
        shape = tuple(v.shape)
        if k.endswith("_ids"):
            batch[k] = _ids(rc.vocab_sizes, shape, generator, device)
        elif k == "hist_mask":
            batch[k] = torch.rand(shape, **g) < 0.8
        elif k == "labels":
            batch[k] = (torch.rand(shape, **g) < 0.5).to(torch.float32)
        else:
            batch[k] = torch.randn(shape, **g)
    if cell.kind == "train_step":
        return params, Adafactor().init(params), batch
    return params, batch


def _advance(cell: Cell, args: tuple, out) -> tuple:
    """The arguments of the next step: a decode step consumes its state."""
    if cell.kind == "serve_step" and len(args) == 3 and hasattr(args[2], "caches"):
        return args[0], args[1], out[1]
    return args


def _profile_kernels(fn, top: int = 12) -> dict:
    """Device kernels of one call by name: {name: (count, ms)}, the busy ms
    and the wall ms (CUPTI through torch.profiler); only "out" if it saw no
    device time. The raw kineto events are read directly: parsing them into
    the profiler's Python events takes minutes for a step of ~10^5 kernels."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    us, n = Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            us[e.name()[:90]] += e.duration_ns() / 1e3
            n[e.name()[:90]] += 1
    if not us:
        return {"out": out}
    busy_ms = sum(us.values()) / 1e3
    return {"out": out, "n_kernels": sum(n.values()), "busy_ms": busy_ms, "wall_ms": wall_ms,
            "idle": 1 - busy_ms / wall_ms, "top": [(k, n[k], v / 1e3) for k, v in us.most_common(top)]}


def measure_cell(cell: Cell, device, generator, steps: int = 3, args: tuple | None = None,
                 flops: int | None = None, base_bytes: int | None = None) -> dict:
    """Run ``cell``'s step on a CUDA ``device`` over seeded inputs
    (``draw_args``, or ``args``): one profiled warm-up step, then ``steps``
    timed ones. An LM train cell's warm-up runs its first micro-batch and the
    update (every later micro-batch launches the same kernels; a whole step
    is ~10^5 kernels a micro-batch). Returns {ms (the median), ms_all,
    peak_bytes (the cell's own peak: ``max_memory_allocated`` from the
    warm-up on, less ``base_bytes``, what the card held before the cell's
    inputs were drawn; by default measured here, or with ``args`` given, the
    memory allocated before the warm-up, the inputs then left out),
    base_bytes, peak_abs_bytes (the card's absolute peak, earlier work's
    tensors included), profile (the warm-up's device kernels), profiled
    (what it ran), flops (counted on meta unless given: dispatched FLOPs,
    remat's recompute and every launched attention tile included),
    counted_tflops (flops over ms), out, args}. Raises without a CUDA device:
    a measurement never runs elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("measure_cell measures a card; it does not run on the CPU")
    counted = "given"
    if flops is None:
        cost, _, _, counted = count_cell(cell)
        flops = cost["flops"]
    torch.cuda.synchronize(device)
    if args is None:
        base_bytes = torch.cuda.memory_allocated(device) if base_bytes is None else base_bytes
        args = draw_args(cell, device, generator)
        torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base_bytes = torch.cuda.memory_allocated(device) if base_bytes is None else base_bytes
    micro = {"micro_batches": 1} if _is_micro_batched(cell) else {}
    prof = _profile_kernels(lambda: cell.fn(*args, **micro))
    out = prof.pop("out")
    args = _advance(cell, args, out)
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = cell.fn(*args)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        args = _advance(cell, args, out)
    med = sorted(ms)[len(ms) // 2]
    profiled = f"micro-batch 1 of {lm_accum(get_arch(cell.arch))} and the update" if micro else "a whole step"
    peak = torch.cuda.max_memory_allocated(device)
    return {"ms": med, "ms_all": ms, "peak_bytes": peak - base_bytes, "base_bytes": base_bytes,
            "peak_abs_bytes": peak, "profile": prof, "profiled": profiled,
            "flops": flops, "counted": counted, "counted_tflops": flops / (med * 1e-3) / 1e12,
            "out": out, "args": args}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--shape", type=str, default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multipod", action="store_true")
    p.add_argument("--skip-done", action="store_true", help="skip cells with an ok artifact")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    mesh_name = "2x16x16" if args.multipod else "16x16"
    out_dir = args.out or os.path.abspath(os.path.join(RESULTS_DIR, mesh_name))

    if args.all:
        cells = [(name, shape) for name in all_arch_names() for shape in get_arch(name).shapes]
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    n_ok = n_fail = n_skip = 0
    for arch_name, shape_name in cells:
        path = os.path.join(out_dir, f"{arch_name}__{shape_name}.json")
        if args.skip_done and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {arch_name} x {shape_name} x {mesh_name}: cached, skipping")
                    continue
        print(f"\n=== {arch_name} x {shape_name} x {mesh_name} ===", flush=True)
        rec = run_cell(arch_name, shape_name, args.multipod, out_dir)
        if rec["status"] == "ok":
            print(f"per-rank argument bytes {rec['memory']['argument_bytes']}, output bytes "
                  f"{rec['memory']['output_bytes']}; global flops {rec['cost']['flops']:.6g}, bytes "
                  f"{rec['cost']['bytes_accessed']:.6g}; per device flops {rec['cost_adjusted']['flops']:.6g}; "
                  f"{rec['op_stats']['n_ops']} ops ({rec['cost']['counted']})")
        print(f"[dryrun] status={rec['status']} t={rec['total_s']}s " + rec.get("error", ""))
        n_ok += rec["status"] == "ok"
        n_fail += rec["status"] == "failed"
        n_skip += rec["status"] == "skipped"
    print(f"\n[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped (see {out_dir})")


if __name__ == "__main__":
    main()
