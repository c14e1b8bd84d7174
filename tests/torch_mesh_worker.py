"""Rank body of the process-group tests (``test_torch_sharded_mesh.py``).

``spawn_world(world, spec, root)`` starts ``world`` processes with the
``spawn`` method, each joining one gloo process group through a file store
under ``root``, runs every case of ``spec`` on every rank in that one world,
and returns each rank's results (host numpy arrays) by rank. The last two
cases drive the serving launcher's job through the rank-0 group front end,
and a front end whose rank 1 goes silent on a group of its own. A spec with
a ``"runner"`` (``"module:function"``, a function of (spec, report)) runs
that rank body in place of these cases.

Every rank reports as it goes (joined, each case done, its result), and the
parent's wait runs from the last report of any rank, so a world on a loaded
host takes as long as it needs while a rank that stalls still fails the call.
The ranks meet at a barrier after their last collective, so none tears its
process group down while another is still in one, and then each destroys its
group. A rank that raises sends its traceback; a rank that dies writes a
fault dump (``faulthandler``) to a file under ``root``; either reaches the
error the call raises, with the rank's number and exit code. Every process
is stopped before the call returns.

This module imports torch and the port only, so a rank starts without JAX.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import traceback

RANK_TIMEOUT_S = 120  # the longest a world may go without a report from any rank
DEAD_TIMEOUT_S = 3  # the collectives' timeout on the group whose follower goes silent


def _fields(res) -> dict:
    return {f: getattr(res, f).cpu().numpy() for f in res._fields}


def _run_cases(spec: dict, report) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.api import Retriever, SearchRequest
    from repro_torch.core.config import DynamicParams, RetrievalConfig, StaticConfig
    from repro_torch.core.lsp_dense import make_sharded_dense_retriever
    from repro_torch.core.query import make_query_batch
    from repro_torch.distributed.retrieval import make_mesh_retriever, shard_index
    from repro_torch.distributed.sharded import ShardedRetriever
    from repro_torch.distributed.topk import distributed_topk, pmax_scalar
    from repro_torch.index.store import load_index

    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    qb = make_query_batch(spec["queries"], spec["vocab"], device="cpu")
    index = load_index(spec["index_dir"], device="cpu")
    for name, scfg_kw, dyn in spec["configs"]:
        scfg = StaticConfig(**scfg_kw)
        dyn = None if dyn is None else [DynamicParams(**d) for d in dyn]
        own = ShardedRetriever.from_dir(spec["sharded_dir"], scfg, group=dist.group.WORLD, impl="ref",
                                        device="cpu")
        out[f"dir/{name}"] = _fields(own(qb, dyn))
        cut = ShardedRetriever(index, scfg, group=dist.group.WORLD, impl="ref")  # each rank cuts its shard
        out[f"cut/{name}"] = _fields(cut(qb, dyn))
        report(name)

    retr = Retriever.load(spec["sharded_dir"], StaticConfig(**spec["configs"][0][1]), group=dist.group.WORLD,
                          impl="ref", device="cpu")
    resp = retr.search_batch([SearchRequest(t, w) for t, w in spec["queries"]])
    out["facade"] = {"backend": retr.backend_name,
                     "doc_ids": [r.doc_ids for r in resp], "theta": [r.theta for r in resp],
                     "shard_candidates": [r.shard_candidates for r in resp]}
    report("facade")

    scores = torch.from_numpy(spec["topk_scores"])
    n_local = scores.shape[1] // world
    vals, ids = distributed_topk(scores[:, rank * n_local: (rank + 1) * n_local], spec["topk_k"])
    out["topk"] = (vals.numpy(), ids.numpy())
    out["pmax"] = pmax_scalar(torch.tensor([float(rank), -float(rank)])).numpy()
    report("topk")

    mesh_run, _ = make_mesh_retriever(shard_index(index, world), RetrievalConfig(**spec["mesh_cfg"]),
                                      group=dist.group.WORLD, impl="ref")
    out["mesh"] = tuple(t.numpy() for t in mesh_run(qb))
    report("mesh")

    dense_shards = torch.load(spec["dense_shards"], weights_only=False)
    dense_run = make_sharded_dense_retriever(dense_shards, RetrievalConfig(**spec["dense_cfg"]),
                                             group=dist.group.WORLD, impl="ref")
    out["dense"] = tuple(t.numpy() for t in dense_run(torch.from_numpy(spec["dense_q"])))
    report("dense")

    out["launcher"] = _launcher_case(spec)
    report("launcher")
    out["dead_follower"] = _dead_follower_case(spec, StaticConfig(**spec["configs"][0][1]))
    return out


def _response_fields(r) -> dict:
    return {f: getattr(r, f) for f in ("doc_ids", "scores", "theta", "n_superblocks_visited", "n_blocks_scored",
                                       "shard_candidates", "params_served", "epoch")}


def _launcher_case(spec: dict):
    """``launch/serve.py``'s job under the world: rank 0's engine drives every
    rank through the group front end (a swap mid-run, a k sweep); rank 0
    returns each response's fields and what the job printed."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.launch.serve import parse_args, serve_job

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = serve_job(parse_args(spec["launch_argv"] + ["--shards", str(dist.get_world_size())]),
                        group=dist.group.WORLD)
    if run is None:  # a follower
        return None
    return {"responses": [_response_fields(r) for r in run.responses],
            "sweep": [_response_fields(r) for r in run.sweep], "recompiles": run.recompiles,
            "summary": {k: run.summary[k] for k in ("requests", "swaps", "failures")}, "printed": buf.getvalue()}


def _dead_follower_case(spec: dict, scfg):
    """Rank 1 takes part in the opening of the shard set and then goes
    silent, on a group whose collectives time out after DEAD_TIMEOUT_S:
    rank 0's engine must fail every pending request, and the next one, with
    the typed ``ShardGroupError``. The other followers' wait for the next
    operation times out too."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.api import SearchRequest
    from repro_torch.serve.errors import ShardGroupError
    from repro_torch.serve.group import Follower, GroupFrontEnd

    group = dist.new_group(backend="gloo", timeout=timedelta(seconds=DEAD_TIMEOUT_S))
    rank = dist.get_rank()
    if rank == 1:
        return Follower(group, "cpu").step()
    if rank > 1:
        try:
            Follower(group, "cpu").run()
        except RuntimeError as exc:  # the wait for rank 0's next operation times out
            return type(exc).__name__
        return "ran to a shutdown"
    front = GroupFrontEnd(group, "cpu")
    eng = front.open(spec["sharded_dir"], scfg, impl="ref").serve(max_batch=4, nq_max=64)
    futs = [eng.search(SearchRequest(t, w)) for t, w in spec["queries"][:8]]
    outcomes = []
    for f in futs + [eng.search(SearchRequest(*spec["queries"][0]))]:
        try:
            f.result(timeout=RANK_TIMEOUT_S)
            outcomes.append("served")
        except ShardGroupError:
            outcomes.append("ShardGroupError")
    eng.shutdown()
    front.close()
    return {"outcomes": outcomes, "failures": eng.stats.summary()["failures"]}


def _rank_main(rank: int, world: int, root: str, spec: dict, results) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    fault_log = open(_fault_path(root, rank), "w")  # left open: the dump may come as late as the process's exit
    faulthandler.enable(fault_log, all_threads=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store')}", world_size=world, rank=rank)
    results.put((rank, "joined", None))
    try:
        module, _, fn = spec.get("runner", f"{__name__}:_run_cases").partition(":")
        out = getattr(importlib.import_module(module), fn)(spec, lambda case: results.put((rank, "progress", case)))
        dist.barrier()  # every rank is past its last collective before any tears its group down
    except BaseException:  # reported to the parent, then re-raised
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()
    results.put((rank, "result", out))


def _fault_path(root: str, rank: int) -> str:
    return os.path.join(root, f"rank{rank}.fault")


def spawn_world(world: int, spec: dict, root: str) -> dict:
    """Run every case of ``spec`` on ``world`` gloo ranks; {rank: results}.
    ``root`` is an empty directory for the world's store and fault dumps."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, root, spec, results)) for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) < world and not errors:  # drain before joining
            try:
                rank, kind, payload = results.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"no rank reported within {RANK_TIMEOUT_S} s; results from ranks {sorted(got)}")
                break
            if kind == "error":
                errors.append(f"rank {rank}:\n{payload}")
            elif kind == "result":
                got[rank] = payload
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S if not errors else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    for rank, p in enumerate(procs):
        if p.exitcode != 0:
            path = _fault_path(root, rank)
            dump = open(path).read().strip() if os.path.exists(path) else ""
            errors.append(f"rank {rank} exited with {p.exitcode}" + (f"; its fault dump:\n{dump}" if dump else ""))
    if errors:
        raise RuntimeError("\n".join(errors))
    return got
