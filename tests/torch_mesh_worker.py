"""Rank body of the process-group tests (``test_torch_sharded_mesh.py``).

``spawn_world(world, spec)`` starts ``world`` processes with the ``spawn``
method, each joining one gloo process group over ``tcp://127.0.0.1``, runs
every case of ``spec`` on every rank in that one world, and returns each
rank's results (host numpy arrays) by rank. Every wait has a timeout; a rank
that fails or hangs fails the call, and every process is stopped.

This module imports torch and the port only, so a rank starts without JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import traceback

RANK_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fields(res) -> dict:
    return {f: getattr(res, f).cpu().numpy() for f in res._fields}


def _run_cases(spec: dict) -> dict:
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

    retr = Retriever.load(spec["sharded_dir"], StaticConfig(**spec["configs"][0][1]), group=dist.group.WORLD,
                          impl="ref", device="cpu")
    resp = retr.search_batch([SearchRequest(t, w) for t, w in spec["queries"]])
    out["facade"] = {"backend": retr.backend_name,
                     "doc_ids": [r.doc_ids for r in resp], "theta": [r.theta for r in resp],
                     "shard_candidates": [r.shard_candidates for r in resp]}

    scores = torch.from_numpy(spec["topk_scores"])
    n_local = scores.shape[1] // world
    vals, ids = distributed_topk(scores[:, rank * n_local: (rank + 1) * n_local], spec["topk_k"])
    out["topk"] = (vals.numpy(), ids.numpy())
    out["pmax"] = pmax_scalar(torch.tensor([float(rank), -float(rank)])).numpy()

    mesh_run, _ = make_mesh_retriever(shard_index(index, world), RetrievalConfig(**spec["mesh_cfg"]),
                                      group=dist.group.WORLD, impl="ref")
    out["mesh"] = tuple(t.numpy() for t in mesh_run(qb))

    dense_shards = torch.load(spec["dense_shards"], weights_only=False)
    dense_run = make_sharded_dense_retriever(dense_shards, RetrievalConfig(**spec["dense_cfg"]),
                                             group=dist.group.WORLD, impl="ref")
    out["dense"] = tuple(t.numpy() for t in dense_run(torch.from_numpy(spec["dense_q"])))
    return out


def _rank_main(rank: int, world: int, port: int, spec: dict, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        results.put((rank, _run_cases(spec), None))
    except BaseException:  # reported to the parent, then re-raised
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def spawn_world(world: int, spec: dict) -> dict:
    """Run every case of ``spec`` on ``world`` gloo ranks; {rank: results}."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, spec, results)) for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:  # drain before joining
            try:
                rank, res, err = results.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"a rank sent nothing within {RANK_TIMEOUT_S} s")
                break
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            got[rank] = res
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S if not errors else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return got
