"""Retrieval serving launcher: build (or load) an LSP index over a corpus and
serve batched queries through ``repro_torch.api``: the ``Retriever`` facade,
typed requests and responses, and the bucketed engine (shape-bucket ladder,
result cache, failure isolation) with latency percentiles.

With ``--index-dir`` a committed index under that directory is mmap-loaded
instead of rebuilt, and a fresh build is saved there for the next start.
``--swap-mid-run`` hot-swaps the engine to a rebuilt index halfway through
the request stream while traffic keeps flowing.

``--shards N`` serves through the sharded backends, equal to the single
index with 1/N of its memory a shard. In one process the host loop serves
every shard. Under ``torchrun --nproc-per-node N`` each rank holds one shard
and the process-group transport serves them: rank 0 runs the engine, and the
other ranks follow its operations (``serve/group.py``). The ranks run over
NCCL where each has a card of its own, over gloo where they share one card
or run on the CPU. Any other world size is refused. With ``--index-dir`` a
sharded set is saved and loaded as one committed directory, and
``--swap-mid-run`` swaps every shard under one epoch.

``--sweep-k A,B,...`` replays the stream at per-request k overrides; the
port compiles nothing per point, and the live retriever's ``n_traces()``
stays 0. ``--slo-p99-ms`` / ``--deadline-ms`` / ``--tenant-quota`` turn on
the SLO control plane: the degradation ladder, deadlines that fail queued
requests fast with ``DeadlineExceeded``, per-tenant token buckets.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 16384 --requests 128        # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n-docs 2048 --vocab 512  # CPU smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --index-dir /tmp/lsp_index  # save, then mmap
  PYTHONPATH=src python -m repro_torch.launch.serve --swap-mid-run --sweep-k 1,5,10
  PYTHONPATH=src python -m repro_torch.launch.serve --slo-p99-ms 50 --deadline-ms 25
  PYTHONPATH=src python -m repro_torch.launch.serve --tenant-quota 'default=100/20,teamA=500'
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 3  # host-loop transport
  PYTHONPATH=src torchrun --nproc-per-node 3 -m repro_torch.launch.serve --shards 3  # process group
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.api import DynamicParams, Retriever, SearchRequest, StaticConfig
from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries
from repro_torch.device import resolve_device
from repro_torch.index.builder import IndexBuildConfig, build_index
from repro_torch.index.store import (
    SHARDED_MANIFEST_FORMAT,
    IndexStoreError,
    load_index_auto,
    manifest_format,
    read_manifest,
    read_sharded_manifest,
    save_index,
    save_sharded_index,
)
from repro_torch.serve import AdmissionConfig, DeadlineExceeded, SLOConfig, TenantQuota
from repro_torch.serve.group import GROUP_TIMEOUT_S, Follower, GroupFrontEnd

N_TOPICS = 32  # the launcher's synthetic corpus


def parse_tenant_quotas(spec: str) -> AdmissionConfig:
    """Parse ``'tenant=rate[/burst],...'``; the tenant name ``default`` sets the
    quota applied to every tenant not listed explicitly."""
    quotas, default_quota = {}, None
    for item in spec.split(","):
        name, sep, rb = item.partition("=")
        if not sep or not name.strip():
            raise ValueError(f"bad --tenant-quota item {item!r}; want 'tenant=rate[/burst]'")
        rate, _, burst = rb.partition("/")
        q = TenantQuota(rate=float(rate), burst=float(burst) if burst else 0.0)
        if name.strip() == "default":
            default_quota = q
        else:
            quotas[name.strip()] = q
    return AdmissionConfig(quotas=quotas, default_quota=default_quota)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--n-docs", type=int, default=16384)
    p.add_argument("--vocab", type=int, default=2048)
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--c", type=int, default=16)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--gamma", type=int, default=0, help="0 -> NS/8 (zero-shot scaled)")
    p.add_argument("--variant", default="lsp0", choices=["lsp0", "lsp1", "lsp2", "sp", "bmp"])
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--no-buckets", action="store_true",
                   help="single shape: every batch padded to max-batch")
    p.add_argument("--cache-size", type=int, default=1024, help="result-cache entries; 0 disables")
    p.add_argument("--no-warmup", action="store_true", help="skip the warm-up of every bucket")
    p.add_argument("--shards", type=int, default=0,
                   help="serve through the sharded backend over N index shards (the process-group "
                        "transport under torchrun with N ranks, else the host loop in one process)")
    p.add_argument("--index-dir", default=None,
                   help="persisted-index dir: mmap-load if committed, else build + save")
    p.add_argument("--swap-mid-run", action="store_true",
                   help="hot-swap to a re-built index halfway through the stream")
    p.add_argument("--sweep-k", default=None,
                   help="comma-separated k values (each <= --k) replayed as "
                        "per-request DynamicParams overrides, zero recompiles")
    p.add_argument("--slo-p99-ms", type=float, default=0.0,
                   help="SLO controller target: degrade per-request params under "
                        "queue/latency pressure to hold served p99 under this (0 = off)")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="per-request deadline: queued requests past it fail fast "
                        "with DeadlineExceeded, never scored (0 = none)")
    p.add_argument("--tenant-quota", default=None,
                   help="admission quotas 'tenant=rate[/burst],...' in requests/s; "
                        "tenant 'default' covers unlisted tenants")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


class ServeRun(NamedTuple):
    """What one run of the launcher served (rank 0; None on a follower)."""

    corpus: Any
    index: Any  # what the run opened: an LSPIndex or ShardedIndex, or in a process group its directory
    swapped: Any  # the index --swap-mid-run flipped to (None without it, or in a process group)
    static_cfg: StaticConfig
    params: DynamicParams
    retriever: Retriever
    engine: Any  # serve.RetrievalEngine, shut down
    queries: list
    responses: list  # SearchResponse per request, in order; DeadlineExceeded where shed
    sweep: list  # the --sweep-k responses, k by k, in request order (empty without it)
    recompiles: Optional[int]
    summary: dict  # engine.stats.summary() after the shutdown


def make_host_group(model: int, device=None):
    """The process group of the shard ranks that ``torchrun`` started (its
    ``RANK``/``WORLD_SIZE``/``MASTER_*`` environment): one rank a shard.
    Returns (group, this rank's device). Raises ValueError unless the world
    has ``model`` ranks."""
    world = int(os.environ["WORLD_SIZE"])
    if world != model:
        raise ValueError(f"--shards {model} needs a process group of {model} ranks, not {world}")
    device = resolve_device(device)
    # NCCL where every rank has a card of its own; gloo where ranks share one (NCCL refuses that) or the CPU
    backend = "nccl" if device.type == "cuda" and torch.cuda.device_count() >= world else "gloo"
    if backend == "nccl":  # a card each
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    if dist.get_rank() == 0:
        print(f"[serve] process group of {world} ranks over {backend}"
              + (" (one card each)" if backend == "nccl" else f" on {device}"))
    return dist.group.WORLD, device


def _load_or_build(args, corpus, bcfg, n_shards: int, device, group) -> tuple:
    """(the index or, in a process group, the committed sharded directory;
    the global superblock count; whether it was stored already; a temporary
    directory to remove or None), by the JAX launcher's rules: a committed
    index of the asked shard count is mmap-loaded, anything else is rebuilt
    and saved under ``--index-dir``."""
    if args.index_dir:
        try:
            t0 = time.perf_counter()
            fmt = manifest_format(args.index_dir)
            stored_shards = read_sharded_manifest(args.index_dir)["n_shards"] if fmt == SHARDED_MANIFEST_FORMAT else 0
            if stored_shards != n_shards:
                print(f"[serve] stored index has {stored_shards} shards, want {n_shards}; rebuilding")
            elif group is not None:  # each rank loads its own shard when the front end opens it
                return args.index_dir, read_sharded_manifest(args.index_dir)["n_superblocks"], True, None
            else:
                idx = load_index_auto(args.index_dir, mmap=True, device=device)
                fp = idx.fingerprint if stored_shards else read_manifest(args.index_dir)["fingerprint"]
                print(f"[serve] mmap-loaded index {args.index_dir} ({fp[:12]}…) "
                      f"in {time.perf_counter() - t0:.3f}s")
                return idx, idx.n_superblocks, True, None
        except FileNotFoundError:
            pass
        except IndexStoreError as exc:  # version/manifest drift -> rebuild + resave
            print(f"[serve] stored index unusable ({exc}); rebuilding")
    t0 = time.perf_counter()
    idx = build_index(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab, bcfg, device=device)
    print(f"[serve] built index in {time.perf_counter() - t0:.1f}s")
    tmp, target = None, args.index_dir
    if group is not None and not target:  # the ranks meet at a directory
        tmp = tempfile.mkdtemp(prefix="lsp-serve-")
        target = os.path.join(tmp, "index")
    if target:
        if n_shards:
            fp = save_sharded_index(target, idx, n_shards, bcfg)
            print(f"[serve] saved {n_shards}-shard index -> {target} ({fp[:12]}…)")
            if group is not None:  # each rank loads its own shard when the front end opens it
                return target, idx.n_superblocks, False, tmp
            idx = load_index_auto(target, mmap=True, device=device)
        else:
            fp = save_index(target, idx, bcfg)
            print(f"[serve] saved index -> {target} ({fp[:12]}…)")
    return idx, idx.n_superblocks, False, tmp


def serve_job(args: argparse.Namespace, corpus=None, group=None) -> Optional[ServeRun]:
    """One run of the launcher from its parsed arguments (``parse_args``),
    printing what the JAX package's launcher prints. ``corpus`` is the
    synthetic corpus of ``--n-docs``/``--vocab`` if the caller has it
    already. With ``group`` (a process group of ``--shards`` ranks) rank 0
    serves through the group front end and every other rank follows it until
    the shutdown and returns None."""
    device = resolve_device(args.device)
    n_shards = args.shards
    if group is not None:
        world = dist.get_world_size(group)
        if world != n_shards:
            raise ValueError(f"--shards {n_shards} needs a process group of {n_shards} ranks, not {world}")
        if dist.get_rank(group) != 0:
            Follower(group, device).run()
            return None
    ccfg = CorpusConfig(n_docs=args.n_docs, vocab=args.vocab, n_topics=N_TOPICS, seed=0)
    front = GroupFrontEnd(group, device) if group is not None else None  # its heartbeats start now
    tmps = []
    eng = None
    try:
        if corpus is None:
            corpus = make_corpus(ccfg)
        elif (len(corpus.doc_ptr) - 1, corpus.vocab) != (args.n_docs, args.vocab):
            raise ValueError("the corpus passed in is not the one of --n-docs and --vocab")
        bcfg = IndexBuildConfig(b=args.b, c=args.c)
        idx, ns, stored, tmp = _load_or_build(args, corpus, bcfg, n_shards, device, group)
        tmps.append(tmp)
        gamma = args.gamma or max(16, ns // 8)
        scfg = StaticConfig(variant=args.variant, gamma=gamma, gamma0=min(32, gamma), k_max=args.k)
        params = DynamicParams.recommended(args.k)
        print(f"[serve] NS={ns}, {args.variant} γ={gamma}" + (f", {n_shards} shards" if n_shards else ""))

        if front is not None:
            t0 = time.perf_counter()
            retr = front.open(idx, scfg, params)
            if stored:
                print(f"[serve] mmap-loaded index {idx} ({retr.index.fingerprint[:12]}…) "
                      f"in {time.perf_counter() - t0:.3f}s")
            print(f"[serve] shard_map transport: the engine on rank 0, {n_shards} ranks a shard each")
        else:
            if n_shards:
                print(f"[serve] one process for {n_shards} shards: host-loop transport")
            retr = Retriever.from_index(idx, scfg, params=params, shards=0 if hasattr(idx, "shards") else n_shards,
                                        device=device)
        batch_buckets = [args.max_batch] if args.no_buckets else None
        serve_kw = {}
        if args.slo_p99_ms:
            serve_kw["slo"] = SLOConfig(p99_ms=args.slo_p99_ms)
        if args.deadline_ms or args.tenant_quota:
            adm = parse_tenant_quotas(args.tenant_quota) if args.tenant_quota else AdmissionConfig()
            serve_kw["admission"] = AdmissionConfig(default_deadline_ms=args.deadline_ms, quotas=adm.quotas,
                                                    default_quota=adm.default_quota)
        eng = retr.serve(max_batch=args.max_batch, nq_max=64, batch_buckets=batch_buckets,
                         cache_size=args.cache_size, warmup=not args.no_warmup, **serve_kw)
        print(f"[serve] backend {retr.backend_name}, buckets {eng.ladder}, cache={args.cache_size}")
        queries = make_queries(ccfg, corpus, args.requests)
        half = len(queries) // 2 if args.swap_mid_run else len(queries)
        futs = [eng.search(SearchRequest(t, w)) for t, w in queries[:half]]
        swapped = None
        if args.swap_mid_run:
            swapped = build_index(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab, bcfg, device=device)
            if front is not None:  # the ranks load the rebuilt set from a directory
                tmps.append(tempfile.mkdtemp(prefix="lsp-swap-"))
                new_dir = os.path.join(tmps[-1], "index")
                save_sharded_index(new_dir, swapped, n_shards, bcfg)
                swapped = None
                epoch = eng.swap_index(new_dir)
            else:
                epoch = eng.swap_index(swapped)  # built + warmed off the worker; atomic flip
            print(f"[serve] hot-swapped to epoch {epoch} "
                  f"({eng.stats.summary()['last_swap_ms']:.0f} ms) with traffic in flight")
            futs += [eng.search(SearchRequest(t, w)) for t, w in queries[half:]]
        responses = _collect(futs)
        shed = sum(isinstance(r, DeadlineExceeded) for r in responses)
        if shed:
            print(f"[serve] {shed} queued requests shed at their deadline (typed, never scored)")
        sweep, recompiles = [], None
        if args.sweep_k:
            ks = [int(v) for v in args.sweep_k.split(",")]
            t0 = time.perf_counter()
            # count traces on the engine's LIVE backend: --swap-mid-run replaced the one `retr` was built with
            live = eng.retriever
            before = live.n_traces()
            sweep = _collect([eng.search(SearchRequest(t, w, params=DynamicParams(k=kv, beta=params.beta)))
                              for kv in ks for t, w in queries])
            recompiles = live.n_traces() - before
            print(f"[serve] dynamic sweep k={ks}: {len(sweep)} requests in "
                  f"{time.perf_counter() - t0:.1f}s, recompiles={recompiles}")
        eng.shutdown()
        s = eng.stats.summary()
        print(f"[serve] {s['requests']} requests / {s['batches']} batches | "
              f"mean {s['mean_ms']:.1f} ms p50 {s['p50_ms']:.1f} p99 {s['p99_ms']:.1f}")
        print(f"[serve] buckets used {s['bucket_batches']} | "
              f"cache hit rate {s['cache_hit_rate']:.2f} ({s['cache_hits']}/{s['cache_hits'] + s['cache_misses']}) | "
              f"swaps {s['swaps']} | failures {s['failures']}")
        if args.slo_p99_ms or args.deadline_ms or args.tenant_quota:
            print(f"[serve] slo: degraded {s['degraded']} | "
                  f"deadline_expired {s['deadline_expired']} | "
                  f"quota_rejected {s['quota_rejected']} | rejected {s['rejected']}"
                  + (f" | level {s.get('slo_level')}" if args.slo_p99_ms else ""))
        return ServeRun(corpus, idx, swapped, scfg, params, retr, eng, queries, responses, sweep, recompiles, s)
    finally:
        if eng is not None:
            eng.shutdown()
        if front is not None:
            front.close()
        for tmp in tmps:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)


def _collect(futs: list) -> list:
    """Each future's response, or its ``DeadlineExceeded`` (a shed request);
    any other failure raises."""
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=600))
        except DeadlineExceeded as exc:
            out.append(exc)
    return out


def main(argv=None) -> None:
    args = parse_args(argv)
    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # started by torchrun: a rank a shard
        group, device = make_host_group(args.shards, args.device)
        args.device = str(device)
    try:
        serve_job(args, group=group)
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
