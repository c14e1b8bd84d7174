#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

In order: builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
prints the card's name and power limit; holds each kernel against its plain
PyTorch version at a small shape; generates a 1,048,576-document synthetic
corpus (vocab 30,522) and builds its index on the card with
``Retriever.build``; answers 256 requests in four ``search_batch`` calls of
64 and checks that every kernel was launched; runs the same requests through
``impl="ref"`` and the ``exact`` backend; holds each kernel against its plain
version again at the shapes the search gave it and times both with CUDA
events (median of 20, L2 flushed); times ``search_batch`` and profiles one
call (device kernels, device idle share). The second-to-last
line is a JSON object of per-kernel numbers, the last ``{"ok": true, ...}``.
Any failed check raises and exits non-zero; without a CUDA device it exits 1
before printing any result. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_DOCS, VOCAB, N_TOPICS = 1_048_576, 30_522, 1024
N_QUERIES, BATCH = 256, 64
K = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-4)  # float32 sums in another order than the plain version
REPS = 20


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg):
    print(msg, flush=True)


def timed_ms(fn, flush, reps=REPS):
    """Median device time of ``fn`` in ms over ``reps`` runs, each after a
    512 MB memset that evicts the L2 and keeps the device busy while the
    host enqueues the timed launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, flops):
    """(least time in ms, what bounds it): bytes over the HBM rate vs float32
    operations over the card's float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def sbmax_work(packed, tids, ws, bits, granule):
    import torch

    live = ws != 0
    rows = torch.unique(tids[live]).numel()
    w = packed.shape[1]
    vpw = 32 // bits
    nbytes = rows * w * 4 + _nbytes(tids, ws) + tids.shape[0] * w * vpw * 4
    return nbytes, 2.0 * int(live.sum()) * w * vpw


def boundsum_work(packed, c, bits, tids, ws, sel):
    import torch

    cw = c * bits // 32
    live = (ws != 0)[:, :, None].expand(-1, -1, sel.shape[1])
    pairs = tids.long()[:, :, None] * (packed.shape[1] // cw) + sel.long()[:, None, :]
    granules = torch.unique(pairs[live]).numel()
    nbytes = granules * cw * 4 + _nbytes(tids, ws, sel) + sel.numel() * c * 4
    return nbytes, 2.0 * int(live.sum()) * c


def doc_score_work(tids3, ws3, qdense, blk):
    import torch

    _, b, t = tids3.shape
    blocks = torch.unique(blk).numel()
    postings = int((tids3[blk.long()] != qdense.shape[1] - 1).sum())  # non-sentinel slots
    nbytes = blocks * b * t * (4 + ws3.element_size()) + _nbytes(qdense, blk) + blk.numel() * b * 4
    return nbytes, 2.0 * postings


def small_kernel_checks(device):
    """Each kernel against its plain version at one small shape."""
    import torch

    from repro_torch.index.pack import pack_rows_strided
    from repro_torch.kernels.boundsum_gather.kernel import boundsum_gather_kernel
    from repro_torch.kernels.boundsum_gather.ref import boundsum_gather_ref
    from repro_torch.kernels.doc_score.kernel import doc_score_fwd_kernel
    from repro_torch.kernels.doc_score.ref import doc_score_fwd_ref
    from repro_torch.kernels.sbmax.kernel import sbmax_kernel
    from repro_torch.kernels.sbmax.ref import sbmax_ref

    g = torch.Generator(device="cpu").manual_seed(0)

    def ints(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g).to(device, dtype)

    def floats(shape):
        return torch.rand(shape, generator=g).to(device)

    errs = {}
    for bits, granule in ((4, 128), (8, 128), (4, 2)):
        packed = pack_rows_strided(ints(1 << bits, (300, 4096), torch.uint8), bits, granule)
        tids, ws = ints(300, (3, 17)), floats((3, 17))
        ws[:, -1] = 0.0
        k_out = sbmax_kernel(packed, tids, ws, bits, granule)
        p_out = sbmax_ref(packed, tids, ws, bits, granule)
        torch.testing.assert_close(k_out, p_out, **TOL)
        errs[f"sbmax bits={bits} granule={granule}"] = float((k_out - p_out).abs().max())
    for bits, c in ((4, 16), (8, 4)):
        packed = pack_rows_strided(ints(1 << bits, (150, 30 * c), torch.uint8), bits, c * bits // 32)
        tids, ws, sel = ints(150, (2, 9)), floats((2, 9)), ints(30, (2, 7))
        k_out = boundsum_gather_kernel(packed, c, bits, tids, ws, sel)
        p_out = boundsum_gather_ref(packed, c, bits, tids, ws, sel)
        torch.testing.assert_close(k_out, p_out, **TOL)
        errs[f"boundsum_gather bits={bits} c={c}"] = float((k_out - p_out).abs().max())
    vocab = 300
    tids3 = ints(vocab + 1, (17, 4, 24))
    ws3 = ints(256, (17, 4, 24), torch.uint8)
    qdense = torch.randn((3, vocab + 1), generator=g).to(device)
    qdense[:, vocab] = 0.0
    blk = ints(17, (3, 9))
    k_out = doc_score_fwd_kernel(tids3, ws3, qdense, blk)
    p_out = doc_score_fwd_ref(tids3, ws3, qdense, blk)
    torch.testing.assert_close(k_out, p_out, **TOL)
    errs["doc_score_fwd"] = float((k_out - p_out).abs().max())
    return errs


def profile_search_batch(retr, batch):
    """Where one search_batch's time goes: device kernels by name (CUPTI,
    through torch.profiler), their count, and the device's idle share of the
    call's wall time. Prints "not measured" if the profiler sees no device time."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    retr.search_batch(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        retr.search_batch(batch)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler saw no device time; device busy share not measured")
        return
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:90]] += e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    log(f"profile of one search_batch ({len(batch)} requests, profiler on): wall {wall_us / 1e3:.2f} ms, "
        f"{len(kernels)} device kernels, device busy {busy_us / 1e3:.3f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    for name, us in by_name.most_common(12):
        log(f"  {us / 1e3:8.4f} ms  {name}")
    cpu = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in cpu[:8]:
        log(f"  host {e.self_cpu_time_total / 1e3:8.3f} ms  {e.count:4d} x {e.key}")
    torch.cuda.synchronize()


def recording(fn, calls):
    """``fn`` that also appends the arguments of every call to ``calls``."""

    def wrapper(*args):
        calls.append(args)
        return fn(*args)

    return wrapper


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    return smoke(torch.device("cuda", 0))


def smoke(device) -> int:
    import numpy as np
    import torch

    from repro_torch.api import Retriever, SearchRequest
    from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries
    from repro_torch.eval.metrics import recall_vs_oracle
    from repro_torch.index.layout import index_nbytes
    from repro_torch.core import ops as core_ops
    from repro_torch.kernels import _build
    from repro_torch.kernels.boundsum_gather.ref import boundsum_gather_ref
    from repro_torch.kernels.doc_score.ref import doc_score_fwd_ref
    from repro_torch.kernels.sbmax.ref import sbmax_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # k-means distances in full float32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. build the kernels (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- 2. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 3. kernels vs plain versions at a small shape
    for name, err in small_kernel_checks(device).items():
        log(f"small-shape check {name}: max_abs_err {err:.3g}")

    # ---- 4. corpus and index build on the card
    t0 = time.perf_counter()
    ccfg = CorpusConfig(n_docs=N_DOCS, vocab=VOCAB, n_topics=N_TOPICS, seed=0)
    corpus = make_corpus(ccfg)
    queries = make_queries(ccfg, corpus, N_QUERIES, seed=1)
    log(f"corpus: {N_DOCS} docs, {len(corpus.tids)} postings, vocab {VOCAB}, "
        f"{N_QUERIES} queries (host, {time.perf_counter() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    retr = Retriever.build(corpus, device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    idx = retr.index
    log(f"index built on the card in {build_s:.1f} s: {idx.n_blocks} blocks, {idx.n_superblocks} "
        f"superblocks, t_pad {idx.docs_fwdq.t_pad}; index holds {index_nbytes(idx) / 1e9:.3f} GB "
        f"on the card; build peak {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    log(f"retriever: {retr}")
    requests = [SearchRequest(t, w) for t, w in queries]
    batches = [requests[i: i + BATCH] for i in range(0, N_QUERIES, BATCH)]

    # ---- one warm-up batch, recording the inputs each kernel is handed
    captured = {"sbmax": [], "boundsum_gather": [], "doc_score_fwd": []}
    patches = [("sbmax_kernel", "sbmax"), ("boundsum_gather_kernel", "boundsum_gather"),
               ("doc_score_fwd_kernel", "doc_score_fwd")]
    originals = {}
    for attr, key in patches:
        originals[key] = fn = getattr(core_ops, attr)
        setattr(core_ops, attr, recording(fn, captured[key]))
    retr.search_batch(batches[0])
    for attr, key in patches:
        setattr(core_ops, attr, originals[key])
    torch.cuda.synchronize(device)

    # ---- 5-6. the main path: 256 requests in four search_batch calls, counted
    for fn in originals.values():
        fn.launches = 0
    responses, batch_s = [], []
    for batch in batches:
        t0 = time.perf_counter()
        responses += retr.search_batch(batch)
        batch_s.append(time.perf_counter() - t0)
    launches = {key: fn.launches for key, fn in originals.items()}
    log(f"launches during the 4 search_batch calls: {launches}")
    for key, n in launches.items():
        check(n > 0, f"kernel {key} was never launched on the main path")
    ids = np.stack([r.doc_ids for r in responses])
    scores = np.stack([r.scores for r in responses])
    check(ids.shape == (N_QUERIES, K) and np.isfinite(scores).all(), "result shape / finite scores")
    check(((ids >= 0) & (ids < N_DOCS)).all(), "every query returns k valid doc ids")

    # ---- 7. the same requests through impl="ref" on the card and through the exact backend
    ref = Retriever.from_index(idx, retr.static_cfg, impl="ref", device=device)
    ref_resp = [r for b in batches for r in ref.search_batch(b)]
    same_counters = all(
        (a.n_superblocks_visited, a.n_blocks_scored) == (b.n_superblocks_visited, b.n_blocks_scored)
        for a, b in zip(responses, ref_resp)
    )
    ref_ids = np.stack([r.doc_ids for r in ref_resp])
    rec_ref = recall_vs_oracle(ids, ref_ids)
    log(f"kernel path vs impl='ref': counters equal {same_counters}, recall@10 {rec_ref:.4f}, "
        f"ids identical {float((ids == ref_ids).mean()):.4f}")
    check(same_counters, "kernel and ref paths visit the same superblocks and blocks")
    check(rec_ref >= 0.99, f"recall@10 of the kernel path against the ref path {rec_ref} < 0.99")
    t0 = time.perf_counter()
    exact = Retriever.from_index(idx, retr.static_cfg, backend="exact", device=device)
    exact_ids = np.stack([r.doc_ids for b in batches for r in exact.search_batch(b)])
    exact_s = time.perf_counter() - t0
    rec_exact = recall_vs_oracle(ids, exact_ids)
    visited = float(np.mean([r.n_superblocks_visited for r in responses]))
    blocks = float(np.mean([r.n_blocks_scored for r in responses]))
    log(f"lsp0 recall@10 vs exact: {rec_exact:.4f} (exact backend {exact_s:.1f} s for {N_QUERIES}); "
        f"mean superblocks visited {visited:.1f} / {idx.n_superblocks}, blocks scored {blocks:.1f}")

    # ---- 8. each kernel vs its plain version at the main path's shapes, timed
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device=device)
    plain = {"sbmax": sbmax_ref, "boundsum_gather": boundsum_gather_ref, "doc_score_fwd": doc_score_fwd_ref}
    work = {"sbmax": sbmax_work, "boundsum_gather": boundsum_work, "doc_score_fwd": doc_score_work}
    meta = {
        "sbmax": ("src/repro_torch/csrc/sbmax.cu", "src/repro/kernels/sbmax/kernel.py:51"),
        "boundsum_gather": ("src/repro_torch/csrc/boundsum_gather.cu",
                            "src/repro/kernels/boundsum_gather/kernel.py:45"),
        "doc_score_fwd": ("src/repro_torch/csrc/doc_score.cu", "src/repro/kernels/doc_score/kernel.py:40"),
    }
    rows = []
    for key, calls in captured.items():
        check(calls, f"no captured call of {key}")
        per_call = []
        for args in calls:
            k_out = originals[key](*args)
            p_out = plain[key](*args)
            torch.testing.assert_close(k_out, p_out, **TOL)
            err = float((k_out - p_out).abs().max())
            ms = timed_ms(lambda: originals[key](*args), flush)
            plain_ms = timed_ms(lambda: plain[key](*args), flush)
            bound_ms, bound_by = bound(*work[key](*args))
            shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            log(f"{key} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), max_abs_err {err:.3g}")
            per_call.append((ms, err, plain_ms, bound_ms, bound_by))
        ms, err, plain_ms, bound_ms, bound_by = max(per_call)  # the largest call of the path
        src, replaces = meta[key]
        rows.append({"name": key, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[key], "max_abs_err": max(p[1] for p in per_call), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

    # ---- search_batch end to end (host clock; each call ends in a device->host copy)
    for _ in range(2):
        for batch in batches:
            t0 = time.perf_counter()
            retr.search_batch(batch)
            batch_s.append(time.perf_counter() - t0)
    ref_s = []
    for batch in batches:
        t0 = time.perf_counter()
        ref.search_batch(batch)
        ref_s.append(time.perf_counter() - t0)
    log(f"search_batch of {BATCH}: median {statistics.median(batch_s) * 1e3:.2f} ms over {len(batch_s)} "
        f"calls (kernel path); impl='ref' median {statistics.median(ref_s) * 1e3:.2f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    profile_search_batch(retr, batches[0])
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
