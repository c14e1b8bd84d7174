#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

In order: builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
prints the card's name and power limit; holds each kernel against its plain
PyTorch version at a small shape (and sbmax at its call sites' widths on
seeded inputs, with a sha256 of the output's bits to set beside another
build's); generates a 1,048,576-document synthetic
corpus (vocab 30,522) and builds its index on the card with
``Retriever.build``; answers 256 requests in four ``search_batch`` calls of
64 and checks that every kernel of that path was launched; runs the same
requests through ``impl="ref"`` and the ``exact`` backend; answers them again
under ``doc_layout="flat"``, under lsp2 (sbmax at phase 1 and SBavg) and
under bmp (sbmax as the BoundSum over all blocks), each kernel path against
``impl="ref"`` on ids and both counters of every query; holds the runner's
CUDA graphs to the eager traversal (every variant and lsp0 flat, Q 1 and 64,
three nq buckets, to the bit; one capture a bucket, then replays; a launch's
kept arguments; kernels a call on both paths; host ms); serves the same
256 requests through ``Retriever.serve`` (the bucketed engine, warmed on every
bucket) from 8 client threads against ``search_batch`` (launches counted),
times closed loops of 1 and 64 client threads (p50, p99, batches per
bucket), fails every third batch with a chaos fault, serves requests with
out-of-range term ids against ``impl="ref"`` and the 256 again after them,
repeats the requests through a result cache, saves the index to a temporary
directory and ``swap_index``es it back from disk; promotes a retriever over
the same index to a live mutable one (``recommended_static(64, ns)``, k 10),
adds 1,024 docs and deletes 48, answers the 256 requests through the kernels
against ``impl="ref"`` on the same mutable state (ids and both counters,
launches counted), compacts on the card and answers them again, with recall@10
against exact over the logical corpus, times the delta's parts (the
traversal, ``score_delta_docs``, ``merge_mutable_topk``) and the compaction's
stages, serves it through the engine with a background ``CompactionManager``
(32 dominating adds each at rank 0 on the next search; a 90/10 read/write mix
until a flip, every probe response audited by its ``delta_seq``), saves and
reloads it in the mutable format, and promotes a retriever loaded from the
single-index save (``corpus_from_index``); cuts the index into 3 shards,
saves them with ``save_sharded_index`` and reads them back; serves those 3
shards through the host-loop ``sharded`` backend (the 256 requests equal to
the local responses on ids, θ and both counters, and to its own
``impl="ref"``; sbmax, boundsum_gather and doc_score_fwd launching on every
shard), under lsp2 and a binding block budget against local, through the
engine over ``Retriever.load`` of the saved set with ``swap_index`` to the
single directory, back and again under client traffic, and through 3
spawned gloo ranks on the card, each loading only its shard, against the
host loop; builds a dense index
of 1,000,000 synthetic 64-dim candidate embeddings on the card and answers
256 query rows with ``retrieve_dense`` (kernel path, ``impl="ref"``,
exhaustive) and through the dense index cut into 4 shards (recall@10
against single-device, dequant_matmul on every shard); runs the recsys
models at full width, weights drawn on the card from a seeded CUDA
generator: dlrm-rm2 (6.656 GB of tables) and din (0.793 GB) at serve_p99
(512 rows; ms, peak GB, the profiler's kernels and idle share) and
serve_bulk (262,144 rows; DIN in chunks of 16,384), each held to the CPU
port on 16 rows, and the retrieval_cand sweep of 1 user over 1,000,000
candidates (chunks of 8,192 and 4,096) with its top 10 held to the CPU port;
mind (2.586 GB): 512 users' interests against the CPU port, its item tower
over 1,000,000 candidate items into a dense LSP index built on the card, and
64 users' 256 interest rows through ``retrieve_dense`` in four calls of 64
(dequant_matmul counted) against ``impl="ref"`` (recall@10 >= 0.99) and
exhaustive, each user's four exact per-interest top 10s merged by score
equal to the top 10 of ``mind_score_candidates`` over all 1,000,000; runs
schnet at full width over the molecule batch (128 graphs x 30 atoms x 64
edges, ``molecule_batch_forward``), full_graph_sm (2,708 nodes) and
minibatch_lg's sampled subgraph (169,984 nodes, 168,960 edges; the parent
graph's edges cut to a tenth of Reddit's), each held to the CPU port in
float32; trains the SPLADE
encoder at full width (``splade_100m_config``, 110 M parameters) through the
launcher's ``--splade`` job, bf16 compute, with falling ``ce``, checkpoints a
second run at step 10, restores it in a fresh ``Trainer`` and runs it to 20
against the straight run, probes the step under
``torch.use_deterministic_algorithms``, holds one float32 batch on the card
to the CPU port, encodes 65,536 documents and 256 queries on the card,
sparsifies them there, builds an index of the learned vectors with
``build_index`` and answers the 256 queries in four ``search_batch`` calls of
64 at lsp0 (kernels counted) against ``impl="ref"`` and exact, with
``estimate_theta`` and the γ analysis beside the synthetic index's; serves
decoder-only LMs through the stacked path, weights drawn on the card from a
seeded CUDA generator (no kernel of this repository on that path): qwen3-4b at
full width and depth (4,022,795,776 parameters), 64 float32 teacher-forced
decode steps after a 2 x 512 prefill against one forward over 2 x 1,024, the
same in bf16 against float32, its 2-layer cut against the CPU port, and bf16
serving (a 4 x 4,096 prefill, 128 greedy decode steps, a 1 x 32,768 prefill;
ms, tokens/s, peak GB, the profiler's kernels a decode step and idle share);
gemma3-27b cut to 6 layers, a 2 x 1,536 prefill wrapping and rolling the
ring buffer of its 1,024-token windows, against the forward; phi3.5-moe cut
to 2 layers against the CPU port with its dropped choices counted, then bf16
serving; trains qwen3-4b through the launcher's ``--arch`` job; runs the
distributed training layer in 4 spawned gloo ranks sharing the card:
qwen3-4b at full width and depth with its Adafactor moments, each leaf drawn
from its own seed and cut to the rank's shard by ``stacked_lm_param_specs``
and ``adafactor_state_specs`` on mesh (data 2, model 2), ``reshard_state``
to (data 1, model 4) against the redrawn leaves, a sample gathered on rank
0, a checkpoint of its 2-layer cut saved from the first mesh and
``restore_checkpoint(shardings=)`` onto the second; dlrm-rm2's 6.656 GB
table row-sharded over model = 4 through both vocab-parallel lookups at 512
and 16,384 rows (outputs to the bit against ``field_lookup``, zeros for
out-of-range ids, each shard's gradient against the whole table's); 20
data-parallel steps of the SPLADE encoder through ``compressed_psum``
against the uncompressed mean (within a quantization level, the
error-feedback identity), its step times fed to ``BackupStepPolicy``; runs
the cells phase: ``launch/dryrun.py``'s meta pass over the 37 cells of
``launch/specs.py`` on both production meshes in 8 processes (a line a
cell: per-rank argument bytes, global and per-device FLOPs, ops), then on
the card through ``measure_cell`` the schnet, dlrm-rm2, din and mind
training steps, mind's 16-shard retrieval (dequant_matmul counted, ids
against ``impl="ref"``), qwen3-4b's decode at a 32,768-token cache and its
train_4k step at one (pod 2, data 16) position's share (ms, peak GB above
what the card held before, the profiler's kernels, counted and model
TFLOP/s; the schnet molecule and mind training steps held against the same
step on the CPU), and ``impl="legacy"`` on the 1 M index
at lsp0, lsp2 and bmp against ``impl="ref"``; holds
each kernel against its plain version again at the shapes
its path gave it and times both with CUDA events (median of 20, L2 flushed):
sbmax at each of its call sites (phase 1, SBavg, bmp's BoundSum; a row each,
with a ``zero_()`` of its output as the floor), doc_score_fwd and doc_score_flat at the block ids and mask of round 0
and phase 3, boundsum_gather at phase 2's superblocks and eligibility mask,
each masked kernel with two bounds (its contract's: the live blocks or
granules and the query-row sectors they look up; and every selected block or
superblock) and two floors (the kernel with every pair masked, and a
``zero_()`` of its output), the doc_score kernels again with the query row
padded past what shared memory holds, so every lookup goes to L2; times
``search_batch`` and profiles one call of each path (device kernels, device
idle share). Each path's launch counts are set to 0 just before it
runs and read just after. The second-to-last line is a JSON object of
per-kernel numbers (with a ``"path": "sharded"`` row for each kernel of the
sharded paths, over its per-shard launches, a ``"path": "mind"`` row for
dequant_matmul at the shapes MIND's retrieval gave it, and a ``"path":
"encoder"`` row for each kernel of the learned index's path), the last
``{"ok": true, ...}``.
Any failed check raises and exits non-zero; without a CUDA device it exits 1
before printing any result. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_DOCS, VOCAB, N_TOPICS = 1_048_576, 30_522, 1024
N_QUERIES, BATCH = 256, 64
K = 10
# dense phase: MIND's 64-dim embeddings, the recsys retrieval_cand cell's 1M
# candidates, 64 users x MIND's 4 interests; clustered like
# benchmarks/dense_retrieval.py (64 Gaussian centres, noise 0.25 / 0.2)
N_CANDS, DIM, N_CENTRES, N_INTEREST_ROWS = 1_000_000, 64, 64, 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-4)  # float32 sums in another order than the plain version
L2_ROW_FLOATS = 60_000  # a dense query row this long does not fit in an H100 thread block's shared memory
QDENSE_ARG = {"doc_score_fwd": 2, "doc_score_flat": 3}  # where each doc_score kernel takes its dense query rows
REPS = 20
ENGINE_NQ = 64  # the serving engine's widest nq bucket
GRAPH_WIDTHS = (13, 24, 37)  # nq buckets 16 (padded), 24 (exact), 40 (padded)
GRAPH_TIMED_CALLS = 30
ENGINE_TOL = dict(rtol=1e-5, atol=1e-5)  # the same kernels on batches of another shape
# mutable phase: k_max headroom over k for the tombstone overfetch (k + 48 <= 64), as
# benchmarks/freshness_suite.py; 1,024 adds (CompactionManager's default max_delta_docs)
MUT_K_MAX, MUT_ADDS, MUT_DELETES, N_VISIBLE = 64, 1024, 48, 32
MIX_AFTER_FLIP, MIX_LIMIT_S = 100, 300  # reads of the 90/10 mix after its first flip; its time limit
N_SHARDS = 3  # a ragged last shard, and an unaligned cut of the superblock matrices
# a block budget below lsp0's budget*c = 4,000 blocks, at an η that lets the θ/η cut
# keep more blocks than that a query, so the cross-shard cut removes blocks
SHARDED_BLOCK_BUDGET, SHARDED_BUDGET_ETA = 64, 4.0
DENSE_SHARDS = 4  # the dense index's 984 superblocks cut evenly
RANK_TIMEOUT_S = 300  # a process-group rank that sends nothing in this time fails the run
# encoder phase: splade_100m_config at vocab 32,768, the JAX launcher's --splade job
# (batch 64, AdamW lr 3e-4, warmup 10, bf16 compute); 65,536 documents encoded
# and indexed, the top 64 terms a document and 32 a query above 1e-4, as
# examples/train_sparse_encoder.py; lsp0 at a quarter of the superblocks, as the example
ENC_STEPS, ENC_BATCH, ENC_WARMUP = 240, 64, 5
ENC_RESUME_AT = 20  # the resume check: a run checkpointed at 10, restored and run to 20, against the straight run
ENC_DOCS, ENC_ENCODE_BATCH, ENC_TOP_DOC, ENC_TOP_Q, ENC_MIN_WEIGHT = 65_536, 1024, 64, 32, 1e-4
ENC_GAMMA_DIV = 4
ENC_DEVICE_RTOL = 1e-4  # float32 on both devices (TF32 off), sums in another order
ENC_RESUME_ATOL = 1e-3  # a few AdamW steps of lr 3e-4, if an op were nondeterministic
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16
# LM phase: qwen3-4b at full width and depth; 2 sequences of 1,024 tokens from
# lm_synthetic_batch, the first 512 prefilled and 64 decoded teacher-forced
# against one forward over all 1,024
LM_SEED, QWEN_PARAMS = 0, 4_022_795_776
LM_SEQ, LM_PROMPT, LM_STEPS = 1024, 512, 64
LM_F32_RTOL = 1e-4  # decode against the forward, tests/test_arch_smoke.py's bound; card against CPU the same
# twice JAX's own bf16-vs-float32 gap (relative error norm of the decode logits)
# at qwen3's 36 layers and the reduced widths, mean of 3 seeds 0.019450 (tests/lm_bf16_gap.py)
LM_BF16_GAP = 0.0389
# bf16 serving: train_4k's length at prefill_32k's batch of 32 cut to 4, 128
# greedy steps (decode_32k's batch of 128 cut to 4, at a 4,224-token cache),
# then prefill_32k's full length at batch 1
LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_STEPS, LM_LONG = 4, 4096, 128, 32768
LM_CPU_TOKENS = 128  # the 2-layer cut's forward, card against CPU
LM_GEMMA_LAYERS, LM_GEMMA_SEQ, LM_GEMMA_PROMPT = 6, 2048, 1536  # one group: 5 sliding-window, 1 global
LM_PHI_LAYERS, LM_PHI_TOKENS, LM_PHI_PROMPT, LM_PHI_STEPS = 2, 64, 1024, 32
# serving-launcher phase: python -m repro_torch.launch.serve at the smoke's corpus size (its own
# 32 topics), 256 requests at its default max batch of 8; the SLO flags at the JAX launcher's
# example target, a deadline and a quota no request reaches
LAUNCH_REQUESTS, LAUNCH_SHARDS = 256, 3
LAUNCH_SLO = ["--slo-p99-ms", "50", "--deadline-ms", "60000", "--tenant-quota", "default=1000000/1000000"]
# LM-training phase: the launcher's --arch job (Adafactor lr 1e-3, bf16 compute over float32
# masters, remat, lm_synthetic_batch) for qwen3-4b at full width and depth; its 2-layer cut in
# float32, card against CPU after 2 steps (a smaller batch: the CPU runs it) and a checkpoint at
# step 2 resumed to 4 against the straight run; phi3.5-moe at 2 layers for 3 bf16 steps
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP = "qwen3-4b", 20, 8, 128, 3
TRAIN_CUT_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 2, 64
TRAIN_CPU_RTOL = 1e-4  # float32 on both devices (TF32 off), sums in another order; per leaf, in norm
TRAIN_PHI_STEPS = 3
# recsys phase: dlrm-rm2, din and mind at full width, weights from a seeded CUDA generator, data
# from seeded numpy; the recsys shapes serve_p99 (512 rows) and serve_bulk (262,144; DIN in chunks
# of 16,384, as its [B, 100, 216] attention input alone is 22.6 GB at once), retrieval_cand (1 user
# x 1,000,000 candidates in chunks of 8,192 for DLRM and 4,096 for DIN, launch/specs.py's); mind:
# 1,000,000 candidate items (distinct item ids, Zipf categories) into the dense LSP index, 64 users'
# 4 interests through retrieve_dense at the dense phase's settings
REC_SEED, REC_REPS = 0, 10
REC_P99, REC_BULK, REC_CANDS = 512, 262_144, 1_000_000
DLRM_CHUNK, DIN_CHUNK, DIN_BULK_CHUNK = 8192, 4096, 16_384
MIND_USERS, MIND_ZIPF = 64, 1.2
REC_CPU_ROWS = 16  # rows of a batch held to the CPU port
REC_CPU_RTOL = 1e-4  # card against CPU in float32 (TF32 off), sums in another order: max abs error / max |reference|
MERGE_RTOL = 1e-5  # the per-interest merge against mind_score_candidates: two float32 einsums, another order
# GNN phase: schnet at full width over the molecule, full_graph_sm and minibatch_lg shapes;
# minibatch_lg's parent graph has Reddit's 232,965 nodes and a tenth of its 114,615,892 edges
# (host generation; the sampled subgraph's shapes do not depend on the edge count)
GNN_SEED, GNN_PARENT_EDGES = 0, 11_461_589
GNN_CPU_RTOL = 1e-4  # card against CPU in float32; the card's segment sums use atomics
# distributed phase: 4 gloo ranks on the one card. qwen3-4b at full width and depth placed by
# stacked_lm_param_specs(fsdp=True, kv_shard=False) + adafactor_state_specs on (data 2, model 2),
# resharded to (data 1, model 4), a checkpoint of its DIST_CKPT_LAYERS-layer cut saved from the
# first mesh and restored onto the second; dlrm-rm2's stacked table row-sharded over model = 4
# through both vocab-parallel lookups (serve_p99's 512 rows, one 16,384-row serve_bulk chunk);
# compressed_psum over data = 4 on the SPLADE encoder's gradients, a quarter of a --splade batch of
# 64 a rank, for DIST_CP_STEPS steps
DIST_WORLD, DIST_SEED, DIST_CKPT_LAYERS, DIST_CP_STEPS = 4, 0, 2, 20
DIST_MESH_A, DIST_MESH_B = ((2, 2), ("data", "model")), ((1, 4), ("data", "model"))
DIST_GATHERED = ("params/embed", "params/groups/0/attn/wk", "params/final_norm", "moments/groups/0/attn/wq/vr")
DIST_LOOKUP_BATCHES = {"serve_p99": 512, "serve_bulk chunk": 16_384}
DIST_ROW_CHUNK = 1 << 20  # table rows drawn per seeded chunk, so a rank draws only its own rows
DIST_GRAD_RTOL = 1e-6
DIST_REPS = 5
# cells phase: launch/dryrun.py's meta pass over every runnable cell on both production meshes, in
# CELL_WORKERS spawned processes (host work); then, on the card, the cells one H100 holds at full shape
# or at the share one (pod 2, data 16, model 16) position gets: (arch, shape, ShapeSpec fields cut, the
# cut by name, timed steps). Then impl="legacy" on the 1 M-document index, in batches of LEGACY_BATCH
CELL_WORKERS, CELL_SEED = 8, 0
CARD_CELLS = [
    ("schnet", "molecule", {}, "", 3),
    ("schnet", "full_graph_sm", {}, "", 3),
    ("schnet", "minibatch_lg", {}, "", 3),
    ("dlrm-rm2", "train_batch", {}, "", 3),
    ("din", "train_batch", {}, "", 3),
    ("mind", "train_batch", {"batch": 4096},
     "batch 4,096 of 65,536: the share of one (data 16, model 16) position; the in-batch softmax's [B, B] "
     "logits alone are 17.2 GB at the full batch, three times that with their softmax and gradient", 3),
    ("mind", "retrieval_cand", {}, "its 16 model shards on one card, through the host loop", 3),
    ("qwen3-4b", "decode_32k", {"global_batch": 4},
     "batch 4 of 128: the share of one (pod 2, data 16) position", 4),
    ("qwen3-4b", "train_4k", {"global_batch": 8},
     "8 of 256 sequences: the share of one (pod 2, data 16) position", 1),
]
# card cells whose first training step is also run on a CPU copy of the same inputs: the loss and
# every updated parameter held at GNN_CPU_RTOL x max |reference|, the update (new - old, all leaves)
# at CELL_UPDATE_RTOL x its largest CPU element. Adafactor divides each gradient element by its row's
# and column's RMS, so an element whose gradient is small beside its row's carries the float32
# summation noise of the card's atomics into the update (about 4e-4 of the largest update on
# schnet's molecule step, NVIDIA H100 80GB HBM3)
CELL_CPU_HELD = (("schnet", "molecule"), ("mind", "train_batch"))
CELL_UPDATE_RTOL = 1e-2
LEGACY_VARIANTS, LEGACY_BATCH = ("lsp0", "lsp2", "bmp"), 32
LEGACY_TOL = dict(rtol=1e-5, atol=1e-5)  # float32 sums in another order (ref's kernel-free scoring)
# name -> (core.ops attribute, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "sbmax": ("sbmax_kernel", "src/repro_torch/csrc/sbmax.cu", "src/repro/kernels/sbmax/kernel.py:51"),
    "boundsum_gather": ("boundsum_gather_kernel", "src/repro_torch/csrc/boundsum_gather.cu",
                        "src/repro/kernels/boundsum_gather/kernel.py:45"),
    "doc_score_fwd": ("doc_score_fwd_kernel", "src/repro_torch/csrc/doc_score.cu",
                      "src/repro/kernels/doc_score/kernel.py:40"),
    "doc_score_flat": ("doc_score_flat_kernel", "src/repro_torch/csrc/doc_score_flat.cu",
                       "src/repro/kernels/doc_score/kernel.py:84"),
    "dequant_matmul": ("dequant_matmul_kernel", "src/repro_torch/csrc/dequant_matmul.cu",
                       "src/repro/kernels/dequant_matmul/kernel.py:46"),
}
# sbmax's call sites (core/lsp.py), each by the index matrix it hands the kernel:
# phase 1 of every variant but bmp, SBavg of lsp2 and sp, bmp's all-block BoundSum
SBMAX_SITES = {"phase 1": "sb_bounds", "SBavg": "sb_avg", "bmp BoundSum": "blk_bounds"}


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


def boundsum_work(packed, c, bits, tids, ws, sel, mask):
    """The contract's own work: the granules of the live (term, eligible
    superblock) pairs (each distinct one read once), the query terms, the
    mask, the eligible pairs' superblock ids, the output written once; two
    operations per live term and bound."""
    import torch

    cw = c * bits // 32
    live = (ws != 0)[:, :, None] & mask[:, None, :]  # [Q, nq, S]
    pairs = tids.long()[:, :, None] * (packed.shape[1] // cw) + sel.long()[:, None, :]
    granules = torch.unique(pairs[live]).numel()
    nbytes = granules * cw * 4 + _nbytes(tids, ws, mask) + int(mask.sum()) * 4 + sel.numel() * c * 4
    return nbytes, 2.0 * int(live.sum()) * c


def doc_score_work(tids3, ws3, qdense, blk, mask):
    """The contract's own work: the live blocks (each distinct one read once),
    the 32-byte sectors of the dense query rows that their non-sentinel
    slots look up (each distinct one read once), the mask, the live pairs'
    block ids, the output written once; FMAs on live non-sentinel slots."""
    import torch

    _, b, t = tids3.shape
    vp = qdense.shape[1]
    live = blk[mask].long()
    blocks = torch.unique(live).numel()
    looked_up = tids3[live].reshape(live.numel(), b * t).long()  # [live pairs, b*T]
    slot = looked_up != vp - 1  # non-sentinel slots
    q_of = mask.nonzero()[:, 0][:, None].expand_as(looked_up)
    sectors = torch.unique((q_of * vp + looked_up)[slot] // 8).numel()  # 8 floats a sector
    nbytes = (blocks * b * t * (4 + ws3.element_size()) + sectors * 32 + _nbytes(mask)
              + live.numel() * 4 + blk.numel() * b * 4)
    return nbytes, 2.0 * int(slot.sum())


def doc_score_flat_work(tids, ws, doc_ends, qdense, blk, mask):
    """The contract's own work: each distinct live block's postings up to
    doc_ends[b-1] and its doc_ends row, read once; the 32-byte sectors of the
    dense query rows that the live pairs' postings look up (each distinct one
    read once); the mask, the live pairs' block ids, the output written once;
    FMAs on the live pairs' postings."""
    import torch

    b = doc_ends.shape[1]
    m = tids.shape[1]
    vp = qdense.shape[1]
    live = blk[mask].long()
    blocks = torch.unique(live)
    n_live = doc_ends[:, -1].long().clamp(0, m)  # postings before each block's padding
    looked_up = tids[live].long()  # [live pairs, m]
    posting = torch.arange(m, device=tids.device)[None, :] < n_live[live][:, None]
    q_of = mask.nonzero()[:, 0][:, None].expand_as(looked_up)
    sectors = torch.unique((q_of * vp + looked_up)[posting] // 8).numel()  # 8 floats a sector
    nbytes = (int(n_live[blocks].sum()) * (4 + ws.element_size()) + blocks.numel() * b * 4 + sectors * 32
              + _nbytes(mask) + live.numel() * 4 + blk.numel() * b * 4)
    return nbytes, 2.0 * int(posting.sum())


def every_selected(work):
    """The pre-mask contract's work: ``work`` with every selected block or
    superblock live (the mask is the last argument)."""

    def every(*args):
        import torch

        return work(*args[:-1], torch.ones_like(args[-1]))

    return every


def dequant_matmul_work(x, packed, bits):
    m, k = x.shape
    n = packed.shape[1] * (32 // bits)
    return _nbytes(x, packed) + m * n * 4, 2.0 * m * k * n


def small_kernel_checks(device):
    """Each kernel against its plain version at one small shape."""
    import torch

    from repro_torch.index.pack import pack_rows_strided
    from repro_torch.kernels.boundsum_gather.kernel import boundsum_gather_kernel
    from repro_torch.kernels.boundsum_gather.ref import boundsum_gather_ref
    from repro_torch.kernels.dequant_matmul.kernel import dequant_matmul_kernel
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
    from repro_torch.kernels.doc_score.kernel import doc_score_flat_kernel, doc_score_fwd_kernel
    from repro_torch.kernels.doc_score.ref import doc_score_flat_ref, doc_score_fwd_ref
    from repro_torch.kernels.sbmax.kernel import sbmax_kernel
    from repro_torch.kernels.sbmax.ref import sbmax_ref

    g = torch.Generator(device="cpu").manual_seed(0)

    def ints(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g).to(device, dtype)

    def floats(shape):
        return torch.rand(shape, generator=g).to(device)

    errs = {}
    for bits, granule in ((4, 128), (8, 128), (4, 2), (8, 4)):
        packed = pack_rows_strided(ints(1 << bits, (300, 4096), torch.uint8), bits, granule)
        tids, ws = ints(300, (3, 17)), floats((3, 17))
        ws[:, -1] = 0.0
        k_out = sbmax_kernel(packed, tids, ws, bits, granule)
        p_out = sbmax_ref(packed, tids, ws, bits, granule)
        torch.testing.assert_close(k_out, p_out, **TOL)
        errs[f"sbmax bits={bits} granule={granule}"] = float((k_out - p_out).abs().max())
    # sbmax at its call sites' widths (phase 1 and SBavg: 1,024 words at granule 128; bmp: 16,384 at
    # granule 2) on inputs that are the same in every run, so that the sha256 of the output's bits tells
    # whether two builds of the kernel give the same bits (the index, and with it every path's inputs,
    # differs between runs: the k-means uses atomics)
    gd = torch.Generator(device=device).manual_seed(0)
    for n_words, granule in ((1024, 128), (16384, 2)):
        packed = torch.randint(-2**31, 2**31 - 1, (4096, n_words), generator=gd, device=device, dtype=torch.int32)
        tids = torch.randint(0, 4096, (BATCH, 34), generator=gd, device=device, dtype=torch.int32)
        ws = torch.rand((BATCH, 34), generator=gd, device=device)
        ws[torch.rand((BATCH, 34), generator=gd, device=device) < 0.25] = 0.0  # pruned terms
        k_out = sbmax_kernel(packed, tids, ws, 4, granule)
        p_out = sbmax_ref(packed, tids, ws, 4, granule)
        torch.testing.assert_close(k_out, p_out, **TOL)
        errs[f"sbmax bits=4 granule={granule} W={n_words}"] = float((k_out - p_out).abs().max())
        digest = hashlib.sha256(k_out.view(torch.int32).cpu().numpy().tobytes()).hexdigest()[:16]
        log(f"sbmax at W = {n_words} words, granule {granule}, seeded inputs: sha256 of the output's bits {digest}")
    for bits, c in ((4, 16), (8, 4)):
        packed = pack_rows_strided(ints(1 << bits, (150, 30 * c), torch.uint8), bits, c * bits // 32)
        tids, ws, sel, sel_mask = ints(150, (2, 9)), floats((2, 9)), ints(30, (2, 40)), ints(2, (2, 40), torch.bool)
        k_out = boundsum_gather_kernel(packed, c, bits, tids, ws, sel, sel_mask)
        p_out = boundsum_gather_ref(packed, c, bits, tids, ws, sel, sel_mask)
        torch.testing.assert_close(k_out, p_out, **TOL)
        errs[f"boundsum_gather bits={bits} c={c}"] = float((k_out - p_out).abs().max())
    vocab = 300
    tids3 = ints(vocab + 1, (17, 4, 24))
    ws3 = ints(256, (17, 4, 24), torch.uint8)
    qdense = torch.randn((3, vocab + 1), generator=g).to(device)
    qdense[:, vocab] = 0.0
    blk = ints(17, (3, 9))
    mask = ints(2, (3, 9), torch.bool)
    k_out = doc_score_fwd_kernel(tids3, ws3, qdense, blk, mask)
    p_out = doc_score_fwd_ref(tids3, ws3, qdense, blk, mask)
    torch.testing.assert_close(k_out, p_out, **TOL)
    errs["doc_score_fwd"] = float((k_out - p_out).abs().max())
    for wdtype in (torch.uint8, torch.uint16):
        counts = torch.randint(0, 9, (17, 4), generator=g)
        doc_ends = torch.cumsum(counts, dim=1).to(device, torch.int32)  # runs of 0-8 postings
        live = torch.arange(40)[None, :] < doc_ends[:, -1:].cpu()
        tids = torch.where(live, torch.randint(0, vocab, (17, 40), generator=g), vocab).to(device, torch.int32)
        ws = torch.where(live, torch.randint(0, 1 << (8 * wdtype.itemsize), (17, 40), generator=g), 0)
        args = (tids, ws.to(torch.int32).to(device).to(wdtype), doc_ends, qdense, blk, mask)
        k_out = doc_score_flat_kernel(*args)
        p_out = doc_score_flat_ref(*args)
        torch.testing.assert_close(k_out, p_out, **TOL)
        errs[f"doc_score_flat weights={wdtype}"] = float((k_out - p_out).abs().max())
    for bits, dtype, m in ((4, torch.float32, 64), (8, torch.float32, 100), (4, torch.bfloat16, 3)):
        x = torch.randn((m, 300), generator=g).to(device, dtype)
        packed = pack_rows_strided(ints(1 << bits, (300, 32 // bits * 256), torch.uint8), bits, 128)
        k_out = dequant_matmul_kernel(x, packed, bits)
        p_out = dequant_matmul_ref(x, packed, bits)
        torch.testing.assert_close(k_out, p_out, rtol=1e-5, atol=1e-2)  # sums of 300 terms ~1e2
        errs[f"dequant_matmul bits={bits} x={dtype} M={m}"] = float((k_out - p_out).abs().max())
    return errs


def profile_call(label, fn):
    """Where one call's time goes: device kernels by name (CUPTI, through
    torch.profiler), their count, and the device's idle share of the call's
    wall time. ``fn`` must end in a device-to-host copy. Prints "not
    measured" if the profiler sees no device time (and returns None; else
    {kernels, busy_ms, wall_ms, idle})."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler saw no device time; device busy share not measured")
        return None
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:90]] += e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    log(f"profile of one {label} (profiler on): wall {wall_us / 1e3:.2f} ms, "
        f"{len(kernels)} device kernels, device busy {busy_us / 1e3:.3f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    for name, us in by_name.most_common(12):
        log(f"  {us / 1e3:8.4f} ms  {name}")
    cpu = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in cpu[:8]:
        log(f"  host {e.self_cpu_time_total / 1e3:8.3f} ms  {e.count:4d} x {e.key}")
    torch.cuda.synchronize()
    return {"kernels": len(kernels), "busy_ms": busy_us / 1e3, "wall_ms": wall_us / 1e3,
            "idle": 1 - busy_us / wall_us}


def recording(fn, calls):
    """``fn`` that also appends the arguments of every call to ``calls``."""

    def wrapper(*args):
        calls.append(args)
        return fn(*args)

    return wrapper


def capture(core_ops, names, run):
    """Run ``run()`` with the kernels ``names`` (keys of KERNELS) recording the
    arguments of each launch; returns {name: [args, ...]}."""
    calls = {name: [] for name in names}
    originals = {name: getattr(core_ops, KERNELS[name][0]) for name in names}
    for name, fn in originals.items():
        setattr(core_ops, KERNELS[name][0], recording(fn, calls[name]))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(core_ops, KERNELS[name][0], fn)
    return calls


def counted(core_ops, run, sites):
    """Run ``run()`` with every kernel's launch count set to 0 just before;
    returns (run's result, {name: launches during the run}, {sbmax call site:
    launches during the run}). ``sites`` maps the data pointer of each packed
    bound matrix to the call site that hands it to sbmax (SBMAX_SITES)."""
    fns = {name: getattr(core_ops, attr) for name, (attr, _, _) in KERNELS.items()}
    for fn in fns.values():
        fn.launches = 0
    out = []
    sbmax_calls = capture(core_ops, ["sbmax"], lambda: out.append(run()))["sbmax"]
    launches = {name: fn.launches for name, fn in fns.items()}
    by_site = {site: 0 for site in SBMAX_SITES}
    for args in sbmax_calls:
        by_site[sites[args[0].data_ptr()]] += 1
    check(sum(by_site.values()) == launches["sbmax"], "every sbmax launch has a call site")
    return out[0], launches, by_site


def host_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def path_phase(label, cfg, idx, batches, exact_ids, device, core_ops, sites, kernels, fwd_responses=None):
    """The same requests under ``cfg``: kernel path (counted) against
    impl="ref" on the card, ids and both counters of every query, against
    exact and, given ``fwd_responses``, against the fwd layout; times and
    profiles ``search_batch``. Returns (launches, sbmax launches by call site,
    captured calls of ``kernels``, each of which must launch)."""
    import numpy as np

    from repro_torch.api import Retriever
    from repro_torch.eval.metrics import recall_vs_oracle

    retr = Retriever.from_index(idx, cfg, device=device)
    captured = capture(core_ops, kernels, lambda: retr.search_batch(batches[0]))
    resp, launches, by_site = counted(core_ops, lambda: [r for b in batches for r in retr.search_batch(b)], sites)
    log(f"{label} ({cfg}): launches during the 4 search_batch calls: {launches}; sbmax by call site {by_site}")
    for key in kernels:
        check(launches[key] > 0, f"kernel {key} was never launched on the {label} path")
    ids = np.stack([r.doc_ids for r in resp])
    check(ids.shape == (N_QUERIES, K) and np.isfinite(np.stack([r.scores for r in resp])).all(),
          f"{label} result shape / finite scores")
    check(((ids >= 0) & (ids < N_DOCS)).all(), f"every {label} query returns k valid doc ids")
    ref = Retriever.from_index(idx, cfg, impl="ref", device=device)
    ref_resp = [r for b in batches for r in ref.search_batch(b)]
    same_counters = all(
        (a.n_superblocks_visited, a.n_blocks_scored) == (b.n_superblocks_visited, b.n_blocks_scored)
        for a, b in zip(resp, ref_resp)
    )
    ref_ids = np.stack([r.doc_ids for r in ref_resp])
    rec_ref = recall_vs_oracle(ids, ref_ids)
    rec_fwd = 1.0 if fwd_responses is None else recall_vs_oracle(ids, np.stack([r.doc_ids for r in fwd_responses]))
    log(f"{label} kernel path vs {label} impl='ref' ({N_QUERIES} queries): counters equal {same_counters}, "
        f"recall@10 {rec_ref:.4f}, ids identical {float((ids == ref_ids).mean()):.4f}"
        f"{'' if fwd_responses is None else f'; vs fwd recall@10 {rec_fwd:.4f}'}; recall@10 vs exact "
        f"{recall_vs_oracle(ids, exact_ids):.4f}; mean superblocks visited "
        f"{np.mean([r.n_superblocks_visited for r in resp]):.1f}, blocks scored "
        f"{np.mean([r.n_blocks_scored for r in resp]):.1f}")
    check(same_counters, f"{label} kernel and ref paths visit the same superblocks and blocks")
    check((ids == ref_ids).all(), f"{label} kernel and ref paths return the same ids for every query")
    check(rec_ref >= 0.99, f"recall@10 of the {label} kernel path against its ref path {rec_ref} < 0.99")
    check(rec_fwd >= 0.99, f"recall@10 of the {label} path against the fwd layout {rec_fwd} < 0.99")
    call_ms = [host_ms(lambda: retr.search_batch(b)) for _ in range(3) for b in batches]
    ref_ms = [host_ms(lambda: ref.search_batch(b)) for b in batches]
    log(f"search_batch of {BATCH}, {label}: median {statistics.median(call_ms):.2f} ms over {len(call_ms)} calls "
        f"(kernel path); impl='ref' median {statistics.median(ref_ms):.2f} ms")
    profile_call(f"{label} search_batch ({BATCH} requests)", lambda: retr.search_batch(batches[0]))
    return launches, by_site, captured


def _device_ops(fn):
    """The device operations the profiler sees in one ``fn()``, counted by
    name (kernels, and copies and sets under ``Memcpy``/``Memset`` names)."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name[:100] for e in prof.events() if e.device_type == DeviceType.CUDA)


def _n_kernels(ops_by_name):
    return sum(n for name, n in ops_by_name.items() if not name.startswith(("Memcpy", "Memset")))


def graphs_phase(idx, cfg, queries, device, core_ops):
    """The runner's CUDA graphs (``core.graphs``) against the eager traversal
    on the card: every variant, and lsp0 on the flat layout, at Q 1 and 64
    and three nq buckets (one exact, two padded), ids, scores, θ and both
    counters to the bit against ``search_retrieve`` at the bucket's width;
    one set captured a bucket, replayed after; each kernel's first-call
    arguments unchanged after ten more calls; the profiler's kernels a call
    on both paths; host ms a call on both."""
    import numpy as np
    import torch

    from repro_torch.core.config import DynamicParams, dynamic_args
    from repro_torch.core.graphs import nq_bucket
    from repro_torch.core.lsp import make_search_runner, search_retrieve
    from repro_torch.core.query import QueryBatch, make_query_batch

    def padded(qb, width):
        pad = width - qb.tids.shape[1]
        return QueryBatch(torch.nn.functional.pad(qb.tids, (0, pad), value=qb.vocab),
                          torch.nn.functional.pad(qb.ws, (0, pad)), qb.vocab)

    def same(got, want, what):
        for name in ("doc_ids", "scores", "theta", "n_superblocks_visited", "n_blocks_scored"):
            check(torch.equal(getattr(got, name), getattr(want, name)), f"graphs: {what}: {name} differs from eager")

    mixed = [DynamicParams(k=1 + (i * 3) % K, mu=(0.2, 0.5, 0.9)[i % 3], eta=(0.7, 1.0)[i % 2],
                           beta=(0.33, 0.6, 1.0)[i % 3]) for i in range(BATCH)]
    for variant, layout in [(v, "fwd") for v in ("lsp0", "lsp1", "lsp2", "sp", "bmp")] + [("lsp0", "flat")]:
        scfg = dataclasses.replace(cfg, variant=variant, doc_layout=layout)
        run = make_search_runner(idx, scfg)
        for q in (1, BATCH):
            for width in GRAPH_WIDTHS:
                qb = make_query_batch(queries[:q], VOCAB, nq_max=width, device=device)
                wide = padded(qb, nq_bucket(width))
                want = search_retrieve(idx, wide, scfg, dynamic_args(run.defaults, q, scfg.k_max, device))
                for call in ("capture", "replay", "replay again"):
                    same(run(qb), want, f"{variant} {layout} Q {q} nq {width} ({call})")
                if q == BATCH:
                    want = search_retrieve(idx, wide, scfg, dynamic_args(mixed, q, scfg.k_max, device))
                    same(run(qb, mixed), want, f"{variant} {layout} Q {q} nq {width} per-row params")
        sets = 2 * len(GRAPH_WIDTHS)
        stats = run.graph_stats()
        log(f"graphs {variant} {layout}: n_traces {run.n_traces()}, graph_stats {stats}")
        check(run.n_traces() == sets and stats == {"captures": sets, "replays": 2 * sets + len(GRAPH_WIDTHS),
                                                   "eager": 0}, f"graphs {variant}: one set a bucket, then replays")

    # the arguments a tracer keeps from a kernel's first call stay as they were
    run = make_search_runner(idx, cfg)
    qb = make_query_batch(queries[:BATCH], VOCAB, device=device)
    run(qb)  # capture
    kept = {}
    originals = {name: getattr(core_ops, KERNELS[name][0]) for name in ("sbmax", "boundsum_gather", "doc_score_fwd")}

    def keeping(name, fn):
        def wrapper(*args):
            if name not in kept:
                kept[name] = (args, [a.clone() if isinstance(a, torch.Tensor) else a for a in args])
            return fn(*args)
        return wrapper

    for name, fn in originals.items():
        setattr(core_ops, KERNELS[name][0], keeping(name, fn))
    try:
        for _ in range(11):
            run(qb)
        torch.cuda.synchronize(device)
    finally:
        for name, fn in originals.items():
            setattr(core_ops, KERNELS[name][0], fn)
    check(sorted(kept) == sorted(originals), f"graphs: kernels launched in the eleven calls {sorted(kept)}")
    for name, (args, copies) in kept.items():
        check(all(not isinstance(a, torch.Tensor) or torch.equal(a, c) for a, c in zip(args, copies)),
              f"graphs: an argument kept from {name}'s first call changed in ten more calls")
    log(f"graphs: the first call's arguments of {sorted(kept)} unchanged after ten more calls")

    # the profiler sees the kernels a graph launches; host time a call on both paths
    d = dynamic_args(run.defaults, BATCH, cfg.k_max, device)
    wide = padded(qb, nq_bucket(qb.tids.shape[1]))
    paths = {"graphs": lambda: run(qb), "eager": lambda: search_retrieve(idx, wide, cfg, d)}
    seen = {name: _device_ops(lambda: fn().doc_ids.cpu()) for name, fn in paths.items()}
    log(f"graphs: kernels (device operations) the profiler sees in one call of {BATCH}: "
        + ", ".join(f"{name} {_n_kernels(c)} ({sum(c.values())})" for name, c in seen.items()))
    log(f"  the graph path's device operations beyond the eager path's: {dict(seen['graphs'] - seen['eager'])}; "
        f"short of them: {dict(seen['eager'] - seen['graphs'])}")
    missing = {name: n for name, n in (seen["eager"] - seen["graphs"]).items()
               if not name.startswith(("Memcpy", "Memset"))}
    check(not missing, f"graphs: the profiler misses kernels a graph launches: {missing}")
    enqueue, call = {name: [] for name in paths}, {name: [] for name in paths}
    for _ in range(GRAPH_TIMED_CALLS):
        for name, fn in paths.items():
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize(device)
            enqueue[name].append((t1 - t0) * 1e3)
            call[name].append((time.perf_counter() - t0) * 1e3)
    for name in paths:
        log(f"graphs: {name} traversal of {BATCH}, host ms a call to return {np.median(enqueue[name]):.3f}, "
            f"to the device's end {np.median(call[name]):.3f} (medians of {GRAPH_TIMED_CALLS}, interleaved)")


def dense_phase(device, core_ops, sites):
    """Dense-embedding LSP at the recsys retrieval_cand size: build on the
    card, 256 query rows in four calls of 64 through the kernel path (counted),
    against impl="ref" and the exhaustive oracle. Returns (dequant_matmul
    launches, captured kernel calls)."""
    import numpy as np
    import torch

    from repro_torch.core.config import DynamicParams, StaticConfig, combine
    from repro_torch.core.lsp_dense import (
        DenseIndexConfig,
        build_dense_index,
        retrieve_dense,
        retrieve_dense_exact,
    )
    from repro_torch.eval.metrics import recall_vs_oracle
    from repro_torch.index.layout import index_nbytes

    rng = np.random.default_rng(0)
    centres = rng.standard_normal((N_CENTRES, DIM)).astype(np.float32)
    cands = (centres[rng.integers(0, N_CENTRES, N_CANDS)]
             + 0.25 * rng.standard_normal((N_CANDS, DIM))).astype(np.float32)
    rows = (centres[rng.integers(0, N_CENTRES, N_INTEREST_ROWS)]
            + 0.2 * rng.standard_normal((N_INTEREST_ROWS, DIM))).astype(np.float32)
    calls = [torch.from_numpy(rows[i: i + BATCH]).to(device) for i in range(0, N_INTEREST_ROWS, BATCH)]
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    didx = build_dense_index(cands, DenseIndexConfig(b=64, c=16, bits=4, kmeans_iters=4, ns_align=8),
                             device=device)
    torch.cuda.synchronize(device)
    log(f"dense index of {N_CANDS} x {DIM} built on the card in {time.perf_counter() - t0:.1f} s: "
        f"{didx.n_blocks} blocks, {didx.n_superblocks} superblocks; index holds "
        f"{index_nbytes(didx) / 1e9:.3f} GB on the card; build peak "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    cfg = combine(StaticConfig(variant="lsp0", gamma=max(8, didx.n_superblocks // 8), gamma0=4, k_max=K),
                  DynamicParams(k=K))
    log(f"dense config: {cfg}")

    def run(impl):
        return np.concatenate([retrieve_dense(didx, q, cfg, impl=impl)[0].cpu().numpy() for q in calls])

    captured = capture(core_ops, ["dequant_matmul"], lambda: retrieve_dense(didx, calls[0], cfg))
    ids, launches, _ = counted(core_ops, lambda: run("auto"), sites)
    log(f"dense: launches during the 4 retrieve_dense calls: {launches}")
    check(launches["dequant_matmul"] > 0, "kernel dequant_matmul was never launched on the dense path")
    check(ids.shape == (N_INTEREST_ROWS, K) and ((ids >= 0) & (ids < N_CANDS)).all(),
          "every dense query returns k valid candidate ids")
    rec_ref = recall_vs_oracle(ids, run("ref"))
    exact_ids = np.concatenate([retrieve_dense_exact(didx, q, K)[0].cpu().numpy() for q in calls])
    log(f"dense kernel path vs impl='ref': recall@10 {rec_ref:.4f}; recall@10 vs exhaustive "
        f"{recall_vs_oracle(ids, exact_ids):.4f}")
    check(rec_ref >= 0.99, f"recall@10 of the dense kernel path against the ref path {rec_ref} < 0.99")
    call_ms = [host_ms(lambda: retrieve_dense(didx, q, cfg)[0].cpu()) for _ in range(3) for q in calls]
    ref_ms = [host_ms(lambda: retrieve_dense(didx, q, cfg, impl="ref")[0].cpu()) for q in calls]
    exact_ms = [host_ms(lambda: retrieve_dense_exact(didx, q, K)[0].cpu()) for q in calls]
    log(f"retrieve_dense of {BATCH} rows: median {statistics.median(call_ms):.2f} ms over {len(call_ms)} calls "
        f"(kernel path); impl='ref' median {statistics.median(ref_ms):.2f} ms; exhaustive median "
        f"{statistics.median(exact_ms):.2f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    profile_call(f"retrieve_dense ({BATCH} rows)", lambda: retrieve_dense(didx, calls[0], cfg)[0].cpu())
    profile_call(f"retrieve_dense_exact ({BATCH} rows)", lambda: retrieve_dense_exact(didx, calls[0], K)[0].cpu())
    sharded = sharded_dense(didx, cfg, calls, ids, exact_ids, core_ops, sites)
    return launches["dequant_matmul"], captured, sharded


def sharded_dense(didx, cfg, calls, single_ids, exact_ids, core_ops, sites):
    """The dense index cut into DENSE_SHARDS shards, through the host loop of
    ``make_sharded_dense_retriever`` at the single-device config (each shard
    takes its own top-γ): dequant_matmul on every shard, recall@10 against
    the single-device kernel path (at least 0.9, the JAX package's bar) and
    against the exhaustive oracle. Returns (launches, the dequant_matmul
    calls of the first call)."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.core.lsp_dense import make_sharded_dense_retriever, retrieve_dense, shard_dense_index
    from repro_torch.eval.metrics import recall_vs_oracle

    t0 = time.perf_counter()
    shards = shard_dense_index(didx, DENSE_SHARDS)
    torch.cuda.synchronize()
    cut_s = time.perf_counter() - t0
    owner = {t.data_ptr(): p for p, s in enumerate(shards) for t in (s.sb.max_packed, s.sb.min_packed)}
    run = make_sharded_dense_retriever(shards, cfg)
    run(calls[0])
    holder = {}

    def all_calls():
        out = []
        holder["calls"] = capture(core_ops, ["dequant_matmul"], lambda: out.extend(run(q)[0].cpu().numpy()
                                                                                  for q in calls))
        return np.concatenate(out)

    ids, launches, _ = counted(core_ops, all_calls, sites)
    by_shard = Counter(owner[args[1].data_ptr()] for args in holder["calls"]["dequant_matmul"])
    check(sorted(by_shard) == list(range(DENSE_SHARDS)), f"dequant_matmul on every dense shard: {dict(by_shard)}")
    check(ids.shape == single_ids.shape and ((ids >= 0) & (ids < N_CANDS)).all(), "sharded dense ids")
    rec = recall_vs_oracle(ids, single_ids)
    log(f"sharded dense ({DENSE_SHARDS} shards of {shards[0].n_superblocks} superblocks, cut in {cut_s:.2f} s): "
        f"launches during the 4 calls {launches}, dequant_matmul by shard {dict(sorted(by_shard.items()))}; "
        f"recall@10 vs the single-device kernel path {rec:.4f}, vs exhaustive {recall_vs_oracle(ids, exact_ids):.4f}")
    check(rec >= 0.9, f"recall@10 of sharded dense against single-device {rec} < 0.9")
    single_ms = [host_ms(lambda: retrieve_dense(didx, q, cfg)[0].cpu()) for q in calls]
    sharded_ms = [host_ms(lambda: run(q)[0].cpu()) for q in calls]
    log(f"dense of {BATCH} rows: sharded host loop median {statistics.median(sharded_ms):.2f} ms, single "
        f"{statistics.median(single_ms):.2f} ms")
    return launches["dequant_matmul"], holder["calls"]["dequant_matmul"][: 2 * DENSE_SHARDS]


def _same_response(got, want, what):
    """Equal ids and both counters, scores and θ within 1e-5."""
    import numpy as np

    check((got.doc_ids == want.doc_ids).all(), f"{what}: ids differ")
    check((got.n_superblocks_visited, got.n_blocks_scored) == (want.n_superblocks_visited, want.n_blocks_scored),
          f"{what}: counters differ")
    check(np.allclose(got.scores, want.scores, **ENGINE_TOL), f"{what}: scores differ")
    check(np.allclose(got.theta, want.theta, **ENGINE_TOL), f"{what}: theta differs")


def _submit_all(engine, requests, n_threads):
    """Every request through ``engine.search`` from ``n_threads`` client
    threads, each waiting for one response before it sends its next request
    (a closed loop). Returns (responses or exceptions in request order,
    latency ms of each)."""
    import threading

    out = [None] * len(requests)
    lat = [0.0] * len(requests)

    def client(first):
        for i in range(first, len(requests), n_threads):
            t0 = time.perf_counter()
            fut = engine.search(requests[i])
            exc = fut.exception(timeout=120)
            out[i] = exc if exc is not None else fut.result()
            lat[i] = (time.perf_counter() - t0) * 1e3
    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "a client thread of the engine phase hung")
    return out, lat


def engine_phase(retr, ref, requests, responses, device, core_ops, sites, tmp):
    """The serving engine over the index of the main path (lsp0, fwd):
    warm-up on every bucket, 256 requests from 8 client threads against
    ``search_batch`` (launches counted), closed-loop latency at 1 and 64
    client threads, the result cache, ``save`` (into ``tmp``) + ``swap_index``
    from disk, chaos faults, and requests with out-of-range term ids. Returns
    (the launches of the correctness pass, the saved directory)."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.api import SearchRequest
    from repro_torch.index.store import load_index, read_manifest
    from repro_torch.serve import ChaosConfig, ChaosFault, ChaosInjector

    longest = max(len(r.tids) for r in requests)
    check(longest <= ENGINE_NQ, f"the longest query ({longest} terms) must fit the engine's nq_max {ENGINE_NQ}")

    def new_engine(**knobs):
        engine = retr.serve(max_batch=BATCH, nq_max=ENGINE_NQ, **knobs)
        t0 = time.perf_counter()
        engine.warmup()
        return engine, time.perf_counter() - t0

    engine, warm_s = new_engine(cache_size=0)
    try:
        log(f"engine: {len(engine.ladder.shapes())} buckets ({engine.ladder}), warm-up {warm_s:.2f} s")
        got, launches, _ = counted(core_ops, lambda: _submit_all(engine, requests, 8)[0], sites)
        log(f"engine: launches during {len(requests)} requests from 8 client threads: {launches}")
        for key in ("sbmax", "boundsum_gather", "doc_score_fwd"):
            check(launches[key] > 0, f"kernel {key} was never launched on the engine path")
        for i, (g, w) in enumerate(zip(got, responses)):
            check(not isinstance(g, BaseException), f"engine request {i} failed: {g!r}")
            _same_response(g, w, f"engine request {i} vs search_batch")
        log(f"engine == search_batch on ids, both counters, scores and theta (rtol/atol 1e-5) for all "
            f"{len(requests)} requests; {engine.stats.summary()['bucket_batches']}")

        # ---- closed-loop latency, 4 passes of the 256 requests
        for n_threads in (1, BATCH):
            load_engine, _ = new_engine(cache_size=0)
            try:
                lat = []
                for _ in range(4):
                    out, pass_lat = _submit_all(load_engine, requests, n_threads)
                    check(not any(isinstance(o, BaseException) for o in out), "a request failed under load")
                    lat += pass_lat
                summ = load_engine.stats.summary()
            finally:
                load_engine.shutdown()
            log(f"engine closed loop, {n_threads} client thread(s), {len(lat)} requests: p50 "
                f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms (client clock); engine's "
                f"own p50 {summ['p50_ms']:.3f} ms, p99 {summ['p99_ms']:.3f} ms; batches per bucket "
                f"{summ['bucket_batches']}")

        # ---- chaos: every third batch fails; every future resolves exactly once
        before = engine.stats.summary()["failures"]
        engine.set_chaos(ChaosInjector(ChaosConfig(fault_every=3)))
        resolved = Counter()
        futs = [engine.search(r) for r in requests]
        for f in futs:
            f.add_done_callback(lambda fu: resolved.update([id(fu)]))
        excs = [f.exception(timeout=120) for f in futs]
        engine.set_chaos(None)
        failed = sum(e is not None for e in excs)
        check(all(e is None or isinstance(e, ChaosFault) for e in excs), "only injected faults fail requests")
        check(len(resolved) == len(futs) and set(resolved.values()) == {1}, "every future resolves exactly once")
        check(failed == engine.stats.summary()["failures"] - before, "failed futures == stats.failures")
        check(0 < failed < len(futs), f"chaos failed {failed} of {len(futs)} requests")
        for i, (f, e) in enumerate(zip(futs, excs)):
            if e is None:
                _same_response(f.result(), responses[i], f"request {i} beside chaos faults")
        log(f"engine under ChaosConfig(fault_every=3): {failed} of {len(futs)} requests failed, each counted in "
            f"stats.failures; the other {len(futs) - failed} equal search_batch")

        # ---- out-of-range term ids: served, equal impl="ref", and the engine serves on
        vocab = retr.vocab
        bad = [SearchRequest(np.concatenate([r.tids, [vocab + 3, -1, -(vocab + 5)]]),
                             np.concatenate([r.weights, [0.7, 0.9, 1.1]])) for r in requests[:BATCH]]
        out, _ = _submit_all(engine, bad, 8)
        want = ref.search_batch(bad)
        for i, (g, w) in enumerate(zip(out, want)):
            check(not isinstance(g, BaseException), f"out-of-range request {i} failed: {g!r}")
            _same_response(g, w, f"out-of-range request {i} vs impl='ref'")
        out, _ = _submit_all(engine, requests, 8)
        for i, (g, w) in enumerate(zip(out, responses)):
            check(not isinstance(g, BaseException), f"request {i} after the out-of-range ones failed: {g!r}")
            _same_response(g, w, f"request {i} after the out-of-range ones")
        torch.cuda.synchronize(device)
        log(f"engine: {len(bad)} requests with term ids {vocab + 3}, -1, {-(vocab + 5)} served, equal to "
            f"impl='ref'; the {len(requests)} requests after them equal search_batch (the CUDA context is intact)")
    finally:
        engine.shutdown()

    # ---- the result cache, then swap_index from a directory the port wrote
    cached, _ = new_engine(cache_size=1024)
    try:
        first, _ = _submit_all(cached, requests, 8)
        again, _ = _submit_all(cached, requests, 8)
        for i, (a, b) in enumerate(zip(first, again)):
            check(b.cache_hit and not a.cache_hit, f"request {i}: a repeat is a cache hit")
            _same_response(b, a, f"cached request {i}")
        log(f"engine cache_size=1024: the repeat of {len(requests)} requests all hits; "
            f"hit rate {cached.stats.summary()['cache_hit_rate']:.3f}")
        path = os.path.join(tmp, "index")
        free_gb = shutil.disk_usage(tmp).free / 1e9
        t0 = time.perf_counter()
        fp = retr.save(path)
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        log(f"Retriever.save: {written / 1e9:.3f} GB written in {save_s:.2f} s ({free_gb:.0f} GB were free there); "
            f"fingerprint {fp}")
        t0 = time.perf_counter()
        epoch = cached.swap_index(path)
        swap_s = time.perf_counter() - t0
        check(epoch == 1 and cached.epoch == 1, "swap_index bumps the epoch to 1")
        after, _ = _submit_all(cached, requests, 8)
        for i, (a, b) in enumerate(zip(first, after)):
            check(not b.cache_hit and b.epoch == 1, f"request {i}: after the swap the cache misses, epoch 1")
            _same_response(b, a, f"request {i} after swap_index")
        last_swap_s = cached.stats.summary()["last_swap_ms"] / 1e3
        log(f"swap_index from disk: {swap_s:.2f} s in all: load onto the card {swap_s - last_swap_s:.2f} s, "
            f"backend build + warm-up of every bucket + flip {last_swap_s:.2f} s; epoch 1, every request a cache "
            f"miss and equal to the responses before the swap")
        t0 = time.perf_counter()
        loaded = load_index(path, verify=True, device=device)
        verify_s = time.perf_counter() - t0
        check(read_manifest(path)["fingerprint"] == fp, "the manifest holds the saved fingerprint")
        check(loaded.n_docs == retr.index.n_docs, "the verified index holds every document")
        del loaded
        log(f"load_index(verify=True): fingerprint {fp} re-hashed and equal, {verify_s:.2f} s")
    finally:
        cached.shutdown()
    torch.cuda.empty_cache()
    return launches, path


def _pinned_ref(retr):
    """An adapter over ``retr``'s current mutable state whose main runtime is
    impl="ref": both paths read the same delta, tombstones and generation."""
    import types

    from repro_torch.api import Retriever
    from repro_torch.serve import MutableRetrieverAdapter

    view = retr.index.state()
    ref_rt = Retriever.from_index(view.main, retr.static_cfg, impl="ref", params=retr.defaults,
                                  device=retr.device)._backend
    pinned = types.SimpleNamespace(state=lambda: view._replace(runtime=ref_rt), vocab=retr.vocab, device=retr.device)
    return MutableRetrieverAdapter(pinned, None)


def _through(retr, backend, batches):
    """``search_batch`` of every batch through ``backend`` in place of ``retr``'s own."""
    own = retr._backend
    retr._backend = backend
    try:
        return [r for b in batches for r in retr.search_batch(b)]
    finally:
        retr._backend = own


def mutable_search_check(label, retr, batches, deleted, core_ops, sites):
    """The promoted retriever's kernel path (counted) against impl="ref" on the
    same mutable state: ids and both counters of every query, scores and θ
    within ENGINE_TOL; no deleted id; no saturated row. Returns (responses,
    launches)."""
    import numpy as np

    from repro_torch.core.query import make_query_batch

    main = retr.index.state().main  # a compaction's generation hands sbmax matrices of its own
    sites = {**sites, **{getattr(main, attr).packed.data_ptr(): site for site, attr in SBMAX_SITES.items()
                         if getattr(main, attr) is not None}}
    got, launches, by_site = counted(core_ops, lambda: [r for b in batches for r in retr.search_batch(b)], sites)
    log(f"mutable, {label}: launches during the {len(batches)} search_batch calls: {launches}; sbmax by call site "
        f"{by_site}")
    for key in ("sbmax", "boundsum_gather", "doc_score_fwd"):
        check(launches[key] > 0, f"kernel {key} was never launched on the mutable path ({label})")
    want = _through(retr, _pinned_ref(retr), batches)
    for i, (g, w) in enumerate(zip(got, want)):
        _same_response(g, w, f"mutable {label}, query {i}: kernel vs impl='ref'")
    ids = np.stack([r.doc_ids for r in got])
    check(ids.shape == (N_QUERIES, K) and np.isfinite(np.stack([r.scores for r in got])).all(),
          f"mutable {label}: result shape / finite scores")
    check(not np.isin(ids, np.asarray(sorted(deleted), np.int64)).any(), f"mutable {label}: a deleted id surfaced")
    saturated = 0
    for b in batches:
        qb = make_query_batch([(r.tids, r.weights) for r in b], retr.vocab, nq_max=max(len(r.tids) for r in b),
                              device=retr.device)
        saturated += retr._adapter(qb, [retr.defaults] * len(b)).overfetch_saturated
    check(saturated == 0, f"mutable {label}: {saturated} rows saturated the tombstone overfetch")
    log(f"mutable, {label}: kernel path == impl='ref' on ids and both counters of all {len(got)} queries, scores "
        f"and theta within 1e-5; no deleted id among the results; overfetch_saturated 0; mean superblocks visited "
        f"{np.mean([r.n_superblocks_visited for r in got]):.1f}, blocks scored "
        f"{np.mean([r.n_blocks_scored for r in got]):.1f}")
    return got, launches


def mutable_split(label, retr, batch, device):
    """search_batch of one batch on the host clock, and its three parts: the main
    traversal (device events; host clock too), score_delta_docs and
    merge_mutable_topk (host clock), each a median of 8."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.exact import score_delta_docs
    from repro_torch.core.merge import merge_mutable_topk
    from repro_torch.core.query import make_query_batch

    view = retr.index.state()
    total = statistics.median([host_ms(lambda: retr.search_batch(batch)) for _ in range(8)])
    qb = make_query_batch([(r.tids, r.weights) for r in batch], retr.vocab, nq_max=max(len(r.tids) for r in batch),
                          device=device)
    n_tomb = int(view.tombstones.size)
    eff = [dataclasses.replace(retr.defaults, k=min(retr.defaults.k + n_tomb, retr.static_cfg.k_max))] * len(batch)
    dev_ms, main_ms = [], []
    for _ in range(8):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = view.runtime(qb, eff)
        end.record()
        ids = out.doc_ids.cpu().numpy()
        main_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    q_tids, q_ws = qb.tids.cpu().numpy(), qb.ws.cpu().numpy()
    delta_ms = statistics.median([host_ms(lambda: score_delta_docs(q_tids, q_ws, view.delta_tids, view.delta_ws,
                                                                      retr.vocab)) for _ in range(8)])
    d_scores = score_delta_docs(q_tids, q_ws, view.delta_tids, view.delta_ws, retr.vocab)
    d_ids = view.delta_ids.copy()
    m_ids = np.where(ids >= 0, view.ext_ids[np.clip(ids, 0, None)], -1)
    args = (m_ids, out.scores.cpu().numpy(), d_ids, d_scores, np.full(len(batch), retr.defaults.k),
            retr.static_cfg.k_max, out.theta.cpu().numpy())
    merge_ms = statistics.median([host_ms(lambda: merge_mutable_topk(*args)) for _ in range(8)])
    log(f"mutable search_batch of {len(batch)}, {label} ({view.delta_ids.size} delta docs x "
        f"{view.delta_tids.shape[1]} padded terms, {n_tomb} tombstones): {total:.2f} ms (host clock, median of 8); "
        f"main traversal at k_eff {eff[0].k}: device {statistics.median(dev_ms):.3f} ms (events), host "
        f"{statistics.median(main_ms):.2f} ms; score_delta_docs {delta_ms:.2f} ms; merge_mutable_topk "
        f"{merge_ms:.2f} ms (host clock)")
    profile_call(f"mutable search_batch ({len(batch)} requests, {label})", lambda: retr.search_batch(batch))
    return total


def _audit(responses, added_at, deleted_at):
    """The flip audit of benchmarks/freshness_suite.py: (stale, lost) over
    ``responses`` of the probe query, each judged at its delta_seq."""
    stale = lost = 0
    for resp in responses:
        got = {int(d) for d in resp.doc_ids if d >= 0}
        stale += sum(resp.delta_seq >= seq and doc in got for doc, seq in deleted_at.items())
        live = [d for d, s in added_at.items()
                if resp.delta_seq >= s and (d not in deleted_at or resp.delta_seq < deleted_at[d])]
        lost += bool(live) and not (set(live) & got)
    return stale, lost


def freshness_engine(retr, requests, queries, device):
    """``Retriever.serve`` with a CompactionManager over the promoted 1M-doc
    retriever: reads before any write, 32 dominating adds each visible at rank
    0 on the very next search, then a 90/10 read/write mix until a background
    compaction has flipped, every probe response audited by its delta_seq."""
    import numpy as np
    import torch

    from repro_torch.api import SearchRequest

    engine = retr.serve(max_batch=BATCH, nq_max=ENGINE_NQ,
                        compaction=dict(max_delta_docs=MUT_ADDS, max_tombstones=MUT_DELETES, interval_s=0.05))
    compactor = engine._compactor
    adapter = retr._adapter
    try:
        engine.warmup()

        def read(req):
            t0 = time.perf_counter()
            resp = engine.search(req).result(timeout=600)
            return resp, (time.perf_counter() - t0) * 1e3

        before = [read(r)[1] for r in requests]

        lags = []
        for i in range(N_VISIBLE):
            qt, qw = queries[i]
            t0 = time.perf_counter()
            (doc_id,), _ = engine.add_docs([(qt, np.full(qt.shape, 100.0, np.float32))])
            resp, _ = read(SearchRequest(qt, qw))
            lags.append((time.perf_counter() - t0) * 1e3)
            check(int(resp.doc_ids[0]) == doc_id, f"added doc {doc_id} is not at rank 0 on the very next search")
            engine.delete_docs([doc_id])  # restore the baseline ranking
        log(f"mutable engine: {N_VISIBLE} dominating docs added one at a time, each at rank 0 on the very next "
            f"search; add -> visible lag p50 {np.percentile(lags, 50):.3f} ms, p99 {np.percentile(lags, 99):.3f} "
            f"ms, max {max(lags):.3f} ms (host clock, 1 client)")

        # out-of-range term ids with a delta to score: served, equal impl="ref", and the engine serves on
        vocab = retr.vocab
        bad = [SearchRequest(np.concatenate([r.tids, [vocab + 3, -1, -(vocab + 5)]]),
                             np.concatenate([r.weights, [0.7, 0.9, 1.1]])) for r in requests[:8]]
        want = _through(retr, _pinned_ref(retr), [bad])
        for i, (r, w) in enumerate(zip(bad, want)):
            _same_response(read(r)[0], w, f"mutable engine, out-of-range request {i} vs impl='ref'")
        check(engine.stats.summary()["failures"] == 0, "out-of-range requests fail nothing")
        log(f"mutable engine: {len(bad)} requests with term ids {vocab + 3}, -1, {-(vocab + 5)} beside "
            f"{retr._adapter.pressure()['delta_docs']} delta docs served, equal to impl='ref'")

        rng = np.random.default_rng(7)
        probe = SearchRequest(*queries[1])
        dominating = (queries[1][0], np.full(queries[1][0].shape, 100.0, np.float32))
        added_at, deleted_at, pool, audited = {}, {}, [], []
        lat = {"under writes": [], "across the flip": [], "after the flip": []}
        writes = ops = 0
        peak_tomb = 0
        t_mix = time.perf_counter()
        flips = engine.stats.summary()["compactions"]
        while True:
            done = engine.stats.compactions - flips
            if done >= 1 and len(lat["after the flip"]) >= MIX_AFTER_FLIP:
                break
            check(time.perf_counter() - t_mix < MIX_LIMIT_S, "the 90/10 mix forced no compaction flip in time")
            ops += 1
            if rng.random() < 0.10:
                writes += 1
                if pool and rng.random() < 0.4:
                    doc = pool.pop()
                    deleted_at[doc] = engine.delete_docs([doc])
                else:
                    n = int(rng.integers(3, 9))
                    filler = (rng.choice(retr.vocab, n, replace=False).astype(np.int32),
                              rng.uniform(0.1, 2.0, n).astype(np.float32))
                    ids, seq = engine.add_docs([dominating, filler])
                    added_at[ids[0]] = seq
                    pool.append(ids[0])
                continue
            pending = adapter.needs_compaction(MUT_ADDS, MUT_DELETES)
            peak_tomb = max(peak_tomb, adapter.pressure()["tombstones"])
            arm = "after the flip" if done else ("across the flip" if pending else "under writes")
            is_probe = rng.random() < 0.25
            resp, ms = read(probe if is_probe else requests[int(rng.integers(0, len(requests)))])
            lat[arm].append(ms)
            if is_probe:
                audited.append(resp)
        # let a compaction still in flight land before the final audit read
        deadline = time.perf_counter() + MIX_LIMIT_S
        while adapter.needs_compaction(MUT_ADDS, MUT_DELETES) and time.perf_counter() < deadline:
            time.sleep(0.05)
        audited.append(read(probe)[0])
        stale, lost = _audit(audited, added_at, deleted_at)
        s = engine.stats.summary()
        pct = {arm: (f"p50 {np.percentile(v, 50):.3f} ms, p99 {np.percentile(v, 99):.3f} ms over {len(v)} reads"
                     if v else "no reads") for arm, v in [("before any write", before), *lat.items()]}
        log(f"mutable engine 90/10 mix: {ops} ops ({writes} writes) in {time.perf_counter() - t_mix:.1f} s; reads "
            f"(host clock, 1 client): " + "; ".join(f"{a}: {p}" for a, p in pct.items()))
        log(f"mutable engine: compactions {s['compactions']}, compaction_failures {s['compaction_failures']}, last "
            f"compaction {s['last_compaction_ms'] / 1e3:.2f} s (build + warm-up of {len(engine.ladder.shapes())} "
            f"buckets + flip), epoch {engine.epoch}; adds {s['adds']}, deletes {s['deletes']}; tombstones peaked at "
            f"{peak_tomb} (k_max - k = {retr.static_cfg.k_max - K}); overfetch_saturated {s['overfetch_saturated']} "
            f"rows; flip audit of {len(audited)} probe responses: stale {stale}, lost {lost}")
        check(s["compactions"] >= 1 and s["compaction_failures"] == 0, "a clean background compaction flip")
        check(stale == 0 and lost == 0, f"flip audit: {stale} stale, {lost} lost")
        check(s["failures"] == 0, "no request failed in the mutable engine")
    finally:
        engine.shutdown()
        compactor._thread.join(timeout=MIX_LIMIT_S)
        check(not compactor._thread.is_alive(), "the compaction thread ended")
    torch.cuda.synchronize(device)


def mutable_phase(idx, corpus, queries, requests, device, core_ops, sites, single_dir, tmp):
    """The live mutable index at full width over the main path's index (no
    second build): promotion, 1,024 adds and 48 deletes, the kernel path
    against impl="ref" with the delta and tombstones and again after a
    synchronous compaction (recall against exact over the logical corpus),
    freshness through the engine with background compaction, the mutable
    save and load, and the promotion of a loaded single index (corpus_from_index).
    Returns the launches of the first search pass."""

    import numpy as np
    import torch

    from repro_torch.api import DynamicParams, Retriever, SearchRequest
    from repro_torch.core.config import recommended_static
    from repro_torch.data.synthetic import CorpusConfig, make_corpus
    from repro_torch.eval.metrics import recall_vs_oracle
    from repro_torch.index import mutable
    from repro_torch.index.builder import IndexBuildConfig
    from repro_torch.index.layout import index_nbytes

    batches = [requests[i: i + BATCH] for i in range(0, len(requests), BATCH)]
    scfg = recommended_static(MUT_K_MAX, idx.n_superblocks)
    retr = Retriever.from_index(idx, scfg, params=DynamicParams(k=K), device=device)
    retr._corpus = (corpus.doc_ptr, corpus.tids, corpus.ws)  # the source corpus, as Retriever.build keeps it
    retr._build_cfg = IndexBuildConfig()
    t0 = time.perf_counter()
    retr.mutable()
    log(f"mutable: promoted the {N_DOCS}-doc retriever in {time.perf_counter() - t0:.2f} s ({scfg}, k {K})")
    mutable_split("empty delta", retr, batches[0], device)

    # ---- writes: 1,024 docs from another seed, 48 deletes (some in the current top-10)
    extra = make_corpus(CorpusConfig(n_docs=MUT_ADDS, vocab=VOCAB, n_topics=N_TOPICS, seed=2))
    docs = [(extra.tids[extra.doc_ptr[i]: extra.doc_ptr[i + 1]], extra.ws[extra.doc_ptr[i]: extra.doc_ptr[i + 1]])
            for i in range(MUT_ADDS)]
    t0 = time.perf_counter()
    added = retr.add(docs)
    add_s = time.perf_counter() - t0
    check(added == list(range(N_DOCS, N_DOCS + MUT_ADDS)), "added docs get the next external ids")
    top = [int(r.doc_ids[0]) for r in retr.search_batch(batches[0])]
    in_top = list(dict.fromkeys(top))[:24]
    check(len(in_top) >= 10, "at least 10 deletes are ids in the current top-10")
    rng = np.random.default_rng(3)
    others = [int(i) for i in rng.choice(N_DOCS, 64, replace=False) if int(i) not in in_top][:12]
    deleted = in_top + others + [a for a in added if a not in in_top][: MUT_DELETES - len(in_top) - len(others)]
    check(len(set(deleted)) == MUT_DELETES, "48 distinct deletes")
    retr.delete(deleted)
    log(f"mutable: {MUT_ADDS} docs added in {add_s * 1e3:.1f} ms; {MUT_DELETES} deleted ({len(in_top)} of them the "
        f"current rank-0 ids of probe queries, {len(others)} other main docs, the rest added docs); "
        f"pressure {retr._adapter.pressure()}")

    # ---- searches: kernel vs ref with the delta and tombstones
    resp, launches = mutable_search_check("1,024 delta docs + 48 tombstones", retr, batches, deleted, core_ops, sites)
    mutable_split("1,024 delta docs + 48 tombstones", retr, batches[0], device)

    # ---- a synchronous compaction, timed by stage
    stage = {}

    def timed(name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize(device)
            stage[name] = stage.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    adapter = retr._adapter
    factory = adapter._runtime_factory

    def timed_factory(ix):
        runtime = factory(ix)
        runtime.warmup = timed("warm-up", runtime.warmup)
        return runtime

    originals = (mutable._live_csr, mutable.build_index)
    mutable._live_csr, mutable.build_index = timed("_live_csr", mutable._live_csr), timed("build", mutable.build_index)
    adapter._runtime_factory = timed_factory
    torch.cuda.reset_peak_memory_stats(device)
    base_gb = torch.cuda.memory_allocated(device) / 1e9
    try:
        t0 = time.perf_counter()
        adapter.compact(warm_shapes=[(b, q) for b in (1, 4, 16, 64) for q in (16, ENGINE_NQ)])
        compact_s = time.perf_counter() - t0
    finally:
        mutable._live_csr, mutable.build_index = originals
        adapter._runtime_factory = factory
    view = retr.index.state()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"mutable compact(): {compact_s:.2f} s in all: _live_csr {stage['_live_csr']:.2f} s, build on the card "
        f"{stage['build']:.2f} s, warm-up of 8 buckets {stage['warm-up']:.2f} s, backend + commit "
        f"{compact_s - sum(stage.values()):.2f} s; peak device memory {peak_gb:.2f} GB ({base_gb:.2f} GB before); "
        f"generation {view.generation}, {view.main.n_docs} live docs, new index {index_nbytes(view.main) / 1e9:.3f} GB")
    check(view.generation == 1 and view.delta_ids.size == 0 and view.tombstones.size == 0, "compaction folded all")
    check(view.main.n_docs == N_DOCS + MUT_ADDS - MUT_DELETES, "the compacted generation holds every live doc")
    mutable_search_check("compacted", retr, batches, deleted, core_ops, sites)
    mutable_split("compacted", retr, batches[0], device)
    got = np.stack([r.doc_ids for b in batches for r in retr.search_batch(b)])
    exact = Retriever.from_index(view.main, scfg, backend="exact", params=DynamicParams(k=K), device=device)
    ex = np.stack([r.doc_ids for b in batches for r in exact.search_batch(b)])
    ex = np.where(ex >= 0, view.ext_ids[np.clip(ex, 0, None)], -1)
    rec = recall_vs_oracle(got, ex)
    log(f"mutable, compacted generation: recall@10 vs exact over the logical corpus {rec:.4f}")
    check(rec >= 0.90, f"recall@10 of the compacted generation {rec} < 0.90")
    del exact

    # ---- freshness through the engine, with background compaction
    freshness_engine(retr, requests, queries, device)

    # ---- the mutable store: save, load, resume
    extra_ids = retr.add(docs[:8])
    retr.delete(extra_ids[:2] + [int(retr.index.state().ext_ids[5])])
    path = os.path.join(tmp, "mutable")
    t0 = time.perf_counter()
    fp = retr.save(path)
    save_s = time.perf_counter() - t0
    written = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    t0 = time.perf_counter()
    loaded = Retriever.load(path, scfg, params=DynamicParams(k=K), device=device)
    load_s = time.perf_counter() - t0
    check(loaded._adapter.pressure() == retr._adapter.pressure(), "the delta, tombstones and seq come back")
    before = [r for b in batches for r in retr.search_batch(b)]
    for i, (a, b) in enumerate(zip([r for b in batches for r in loaded.search_batch(b)], before)):
        _same_response(a, b, f"mutable reload, query {i}")
    next_id = loaded.add(docs[8:9])
    check(next_id == retr.add(docs[8:9]), "the next add gets the next id after a reload")
    log(f"mutable Retriever.save: {written / 1e9:.3f} GB in {save_s:.2f} s (fingerprint {fp}); Retriever.load "
        f"{load_s:.2f} s (page-cached); pressure {loaded._adapter.pressure()} equal; the {len(before)} queries "
        f"answer equal; the next add gets id {next_id[0]}")
    del loaded
    shutil.rmtree(path, ignore_errors=True)

    # ---- promotion of a loaded single index: corpus_from_index at 1M docs
    single = Retriever.load(single_dir, scfg, params=DynamicParams(k=K), device=device)
    want = [r for b in batches for r in single.search_batch(b)]
    t0 = time.perf_counter()
    ptr, tids, ws = mutable.corpus_from_index(single.index)
    cfi_s = time.perf_counter() - t0
    check(np.array_equal(ptr, corpus.doc_ptr) and np.array_equal(tids, corpus.tids),
          "corpus_from_index gives back the source corpus's docs and terms")
    err = float(np.abs(ws - corpus.ws).max())
    t0 = time.perf_counter()
    single.mutable()
    promote_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip([r for b in batches for r in single.search_batch(b)], want)):
        _same_response(a, b, f"promoted single index, query {i}")
    log(f"corpus_from_index of the loaded {N_DOCS}-doc index: {cfi_s:.2f} s (the docs and terms of the source "
        f"corpus, weights within {err:.4f} of it: the 8-bit dequantization); mutable() of that retriever "
        f"{promote_s:.2f} s; its {len(want)} answers unchanged")
    del single, retr
    torch.cuda.empty_cache()
    return launches


def sharded_store_phase(idx, device, core_ops, sites, tmp):
    """save_sharded_index of the main path's index into 3 shards (a ragged last
    shard, an unaligned cut of the superblock matrices), load_index_auto,
    a second save's fingerprint, load_sharded_index(verify=True). Returns
    (shard_index's shards, the saved directory) for the sharded phase."""

    import torch

    from repro_torch.distributed.retrieval import shard_index
    from repro_torch.index.builder import IndexBuildConfig
    from repro_torch.index.layout import index_nbytes
    from repro_torch.index.store import ShardedIndex, load_index_auto, load_sharded_index, save_sharded_index

    def cut():
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        shards = shard_index(idx, N_SHARDS)
        torch.cuda.synchronize(device)
        return shards, time.perf_counter() - t0, base, torch.cuda.max_memory_allocated(device)

    (shards, cut_s, base, peak), launches, _ = counted(core_ops, cut, sites)
    log(f"sharded store: launches during shard_index: {launches} (the cut is plain torch)")
    log(f"shard_index of the {N_DOCS}-doc index into {N_SHARDS}: {cut_s:.2f} s; {shards[0].n_superblocks} "
        f"superblocks a shard ({N_SHARDS * shards[0].n_superblocks - idx.n_superblocks} padded); shards hold "
        f"{sum(index_nbytes(s) for s in shards) / 1e9:.3f} GB; peak device memory {peak / 1e9:.2f} GB, "
        f"{(peak - base) / 1e9:.2f} GB above the {base / 1e9:.2f} GB before")
    paths = [os.path.join(tmp, f"sharded{i}") for i in range(2)]
    try:
        t0 = time.perf_counter()
        fp = save_sharded_index(paths[0], idx, N_SHARDS, IndexBuildConfig())
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(paths[0]) for f in fs)
        t0 = time.perf_counter()
        loaded = load_index_auto(paths[0], device=device)
        load_s = time.perf_counter() - t0
        check(isinstance(loaded, ShardedIndex) and loaded.fingerprint == fp and len(loaded.shards) == N_SHARDS
              and loaded.n_superblocks == idx.n_superblocks, "load_index_auto returns the saved ShardedIndex")

        def same(a, b, path):
            if isinstance(b, torch.Tensor):
                check(a.dtype == b.dtype and torch.equal(a, b), f"shard leaf {path}")
            elif isinstance(b, tuple):
                for f in b._fields:
                    same(getattr(a, f), getattr(b, f), f"{path}.{f}")
            else:
                check(a == b, f"shard leaf {path}")

        for i, (a, b) in enumerate(zip(loaded.shards, shards)):
            same(a, b, f"shard {i}")
        del loaded
        t0 = time.perf_counter()
        check(save_sharded_index(paths[1], idx, N_SHARDS, IndexBuildConfig()) == fp, "a second save, the same "
              "global fingerprint")
        resave_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(len(load_sharded_index(paths[0], verify=True, device=device)) == N_SHARDS, "verify")
        verify_s = time.perf_counter() - t0
        log(f"save_sharded_index ({N_SHARDS} shards): {written / 1e9:.3f} GB in {save_s:.2f} s (fingerprint {fp}); "
            f"load_index_auto {load_s:.2f} s (page-cached), every shard equal leaf by leaf to shard_index's; a second "
            f"save {resave_s:.2f} s, the same fingerprint; load_sharded_index(verify=True) {verify_s:.2f} s")
    finally:
        shutil.rmtree(paths[1], ignore_errors=True)
    torch.cuda.empty_cache()
    return shards, paths[0]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, sharded_dir, scfg, defaults, queries, device, results):
    """One rank of the sharded phase's process group (gloo; every rank on
    ``device``, the one card): loads only its own shard from ``sharded_dir``,
    answers the batches of ``queries`` with the others, and sends back every
    result field, its launches and its times."""
    import traceback

    import torch
    import torch.distributed as dist

    from repro_torch.core import ops as core_ops
    from repro_torch.core.query import make_query_batch
    from repro_torch.distributed.sharded import ShardedRetriever
    from repro_torch.index.layout import index_nbytes

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        t0 = time.perf_counter()
        retr = ShardedRetriever.from_dir(sharded_dir, scfg, group=dist.group.WORLD, defaults=defaults, device=device)
        load_s = time.perf_counter() - t0
        qbs = [make_query_batch(queries[i: i + BATCH], retr.vocab, nq_max=max(len(t) for t, _ in queries[i: i + BATCH]),
                                device=device) for i in range(0, len(queries), BATCH)]
        retr(qbs[0])  # the first call loads the kernels
        fns = {name: getattr(core_ops, attr) for name, (attr, _, _) in KERNELS.items()}
        for fn in fns.values():
            fn.launches = 0
        outs, batch_ms = [], []
        for qb in qbs:
            t0 = time.perf_counter()
            out = retr(qb)
            outs.append({f: getattr(out, f).cpu().numpy() for f in out._fields})
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {name: fn.launches for name, fn in fns.items()}
        results.put((rank, dict(outs=outs, launches=launches, load_s=load_s, batch_ms=batch_ms,
                                shard_gb=index_nbytes(retr.shards[rank]) / 1e9),
                     None))
    except BaseException:  # sent to the parent, then raised
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def process_group_run(sharded_dir, scfg, defaults, requests, device):
    """The process-group transport: N_SHARDS spawned ranks over gloo sharing
    the card, each loading only its own shard; joined with a timeout, a hung
    or failed rank fails the run. Returns {rank: what it sent}."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    queries = [(r.tids, r.weights) for r in requests]
    procs = [ctx.Process(target=_rank_main, args=(r, N_SHARDS, port, sharded_dir, scfg, defaults, queries, device,
                                                  results)) for r in range(N_SHARDS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:  # drain the queue before joining
            try:
                rank, res, err = results.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"a rank sent nothing within {RANK_TIMEOUT_S} s")
                break
            if err is not None:
                errors.append(f"rank {rank} failed:\n{err}")
                break
            got[rank] = res
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S if not errors else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    check(not errors, "; ".join(errors))
    check(all(p.exitcode == 0 for p in procs), f"rank exit codes {[p.exitcode for p in procs]}")
    log(f"process group: {N_SHARDS} ranks spawned, joined and exited 0 in {time.perf_counter() - t0:.1f} s")
    return got


def _same_ids_theta_counters(got, want, what):
    """Equal ids, θ and both counters; the largest score difference."""
    import numpy as np

    check((got.doc_ids == want.doc_ids).all(), f"{what}: ids differ")
    check(got.theta == want.theta, f"{what}: theta differs ({got.theta} vs {want.theta})")
    check((got.n_superblocks_visited, got.n_blocks_scored) == (want.n_superblocks_visited, want.n_blocks_scored),
          f"{what}: counters differ")
    return float(np.abs(got.scores - want.scores).max())


def sharded_phase(retr, batches, responses, shards, sharded_dir, single_dir, device, core_ops, sites):
    """Sharded serving over the main path's index, the sharded-store phase's
    3-shard cut and its directory (nothing is built again): the host-loop
    sharded backend on the default lsp0 point against the fwd phase's local
    responses and against its own impl="ref" (each kernel launching on every
    shard); lsp2 and a binding block budget against local at the same config;
    ``Retriever.load`` of the directory through the engine, with
    ``swap_index`` to the single directory, back and again under client
    traffic; the process-group transport (3 gloo ranks on the card) against
    the host loop. Returns (launches of the lsp0 run, the kernel calls of its
    first batch by kernel)."""
    import dataclasses
    import threading
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.api import Retriever
    from repro_torch.core.query import make_query_batch
    from repro_torch.distributed.sharded import make_plan
    from repro_torch.index.layout import index_nbytes

    idx, cfg = retr.index, retr.static_cfg
    requests = [r for b in batches for r in b]
    sites = {**sites, **{getattr(s, attr).packed.data_ptr(): site for s in shards for site, attr in SBMAX_SITES.items()
                         if attr != "blk_bounds"}}
    owner = {t.data_ptr(): p for p, s in enumerate(shards)
             for t in (s.sb_bounds.packed, s.sb_avg.packed, s.blk_bounds.packed, s.docs_fwdq.tids)}
    fwd_kernels = ["sbmax", "boundsum_gather", "doc_score_fwd"]
    sharded = Retriever.from_index(shards, cfg, ns_true=idx.n_superblocks, device=device)
    check(sharded.backend_name == "sharded", "a shard list resolves to the sharded backend")
    log(f"sharded: {N_SHARDS} shards of {shards[0].n_superblocks} superblocks resident, "
        f"{sum(index_nbytes(s) for s in shards) / 1e9:.3f} GB (the unsharded index {index_nbytes(idx) / 1e9:.3f} GB); "
        f"device memory allocated {torch.cuda.memory_allocated(device) / 1e9:.2f} GB")

    # ---- 1. host loop, lsp0, the 256 requests: every kernel on every shard
    sharded.search_batch(batches[0])
    holder = {}

    def run():
        out = []
        holder["calls"] = capture(core_ops, fwd_kernels,
                                  lambda: out.extend(r for b in batches for r in sharded.search_batch(b)))
        return out

    got, launches, by_site = counted(core_ops, run, sites)
    by_shard = {k: Counter(owner[args[0].data_ptr()] for args in calls) for k, calls in holder["calls"].items()}
    log(f"sharded lsp0: launches during the 4 search_batch calls: {launches}; sbmax by call site {by_site}; "
        f"by shard {({k: dict(sorted(v.items())) for k, v in by_shard.items()})}")
    for key, per in (("sbmax", 1), ("boundsum_gather", 1), ("doc_score_fwd", 2)):
        check(launches[key] == len(batches) * N_SHARDS * per, f"sharded {key}: {launches[key]} launches")
        check(all(by_shard[key][p] == len(batches) * per for p in range(N_SHARDS)),
              f"sharded {key} launched {per} a batch on every shard")
    diff = max(_same_ids_theta_counters(g, w, f"sharded request {i} vs local") for i, (g, w)
               in enumerate(zip(got, responses)))
    ref = Retriever.from_index(shards, cfg, ns_true=idx.n_superblocks, impl="ref", device=device)
    ref_got = [r for b in batches for r in ref.search_batch(b)]
    for i, (g, w) in enumerate(zip(got, ref_got)):
        check((g.doc_ids == w.doc_ids).all() and (g.n_superblocks_visited, g.n_blocks_scored) == (
            w.n_superblocks_visited, w.n_blocks_scored), f"sharded request {i}: kernel vs impl='ref'")
    cand = np.stack([r.shard_candidates for r in got])
    log(f"sharded lsp0 == local (fwd phase) on ids, theta and both counters for all {len(got)} requests, largest "
        f"score difference {diff:.3g}; == impl='ref' on ids and both counters; top-gamma share per shard: mean "
        f"{cand.mean(axis=0).round(1).tolist()}, min {cand.min(axis=0).tolist()}, max {cand.max(axis=0).tolist()}")
    first_calls = {k: v[: {"doc_score_fwd": 2 * N_SHARDS}.get(k, N_SHARDS)] for k, v in holder["calls"].items()}
    qbs = [make_query_batch([(r.tids, r.weights) for r in b], idx.vocab, nq_max=max(len(r.tids) for r in b),
                            device=device) for b in batches]
    host = [sharded._backend(qb, sharded.defaults) for qb in qbs]
    host = [{f: getattr(o, f).cpu().numpy() for f in o._fields} for o in host]
    local_ms, sharded_ms = [], []
    for _ in range(3):
        for b in batches:
            local_ms.append(host_ms(lambda: retr.search_batch(b)))
            sharded_ms.append(host_ms(lambda: sharded.search_batch(b)))
    log(f"search_batch of {BATCH}, lsp0: sharded (host loop, {N_SHARDS} shards) median "
        f"{statistics.median(sharded_ms):.2f} ms, local median {statistics.median(local_ms):.2f} ms "
        f"(interleaved, {len(local_ms)} calls each)")
    profile_call(f"sharded search_batch ({BATCH} requests, {N_SHARDS} shards)", lambda: sharded.search_batch(batches[0]))
    profile_call(f"local search_batch ({BATCH} requests), beside it", lambda: retr.search_batch(batches[0]))

    # ---- 2. lsp2 (SBavg per shard) and a binding block budget, against local at the same config
    wide = dataclasses.replace(retr.defaults, eta=SHARDED_BUDGET_ETA)
    for label, c2, params in (
            ("lsp2", dataclasses.replace(cfg, variant="lsp2"), retr.defaults),
            (f"block_budget {SHARDED_BLOCK_BUDGET}, eta {SHARDED_BUDGET_ETA}",
             dataclasses.replace(cfg, block_budget=SHARDED_BLOCK_BUDGET), wide)):
        plan = make_plan(c2, idx.n_superblocks, shards[0].n_superblocks, idx.c, idx.b, N_SHARDS)
        local = [r for b in batches for r in Retriever.from_index(idx, c2, params=params, device=device).search_batch(b)]
        sh = Retriever.from_index(shards, c2, params=params, ns_true=idx.n_superblocks, device=device)
        out, n, sites_n = counted(core_ops, lambda: [r for b in batches for r in sh.search_batch(b)], sites)
        diff = max(_same_ids_theta_counters(g, w, f"sharded {label}, request {i}") for i, (g, w)
                   in enumerate(zip(out, local)))
        blocks = np.mean([r.n_blocks_scored for r in out])
        log(f"sharded {label}: == local on ids, theta and both counters for all {len(out)} requests (largest score "
            f"difference {diff:.3g}); launches {n}, sbmax by call site {sites_n}; cross-shard bounds merge "
            f"{plan.competitive} (budget*c = {plan.budget * idx.c}, block_budget {plan.block_budget}); mean blocks "
            f"scored {blocks:.1f}")
        if c2.variant == "lsp2":
            check(sites_n["SBavg"] == len(batches) * N_SHARDS, "SBavg on every shard")
            continue
        free = [r for b in batches for r in Retriever.from_index(idx, cfg, params=wide, device=device).search_batch(b)]
        free_blocks = np.mean([r.n_blocks_scored for r in free])
        log(f"  without the budget at eta {SHARDED_BUDGET_ETA}: mean blocks scored {free_blocks:.1f}; the cut kept "
            f"at most {SHARDED_BLOCK_BUDGET} of phase 3's")
        check(plan.competitive and blocks < free_blocks, "the block budget binds and cuts blocks")

    # ---- 3. the engine over the saved set, swap_index to the single directory and back under traffic
    t0 = time.perf_counter()
    loaded = Retriever.load(sharded_dir, cfg, device=device)
    load_s = time.perf_counter() - t0
    check(loaded.backend_name == "sharded" and loaded._backend.n_shards == N_SHARDS, "the set loads sharded")
    engine = loaded.serve(max_batch=BATCH, nq_max=ENGINE_NQ, cache_size=0)
    try:
        engine.warmup()
        out, _ = _submit_all(engine, requests, 8)
        for i, (g, w) in enumerate(zip(out, got)):
            check(not isinstance(g, BaseException), f"engine request {i} over the loaded set failed: {g!r}")
            _same_response(g, w, f"engine request {i} over the loaded set vs search_batch")
        log(f"Retriever.load of the {N_SHARDS}-shard directory {load_s:.2f} s; its engine answers all "
            f"{len(requests)} requests equal to the host loop's search_batch")
        stop, lock = threading.Event(), threading.Lock()
        seen, errors = [], []

        def client(first):
            i = first
            while not stop.is_set():
                try:
                    resp = engine.search(requests[i % len(requests)]).result(timeout=120)
                except Exception as exc:  # noqa: BLE001 - counted as a failure below
                    with lock:
                        errors.append(exc)
                    return
                with lock:
                    seen.append((i % len(requests), resp))
                i += 4

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        swap_s = []
        try:
            for epoch, target in enumerate((single_dir, sharded_dir, single_dir), start=1):
                time.sleep(0.5)
                t0 = time.perf_counter()
                check(engine.swap_index(target) == epoch, f"swap {epoch}")
                swap_s.append(time.perf_counter() - t0)
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "a client thread of the swap traffic hung")
        check(not errors, f"requests failed across the swaps: {errors[:3]}")
        for i, resp in seen:
            _same_response(resp, got[i], f"request {i} at epoch {resp.epoch}")
        epochs = Counter(resp.epoch for _, resp in seen)
        check(set(epochs) == {0, 1, 2, 3}, f"traffic saw every epoch: {dict(epochs)}")
        check(engine.stats.summary()["failures"] == 0, "no failure in the engine")
        log(f"engine swap_index under 4 client threads: single dir -> sharded dir -> single dir, each cut into "
            f"{N_SHARDS} shards, {[f'{s:.2f}' for s in swap_s]} s; {len(seen)} responses by epoch "
            f"{dict(sorted(epochs.items()))}, each equal to the host loop's; 0 failures")
    finally:
        engine.shutdown()
    del loaded, engine
    torch.cuda.empty_cache()

    # ---- 4. the process-group transport: 3 gloo ranks on the card, each with its own shard
    ranks = process_group_run(sharded_dir, cfg, sharded.defaults, requests, device)
    for rank, res in sorted(ranks.items()):
        for b, (g, w) in enumerate(zip(res["outs"], host)):
            for f, want in w.items():
                check(np.array_equal(g[f], want), f"process group rank {rank}, batch {b}: {f} differs from the host loop")
        check(res["launches"]["sbmax"] == len(batches) and res["launches"]["boundsum_gather"] == len(batches)
              and res["launches"]["doc_score_fwd"] == 2 * len(batches), f"rank {rank} launches {res['launches']}")
        log(f"process group rank {rank}: every field of all {len(host)} batches equal to the host loop (ids, scores, "
            f"theta, both counters, shard_theta, shard_superblocks, shard_blocks, shard_candidates); launches "
            f"{res['launches']}; its shard {res['shard_gb']:.3f} GB loaded in {res['load_s']:.2f} s; a batch "
            f"{statistics.median(res['batch_ms']):.2f} ms median (host clock)")
    return launches, first_calls

def _top_terms(vecs, top):
    """Each row's ``top`` largest term weights above ENC_MIN_WEIGHT, on the
    device: (terms a row, term ids, weights), rows in order."""
    import torch

    vals, ids = torch.topk(vecs, top, dim=1)
    keep = vals > ENC_MIN_WEIGHT
    return keep.sum(dim=1), ids[keep].to(torch.int32), vals[keep]


def encoder_step_flops(cfg, batch):
    """The model FLOPs of one training step of the encoder on ``batch`` query
    and document pairs: eval/model_flops.py's 6·N·tokens, plus attention over
    the whole sequence (bidirectional: no causal half), x3 for the backward."""
    from repro_torch.eval.model_flops import lm_active_params
    from repro_torch.launch.train import SPLADE_D_LEN, SPLADE_Q_LEN

    hd = cfg.resolved_head_dim()
    flops = 0.0
    for seq in (SPLADE_Q_LEN, SPLADE_D_LEN):
        tokens = batch * seq
        flops += 6.0 * lm_active_params(cfg) * tokens + cfg.n_layers * 3.0 * 2.0 * 2.0 * cfg.n_heads * hd * tokens * seq
    return flops


def gamma_reading(idx, queries, vocab, exact_ids, gamma, device):
    """The paper's γ analysis on an index (print only): the share of the
    exact top-k documents' superblocks that rank in the top γ by SBMax, and
    P_γ(R) from gamma_analysis (the γ-th ranked superblock holds a top-k doc)."""
    import numpy as np
    import torch

    from repro_torch.core import ops
    from repro_torch.core.gamma_analysis import (
        contains_topk, p_contains_topk_by_bin, p_gamma_contains, sbmax_ratio_distribution,
    )
    from repro_torch.core.query import make_query_batch

    qb = make_query_batch(queries, vocab, device=device)
    sbm = ops.sbmax(idx.sb_bounds, qb.tids, qb.ws, "ref")
    in_top = torch.zeros_like(sbm, dtype=torch.bool).scatter_(1, torch.topk(sbm, gamma, dim=1).indices, True)
    contains = contains_topk(idx, exact_ids)
    share = float((contains & in_top.cpu().numpy()).sum() / max(contains.sum(), 1))
    edges, cdf, ratios = sbmax_ratio_distribution(sbm.cpu().numpy().astype(np.float64))
    p_bin = p_contains_topk_by_bin(ratios, contains, edges)
    return share, float(p_gamma_contains(np.array([gamma]), idx.n_superblocks, edges, cdf, p_bin)[0])


def encoder_phase(device, core_ops, sites):
    """The SPLADE encoder at full width (splade_100m_config, vocab 32,768),
    through the launcher's --splade job: ENC_STEPS bf16-compute steps with
    falling ce; a second run of the same job checkpointed at step
    ENC_RESUME_AT / 2, restored in a fresh Trainer and run to ENC_RESUME_AT,
    against the straight run there (to the bit, see the determinism probe);
    one float32 batch on the card against the CPU port; then
    ENC_DOCS documents and N_QUERIES queries encoded on the card, sparsified
    there, indexed with build_index and searched in four search_batch calls
    of 64 at lsp0 (counted) against impl="ref" and exact. Returns (launches,
    captured calls) of the path's kernels."""
    import numpy as np
    import torch

    from repro_torch.api import Retriever, SearchRequest
    from repro_torch.common.tree_utils import flatten_with_paths, global_norm, param_count, tree_cast, tree_map
    from repro_torch.core.config import DynamicParams, StaticConfig
    from repro_torch.core.query import make_query_batch
    from repro_torch.core.threshold import estimate_theta
    from repro_torch.data.pipeline import CounterPipeline, PipelineConfig, splade_synthetic_batch
    from repro_torch.eval.metrics import recall_vs_oracle
    from repro_torch.index.builder import IndexBuildConfig, build_index
    from repro_torch.launch.train import SPLADE_D_LEN, SPLADE_Q_LEN, splade_job
    from repro_torch.models.sparse_encoder import SpladeBatch, encoder_forward, splade_loss

    t_phase = time.perf_counter()
    # ---- a. the straight run
    cfg, trainer, pipe = splade_job(ENC_STEPS, ENC_BATCH, device=device)
    state = trainer.init_or_restore()
    n_params = param_count(state.params)
    log(f"encoder: {cfg}; {n_params:,} parameters; AdamW lr 3e-4, warmup 10, {ENC_STEPS} steps of "
        f"{ENC_BATCH} pairs ({SPLADE_Q_LEN} + {SPLADE_D_LEN} tokens), bf16 compute, float32 master weights")
    check(100e6 < n_params < 120e6, f"the full-width encoder has {n_params} parameters")
    ces, stamps = [], []

    def on_step(step, metrics):
        ces.append(float(metrics["ce"]))  # waits for the step
        stamps.append(time.perf_counter())

    resident_gb = torch.cuda.memory_allocated(device) / 1e9  # the model, its moments and what earlier phases hold
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = trainer.run(state, pipe, ENC_RESUME_AT, log_every=0, on_step=on_step)
    at_resume = tree_map(lambda x: x.clone(), state)  # the straight run at step ENC_RESUME_AT
    straight = trainer.run(state, pipe, ENC_STEPS - ENC_RESUME_AT, log_every=0, on_step=on_step)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stamps.insert(ENC_RESUME_AT, None)  # the snapshot between the two calls is no step
    step_s = statistics.median(b - a for a, b in zip(stamps[ENC_WARMUP:], stamps[ENC_WARMUP + 1:])
                               if a is not None and b is not None)
    first, last = float(np.mean(ces[:5])), float(np.mean(ces[-5:]))
    flops = encoder_step_flops(cfg, ENC_BATCH)
    log(f"encoder training: ce first 5 steps {first:.4f} (ln {ENC_BATCH} = {np.log(ENC_BATCH):.4f}), last 5 "
        f"{last:.4f}; every 20th: {[round(c, 3) for c in ces[::20]]}")
    log(f"encoder train step: median {step_s * 1e3:.2f} ms (steps {ENC_WARMUP + 2}-{ENC_STEPS}, host clock, "
        f"each step ends in a read of ce), {ENC_BATCH * (SPLADE_Q_LEN + SPLADE_D_LEN) / step_s:,.0f} tokens/s, "
        f"{flops / 1e12:.3f} model TFLOP a step -> {flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{flops / step_s / BF16_FLOP_PER_S:.3f} of the H100's dense bf16 peak; peak device memory {peak_gb:.2f} GB, "
        f"{resident_gb:.2f} GB of it allocated before the first step")
    check(last < first, f"ce does not fall: first 5 steps {first}, last 5 {last}")

    # ---- b. determinism probe: one step under torch.use_deterministic_algorithms(True)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    probe = tree_map(lambda x: x.clone(), straight)
    batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(ENC_STEPS).items()}
    torch.use_deterministic_algorithms(True)
    try:
        trainer.step_fn(probe, batch)
        torch.cuda.synchronize(device)
        flagged = "none: no op of the step is flagged nondeterministic"
    except RuntimeError as e:
        flagged = str(e).splitlines()[0][:300]
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"encoder determinism probe (a step under use_deterministic_algorithms(True)): {flagged}")
    profile_call("encoder train step", lambda: float(trainer.step_fn(probe, batch)[1]["ce"]))
    del probe

    # ---- c. checkpoint half way, restore in a fresh Trainer, run on
    tmp = tempfile.mkdtemp()
    try:
        ck = os.path.join(tmp, "ckpt")
        _, t_a, pipe_a = splade_job(ENC_STEPS, ENC_BATCH, device=device, ckpt_dir=ck, ckpt_every=ENC_STEPS)
        a_stamps = []
        t_a.run(t_a.init_or_restore(), pipe_a, ENC_RESUME_AT // 2, log_every=0,
                on_step=lambda step, m: (float(m["loss"]), a_stamps.append(time.perf_counter())))
        save_s = time.perf_counter() - a_stamps[-1]
        ck_gb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ck) for f in fs) / 1e9
        _, t_b, pipe_b = splade_job(ENC_STEPS, ENC_BATCH, device=device, ckpt_dir=ck, ckpt_every=ENC_STEPS)
        t0 = time.perf_counter()
        resumed = t_b.init_or_restore()
        restore_s = time.perf_counter() - t0
        check(int(resumed.step) == ENC_RESUME_AT // 2, f"restored step {int(resumed.step)}")
        resumed = t_b.run(resumed, pipe_b, ENC_RESUME_AT - ENC_RESUME_AT // 2, log_every=0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = flatten_with_paths(at_resume), flatten_with_paths(resumed)
    del at_resume
    differ = {k: float((a[k].double() - b[k].double()).abs().max()) for k in a if not torch.equal(a[k], b[k])}
    log(f"encoder checkpoint at step {ENC_RESUME_AT // 2}: {ck_gb:.3f} GB written in {save_s:.1f} s (save at the "
        f"end of the run), restored in a fresh Trainer in {restore_s:.1f} s; resumed run vs straight run after "
        f"{ENC_RESUME_AT} steps: {len(a) - len(differ)} of {len(a)} leaves equal to the bit"
        + (f"; largest difference {max(differ.values()):.3g} in {max(differ, key=differ.get)}" if differ else ""))
    check(not differ or max(differ.values()) <= ENC_RESUME_ATOL,
          f"the resumed run is more than {ENC_RESUME_ATOL} from the straight run: {differ}")

    # ---- d. one float32 batch on the card and on the CPU (the path the tests hold to JAX)
    fbatch = pipe.batch_at(0)

    def loss_and_norm(dev):
        p = tree_map(lambda x: x.detach().to(dev, torch.float32, copy=True).requires_grad_(), straight.params)
        bt = {k: torch.from_numpy(v).to(dev) for k, v in fbatch.items()}
        loss, _ = splade_loss(p, cfg, SpladeBatch(bt["q_tokens"], bt["q_mask"], bt["d_tokens"], bt["d_mask"]))
        grads = torch.autograd.grad(loss, list(flatten_with_paths(p).values()))
        return float(loss.detach()), float(global_norm(grads))

    t0 = time.perf_counter()
    cpu_loss, cpu_norm = loss_and_norm(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    card_loss, card_norm = loss_and_norm(device)
    log(f"encoder float32 batch: loss card {card_loss:.7f} vs CPU {cpu_loss:.7f}, gradient norm card "
        f"{card_norm:.7f} vs CPU {cpu_norm:.7f} (CPU {cpu_s:.1f} s); tolerance rtol {ENC_DEVICE_RTOL}")
    check(abs(card_loss - cpu_loss) <= ENC_DEVICE_RTOL * abs(cpu_loss), "encoder loss on the card vs the CPU")
    check(abs(card_norm - cpu_norm) <= ENC_DEVICE_RTOL * abs(cpu_norm), "gradient norm on the card vs the CPU")

    # ---- e. encode ENC_DOCS documents and N_QUERIES queries on the card, sparsify there
    params = tree_cast(straight.params, torch.bfloat16)  # the compute dtype the encoder was trained in
    docs = CounterPipeline(PipelineConfig(global_batch=ENC_ENCODE_BATCH, seed=1),
                           splade_synthetic_batch(cfg.vocab, ENC_ENCODE_BATCH, SPLADE_Q_LEN, SPLADE_D_LEN))
    parts, host_s = [], 0.0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(ENC_DOCS // ENC_ENCODE_BATCH):
            th = time.perf_counter()
            b = docs.batch_at(i)
            host_s += time.perf_counter() - th
            if i == 0:
                qtok, qmask = b["q_tokens"][:N_QUERIES], b["q_mask"][:N_QUERIES]  # their positives are docs 0-255
            dv = encoder_forward(params, cfg, torch.from_numpy(b["d_tokens"]).to(device),
                                 torch.from_numpy(b["d_mask"]).to(device))
            parts.append(_top_terms(dv, ENC_TOP_DOC))
        qv = encoder_forward(params, cfg, torch.from_numpy(qtok).to(device), torch.from_numpy(qmask).to(device))
        q_lens, q_tids, q_ws = (t.cpu().numpy() for t in _top_terms(qv, ENC_TOP_Q))
        lens, tids, ws = (torch.cat([p[j] for p in parts]).cpu().numpy() for j in range(3))
    encode_s = time.perf_counter() - t0 - host_s
    doc_ptr = np.zeros(ENC_DOCS + 1, np.int64)
    np.cumsum(lens, out=doc_ptr[1:])
    q_ptr = np.concatenate([[0], np.cumsum(q_lens)])
    queries = [(q_tids[q_ptr[i]: q_ptr[i + 1]], q_ws[q_ptr[i]: q_ptr[i + 1]]) for i in range(N_QUERIES)]
    log(f"encoded {ENC_DOCS} documents and {N_QUERIES} queries on the card (bf16) in {encode_s:.2f} s "
        f"({ENC_DOCS / encode_s:,.0f} docs/s; host batch synthesis {host_s:.2f} s excluded); terms a document "
        f"mean {lens.mean():.1f} (min {lens.min()}), a query mean {q_lens.mean():.1f}")
    check(lens.min() > 0 and q_lens.min() > 0, "every document and query keeps a term above the floor")

    # ---- f. index the learned vectors on the card, search at lsp0, counted
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    idx = build_index(doc_ptr, tids, ws, cfg.vocab, IndexBuildConfig(), device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    sites.update({getattr(idx, attr).packed.data_ptr(): site for site, attr in SBMAX_SITES.items()})
    gamma = max(8, idx.n_superblocks // ENC_GAMMA_DIV)
    scfg = StaticConfig(variant="lsp0", gamma=gamma, gamma0=4, k_max=K)
    log(f"learned index built on the card in {build_s:.2f} s: {idx.n_blocks} blocks, {idx.n_superblocks} "
        f"superblocks; lsp0 at gamma = {gamma} (1/{ENC_GAMMA_DIV} of the superblocks), gamma0 4, k 10")
    retr = Retriever.from_index(idx, scfg, device=device)
    requests = [SearchRequest(t, w) for t, w in queries]
    batches = [requests[i: i + BATCH] for i in range(0, N_QUERIES, BATCH)]
    kernels = ["sbmax", "boundsum_gather", "doc_score_fwd"]
    captured = capture(core_ops, kernels, lambda: retr.search_batch(batches[0]))
    resp, launches, by_site = counted(core_ops, lambda: [r for bt in batches for r in retr.search_batch(bt)], sites)
    log(f"encoder path: launches during the 4 search_batch calls: {launches}; sbmax by call site {by_site}")
    for key in kernels:
        check(launches[key] > 0, f"kernel {key} was never launched on the encoder path")
    ids = np.stack([r.doc_ids for r in resp])
    check(ids.shape == (N_QUERIES, K) and np.isfinite(np.stack([r.scores for r in resp])).all(),
          "encoder path result shape / finite scores")
    ref = Retriever.from_index(idx, scfg, impl="ref", device=device)
    ref_resp = [r for bt in batches for r in ref.search_batch(bt)]
    same_counters = all((x.n_superblocks_visited, x.n_blocks_scored) == (y.n_superblocks_visited, y.n_blocks_scored)
                        for x, y in zip(resp, ref_resp))
    same_ids = bool((ids == np.stack([r.doc_ids for r in ref_resp])).all())
    exact = Retriever.from_index(idx, scfg, backend="exact", device=device)
    exact_resp = [r for bt in batches for r in exact.search_batch(bt)]
    exact_ids = np.stack([r.doc_ids for r in exact_resp])
    kth = np.stack([r.scores for r in exact_resp])[:, K - 1]
    theta = estimate_theta(idx, make_query_batch(queries, cfg.vocab, device=device), K).cpu().numpy()
    whole = Retriever.from_index(idx, scfg, params=DynamicParams(k=K, beta=1.0), device=device)
    whole_resp = [r for bt in batches for r in whole.search_batch(bt)]
    log(f"encoder path kernel vs impl='ref' ({N_QUERIES} queries): ids identical {same_ids}, counters equal "
        f"{same_counters}; lsp0 recall@10 vs exact {recall_vs_oracle(ids, exact_ids):.4f}; mean superblocks "
        f"visited {np.mean([r.n_superblocks_visited for r in resp]):.1f} / {idx.n_superblocks}, blocks scored "
        f"{np.mean([r.n_blocks_scored for r in resp]):.1f}; at beta 1 (bounds over every query term): recall@10 "
        f"{recall_vs_oracle(np.stack([r.doc_ids for r in whole_resp]), exact_ids):.4f}, superblocks visited "
        f"{np.mean([r.n_superblocks_visited for r in whole_resp]):.1f}; estimate_theta at or below the true 10th "
        f"score: {float(np.mean(theta <= kth)):.3f}")
    check(same_ids and same_counters, "encoder path: kernel and ref paths return the same ids and counters")
    call_ms = [host_ms(lambda: retr.search_batch(bt)) for _ in range(3) for bt in batches]
    log(f"search_batch of {BATCH} on the learned index: median {statistics.median(call_ms):.2f} ms over "
        f"{len(call_ms)} calls (kernel path)")
    profile_call(f"search_batch on the learned index ({BATCH} requests)", lambda: retr.search_batch(batches[0]))
    share, p_gamma = gamma_reading(idx, queries, cfg.vocab, exact_ids, gamma, device)
    log(f"gamma analysis on the learned index at gamma {gamma}: exact top-10 superblocks in the top gamma by "
        f"SBMax {share:.4f}, P_gamma(R) {p_gamma:.4f}")
    log(f"encoder phase {time.perf_counter() - t_phase:.1f} s")
    return launches, captured


def _wall_ms(fn, reps=REC_REPS):
    """Median host-clock ms of ``fn()`` over ``reps`` calls, each ended by a
    device sync (one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _held_to_cpu(label, got, want, rtol):
    """A card result against the CPU port's on the same inputs: max abs error
    <= rtol x max |reference|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    import torch

    check(tuple(got.shape) == tuple(want.shape), f"{label}: shape {tuple(got.shape)} against {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: finite values")
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    log(f"{label}: card against the CPU port max abs error {err:.3g} (max |reference| {ref:.3g}, bound "
        f"{rtol} x it)")
    check(err <= rtol * ref, f"{label}: card against CPU {err} > {rtol} x {ref}")


def _peak_gb(device):
    import torch

    return torch.cuda.max_memory_allocated(device) / 1e9


def _table_gb(tables):
    return tables.table.numel() * tables.table.element_size() / 1e9


def _cand_sweep(score_chunk, n, chunk):
    """The top K (values, candidate ids) of candidates 0..n-1, scored by
    ``score_chunk(lo, hi)`` in chunks of ``chunk``."""
    import torch

    return torch.topk(torch.cat([score_chunk(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]), K)


def dlrm_din_serving(device):
    """dlrm-rm2 and din at full width: serve_p99 (timed, profiled, its first
    REC_CPU_ROWS rows held to the CPU port), serve_bulk (DLRM in one call, DIN
    in chunks of DIN_BULK_CHUNK) and the retrieval_cand sweep of 1 user over
    REC_CANDS candidates (DLRM: candidate ids in field 0, chunks of
    DLRM_CHUNK; DIN: candidate items, chunks of DIN_CHUNK), its top K held
    to the CPU port."""
    import numpy as np
    import torch

    from repro_torch.common.tree_utils import tree_map
    from repro_torch.configs.base import get_arch
    from repro_torch.models import recsys as R

    rng = np.random.default_rng(REC_SEED)
    # ---- dlrm-rm2
    rc = get_arch("dlrm-rm2").recsys
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    p = R.init_dlrm(rc, torch.Generator(device=device).manual_seed(REC_SEED), device=device)
    torch.cuda.synchronize(device)
    log(f"recsys: dlrm-rm2 {rc.n_sparse} x {rc.vocab_sizes[0]:,} rows padded to {p.tables.table.shape[0]:,} x "
        f"{rc.embed_dim}: {_table_gb(p.tables):.3f} GB of tables (float32), drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; bottom MLP {(rc.n_dense,) + rc.bot_mlp}, top MLP "
        f"{(p.top[0].shape[0],) + rc.top_mlp}")
    check(tuple(p.tables.table.shape) == (26_000_384, 64) and p.top[0].shape[0] == 415, "dlrm-rm2 at full width")
    vocab = np.asarray(rc.vocab_sizes)

    def dlrm_batch(n):
        dense = np.log1p(rng.exponential(4.0, (n, rc.n_dense))).astype(np.float32)  # log-transformed counts
        ids = rng.integers(0, vocab, (n, rc.n_sparse)).astype(np.int32)
        return torch.from_numpy(dense).to(device), torch.from_numpy(ids).to(device)

    p_cpu = tree_map(lambda x: x.cpu(), p)
    with torch.no_grad():
        dense, ids = dlrm_batch(REC_P99)
        out = R.dlrm_forward(p, rc, dense, ids)
        check(tuple(out.shape) == (REC_P99,), "dlrm-rm2 serve_p99 logits [512]")
        _held_to_cpu("dlrm-rm2 serve_p99", out[:REC_CPU_ROWS],
                     R.dlrm_forward(p_cpu, rc, dense[:REC_CPU_ROWS].cpu(), ids[:REC_CPU_ROWS].cpu()), REC_CPU_RTOL)
        ms = _wall_ms(lambda: R.dlrm_forward(p, rc, dense, ids))
        log(f"recsys: dlrm-rm2 serve_p99 ({REC_P99} rows): median {ms:.3f} ms ({REC_P99 / ms * 1e3:,.0f} rows/s); "
            f"peak device memory {_peak_gb(device):.2f} GB")
        profile_call(f"dlrm-rm2 serve_p99 ({REC_P99} rows)", lambda: R.dlrm_forward(p, rc, dense, ids).cpu())
        dense, ids = dlrm_batch(REC_BULK)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = R.dlrm_forward(p, rc, dense, ids)
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        check(tuple(out.shape) == (REC_BULK,) and bool(torch.isfinite(out).all()), "dlrm-rm2 serve_bulk logits")
        log(f"recsys: dlrm-rm2 serve_bulk ({REC_BULK:,} rows, one call): {ms:.1f} ms "
            f"({REC_BULK / ms * 1e3:,.0f} rows/s); peak device memory {_peak_gb(device):.2f} GB")
        # retrieval_cand: one user's features, the candidate id in field 0
        dense1, ids1 = dlrm_batch(1)

        def dlrm_chunk(lo, hi):
            sp = ids1.expand(hi - lo, -1).clone()
            sp[:, 0] = torch.arange(lo, hi, device=device, dtype=sp.dtype)
            return R.dlrm_forward(p, rc, dense1.expand(hi - lo, -1), sp)

        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        vals, top = _cand_sweep(dlrm_chunk, REC_CANDS, DLRM_CHUNK)
        top = top.cpu()
        ms = (time.perf_counter() - t0) * 1e3
        sp = ids1.cpu().expand(K, -1).clone()
        sp[:, 0] = top.to(sp.dtype)
        _held_to_cpu(f"dlrm-rm2 retrieval_cand top {K}", vals, R.dlrm_forward(p_cpu, rc, dense1.cpu().expand(K, -1), sp),
                     REC_CPU_RTOL)
        log(f"recsys: dlrm-rm2 retrieval_cand, 1 user x {REC_CANDS:,} candidates in chunks of {DLRM_CHUNK}: "
            f"{ms:.1f} ms; top {K} ids {top.tolist()}")
    del p, p_cpu, dense, ids, out
    torch.cuda.empty_cache()

    # ---- din
    rc = get_arch("din").recsys
    torch.cuda.reset_peak_memory_stats(device)
    p = R.init_din(rc, torch.Generator(device=device).manual_seed(REC_SEED + 1), device=device)
    log(f"recsys: din {rc.vocab_sizes} rows padded to {p.tables.table.shape[0]:,} x {rc.embed_dim}: "
        f"{_table_gb(p.tables):.3f} GB of tables; history {rc.hist_len}; attention MLP "
        f"{(p.attn[0].shape[0],) + rc.attn_mlp + (1,)}, top MLP {(p.top[0].shape[0],) + rc.top_mlp}")
    check(tuple(p.tables.table.shape) == (11_010_048, 18) and p.attn[0].shape[0] == 216, "din at full width")
    vocab = np.asarray(rc.vocab_sizes)

    def din_batch(n):
        target = rng.integers(0, vocab, (n, rc.n_sparse)).astype(np.int32)
        hist = rng.integers(0, vocab, (n, rc.hist_len, rc.n_sparse)).astype(np.int32)
        mask = np.arange(rc.hist_len)[None, :] < rng.integers(1, rc.hist_len + 1, n)[:, None]
        return [torch.from_numpy(a).to(device) for a in (target, hist, mask)]

    def din_chunked(t, h, m, chunk):
        return torch.cat([R.din_forward(p, rc, t[lo: lo + chunk], h[lo: lo + chunk], m[lo: lo + chunk])
                          for lo in range(0, t.shape[0], chunk)])

    p_cpu = tree_map(lambda x: x.cpu(), p)
    with torch.no_grad():
        t, h, m = din_batch(REC_P99)
        out = R.din_forward(p, rc, t, h, m)
        check(tuple(out.shape) == (REC_P99,), "din serve_p99 logits [512]")
        _held_to_cpu("din serve_p99", out[:REC_CPU_ROWS],
                     R.din_forward(p_cpu, rc, *(a[:REC_CPU_ROWS].cpu() for a in (t, h, m))), REC_CPU_RTOL)
        ms = _wall_ms(lambda: R.din_forward(p, rc, t, h, m))
        log(f"recsys: din serve_p99 ({REC_P99} rows): median {ms:.3f} ms ({REC_P99 / ms * 1e3:,.0f} rows/s); "
            f"peak device memory {_peak_gb(device):.2f} GB")
        profile_call(f"din serve_p99 ({REC_P99} rows)", lambda: R.din_forward(p, rc, t, h, m).cpu())
        t, h, m = din_batch(REC_BULK)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = din_chunked(t, h, m, DIN_BULK_CHUNK)
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        check(tuple(out.shape) == (REC_BULK,) and bool(torch.isfinite(out).all()), "din serve_bulk logits")
        _held_to_cpu("din serve_bulk (its last rows)", out[-REC_CPU_ROWS:],
                     R.din_forward(p_cpu, rc, *(a[-REC_CPU_ROWS:].cpu() for a in (t, h, m))), REC_CPU_RTOL)
        log(f"recsys: din serve_bulk ({REC_BULK:,} rows in chunks of {DIN_BULK_CHUNK:,}): {ms:.1f} ms "
            f"({REC_BULK / ms * 1e3:,.0f} rows/s); peak device memory {_peak_gb(device):.2f} GB")
        # retrieval_cand: one user's history, REC_CANDS candidate items
        _, h1, m1 = din_batch(1)
        cand = torch.from_numpy(rng.integers(0, vocab, (REC_CANDS, rc.n_sparse)).astype(np.int32)).to(device)

        def din_chunk(lo, hi):
            return R.din_forward(p, rc, cand[lo:hi], h1.expand(hi - lo, -1, -1), m1.expand(hi - lo, -1))

        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        vals, top = _cand_sweep(din_chunk, REC_CANDS, DIN_CHUNK)
        top = top.cpu()
        ms = (time.perf_counter() - t0) * 1e3
        _held_to_cpu(f"din retrieval_cand top {K}", vals,
                     R.din_forward(p_cpu, rc, cand.cpu()[top], h1.cpu().expand(K, -1, -1), m1.cpu().expand(K, -1)),
                     REC_CPU_RTOL)
        log(f"recsys: din retrieval_cand, 1 user x {REC_CANDS:,} candidates in chunks of {DIN_CHUNK}: {ms:.1f} ms")
    del p, p_cpu, t, h, m, out, cand
    torch.cuda.empty_cache()


def mind_phase(device, core_ops, sites):
    """mind at full width: serve_p99's interests (timed, held to the CPU
    port); REC_CANDS candidate items (distinct item ids, Zipf categories)
    through ``mind_item_embedding`` on the card into a dense LSP index; 64
    users' 256 interest rows through ``retrieve_dense`` in four calls of 64
    (dequant_matmul counted) against impl="ref" (recall@10 >= 0.99) and the
    exhaustive oracle; each user's four exact per-interest top-Ks merged by
    score against the top K of ``mind_score_candidates`` over every
    candidate. Returns (dequant_matmul launches, its captured calls)."""
    import numpy as np
    import torch

    from repro_torch.common.tree_utils import tree_map
    from repro_torch.configs.base import get_arch
    from repro_torch.core.config import DynamicParams, StaticConfig, combine
    from repro_torch.core.lsp_dense import DenseIndexConfig, build_dense_index, retrieve_dense, retrieve_dense_exact
    from repro_torch.eval.metrics import recall_vs_oracle
    from repro_torch.models import recsys as R

    rng = np.random.default_rng(REC_SEED + 2)
    rc = get_arch("mind").recsys
    torch.cuda.reset_peak_memory_stats(device)
    p = R.init_mind(rc, torch.Generator(device=device).manual_seed(REC_SEED + 2), device=device)
    log(f"recsys: mind {rc.vocab_sizes} rows padded to {p.tables.table.shape[0]:,} x {rc.embed_dim}: "
        f"{_table_gb(p.tables):.3f} GB of tables; {rc.n_interests} interests, {rc.capsule_iters} capsule "
        f"iterations, history {rc.hist_len}")
    check(tuple(p.tables.table.shape) == (10_100_224, 64), "mind at full width")

    def histories(n):
        items = rng.integers(0, rc.vocab_sizes[0], (n, rc.hist_len))
        cats = (rng.zipf(MIND_ZIPF, (n, rc.hist_len)) - 1) % rc.vocab_sizes[1]
        mask = np.arange(rc.hist_len)[None, :] < rng.integers(5, rc.hist_len + 1, n)[:, None]
        return (torch.from_numpy(np.stack([items, cats], -1).astype(np.int32)).to(device),
                torch.from_numpy(mask).to(device))

    with torch.no_grad():
        h, m = histories(REC_P99)
        out = R.mind_interests(p, rc, h, m)
        check(tuple(out.shape) == (REC_P99, rc.n_interests, rc.embed_dim), "mind serve_p99 interests [512, 4, 64]")
        p_cpu = tree_map(lambda x: x.cpu(), p)
        _held_to_cpu("mind serve_p99 interests", out[:REC_CPU_ROWS],
                     R.mind_interests(p_cpu, rc, h[:REC_CPU_ROWS].cpu(), m[:REC_CPU_ROWS].cpu()), REC_CPU_RTOL)
        del p_cpu
        ms = _wall_ms(lambda: R.mind_interests(p, rc, h, m))
        log(f"recsys: mind serve_p99 ({REC_P99} users' interests): median {ms:.3f} ms")

        items = rng.choice(rc.vocab_sizes[0], REC_CANDS, replace=False)
        cats = (rng.zipf(MIND_ZIPF, REC_CANDS) - 1) % rc.vocab_sizes[1]
        cand_ids = torch.from_numpy(np.stack([items, cats], 1).astype(np.int32)).to(device)
        t0 = time.perf_counter()
        cands = R.mind_item_embedding(p, rc, cand_ids)
        torch.cuda.synchronize(device)
        log(f"recsys: mind item tower over {REC_CANDS:,} candidates ({len(np.unique(cats)):,} categories, Zipf "
            f"{MIND_ZIPF}) in {(time.perf_counter() - t0) * 1e3:.1f} ms")
        hist, mask = histories(MIND_USERS)
        interests = R.mind_interests(p, rc, hist, mask)  # [64, 4, 64]
    t0 = time.perf_counter()
    didx = build_dense_index(cands, DenseIndexConfig(b=64, c=16, bits=4, kmeans_iters=4, ns_align=8), device=device)
    torch.cuda.synchronize(device)
    log(f"recsys: mind's dense index of {REC_CANDS:,} x {rc.embed_dim} built on the card in "
        f"{time.perf_counter() - t0:.1f} s: {didx.n_blocks} blocks, {didx.n_superblocks} superblocks; "
        f"{int(mask.sum())} of {mask.numel()} history slots live")
    rows = interests.reshape(-1, rc.embed_dim)
    check(rows.shape[0] == N_INTEREST_ROWS, f"{N_INTEREST_ROWS} interest rows")
    calls = [rows[i: i + BATCH] for i in range(0, N_INTEREST_ROWS, BATCH)]
    cfg = combine(StaticConfig(variant="lsp0", gamma=max(8, didx.n_superblocks // 8), gamma0=4, k_max=K),
                  DynamicParams(k=K))

    def run(impl):
        return np.concatenate([retrieve_dense(didx, q, cfg, impl=impl)[0].cpu().numpy() for q in calls])

    captured = capture(core_ops, ["dequant_matmul"], lambda: retrieve_dense(didx, calls[0], cfg))
    ids, launches, _ = counted(core_ops, lambda: run("auto"), sites)
    log(f"recsys: mind, launches during the 4 retrieve_dense calls: {launches}")
    check(launches["dequant_matmul"] > 0, "kernel dequant_matmul was never launched on mind's path")
    check(ids.shape == (N_INTEREST_ROWS, K) and ((ids >= 0) & (ids < REC_CANDS)).all(),
          "every mind interest row returns k valid candidate ids")
    rec_ref = recall_vs_oracle(ids, run("ref"))
    exact = [retrieve_dense_exact(didx, q, K) for q in calls]
    ex_ids = torch.cat([e[0] for e in exact]).cpu()
    ex_vals = torch.cat([e[1] for e in exact]).cpu()
    log(f"recsys: mind kernel path vs impl='ref': recall@10 {rec_ref:.4f}; recall@10 vs exhaustive "
        f"{recall_vs_oracle(ids, ex_ids.numpy()):.4f} (untrained weights: no threshold)")
    check(rec_ref >= 0.99, f"recall@10 of mind's kernel path against the ref path {rec_ref} < 0.99")

    # each user's four per-interest exact top-Ks, merged by score, against mind_score_candidates
    # over the candidates as the index holds them (bfloat16)
    with torch.no_grad():
        full = R.mind_score_candidates(interests, cands.to(torch.bfloat16).to(torch.float32))
        top_vals, top_ids = (t.cpu() for t in torch.topk(full, K, dim=1))
    del full
    ties = 0
    for u in range(MIND_USERS):
        best = {}
        for i, v in zip(ex_ids[u * rc.n_interests: (u + 1) * rc.n_interests].reshape(-1).tolist(),
                        ex_vals[u * rc.n_interests: (u + 1) * rc.n_interests].reshape(-1).tolist()):
            best[i] = max(v, best.get(i, -np.inf))
        merged = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))[:K]
        tol = MERGE_RTOL * float(top_vals[u].abs().max())
        for j, (i, v) in enumerate(merged):
            check(abs(v - float(top_vals[u, j])) <= tol, f"mind user {u} rank {j}: merged score {v} against "
                                                         f"mind_score_candidates' {float(top_vals[u, j])}")
            if i != int(top_ids[u, j]):
                ties += 1
    log(f"recsys: mind, each user's {rc.n_interests} exact per-interest top {K}s merged by score equal "
        f"mind_score_candidates' top {K} over all {REC_CANDS:,} for all {MIND_USERS} users (scores within "
        f"{MERGE_RTOL} x max; {ties} positions differ in id at equal score)")
    call_ms = [host_ms(lambda: retrieve_dense(didx, q, cfg)[0].cpu()) for _ in range(3) for q in calls]
    ref_ms = [host_ms(lambda: retrieve_dense(didx, q, cfg, impl="ref")[0].cpu()) for q in calls]
    exact_ms = [host_ms(lambda: retrieve_dense_exact(didx, q, K)[0].cpu()) for q in calls]
    log(f"recsys: mind retrieve_dense of {BATCH} rows: median {statistics.median(call_ms):.2f} ms over "
        f"{len(call_ms)} calls (kernel path); impl='ref' median {statistics.median(ref_ms):.2f} ms; exhaustive "
        f"median {statistics.median(exact_ms):.2f} ms; peak device memory {_peak_gb(device):.2f} GB")
    profile_call(f"mind retrieve_dense ({BATCH} rows)", lambda: retrieve_dense(didx, calls[0], cfg)[0].cpu())
    del p, didx, cands, interests
    torch.cuda.empty_cache()
    return launches["dequant_matmul"], captured["dequant_matmul"]


def gnn_phase(device):
    """schnet at full width (3 interactions, 64 hidden, 300 RBFs, cutoff 10)
    through the three GNN shapes that fit one card, each held to the CPU port
    in float32: ``molecule_batch_forward`` over the molecule shape (timed,
    profiled); ``schnet_forward`` + ``schnet_readout`` over full_graph_sm
    (``make_random_graph``) and over minibatch_lg's sampled subgraph (parent
    graph with Reddit's nodes and GNN_PARENT_EDGES edges)."""
    import numpy as np
    import torch

    from repro_torch.common.tree_utils import tree_map
    from repro_torch.configs.base import GNN_SHAPES, get_arch
    from repro_torch.data.graph import SampledSubgraph, make_random_graph, sample_subgraph
    from repro_torch.models import schnet as S

    cfg = get_arch("schnet").gnn
    rng = np.random.default_rng(GNN_SEED)
    t_phase = time.perf_counter()

    def init(in_dim, out_dim, seed):
        p = S.init_schnet(cfg, in_dim, out_dim, torch.Generator(device=device).manual_seed(seed), device=device)
        return p, tree_map(lambda x: x.cpu(), p)

    # ---- molecule: 128 graphs x 30 atoms x 64 edges, 16 atom types, an energy each
    shp = GNN_SHAPES["molecule"]
    b, n, e = shp.batch, shp.n_nodes, shp.n_edges
    p, p_cpu = init(16, 1, GNN_SEED)
    n_live = rng.integers(e // 2, e + 1, b)
    host = (np.eye(16, dtype=np.float32)[rng.integers(0, 16, (b, n))],
            (rng.standard_normal((b, n, 3)) * 1.5).astype(np.float32),
            rng.integers(0, n, (b, e)).astype(np.int32), rng.integers(0, n, (b, e)).astype(np.int32),
            np.arange(e)[None, :] < n_live[:, None])
    args = [torch.from_numpy(a).to(device) for a in host]
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        out = S.molecule_batch_forward(p, cfg, *args)
        _held_to_cpu(f"schnet molecule ({b} x {n} atoms x {e} edges) energies", out,
                     S.molecule_batch_forward(p_cpu, cfg, *(torch.from_numpy(a) for a in host)), GNN_CPU_RTOL)
        ms = _wall_ms(lambda: S.molecule_batch_forward(p, cfg, *args))
        log(f"gnn: schnet molecule_batch_forward ({b} graphs): median {ms:.3f} ms ({b / ms * 1e3:,.0f} graphs/s); "
            f"peak device memory {_peak_gb(device):.2f} GB")
        profile_call(f"schnet molecule_batch_forward ({b} graphs)",
                     lambda: S.molecule_batch_forward(p, cfg, *args).cpu())

    def node_level(label, x, es, ed, ew, em, n_out, seed, rows=None):
        p, p_cpu = init(x.shape[1], n_out, seed)
        host = (x, es, ed, ew) + (() if em is None else (em,))
        dev = [torch.from_numpy(a).to(device) for a in host]
        torch.cuda.reset_peak_memory_stats(device)
        with torch.no_grad():
            got = S.schnet_readout(p, S.schnet_forward(p, cfg, *dev))[:rows]
            want = S.schnet_readout(p_cpu, S.schnet_forward(p_cpu, cfg, *(torch.from_numpy(a) for a in host)))[:rows]
            _held_to_cpu(f"schnet {label} logits", got, want, GNN_CPU_RTOL)
            ms = _wall_ms(lambda: S.schnet_readout(p, S.schnet_forward(p, cfg, *dev)))
        log(f"gnn: schnet {label} ({x.shape[0]:,} nodes, {len(es):,} edges, {x.shape[1]} features): forward + "
            f"readout median {ms:.3f} ms; peak device memory {_peak_gb(device):.2f} GB")

    # ---- full_graph_sm: 2,708 nodes, 10,556 edges, 1,433 features, 16 classes
    shp = GNN_SHAPES["full_graph_sm"]
    g = make_random_graph(shp.n_nodes, shp.n_edges, shp.d_feat, 16, seed=GNN_SEED)
    src = np.repeat(np.arange(shp.n_nodes), np.diff(g.indptr)).astype(np.int32)
    ew = (rng.random(shp.n_edges) * 5.0).astype(np.float32)  # pseudo-distances, as sample_subgraph draws them
    node_level("full_graph_sm", g.feats, src, g.indices, ew, None, 16, GNN_SEED + 1)

    # ---- minibatch_lg: 1,024 seeds, fanout (15, 10) from a graph of Reddit's 232,965 nodes
    shp = GNN_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    g = make_random_graph(shp.n_nodes, GNN_PARENT_EDGES, 100, 16, seed=GNN_SEED + 2)
    sub = sample_subgraph(g, rng.choice(shp.n_nodes, shp.batch_nodes, replace=False), shp.fanout, rng)
    want = SampledSubgraph.shapes(shp.batch_nodes, shp.fanout, 100)
    check(sub.node_feats.shape == want["node_feats"] == (169_984, 100) and sub.edge_src.shape == (168_960,),
          "minibatch_lg subgraph shapes")
    log(f"gnn: minibatch_lg parent graph {shp.n_nodes:,} nodes x {GNN_PARENT_EDGES:,} edges (Reddit's "
        f"{shp.n_edges:,} cut) and its subgraph on the host in {time.perf_counter() - t0:.1f} s")
    node_level("minibatch_lg subgraph", sub.node_feats, sub.edge_src, sub.edge_dst, sub.edge_w, sub.edge_mask, 16,
               GNN_SEED + 3, rows=shp.batch_nodes)
    del p, args, g, sub
    torch.cuda.empty_cache()
    log(f"gnn phase {time.perf_counter() - t_phase:.1f} s")


def lm_rel_err(got, want):
    """Largest absolute error over the largest |reference| (float64 on the card)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def lm_teacher_forced(params, cfg, tokens, prompt, steps, cache_dtype):
    """The stacked prefill of tokens[:, :prompt], then ``steps`` decode steps
    fed tokens[:, prompt + i]: the float32 logits of positions prompt-1 ..
    prompt+steps-1, [B, steps + 1, V_pad]."""
    import torch

    from repro_torch.models import stacked

    logits, state = stacked.lm_prefill_stacked(params, cfg, tokens[:, :prompt], prompt + steps, cache_dtype)
    rows = [logits[:, -1].float()]
    del logits
    for i in range(steps):
        out, state = stacked.lm_decode_step_stacked(params, cfg, tokens[:, prompt + i: prompt + i + 1], state)
        rows.append(out[:, 0].float())
    return torch.stack(rows, dim=1)


def lm_decode_against_forward(label, params, cfg, tokens, prompt, steps):
    """Float32 teacher-forced decode against one forward over ``tokens``:
    every position's error within LM_F32_RTOL. Returns the decode logits."""
    import torch

    from repro_torch.models import stacked

    t0 = time.perf_counter()
    full, _ = stacked.lm_forward_stacked(params, cfg, tokens, remat=False)
    want = full[:, prompt - 1: prompt + steps].float()
    del full
    got = lm_teacher_forced(params, cfg, tokens, prompt, steps, torch.float32)
    errs = [lm_rel_err(got[:, i], want[:, i]) for i in range(steps + 1)]
    log(f"lm: {label}: prefill {tuple(tokens[:, :prompt].shape)} + {steps} teacher-forced decode steps against "
        f"one forward over {tuple(tokens.shape)}, float32: max error / max |logit| {max(errs):.3g} (prefill row "
        f"{errs[0]:.3g}; bound {LM_F32_RTOL}) in {time.perf_counter() - t0:.1f} s")
    check(max(errs) <= LM_F32_RTOL, f"{label}: decode against the forward {max(errs)} > {LM_F32_RTOL}")
    return got


def lm_card_vs_cpu(label, cfg, tokens, device):
    """The same weights (drawn on the card) forward on the card and on the
    CPU port, float32: within LM_F32_RTOL. Returns the MoE inputs the card
    run recorded ({layer's router data pointer: (params, x)})."""
    import torch

    from repro_torch.common.tree_utils import tree_map
    from repro_torch.models import ffn, stacked

    params = stacked.init_lm_stacked(cfg, torch.Generator(device=device).manual_seed(LM_SEED), device=device)
    moe_calls = []
    real = ffn.moe_ffn
    ffn.moe_ffn = lambda p, moe, x: moe_calls.append((p, moe, x)) or real(p, moe, x)
    try:
        card, _ = stacked.lm_forward_stacked(params, cfg, tokens.to(device), remat=False)
    finally:
        ffn.moe_ffn = real
    cpu_params = tree_map(lambda x: x.cpu(), params)
    t0 = time.perf_counter()
    cpu, _ = stacked.lm_forward_stacked(cpu_params, cfg, tokens.cpu(), remat=False)
    err = lm_rel_err(card.cpu(), cpu)
    log(f"lm: {label}: {cfg.n_layers} layers at full width, forward {tuple(tokens.shape)} on the card against the "
        f"CPU port on the same weights, float32: max error / max |logit| {err:.3g} (bound {LM_F32_RTOL}; CPU "
        f"{time.perf_counter() - t0:.1f} s)")
    check(err <= LM_F32_RTOL, f"{label}: card against CPU {err} > {LM_F32_RTOL}")
    return params, moe_calls


def moe_dropped(p, moe, x):
    """(choices dropped at the capacity, choices, capacity) of one moe_ffn call."""
    import torch

    from repro_torch.core.topk import stable_topk

    s = x.shape[1]
    cap = max(1, int(s * moe.top_k * moe.capacity_factor / moe.n_experts))
    probs = torch.softmax((x @ p.router).float(), dim=-1)
    _, idx = stable_topk(probs, moe.top_k)  # [B, S, k]
    onehot = torch.nn.functional.one_hot(idx, moe.n_experts).reshape(x.shape[0], -1, moe.n_experts)
    ahead = torch.cumsum(onehot, dim=1) - onehot  # the moe_ffn queue position of each choice
    return int(((ahead >= cap) & (onehot > 0)).sum()), int(onehot.sum()), cap


def lm_serve(label, params, cfg, batch, prompt, steps, device, seed):
    """bf16 serving: one prefill of [batch, prompt] (ms), then ``steps``
    greedy decode steps (argmax over the first vocab columns) on the cache it
    wrote (ms a step; the first step untimed, the last two profiled), with
    the step's bandwidth floor."""
    import numpy as np
    import torch

    from repro_torch.common.tree_utils import param_bytes, tree_leaves
    from repro_torch.data.pipeline import lm_synthetic_batch
    from repro_torch.models import stacked

    toks = torch.from_numpy(lm_synthetic_batch(cfg.vocab, batch, prompt)(np.random.default_rng(seed), 0)["tokens"])
    toks = toks.to(device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logits, state = stacked.lm_prefill_stacked(params, cfg, toks, prompt + steps, torch.bfloat16)
    tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
    torch.cuda.synchronize(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del logits
    box = {"state": state, "tok": tok}

    def step():
        out, box["state"] = stacked.lm_decode_step_stacked(params, cfg, box["tok"], box["state"])
        box["tok"] = out[:, -1, :cfg.vocab].argmax(-1, keepdim=True)

    step()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps - 3):
        step()
    torch.cuda.synchronize(device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / (steps - 3)
    profile_call(f"{label} decode step (batch {batch})", lambda: (step(), box["tok"].cpu()))
    check(int(box["state"].pos) == prompt + steps, f"{label}: {steps} decode steps after the prefill")
    state = box["state"]
    kv_bytes = sum(x.numel() * x.element_size() for x in tree_leaves((state.caches, state.tail_caches)))
    floor_ms = (param_bytes(params) + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"lm: {label}, bf16: prefill {batch} x {prompt} in {prefill_ms:.1f} ms "
        f"({batch * prompt / prefill_ms * 1e3:,.0f} tokens/s); decode {decode_ms:.2f} ms a step over {steps - 3} steps ({batch / decode_ms * 1e3:,.1f} tokens/s) "
        f"at a {prompt + steps}-token cache; bandwidth floor of a step {floor_ms:.3f} ms (bf16 weights "
        f"{param_bytes(params) / 1e9:.2f} GB + KV {kv_bytes / 1e9:.2f} GB over {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def lm_phase(device):
    """Decoder-only LM serving through the stacked path, the weights drawn on
    the card from a seeded CUDA generator, each model freed before the next:
    (a) qwen3-4b at full width and depth: float32 teacher-forced decode
    against the forward, the same in bf16 against float32, the 2-layer cut
    against the CPU port, and bf16 serving (4 x 4,096 prefill, 128 greedy
    decode steps, a 1 x 32,768 prefill); (b) gemma3-27b cut to 6 layers, the
    ring buffer of its sliding-window layers wrapping and rolling, against the
    forward; (c) phi3.5-moe cut to 2 layers against the CPU port, its dropped
    choices counted, then bf16 serving."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.common.tree_utils import param_count, tree_cast
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import lm_synthetic_batch
    from repro_torch.models import stacked
    from repro_torch.models.transformer import padded_vocab

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with torch.inference_mode():
        # ---- a. qwen3-4b, full width and depth
        qwen = get_arch("qwen3-4b").lm
        t0 = time.perf_counter()
        params = stacked.init_lm_stacked(qwen, torch.Generator(device=device).manual_seed(LM_SEED), device=device)
        torch.cuda.synchronize(device)
        n_params = param_count(params)
        log(f"lm: qwen3-4b {qwen}: {n_params:,} parameters, float32, drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        check(n_params == QWEN_PARAMS, f"qwen3-4b has {n_params} parameters, not {QWEN_PARAMS}")
        toks = lm_synthetic_batch(qwen.vocab, 2, LM_SEQ)(np.random.default_rng(LM_SEED), 0)["tokens"]
        toks = torch.from_numpy(toks).to(device)
        f32 = lm_decode_against_forward("qwen3-4b", params, qwen, toks, LM_PROMPT, LM_STEPS)
        low = tree_cast(params, torch.bfloat16)
        del params
        torch.cuda.empty_cache()
        bf16 = lm_teacher_forced(low, qwen, toks, LM_PROMPT, LM_STEPS, torch.bfloat16)
        d32, d16 = f32[:, 1:, :qwen.vocab], bf16[:, 1:, :qwen.vocab]
        gap = float((d16.double() - d32.double()).norm() / d32.double().norm())
        same = float((d16.argmax(-1) == d32.argmax(-1)).float().mean())
        log(f"lm: qwen3-4b bf16 weights and cache against float32, the {LM_STEPS} teacher-forced decode steps: "
            f"relative error norm {gap:.5f} (bound {LM_BF16_GAP}: twice JAX's own gap, tests/lm_bf16_gap.py); "
            f"greedy tokens equal to float32's {same:.4f}")
        check(gap <= LM_BF16_GAP, f"qwen3-4b bf16 against float32 {gap} > {LM_BF16_GAP}")
        del f32, bf16, d32, d16

        torch.cuda.reset_peak_memory_stats(device)
        lm_serve("qwen3-4b", low, qwen, LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_STEPS, device, 1)
        long = torch.from_numpy(lm_synthetic_batch(qwen.vocab, 1, LM_LONG)(np.random.default_rng(2), 0)["tokens"])
        long = long.to(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits, state = stacked.lm_prefill_stacked(low, qwen, long, LM_LONG, torch.bfloat16)
        last = logits[:, -1, :qwen.vocab].float()  # the cell's serve output: the last row
        torch.cuda.synchronize(device)
        long_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        check(bool(torch.isfinite(last).all()) and tuple(logits.shape) == (1, LM_LONG, padded_vocab(qwen)),
              "qwen3-4b 1 x 32,768 prefill: finite logits of the padded vocab's width")
        log(f"lm: qwen3-4b bf16 prefill 1 x {LM_LONG} (attention blocks 2048 x 1024) in {long_ms:.1f} ms "
            f"({LM_LONG / long_ms * 1e3:,.0f} tokens/s); logits {logits.numel() * logits.element_size() / 1e9:.2f} GB, "
            f"KV {sum(c.k.numel() * 2 * c.k.element_size() for c in state.caches) / 1e9:.2f} GB; peak device "
            f"memory since the 4 x {LM_SERVE_PROMPT} prefill {peak:.2f} GB")
        del logits, state, last, low
        torch.cuda.empty_cache()
        lm_card_vs_cpu("qwen3-4b", dataclasses.replace(qwen, n_layers=2),
                       torch.from_numpy(toks[:1, :LM_CPU_TOKENS].cpu().numpy()), device)
        torch.cuda.empty_cache()

        # ---- b. gemma3-27b, 6 layers: 5 sliding-window (1,024) and 1 global
        gemma = dataclasses.replace(get_arch("gemma3-27b").lm, n_layers=LM_GEMMA_LAYERS)
        params = stacked.init_lm_stacked(gemma, torch.Generator(device=device).manual_seed(LM_SEED), device=device)
        log(f"lm: gemma3-27b cut to {gemma.n_layers} layers: {param_count(params):,} parameters, float32")
        toks = lm_synthetic_batch(gemma.vocab, 2, LM_GEMMA_SEQ)(np.random.default_rng(3), 0)["tokens"]
        lm_decode_against_forward("gemma3-27b ring buffer", params, gemma, torch.from_numpy(toks).to(device),
                                  LM_GEMMA_PROMPT, LM_STEPS)
        del params
        torch.cuda.empty_cache()

        # ---- c. phi3.5-moe, 2 MoE layers: 16 experts, top 2
        phi = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b").lm, n_layers=LM_PHI_LAYERS)
        toks = lm_synthetic_batch(phi.vocab, 1, LM_PHI_TOKENS)(np.random.default_rng(4), 0)["tokens"]
        params, moe_calls = lm_card_vs_cpu("phi3.5-moe", phi, torch.from_numpy(toks), device)
        log(f"lm: phi3.5-moe: {param_count(params):,} parameters; " + "; ".join(
            "layer {}: {} of {} choices dropped at a capacity of {} per expert".format(i, *moe_dropped(*c))
            for i, c in enumerate(moe_calls)))
        check(len(moe_calls) == LM_PHI_LAYERS, "phi3.5-moe: every layer ran moe_ffn")
        low = tree_cast(params, torch.bfloat16)
        del params
        torch.cuda.empty_cache()
        lm_serve("phi3.5-moe", low, phi, LM_SERVE_BATCH, LM_PHI_PROMPT, LM_PHI_STEPS, device, 5)
        del low
    torch.cuda.empty_cache()
    log(f"lm phase {time.perf_counter() - t_phase:.1f} s")


def _launcher_follower(rank, world, store, argv, device, results):
    """A follower rank of the serving launcher's process group (gloo, the
    card shared): the launcher's own job, which follows rank 0's front end
    until its shutdown."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.launch.serve import parse_args, serve_job

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        check(serve_job(parse_args(argv), group=dist.group.WORLD) is None, "a follower returns nothing")
        dist.barrier()
        results.put((rank, None))
    except BaseException:  # sent to the parent, then raised
        results.put((rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def launcher_group_run(argv, corpus, device, tmp):
    """The launcher's job over a process group of LAUNCH_SHARDS gloo ranks
    on the card: this process is rank 0 (the engine and the front end), the
    other ranks are spawned and follow it. A rank that fails or sends
    nothing within RANK_TIMEOUT_S fails the run. Returns (rank 0's run,
    what it printed)."""
    import multiprocessing as mp
    import queue
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.launch.serve import parse_args, serve_job

    store = os.path.join(tmp, "launch_group_store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_launcher_follower, args=(r, LAUNCH_SHARDS, store, argv, device, results))
             for r in range(1, LAUNCH_SHARDS)]
    for p in procs:
        p.start()
    errors = []
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=LAUNCH_SHARDS, rank=0,
                                timeout=timedelta(seconds=RANK_TIMEOUT_S))
        try:
            run, printed = _quiet(lambda: serve_job(parse_args(argv), corpus=corpus, group=dist.group.WORLD))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        for _ in procs:  # drain the queue before joining
            try:
                rank, err = results.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"a follower sent nothing within {RANK_TIMEOUT_S} s")
                break
            if err is not None:
                errors.append(f"follower {rank} failed:\n{err}")
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S if not errors else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    check(not errors, "; ".join(errors))
    check(all(p.exitcode == 0 for p in procs), f"follower exit codes {[p.exitcode for p in procs]}")
    return run, printed


def _quiet(fn):
    """(fn(), what it printed); the printed lines go to the log too."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    for line in buf.getvalue().splitlines():
        log(f"  {line}")
    return out, buf.getvalue()


def _served_as(resp, t, w, requested, params, ladder, nq_max):
    """The request exactly as the engine served it: at the point it served
    (``params_served``) and, when the SLO controller degraded it, cut to the
    query terms of the rung whose point that is."""
    from repro_torch.api import SearchRequest
    from repro_torch.core.config import DynamicParams
    from repro_torch.core.query import canonical_query

    cap = 0
    if resp.degraded:
        base = requested or params
        rung = next(r for r in ladder[1:] if DynamicParams(
            k=min(base.k, r.params.k), mu=min(base.mu, r.params.mu), eta=min(base.eta, r.params.eta),
            beta=min(base.beta, r.params.beta)) == resp.params_served)
        cap = rung.nq_cap
    t, w = canonical_query(t, w, min(cap, nq_max) if cap else nq_max)
    return SearchRequest(t, w, params=resp.params_served)


def launcher_phase(device, core_ops, tmp):
    """The serving launcher (``python -m repro_torch.launch.serve``'s job) at
    the smoke's corpus size with its own 32 topics: a first start builds the
    index on the card and saves it; a second start mmap-loads it and serves
    LAUNCH_REQUESTS requests with a hot swap to a rebuilt index mid-run, the
    k sweep 1, 5, 10 and the SLO flags (every kernel's launches counted),
    every response equal to a pinned impl="ref" retriever over the index its
    epoch served, at the point and terms it was served; then 3 shards cut
    from the first index, served by the launcher through the host loop and
    through 3 gloo ranks behind the rank-0 front end, both equal to the
    single index's kernel path. Returns (launches, captured calls) of the
    second start."""
    import re

    import numpy as np

    from repro_torch.api import Retriever, SearchRequest
    from repro_torch.core.config import DynamicParams
    from repro_torch.data.synthetic import CorpusConfig, make_corpus
    from repro_torch.index.store import save_sharded_index
    from repro_torch.launch import serve
    from repro_torch.serve.errors import DeadlineExceeded
    from repro_torch.serve.slo import default_degradation_ladder

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    corpus = make_corpus(CorpusConfig(n_docs=N_DOCS, vocab=VOCAB, n_topics=serve.N_TOPICS, seed=0))
    log(f"launcher: corpus of {N_DOCS} docs, vocab {VOCAB}, {serve.N_TOPICS} topics, {len(corpus.tids)} postings "
        f"(host, {time.perf_counter() - t0:.1f} s)")
    base = ["--n-docs", str(N_DOCS), "--vocab", str(VOCAB), "--requests", str(LAUNCH_REQUESTS), "--device", str(device)]
    single_dir = os.path.join(tmp, "launch_single")

    # ---- a. the first start: build on the card, save
    t0 = time.perf_counter()
    first, _ = _quiet(lambda: serve.serve_job(serve.parse_args(base + ["--index-dir", single_dir]), corpus=corpus))
    log(f"launcher start 1 (build and save) in {time.perf_counter() - t0:.1f} s")
    check(first.summary["failures"] == 0 and first.summary["requests"] == LAUNCH_REQUESTS, "launcher start 1 served")

    # ---- b. the second start: mmap-load, swap mid-run, sweep, SLO flags; the main path, counted
    argv = base + ["--index-dir", single_dir, "--swap-mid-run", "--sweep-k", "1,5,10"] + LAUNCH_SLO
    log("launcher start 2: " + " ".join(argv))
    fns = {name: getattr(core_ops, attr) for name, (attr, _, _) in KERNELS.items()}
    for fn in fns.values():
        fn.launches = 0
    box = {}
    t0 = time.perf_counter()
    captured = capture(core_ops, ["sbmax", "boundsum_gather", "doc_score_fwd"], lambda: box.update(zip(
        ("run", "printed"), _quiet(lambda: serve.serve_job(serve.parse_args(argv), corpus=corpus)))))
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    run, printed = box["run"], box["printed"]
    log(f"launcher start 2 in {wall_s:.1f} s; launches {launches}")
    for key in ("sbmax", "boundsum_gather", "doc_score_fwd"):
        check(launches[key] > 0, f"kernel {key} was never launched on the serving launcher's path")
    s = run.summary
    mmap_s = float(re.search(r"mmap-loaded index .* in ([0-9.]+)s", printed).group(1))
    check(run.recompiles == 0, f"recompiles {run.recompiles}")
    check(s["failures"] == 0 and s["swaps"] == 1, f"launcher start 2: failures {s['failures']}, swaps {s['swaps']}")
    n_sweep = 3 * LAUNCH_REQUESTS
    check(len(run.responses) == LAUNCH_REQUESTS and len(run.sweep) == n_sweep, "every request answered")
    shed = sum(isinstance(r, DeadlineExceeded) for r in run.responses + run.sweep)
    check(shed == 0 and s["deadline_expired"] == 0, f"{shed} requests shed at a 60 s deadline")
    half = LAUNCH_REQUESTS // 2
    epochs = [r.epoch for r in run.responses]
    check(set(epochs[:half]) <= {0, 1} and set(epochs[half:]) == {1} and {r.epoch for r in run.sweep} == {1},
          "a request submitted after the swap was served by the old index (stale)")
    # every response against impl="ref" over the index its epoch served, at the point and terms it was served
    ladder = default_degradation_ladder(run.params, nq_max=ENGINE_NQ)
    refs = [Retriever.from_index(ix, run.static_cfg, params=run.params, impl="ref", device=device)
            for ix in (run.index, run.swapped)]
    requested = [None] * LAUNCH_REQUESTS + [DynamicParams(k=k, beta=run.params.beta) for k in (1, 5, 10)
                                            for _ in range(LAUNCH_REQUESTS)]
    mismatched = 0
    for resp, (t, w), req in zip(run.responses + run.sweep, run.queries * 4, requested):
        want = refs[resp.epoch].search(_served_as(resp, t, w, req, run.params, ladder, ENGINE_NQ))
        mismatched += not (np.array_equal(resp.doc_ids, want.doc_ids) and resp.theta == want.theta
                           and (resp.n_superblocks_visited, resp.n_blocks_scored)
                           == (want.n_superblocks_visited, want.n_blocks_scored))
    log(f"launcher start 2: {LAUNCH_REQUESTS} requests + {n_sweep} of the sweep against impl='ref' over the index "
        f"each epoch served: {mismatched} differ in ids, theta or counters; {s['degraded']} degraded by the SLO "
        f"controller (compared at the point and terms served); epochs of the first half {sorted(set(epochs[:half]))}")
    check(mismatched == 0, f"launcher start 2: {mismatched} responses differ from impl='ref'")
    log(f"launcher at {N_DOCS} docs: mmap-load {mmap_s:.3f} s, swap {s['last_swap_ms']:.1f} ms (warm and flip; the "
        f"rebuild before it excluded), {s['requests']} requests in {s['batches']} batches, p50 {s['p50_ms']:.2f} ms "
        f"p99 {s['p99_ms']:.2f} ms ({LAUNCH_REQUESTS} submitted at once, then the sweep's {n_sweep}: queueing "
        f"included), cache hit rate {s['cache_hit_rate']:.3f}")
    del refs, run

    # ---- c. 3 shards of the first index: the host loop, and 3 ranks behind the rank-0 front end
    sharded_dir = os.path.join(tmp, "launch_sharded")
    t0 = time.perf_counter()
    save_sharded_index(sharded_dir, first.index, LAUNCH_SHARDS)
    log(f"launcher: the first index cut into {LAUNCH_SHARDS} shards and saved in {time.perf_counter() - t0:.1f} s")
    single = Retriever.from_index(first.index, first.static_cfg, params=first.params, device=device)
    want = single.search_batch([SearchRequest(t, w) for t, w in first.queries])
    want += [r for k in (1, 5, 10) for r in single.search_batch(
        [SearchRequest(t, w, params=DynamicParams(k=k, beta=first.params.beta)) for t, w in first.queries])]
    del first, single
    shard_argv = base + ["--shards", str(LAUNCH_SHARDS), "--index-dir", sharded_dir, "--sweep-k", "1,5,10"]
    starts = {}
    t0 = time.perf_counter()
    starts["host loop"], _ = _quiet(lambda: serve.serve_job(serve.parse_args(shard_argv), corpus=corpus))
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    starts["3-rank front end"], group_printed = launcher_group_run(shard_argv, corpus, device, tmp)
    group_s = time.perf_counter() - t0
    check("shard_map transport" in group_printed, "the 3-rank start served through the front end")
    for label, got in starts.items():
        check(got.summary["failures"] == 0 and got.recompiles == 0, f"launcher {label}: failures or recompiles")
        for i, (g, w) in enumerate(zip(got.responses + got.sweep, want)):
            _same_ids_theta_counters(g, w, f"launcher {label}, request {i}")
        log(f"launcher --shards {LAUNCH_SHARDS}, {label}: {len(got.responses) + len(got.sweep)} responses equal to "
            f"the single index's on ids, theta and counters; p50 {got.summary['p50_ms']:.2f} ms p99 "
            f"{got.summary['p99_ms']:.2f} ms; the start {host_s if label == 'host loop' else group_s:.1f} s")
    log(f"launcher phase {time.perf_counter() - t_phase:.1f} s")
    mid = len(captured["doc_score_fwd"]) // 4 * 2  # a round-0 call and the phase-3 call after it, mid-run
    return launches, {"sbmax": captured["sbmax"][len(captured["sbmax"]) // 2:][:1],
                      "boundsum_gather": captured["boundsum_gather"][len(captured["boundsum_gather"]) // 2:][:1],
                      "doc_score_fwd": captured["doc_score_fwd"][mid: mid + 2]}


def lm_train_phase(device):
    """LM training through the launcher's --arch job on the card: qwen3-4b
    at full width and depth (bf16 compute, Adafactor) with falling ce, its
    step time, peak memory, kernels a step and floor; its 2-layer cut in
    float32, card against CPU after 2 steps, and a checkpoint at step 2
    resumed to 4 against the straight run; phi3.5-moe at 2 layers, 3 bf16
    steps with its dropped expert choices; one step under
    torch.use_deterministic_algorithms(True), twice from one state, to the
    bit."""
    import numpy as np
    import torch

    from repro_torch.common.tree_utils import flatten_with_paths, param_count, tree_cast, tree_map
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import CounterPipeline, PipelineConfig, lm_synthetic_batch
    from repro_torch.launch.train import lm_job
    from repro_torch.models import ffn, stacked
    from repro_torch.optim import Adafactor
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()

    # ---- a. qwen3-4b, full width and depth, through lm_job
    torch.cuda.reset_peak_memory_stats(device)
    cfg, trainer, pipe = lm_job(TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, device=device)
    t0 = time.perf_counter()
    state = trainer.init_or_restore()
    torch.cuda.synchronize(device)
    n_params = param_count(state.params)
    check(n_params == QWEN_PARAMS, f"{TRAIN_ARCH} has {n_params} parameters")
    log(f"train: {TRAIN_ARCH} {cfg}; {n_params:,} parameters drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"Adafactor lr 1e-3, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, bf16 compute over float32 "
        f"masters, remat per group")
    ces, stamps = [], []

    def on_step(step, metrics):
        ces.append(float(metrics["ce"]))  # waits for the step
        stamps.append(time.perf_counter())

    resident_gb = torch.cuda.memory_allocated(device) / 1e9
    state = trainer.run(state, pipe, TRAIN_STEPS, log_every=0, on_step=on_step)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    step_s = statistics.median(b - a for a, b in zip(stamps[TRAIN_WARMUP:], stamps[TRAIN_WARMUP + 1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens  # model FLOPs; remat runs a second forward, so 8·N·tokens are executed
    products_ms = 8 * n_params * tokens / BF16_FLOP_PER_S * 1e3
    adafactor_ms = 12 * n_params / HBM_BYTES_PER_S * 1e3
    first, last = float(np.mean(ces[:5])), float(np.mean(ces[-5:]))
    log(f"train {TRAIN_ARCH}: ce first 5 steps {first:.4f}, last 5 {last:.4f} (ln V = {np.log(cfg.vocab):.4f}); "
        f"every step: {[round(c, 3) for c in ces]}")
    batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(TRAIN_STEPS).items()}
    prof = profile_call(f"{TRAIN_ARCH} train step", lambda: float(trainer.step_fn(state, batch)[1]["ce"]))
    log(f"train {TRAIN_ARCH} step: median {step_s * 1e3:.1f} ms (steps {TRAIN_WARMUP + 2}-{TRAIN_STEPS}, host clock, "
        f"each ends in a read of ce), {tokens / step_s:,.0f} tokens/s, {flops / 1e12:.2f} model TFLOP a step "
        f"(6·N·tokens; remat runs a second forward, 8·N·tokens executed) -> {flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{flops / step_s / BF16_FLOP_PER_S:.3f} of the dense bf16 peak; floor {products_ms + adafactor_ms:.1f} ms = "
        f"products 8·N·tokens at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s {products_ms:.1f} ms + Adafactor's 12·N bytes "
        f"(read p and g, write p) at {HBM_BYTES_PER_S / 1e12:.2f} TB/s {adafactor_ms:.1f} ms; "
        + (f"{prof['kernels']} kernels a step, idle share {prof['idle']:.3f}; " if prof else "")
        + f"peak device memory {peak_gb:.2f} GB ({resident_gb:.2f} GB of it allocated before the first step)")
    check(last < first, f"{TRAIN_ARCH}: ce does not fall: first 5 steps {first}, last 5 {last}")
    check(bool(np.isfinite(ces).all()), f"{TRAIN_ARCH}: a step's ce is not finite")
    del trainer, state, batch
    torch.cuda.empty_cache()

    def make_trainer(c, init, dtype, ckpt_dir=""):
        return Trainer(lambda p, b: stacked.lm_loss_stacked(p, c, b["tokens"], b["labels"], remat=True),
                       Adafactor(lr=1e-3), TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2, ckpt_async=False,
                                                         compute_dtype=dtype), init)

    # ---- b. the 2-layer cut in float32: card against CPU after 2 steps; a checkpoint at 2 resumed to 4
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    base = stacked.init_lm_stacked(cut, torch.Generator(device=device).manual_seed(LM_SEED), device=device)
    small = CounterPipeline(PipelineConfig(global_batch=TRAIN_CPU_BATCH),
                            lm_synthetic_batch(cut.vocab, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ))
    losses = {}

    def run(dev, steps, ckpt_dir="", start=None):
        t = make_trainer(cut, lambda: tree_map(lambda x: x.to(dev, copy=True), base), torch.float32, ckpt_dir)
        st = t.init_or_restore() if start is None else start
        losses[dev.type] = []
        return t.run(st, small, steps, log_every=0, on_step=lambda i, m: losses[dev.type].append(float(m["loss"])))

    card2 = run(device, 2)
    t0 = time.perf_counter()
    cpu2 = run(torch.device("cpu"), 2)
    cpu_s = time.perf_counter() - t0
    a, b = flatten_with_paths(card2), flatten_with_paths(cpu2)
    errs = {k: float((a[k].cpu().double() - b[k].double()).norm() / b[k].double().norm().clamp_min(1e-30))
            for k in b if b[k].is_floating_point() and b[k].numel()}
    worst = max(errs, key=errs.get)
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(losses[device.type], losses["cpu"]))
    log(f"train {TRAIN_ARCH} cut to {cut.n_layers} layers ({param_count(base):,} parameters), float32, "
        f"{TRAIN_CPU_BATCH} x {TRAIN_CPU_SEQ} tokens, 2 Adafactor steps, card against CPU: loss {losses[device.type]} "
        f"vs {losses['cpu']} (largest relative difference {loss_err:.3g}); largest per-leaf relative error norm "
        f"{errs[worst]:.3g} in {worst} over {len(errs)} leaves (bound {TRAIN_CPU_RTOL}; CPU {cpu_s:.1f} s)")
    check(loss_err <= TRAIN_CPU_RTOL and errs[worst] <= TRAIN_CPU_RTOL, f"{TRAIN_ARCH} cut: card against CPU")
    del cpu2
    straight = run(device, 2, start=card2)
    tmp = tempfile.mkdtemp()
    try:
        ck = os.path.join(tmp, "ckpt")
        run(device, 2, ckpt_dir=ck)
        t0 = time.perf_counter()
        restored = make_trainer(cut, lambda: tree_map(lambda x: x.clone(), base), torch.float32,
                                ck).init_or_restore()
        restore_s = time.perf_counter() - t0
        check(int(restored.step) == 2, f"restored step {int(restored.step)}")
        resumed = run(device, 2, start=restored)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = flatten_with_paths(straight), flatten_with_paths(resumed)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    log(f"train {TRAIN_ARCH} cut: checkpoint at step 2 restored in a fresh Trainer in {restore_s:.1f} s and run to "
        f"4: {len(a) - len(differ)} of {len(a)} leaves equal to the straight run to the bit")
    check(not differ, f"the resumed run differs from the straight run in {differ[:5]}")
    del base, card2, straight, restored, resumed
    torch.cuda.empty_cache()

    # ---- c. phi3.5-moe at 2 layers, bf16: falling loss, dropped choices; the determinism probe
    phi = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b").lm, n_layers=LM_PHI_LAYERS)
    t = make_trainer(phi, lambda: stacked.init_lm_stacked(phi, torch.Generator(device=device).manual_seed(LM_SEED),
                                                          device=device), torch.bfloat16)
    phi_pipe = CounterPipeline(PipelineConfig(global_batch=TRAIN_BATCH),
                               lm_synthetic_batch(phi.vocab, TRAIN_BATCH, TRAIN_SEQ))
    held = {k: torch.from_numpy(v).to(device) for k, v in phi_pipe.batch_at(0).items()}

    def held_ce(params):  # the loss of batch 0 at the bf16 compute of a step: the same batch before and after
        with torch.no_grad():
            return float(stacked.lm_loss_stacked(tree_cast(params, torch.bfloat16), phi, held["tokens"],
                                                 held["labels"], remat=False)[1]["ce"])

    calls, real = [], ffn.moe_ffn
    ffn.moe_ffn = lambda p, moe, x: calls.append((p, moe, x)) or real(p, moe, x)
    phi_ce = []
    try:
        st = t.init_or_restore()
        ce_before = held_ce(st.params)
        calls.clear()
        st = t.run(st, phi_pipe, 1, log_every=0, on_step=lambda i, m: phi_ce.append(float(m["ce"])))
    finally:
        ffn.moe_ffn = real
    dropped = [moe_dropped(*c) for c in calls[:phi.n_layers]]  # the forward's calls (remat repeats them)
    del calls
    st = t.run(st, phi_pipe, TRAIN_PHI_STEPS - 1, log_every=0, on_step=lambda i, m: phi_ce.append(float(m["ce"])))
    ce_after = held_ce(st.params)
    log(f"train phi3.5-moe cut to {phi.n_layers} layers ({param_count(st.params):,} parameters), bf16, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: ce of the steps {phi_ce}; ce of batch 0 before {ce_before:.5f}, after "
        f"{TRAIN_PHI_STEPS} steps {ce_after:.5f}; first step: " + "; ".join(
            "layer {}: {} of {} choices dropped at a capacity of {} per expert".format(i, *d)
            for i, d in enumerate(dropped)))
    check(bool(np.isfinite(phi_ce).all()) and ce_after < ce_before,
          f"phi3.5-moe: ce {phi_ce} not finite, or batch 0's ce {ce_before} -> {ce_after} does not fall")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    batch = {k: torch.from_numpy(v).to(device) for k, v in phi_pipe.batch_at(TRAIN_PHI_STEPS).items()}
    start = tree_map(lambda x: x.to("cpu", copy=True), st)  # on the host: one state on the card at a time
    outs = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            tree_map(lambda d, h: d.copy_(h), st, start)  # the step updates the state in place
            out, _ = t.step_fn(st, batch)
            outs.append({k: v.to("cpu", copy=True) for k, v in flatten_with_paths(out).items()})
            del out
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    log(f"train determinism probe: a phi3.5-moe step under use_deterministic_algorithms(True), twice from one "
        f"state: {len(outs[0]) - len(differ)} of {len(outs[0])} leaves equal to the bit; peak device memory of the "
        f"phase {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    check(not differ, f"two deterministic steps differ in {differ[:5]}")
    del t, st, outs, start
    torch.cuda.empty_cache()
    log(f"lm training phase {time.perf_counter() - t_phase:.1f} s")


def _draw(shape, seed, device, positive=False):
    """A leaf drawn whole from a CUDA generator seeded with ``seed``:
    any rank can draw any leaf again and get the same bits."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    if positive:
        return torch.rand(shape, generator=gen, device=device)
    return torch.randn(shape, generator=gen, device=device).mul_(0.02)


def _dist_state(cfg, mesh, device, seed0):
    """qwen3's stacked params and Adafactor moments, each leaf drawn whole on
    this rank from its own seed and cut to this rank's shard under the
    rules' placement on ``mesh`` (tests/test_torch_distributed.py holds the
    index maps at qwen3-4b's full shapes against JAX's). Returns (meta state,
    shards, placements, this rank's bytes, the whole's bytes, seconds by
    stage)."""
    import torch

    from repro_torch.common.tree_utils import flatten_with_paths, tree_map
    from repro_torch.models import stacked
    from repro_torch.optim.adafactor import Adafactor

    params = stacked.init_lm_stacked(cfg, device="meta")
    meta = {"params": params, "moments": Adafactor().init(params).moments}
    placements = _dist_placements(meta, mesh)
    flat_p = flatten_with_paths(placements)
    local, local_bytes, whole_bytes, stage_s = [], 0, 0, {"draw": 0.0, "shard": 0.0}

    def timed(stage, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize(device)
        stage_s[stage] += time.perf_counter() - t0
        return r

    for i, (path, leaf) in enumerate(flatten_with_paths(meta).items()):
        full = timed("draw", lambda: _draw(leaf.shape, seed0 + i, device, positive=path.startswith("moments")))
        piece = timed("shard", lambda: flat_p[path].shard(full))
        local.append(piece)
        local_bytes += piece.numel() * piece.element_size()
        whole_bytes += full.numel() * full.element_size()
        del full
    it = iter(local)
    return meta, tree_map(lambda _: next(it), meta), placements, local_bytes, whole_bytes, stage_s


def _dist_placements(meta, mesh):
    from repro_torch.common.tree_utils import tree_map
    from repro_torch.distributed.sharding import NamedSharding, adafactor_state_specs, stacked_lm_param_specs

    specs = stacked_lm_param_specs(meta["params"], mesh, fsdp=True, kv_shard=False)
    specs = {"params": specs, "moments": adafactor_state_specs(specs)}
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def _dist_equal_redrawn(meta, shards, placements, device, seed0, what):
    """Every shard equal to its slice of the leaf drawn again from its seed."""
    import torch

    from repro_torch.common.tree_utils import flatten_with_paths

    flat_s, flat_p = flatten_with_paths(shards), flatten_with_paths(placements)
    for i, (path, leaf) in enumerate(flatten_with_paths(meta).items()):
        full = _draw(leaf.shape, seed0 + i, device, positive=path.startswith("moments"))
        check(torch.equal(flat_s[path], flat_p[path].local_slice(full)), f"{what}: {path} differs from its slice")
        del full
    return len(flat_s)


def _dist_lm(device, ckpt_dir, report):
    """qwen3-4b placed on (data 2, model 2), resharded to (data 1, model 4),
    a sample gathered on rank 0; its cut checkpointed from the first mesh and
    restored onto the second."""
    import dataclasses
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.common.tree_utils import flatten_with_paths, tree_map
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.mesh import DeviceMesh, make_host_mesh
    from repro_torch.train.elastic import reshard_state

    cfg = get_arch("qwen3-4b").lm
    mesh_a = make_host_mesh(model=DIST_MESH_A[0][1], device=device)
    mesh_b = DeviceMesh(*DIST_MESH_B, device=device)
    out = {}
    t0 = time.perf_counter()
    meta, on_a, place_a, out["rank_bytes"], out["whole_bytes"], out["place_stages"] = _dist_state(
        cfg, mesh_a, device, DIST_SEED)
    out["n_params"] = sum(x.numel() for x in flatten_with_paths(meta["params"]).values())
    torch.cuda.synchronize(device)
    out["place_s"] = time.perf_counter() - t0
    out["reserved_gb"] = torch.cuda.max_memory_reserved(device) / 1e9
    out["rank_param_bytes"] = sum(x.numel() * x.element_size() for x in flatten_with_paths(on_a["params"]).values())
    report("placed")

    place_b = _dist_placements(meta, mesh_b)
    dist.barrier()
    t0 = time.perf_counter()
    on_b = reshard_state(on_a, place_b, place_a)
    torch.cuda.synchronize(device)
    dist.barrier()
    out["reshard_s"] = time.perf_counter() - t0
    del on_a
    out["resharded_leaves"] = _dist_equal_redrawn(meta, on_b, place_b, device, DIST_SEED, "resharded")
    flat_b, flat_pb = flatten_with_paths(on_b), flatten_with_paths(place_b)
    seeds = {path: DIST_SEED + i for i, path in enumerate(flatten_with_paths(meta))}
    t0, out["gathered_bytes"] = time.perf_counter(), 0
    for path in DIST_GATHERED:
        whole = flat_pb[path].gather(flat_b[path], dst=0)
        if dist.get_rank() == 0:
            want = _draw(whole.shape, seeds[path], device, positive=path.startswith("moments"))
            check(torch.equal(whole, want), f"gathered {path} differs from the drawn leaf")
            out["gathered_bytes"] += whole.numel() * whole.element_size()
        del whole
    out["gather_s"] = time.perf_counter() - t0
    del on_b, flat_b
    torch.cuda.empty_cache()
    report("resharded")

    # the checkpoint, at a depth cut: saved by rank 0 from the shards on mesh A, restored onto mesh B
    cut = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, DIST_CKPT_LAYERS))
    seed_cut = DIST_SEED + 100_000
    meta_c, cut_a, place_ca, _, out["ckpt_whole_bytes"], _ = _dist_state(cut, mesh_a, device, seed_cut)
    place_cb = _dist_placements(meta_c, mesh_b)
    dist.barrier()
    t0 = time.perf_counter()
    whole = gather_tree(cut_a, place_ca, dst=0)
    torch.cuda.synchronize(device)
    out["ckpt_gather_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if dist.get_rank() == 0:
        save_checkpoint(ckpt_dir, 1, whole)
    del whole
    dist.barrier()
    out["save_s"] = time.perf_counter() - t0
    del cut_a
    t0 = time.perf_counter()
    restored, step = restore_checkpoint(ckpt_dir, meta_c, shardings=place_cb)
    torch.cuda.synchronize(device)
    out["restore_s"] = time.perf_counter() - t0
    check(step == 1, f"restored step {step}")
    out["restored_leaves"] = _dist_equal_redrawn(meta_c, restored, place_cb, device, seed_cut, "restored")
    out["ckpt_layers"] = cut.n_layers
    del restored
    torch.cuda.empty_cache()
    report("checkpoint")
    return out


def _table_rows(lo, hi, dim, device, seed):
    """Rows [lo, hi) of the stacked table, drawn in seeded chunks of
    DIST_ROW_CHUNK rows (recsys.init_tables' scale, 1 / sqrt(D))."""
    import torch

    out = torch.empty((hi - lo, dim), device=device)
    for c in range(lo // DIST_ROW_CHUNK, -(-hi // DIST_ROW_CHUNK)):
        c_lo = c * DIST_ROW_CHUNK
        chunk = _draw((DIST_ROW_CHUNK, dim), seed + c, device).mul_(50.0 / dim ** 0.5)  # _draw scales by 0.02
        a, b = max(lo, c_lo), min(hi, c_lo + DIST_ROW_CHUNK)
        out[a - lo: b - lo] = chunk[a - c_lo: b - c_lo]
    return out


def _bcast(t, device):
    """Rank 0's tensor on every rank (through host memory: gloo)."""
    import torch.distributed as dist

    host = t.cpu().contiguous()
    dist.broadcast(host, src=0)
    return host.to(device)


def _dist_lookup(device, report):
    """dlrm-rm2's stacked table row-sharded over model = 4, through both
    vocab-parallel lookups at serve_p99 and one serve_bulk chunk: outputs to
    the bit against field_lookup over the whole table (rank 0), zeros for a
    row of out-of-range ids, each shard's gradient against the whole table's."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.embedding import vocab_parallel_lookup, vocab_parallel_lookup_scattered
    from repro_torch.launch.mesh import DeviceMesh, batch_axes
    from repro_torch.models.recsys import EmbedTables, field_lookup

    rc = get_arch("dlrm-rm2").recsys
    rows_total = -(-int(sum(rc.vocab_sizes)) // 512) * 512  # init_tables' padding
    mesh = DeviceMesh(*DIST_MESH_B, device=device)
    rank, n_model = dist.get_rank(), mesh.shape["model"]
    r_local = rows_total // n_model
    lo = mesh.index("model") * r_local
    seed = DIST_SEED + 200_000
    table_l = _table_rows(lo, lo + r_local, rc.embed_dim, device, seed).requires_grad_()  # this rank's shard
    # rank 0: the whole table on the card (the outputs' reference, field_lookup's time) and on the host (the
    # gradients' reference: a dense 6.656 GB gradient beside what the script's earlier phases hold would not fit)
    whole = _table_rows(0, rows_total, rc.embed_dim, device, seed) if rank == 0 else None
    whole_host = whole.cpu() if rank == 0 else None
    offsets = np.cumsum([0] + list(rc.vocab_sizes[:-1]))
    n_f = len(rc.vocab_sizes)
    out = {"rows": rows_total, "dim": rc.embed_dim, "fields": n_f,
           "table_gb": rows_total * rc.embed_dim * 4 / 1e9, "shard_gb": r_local * rc.embed_dim * 4 / 1e9}
    rng = np.random.default_rng(DIST_SEED)
    for label, n in DIST_LOOKUP_BATCHES.items():
        fids = np.stack([rng.integers(0, v, n) for v in rc.vocab_sizes], axis=1)
        gids = torch.from_numpy(fids + offsets[None, :])
        gids[-1] = torch.tensor([-3 if f % 2 else rows_total + 11 for f in range(n_f)])  # no shard owns these
        w = _draw((n, n_f, rc.embed_dim), seed + 999, device) * 50.0
        ref_out = ref_rows = tol_rows = uniq = None
        if rank == 0:  # field_lookup over the whole table, and its gradient, on the in-range rows
            offs = torch.from_numpy(offsets)
            ref = field_lookup(EmbedTables(whole, offs.to(device)), torch.from_numpy(fids[:-1]).to(device))
            ref_out = torch.cat([ref, torch.zeros_like(ref[:1])])
            whole_host.requires_grad_()
            w_host = w[:-1].cpu()
            (field_lookup(EmbedTables(whole_host, offs), torch.from_numpy(fids[:-1])) * w_host).sum().backward()
            uniq, inv, counts = torch.unique(gids[:-1].reshape(-1), return_inverse=True, return_counts=True)
            ref_rows = whole_host.grad[uniq]
            abs_sum = torch.zeros((len(uniq), rc.embed_dim)).index_add_(0, inv, w_host.reshape(-1, rc.embed_dim).abs())
            # a float32 sum of c terms in another order: within (c - 1) 2^-24 of the sum of their |terms|
            tol_rows = (counts[:, None] - 1).float() * 2.0 ** -24 * abs_sum
            whole_host.grad = None
            whole_host.requires_grad_(False)
            del ref, abs_sum, w_host
        ref_out = _bcast(ref_out if rank == 0 else torch.empty((n, n_f, rc.embed_dim)), device)
        n_u = _bcast(torch.tensor([0 if uniq is None else len(uniq)]), "cpu").item()
        uniq = _bcast(uniq if rank == 0 else torch.empty(n_u, dtype=torch.int64), device)
        ref_rows = _bcast(ref_rows if rank == 0 else torch.empty((n_u, rc.embed_dim)), device)
        tol_rows = _bcast(tol_rows if rank == 0 else torch.empty((n_u, rc.embed_dim)), device)
        mine = (uniq >= lo) & (uniq < lo + r_local)
        rows = uniq[mine] - lo
        gids = gids.to(device)
        for name, fn in (("psum", vocab_parallel_lookup), ("scattered", vocab_parallel_lookup_scattered)):
            got = fn(table_l, gids, mesh, batch_axes(mesh))
            part = slice(rank * n // n_model, (rank + 1) * n // n_model) if name == "scattered" else slice(0, n)
            check(torch.equal(got, ref_out[part]), f"{name} lookup at {label}: not field_lookup's bits")
            if part.stop == n:
                check(not got[-1].any(), f"{name} lookup at {label}: out-of-range ids give nonzero rows")
            (got * w[part]).sum().backward()
            g, table_l.grad = table_l.grad, None
            err = (g[rows] - ref_rows[mine]).abs()
            bound = DIST_GRAD_RTOL * ref_rows[mine].abs() + tol_rows[mine]
            check(bool((err <= bound).all()), f"{name} at {label}: shard gradient off its slice of the whole's "
                                              f"(max err {float(err.max()):.3g})")
            scaled = float((g[rows] - n_model * ref_rows[mine]).abs().max())
            g.index_fill_(0, rows, 0)
            check(float(g.amax()) == 0.0 == float(g.amin()), f"{name} at {label}: gradient on rows no id looked up")
            del got, g
            fwd_ms, bwd_ms = [], []
            for _ in range(DIST_REPS):
                dist.barrier()
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                y = fn(table_l, gids, mesh, batch_axes(mesh))
                torch.cuda.synchronize(device)
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
                dist.barrier()
                t0 = time.perf_counter()
                (y * w[part]).sum().backward()
                torch.cuda.synchronize(device)
                bwd_ms.append((time.perf_counter() - t0) * 1e3)
                table_l.grad = None
                del y
            out[f"{name}/{label}"] = dict(ms=statistics.median(fwd_ms), bwd_ms=statistics.median(bwd_ms),
                                          grad_err=float(err.max()), rows_checked=len(rows), scaled_err=scaled)
        if rank == 0:
            ms = []
            idx = torch.from_numpy(fids).to(device)
            tab = EmbedTables(whole, torch.from_numpy(offsets).to(device))
            for _ in range(DIST_REPS):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                field_lookup(tab, idx)
                torch.cuda.synchronize(device)
                ms.append((time.perf_counter() - t0) * 1e3)
            out[f"field_lookup/{label}"] = statistics.median(ms)
    del table_l, whole, whole_host
    torch.cuda.empty_cache()
    report("lookup")
    return out


def _dist_compressed(device, report):
    """DIST_CP_STEPS data-parallel steps of the SPLADE encoder over data = 4:
    each rank's gradient on its quarter of the --splade batch, the mean
    through compressed_psum (AdamW applies it), against the uncompressed
    all-reduce mean: within one quantization level at every step, the
    residuals within half a level, and the error-feedback identity over the
    run. BackupStepPolicy tracks the step times."""
    import torch
    import torch.distributed as dist

    from repro_torch.common.tree_utils import tree_leaves, tree_map
    from repro_torch.distributed.topk import all_reduce_sum, pmax_scalar
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.train import splade_job
    from repro_torch.models.sparse_encoder import SpladeBatch, splade_loss
    from repro_torch.optim.grad_compress import compressed_psum, init_error_feedback
    from repro_torch.train.elastic import BackupStepPolicy

    mesh = DeviceMesh((DIST_WORLD, 1), ("data", "model"), device=device)
    group, rank = mesh.group("data"), dist.get_rank()
    cfg, trainer, pipe = splade_job(DIST_CP_STEPS, ENC_BATCH, device=device)
    state = trainer.init_or_restore()
    params, opt = state.params, state.opt_state
    q = ENC_BATCH // DIST_WORLD
    ef = init_error_feedback(params)
    sum_c = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float64), params)
    sum_t = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float64), params)
    m_sum = torch.zeros(len(tree_leaves(params)), dtype=torch.float64, device=device)
    policy = BackupStepPolicy()
    step_ms, comp_ms, ar_ms, ces, worst_gap, worst_res, overruns = [], [], [], [], 0.0, 0.0, 0
    prev_level = torch.zeros(len(tree_leaves(params)), device=device)
    for t in range(DIST_CP_STEPS):
        batch = {k: torch.from_numpy(v[rank * q: (rank + 1) * q]).to(device) for k, v in pipe.batch_at(t).items()}
        dist.barrier()
        policy.start()
        lowp = tree_map(lambda x: x.detach().to(torch.bfloat16).requires_grad_(), params)
        loss, metrics = splade_loss(lowp, cfg, SpladeBatch(batch["q_tokens"], batch["q_mask"], batch["d_tokens"],
                                                          batch["d_mask"]))
        it = iter([g.float() for g in torch.autograd.grad(loss, tree_leaves(lowp))])
        grads = tree_map(lambda _: next(it), params)
        # the worst rank's level a leaf, max |g + e| / 127, before compressed_psum replaces e
        level = pmax_scalar(torch.stack([torch.clamp((g + e).abs().max(), min=1e-12) / 127.0
                                             for g, e in zip(tree_leaves(grads), tree_leaves(ef.err))]), group)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        mean, ef = compressed_psum(grads, ef, group)
        torch.cuda.synchronize(device)
        comp_ms.append((time.perf_counter() - t0) * 1e3)
        params, opt, _ = trainer.optimizer.update(mean, opt, params)
        torch.cuda.synchronize(device)
        if policy.overrun():
            overruns += 1
        step_ms.append(policy.finish() * 1e3)
        ces.append(float(metrics["ce"].detach()))
        # the reference: the uncompressed mean, all leaves in one all-reduce
        t0 = time.perf_counter()
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in tree_leaves(grads)]), group) / float(DIST_WORLD)
        torch.cuda.synchronize(device)
        ar_ms.append((time.perf_counter() - t0) * 1e3)
        numels = [g.numel() for g in tree_leaves(grads)]
        true = [v.view_as(g) for v, g in zip(flat.split(numels), tree_leaves(grads))]
        for i, (c, tm, e, sc, st) in enumerate(zip(tree_leaves(mean), true, tree_leaves(ef.err),
                                                   tree_leaves(sum_c), tree_leaves(sum_t))):
            lv, m = float(level[i]), 127.0 * float(level[i])
            gap = float((c - tm).abs().max())
            # |mean_r (e_{t-1} - e_t)| <= half the last level + half this one, plus float32 rounding
            allowed = 0.5 * (float(prev_level[i]) + lv) + 2.0 ** -20 * m
            check(gap <= allowed, f"step {t} leaf {i}: compressed mean {gap:.3g} from the true mean, over "
                                  f"one level {allowed:.3g}")
            res = float(e.abs().max())
            check(res <= 0.5 * lv + 2.0 ** -22 * m, f"step {t} leaf {i}: residual {res:.3g} over half a level "
                                                    f"{lv:.3g}")
            worst_gap, worst_res = max(worst_gap, gap / max(lv, float(prev_level[i]))), max(worst_res, res / lv)
            sc += c
            st += tm
        m_sum += 127.0 * level.double()
        prev_level = level
    # the error-feedback identity: sum_t compressed = sum_t true - mean over ranks of the last residual
    worst_id = 0.0
    for i, (sc, st, e) in enumerate(zip(tree_leaves(sum_c), tree_leaves(sum_t), tree_leaves(ef.err))):
        e_mean = all_reduce_sum(e.double(), group) / DIST_WORLD
        gap = float((sc - (st - e_mean)).abs().max())
        tol = 2.0 ** -19 * float(m_sum[i])  # float32 rounding of each step's sums and quantization
        check(gap <= tol, f"error feedback identity, leaf {i}: {gap:.3g} over {tol:.3g}")
        worst_id = max(worst_id, gap / tol)
    out = dict(n_params=sum(p.numel() for p in tree_leaves(params)), leaves=len(tree_leaves(params)),
               comp_ms=statistics.median(comp_ms), ar_ms=statistics.median(ar_ms),
               step_ms=statistics.median(step_ms), ces=ces, worst_gap=worst_gap,
               worst_res=worst_res, worst_identity=worst_id, ewma_ms=policy.ewma * 1e3,
               deadline_ms=policy.deadline() * 1e3, overruns=overruns, step_ms_all=step_ms)
    report("compressed_psum")
    return out


def _dist_rank_main(rank, world, port, device, ckpt_dir, results):
    """One rank of the distributed phase (gloo; every rank on ``device``,
    the one card). Reports as it goes; sends its numbers, or its traceback."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    report = lambda stage: results.put((rank, "progress", stage))
    try:
        out = {"lm": _dist_lm(device, ckpt_dir, report), "lookup": _dist_lookup(device, report),
               "compressed": _dist_compressed(device, report)}
        dist.barrier()  # every rank is past its last collective before any tears its group down
        results.put((rank, "result", out))
    except BaseException:  # sent to the parent, then raised
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def distributed_phase(device, card):
    """The distributed training layer: DIST_WORLD spawned gloo ranks share
    the card (NCCL refuses two ranks on one card). A rank that fails, or a
    world from which no rank reports within RANK_TIMEOUT_S, fails the run."""
    import multiprocessing as mp
    import queue

    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with what this process still holds
    ckpt_dir = tempfile.mkdtemp()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_dist_rank_main, args=(r, DIST_WORLD, port, device, ckpt_dir, results))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) < DIST_WORLD and not errors:  # drain before joining
            try:
                rank, kind, payload = results.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"no rank reported within {RANK_TIMEOUT_S} s; results from ranks {sorted(got)}")
                break
            if kind == "error":
                errors.append(f"rank {rank} failed:\n{payload}")
            elif kind == "result":
                got[rank] = payload
            elif rank == 0:
                log(f"  distributed phase: rank 0 {payload} at {time.perf_counter() - t_phase:.1f} s")
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S if not errors else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(not errors, "; ".join(errors))
    check(all(p.exitcode == 0 for p in procs), f"rank exit codes {[p.exitcode for p in procs]}")

    lm, lk, cp = got[0]["lm"], got[0]["lookup"], got[0]["compressed"]
    per_rank = lambda part, key, nd=2: [round(got[r][part][key], nd) for r in range(DIST_WORLD)]
    rank_gb = [b / 1e9 for b in per_rank("lm", "rank_bytes", 0)]
    stages = ", ".join(f"{k} {v:.1f} s" for k, v in lm["place_stages"].items())
    log(f"distributed ({card}): qwen3-4b, {lm['n_params']:,} parameters + Adafactor moments, float32, placed "
        f"by stacked_lm_param_specs(fsdp, kv_shard=False) on mesh (data 2, model 2) in {lm['place_s']:.1f} s "
        f"({stages}): {[round(g, 3) for g in rank_gb]} GB a rank of {lm['whole_bytes'] / 1e9:.3f} GB "
        f"({rank_gb[0] * 1e9 / lm['whole_bytes']:.4f}), params {lm['rank_param_bytes'] / 1e9:.3f} GB a rank; "
        f"peak reserved {per_rank('lm', 'reserved_gb')} GB a rank")
    log(f"distributed ({card}): reshard_state to (data 1, model 4) in {per_rank('lm', 'reshard_s')} s (ranks); "
        f"all {lm['resharded_leaves']} leaves equal to a fresh placement's slices of the redrawn leaves; "
        f"{len(DIST_GATHERED)} leaves ({lm['gathered_bytes'] / 1e9:.3f} GB) gathered on rank 0 in "
        f"{lm['gather_s']:.2f} s, equal to the drawn bits")
    log(f"distributed ({card}): checkpoint of the {lm['ckpt_layers']}-layer cut "
        f"({lm['ckpt_whole_bytes'] / 1e9:.3f} GB) gathered on rank 0 in {lm['ckpt_gather_s']:.2f} s and saved in "
        f"{lm['save_s']:.2f} s; restore_checkpoint(shardings=) onto (data 1, model 4) in "
        f"{per_rank('lm', 'restore_s')} s (ranks); all {lm['restored_leaves']} restored shards equal to the "
        f"saved bits")
    log(f"distributed ({card}): dlrm-rm2 table {lk['rows']:,} x {lk['dim']} float32 ({lk['table_gb']:.3f} GB), "
        f"{lk['shard_gb']:.3f} GB a rank over model = {DIST_WORLD}")
    for label, n in DIST_LOOKUP_BATCHES.items():
        for name in ("psum", "scattered"):
            r = lk[f"{name}/{label}"]
            log(f"  {name} lookup at {label} ({n} rows x {lk['fields']} fields): {r['ms']:.3f} ms a call, "
                f"backward {r['bwd_ms']:.3f} ms (medians of {DIST_REPS}); output equal to field_lookup's bits, "
                f"out-of-range row zero; gradient max err {r['grad_err']:.3g} over {r['rows_checked']} rows of "
                f"rank 0's shard (scaled by model it would be {r['scaled_err']:.3g} off)")
        log(f"  field_lookup over the whole table at {label}: {lk[f'field_lookup/{label}']:.3f} ms")
    log(f"distributed ({card}): compressed_psum over data = {DIST_WORLD}, SPLADE encoder ({cp['n_params']:,} "
        f"parameters, {cp['leaves']} leaves), {DIST_CP_STEPS} steps of a quarter of a batch of {ENC_BATCH} a "
        f"rank: compressed_psum (leaf by leaf) {cp['comp_ms']:.1f} ms a step, the reference's uncompressed "
        f"all-reduce (one flat buffer) {cp['ar_ms']:.1f} ms, step {cp['step_ms']:.1f} ms (medians); ce "
        f"{cp['ces'][0]:.4f} -> {cp['ces'][-1]:.4f} (rank 0's quarter; AdamW's warmup of 10 steps at untrained ce, "
        f"as in the encoder phase's first 20 steps); worst |compressed - true mean| {cp['worst_gap']:.4f} of a "
        f"level (the larger of the step's and the last one's), worst residual {cp['worst_res']:.4f} of a "
        f"level, error-feedback identity at {cp['worst_identity']:.4f} of its tolerance")
    log(f"distributed ({card}): BackupStepPolicy over the {DIST_CP_STEPS} step times: EWMA {cp['ewma_ms']:.1f} "
        f"ms, deadline {cp['deadline_ms']:.1f} ms, {cp['overruns']} overruns; steps "
        f"{[round(x, 1) for x in cp['step_ms_all']]} ms; ce by step {[round(c, 2) for c in cp['ces']]}")
    log(f"distributed phase {time.perf_counter() - t_phase:.1f} s")
    return got


def _cell_mesh(arch_name, shape_name, meta=False):
    """The mesh a card cell is built on: the production mesh's model axis for
    mind's retrieval (its per-shard layout), else one rank (its shape alone
    for the meta pass, whose recsys lookups are field_lookup)."""
    from repro_torch.launch.mesh import DeviceMesh, MeshShape

    if (arch_name, shape_name) == ("mind", "retrieval_cand"):
        return MeshShape((16, 16), ("data", "model"))
    return MeshShape((1, 1), ("data", "model")) if meta else DeviceMesh((1, 1), ("data", "model"), device="cuda")


def _card_cell(arch_name, shape_name, fields, meta=False):
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.specs import cell_for_shape

    arch = get_arch(arch_name)
    shape = dataclasses.replace(arch.shapes[shape_name], **fields)
    return cell_for_shape(arch, shape, _cell_mesh(arch_name, shape_name, meta))


def _count_card_cell(arch_name, shape_name, fields):
    """Counted FLOPs of a card cell (a pool job): its meta pass on the mesh's shape."""
    from repro_torch.launch.dryrun import count_cell

    cost, _, _, counted = count_cell(_card_cell(arch_name, shape_name, fields, meta=True))
    return cost["flops"], counted


def _meta_pass(out_dir, card_bytes):
    """launch/dryrun.py's run_cell over every cell x both production meshes in
    CELL_WORKERS spawned processes, with the card cells' FLOP counts; prints a
    line a cell and returns ({(mesh, arch, shape): record}, {card cell: flops})."""
    import concurrent.futures
    import multiprocessing as mp

    from repro_torch.configs.base import all_arch_names, get_arch
    from repro_torch.launch.dryrun import run_cell_on_both_meshes

    t0 = time.perf_counter()
    jobs = [(name, shape) for name in all_arch_names() for shape in get_arch(name).shapes]
    # the long ones first: the LM train steps, then the prefills
    jobs.sort(key=lambda j: (get_arch(j[0]).family != "lm", j[1] != "train_4k", j[1] != "prefill_32k"))
    with concurrent.futures.ProcessPoolExecutor(CELL_WORKERS, mp_context=mp.get_context("spawn")) as pool:
        futs = {j: pool.submit(run_cell_on_both_meshes, j[0], j[1], out_dir) for j in jobs[:5]}
        counts = {(a, sh): pool.submit(_count_card_cell, a, sh, f) for a, sh, f, _, _ in CARD_CELLS}
        futs.update({j: pool.submit(run_cell_on_both_meshes, j[0], j[1], out_dir) for j in jobs[5:]})
        records = {(m, a, sh): rec for (a, sh), f in futs.items() for m, rec in f.result().items()}
        flops = {k: f.result() for k, f in counts.items()}
    n_ok = sum(r["status"] == "ok" for r in records.values())
    n_skip = sum(r["status"] == "skipped" for r in records.values())
    failed = [k for k, r in records.items() if r["status"] not in ("ok", "skipped")]
    for key in sorted(records):
        r = records[key]
        if r["status"] != "ok":
            log(f"  dry run {key[0]} {key[1]} {key[2]}: {r['status']} {r.get('reason', r.get('error', ''))}")
            continue
        arg = r["memory"]["argument_bytes"]
        log(f"  dry run {key[0]} {key[1]} {key[2]} ({r['kind']}): per-rank arguments {arg / 1e9:.4f} GB, outputs "
            f"{r['memory']['output_bytes'] / 1e9:.4f} GB; global {r['cost']['flops']:.6g} FLOP, per device "
            f"{r['cost_adjusted']['flops'] / 1e12:.4f} TFLOP; {r['op_stats']['n_ops']} ops; counted in "
            f"{r['count_s']:.1f} s ({r['cost']['counted']})")
        if arg > card_bytes:
            log(f"    {key[1]} {key[2]} on {key[0]}: {arg / 1e9:.1f} GB of arguments a rank exceed the card's "
                f"{card_bytes / 1e9:.1f} GB")
    log(f"dry run: {n_ok} ok, {n_skip} skipped, {len(failed)} failed over 2 meshes in "
        f"{time.perf_counter() - t0:.1f} s ({CELL_WORKERS} processes)")
    check(not failed, f"dry-run cells failed: {[(k, records[k].get('error')) for k in failed]}")
    check(n_ok == 74 and n_skip == 6, f"the dry run built {n_ok} cells and skipped {n_skip}, not 74 and 6")
    return records, flops


def _card_model_flops(arch_name, shape_name, fields):
    """eval/model_flops.py's count of a card cell at its cut shape: 6·N·tokens
    for an LM train step, the analytic per-op counts elsewhere."""
    from repro_torch.configs.base import get_arch
    from repro_torch.eval.model_flops import model_flops

    arch = get_arch(arch_name)
    return model_flops(arch, shape_name, dataclasses.replace(arch.shapes[shape_name], **fields))


def _train_step_held_to_cpu(label, cell, args):
    """One training step of ``cell`` on the card and on a CPU copy of the same
    inputs: the loss and each updated parameter within GNN_CPU_RTOL x max
    |reference|, the update (new - old, all leaves) within CELL_UPDATE_RTOL x
    its largest CPU element. The card's step updates ``args`` in place; returns the
    next step's arguments."""
    import torch

    from repro_torch.common.tree_utils import flatten_with_paths, tree_map

    def to_cpu(x):
        return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x

    cpu_args = tree_map(to_cpu, args)
    old = flatten_with_paths(tree_map(to_cpu, cpu_args[0]))
    t0 = time.perf_counter()
    out = cell.fn(*args)
    torch.cuda.synchronize()
    cpu_out = cell.fn(*cpu_args)
    _held_to_cpu(f"{label} loss", out[2].reshape(1), cpu_out[2].reshape(1), GNN_CPU_RTOL)
    want = flatten_with_paths(cpu_out[0])
    err = upd = 0.0
    for path, got in flatten_with_paths(out[0]).items():  # float32 on the host: a 2.6 GB table stays one copy
        got, w = got.detach().cpu(), want[path]
        check(got.shape == w.shape and bool(torch.isfinite(got).all()), f"{label} updated {path}: shape or values")
        e, ref = float((got - w).abs().max()), float(w.abs().max())
        check(e <= GNN_CPU_RTOL * ref, f"{label} updated {path}: card against CPU {e} > {GNN_CPU_RTOL} x {ref}")
        err, upd = max(err, e), max(upd, float((w - old[path]).abs().max()))
    log(f"{label} updated parameters: each of {len(want)} leaves within {GNN_CPU_RTOL} x its max |reference|")
    log(f"{label} update over {len(want)} leaves: card against the CPU port max abs error {err:.3g} (largest "
        f"CPU update {upd:.3g}, ratio {err / upd if upd else float('nan'):.3g}, bound {CELL_UPDATE_RTOL} x "
        f"it); held in {time.perf_counter() - t0:.1f} s")
    check(upd > 0 and err <= CELL_UPDATE_RTOL * upd, f"{label}: update error {err} > {CELL_UPDATE_RTOL} x {upd}")
    return (out[0], out[1]) + tuple(args[2:])


def _card_cells(device, card, flops, core_ops, sites):
    """Each of CARD_CELLS through measure_cell: ms a step, the cell's own peak
    GB (above what the card held before its inputs were drawn), the profiler's
    kernels, counted and model TFLOP/s; the CELL_CPU_HELD training steps
    against the CPU port; mind's retrieval with dequant_matmul counted and
    its ids against impl="ref"."""
    import torch

    from repro_torch.launch.dryrun import draw_args, measure_cell

    rows = {}
    for arch_name, shape_name, fields, cut, steps in CARD_CELLS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        cell = _card_cell(arch_name, shape_name, fields)
        gen = torch.Generator(device=device).manual_seed(CELL_SEED)
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        args = draw_args(cell, device, gen)
        extra = ""
        if cell.kind == "retrieve_step":
            out, launches, _ = counted(core_ops, lambda: cell.fn(*args), sites)
            ref_ids, ref_vals = cell.fn(*args, impl="ref")
            check(launches["dequant_matmul"] > 0, "dequant_matmul was never launched on mind's 16-shard cell")
            check(torch.equal(out[0], ref_ids), "mind's 16-shard cell: kernel ids differ from impl='ref'")
            torch.testing.assert_close(out[1], ref_vals, **TOL)
            valid = float((out[0] >= 0).float().mean())
            extra = (f"; dequant_matmul launched {launches['dequant_matmul']} times, top {out[0].shape[1]} of "
                     f"{out[0].shape[0]} interest rows equal to impl='ref' on ids ({valid:.4f} of slots filled)")
        if (arch_name, shape_name) in CELL_CPU_HELD:
            args = _train_step_held_to_cpu(f"card cell {arch_name} {shape_name}", cell, args)
            extra += "; its first step held against the CPU port"
        res = measure_cell(cell, device, gen, steps=steps, args=args, flops=flops[(arch_name, shape_name)][0],
                           base_bytes=base)
        model = _card_model_flops(arch_name, shape_name, fields)
        out = res["out"]
        leaves = [x for x in (out if isinstance(out, tuple) else (out,)) if isinstance(x, torch.Tensor)]
        check(all(bool(torch.isfinite(x.float()).all()) for x in leaves if x.is_floating_point()),
              f"{arch_name} {shape_name}: non-finite outputs")
        if cell.kind == "train_step":
            loss = float(out[2])
            check(math.isfinite(loss), f"{arch_name} {shape_name}: loss {loss}")
            extra += f"; loss {loss:.4f}"
        prof = res["profile"]
        top = "; ".join(f"{name} x{n} {ms:.2f} ms" for name, n, ms in prof.get("top", [])[:6]) or "not measured"
        log(f"card cell {arch_name} {shape_name} ({cell.kind}) [{card}]: {res['ms']:.2f} ms a step (median of "
            f"{steps}: {[round(x, 2) for x in res['ms_all']]}), peak {res['peak_bytes'] / 1e9:.2f} GB above the "
            f"{res['base_bytes'] / 1e9:.2f} GB held before its inputs were drawn (absolute "
            f"{res['peak_abs_bytes'] / 1e9:.2f} GB), counted {res['counted_tflops']:.2f} TFLOP/s "
            f"({res['flops']:.4g} FLOP counted on meta, {res['counted']}: dispatched, remat and launched "
            f"attention tiles included), model {model / (res['ms'] * 1e-3) / 1e12:.2f} TFLOP/s ({model:.4g} "
            f"FLOP, eval/model_flops.py) against the H100's {BF16_FLOP_PER_S / 1e12:.0f} (bf16) and "
            f"{FP32_FLOP_PER_S / 1e12:.0f} (float32) peaks{extra}; cut: {cut or 'none (full shape)'}; {cell.note}")
        if prof.get("n_kernels"):
            log(f"  profiled warm-up ({res['profiled']}): {prof['n_kernels']} kernels, device busy "
                f"{prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms (idle {prof['idle']:.3f}); {top}")
        else:
            log(f"  profiled warm-up ({res['profiled']}): the profiler saw no device time (not measured)")
        rows[(arch_name, shape_name)] = {k: res[k] for k in ("ms", "peak_bytes", "counted_tflops")}
        del cell, args, res, out, leaves
        log(f"  {arch_name} {shape_name} took {time.perf_counter() - t0:.1f} s")
    return rows


def _legacy_on_the_index(idx, cfg, batches, device, card):
    """The 256 requests under impl="legacy" at lsp0, lsp2 and bmp against
    impl="ref" (ids, θ, both counters equal; scores to float32 tolerance),
    timed beside impl="kernel", in batches of LEGACY_BATCH."""
    import numpy as np
    import torch

    from repro_torch.api import Retriever

    requests = [r for b in batches for r in b]
    small = [requests[i: i + LEGACY_BATCH] for i in range(0, len(requests), LEGACY_BATCH)]
    for variant in LEGACY_VARIANTS:
        vcfg = dataclasses.replace(cfg, variant=variant)
        out, ms = {}, {}
        for impl in ("legacy", "ref", "kernel"):
            retr = Retriever.from_index(idx, vcfg, impl=impl, device=device)
            retr.search_batch(small[0])  # warm-up
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out[impl] = [r for b in small for r in retr.search_batch(b)]
            ms[impl] = (time.perf_counter() - t0) * 1e3 / len(small)
        for a, b in zip(out["legacy"], out["ref"]):
            check(np.array_equal(a.doc_ids, b.doc_ids), f"legacy {variant}: ids differ from impl='ref'")
            check((a.n_superblocks_visited, a.n_blocks_scored) == (b.n_superblocks_visited, b.n_blocks_scored),
                  f"legacy {variant}: counters differ from impl='ref'")
            check(np.isclose(a.theta, b.theta, **LEGACY_TOL), f"legacy {variant}: theta {a.theta} vs {b.theta}")
            np.testing.assert_allclose(a.scores, b.scores, **LEGACY_TOL)
        same_kernel = all(np.array_equal(a.doc_ids, b.doc_ids) for a, b in zip(out["legacy"], out["kernel"]))
        log(f"legacy {variant} [{card}]: {len(requests)} requests in {len(small)} search_batch calls of "
            f"{LEGACY_BATCH}: ids, theta and both counters equal to impl='ref'; {ms['legacy']:.2f} ms a call, "
            f"against impl='ref' {ms['ref']:.2f} ms and impl='kernel' {ms['kernel']:.2f} ms "
            f"(legacy / kernel {ms['legacy'] / ms['kernel']:.2f}x; kernel ids equal to legacy's: {same_kernel})")


def cells_phase(device, card, idx, cfg, batches, core_ops, sites):
    """The cell builder and its dry run (launch/specs.py, launch/dryrun.py):
    (a) the meta pass over 37 cells x 2 meshes in CELL_WORKERS processes, (b)
    CARD_CELLS on the card through measure_cell, (c) impl="legacy" on the
    1 M-document index. Any cell that fails to build, run or match fails the run."""
    import torch

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp()
    try:
        _, flops = _meta_pass(out_dir, torch.cuda.get_device_properties(device).total_memory)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"  meta pass done at {time.perf_counter() - t_phase:.1f} s")
    _card_cells(device, card, flops, core_ops, sites)
    torch.cuda.empty_cache()
    log(f"  card cells done at {time.perf_counter() - t_phase:.1f} s")
    _legacy_on_the_index(idx, cfg, batches, device, card)
    log(f"cells phase {time.perf_counter() - t_phase:.1f} s")


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
    from repro_torch.core.bounds import unpack_strided
    from repro_torch.kernels import _build
    from repro_torch.kernels.boundsum_gather.ref import boundsum_gather_ref
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
    from repro_torch.kernels.doc_score.ref import doc_score_flat_ref, doc_score_fwd_ref
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
    sites = {getattr(idx, attr).packed.data_ptr(): site for site, attr in SBMAX_SITES.items()}

    # ---- one warm-up batch, recording the inputs each kernel is handed
    fwd_kernels = ["sbmax", "boundsum_gather", "doc_score_fwd"]
    captured = capture(core_ops, fwd_kernels, lambda: retr.search_batch(batches[0]))
    torch.cuda.synchronize(device)

    # ---- 5-6. the main path: 256 requests in four search_batch calls, counted
    batch_s = []

    def main_path():
        out = []
        for batch in batches:
            t0 = time.perf_counter()
            out += retr.search_batch(batch)
            batch_s.append(time.perf_counter() - t0)
        return out

    responses, counts, by_site = counted(core_ops, main_path, sites)
    log(f"launches during the 4 search_batch calls: {counts}; sbmax by call site {by_site}")
    launches = {key: counts[key] for key in fwd_kernels}
    for key, n in launches.items():
        check(n > 0, f"kernel {key} was never launched on the main path")
    # sbmax has a row per call site, each with its launches on the first path that runs it
    sbmax_launches = {"phase 1": by_site["phase 1"]}
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
    check((ids == ref_ids).all(), "kernel and ref paths return the same ids for every query")
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
    share, p_gamma = gamma_reading(idx, queries, VOCAB, exact_ids, retr.static_cfg.gamma, device)
    log(f"gamma analysis on the synthetic index at gamma {retr.static_cfg.gamma}: exact top-10 superblocks in the "
        f"top gamma by SBMax {share:.4f}, P_gamma(R) {p_gamma:.4f}")

    # ---- 7a. the same requests under the flat document layout
    cfg = retr.static_cfg
    flat_launches, _, flat_captured = path_phase("flat layout", dataclasses.replace(cfg, doc_layout="flat"), idx,
                                                 batches, exact_ids, device, core_ops, sites, ["doc_score_flat"],
                                                 fwd_responses=responses)
    launches["doc_score_flat"] = flat_launches["doc_score_flat"]
    captured.update(flat_captured)

    # ---- 7b. the same requests under lsp2 (sbmax at phase 1 and SBavg) and bmp (sbmax over all blocks)
    for variant, variant_sites in (("lsp2", ("phase 1", "SBavg")), ("bmp", ("bmp BoundSum",))):
        _, by_site, variant_captured = path_phase(variant, dataclasses.replace(cfg, variant=variant), idx, batches,
                                                  exact_ids, device, core_ops, sites, ["sbmax"])
        for site in variant_sites:
            check(by_site[site] > 0, f"sbmax was never launched at {site} on the {variant} path")
            sbmax_launches.setdefault(site, by_site[site])
        captured["sbmax"] += variant_captured["sbmax"]

    # ---- 7b'. the runner's CUDA graphs against the eager traversal
    graphs_phase(idx, cfg, queries, device, core_ops)

    tmp = tempfile.mkdtemp()
    try:
        # ---- 7c. the serving engine over the same index (lsp0, fwd)
        engine_launches, single_dir = engine_phase(retr, ref, requests, responses, device, core_ops, sites, tmp)
        log(f"engine path launches: {engine_launches}")

        # ---- 7d. the live mutable index over the same index, then the sharded store
        mutable_launches = mutable_phase(idx, corpus, queries, requests, device, core_ops, sites, single_dir, tmp)
        log(f"mutable path launches: {mutable_launches}")
        shards, sharded_dir = sharded_store_phase(idx, device, core_ops, sites, tmp)

        # ---- 7e. sharded serving over those shards and that directory
        sharded_launches, sharded_calls = sharded_phase(retr, batches, responses, shards, sharded_dir, single_dir,
                                                        device, core_ops, sites)
        del shards

        # ---- 7e'. the serving launcher: build + save, mmap-load + swap + sweep + SLO, 3 shards in 1 and 3 ranks
        launcher_launches, launcher_calls = launcher_phase(device, core_ops, tmp)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 7f. dense-embedding LSP (recsys retrieval_cand), and sharded
    launches["dequant_matmul"], dense_captured, (dense_sharded_launches, dense_sharded_calls) = dense_phase(
        device, core_ops, sites)
    captured.update(dense_captured)
    sharded_launches["dequant_matmul"] = dense_sharded_launches
    sharded_calls["dequant_matmul"] = dense_sharded_calls
    torch.cuda.empty_cache()

    # ---- 7f'. the recsys models at full width: dlrm-rm2 and din serving, mind's retrieval (dequant_matmul)
    t0 = time.perf_counter()
    dlrm_din_serving(device)
    mind_launches, mind_calls = mind_phase(device, core_ops, sites)
    torch.cuda.empty_cache()
    log(f"recsys phase {time.perf_counter() - t0:.1f} s")

    # ---- 7f''. schnet at full width: molecules, full_graph_sm, minibatch_lg
    gnn_phase(device)

    # ---- 7g. the SPLADE encoder: train, checkpoint, encode, index the learned vectors, retrieve
    encoder_launches, encoder_calls = encoder_phase(device, core_ops, sites)
    torch.cuda.empty_cache()

    # ---- 7h. decoder-only LM serving: qwen3-4b, gemma3-27b's ring buffer, phi3.5-moe (no kernel of this repo)
    lm_phase(device)

    # ---- 7i. LM training: qwen3-4b through the launcher's --arch job, its cut card against CPU, phi3.5-moe
    lm_train_phase(device)

    # ---- 7j. the distributed training layer: 4 gloo ranks on the card (placement, reshard, sharded restore,
    # vocab-parallel lookups, compressed_psum)
    distributed_phase(device, card)

    # ---- 7k. the cell builder and its dry run: 37 cells x 2 meshes counted on meta, the cells one card
    # holds run through measure_cell, impl="legacy" on the 1 M-document index
    cells_phase(device, card, idx, retr.static_cfg, batches, core_ops, sites)

    # ---- 8. each kernel vs its plain version at its path's shapes, timed
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device=device)
    plain = {"sbmax": sbmax_ref, "boundsum_gather": boundsum_gather_ref, "doc_score_fwd": doc_score_fwd_ref,
             "doc_score_flat": doc_score_flat_ref, "dequant_matmul": dequant_matmul_ref}
    work = {"sbmax": sbmax_work, "boundsum_gather": boundsum_work, "doc_score_fwd": doc_score_work,
            "doc_score_flat": doc_score_flat_work, "dequant_matmul": dequant_matmul_work}
    masked = ("boundsum_gather", "doc_score_fwd", "doc_score_flat")  # kernels whose last argument is a mask

    def library_ms(key, args):
        """One PyTorch call computing the same function, where there is one."""
        if key != "dequant_matmul":
            return None
        x, packed, bits = args
        w = unpack_strided(packed, bits, 128).to(torch.float32)  # unpacked beforehand, not timed
        ms = timed_ms(lambda: torch.matmul(x.to(torch.float32), w), flush)
        log(f"  library: torch.matmul(x, W) on W unpacked to float32 beforehand (unpack excluded): {ms:.4f} ms")
        return ms

    # a row per kernel over its captured calls, and for sbmax a row per call
    # site at the site's first captured call
    groups = []  # (kernel, call site or None, calls, launches, path or None)
    for key in KERNELS:
        check(captured[key], f"no captured call of {key}")
        if key != "sbmax":
            groups.append((key, None, captured[key], launches[key], None))
            continue
        for site in SBMAX_SITES:
            calls = [args for args in captured[key] if sites[args[0].data_ptr()] == site]
            check(calls, f"no captured call of sbmax at {site}")
            groups.append((key, site, calls[:1], sbmax_launches[site], None))
    # a row per kernel of the sharded paths over its per-shard launches (the
    # first batch or call), launches counted on those paths
    for key in ("sbmax", "boundsum_gather", "doc_score_fwd", "dequant_matmul"):
        check(sharded_calls[key], f"no captured call of {key} on a sharded path")
        groups.append((key, "phase 1" if key == "sbmax" else None, sharded_calls[key], sharded_launches[key],
                       "sharded"))
    # and a row per kernel of the encoder path (the learned index), launches counted on that path
    for key in ("sbmax", "boundsum_gather", "doc_score_fwd"):
        groups.append((key, "phase 1" if key == "sbmax" else None, encoder_calls[key], encoder_launches[key],
                       "encoder"))
    # and of mind's retrieval (its interests, the dense index of its item tower), launches counted there
    groups.append(("dequant_matmul", None, mind_calls, mind_launches, "mind"))
    # and of the serving launcher's second start (the engine's batches of up to 8), launches counted there
    for key in ("sbmax", "boundsum_gather", "doc_score_fwd"):
        check(launcher_calls[key], f"no captured call of {key} on the serving launcher's path")
        groups.append((key, "phase 1" if key == "sbmax" else None, launcher_calls[key], launcher_launches[key],
                       "serve launcher"))

    rows = []
    for key, site, calls, n_launches, path in groups:
        attr, src, replaces = KERNELS[key]
        kernel = getattr(core_ops, attr)
        per_call = []
        for args in calls:
            k_out = kernel(*args)
            p_out = plain[key](*args)
            torch.testing.assert_close(k_out, p_out, **TOL)
            err = float((k_out - p_out).abs().max())
            ms = timed_ms(lambda: kernel(*args), flush)
            plain_ms = timed_ms(lambda: plain[key](*args), flush)
            bound_ms, bound_by = bound(*work[key](*args))
            shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            log(f"{key}{f' ({site})' if site else ''}{f' [{path}]' if path else ''} at {shape}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), max_abs_err {err:.3g}")
            if key == "sbmax":  # the floor under it: the launch and a write of the output
                zeros = torch.empty_like(k_out)
                zero_ms = timed_ms(lambda: zeros.zero_(), flush)
                log(f"  zero_() of the output alone {zero_ms:.4f} ms")
            if key in masked:
                mask = args[-1]
                every_ms, every_by = bound(*every_selected(work[key])(*args))
                # the floor under the live work: the launch, the mask and the zero output
                none = list(args)
                none[-1] = torch.zeros_like(mask)
                empty_ms = timed_ms(lambda: kernel(*none), flush)
                zeros = torch.empty_like(k_out)
                zero_ms = timed_ms(lambda: zeros.zero_(), flush)
                log(f"  {int(mask.sum())} of {mask.numel()} (q, s) pairs live; bound if every selected "
                    f"{'superblock' if key == 'boundsum_gather' else 'block'} were computed {every_ms:.4f} ms "
                    f"({every_by}); every pair masked {empty_ms:.4f} ms; zero_() of the output alone "
                    f"{zero_ms:.4f} ms")
            if key in QDENSE_ARG:
                # zero columns past what shared memory holds: the kernel then looks every term up in L2
                wide = list(args)
                i = QDENSE_ARG[key]
                wide[i] = torch.nn.functional.pad(args[i], (0, L2_ROW_FLOATS - args[i].shape[1]))
                l2_out = kernel(*wide)
                torch.testing.assert_close(l2_out, p_out, **TOL)
                l2_ms = timed_ms(lambda: kernel(*wide), flush)
                log(f"  query row looked up from L2 instead of shared memory: {l2_ms:.4f} ms "
                    f"(bits equal: {torch.equal(l2_out, k_out)})")
            per_call.append((ms, err, plain_ms, bound_ms, bound_by, library_ms(key, args)))
        ms, err, plain_ms, bound_ms, bound_by, lib_ms = max(per_call, key=lambda p: p[0])  # the largest call
        rows.append({"name": key, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": n_launches, "max_abs_err": max(p[1] for p in per_call), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                     **({"call_site": site} if site else {}), **({"path": path} if path else {})})

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
        f"peak device memory since the LM-training phase began {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    profile_call(f"search_batch ({BATCH} requests)", lambda: retr.search_batch(batches[0]))
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
