// The walk over live (query, block) pairs that both document-scoring kernels
// share (doc_score.cu: forward layout; doc_score_flat.cu: flat layout), for
// sm_90a. Each kernel supplies a Layout that says how one block is copied into
// a stage and scored; everything else is here.
//
// A 1-D grid of thread blocks, each owning a contiguous part of one query's
// S pairs: min(SMs / Q, ceil(S / kMinPairsPerCta)) parts a query, at least one (at
// Q = 64 and 132 SMs, halves; past 132 queries, one thread block a query).
// So a thread block makes at most one query-row copy. It walks its part in
// windows of kThreads pairs:
//  1. Each thread reads one mask entry; a ballot and a prefix over the warps
//     compact the window's live pairs and their block ids (and, where the
//     layout asks, one int of the block: Layout::aux) into a list in shared
//     memory, and the masked pairs' outputs are zeroed with coalesced stores.
//     A window with no live pair ends there: no copy, no query row.
//  2. Where the window has kRowMinPairs live pairs or more, the query row is
//     copied into shared memory (122 KB at vocab 30,522; once a thread
//     block) and every qdense[q, tid] lookup is a shared-memory read; a
//     window with fewer (phase 3) looks its few hundred terms up through
//     __ldg from L2 instead of copying the whole row. A row too long for
//     shared memory (beside kMinStages stages) is looked up through L2 in
//     every window. No option chooses the place: it depends only on whether
//     the row fits.
//  3. Within a window the warps work independently: warp c scores the live
//     pairs c, c + n_cons, ... and its lane 0 copies each into one of the
//     warp's own stages ahead of use (1-D TMA bulk copies, cp.async.bulk,
//     completing on the stage's mbarrier), refilling a stage as soon as the
//     warp has read it. A warp has one or two stages, as many as fit beside
//     the query row (n_cons <= 32 warps), with no barrier across the thread
//     block, and a stage serves one warp only, so no wait can run a phase
//     ahead of its barrier. Where the layout's rows cannot be bulk-copied
//     (16-byte alignment), the warps read them from device memory instead.
//  4. The layout scores the pair with the warp's 32 lanes and lane-local
//     writes of the pair's b outputs.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace doc_score {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStagesPer = 2;      // stages of one warp
constexpr int kMaxStages = kWarps * kMaxStagesPer;  // block rows in flight per thread block
constexpr int kMinStages = 8;         // the query row goes to shared memory only beside this many
constexpr int kRowMinPairs = 8;       // a run of fewer live pairs looks the query row up in L2
constexpr int kMinPairsPerCta = 32;   // small launches use fewer thread blocks
constexpr int kSmemLimit = 232448;    // dynamic shared memory one H100 thread block may use

// stage barriers, live pairs and their block ids, [the blocks' aux ints,]
// masked flags, per-warp live counts (a multiple of 16)
template <bool kAux>
__host__ __device__ constexpr int head_bytes() {
  return kMaxStages * 8 + kThreads * 8 + (kAux ? kThreads * 4 : 0) + kThreads + kWarps * 4;
}
static_assert(head_bytes<false>() % 16 == 0 && head_bytes<true>() % 16 == 0, "stages must start 16-byte aligned");

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {  // one arrival a phase
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint64_t* bar, void* dst, const void* src, uint32_t n) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

// One thread: the stage's barrier expects n0 + n1 bytes, then up to two bulk
// copies bring them (a copy of 0 bytes is not issued; with none the phase
// completes on the arrival). Addresses and sizes are multiples of 16.
__device__ __forceinline__ void bulk_load(uint64_t* bar, void* dst0, const void* src0, uint32_t n0,
                                          void* dst1, const void* src1, uint32_t n1) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(n0 + n1)
               : "memory");
  if (n0) bulk_copy(bar, dst0, src0, n0);
  if (n1) bulk_copy(bar, dst1, src1, n1);
}

template <bool kGlobal, typename T>
__device__ __forceinline__ T load(const T* p) {  // from device memory (read-only path) or shared memory
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// The kernel body. Layout provides:
//   kAux                       whether step 1 keeps an int of each live block
//   int aux(int blk)           that int, read by the thread that reads the mask
//   int stage_bytes            bytes of one stage (bulk path)
//   void fetch(bar, dst, blk, aux)                    lane 0: bulk-copy the block into a stage
//   Pre pre(blk, lane)                                loads issued before the stage's wait
//   void score<kBulk, kRowSmem>(stage, blk, aux, pre, qrow, qsrc, out_of_pair, lane)
template <class Layout, bool kBulk, bool kQrowSmem>
__device__ __forceinline__ void walk(const Layout lay, const float* __restrict__ qdense,
                                     const int32_t* __restrict__ blk, const uint8_t* __restrict__ mask,
                                     float* __restrict__ out, int n_sel, int b, int vp, int pairs_per_cta,
                                     int parts, int n_cons, int per_cons) {
  constexpr bool kAux = Layout::kAux;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* live = reinterpret_cast<int*>(full + kMaxStages);
  int* live_blk = live + kThreads;
  int* live_aux = live_blk + kThreads;  // kThreads ints where kAux, else none
  unsigned char* masked = reinterpret_cast<unsigned char*>(live_aux + (kAux ? kThreads : 0));
  int* warp_live = reinterpret_cast<int*>(masked + kThreads);
  unsigned char* stages = smem + head_bytes<kAux>();
  const int stage_bytes = lay.stage_bytes;
  const int n_stages = n_cons * per_cons;  // 0 on the plain-load path
  float* qrow = reinterpret_cast<float*>(stages + static_cast<size_t>(n_stages) * stage_bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (kBulk && tid == 0) {
    for (int s = 0; s < n_stages; ++s) bar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this thread block's pairs: part `blockIdx.x % parts` of query q's
  const int q = blockIdx.x / parts;
  const int p_begin = q * n_sel + (blockIdx.x - q * parts) * pairs_per_cta;
  const int p_end = min((q + 1) * n_sel, p_begin + pairs_per_cta);
  const float* qsrc = qdense + static_cast<size_t>(q) * vp;
  bool row_loaded = false;
  int seq = 0;  // pairs this warp scored in earlier windows: fixes its stages' barrier phases

  for (int w0 = p_begin; w0 < p_end; w0 += kThreads) {
    // ---- 1. compact the window's live pairs; zero the masked pairs' outputs
    const int n_win = min(kThreads, p_end - w0);
    const bool on = tid < n_win && mask[w0 + tid] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    masked[tid] = !on;
    __syncthreads();  // (the first one also publishes the barriers' init)
    int base = 0, n_live = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_live[w];
      base += w < warp ? c : 0;
      n_live += c;
    }
    if (on) {  // the block ids are read here, all at once, not by the thread that starts the copies
      const int i = base + __popc(ballot & ((1u << lane) - 1u));
      const int bk = blk[w0 + tid];
      live[i] = w0 + tid;
      live_blk[i] = bk;
      if constexpr (kAux) live_aux[i] = lay.aux(bk);
    }
    float* ow = out + static_cast<size_t>(w0) * b;
    for (int i = tid; i < n_win * b; i += kThreads) {
      if (masked[i / b]) ow[i] = 0.f;
    }
    __syncthreads();
    if (n_live == 0) continue;

    // ---- 2-4. the live pairs: warp c scores pairs c, c + n_cons, ...; its
    // lane 0 copies each into one of the warp's own stages, per_cons pairs ahead
    const bool row_smem = kQrowSmem && n_live >= kRowMinPairs;
    const int n_mine = warp < n_cons ? max(0, (n_live - warp + n_cons - 1) / n_cons) : 0;
    auto fetch = [&](int i) {
      const int st = warp * per_cons + (seq + i) % per_cons;
      const int j = warp + i * n_cons;
      lay.fetch(full + st, stages + static_cast<size_t>(st) * stage_bytes, live_blk[j],
                kAux ? live_aux[j] : 0);
    };
    if (kBulk && lane == 0) {  // the first copies overlap the query row's
      for (int i = 0; i < min(per_cons, n_mine); ++i) fetch(i);
    }
    if (row_smem && !row_loaded) {
#pragma unroll 8
      for (int v = tid; v < vp; v += kThreads) qrow[v] = __ldg(qsrc + v);
      row_loaded = true;
      __syncthreads();  // the query row is in place
    }
    for (int i = 0; i < n_mine; ++i) {
      const int j = warp + i * n_cons;
      const int bk = live_blk[j];
      const int ax = kAux ? live_aux[j] : 0;
      const auto pre = lay.pre(bk, lane);
      const int st = kBulk ? warp * per_cons + (seq + i) % per_cons : 0;
      const unsigned char* stage = stages + static_cast<size_t>(st) * stage_bytes;
      if (kBulk) bar_wait(full + st, static_cast<uint32_t>((seq + i) / per_cons) & 1u);
      float* o = out + static_cast<size_t>(live[j]) * b;
      if (row_smem) {
        lay.template score<kBulk, true>(stage, bk, ax, pre, qrow, qsrc, o, lane);
      } else {
        lay.template score<kBulk, false>(stage, bk, ax, pre, qrow, qsrc, o, lane);
      }
      if (kBulk) {
        __syncwarp();  // the stage is read: refill it
        if (lane == 0 && i + per_cons < n_mine) fetch(i + per_cons);
      }
    }
    seq += n_mine;
    __syncthreads();  // the window is scored: its live list may be replaced
  }
}

// Whether the query row goes to shared memory: where it fits beside the head
// and, on the bulk path, kMinStages stages.
template <bool kAux>
inline bool row_fits(int vp, bool bulk, int stage_bytes) {
  return head_bytes<kAux>() + vp * 4 + (bulk ? kMinStages * stage_bytes : 0) <= kSmemLimit;
}

// Sizes the stages and the grid and launches `kernel(args..., pairs_per_cta,
// parts, n_cons, per_cons)` over q queries of n_sel pairs (both > 0);
// returns a cudaError_t code.
template <bool kAux, bool kBulk, bool kQrowSmem, typename... KArgs, typename... Args>
int launch_walk(void (*kernel)(KArgs...), int stage_bytes, int vp, int q, int n_sel, cudaStream_t st,
                Args... args) {
  const int head = head_bytes<kAux>();
  const int qrow_bytes = kQrowSmem ? vp * 4 : 0;
  // scoring warps, and stages of each: as many as fit beside the row, at most kMaxStagesPer
  const int fit = kBulk ? (kSmemLimit - head - qrow_bytes) / stage_bytes : kWarps;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_cons = std::min(kWarps, fit);
  const int per_cons = kBulk ? std::min(kMaxStagesPer, fit / n_cons) : 0;
  const int n_stages = n_cons * per_cons;
  const int smem = head + n_stages * stage_bytes + qrow_bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // each thread block takes a part of one query's pairs: one query, one row copy
  int parts = std::max(1, std::min(sms / q, (n_sel + kMinPairsPerCta - 1) / kMinPairsPerCta));
  const int pairs_per_cta = (n_sel + parts - 1) / parts;
  parts = (n_sel + pairs_per_cta - 1) / pairs_per_cta;
  kernel<<<q * parts, kThreads, smem, st>>>(args..., pairs_per_cta, parts, n_cons, per_cons);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace doc_score
