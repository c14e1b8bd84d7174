// Fused document scoring of the live selected blocks (forward layout), for sm_90a.
//
// Replaces src/repro/kernels/doc_score/kernel.py::doc_score_fwd_pallas
// (_fwd_kernel), the TPU kernel of round 0 and phase 3:
//
//   out[q, s, j] = mask[q, s] ? sum_t qdense[q, tids[blk[q, s], j, t]] * ws[blk[q, s], j, t] : 0
//
// tids int32 and ws uint8/uint16 are [NB, b, T]; qdense is float32 [Q, Vp]
// whose last column (the sentinel term id == vocab) is zero, so padded term
// slots add nothing without a mask. mask is bool [Q, S]. Scale-free: the
// wrapper clamps block ids and applies the per-block dequant scales. Live
// entries are what the TPU kernel computes; masked entries are written as 0
// and their blocks are never read. The kernel assumes no order in the mask.
//
// Bound on the H100: bytes. Each live block streams b*T*(4 + 1) bytes of term
// ids and weights (~3.2 KB at b = 8, T = 80), read once; the work is one FMA
// per 5 bytes. At round 0 every pair is live; at phase 3 about 50 pairs of
// 256,000 are, so there the bound is the zero output and the mask.
//
// Design. A 1-D grid of one thread block per SM; each thread block owns a
// contiguous range of (q, s) pairs in row-major order and walks it in
// windows of kThreads pairs:
//  1. Each thread reads one mask entry; a ballot and a prefix over the warps
//     compact the window's live pairs and their block ids into a list in
//     shared memory, and the masked pairs' outputs are zeroed with coalesced
//     stores. A window with no live pair ends there: no copy, no query row.
//  2. The live list is cut into runs of one query (a thread block's pairs are
//     contiguous, so at most a few). Where a run has kRowMinPairs pairs or
//     more, the query row is copied into shared memory (122 KB at vocab
//     30,522) and every qdense[q, tid] lookup is a shared-memory read; a
//     shorter run (phase 3) looks its few hundred terms up through __ldg from
//     L2 instead of copying the whole row. A row too long for shared memory
//     is looked up through L2 in every run (at round 0 about 1.5x slower:
//     chip_smoke.py times both placements at the path's inputs).
//  3. Within a run the warps work independently: warp c scores the run's
//     pairs c, c + n_cons, ... and its lane 0 copies each into one of the
//     warp's own stages ahead of use, refilling a stage as soon as the warp
//     has read it. Where the block rows and pointers are 16-byte aligned
//     (b*T*4 and b*T*sizeof(WT) multiples of 16), the copies are 1-D TMA bulk
//     copies (cp.async.bulk) completing on the stage's mbarrier. A warp has
//     one or two stages, as many as fit beside the query row (n_cons <= 32
//     warps), so 31 to 64 blocks are in flight per SM with no barrier across
//     the thread block, and a stage serves one warp only, so no wait can run
//     a phase ahead of its barrier. Where the rows are not aligned (the small
//     test shapes), the warps read them with plain loads instead.
//  4. A warp scores a pair four document rows at a time: per row its lanes
//     stride over the T term slots and reduce with shuffles, in the same
//     order as before (lane-strided float32 sums, then shfl_down 16..1).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStagesPer = 2;      // stages of one warp
constexpr int kMaxStages = kWarps * kMaxStagesPer;  // block rows in flight per thread block
constexpr int kMinStages = 8;         // the query row goes to shared memory only beside this many
constexpr int kRowMinPairs = 8;       // a run of fewer live pairs looks the query row up in L2
constexpr int kMinPairsPerCta = 32;   // small launches use fewer thread blocks
constexpr int kSmemLimit = 232448;    // dynamic shared memory one H100 thread block may use
// stage barriers, live pairs and their block ids, masked flags, per-warp
// live counts (a multiple of 16)
constexpr int kHeadBytes = kMaxStages * 8 + kThreads * 8 + kThreads + kWarps * 4;
static_assert(kHeadBytes % 16 == 0, "stages must start 16-byte aligned");

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

// One thread: the stage's barrier expects n0 + n1 bytes, then two bulk copies bring them.
__device__ __forceinline__ void bulk_load(uint64_t* bar, void* dst0, const void* src0, uint32_t n0,
                                          void* dst1, const void* src1, uint32_t n1) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(n0 + n1)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst0)),
      "l"(src0), "r"(n0), "r"(smem_u32(bar))
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst1)),
      "l"(src1), "r"(n1), "r"(smem_u32(bar))
      : "memory");
}

template <bool kGlobal, typename T>
__device__ __forceinline__ T load(const T* p) {  // from device memory (read-only path) or shared memory
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

template <typename WT, bool kBulk, bool kRowSmem>
__device__ __forceinline__ void score_pair(const int32_t* ts, const WT* wr, const float* qrow, const float* qsrc,
                                           float* o, int b, int t, int lane) {
  constexpr int kRows = 4;  // rows at a time: their loads are independent and in flight together
  const float* q = kRowSmem ? qrow : qsrc;
  for (int j0 = 0; j0 < b; j0 += kRows) {
    float acc[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) acc[u] = 0.f;
    for (int k = lane; k < t; k += 32) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (j0 + u < b) {
          const int i = (j0 + u) * t + k;
          acc[u] += load<!kRowSmem>(q + load<!kBulk>(ts + i)) * static_cast<float>(load<!kBulk>(wr + i));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) acc[u] += __shfl_down_sync(0xffffffffu, acc[u], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (j0 + u < b) o[j0 + u] = acc[u];
      }
    }
  }
}

template <typename WT, bool kBulk, bool kQrowSmem>
__global__ void __launch_bounds__(kThreads, 1)
doc_score_fwd_kernel(const int32_t* __restrict__ tids3,
                     const WT* __restrict__ ws3,
                     const float* __restrict__ qdense,
                     const int32_t* __restrict__ blk,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ out,
                     int n_pairs, int n_sel, int b, int t, int vp,
                     int pairs_per_cta, int n_cons, int per_cons) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* live = reinterpret_cast<int*>(full + kMaxStages);
  int* live_blk = live + kThreads;
  unsigned char* masked = reinterpret_cast<unsigned char*>(live_blk + kThreads);
  int* warp_live = reinterpret_cast<int*>(masked + kThreads);
  unsigned char* stages = smem + kHeadBytes;
  const int bt = b * t;
  const int ws_off = round16(bt * 4);
  const int stage_bytes = ws_off + round16(bt * static_cast<int>(sizeof(WT)));
  const int n_stages = n_cons * per_cons;  // 0 on the plain-load path
  float* qrow = reinterpret_cast<float*>(stages + static_cast<size_t>(n_stages) * stage_bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (kBulk && tid == 0) {
    for (int s = 0; s < n_stages; ++s) bar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int p_begin = blockIdx.x * pairs_per_cta;
  const int p_end = min(n_pairs, p_begin + pairs_per_cta);
  int q_loaded = -1;
  int seq = 0;  // pairs this warp scored in earlier runs: fixes its stages' barrier phases

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
      live[i] = w0 + tid;
      live_blk[i] = blk[w0 + tid];
    }
    float* ow = out + static_cast<size_t>(w0) * b;
    for (int i = tid; i < n_win * b; i += kThreads) {
      if (masked[i / b]) ow[i] = 0.f;
    }
    __syncthreads();

    // ---- 2-4. runs of one query
    for (int r0 = 0; r0 < n_live;) {
      const int q = live[r0] / n_sel;
      int lo = r0 + 1, hi = n_live;  // r1 = first live pair of a later query (the list is sorted)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (live[mid] / n_sel == q) lo = mid + 1; else hi = mid;
      }
      const int r1 = lo;
      const float* qsrc = qdense + static_cast<size_t>(q) * vp;
      const bool row_smem = kQrowSmem && r1 - r0 >= kRowMinPairs;
      // warp c scores the run's pairs c, c + n_cons, ...; its lane 0 copies
      // each into one of the warp's own stages, per_cons pairs ahead
      const int n_mine = warp < n_cons ? max(0, (r1 - r0 - warp + n_cons - 1) / n_cons) : 0;
      auto fetch = [&](int i) {
        const int st = warp * per_cons + (seq + i) % per_cons;
        unsigned char* dst = stages + static_cast<size_t>(st) * stage_bytes;
        const size_t src = static_cast<size_t>(live_blk[r0 + warp + i * n_cons]) * bt;
        bulk_load(full + st, dst, tids3 + src, bt * 4, dst + ws_off, ws3 + src,
                  bt * static_cast<uint32_t>(sizeof(WT)));
      };
      if (kBulk && lane == 0) {  // the first copies overlap the query row's
        for (int i = 0; i < min(per_cons, n_mine); ++i) fetch(i);
      }
      if (row_smem && q != q_loaded) {
#pragma unroll 8
        for (int v = tid; v < vp; v += kThreads) qrow[v] = __ldg(qsrc + v);
        q_loaded = q;
      }
      __syncthreads();  // the query row is in place
      for (int i = 0; i < n_mine; ++i) {
        const int j = r0 + warp + i * n_cons;
        const int32_t* ts = tids3 + static_cast<size_t>(live_blk[j]) * bt;
        const WT* wr = ws3 + static_cast<size_t>(live_blk[j]) * bt;
        const int st = kBulk ? warp * per_cons + (seq + i) % per_cons : 0;
        if (kBulk) {
          bar_wait(full + st, static_cast<uint32_t>((seq + i) / per_cons) & 1u);
          ts = reinterpret_cast<const int32_t*>(stages + static_cast<size_t>(st) * stage_bytes);
          wr = reinterpret_cast<const WT*>(stages + static_cast<size_t>(st) * stage_bytes + ws_off);
        }
        float* o = out + static_cast<size_t>(live[j]) * b;
        if (row_smem) {
          score_pair<WT, kBulk, true>(ts, wr, qrow, qsrc, o, b, t, lane);
        } else {
          score_pair<WT, kBulk, false>(ts, wr, qrow, qsrc, o, b, t, lane);
        }
        if (kBulk) {
          __syncwarp();  // the stage is read: refill it
          if (lane == 0 && i + per_cons < n_mine) fetch(i + per_cons);
        }
      }
      seq += n_mine;
      __syncthreads();  // the run is scored: the query row may be replaced
      r0 = r1;
    }
  }
}

template <typename WT, bool kBulk, bool kQrowSmem>
int launch(const void* tids3, const void* ws3, const void* qdense, const void* blk, const void* mask,
           void* out, int n_pairs, int n_sel, int b, int t, int vp, cudaStream_t st) {
  const auto kernel = doc_score_fwd_kernel<WT, kBulk, kQrowSmem>;
  const int stage_bytes = round16(b * t * 4) + round16(b * t * static_cast<int>(sizeof(WT)));
  const int qrow_bytes = kQrowSmem ? vp * 4 : 0;
  // scoring warps, and stages of each: as many as fit beside the row, at most kMaxStagesPer
  const int fit = kBulk ? (kSmemLimit - kHeadBytes - qrow_bytes) / stage_bytes : kWarps;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_cons = std::min(kWarps, fit);
  const int per_cons = kBulk ? std::min(kMaxStagesPer, fit / n_cons) : 0;
  const int n_stages = n_cons * per_cons;
  const int smem = kHeadBytes + n_stages * stage_bytes + qrow_bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int grid = std::max(1, std::min(sms, (n_pairs + kMinPairsPerCta - 1) / kMinPairsPerCta));
  const int pairs_per_cta = (n_pairs + grid - 1) / grid;
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(tids3), static_cast<const WT*>(ws3), static_cast<const float*>(qdense),
      static_cast<const int32_t*>(blk), static_cast<const uint8_t*>(mask), static_cast<float*>(out),
      n_pairs, n_sel, b, t, vp, pairs_per_cta, n_cons, per_cons);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int dispatch(const void* tids3, const void* ws3, const void* qdense, const void* blk, const void* mask,
             void* out, int n_pairs, int n_sel, int b, int t, int vp, cudaStream_t st) {
  const int bt = b * t;
  const bool bulk = (bt * 4) % 16 == 0 && (bt * static_cast<int>(sizeof(WT))) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(tids3) % 16 == 0 && reinterpret_cast<uintptr_t>(ws3) % 16 == 0;
  // the row may go to shared memory where it fits beside kMinStages stages
  const int stage_bytes = round16(bt * 4) + round16(bt * static_cast<int>(sizeof(WT)));
  const bool fits = kHeadBytes + vp * 4 + (bulk ? kMinStages * stage_bytes : 0) <= kSmemLimit;
  if (bulk) {
    return fits ? launch<WT, true, true>(tids3, ws3, qdense, blk, mask, out, n_pairs, n_sel, b, t, vp, st)
                : launch<WT, true, false>(tids3, ws3, qdense, blk, mask, out, n_pairs, n_sel, b, t, vp, st);
  }
  return fits ? launch<WT, false, true>(tids3, ws3, qdense, blk, mask, out, n_pairs, n_sel, b, t, vp, st)
              : launch<WT, false, false>(tids3, ws3, qdense, blk, mask, out, n_pairs, n_sel, b, t, vp, st);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success).
// weight_bytes is 1 (uint8 weights) or 2 (uint16 weights).
extern "C" int doc_score_fwd_launch(const void* tids3, const void* ws3, const void* qdense, const void* blk,
                                    const void* mask, void* out, int q, int n_sel, int b, int t, int vp,
                                    int weight_bytes, void* stream) {
  if (q == 0 || n_sel == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pairs = q * n_sel;
  if (weight_bytes == 1) {
    return dispatch<uint8_t>(tids3, ws3, qdense, blk, mask, out, n_pairs, n_sel, b, t, vp, st);
  }
  if (weight_bytes == 2) {
    return dispatch<uint16_t>(tids3, ws3, qdense, blk, mask, out, n_pairs, n_sel, b, t, vp, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
