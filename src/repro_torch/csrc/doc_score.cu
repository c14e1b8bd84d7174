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
// Design: the walk over live pairs of doc_score_common.cuh (1-D grid of
// thread blocks that each take a part of one query's pairs, ballot compaction
// of each window's live pairs, the query row in shared memory for windows of
// 8 or more live pairs where it fits, per-warp stages filled by TMA bulk
// copies), with this layout:
//  - A stage holds one block's b*T term ids and weights. The copies are bulk
//    where the block rows and pointers are 16-byte aligned (b*T*4 and
//    b*T*sizeof(WT) multiples of 16); otherwise (the small test shapes) the
//    warps read the rows with plain loads. A row too long for shared memory
//    is looked up through L2 in every window (at round 0 about 1.5x slower:
//    chip_smoke.py times both placements at the path's inputs).
//  - A warp scores a pair four document rows at a time: per row its lanes
//    stride over the T term slots and reduce with shuffles (lane-strided
//    float32 sums, then shfl_down 16..1).

#include <cstdint>
#include <cuda_runtime.h>

#include "doc_score_common.cuh"

namespace {

using doc_score::load;
using doc_score::round16;

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

// Blocks of the forward layout: b*T ids and weights, one stage each.
template <typename WT>
struct FwdLayout {
  static constexpr bool kAux = false;
  struct Pre {};
  const int32_t* tids3;
  const WT* ws3;
  int b, t, ws_off, stage_bytes;

  __device__ int aux(int) const { return 0; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void fetch(uint64_t* bar, unsigned char* dst, int bk, int) const {
    const int bt = b * t;
    const size_t src = static_cast<size_t>(bk) * bt;
    doc_score::bulk_load(bar, dst, tids3 + src, bt * 4, dst + ws_off, ws3 + src,
                         bt * static_cast<uint32_t>(sizeof(WT)));
  }
  template <bool kBulk, bool kRowSmem>
  __device__ void score(const unsigned char* stage, int bk, int, Pre, const float* qrow, const float* qsrc,
                        float* o, int lane) const {
    const size_t src = static_cast<size_t>(bk) * b * t;
    const int32_t* ts = kBulk ? reinterpret_cast<const int32_t*>(stage) : tids3 + src;
    const WT* wr = kBulk ? reinterpret_cast<const WT*>(stage + ws_off) : ws3 + src;
    score_pair<WT, kBulk, kRowSmem>(ts, wr, qrow, qsrc, o, b, t, lane);
  }
};

template <typename WT, bool kBulk, bool kQrowSmem>
__global__ void __launch_bounds__(doc_score::kThreads, 1)
doc_score_fwd_kernel(FwdLayout<WT> lay, const float* __restrict__ qdense, const int32_t* __restrict__ blk,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, int n_sel, int b,
                     int vp, int pairs_per_cta, int parts, int n_cons, int per_cons) {
  doc_score::walk<FwdLayout<WT>, kBulk, kQrowSmem>(lay, qdense, blk, mask, out, n_sel, b, vp,
                                                   pairs_per_cta, parts, n_cons, per_cons);
}

template <typename WT, bool kBulk, bool kQrowSmem>
int launch(const FwdLayout<WT>& lay, const void* qdense, const void* blk, const void* mask, void* out,
           int q, int n_sel, int vp, cudaStream_t st) {
  return doc_score::launch_walk<false, kBulk, kQrowSmem>(
      doc_score_fwd_kernel<WT, kBulk, kQrowSmem>, lay.stage_bytes, vp, q, n_sel, st, lay,
      static_cast<const float*>(qdense), static_cast<const int32_t*>(blk), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), n_sel, lay.b, vp);
}

template <typename WT>
int dispatch(const void* tids3, const void* ws3, const void* qdense, const void* blk, const void* mask,
             void* out, int q, int n_sel, int b, int t, int vp, cudaStream_t st) {
  const int bt = b * t;
  const bool bulk = (bt * 4) % 16 == 0 && (bt * static_cast<int>(sizeof(WT))) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(tids3) % 16 == 0 && reinterpret_cast<uintptr_t>(ws3) % 16 == 0;
  const int ws_off = round16(bt * 4);
  const FwdLayout<WT> lay{static_cast<const int32_t*>(tids3), static_cast<const WT*>(ws3), b, t, ws_off,
                          ws_off + round16(bt * static_cast<int>(sizeof(WT)))};
  const bool fits = doc_score::row_fits<false>(vp, bulk, lay.stage_bytes);
  if (bulk) {
    return fits ? launch<WT, true, true>(lay, qdense, blk, mask, out, q, n_sel, vp, st)
                : launch<WT, true, false>(lay, qdense, blk, mask, out, q, n_sel, vp, st);
  }
  return fits ? launch<WT, false, true>(lay, qdense, blk, mask, out, q, n_sel, vp, st)
              : launch<WT, false, false>(lay, qdense, blk, mask, out, q, n_sel, vp, st);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success).
// weight_bytes is 1 (uint8 weights) or 2 (uint16 weights).
extern "C" int doc_score_fwd_launch(const void* tids3, const void* ws3, const void* qdense, const void* blk,
                                    const void* mask, void* out, int q, int n_sel, int b, int t, int vp,
                                    int weight_bytes, void* stream) {
  if (q == 0 || n_sel == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bytes == 1) {
    return dispatch<uint8_t>(tids3, ws3, qdense, blk, mask, out, q, n_sel, b, t, vp, st);
  }
  if (weight_bytes == 2) {
    return dispatch<uint16_t>(tids3, ws3, qdense, blk, mask, out, q, n_sel, b, t, vp, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
