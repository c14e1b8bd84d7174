// Document scoring of the live selected blocks over the flat layout, for sm_90a.
//
// Replaces src/repro/kernels/doc_score/kernel.py::doc_score_flat_pallas
// (_flat_kernel), the TPU kernel of round 0 and phase 3 under
// doc_layout="flat":
//
//   out[q, s, j] = mask[q, s] ? sum_{p in run j of block blk[q, s]} qdense[q, tids[blk, p]] * ws[blk, p] : 0
//
// tids int32 and ws uint8/uint16 are [NB, m]: each block's postings, sorted by
// (local doc, term) and padded with the sentinel term id (== vocab, zero
// weight). doc_ends int32 [NB, b] ends document j's run; it starts
// where run j-1 ends (0 for j = 0). qdense is float32 [Q, Vp] with a zero
// sentinel column. mask is bool [Q, S]. Scale-free: the wrapper clamps block
// ids and applies the per-block dequant scales. Live entries are what the TPU
// kernel computes; masked entries are written as 0 and their blocks are never
// read. The kernel assumes no order in the mask.
//
// Bound on the H100: bytes. A live block streams its doc_ends[b-1] live
// postings (5 or 6 bytes each, ~1.9 KB at b = 8 and a mean document length
// of 48), read once; the padding after them is never read. The work is one
// FMA per posting. At round 0 every pair is live; at phase 3 about 50 pairs
// of 256,000 are, so there the bound is the zero output and the mask.
//
// Design: the walk over live pairs of doc_score_common.cuh (1-D grid of
// thread blocks that each take a part of one query's pairs, ballot compaction
// of each window's live pairs, the query row in shared memory for windows of
// 8 or more live pairs where it fits, per-warp stages filled by TMA bulk
// copies), with this layout:
//  - Step 1 also reads each live block's posting count n = doc_ends[blk, b-1]
//    (clamped to m), all at once, so lane 0 knows the copy's size without a
//    dependent load.
//  - A stage holds one block's n live ids and weights. The rows are aligned
//    only to m's multiple (IndexBuildConfig.lane_pad = 8: uint8 weight
//    rows start 8-byte aligned), so each copy takes the 16-byte-aligned span
//    that covers the run and the scorer skips the head of the span. Where
//    the tensors' pointers or sizes are not multiples of 16 (so the span of
//    the last row could pass the tensor's end), or one stage does not fit in
//    shared memory, the warps read the rows with plain loads instead.
//  - A warp scores a pair with all 32 lanes over its postings, not a warp
//    per document: lanes are cut into groups of lpd lanes (the largest power
//    of two with lpd * b <= 32: 4 at b = 8), and group g sums document g's
//    run, which it reads from the block's doc_ends row (document j starts
//    where j - 1 ends; past 32 documents, in turns of 32). Each lane strides
//    its document by lpd and loads kBatch postings' terms before it adds them
//    (up to 256 lookups in flight a warp, what phase 3's lookups through L2
//    need), then each group reduces with shuffles: a segmented warp
//    reduction whose segments are the groups. The order of the additions is
//    fixed: no atomics, the same bits on every call. Each document is summed
//    directly, never as a difference of prefix sums, so its rounding error
//    scales with its own score. (A first design cut the postings into chunks
//    of 32 and resolved the document starts in each chunk with a segmented
//    scan over all 32 lanes, five shuffles a chunk; on the H100 its round 0
//    was slower, the scans costing more than the lookups.)

#include <cstdint>
#include <cuda_runtime.h>

#include "doc_score_common.cuh"

namespace {

using doc_score::load;
using doc_score::round16;

constexpr int kBatch = 8;  // postings a lane loads before it adds them: loads in flight together

// Blocks of the flat layout: the live run of m posting slots, one stage each.
template <typename WT>
struct FlatLayout {
  static constexpr bool kAux = true;  // aux = live postings of the block
  struct Pre {                        // run bounds of the lane's document in the first group
    int start, end;
  };
  const int32_t* tids;
  const WT* ws;
  const int32_t* doc_ends;
  int b, m, lpd, ids_cap, stage_bytes;  // lpd: lanes per document

  __device__ int aux(int bk) const {
    return min(max(__ldg(doc_ends + static_cast<size_t>(bk) * b + b - 1), 0), m);
  }
  // Document j's run is [doc_ends[j-1], doc_ends[j]) (from 0 for j = 0); past b, empty.
  __device__ Pre bounds(int bk, int j) const {
    const int32_t* e = doc_ends + static_cast<size_t>(bk) * b;
    if (j >= b) return {0, 0};
    return {j == 0 ? 0 : __ldg(e + j - 1), __ldg(e + j)};
  }
  __device__ Pre pre(int bk, int lane) const { return bounds(bk, lane / lpd); }
  // The 16-byte-aligned spans covering the block's first n ids and weights;
  // at least 16 bytes of ids (inside the tensor, whose size is a multiple of
  // 16), so every phase of the stage's barrier has bytes to wait for.
  __device__ void fetch(uint64_t* bar, unsigned char* dst, int bk, int n) const {
    const size_t row = static_cast<size_t>(bk) * m;
    const size_t i0 = (row * 4) & ~size_t{15}, i1 = max(((row + n) * 4 + 15) & ~size_t{15}, i0 + 16);
    const size_t w0 = (row * sizeof(WT)) & ~size_t{15}, w1 = ((row + n) * sizeof(WT) + 15) & ~size_t{15};
    doc_score::bulk_load(bar, dst, reinterpret_cast<const unsigned char*>(tids) + i0,
                         static_cast<uint32_t>(i1 - i0), dst + ids_cap,
                         reinterpret_cast<const unsigned char*>(ws) + w0, static_cast<uint32_t>(w1 - w0));
  }
  template <bool kBulk, bool kRowSmem>
  __device__ void score(const unsigned char* stage, int bk, int n, Pre first, const float* qrow,
                        const float* qsrc, float* o, int lane) const {
    constexpr int kWPer16 = 16 / static_cast<int>(sizeof(WT));
    const size_t row = static_cast<size_t>(bk) * m;
    const int32_t* ts = kBulk ? reinterpret_cast<const int32_t*>(stage) + (row & 3) : tids + row;
    const WT* wr = kBulk ? reinterpret_cast<const WT*>(stage + ids_cap) + (row & (kWPer16 - 1)) : ws + row;
    const float* q = kRowSmem ? qrow : qsrc;
    // lanes lpd * g .. lpd * g + lpd - 1 sum document g0 + g, in groups of
    // 32 / lpd documents (one group where b <= 32)
    const int sub = lane % lpd;
    for (int g0 = 0; g0 < b; g0 += 32 / lpd) {
      const int doc = g0 + lane / lpd;
      const Pre raw = g0 == 0 ? first : bounds(bk, doc);
      const int e = min(max(raw.end, 0), n);
      const int s = min(max(raw.start, 0), e);
      float acc = 0.f;
      for (int p0 = s + sub; p0 < e; p0 += kBatch * lpd) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int p = p0 + u * lpd;
          v[u] = p < e ? load<!kRowSmem>(q + load<!kBulk>(ts + p)) * static_cast<float>(load<!kBulk>(wr + p)) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) acc += v[u];
      }
      for (int off = lpd >> 1; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (sub == 0 && doc < b) o[doc] = acc;
    }
  }
};

template <typename WT, bool kBulk, bool kQrowSmem>
__global__ void __launch_bounds__(doc_score::kThreads, 1)
doc_score_flat_kernel(FlatLayout<WT> lay, const float* __restrict__ qdense, const int32_t* __restrict__ blk,
                      const uint8_t* __restrict__ mask, float* __restrict__ out, int n_sel, int b,
                      int vp, int pairs_per_cta, int parts, int n_cons, int per_cons) {
  doc_score::walk<FlatLayout<WT>, kBulk, kQrowSmem>(lay, qdense, blk, mask, out, n_sel, b, vp,
                                                    pairs_per_cta, parts, n_cons, per_cons);
}

template <typename WT, bool kBulk, bool kQrowSmem>
int launch(const FlatLayout<WT>& lay, const void* qdense, const void* blk, const void* mask, void* out,
           int q, int n_sel, int vp, cudaStream_t st) {
  return doc_score::launch_walk<true, kBulk, kQrowSmem>(
      doc_score_flat_kernel<WT, kBulk, kQrowSmem>, lay.stage_bytes, vp, q, n_sel, st, lay,
      static_cast<const float*>(qdense), static_cast<const int32_t*>(blk), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), n_sel, lay.b, vp);
}

template <typename WT>
int dispatch(const void* tids, const void* ws, const void* doc_ends, const void* qdense, const void* blk,
             const void* mask, void* out, int q, int n_sel, int nb, int b, int m, int vp, cudaStream_t st) {
  const int ids_cap = round16(m * 4) + 16;  // a 16-byte-aligned span covering up to m ids
  int lpd = 1;  // lanes per document: the largest power of two with lpd * b <= 32
  while (lpd * 2 * b <= 32) lpd *= 2;
  const FlatLayout<WT> lay{static_cast<const int32_t*>(tids), static_cast<const WT*>(ws),
                           static_cast<const int32_t*>(doc_ends), b, m, lpd, ids_cap,
                           ids_cap + round16(m * static_cast<int>(sizeof(WT))) + 16};
  const size_t slots = static_cast<size_t>(nb) * m;
  const bool bulk = reinterpret_cast<uintptr_t>(tids) % 16 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0 &&
                    (slots * 4) % 16 == 0 && (slots * sizeof(WT)) % 16 == 0 &&
                    doc_score::head_bytes<true>() + lay.stage_bytes <= doc_score::kSmemLimit;
  const bool fits = doc_score::row_fits<true>(vp, bulk, lay.stage_bytes);
  if (bulk) {
    return fits ? launch<WT, true, true>(lay, qdense, blk, mask, out, q, n_sel, vp, st)
                : launch<WT, true, false>(lay, qdense, blk, mask, out, q, n_sel, vp, st);
  }
  return fits ? launch<WT, false, true>(lay, qdense, blk, mask, out, q, n_sel, vp, st)
              : launch<WT, false, false>(lay, qdense, blk, mask, out, q, n_sel, vp, st);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success).
// weight_bytes is 1 (uint8 weights) or 2 (uint16 weights); nb is the number
// of blocks (rows of tids and ws).
extern "C" int doc_score_flat_launch(const void* tids, const void* ws, const void* doc_ends, const void* qdense,
                                     const void* blk, const void* mask, void* out, int q, int n_sel, int nb,
                                     int b, int m, int vp, int weight_bytes, void* stream) {
  if (q == 0 || n_sel == 0) return static_cast<int>(cudaSuccess);
  if (b < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bytes == 1) {
    return dispatch<uint8_t>(tids, ws, doc_ends, qdense, blk, mask, out, q, n_sel, nb, b, m, vp, st);
  }
  if (weight_bytes == 2) {
    return dispatch<uint16_t>(tids, ws, doc_ends, qdense, blk, mask, out, q, n_sel, nb, b, m, vp, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
