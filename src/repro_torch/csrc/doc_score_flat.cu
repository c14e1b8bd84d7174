// Document scoring of the selected blocks over the flat layout, for sm_90a.
//
// Replaces src/repro/kernels/doc_score/kernel.py::doc_score_flat_pallas
// (_flat_kernel), the TPU kernel of round 0 and phase 3 under
// doc_layout="flat":
//
//   out[q, s, j] = sum_{p in run j of block blk[q, s]} qdense[q, tids[blk, p]] * ws[blk, p]
//
// tids int32 and ws uint8/uint16 are [NB, m]: each block's postings, sorted by
// (local doc, term) and padded with the sentinel term id (== vocab, zero
// weight). doc_ends int32 [NB, b] ends document j's run; it starts where run
// j-1 ends (0 for j = 0). qdense is float32 [Q, Vp] with a zero sentinel
// column. Scale-free: the wrapper clamps block ids and applies the per-block
// dequant scales. Masked blocks are scored too; the caller masks afterwards.
//
// Bound on the H100: bytes. A selected block streams its m postings (5 or 6
// bytes each) once; the work is one FMA per posting. As in doc_score.cu, the
// random qdense[q, tid] lookups go to a copy of the query's dense row in
// shared memory (122 KB at vocab 30,522), made once per thread block of
// blocks_per_cta selected blocks. One warp scores one document: its lanes
// stride over the document's contiguous run (coalesced reads of ids and
// weights) and reduce with shuffles. Each document is summed directly, not
// as a difference of prefix sums, so its rounding error scales with its own
// score. Only the first doc_ends[b-1] postings of a block are read; the
// padding after them is never touched.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

template <typename WT>
__global__ void __launch_bounds__(kThreads)
doc_score_flat_kernel(const int32_t* __restrict__ tids,
                      const WT* __restrict__ ws,
                      const int32_t* __restrict__ doc_ends,
                      const float* __restrict__ qdense,
                      const int32_t* __restrict__ blk,
                      float* __restrict__ out,
                      int n_sel, int b, int m, int vp, int blocks_per_cta) {
  extern __shared__ float qrow[];
  const int q = blockIdx.y;
  const float* src = qdense + static_cast<size_t>(q) * vp;
  for (int v = threadIdx.x; v < vp; v += kThreads) qrow[v] = src[v];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s0 = blockIdx.x * blocks_per_cta;
  const int s_end = min(n_sel, s0 + blocks_per_cta);
  const int rows = (s_end - s0) * b;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int s = s0 + r / b;
    const int j = r - (r / b) * b;
    const size_t qs = static_cast<size_t>(q) * n_sel + s;
    const size_t bk = static_cast<size_t>(blk[qs]);
    const int32_t* ends = doc_ends + bk * b;
    const int end = min(__ldg(ends + j), m);
    const int start = j == 0 ? 0 : min(__ldg(ends + j - 1), end);
    const int32_t* t = tids + bk * m;
    const WT* w = ws + bk * m;
    float acc = 0.f;
    for (int p = start + lane; p < end; p += 32) {
      acc += qrow[__ldg(t + p)] * static_cast<float>(__ldg(w + p));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[qs * b + j] = acc;
  }
}

template <typename WT>
int launch(const void* tids, const void* ws, const void* doc_ends, const void* qdense, const void* blk,
           void* out, int q, int n_sel, int b, int m, int vp, int blocks_per_cta, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(vp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(doc_score_flat_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_sel + blocks_per_cta - 1) / blocks_per_cta, q);
  doc_score_flat_kernel<WT><<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(tids), static_cast<const WT*>(ws),
      static_cast<const int32_t*>(doc_ends), static_cast<const float*>(qdense),
      static_cast<const int32_t*>(blk), static_cast<float*>(out), n_sel, b, m, vp, blocks_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success).
// weight_bytes is 1 (uint8 weights) or 2 (uint16 weights).
extern "C" int doc_score_flat_launch(const void* tids, const void* ws, const void* doc_ends,
                                     const void* qdense, const void* blk, void* out, int q, int n_sel,
                                     int b, int m, int vp, int weight_bytes, int blocks_per_cta,
                                     void* stream) {
  if (q == 0 || n_sel == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bytes == 1) {
    return launch<uint8_t>(tids, ws, doc_ends, qdense, blk, out, q, n_sel, b, m, vp, blocks_per_cta, st);
  }
  if (weight_bytes == 2) {
    return launch<uint16_t>(tids, ws, doc_ends, qdense, blk, out, q, n_sel, b, m, vp, blocks_per_cta, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
