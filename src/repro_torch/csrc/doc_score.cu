// Fused document scoring of the selected blocks (forward layout), for sm_90a.
//
// Replaces src/repro/kernels/doc_score/kernel.py::doc_score_fwd_pallas
// (_fwd_kernel), the TPU kernel of round 0 and phase 3:
//
//   out[q, s, j] = sum_t qdense[q, tids[blk[q, s], j, t]] * ws[blk[q, s], j, t]
//
// tids int32 and ws uint8/uint16 are [NB, b, T]; qdense is float32 [Q, Vp]
// whose last column (the sentinel term id == vocab) is zero, so padded term
// slots add nothing without a mask. Scale-free: the wrapper clamps block ids
// and applies the per-block dequant scales. Masked blocks are scored too; the
// caller masks afterwards.
//
// Bound on the H100: bytes. Each selected block streams b*T*(4 + 1) bytes of
// term ids and weights (~3.5 KB at b = 8, T = 88), read once; the work is one
// FMA per 5 bytes. The random qdense[q, tid] lookups would be scattered
// 4-byte reads, so a thread block first copies the query's whole dense row
// (Vp floats, 122 KB at vocab 30,522) into shared memory, then serves every
// lookup from there. One thread block handles one query and a run of
// blocks_per_cta selected blocks, which spreads the cost of that copy; each
// warp scores one document row at a time, its lanes striding over the T term
// slots (coalesced reads of ids and weights) and reducing with shuffles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

template <typename WT>
__global__ void __launch_bounds__(kThreads)
doc_score_fwd_kernel(const int32_t* __restrict__ tids3,
                     const WT* __restrict__ ws3,
                     const float* __restrict__ qdense,
                     const int32_t* __restrict__ blk,
                     float* __restrict__ out,
                     int n_sel, int b, int t, int vp, int blocks_per_cta) {
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
    const size_t base = (static_cast<size_t>(blk[qs]) * b + j) * t;
    float acc = 0.f;
    for (int k = lane; k < t; k += 32) {
      acc += qrow[__ldg(tids3 + base + k)] * static_cast<float>(__ldg(ws3 + base + k));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[qs * b + j] = acc;
  }
}

template <typename WT>
int launch(const void* tids3, const void* ws3, const void* qdense, const void* blk, void* out,
           int q, int n_sel, int b, int t, int vp, int blocks_per_cta, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(vp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(doc_score_fwd_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_sel + blocks_per_cta - 1) / blocks_per_cta, q);
  doc_score_fwd_kernel<WT><<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(tids3), static_cast<const WT*>(ws3),
      static_cast<const float*>(qdense), static_cast<const int32_t*>(blk),
      static_cast<float*>(out), n_sel, b, t, vp, blocks_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success).
// weight_bytes is 1 (uint8 weights) or 2 (uint16 weights).
extern "C" int doc_score_fwd_launch(const void* tids3, const void* ws3, const void* qdense,
                                    const void* blk, void* out, int q, int n_sel, int b, int t,
                                    int vp, int weight_bytes, int blocks_per_cta, void* stream) {
  if (q == 0 || n_sel == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bytes == 1) {
    return launch<uint8_t>(tids3, ws3, qdense, blk, out, q, n_sel, b, t, vp, blocks_per_cta, st);
  }
  if (weight_bytes == 2) {
    return launch<uint16_t>(tids3, ws3, qdense, blk, out, q, n_sel, b, t, vp, blocks_per_cta, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
