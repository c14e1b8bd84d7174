// SBMax / BoundSum over lane-strided packed bounds, for sm_90a.
//
// Replaces src/repro/kernels/sbmax/kernel.py::sbmax_pallas (_kernel), the TPU
// kernel of phase 1 (superblock max), SBavg (lsp2/sp) and bmp's all-block
// BoundSum:
//
//   out[q, n] = sum_i ws[q, i] * unpack(packed[tids[q, i], :])[n]
//
// packed is uint32 [V, W] in the lane-strided layout of index/pack.py: value v
// of segment s lives at word s*G + v%G, bit-lane v//G, for a granule of G
// words (128 for the superblock matrices, c*bits/32 for the block matrix).
// Terms with ws == 0 (the pruned / padded sentinels) are skipped. Scale-free:
// the wrapper folds the per-term scales into ws and clamps tids.
//
// Bound on the H100: bytes. Each live term reads one packed row (W words) and
// the output is Q x W*vpw floats; the arithmetic is vpw FMAs per word read,
// far below the card's float32 rate. Design: one thread per (query, word), a
// block of 128 threads per (query, 128-word tile). A warp reads 32
// consecutive words of a row (coalesced, 128 bytes), unpacks its vpw values
// in registers and accumulates over the query's terms; each thread writes
// its vpw sums at the logical positions s*G*vpw + j*G + g, which for G = 128
// are 128 consecutive floats per j (coalesced). The term loop is uniform in
// a block (same query), so skipping ws == 0 costs no divergence.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int BITS>
__global__ void sbmax_kernel(const uint32_t* __restrict__ packed,
                             const int32_t* __restrict__ tids,
                             const float* __restrict__ ws,
                             float* __restrict__ out,
                             int nq, int n_words, int granule) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int q = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= n_words) return;

  float acc[VPW];
#pragma unroll
  for (int j = 0; j < VPW; ++j) acc[j] = 0.f;

  const int32_t* qt = tids + static_cast<size_t>(q) * nq;
  const float* qw = ws + static_cast<size_t>(q) * nq;
  for (int i = 0; i < nq; ++i) {
    const float wt = qw[i];
    if (wt == 0.f) continue;
    const uint32_t word = __ldg(packed + static_cast<size_t>(qt[i]) * n_words + w);
#pragma unroll
    for (int j = 0; j < VPW; ++j) {
      acc[j] += wt * static_cast<float>((word >> (j * BITS)) & MASK);
    }
  }

  const int s = w / granule;
  const int g = w - s * granule;
  float* o = out + static_cast<size_t>(q) * n_words * VPW + static_cast<size_t>(s) * granule * VPW + g;
#pragma unroll
  for (int j = 0; j < VPW; ++j) o[static_cast<size_t>(j) * granule] = acc[j];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sbmax_launch(const void* packed, const void* tids, const void* ws, void* out,
                            int q, int nq, int n_words, int granule, int bits, void* stream) {
  if (q == 0 || n_words == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n_words + kThreads - 1) / kThreads, q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(packed);
  const auto* t = static_cast<const int32_t*>(tids);
  const auto* w = static_cast<const float*>(ws);
  auto* o = static_cast<float*>(out);
  if (bits == 4) {
    sbmax_kernel<4><<<grid, kThreads, 0, st>>>(p, t, w, o, nq, n_words, granule);
  } else if (bits == 8) {
    sbmax_kernel<8><<<grid, kThreads, 0, st>>>(p, t, w, o, nq, n_words, granule);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
