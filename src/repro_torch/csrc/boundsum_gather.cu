// Block BoundSums of the selected superblocks only, for sm_90a.
//
// Replaces src/repro/kernels/boundsum_gather/kernel.py::boundsum_gather_pallas
// (_kernel), the TPU kernel of phase 2:
//
//   out[q, s, :] = sum_i ws[q, i] * unpack(packed3[tids[q, i], sel[q, s], :])
//
// packed3 is the block-level bound matrix uint32 [V, NS * cw] viewed as
// [V, NS, cw]: one superblock's c block bounds are one granule of
// cw = c*bits/32 words (2 words at c = 16, 4 bits), laid out lane-strided
// within the granule (value v at word v % cw, bit-lane v / cw). Terms with
// ws == 0 are skipped. Scale-free: the wrapper folds the scales into ws and
// clamps tids and sel.
//
// Bound on the H100: memory latency. Every (term, superblock) pair reads one
// granule of cw words from a scattered address, a few bytes per request, so
// neither bandwidth nor arithmetic is near its limit; what helps is many
// independent loads in flight. Design: one thread per (query, selected
// superblock, granule word), so Q*S*cw threads each start their nq loads
// independently, and the thread's vpw sums go to out[q, s, j*cw + w].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int BITS>
__global__ void boundsum_gather_kernel(const uint32_t* __restrict__ packed,
                                       const int32_t* __restrict__ tids,
                                       const float* __restrict__ ws,
                                       const int32_t* __restrict__ sel,
                                       float* __restrict__ out,
                                       long long n_threads, int nq, int n_sel,
                                       int row_words, int cw) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_threads) return;
  const int w = static_cast<int>(idx % cw);
  const long long qs = idx / cw;  // q * n_sel + s
  const int q = static_cast<int>(qs / n_sel);
  const size_t granule = static_cast<size_t>(sel[qs]) * cw + w;

  float acc[VPW];
#pragma unroll
  for (int j = 0; j < VPW; ++j) acc[j] = 0.f;

  const int32_t* qt = tids + static_cast<size_t>(q) * nq;
  const float* qw = ws + static_cast<size_t>(q) * nq;
  for (int i = 0; i < nq; ++i) {
    const float wt = qw[i];
    if (wt == 0.f) continue;
    const uint32_t word = __ldg(packed + static_cast<size_t>(qt[i]) * row_words + granule);
#pragma unroll
    for (int j = 0; j < VPW; ++j) {
      acc[j] += wt * static_cast<float>((word >> (j * BITS)) & MASK);
    }
  }

  float* o = out + qs * VPW * cw + w;
#pragma unroll
  for (int j = 0; j < VPW; ++j) o[j * cw] = acc[j];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int boundsum_gather_launch(const void* packed, const void* tids, const void* ws,
                                      const void* sel, void* out, int q, int nq, int n_sel,
                                      int row_words, int cw, int bits, void* stream) {
  const long long n_threads = static_cast<long long>(q) * n_sel * cw;
  if (n_threads == 0) return static_cast<int>(cudaSuccess);
  const unsigned int blocks = static_cast<unsigned int>((n_threads + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(packed);
  const auto* t = static_cast<const int32_t*>(tids);
  const auto* w = static_cast<const float*>(ws);
  const auto* s = static_cast<const int32_t*>(sel);
  auto* o = static_cast<float*>(out);
  if (bits == 4) {
    boundsum_gather_kernel<4><<<blocks, kThreads, 0, st>>>(p, t, w, s, o, n_threads, nq, n_sel, row_words, cw);
  } else if (bits == 8) {
    boundsum_gather_kernel<8><<<blocks, kThreads, 0, st>>>(p, t, w, s, o, n_threads, nq, n_sel, row_words, cw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
