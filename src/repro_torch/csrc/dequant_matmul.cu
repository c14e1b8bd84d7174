// Product of a dense matrix with a 4- or 8-bit packed one, for sm_90a.
//
// Replaces src/repro/kernels/dequant_matmul/kernel.py::dequant_matmul_pallas
// (_kernel), the TPU kernel of the dense-embedding LSP bounds
// (core/lsp_dense.py::_bounds, q+ . maxW and q- . minW):
//
//   out[m, n] = sum_k x[m, k] * unpack(packed[k, :])[n]
//
// x is float32 or bfloat16 [M, K]; packed is uint32 [K, W] in the
// lane-strided layout of index/pack.py with a granule of 128 words: value v of
// segment s is at word s*128 + v%128, bit-lane v/128. out is float32
// [M, W * 32/bits] in logical column order, accumulated in float32 and
// unscaled (the caller folds the scales into x).
//
// Bound on the H100: on the dense path (M = 64 query rows, K = 64 dims,
// W = 128 words) the whole call moves ~0.3 MB and does ~8 MFLOP, so it is
// bound by launch latency; at large M and K it would be bound by the float32
// FMAs. Design: one thread per packed word column and a tile of kRows rows of
// x. The rows' K slice is staged in shared memory (converted to float32 once),
// and every thread walks K reading one word per step (a warp reads 128
// consecutive bytes), unpacks its vpw values in registers and adds
// kRows * vpw products into registers. With only M/kRows thread blocks on the
// card, a thread that waited for each word before the next would spend the
// call in load latency, so the loads of kUnroll steps are issued together
// before their products. The thread then writes its vpw sums of each row at
// logical columns s*128*vpw + j*128 + g, 128 consecutive floats per bit-lane
// j across the block. Any M: rows past M are zero in
// shared memory and are not written. No tensor cores: wgmma on the unpacked
// operand is work for a later change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one thread per word of a 128-word segment
constexpr int kRows = 8;       // rows of x per thread block
constexpr int kDepth = 256;    // K slice of x staged in shared memory
constexpr int kUnroll = 16;    // packed words loaded ahead of their use (divides kDepth)
constexpr int kGranule = 128;  // packing granule in words

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const XT* __restrict__ x,
                      const uint32_t* __restrict__ packed,
                      float* __restrict__ out,
                      int m, int k, int n_words) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ float xs[kRows][kDepth];
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * kRows;

  float acc[kRows][VPW];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < VPW; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kDepth) {
    const int kd = min(kDepth, k - k0);
    __syncthreads();  // the previous slice is no longer read
    for (int i = threadIdx.x; i < kRows * kDepth; i += kThreads) {
      const int r = i / kDepth;
      const int kk = i - r * kDepth;
      float v = 0.f;
      if (m0 + r < m && kk < kd) v = to_float(x[static_cast<size_t>(m0 + r) * k + k0 + kk]);
      xs[r][kk] = v;
    }
    __syncthreads();
    if (w < n_words) {
      const uint32_t* col = packed + static_cast<size_t>(k0) * n_words + w;
      for (int kk0 = 0; kk0 < kd; kk0 += kUnroll) {
        // kUnroll independent loads in flight before any is used; words past
        // kd read as 0 and meet zeros in xs, adding nothing
        uint32_t words[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          words[u] = kk0 + u < kd ? __ldg(col + static_cast<size_t>(kk0 + u) * n_words) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float wv[VPW];
#pragma unroll
          for (int j = 0; j < VPW; ++j) wv[j] = static_cast<float>((words[u] >> (j * BITS)) & MASK);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float xr = xs[r][kk0 + u];
#pragma unroll
            for (int j = 0; j < VPW; ++j) acc[r][j] += xr * wv[j];
          }
        }
      }
    }
  }
  if (w >= n_words) return;

  const int s = w / kGranule;
  const int g = w - s * kGranule;
  const size_t row_len = static_cast<size_t>(n_words) * VPW;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (m0 + r >= m) break;
    float* o = out + static_cast<size_t>(m0 + r) * row_len + static_cast<size_t>(s) * kGranule * VPW + g;
#pragma unroll
    for (int j = 0; j < VPW; ++j) o[static_cast<size_t>(j) * kGranule] = acc[r][j];
  }
}

template <typename XT>
int launch(const void* x, const void* packed, void* out, int m, int k, int n_words, int bits,
           cudaStream_t st) {
  const dim3 grid((n_words + kThreads - 1) / kThreads, (m + kRows - 1) / kRows);
  const auto* xp = static_cast<const XT*>(x);
  const auto* p = static_cast<const uint32_t*>(packed);
  auto* o = static_cast<float*>(out);
  if (bits == 4) {
    dequant_matmul_kernel<4, XT><<<grid, kThreads, 0, st>>>(xp, p, o, m, k, n_words);
  } else if (bits == 8) {
    dequant_matmul_kernel<8, XT><<<grid, kThreads, 0, st>>>(xp, p, o, m, k, n_words);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success).
// x_bytes is 4 (float32 x) or 2 (bfloat16 x); n_words is a multiple of 128.
extern "C" int dequant_matmul_launch(const void* x, const void* packed, void* out, int m, int k,
                                     int n_words, int bits, int x_bytes, void* stream) {
  if (m == 0 || n_words == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bytes == 4) return launch<float>(x, packed, out, m, k, n_words, bits, st);
  if (x_bytes == 2) return launch<__nv_bfloat16>(x, packed, out, m, k, n_words, bits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
