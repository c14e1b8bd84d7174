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
// bound by latency: how many thread blocks share the work, and how many
// dependent steps each takes. At large M and K it would be bound by the
// float32 FMAs.
//
// Design. A thread block of 8 warps owns a tile of kWords = 32 packed words
// (one per lane) by ROWS rows of x, and splits K across its warps. ROWS is
// chosen at launch, the largest of 8, 4, 2, 1 that still gives at least one
// thread block per SM (the dense path: ROWS = 1, 64 x 4 = 256 thread blocks).
// Each K slice of the tile's packed words (kDepth rows of 128 bytes) is
// staged in shared memory with cp.async, 16 bytes a thread, and the slice of
// the ROWS rows of x with plain loads, converted to float32 once. Warp w then
// takes the slice's steps w, w + 8, ...: each lane reads its word (a warp
// reads 128 consecutive bytes), unpacks its vpw values in registers and adds
// ROWS * vpw products into registers, with x broadcast from shared memory. The
// eight partial sums of each output are then added in shared memory in warp
// order 0..7, so the result is deterministic: no atomics, the same bits on
// every call. The sum of (row, word, bit-lane j) goes to logical column
// s*128*vpw + j*128 + g, 32 consecutive floats a warp. Any M: rows past M are
// zero in shared memory and are not written. float32 x stays on float32 FMAs
// (TF32 would round x); no tensor cores.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWords = 32;    // packed words per tile, one per lane
constexpr int kDepth = 128;   // K rows of the tile staged in shared memory per slice
constexpr int kGranule = 128; // packing granule in words

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

template <int BITS, int ROWS, typename XT>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const XT* __restrict__ x,
                      const uint32_t* __restrict__ packed,
                      float* __restrict__ out,
                      int m, int k, int n_words) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ __align__(16) uint32_t ps[kDepth][kWords];  // 16 KB
  __shared__ float xs[ROWS][kDepth];
  __shared__ float part[kWarps][VPW][kWords];            // one row's partial sums

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * ROWS;
  const int w0 = blockIdx.y * kWords;

  float acc[ROWS][VPW];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < VPW; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kDepth) {
    const int kd = min(kDepth, k - k0);
    __syncthreads();  // the previous slice is no longer read
    for (int i = tid; i < kd * (kWords / 4); i += kThreads) {
      const int kk = i / (kWords / 4);
      const int c = i - kk * (kWords / 4);
      cp_async16(&ps[kk][c * 4], packed + static_cast<size_t>(k0 + kk) * n_words + w0 + c * 4);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = tid; i < ROWS * kDepth; i += kThreads) {
      const int r = i / kDepth;
      const int kk = i - r * kDepth;
      float v = 0.f;
      if (m0 + r < m && kk < kd) v = to_float(x[static_cast<size_t>(m0 + r) * k + k0 + kk]);
      xs[r][kk] = v;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int kk = warp; kk < kd; kk += kWarps) {
      const uint32_t word = ps[kk][lane];
      float wv[VPW];
#pragma unroll
      for (int j = 0; j < VPW; ++j) wv[j] = static_cast<float>((word >> (j * BITS)) & MASK);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float xr = xs[r][kk];
#pragma unroll
        for (int j = 0; j < VPW; ++j) acc[r][j] += xr * wv[j];
      }
    }
  }

  const size_t row_len = static_cast<size_t>(n_words) * VPW;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (m0 + r >= m) break;  // uniform across the thread block
    __syncthreads();  // the previous row's partial sums are read
#pragma unroll
    for (int j = 0; j < VPW; ++j) part[warp][j][lane] = acc[r][j];
    __syncthreads();
    if (tid < VPW * kWords) {
      const int j = tid / kWords;
      const int l = tid - j * kWords;
      float sum = part[0][j][l];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) sum += part[v][j][l];
      const int w = w0 + l;
      const int s = w / kGranule;
      out[static_cast<size_t>(m0 + r) * row_len + static_cast<size_t>(s) * kGranule * VPW +
          static_cast<size_t>(j) * kGranule + (w - s * kGranule)] = sum;
    }
  }
}

template <int BITS, int ROWS, typename XT>
int launch_rows(const void* x, const void* packed, void* out, int m, int k, int n_words, cudaStream_t st) {
  const dim3 grid((m + ROWS - 1) / ROWS, n_words / kWords);
  dequant_matmul_kernel<BITS, ROWS, XT><<<grid, kThreads, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const uint32_t*>(packed), static_cast<float*>(out), m, k, n_words);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename XT>
int launch(const void* x, const void* packed, void* out, int m, int k, int n_words, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = n_words / kWords;
  auto enough = [&](int rows) { return tiles * ((m + rows - 1) / rows) >= sms; };
  if (enough(8)) return launch_rows<BITS, 8, XT>(x, packed, out, m, k, n_words, st);
  if (enough(4)) return launch_rows<BITS, 4, XT>(x, packed, out, m, k, n_words, st);
  if (enough(2)) return launch_rows<BITS, 2, XT>(x, packed, out, m, k, n_words, st);
  return launch_rows<BITS, 1, XT>(x, packed, out, m, k, n_words, st);
}

template <typename XT>
int launch_bits(const void* x, const void* packed, void* out, int m, int k, int n_words, int bits,
                cudaStream_t st) {
  if (bits == 4) return launch<4, XT>(x, packed, out, m, k, n_words, st);
  if (bits == 8) return launch<8, XT>(x, packed, out, m, k, n_words, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success).
// x_bytes is 4 (float32 x) or 2 (bfloat16 x); n_words is a multiple of 128
// and at most 65535 * 32; packed is 16-byte aligned.
extern "C" int dequant_matmul_launch(const void* x, const void* packed, void* out, int m, int k,
                                     int n_words, int bits, int x_bytes, void* stream) {
  if (m == 0 || n_words == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bytes == 4) return launch_bits<float>(x, packed, out, m, k, n_words, bits, st);
  if (x_bytes == 2) return launch_bits<__nv_bfloat16>(x, packed, out, m, k, n_words, bits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
