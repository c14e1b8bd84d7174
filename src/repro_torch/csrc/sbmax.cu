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
// What holds it on the H100: at bmp's width (W = 16,384 words, a 33.5 MB
// output) the issue of the unpack and the FMAs (~3.25 instructions a value),
// above what its bytes need; at phase 1's (W = 1,024) the launch and memory
// latency: a query reads a few tens of 4 KB rows, a round trip each unless
// they are in flight together. Design:
//  - A thread block of 64 threads owns a tile of kThreads * VEC words (256
//    with 16-byte loads) of one query's row; thread t owns VEC consecutive
//    words. Blocks are ordered tile-major, so the queries that share a term
//    read its tile from L2 at about the same time.
//  - The query's terms of nonzero weight are compacted, in order, into
//    shared memory once per thread block, kMaxStaged term slots at a time
//    (one chunk for any query the system sends), the sums kept across
//    chunks. No term step reads device memory for anything but the row.
//  - Each thread streams its VEC words of the live terms' rows through its
//    own ring of STAGES slots in shared memory with cp.async, STAGES - 1
//    terms ahead of the one it sums. A slot is written and read by one
//    thread only, so the ring needs no barrier. Where the whole grid is
//    resident at once with a deep ring (32 slots: phase 1's 256 thread
//    blocks), a query's few tens of rows are all in flight at once; a larger
//    grid (bmp's 4,096) takes a shallow ring (8 slots), which lets ~2.5x as
//    many thread blocks share an SM and keeps its issue slots busy. The
//    depth changes no sum.
//  - The sums keep the present order: each output value is accumulated in
//    one thread, over the live terms in ascending order, one FMA a term.
//    The unpack costs no int-to-float conversion: the value's bits, masked
//    in place, are ORed into the mantissa of 2^23 and 2^23 is subtracted,
//    which gives v * 2^(bits*k) exactly for a value k lanes up the half
//    word; the weight is scaled by 2^-(bits*k) (exact for |w| >= 2^-114),
//    so each FMA sees the exact product w * v, as fmaf(w, (float)v, acc).
//  - The tile's [vpw, tile] sums go through shared memory and leave in
//    logical order: where the granule is a power of two that divides the
//    tile (2 and 4 for bmp, 128 for phase 1), the tile's outputs are one
//    contiguous run, stored with 16-byte stores in whole 128-byte lines.
//    Any other granule is stored bit-lane by bit-lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kDeepStages = 32;    // row loads in flight per thread, grids resident at once
constexpr int kShallowStages = 8;  // and larger grids
constexpr int kMaxStaged = 4096;   // term slots staged in shared memory at a time (32 KB)
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory a launch may use without opting in
constexpr int kSmemPerSm = 228 * 1024;   // an H100 SM's shared memory, 1 KB of it reserved per thread block
static_assert(kMaxStaged % kThreads == 0, "a chunk ends where a step of kThreads slots does");

template <int VEC>
struct Words;
template <>
struct Words<1> {
  using T = uint32_t;
  __device__ static uint32_t at(const T& v, int) { return v; }
};
template <>
struct Words<4> {
  using T = uint4;
  __device__ static uint32_t at(const T& v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }
};

// one thread's VEC words of a row into its ring slot
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BITS>
__host__ __device__ constexpr int log2_vpw() {
  return BITS == 4 ? 3 : 2;
}

// dynamic shared memory: the ring (which the output tile reuses), then the staged term ids and weights
template <int VEC, int STAGES>
size_t smem_bytes(int nq) {
  return static_cast<size_t>(STAGES) * kThreads * VEC * 4 + static_cast<size_t>(nq < kMaxStaged ? nq : kMaxStaged) * 8;
}

template <int BITS, int VEC, int STAGES>
__global__ void __launch_bounds__(kThreads)
sbmax_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ tids,
             const float* __restrict__ ws, float* __restrict__ out, int n_q, int nq, int n_words,
             int granule, int granule_shift) {
  using V = typename Words<VEC>::T;
  constexpr int VPW = 32 / BITS;
  constexpr int HALF = VPW / 2;  // values in each 16-bit half of a word
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int TILE = kThreads * VEC;  // words per thread block
  static_assert(STAGES >= VPW, "the output tile fits in the ring");
  static_assert((STAGES & (STAGES - 1)) == 0, "the ring index is a mask");
  extern __shared__ __align__(16) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);              // [STAGES][kThreads]
  float* tile_out = reinterpret_cast<float*>(smem);  // [VPW][TILE], once the ring is drained
  int* s_ids = reinterpret_cast<int*>(smem + static_cast<size_t>(STAGES) * kThreads * sizeof(V));
  float* s_ws = reinterpret_cast<float*>(s_ids + (nq < kMaxStaged ? nq : kMaxStaged));
  __shared__ int warp_terms[kWarps];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x / n_q;  // tile-major
  const int q = blockIdx.x - tile * n_q;
  const int w0 = tile * TILE;
  const int w = w0 + tid * VEC;
  const bool active = w < n_words;  // n_words % VEC == 0
  const uint32_t* col = packed + w;
  const int32_t* qt = tids + static_cast<size_t>(q) * nq;
  const float* qw = ws + static_cast<size_t>(q) * nq;
  V* my = ring + tid;  // this thread's slot k at my[k * kThreads]

  float acc[VEC][VPW];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
#pragma unroll
    for (int j = 0; j < VPW; ++j) acc[e][j] = 0.f;
  }

  for (int c0 = 0; c0 < nq; c0 += kMaxStaged) {
    // ---- the chunk's live terms, compacted in order into shared memory
    const int c1 = min(nq, c0 + kMaxStaged);
    int n_terms = 0;
    for (int i0 = c0; i0 < c1; i0 += kThreads) {
      const int i = i0 + tid;
      const float wt = i < c1 ? qw[i] : 0.f;
      const int t = i < c1 ? qt[i] : 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, wt != 0.f);
      if (lane == 0) warp_terms[warp] = __popc(ballot);
      __syncthreads();  // also: every thread is done with the previous chunk's staged terms
      int base = n_terms;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        base += k < warp ? warp_terms[k] : 0;
        n_terms += warp_terms[k];
      }
      if (wt != 0.f) {
        const int k = base + __popc(ballot & ((1u << lane) - 1u));
        s_ids[k] = t;
        s_ws[k] = wt;
      }
      __syncthreads();  // warp_terms is read before the next step's counts replace it
    }

    // ---- stream the live terms' words through this thread's ring, STAGES - 1 ahead
    auto issue = [&](int k) {
      if (active && k < n_terms) cp_async<VEC>(my + (k & (STAGES - 1)) * kThreads,
                                               col + static_cast<size_t>(s_ids[k]) * n_words);
      cp_async_commit();  // an empty group where there is no term: the count stays one a term
    };
#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) issue(k);
    for (int k = 0; k < n_terms; ++k) {
      cp_async_wait<STAGES - 2>();  // term k's group is complete
      issue(k + STAGES - 1);  // into the slot that term k - 1 left
      if (!active) continue;
      const V v = my[(k & (STAGES - 1)) * kThreads];
      const float wt = s_ws[k];
      float wk[HALF];
#pragma unroll
      for (int h = 0; h < HALF; ++h) wk[h] = wt * (1.0f / static_cast<float>(1u << (BITS * h)));
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const uint32_t lo = Words<VEC>::at(v, e);
        const uint32_t hi = lo >> 16;
#pragma unroll
        for (int j = 0; j < VPW; ++j) {
          const int h = j < HALF ? j : j - HALF;
          const uint32_t bits = ((j < HALF ? lo : hi) & (MASK << (BITS * h))) | 0x4B000000u;
          const float x = __uint_as_float(bits) - 8388608.0f;  // v * 2^(BITS*h), exactly
          acc[e][j] = __fmaf_rn(wk[h], x, acc[e][j]);
        }
      }
    }
    cp_async_wait<0>();
  }

  // ---- the tile's sums, in logical order, through shared memory
  __syncthreads();  // every thread's ring is drained: the tile may overwrite it
  if (active) {
#pragma unroll
    for (int j = 0; j < VPW; ++j) {
      float* dst = tile_out + j * TILE + tid * VEC;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      } else {
        dst[0] = acc[0][j];
      }
    }
  }
  __syncthreads();
  const int t_eff = min(TILE, n_words - w0);
  const int n_out = t_eff * VPW;
  float* o = out + static_cast<size_t>(q) * n_words * VPW;
  if (granule_shift >= 0 && granule <= TILE) {
    // granule a power of two dividing the tile: the outputs are the run
    // [w0 * VPW, (w0 + t_eff) * VPW), where position p is value j of word
    // s*G + g of the tile for p = (s*VPW + j)*G + g; stored 4 floats a thread
    float4* dst = reinterpret_cast<float4*>(o + static_cast<size_t>(w0) * VPW);
    const int gmask = granule - 1;
    for (int p4 = tid; p4 * 4 < n_out; p4 += kThreads) {
      const int p = p4 * 4;
      const int s = p >> (granule_shift + log2_vpw<BITS>());
      const int j = (p >> granule_shift) & (VPW - 1);
      const float* src = tile_out + j * TILE + (s << granule_shift) + (p & gmask);
      if (granule >= 4) {
        dst[p4] = *reinterpret_cast<const float4*>(src);
      } else {
        float e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pu = p + u;
          const int su = pu >> (granule_shift + log2_vpw<BITS>());
          const int ju = (pu >> granule_shift) & (VPW - 1);
          e[u] = tile_out[ju * TILE + (su << granule_shift) + (pu & gmask)];
        }
        dst[p4] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  } else {
    // any other granule: bit-lane by bit-lane, word w0 + t's value j at s*G*VPW + j*G + g
    for (int p = tid; p < n_out; p += kThreads) {
      const int j = p / t_eff;
      const int t = p - j * t_eff;
      const int s = (w0 + t) / granule;
      const int g = w0 + t - s * granule;
      o[static_cast<size_t>(s) * granule * VPW + j * granule + g] = tile_out[j * TILE + t];
    }
  }
}

template <int BITS, int VEC, int STAGES>
int run(const void* packed, const void* tids, const void* ws, void* out, int q, int nq, int n_words, int granule,
        int granule_shift, unsigned grid, cudaStream_t st) {
  const size_t smem = smem_bytes<VEC, STAGES>(nq);
  if (smem + 1024 > kSmemDefault) {  // only for long queries (~1,900 term slots with the deep ring)
    const cudaError_t err = cudaFuncSetAttribute(sbmax_kernel<BITS, VEC, STAGES>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sbmax_kernel<BITS, VEC, STAGES><<<grid, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(tids), static_cast<const float*>(ws),
      static_cast<float*>(out), q, nq, n_words, granule, granule_shift);
  return static_cast<int>(cudaGetLastError());
}

// the deep ring where the grid is resident at once with it (by shared memory), the shallow one otherwise
template <int BITS, int VEC>
int launch(const void* packed, const void* tids, const void* ws, void* out, int q, int nq, int n_words,
           int granule, int granule_shift, cudaStream_t st) {
  constexpr int TILE = kThreads * VEC;
  const long long grid = static_cast<long long>(q) * ((n_words + TILE - 1) / TILE);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long resident = static_cast<long long>(sms) * (kSmemPerSm / (smem_bytes<VEC, kDeepStages>(nq) + 1024));
  if (grid <= resident) {
    return run<BITS, VEC, kDeepStages>(packed, tids, ws, out, q, nq, n_words, granule, granule_shift,
                                       static_cast<unsigned>(grid), st);
  }
  return run<BITS, VEC, kShallowStages>(packed, tids, ws, out, q, nq, n_words, granule, granule_shift,
                                        static_cast<unsigned>(grid), st);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success). Needs
// granule >= 1 dividing n_words. Rows go through 16-byte loads where
// n_words % 4 == 0 and packed is 16-byte aligned, 4-byte loads otherwise.
extern "C" int sbmax_launch(const void* packed, const void* tids, const void* ws, void* out,
                            int q, int nq, int n_words, int granule, int bits, void* stream) {
  if (q == 0 || n_words == 0) return static_cast<int>(cudaSuccess);
  if (granule < 1 || n_words % granule) return static_cast<int>(cudaErrorInvalidValue);
  int granule_shift = -1;  // log2(granule) where it is a power of two
  if ((granule & (granule - 1)) == 0) {
    granule_shift = 0;
    while ((1 << granule_shift) < granule) ++granule_shift;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = n_words % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  if (bits == 4) {
    return vec4 ? launch<4, 4>(packed, tids, ws, out, q, nq, n_words, granule, granule_shift, st)
                : launch<4, 1>(packed, tids, ws, out, q, nq, n_words, granule, granule_shift, st);
  }
  if (bits == 8) {
    return vec4 ? launch<8, 4>(packed, tids, ws, out, q, nq, n_words, granule, granule_shift, st)
                : launch<8, 1>(packed, tids, ws, out, q, nq, n_words, granule, granule_shift, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
