// Block BoundSums of the eligible selected superblocks only, for sm_90a.
//
// Replaces src/repro/kernels/boundsum_gather/kernel.py::boundsum_gather_pallas
// (_kernel), the TPU kernel of phase 2:
//
//   out[q, s, :] = mask[q, s] ? sum_i ws[q, i] * unpack(packed3[tids[q, i], sel[q, s], :]) : 0
//
// packed3 is the block-level bound matrix uint32 [V, NS * cw] viewed as
// [V, NS, cw]: one superblock's c block bounds are one granule of
// cw = c*bits/32 words (2 words at c = 16, 4 bits), laid out lane-strided
// within the granule (value v at word v % cw, bit-lane v / cw). Terms with
// ws == 0 are skipped. mask is bool [Q, S]: masked entries are written as 0
// and their granules are never read (their sel ids are loaded beside the mask
// but never used as addresses); the kernel assumes no order in the mask. Scale-free: the wrapper folds the scales into ws and
// clamps tids and sel.
//
// Bound on the H100: memory latency. Every live (term, superblock) pair reads
// one granule of cw words from a scattered address, a few bytes per request,
// so neither bandwidth nor arithmetic is near its limit; what helps is many
// independent loads in flight and few round trips in a row. Design:
//  - A thread block of 8 warps owns a window of kWindow selected superblocks
//    of one query. It first issues every load that depends on nothing: the
//    window's mask entries and superblock ids, and the query's term slots.
//    Warp 0 compacts the window's live pairs with a ballot; the masked pairs'
//    outputs are zeroed with coalesced stores. A window with no live pair
//    ends there.
//  - The query's terms of nonzero weight are compacted, in order, into
//    shared memory (ids and weights) once per thread block, kMaxStaged term
//    slots at a time (one chunk for any query the system sends), and every
//    live pair of the window takes each chunk, keeping its sums across
//    chunks. So a live pair's granule loads wait for one round trip to
//    device memory, not three.
//  - One warp per live pair: lane l takes word l % cw of the granule of
//    term slots l / cw, l / cw + 32 / cw, ...: the lanes of one term read its
//    granule's adjacent words together, 32 / cw terms a step, so a pair
//    needs ceil(live terms * cw / 32) loads per lane, all independent. Each
//    lane keeps the 32 / bits values of its word in registers.
//  - The partial sums are reduced across the term slots in a fixed tree of
//    shuffles (no atomics: the same bits on every call), and the lanes of
//    term slot 0 write the c values.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 32;          // selected superblocks of one query per thread block
constexpr int kMaxStaged = 4096;     // term slots staged in shared memory at a time (32 KB)
static_assert(kMaxStaged % kThreads == 0, "a chunk ends where a step of kThreads slots does");

template <int BITS>
__global__ void __launch_bounds__(kThreads)
boundsum_gather_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ tids,
                       const float* __restrict__ ws, const int32_t* __restrict__ sel,
                       const uint8_t* __restrict__ mask, float* __restrict__ out, int nq, int n_sel,
                       int row_words, int cw, int windows) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int kPairsPerWarp = kWindow / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_ids = reinterpret_cast<int*>(smem);  // [min(nq, kMaxStaged)]
  float* s_ws = reinterpret_cast<float*>(s_ids + min(nq, kMaxStaged));
  __shared__ int live[kWindow];     // window offsets of the live pairs
  __shared__ int live_sb[kWindow];  // and their superblock ids
  __shared__ unsigned live_bits;
  __shared__ int warp_terms[kWarps];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q = blockIdx.x / windows;
  const int s0 = (blockIdx.x - q * windows) * kWindow;
  const int n_win = min(kWindow, n_sel - s0);
  const size_t qs0 = static_cast<size_t>(q) * n_sel + s0;
  const int c = VPW * cw;
  const int32_t* qt = tids + static_cast<size_t>(q) * nq;
  const float* qw = ws + static_cast<size_t>(q) * nq;

  // ---- every independent load at once: the window's mask entries and
  // superblock ids (warp 0; an id is used only where its pair is live) and
  // the query's first kThreads term slots
  bool on = false;
  int sb = 0;
  if (warp == 0 && lane < n_win) {
    on = mask[qs0 + lane] != 0;
    sb = sel[qs0 + lane];
  }
  float wt = 0.f;
  int t = 0;
  unsigned t_ballot = 0;
  auto load_slots = [&](int i0) {  // slots i0 + tid, and each warp's count of nonzero weights
    const int i = i0 + tid;
    wt = i < nq ? qw[i] : 0.f;
    t = i < nq ? qt[i] : 0;
    t_ballot = __ballot_sync(0xffffffffu, wt != 0.f);
    if (lane == 0) warp_terms[warp] = __popc(t_ballot);
  };
  load_slots(0);
  // ---- the window's live pairs
  if (warp == 0) {
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (on) {
      const int k = __popc(ballot & ((1u << lane) - 1u));
      live[k] = lane;
      live_sb[k] = sb;
    }
    if (lane == 0) live_bits = ballot;
  }
  __syncthreads();
  const unsigned on_bits = live_bits;
  float* ow = out + qs0 * c;
  for (int i = tid; i < n_win * c; i += kThreads) {  // zero the masked pairs' outputs
    if (!((on_bits >> (i / c)) & 1u)) ow[i] = 0.f;
  }
  if (on_bits == 0) return;  // uniform across the thread block
  const int n_live = __popc(on_bits);

  // ---- one warp per live pair (warp w takes pairs w, w + kWarps, ...)
  const int tps = 32 / cw;   // term slots per step
  const int slot = lane / cw;
  const int word = lane - slot * cw;
  float acc[kPairsPerWarp][VPW];
#pragma unroll
  for (int k = 0; k < kPairsPerWarp; ++k) {
#pragma unroll
    for (int j = 0; j < VPW; ++j) acc[k][j] = 0.f;
  }
  for (int c0 = 0; c0 < nq; c0 += kMaxStaged) {
    if (c0 > 0) {  // the staged chunk is read: bring the next one's first slots
      __syncthreads();
      load_slots(c0);
      __syncthreads();
    }
    // the chunk's live terms, compacted in order into shared memory
    const int c1 = min(nq, c0 + kMaxStaged);
    int n_terms = 0;
    for (int i0 = c0;;) {
      int base = n_terms;
      for (int w = 0; w < kWarps; ++w) {
        base += w < warp ? warp_terms[w] : 0;
        n_terms += warp_terms[w];
      }
      if (wt != 0.f) {
        const int k = base + __popc(t_ballot & ((1u << lane) - 1u));
        s_ids[k] = t;
        s_ws[k] = wt;
      }
      i0 += kThreads;
      if (i0 >= c1) break;  // uniform
      __syncthreads();  // warp_terms is read before the next slots' counts replace it
      load_slots(i0);
      __syncthreads();
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairsPerWarp; ++k) {
      const int r = warp + k * kWarps;
      if (r >= n_live || slot >= tps) continue;
      const size_t granule = static_cast<size_t>(live_sb[r]) * cw + word;
      for (int i = slot; i < n_terms; i += tps) {
        const uint32_t v = __ldg(packed + static_cast<size_t>(s_ids[i]) * row_words + granule);
        const float w = s_ws[i];
#pragma unroll
        for (int j = 0; j < VPW; ++j) acc[k][j] += w * static_cast<float>((v >> (j * BITS)) & MASK);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPairsPerWarp; ++k) {
    const int r = warp + k * kWarps;
    if (r >= n_live) break;  // uniform across the warp
    // fixed-order tree over the term slots: slot k takes slot k + d where k % 2d == 0
    for (int d = 1; d < tps; d <<= 1) {
      const bool take = slot % (2 * d) == 0 && slot + d < tps;
#pragma unroll
      for (int j = 0; j < VPW; ++j) {
        const float y = __shfl_down_sync(0xffffffffu, acc[k][j], d * cw);
        if (take) acc[k][j] += y;
      }
    }
    if (slot == 0) {
      float* o = ow + static_cast<size_t>(live[r]) * c + word;
#pragma unroll
      for (int j = 0; j < VPW; ++j) o[j * cw] = acc[k][j];
    }
  }
}

template <int BITS>
int launch(const void* packed, const void* tids, const void* ws, const void* sel, const void* mask, void* out,
           int q, int nq, int n_sel, int row_words, int cw, cudaStream_t st) {
  const int windows = (n_sel + kWindow - 1) / kWindow;
  const long long grid = static_cast<long long>(q) * windows;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(std::min(nq, kMaxStaged)) * 8;
  boundsum_gather_kernel<BITS><<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(tids), static_cast<const float*>(ws),
      static_cast<const int32_t*>(sel), static_cast<const uint8_t*>(mask), static_cast<float*>(out), nq, n_sel,
      row_words, cw, windows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a cudaError_t code (0 on success).
// Needs 1 <= cw <= 32.
extern "C" int boundsum_gather_launch(const void* packed, const void* tids, const void* ws, const void* sel,
                                      const void* mask, void* out, int q, int nq, int n_sel, int row_words,
                                      int cw, int bits, void* stream) {
  if (q == 0 || n_sel == 0) return static_cast<int>(cudaSuccess);
  if (cw < 1 || cw > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4) return launch<4>(packed, tids, ws, sel, mask, out, q, nq, n_sel, row_words, cw, st);
  if (bits == 8) return launch<8>(packed, tids, ws, sel, mask, out, q, nq, n_sel, row_words, cw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
