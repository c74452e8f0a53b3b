// Hopper (sm_90a) kernels for blockwise TDM payload compression, with a
// plain C interface (loaded with ctypes by
// repro_torch/kernels/tdm_compress/tdm_compress.py).
//
// Every kernel works on a stacked (rows, row_len) float32 buffer: one row per
// FL node, cut into blocks of `block` elements per row (the last block of a
// row may be ragged; its missing lanes read as zero payload). One CUDA thread
// block handles one (row, block) pair, or, in the top-k select paths, one
// warp does, so a whole round's send or receive side over all nodes is ONE
// launch (the gossip fold, 7, takes 1024-lane chunks of a row). Per-row
// scalars (Metropolis weights) come as a (rows,) float32 vector.
//
// Rounding contract. The JAX reference runs under jit on XLA, which (a)
// rewrites the scale's `/ 127.0` into `* fl(1/127)` and (b) contracts
// `acc + w * v` into one fused multiply-add. The kernels spell both out with
// intrinsics (__fmul_rn, __fdiv_rn, __fmaf_rn, rintf), so they match the
// reference bit for bit and never depend on nvcc's contraction defaults.
// Build without --use_fast_math.
//
// Entry points take device pointers, sizes as int64_t and the CUDA stream,
// launch, and return cudaGetLastError() as an int (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;       // quantize / dequant_accumulate / scatter
constexpr int kSortThreads = 512;   // topk_sparsify, sort path
constexpr int kSelectMaxK = 32;     // select paths: one result (pair) per lane
constexpr int kWarpsPerCta = 8;     // select paths: one payload block per warp
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kInv127 = 1.0f / 127.0f;
constexpr int64_t kMaxGridX = 2147483647;   // a launch's largest grid.x

// max that propagates NaN, like XLA's max and torch.amax (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// round-half-even(x / scale), clipped to +-127; NaN -> 0 (XLA's convert)
__device__ __forceinline__ int8_t quantize_one(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(r);
}

struct BlockRef {
  int64_t bid;     // flat (row, block) id = row * nb_row + j
  int64_t row;
  int64_t offset;  // element offset of the block's first lane
  int len;         // real lanes in this block (< block only at a row's end)
};

__device__ __forceinline__ BlockRef block_at(int64_t bid, int64_t row_len,
                                             int64_t nb_row, int block) {
  BlockRef r;
  r.bid = bid;
  r.row = r.bid / nb_row;
  const int64_t j = r.bid - r.row * nb_row;
  const int64_t start = j * block;
  r.offset = r.row * row_len + start;
  const int64_t rem = row_len - start;
  r.len = static_cast<int>(rem < block ? rem : block);
  return r;
}

// the payload block of this thread block
__device__ __forceinline__ BlockRef block_ref(int64_t row_len, int64_t nb_row,
                                              int block) {
  return block_at(blockIdx.x, row_len, nb_row, block);
}

// The payload block of this warp in the select paths (kWarpsPerCta blocks
// per thread block); false for the warps past the last block.
__device__ __forceinline__ bool warp_block_ref(int64_t n_blocks, int64_t row_len,
                                               int64_t nb_row, int block,
                                               BlockRef& r) {
  const int64_t bid =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (bid >= n_blocks) return false;
  r = block_at(bid, row_len, nb_row, block);
  return true;
}

// Register layout of the select paths: a warp holds a block of up to 32 * E
// lanes, E (a power of two) in each CUDA lane. Slot s = j * V + c of CUDA
// lane l holds block-local index (l + 32 j) V + c: with V = 4 every j is one
// coalesced float4 access of the warp, and a lane's slots ascend in index.
template <int E>
struct Slots {
  static constexpr int V = E < 4 ? E : 4;
  static constexpr int J = E / V;
  static constexpr int W = (E + 31) / 32;  // 32-bit words of a slot mask
  __device__ static int index(int lane, int s) {
    return (lane + 32 * (s / V)) * V + s % V;
  }
  __device__ static int lane_of(int i) { return (i / V) & 31; }
  __device__ static int slot_of(int i) { return ((i / V) >> 5) * V + i % V; }
};

// v[slot] = p[index] for the block's first `len` lanes, 0 past them; float4
// loads where `vec` (p 16-byte aligned) and the four lanes are all real.
template <int E>
__device__ __forceinline__ void load_slots(const float* __restrict__ p, int len,
                                           bool vec, int lane, float (&v)[E]) {
  using L = Slots<E>;
#pragma unroll
  for (int j = 0; j < L::J; ++j) {
    const int i0 = (lane + 32 * j) * L::V;
    if constexpr (L::V == 4) {
      if (vec && i0 + 4 <= len) {
        const float4 t = *reinterpret_cast<const float4*>(p + i0);
        v[4 * j] = t.x;
        v[4 * j + 1] = t.y;
        v[4 * j + 2] = t.z;
        v[4 * j + 3] = t.w;
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < L::V; ++c)
      v[j * L::V + c] = (i0 + c < len) ? p[i0 + c] : 0.0f;
  }
}

// p[index] = v[slot] for the block's first `len` lanes only
template <int E>
__device__ __forceinline__ void store_slots(float* __restrict__ p, int len,
                                            bool vec, int lane,
                                            const float (&v)[E]) {
  using L = Slots<E>;
#pragma unroll
  for (int j = 0; j < L::J; ++j) {
    const int i0 = (lane + 32 * j) * L::V;
    if constexpr (L::V == 4) {
      if (vec && i0 + 4 <= len) {
        *reinterpret_cast<float4*>(p + i0) =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < L::V; ++c)
      if (i0 + c < len) p[i0 + c] = v[j * L::V + c];
  }
}

template <int W>
__device__ __forceinline__ bool has_bit(const uint32_t (&m)[W], int s) {
  return (m[s >> 5] >> (s & 31)) & 1u;
}

// m |= bit s for a slot known only at run time (registers have no dynamic
// index, so every word is visited)
template <int W>
__device__ __forceinline__ void set_bit(uint32_t (&m)[W], int s) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == (s >> 5)) m[w] |= 1u << (s & 31);
}

// ---------------------------------------------------------------------------
// 1. quantize
// Replaces: src/repro/kernels/tdm_compress/tdm_compress.py quantize_fwd
//           (_quant_kernel), the int8-gossip send side.
// Bound: bytes. Reads 4 B and writes 1 B per element (+4 B per block for the
//        scale): 5 B/elem against 3.35 TB/s of HBM.
// Design: one thread block per 1024-lane block, float4 loads; the absmax is a
//         warp-shuffle then shared-memory reduce; the second pass re-reads
//         the 4 KiB block from L1/L2, not HBM, so HBM sees one read.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int64_t row_len, int64_t nb_row,
                int block) {
  __shared__ float red[kThreads / 32];
  const BlockRef b = block_ref(row_len, nb_row, block);
  const float* xb = x + b.offset;
  int8_t* qb = q + b.offset;
  const bool vec = (b.len % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(xb) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(qb) % 4 == 0);

  float m = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    for (int i = threadIdx.x; i < b.len / 4; i += blockDim.x) {
      const float4 v = x4[i];
      m = nan_max(m, fabsf(v.x));
      m = nan_max(m, fabsf(v.y));
      m = nan_max(m, fabsf(v.z));
      m = nan_max(m, fabsf(v.w));
    }
  } else {
    for (int i = threadIdx.x; i < b.len; i += blockDim.x)
      m = nan_max(m, fabsf(xb[i]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float absmax = red[0];
  // max(absmax, 1e-12) keeping NaN, then XLA's `* fl(1/127)`
  const float clamped = (absmax != absmax) ? absmax : fmaxf(absmax, 1e-12f);
  const float scale = __fmul_rn(clamped, kInv127);
  if (threadIdx.x == 0) scales[b.bid] = scale;

  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    char4* q4 = reinterpret_cast<char4*>(qb);
    for (int i = threadIdx.x; i < b.len / 4; i += blockDim.x) {
      const float4 v = x4[i];
      q4[i] = make_char4(quantize_one(v.x, scale), quantize_one(v.y, scale),
                         quantize_one(v.z, scale), quantize_one(v.w, scale));
    }
  } else {
    for (int i = threadIdx.x; i < b.len; i += blockDim.x)
      qb[i] = quantize_one(xb[i], scale);
  }
}

// ---------------------------------------------------------------------------
// 2. dequant_accumulate
// Replaces: tdm_compress.py dequant_accumulate_fwd (_dequant_acc_kernel),
//           the int8-gossip receive side, once per matching, and the
//           ground-segment relay's fold of the int16 sums at the sinks.
// Bound: bytes. Reads q (1 B; 2 B for int16) and acc (4 B), writes out
//        (4 B): 9 B/elem for int8.
// Design: elementwise, one thread block per payload block so the block's
//         scale and the row's weight are loaded once. Weighted (w != null):
//         out = fma(w, q*s, acc) with the product rounded first, XLA's
//         contraction of the reference expression. Unit (w == null): the
//         reference passes the constant 1.0, XLA drops the multiply by it
//         and contracts what is left, so out = fma(q, s, acc), one rounding.
// ---------------------------------------------------------------------------
template <typename QT, bool kUnit>
__global__ void __launch_bounds__(kThreads)
dequant_acc_kernel(const QT* __restrict__ q, const float* __restrict__ scales,
                   const float* __restrict__ acc, const float* __restrict__ w,
                   float* __restrict__ out, int64_t row_len, int64_t nb_row,
                   int block) {
  const BlockRef b = block_ref(row_len, nb_row, block);
  const float s = scales[b.bid];
  const float wr = kUnit ? 1.0f : w[b.row];
  const QT* qb = q + b.offset;
  const float* ab = acc + b.offset;
  float* ob = out + b.offset;
  for (int i = threadIdx.x; i < b.len; i += blockDim.x) {
    const float v = static_cast<float>(qb[i]);
    ob[i] = kUnit ? __fmaf_rn(v, s, ab[i])
                  : __fmaf_rn(wr, __fmul_rn(v, s), ab[i]);
  }
}

// ---------------------------------------------------------------------------
// 3. topk_sparsify
// Replaces: tdm_compress.py topk_sparsify_fwd (_topk_kernel), the CHOCO send
//           side. Two paths, chosen by the wrapper from k: the select for
//           k <= TOPK_SELECT_MAX_K (the CHOCO round's k is 1 per block), the
//           sort above it.
// Bound: bytes. Reads x (4 B) and writes dense (4 B) per element, plus
//        8 B per selected entry: about 8 B/elem.
// Semantics (the reference's stable descending argsort): key = |x| with NaN
//        as +inf; ties go to the lower block-local index, -0.0 and +0.0
//        tie; lanes past a ragged row end are zero payload, selectable with
//        key 0 and value 0.0, never read or written in x or dense.
//
// 3a. select path. One warp per block, kWarpsPerCta blocks per thread block,
//         no shared memory and no __syncthreads. The warp loads the block
//         once into registers (float4 where aligned) and runs k rounds of
//         the TPU kernel's masked argmax: a candidate is the uint64
//         (bits(key) + 1) << 32 | (0xffffffff - index), whose unsigned max is
//         the largest key, then the lowest index (a non-negative float's
//         bits order as an unsigned integer; 0 is left free for "taken").
//         Each lane keeps the best of its own slots; a round is five
//         shuffles, and only the winning lane rescans its slots. Lane t keeps
//         round t's result, so vals/idxs are one coalesced store, and dense
//         is written from the registers. k rounds cost O(k E) per lane: at
//         the CHOCO round's k = 1 the kernel is bound by its bytes.
// 3b. sort path. One thread block bitonic-sorts the block's (key, index)
//         pairs in shared memory by key descending, index ascending; all
//         pairs are distinct, so the order is total and equals the
//         reference's for every k. O(block log^2 block) work per block,
//         whatever k: simple and exact, for the large k that the select's
//         k rounds would make slower still.
// ---------------------------------------------------------------------------

// (bits(|v|) + 1) with NaN as +inf: the unsigned order of the keys, 0 free
__device__ __forceinline__ uint32_t rank_key(float v) {
  const uint32_t b = __float_as_uint(v) & 0x7fffffffu;
  return (b > 0x7f800000u ? 0x7f800000u : b) + 1u;
}

// The lane's best untaken candidate (0 if none) and its value.
template <int E>
__device__ __forceinline__ unsigned long long lane_best(
    const float (&v)[E], const uint32_t (&taken)[Slots<E>::W], int lane,
    float& val) {
  uint32_t bk = 0;
  int bs = 0;
  float bv = 0.0f;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const uint32_t kk = has_bit(taken, s) ? 0u : rank_key(v[s]);
    if (kk > bk) {  // strict: among equal keys the first slot, lowest index
      bk = kk;
      bs = s;
      bv = v[s];
    }
  }
  val = bv;
  if (bk == 0) return 0ull;
  const uint32_t idx = static_cast<uint32_t>(Slots<E>::index(lane, bs));
  return (static_cast<unsigned long long>(bk) << 32) | (0xffffffffu - idx);
}

template <int E>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
topk_select_kernel(const float* __restrict__ x, float* __restrict__ dense,
                   float* __restrict__ vals, int32_t* __restrict__ idxs,
                   int64_t n_blocks, int64_t row_len, int64_t nb_row,
                   int block, int k) {
  using L = Slots<E>;
  BlockRef b;
  if (!warp_block_ref(n_blocks, row_len, nb_row, block, b)) return;
  const int lane = threadIdx.x & 31;
  const float* xb = x + b.offset;
  float* db = dense + b.offset;
  const bool vec = (reinterpret_cast<uintptr_t>(xb) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  float v[E];
  load_slots<E>(xb, b.len, vec, lane, v);
  uint32_t taken[L::W];
#pragma unroll
  for (int w = 0; w < L::W; ++w) taken[w] = 0u;
#pragma unroll
  for (int s = 0; s < E; ++s)  // slots past the block never compete
    if (L::index(lane, s) >= block) taken[s >> 5] |= 1u << (s & 31);

  float best_v;
  unsigned long long best = lane_best<E>(v, taken, lane, best_v);
  float out_v = 0.0f;
  int32_t out_i = 0;
  for (int t = 0; t < k; ++t) {
    unsigned long long win = best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFullMask, win, off);
      win = o > win ? o : win;
    }
    const int wi = static_cast<int>(0xffffffffu - static_cast<uint32_t>(win));
    const int owner = L::lane_of(wi);
    const float wv = __shfl_sync(kFullMask, best_v, owner);
    if (lane == t) {
      out_v = wv;
      out_i = wi;
    }
    if (lane == owner) {
      set_bit(taken, L::slot_of(wi));
      best = lane_best<E>(v, taken, lane, best_v);
    }
  }
  if (lane < k) {
    vals[b.bid * k + lane] = out_v;
    idxs[b.bid * k + lane] = out_i;
  }
  // dense: x at the selected lanes, 0 elsewhere (the slots past the block
  // are marked too, but lie past len and are never stored)
#pragma unroll
  for (int s = 0; s < E; ++s)
    if (!has_bit(taken, s)) v[s] = 0.0f;
  store_slots<E>(db, b.len, vec, lane, v);
}

__global__ void __launch_bounds__(kSortThreads)
topk_kernel(const float* __restrict__ x, float* __restrict__ dense,
            float* __restrict__ vals, int32_t* __restrict__ idxs,
            int64_t row_len, int64_t nb_row, int block, int k, int p2) {
  extern __shared__ unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);
  int* idx = reinterpret_cast<int*>(key + p2);
  unsigned char* sel = reinterpret_cast<unsigned char*>(idx + p2);
  const BlockRef b = block_ref(row_len, nb_row, block);
  const float* xb = x + b.offset;

  for (int i = threadIdx.x; i < p2; i += blockDim.x) {
    float kk;
    if (i < b.len) {
      const float v = xb[i];
      kk = (v != v) ? INFINITY : fabsf(v);
    } else {
      // zero payload past a ragged row end (selectable, key 0); sort
      // padding past the block gets key -1, below every real key
      kk = (i < block) ? 0.0f : -1.0f;
    }
    key[i] = kk;
    idx[i] = i;
  }
  for (int i = threadIdx.x; i < block; i += blockDim.x) sel[i] = 0;
  __syncthreads();

  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p2 / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const float klo = key[lo], khi = key[hi];
        const int ilo = idx[lo], ihi = idx[hi];
        const bool hi_first = (khi > klo) || (khi == klo && ihi < ilo);
        const bool up = (lo & size) == 0;
        if (hi_first == up) {
          key[lo] = khi; key[hi] = klo;
          idx[lo] = ihi; idx[hi] = ilo;
        }
      }
      __syncthreads();
    }
  }

  float* vb = vals + b.bid * k;
  int32_t* ib = idxs + b.bid * k;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const int i = idx[t];
    vb[t] = (i < b.len) ? xb[i] : 0.0f;
    ib[t] = i;
    sel[i] = 1;
  }
  __syncthreads();
  float* db = dense + b.offset;
  for (int i = threadIdx.x; i < b.len; i += blockDim.x)
    db[i] = sel[i] ? xb[i] : 0.0f;
}

// ---------------------------------------------------------------------------
// 4. scatter_accumulate
// Replaces: tdm_compress.py scatter_accumulate_fwd (_scatter_acc_kernel),
//           the CHOCO receive side, once per matching. Two paths, chosen by
//           the wrapper from k as in topk_sparsify.
// Bound: bytes. Reads acc (4 B) and writes out (4 B) per element, plus 8 B
//        per received entry: about 8 B/elem.
// Semantics: every lane gets fma(w, c, acc), c = 0 + v at a received index
//        and 0 elsewhere -- also the untouched lanes, because the
//        reference's -0.0 + w*0 is +0.0 where a copy of acc would keep
//        -0.0. Indices are unique per block by contract (no atomics);
//        indices outside the block are ignored.
// 4a. select path. One warp per block, kWarpsPerCta blocks per thread block,
//         no shared memory and no __syncthreads: acc is loaded once into
//         registers (float4 where aligned), lane t loads pair t, each pair is
//         broadcast with __shfl_sync and applied by the lane that owns its
//         index, and the warp stores fma(w, c, acc) with float4 stores.
// 4b. shared path. One thread block per block builds the dense
//         contribution in shared memory (zeros, then 0 + vals at idxs) and
//         runs one read-FMA-write pass over acc; for k above the select's.
// ---------------------------------------------------------------------------
template <int E>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
scatter_select_kernel(const float* __restrict__ vals,
                      const int32_t* __restrict__ idxs,
                      const float* __restrict__ acc, const float* __restrict__ w,
                      float* __restrict__ out, int64_t n_blocks,
                      int64_t row_len, int64_t nb_row, int block, int k) {
  using L = Slots<E>;
  BlockRef b;
  if (!warp_block_ref(n_blocks, row_len, nb_row, block, b)) return;
  const int lane = threadIdx.x & 31;
  const float* ab = acc + b.offset;
  float* ob = out + b.offset;
  const bool vec = (reinterpret_cast<uintptr_t>(ab) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(ob) % 16 == 0);
  float a[E];
  load_slots<E>(ab, b.len, vec, lane, a);
  const float wr = w[b.row];
  int32_t my_i = -1;
  float my_v = 0.0f;
  if (lane < k) {
    my_i = idxs[b.bid * k + lane];
    my_v = vals[b.bid * k + lane];
  }
  uint32_t hit[L::W];
#pragma unroll
  for (int w = 0; w < L::W; ++w) hit[w] = 0u;
  for (int t = 0; t < k; ++t) {
    const int i = __shfl_sync(kFullMask, my_i, t);
    const float c = __fadd_rn(0.0f, __shfl_sync(kFullMask, my_v, t));
    if (i >= 0 && i < block && lane == L::lane_of(i)) {
      const int slot = L::slot_of(i);
#pragma unroll
      for (int s = 0; s < E; ++s)
        if (s == slot) a[s] = __fmaf_rn(wr, c, a[s]);
      set_bit(hit, slot);
    }
  }
#pragma unroll
  for (int s = 0; s < E; ++s)
    if (!has_bit(hit, s)) a[s] = __fmaf_rn(wr, 0.0f, a[s]);
  store_slots<E>(ob, b.len, vec, lane, a);
}

__global__ void __launch_bounds__(kThreads)
scatter_acc_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ idxs,
                   const float* __restrict__ acc, const float* __restrict__ w,
                   float* __restrict__ out, int64_t row_len, int64_t nb_row,
                   int block, int k) {
  extern __shared__ float contrib[];
  const BlockRef b = block_ref(row_len, nb_row, block);
  for (int i = threadIdx.x; i < block; i += blockDim.x) contrib[i] = 0.0f;
  __syncthreads();
  const float* vb = vals + b.bid * k;
  const int32_t* ib = idxs + b.bid * k;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const int i = ib[t];
    if (i >= 0 && i < block) contrib[i] = __fadd_rn(0.0f, vb[t]);
  }
  __syncthreads();
  const float wr = w[b.row];
  const float* ab = acc + b.offset;
  float* ob = out + b.offset;
  for (int i = threadIdx.x; i < b.len; i += blockDim.x)
    ob[i] = __fmaf_rn(wr, contrib[i], ab[i]);
}

// ---------------------------------------------------------------------------
// 5. quantize_scaled
// Replaces: tdm_compress.py quantize_scaled_fwd (_quant_scaled_kernel), the
//           ground-segment relay's encode with scales shared by all nodes.
// Bound: bytes. Reads x (4 B) and writes q (1 B) per element, plus 4 B per
//        block of scales: 5 B/elem.
// Design: one thread block per (row, block), float4 loads where aligned.
//         The scale of block j of row r is scales[r * scale_row_stride + j]:
//         stride 0 reads one (nb,) vector shared by every row, stride nb a
//         per-row (rows, nb) one. The divisor is a runtime value in the
//         reference, so this is a true division (__fdiv_rn), then rintf
//         (half to even) and the clip; NaN codes become 0.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
quantize_scaled_kernel(const float* __restrict__ x,
                       const float* __restrict__ scales,
                       int8_t* __restrict__ q, int64_t row_len, int64_t nb_row,
                       int block, int64_t scale_row_stride) {
  const BlockRef b = block_ref(row_len, nb_row, block);
  const int64_t j = b.bid - b.row * nb_row;
  const float scale = scales[b.row * scale_row_stride + j];
  const float* xb = x + b.offset;
  int8_t* qb = q + b.offset;
  const bool vec = (b.len % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(xb) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(qb) % 4 == 0);
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    char4* q4 = reinterpret_cast<char4*>(qb);
    for (int i = threadIdx.x; i < b.len / 4; i += blockDim.x) {
      const float4 v = x4[i];
      q4[i] = make_char4(quantize_one(v.x, scale), quantize_one(v.y, scale),
                         quantize_one(v.z, scale), quantize_one(v.w, scale));
    }
  } else {
    for (int i = threadIdx.x; i < b.len; i += blockDim.x)
      qb[i] = quantize_one(xb[i], scale);
  }
}

// ---------------------------------------------------------------------------
// 6. dequantize
// Replaces: tdm_compress.py dequantize_fwd (_dequant_kernel), q * scale.
// Bound: bytes. Reads q (1 B) and writes x (4 B) per element, plus 4 B per
//        block of scales: 5 B/elem.
// Design: elementwise, one thread block per (row, block) so the block's
//         scale is loaded once; scales addressed as in quantize_scaled. The
//         product is rounded once (__fmul_rn), as the reference's multiply.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t row_len, int64_t nb_row, int block,
                  int64_t scale_row_stride) {
  const BlockRef b = block_ref(row_len, nb_row, block);
  const int64_t j = b.bid - b.row * nb_row;
  const float s = scales[b.row * scale_row_stride + j];
  const int8_t* qb = q + b.offset;
  float* ob = out + b.offset;
  for (int i = threadIdx.x; i < b.len; i += blockDim.x)
    ob[i] = __fmul_rn(static_cast<float>(qb[i]), s);
}

// ---------------------------------------------------------------------------
// 7. gossip_dequant_acc (the int8 gossip's receive side, gossip_fold)
// Replaces: no TPU kernel of its own. It fuses what the reference's int8
//           gossip runs per matching, a ppermute of codes and scales and one
//           dequant_accumulate_fwd (_dequant_acc_kernel) into an accumulator
//           of zeros, and then the self term, into one pass.
// Bound: bytes. Reads x (4 B) and writes out (4 B) per element, plus the
//        codes (1 B) of each arrival: 9 B/elem where every row has one
//        arrival on average.
// Semantics: per element of row i, from a row plan (src (M, rows): the row
//         that i receives over matching m, -1 outside it; w (M, rows); diag
//         (rows,)),
//           a = +0; for m: if src >= 0: a = fma(w_m[i], q[src] * s[src], a)
//           out = a + diag[i] * x[i]
//         the roundings of the unfused chain (zeros, one dequant_acc_kernel
//         a matching, then acc + diag * x), so it is bit-identical to it.
//         Skipping a row outside m is exact: the chain folds a zeroed
//         arrival at weight 0 there, and its accumulator is never -0.
// Design: one float4 group of 4 lanes a thread, so every load and store of
//         a warp is one contiguous run: x and out as float4, each arrival's
//         codes as char4 with one scale (4 divides `block`). One thread
//         block takes kFoldChunk lanes of one row, whose plan entries are
//         uniform loads; a row's own x is loaded before its arrivals, so the
//         loads overlap, and x and the codes through the read-only path
//         (__ldg). Sized by measurement at the slot's (8, 194 384 896)
//         buffer (H100, one and two matchings): 4.56-4.61 ms, 91% of the
//         bytes' bound, where plain loads took 4.71-4.88 ms, two or four
//         groups a thread (40 and 64 registers) 4.7-5.0 ms, a persistent
//         grid over (row, chunk) pairs 4.95 ms, and streaming cache hints
//         (__ldcs / __stcs) 2-3% more.
// ---------------------------------------------------------------------------
constexpr int kFoldChunk = kThreads * 4;   // lanes per thread block

__device__ __forceinline__ float fold_lane(float a, float wm, int8_t c, float sc) {
  return __fmaf_rn(wm, __fmul_rn(static_cast<float>(c), sc), a);
}

__device__ __forceinline__ float self_lane(float a, float d, float x) {
  return __fadd_rn(a, __fmul_rn(d, x));
}

__global__ void __launch_bounds__(kThreads)
gossip_dequant_acc_kernel(const float* __restrict__ x,
                          const int8_t* __restrict__ q,
                          const float* __restrict__ scales,
                          const int32_t* __restrict__ src,
                          const float* __restrict__ w,
                          const float* __restrict__ diag,
                          float* __restrict__ out, int64_t rows,
                          int64_t row_len, int64_t nb_row, int block,
                          int n_match, int64_t chunks_row) {
  const int64_t n_items = rows * chunks_row;
  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int64_t row = item / chunks_row;
    const int64_t col = (item - row * chunks_row) * kFoldChunk + 4 * threadIdx.x;
    if (col >= row_len) continue;
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x + row * row_len + col));
    const int64_t j = col / block;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int m = 0; m < n_match; ++m) {
      const int64_t s = src[m * rows + row];
      if (s < 0) continue;
      const float wm = w[m * rows + row];
      const float sc = scales[s * nb_row + j];
      const char4 c = __ldg(reinterpret_cast<const char4*>(q + s * row_len + col));
      a.x = fold_lane(a.x, wm, c.x, sc);
      a.y = fold_lane(a.y, wm, c.y, sc);
      a.z = fold_lane(a.z, wm, c.z, sc);
      a.w = fold_lane(a.w, wm, c.w, sc);
    }
    const float d = diag[row];
    *reinterpret_cast<float4*>(out + row * row_len + col) =
        make_float4(self_lane(a.x, d, xv.x), self_lane(a.y, d, xv.y),
                    self_lane(a.z, d, xv.z), self_lane(a.w, d, xv.w));
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Calls f(std::integral_constant<int, E>) with E the select paths' slots per
// lane for `block`: the power of two with 32 E >= block. False above 4096.
template <typename F>
bool with_slots(int64_t block, F&& f) {
  if (block <= 32) f(std::integral_constant<int, 1>{});
  else if (block <= 64) f(std::integral_constant<int, 2>{});
  else if (block <= 128) f(std::integral_constant<int, 4>{});
  else if (block <= 256) f(std::integral_constant<int, 8>{});
  else if (block <= 512) f(std::integral_constant<int, 16>{});
  else if (block <= 1024) f(std::integral_constant<int, 32>{});
  else if (block <= 2048) f(std::integral_constant<int, 64>{});
  else if (block <= 4096) f(std::integral_constant<int, 128>{});
  else return false;
  return true;
}

template <typename QT, bool kUnit>
void dequant_acc_grid(const void* q, const void* scales, const void* acc,
                      const void* w, void* out, int64_t grid, int64_t row_len,
                      int64_t nb_row, int64_t block, cudaStream_t st) {
  dequant_acc_kernel<QT, kUnit><<<grid, kThreads, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(acc), static_cast<const float*>(w),
      static_cast<float*>(out), row_len, nb_row, static_cast<int>(block));
}

}  // namespace

extern "C" {

int tdm_quantize(const void* x, void* q, void* scales, int64_t rows,
                 int64_t row_len, int64_t block, void* stream) {
  const int64_t nb_row = cdiv(row_len, block);
  if (rows * nb_row == 0) return 0;
  quantize_kernel<<<rows * nb_row, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), row_len, nb_row, static_cast<int>(block));
  return static_cast<int>(cudaGetLastError());
}

// w == nullptr selects the unit-weight form, fma(q, s, acc)
static int dequant_acc_launch(int q_bits, const void* q, const void* scales,
                              const void* acc, const void* w, void* out,
                              int64_t rows, int64_t row_len, int64_t block,
                              void* stream) {
  const int64_t nb_row = cdiv(row_len, block);
  if (rows * nb_row == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t grid = rows * nb_row;
  if (q_bits == 8) {
    if (w == nullptr)
      dequant_acc_grid<int8_t, true>(q, scales, acc, w, out, grid, row_len,
                                     nb_row, block, st);
    else
      dequant_acc_grid<int8_t, false>(q, scales, acc, w, out, grid, row_len,
                                      nb_row, block, st);
  } else {
    if (w == nullptr)
      dequant_acc_grid<int16_t, true>(q, scales, acc, w, out, grid, row_len,
                                      nb_row, block, st);
    else
      dequant_acc_grid<int16_t, false>(q, scales, acc, w, out, grid, row_len,
                                       nb_row, block, st);
  }
  return static_cast<int>(cudaGetLastError());
}

int tdm_dequant_acc_i8(const void* q, const void* scales, const void* acc,
                       const void* w, void* out, int64_t rows, int64_t row_len,
                       int64_t block, void* stream) {
  return dequant_acc_launch(8, q, scales, acc, w, out, rows, row_len, block,
                            stream);
}

int tdm_dequant_acc_i16(const void* q, const void* scales, const void* acc,
                        const void* w, void* out, int64_t rows,
                        int64_t row_len, int64_t block, void* stream) {
  return dequant_acc_launch(16, q, scales, acc, w, out, rows, row_len, block,
                            stream);
}

// select path of topk_sparsify: k <= kSelectMaxK
int tdm_topk_select(const void* x, void* dense, void* vals, void* idxs,
                    int64_t rows, int64_t row_len, int64_t block, int64_t k,
                    void* stream) {
  const int64_t nb_row = cdiv(row_len, block);
  const int64_t n_blocks = rows * nb_row;
  if (n_blocks == 0 || k == 0) return 0;
  if (k > kSelectMaxK || k > block) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t grid = cdiv(n_blocks, kWarpsPerCta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = with_slots(block, [&](auto e) {
    topk_select_kernel<decltype(e)::value><<<grid, kWarpsPerCta * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(dense),
        static_cast<float*>(vals), static_cast<int32_t*>(idxs), n_blocks,
        row_len, nb_row, static_cast<int>(block), static_cast<int>(k));
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// sort path of topk_sparsify: any k <= block
int tdm_topk_sort(const void* x, void* dense, void* vals, void* idxs,
                  int64_t rows, int64_t row_len, int64_t block, int64_t k,
                  void* stream) {
  const int64_t nb_row = cdiv(row_len, block);
  if (rows * nb_row == 0 || k == 0) return 0;
  int p2 = 1;
  while (p2 < block) p2 <<= 1;
  const size_t smem = static_cast<size_t>(p2) * (sizeof(float) + sizeof(int)) +
                      static_cast<size_t>(block);
  topk_kernel<<<rows * nb_row, kSortThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(dense),
      static_cast<float*>(vals), static_cast<int32_t*>(idxs), row_len, nb_row,
      static_cast<int>(block), static_cast<int>(k), p2);
  return static_cast<int>(cudaGetLastError());
}

// select path of scatter_accumulate: k <= kSelectMaxK
int tdm_scatter_acc_select(const void* vals, const void* idxs, const void* acc,
                           const void* w, void* out, int64_t rows,
                           int64_t row_len, int64_t block, int64_t k,
                           void* stream) {
  const int64_t nb_row = cdiv(row_len, block);
  const int64_t n_blocks = rows * nb_row;
  if (n_blocks == 0) return 0;
  if (k > kSelectMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t grid = cdiv(n_blocks, kWarpsPerCta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = with_slots(block, [&](auto e) {
    scatter_select_kernel<decltype(e)::value><<<grid, kWarpsPerCta * 32, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(idxs),
        static_cast<const float*>(acc), static_cast<const float*>(w),
        static_cast<float*>(out), n_blocks, row_len, nb_row,
        static_cast<int>(block), static_cast<int>(k));
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// shared path of scatter_accumulate: any k
int tdm_scatter_acc_shared(const void* vals, const void* idxs, const void* acc,
                           const void* w, void* out, int64_t rows,
                           int64_t row_len, int64_t block, int64_t k,
                           void* stream) {
  const int64_t nb_row = cdiv(row_len, block);
  if (rows * nb_row == 0) return 0;
  scatter_acc_kernel<<<rows * nb_row, kThreads,
                       static_cast<size_t>(block) * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(idxs),
      static_cast<const float*>(acc), static_cast<const float*>(w),
      static_cast<float*>(out), row_len, nb_row, static_cast<int>(block),
      static_cast<int>(k));
  return static_cast<int>(cudaGetLastError());
}

// scale_row_stride: 0 when one (nb,) vector of scales serves every row,
// nb for per-row (rows, nb) scales.
int tdm_quantize_scaled(const void* x, const void* scales, void* q,
                        int64_t rows, int64_t row_len, int64_t block,
                        int64_t scale_row_stride, void* stream) {
  const int64_t nb_row = cdiv(row_len, block);
  if (rows * nb_row == 0) return 0;
  quantize_scaled_kernel<<<rows * nb_row, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scales),
      static_cast<int8_t*>(q), row_len, nb_row, static_cast<int>(block),
      scale_row_stride);
  return static_cast<int>(cudaGetLastError());
}

int tdm_dequantize(const void* q, const void* scales, void* out, int64_t rows,
                   int64_t row_len, int64_t block, int64_t scale_row_stride,
                   void* stream) {
  const int64_t nb_row = cdiv(row_len, block);
  if (rows * nb_row == 0) return 0;
  dequantize_kernel<<<rows * nb_row, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), row_len, nb_row, static_cast<int>(block),
      scale_row_stride);
  return static_cast<int>(cudaGetLastError());
}

// The int8 gossip's receive side over a row plan of n_match matchings: src
// and w (n_match, rows), diag (rows,). row_len and block multiples of 4; x
// and out 16-byte aligned, q 4-byte aligned.
int tdm_gossip_fold(const void* x, const void* q, const void* scales,
                    const void* src, const void* w, const void* diag,
                    void* out, int64_t rows, int64_t row_len, int64_t block,
                    int64_t n_match, void* stream) {
  if (row_len % 4 != 0 || block % 4 != 0 || n_match < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks_row = cdiv(row_len, kFoldChunk);
  const int64_t n_items = rows * chunks_row;
  if (n_items == 0) return 0;
  const int64_t grid = n_items < kMaxGridX ? n_items : kMaxGridX;
  gossip_dequant_acc_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<const int32_t*>(src),
      static_cast<const float*>(w), static_cast<const float*>(diag),
      static_cast<float*>(out), rows, row_len, cdiv(row_len, block),
      static_cast<int>(block), static_cast<int>(n_match), chunks_row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
