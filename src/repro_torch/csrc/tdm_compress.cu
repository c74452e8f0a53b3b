// Hopper (sm_90a) kernels for blockwise TDM payload compression, with a
// plain C interface (loaded with ctypes by
// repro_torch/kernels/tdm_compress/tdm_compress.py).
//
// Every kernel works on a stacked (rows, row_len) float32 buffer: one row per
// FL node, cut into blocks of `block` elements per row (the last block of a
// row may be ragged; its missing lanes read as zero payload). One CUDA thread
// block handles one (row, block) pair, so a whole round's send or receive
// side over all nodes is ONE launch. Per-row scalars (Metropolis weights)
// come as a (rows,) float32 vector.
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

namespace {

constexpr int kThreads = 256;       // quantize / dequant_accumulate / scatter
constexpr int kSortThreads = 512;   // topk_sparsify
constexpr float kInv127 = 1.0f / 127.0f;

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

__device__ __forceinline__ BlockRef block_ref(int64_t row_len, int64_t nb_row,
                                              int block) {
  BlockRef r;
  r.bid = blockIdx.x;
  r.row = r.bid / nb_row;
  const int64_t j = r.bid - r.row * nb_row;
  const int64_t start = j * block;
  r.offset = r.row * row_len + start;
  const int64_t rem = row_len - start;
  r.len = static_cast<int>(rem < block ? rem : block);
  return r;
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
//           side.
// Bound: bytes. Reads x (4 B) and writes dense (4 B) per element, plus
//        8 B per selected entry: about 8 B/elem.
// Design: the TPU kernel runs k rounds of masked argmax; here one thread
//         block bitonic-sorts the block's (key, index) pairs in shared memory
//         by key descending, index ascending (key = |x|, NaN as +inf). All
//         pairs are distinct, so the order is total and equals the stable
//         descending argsort of the reference for every k. Keys compare as
//         floats: -0.0 and +0.0 tie and go to the lower index. The sort is
//         O(block log^2 block) work per block, far above the byte bound for
//         small k; it is kept for being simple and exact.
// ---------------------------------------------------------------------------
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
//           the CHOCO receive side, once per matching.
// Bound: bytes. Reads acc (4 B) and writes out (4 B) per element, plus 8 B
//        per received entry: about 8 B/elem.
// Design: the dense contribution is built in shared memory (zeros, then
//         0 + vals at idxs: indices are unique per block by contract, so no
//         atomics), and never touches HBM. Every lane then gets
//         fma(w, dense, acc) -- also the untouched ones, because the
//         reference's -0.0 + w*0 is +0.0 where a copy of acc would keep -0.0.
// ---------------------------------------------------------------------------
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

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

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

int tdm_topk_sparsify(const void* x, void* dense, void* vals, void* idxs,
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

int tdm_scatter_acc(const void* vals, const void* idxs, const void* acc,
                    const void* w, void* out, int64_t rows, int64_t row_len,
                    int64_t block, int64_t k, void* stream) {
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

}  // extern "C"
