// Hopper (sm_90a) kernels for attention, prefill and decode, with a plain C
// interface (loaded with ctypes by
// repro_torch/kernels/flash_attention/flash_attention.py).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
//           flash_attention_fwd (_fa_kernel), the Pallas TPU kernel whose
//           grid runs (batch*head, q block, kv block) with the kv axis
//           sequential, carrying the online-softmax state (m, l and a
//           (block_q, head_dim) float32 accumulator) in VMEM scratch, GQA by
//           its BlockSpec index maps (head h reads kv head h // G), and the
//           causal/window blocks out of range skipped with pl.when.
//
// What they compute (kernels/flash_attention/ref.py attention_ref):
//   s[q, t] = scale * q . k_t, scale = hd^-0.5
//   s       = cap * tanh(s / cap)                        (when cap > 0)
//   s       = -1e30 where masked
//   out[q]  = sum_t softmax(s[q])_t v_t
// in float32 throughout (inputs upcast as they are loaded; p is never
// rounded to the inputs' type), the output in the inputs' type.
//
// - flash_attention_fwd (prefill, q_offset 0, Sq = Skv = S): causal
//   (t <= q) and/or window (t > q - window) masks; any S, the ragged last
//   tiles masked here (keys t >= S) and not written (queries q >= S).
// - flash_attention_decode (serving decode): no causal or window mask, a
//   per-row kv_len (B,) int32 device tensor, keys t >= kv_len[b] masked
//   (kv_len must be in [1, L]; tiles past it are skipped). kv_len is read on
//   the card only, so a decode step never waits for the host.
//
// Layout: the model's own. q and out (B, S, H, hd), k and v (B, L, KV, hd),
// all contiguous; kv head g = h / (H / KV) serves G = H / KV query heads, so
// K and V are never repeated in memory. head_dim is a template parameter
// (16, 32, 64, 128 or 256), so every per-thread array lives in registers.
//
// Bound on this card: float32 arithmetic for the prefill. At the serving
// prefill's shape (8 lanes x 16 heads, S 512, hd 256, causal) the causal
// triangle is 17.2 GFLOP against 100.7 MB, i.e. 0.257 ms at the 67 TFLOP/s
// float32 (non-tensor-core) peak against 0.030 ms of HBM time. The decode is
// bytes: at 8 lanes and a 529-token cache it reads 34.7 MB of K and V for
// 69 MFLOP, 10.4 us at 3.35 TB/s.
//
// Design, prefill: one block of 256 threads per (lane*head, 64-query tile).
// The q tile (64 x hd) sits in shared memory as float32; the key loop walks
// 32-key tiles of K and V (float32 in shared memory, rows padded by one
// float so column walks hit distinct banks) over the tile range that the
// causal/window masks leave (the Pallas kernel's pl.when skip): for each,
// S = Q K^T as 4x2 register tiles per thread, the scale, softcap and masks
// applied and written to shared memory; one warp per 8 rows then does the
// online softmax with a lane per key (warp shuffles for the row max and
// sum); and the (64 x hd) float32 accumulator, 4 rows x hd/16 columns per
// thread in registers, is rescaled and gets P V. At hd 256 the tiles take
// 137 KB of shared memory (dynamic, above 48 KB by cudaFuncSetAttribute),
// so one block runs per SM. No tensor cores in this first version.
//
// Design, decode: one block per (lane, kv head), serving its G query heads
// (G * Sq <= 16 rows): the rows in shared memory, 32-key tiles of K and V as
// above, one warp per row computing its 32 scores (a lane per key) and the
// online softmax, then every thread updating hd/16 accumulator entries.
//
// Entry points take device pointers, sizes as int64_t, the scale and softcap
// as double and the CUDA stream, launch, and return cudaGetLastError() as
// an int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;             // query rows per prefill block
constexpr int kBK = 32;             // keys per tile: one per lane of a warp
constexpr int kLdP = kBK + 1;       // padded row of the score tile
constexpr int kMaxDecodeRows = 16;  // G * Sq rows of one decode block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float cap_score(float x, float scale, float softcap) {
  x = x * scale;
  if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
  return x;
}

// Load `rows` rows (of `rows_max`) of a (positions, heads, HD) slab, row r
// at src + r * stride, into a float32 tile with leading dimension `ld`,
// zeroing the rest.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t stride, int rows,
                                          int rows_max) {
  for (int i = threadIdx.x; i < rows_max * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    dst[r * ld + c] = r < rows ? to_f32(src[r * stride + c]) : 0.0f;
  }
}

// One online-softmax update of row r over one key tile: the row's scores
// (one per lane) in p[lane]; leaves exp(s - m_new) there and the rescale
// factor of the old accumulator in alpha[r].
__device__ __forceinline__ void softmax_row(float* p, float* m, float* l,
                                            float* alpha, int r, int lane) {
  const float x = p[lane];
  const float m_old = m[r];
  const float m_new = fmaxf(m_old, warp_max(x));
  const float e = expf(x - m_new);
  const float sum = warp_sum(e);
  p[lane] = e;
  if (lane == 0) {
    const float a = expf(m_old - m_new);
    alpha[r] = a;
    l[r] = l[r] * a + sum;
    m[r] = m_new;
  }
}

template <int HD>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * kLdP + 3 * kBQ);
}

template <int HD>
constexpr size_t decode_smem_bytes() {
  return sizeof(float) * (kMaxDecodeRows * (HD + 1) + kBK * (HD + 1) +
                          kBK * HD + kMaxDecodeRows * kLdP + 3 * kMaxDecodeRows);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int H,
                  int KV, int causal, int window, float scale, float softcap) {
  constexpr int LD = HD + 1;
  constexpr int kCols = HD / 16;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                    // (kBQ, LD)
  float* sK = sQ + kBQ * LD;           // (kBK, LD)
  float* sV = sK + kBK * LD;           // (kBK, HD)
  float* sP = sV + kBK * HD;           // (kBQ, kLdP) scores, then weights
  float* sM = sP + kBQ * kLdP;         // (kBQ,) running max
  float* sL = sM + kBQ;                // (kBQ,) running sum
  float* sA = sL + kBQ;                // (kBQ,) rescale of this tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q_lo = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int q_rows = min(kBQ, S - q_lo);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const T* qb = q + (static_cast<int64_t>(b) * S + q_lo) * q_stride +
                static_cast<int64_t>(h) * HD;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_stride +
                static_cast<int64_t>(g) * HD;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_stride +
                static_cast<int64_t>(g) * HD;
  T* ob = out + (static_cast<int64_t>(b) * S + q_lo) * q_stride +
          static_cast<int64_t>(h) * HD;

  load_rows<T, HD>(sQ, LD, qb, q_stride, q_rows, kBQ);
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
  }

  // the keys any row of this tile may see (_kv_block_range)
  int lo = 0, hi = S;
  if (causal) hi = min(hi, q_lo + q_rows);
  if (window > 0) lo = max(lo, q_lo - window + 1);
  const int t_begin = lo / kBK, t_end = (hi + kBK - 1) / kBK;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k_lo = kt * kBK;
    const int k_rows = min(kBK, S - k_lo);
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    load_rows<T, HD>(sK, LD, kb + k_lo * kv_stride, kv_stride, k_rows, kBK);
    load_rows<T, HD>(sV, HD, vb + k_lo * kv_stride, kv_stride, k_rows, kBK);
    __syncthreads();

    // S = Q K^T: rows ty + 16 i, keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qpos = q_lo + r, kpos = k_lo + c;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sP[r * kLdP + c] = ok ? cap_score(s[i][j], scale, softcap) : kNegInf;
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kBQ / kWarps; ++rr) {
      const int r = warp * (kBQ / kWarps) + rr;
      softmax_row(sP + r * kLdP, sM, sL, sA, r, lane);
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kLdP + t];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = sV[t * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // sL of the last tile

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
      const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        ob[r * q_stride + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ out, int Sq, int L, int H, int KV,
                 float scale, float softcap) {
  constexpr int LD = HD + 1;
  constexpr int kAcc = (kMaxDecodeRows * HD + kThreads - 1) / kThreads;
  extern __shared__ float smem[];
  float* sQ = smem;                         // (kMaxDecodeRows, LD)
  float* sK = sQ + kMaxDecodeRows * LD;     // (kBK, LD)
  float* sV = sK + kBK * LD;                // (kBK, HD)
  float* sP = sV + kBK * HD;                // (kMaxDecodeRows, kLdP)
  float* sM = sP + kMaxDecodeRows * kLdP;
  float* sL = sM + kMaxDecodeRows;
  float* sA = sL + kMaxDecodeRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, g = blockIdx.x - (blockIdx.x / KV) * KV;
  const int G = H / KV;
  const int R = G * Sq;                     // row r: query s = r / G, head g*G + r % G
  const int len = min(max(kv_len[b], 0), L);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const T* kb = k + static_cast<int64_t>(b) * L * kv_stride + static_cast<int64_t>(g) * HD;
  const T* vb = v + static_cast<int64_t>(b) * L * kv_stride + static_cast<int64_t>(g) * HD;

  for (int i = tid; i < kMaxDecodeRows * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    float x = 0.0f;
    if (r < R) {
      const int s = r / G, h = g * G + (r - s * G);
      x = to_f32(q[(static_cast<int64_t>(b) * Sq + s) * q_stride +
                   static_cast<int64_t>(h) * HD + c]);
    }
    sQ[r * LD + c] = x;
  }
  for (int r = tid; r < kMaxDecodeRows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  for (int k_lo = 0; k_lo < len; k_lo += kBK) {
    const int k_rows = min(kBK, L - k_lo);
    __syncthreads();
    load_rows<T, HD>(sK, LD, kb + k_lo * kv_stride, kv_stride, k_rows, kBK);
    load_rows<T, HD>(sV, HD, vb + k_lo * kv_stride, kv_stride, k_rows, kBK);
    __syncthreads();

    for (int r = warp; r < R; r += kWarps) {
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(sQ[r * LD + d], sK[lane * LD + d], s);
      sP[r * kLdP + lane] = k_lo + lane < len ? cap_score(s, scale, softcap) : kNegInf;
      __syncwarp();
      softmax_row(sP + r * kLdP, sM, sL, sA, r, lane);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < R * HD) {
        const int r = e / HD, c = e - r * HD;
        float x = acc[i] * sA[r];
#pragma unroll 4
        for (int t = 0; t < kBK; ++t) x = fmaf(sP[r * kLdP + t], sV[t * HD + c], x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < R * HD) {
      const int r = e / HD, c = e - r * HD;
      const int s = r / G, h = g * G + (r - s * G);
      out[(static_cast<int64_t>(b) * Sq + s) * q_stride + static_cast<int64_t>(h) * HD + c] =
          from_f32<T>(acc[i] / fmaxf(sL[r], 1e-30f));
    }
  }
}

template <typename T, int HD>
int launch_prefill(const void* q, const void* k, const void* v, void* out,
                   int64_t B, int64_t S, int64_t H, int64_t KV, int64_t causal,
                   int64_t window, double scale, double softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_prefill_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * H));
  fa_prefill_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(causal),
      static_cast<int>(window), static_cast<float>(scale),
      static_cast<float>(softcap));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* kv_len, void* out, int64_t B, int64_t Sq,
                  int64_t L, int64_t H, int64_t KV, double scale,
                  double softcap, cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  fa_decode_kernel<T, HD><<<static_cast<unsigned>(B * KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<int>(Sq), static_cast<int>(L),
      static_cast<int>(H), static_cast<int>(KV), static_cast<float>(scale),
      static_cast<float>(softcap));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int prefill_by_hd(const void* q, const void* k, const void* v, void* out,
                  int64_t B, int64_t S, int64_t H, int64_t KV, int64_t hd,
                  int64_t causal, int64_t window, double scale, double softcap,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_prefill<T, 16>(q, k, v, out, B, S, H, KV, causal, window, scale, softcap, st);
    case 32: return launch_prefill<T, 32>(q, k, v, out, B, S, H, KV, causal, window, scale, softcap, st);
    case 64: return launch_prefill<T, 64>(q, k, v, out, B, S, H, KV, causal, window, scale, softcap, st);
    case 128: return launch_prefill<T, 128>(q, k, v, out, B, S, H, KV, causal, window, scale, softcap, st);
    case 256: return launch_prefill<T, 256>(q, k, v, out, B, S, H, KV, causal, window, scale, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int decode_by_hd(const void* q, const void* k, const void* v,
                 const void* kv_len, void* out, int64_t B, int64_t Sq,
                 int64_t L, int64_t H, int64_t KV, int64_t hd, double scale,
                 double softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_decode<T, 16>(q, k, v, kv_len, out, B, Sq, L, H, KV, scale, softcap, st);
    case 32: return launch_decode<T, 32>(q, k, v, kv_len, out, B, Sq, L, H, KV, scale, softcap, st);
    case 64: return launch_decode<T, 64>(q, k, v, kv_len, out, B, Sq, L, H, KV, scale, softcap, st);
    case 128: return launch_decode<T, 128>(q, k, v, kv_len, out, B, Sq, L, H, KV, scale, softcap, st);
    case 256: return launch_decode<T, 256>(q, k, v, kv_len, out, B, Sq, L, H, KV, scale, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// softcap <= 0 means none; window <= 0 means none; causal is 0 or 1.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* out, int64_t B,
                                       int64_t S, int64_t H, int64_t KV,
                                       int64_t hd, int64_t causal,
                                       int64_t window, double scale,
                                       double softcap, void* stream) {
  return prefill_by_hd<float>(q, k, v, out, B, S, H, KV, hd, causal, window,
                              scale, softcap, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, int64_t B,
                                        int64_t S, int64_t H, int64_t KV,
                                        int64_t hd, int64_t causal,
                                        int64_t window, double scale,
                                        double softcap, void* stream) {
  return prefill_by_hd<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, causal,
                                      window, scale, softcap, stream);
}

extern "C" int flash_attention_decode_f32(const void* q, const void* k,
                                          const void* v, const void* kv_len,
                                          void* out, int64_t B, int64_t Sq,
                                          int64_t L, int64_t H, int64_t KV,
                                          int64_t hd, double scale,
                                          double softcap, void* stream) {
  return decode_by_hd<float>(q, k, v, kv_len, out, B, Sq, L, H, KV, hd, scale,
                             softcap, stream);
}

extern "C" int flash_attention_decode_bf16(const void* q, const void* k,
                                           const void* v, const void* kv_len,
                                           void* out, int64_t B, int64_t Sq,
                                           int64_t L, int64_t H, int64_t KV,
                                           int64_t hd, double scale,
                                           double softcap, void* stream) {
  return decode_by_hd<__nv_bfloat16>(q, k, v, kv_len, out, B, Sq, L, H, KV,
                                     hd, scale, softcap, stream);
}
