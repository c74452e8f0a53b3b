// Hopper (sm_90a) kernel for the Mamba-2 chunked SSD scan, with a plain C
// interface (loaded with ctypes by repro_torch/kernels/ssd_scan/ssd_scan.py).
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py ssd_scan_fwd
//           (_ssd_kernel), the Pallas TPU kernel whose grid runs
//           (batch*head, chunk) with the chunk axis sequential, carrying the
//           (P, N) float32 state in VMEM scratch.
//
// What it computes, per (lane b, head h) row, chunk by chunk (Q steps each):
//   cum_t  = sum_{u<=t} dt_u * A_h                       (inclusive, in-chunk)
//   y_t    = exp(cum_t) C_t . S_prev
//          + sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//   S_new  = exp(cum_Q) S_prev + sum_s exp(cum_Q - cum_s) dt_s x_s (x) B_s
// with y written in x's type and the final state in float32. Everything is
// computed in float32, as the Pallas kernel does (it upcasts its tiles).
//
// Layout: the model's own. x (Bz, S, H, P), dt (Bz, S, H) f32, A (H,) f32,
// B and C (Bz, S, G, N) shared by the H/G heads of a group; y (Bz, S, H, P),
// state (Bz, H, P, N). A block reads its group's B and C rows directly, so
// the per-head broadcast of B and C that the reference wrapper builds in
// HBM (H/G times their bytes) is never materialized.
//
// Bound on this card: float32 arithmetic. At the serving prefill's shape
// (8 lanes x 48 heads, S 512, chunk 256, P 64, N 128) the triangle s <= t
// alone is ~16 GFLOP against ~66 MB of traffic, i.e. ~0.24 ms at the
// 67 TFLOP/s float32 (non-tensor-core) peak against ~20 us of HBM time.
//
// Design: the TPU grid's sequential chunk axis becomes a loop inside one
// thread block, so one block owns one (lane, head) row and keeps its
// (P, N) state in shared memory across chunks; blocks of different rows run
// in any order. Within a chunk the work is cut into 64-row tiles of t and
// s (so chunk 256 fits in shared memory in float32 as well as bf16): for
// each t-tile, the inter-chunk term C_t . S_prev, then for each s-tile at or
// below the diagonal the (64 x 64) tile W[t, s] = (C_t . B_s) exp(cum_t -
// cum_s) dt_s and y_t += W x_s, all as 4x4 register tiles per thread over
// shared-memory operands (float32 FMAs; no tensor cores in this first
// version). The exponent above the diagonal is never evaluated: at chunk
// 256 cum_t - cum_s for s > t passes 88 and exp overflows to inf, and
// CB * inf is NaN where CB is 0, so the select comes before the exp. The
// state update runs after every y of the chunk (it reads the old state),
// each thread owning 32 (p, n) entries in registers.
//
// Entry points take device pointers, sizes as int64_t and the CUDA stream,
// launch, and return cudaGetLastError() as an int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows of t (or s) per tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 256;
constexpr int kLdW = kTile + 1;  // padded row of the W tile

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

// Copy `rows` rows (from time step `row0` on) of a
// (Bz, S, heads, width) tensor into a (kTile, ld) float32 tile, zeroing the
// rows past `rows`; `scale` (may be null) multiplies row r by scale[r].
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t row0, int64_t row_stride,
                                          int width, int rows,
                                          const float* scale) {
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    float v = 0.0f;
    if (r < rows) {
      v = to_f32(src[(row0 + r) * row_stride + c]);
      if (scale != nullptr) v = __fmul_rn(v, scale[r]);
    }
    dst[r * ld + c] = v;
  }
}

// One block per SM fits (the tiles take ~132 KB of shared memory), so the
// launch bound lets each thread keep its register tiles without spilling.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int64_t S, int H, int P, int G,
                int N, int Q) {
  extern __shared__ float smem[];
  const int ldN = N + 1, ldP = P + 1;
  float* sS = smem;                    // (P, ldN)   carried state
  float* sC = sS + P * ldN;            // (kTile, ldN)
  float* sB = sC + kTile * ldN;        // (kTile, ldN)
  float* sX = sB + kTile * ldN;        // (kTile, ldP)
  float* sW = sX + kTile * ldP;        // (kTile, kLdW)
  float* sCum = sW + kTile * kLdW;     // (Q,)
  float* sDt = sCum + Q;               // (Q,)
  float* sDecay = sDt + Q;             // (Q,) exp(cum_Q - cum_s) dt_s

  const int row = blockIdx.x;          // b * H + h
  const int64_t b = row / H;
  const int h = row - static_cast<int>(b) * H;
  const int g = h / (H / G);
  const float a = A[h];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;   // 4x4 register tiles (t|s, p|s)
  const int tn = tid & 31, tp = tid >> 5;   // state: p = tp + 8i, n = tn + 32j

  // per-step strides of the model-layout tensors
  const int64_t x_row = static_cast<int64_t>(H) * P;  // x, y: one time step
  const int64_t bc_row = static_cast<int64_t>(G) * N; // B, C: one time step
  const T* xr = x + b * S * x_row + static_cast<int64_t>(h) * P;
  T* yr = y + b * S * x_row + static_cast<int64_t>(h) * P;
  const T* Br = Bm + b * S * bc_row + static_cast<int64_t>(g) * N;
  const T* Cr = Cm + b * S * bc_row + static_cast<int64_t>(g) * N;
  const float* dtr = dt + b * S * H + h;

  for (int i = tid; i < P * ldN; i += kThreads) sS[i] = 0.0f;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int64_t n_chunks = S / Q;

  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t t_base = c * Q;
    __syncthreads();  // the previous chunk's readers of sCum/sDt are done
    for (int i = tid; i < Q; i += kThreads) sDt[i] = dtr[(t_base + i) * H];
    __syncthreads();
    // inclusive cumsum of dt * A: warp 0, each lane a run of consecutive
    // steps, then a shuffle scan of the run totals
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int lo = tid * per;
      const int hi = min(lo + per, Q);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        run = __fadd_rn(run, __fmul_rn(sDt[i], a));
        sCum[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl = __fadd_rn(incl, v);
      }
      const float excl = __fsub_rn(incl, run);
      if (tid > 0)
        for (int i = lo; i < hi; ++i) sCum[i] = __fadd_rn(sCum[i], excl);
    }
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      sDecay[i] = __fmul_rn(expf(__fsub_rn(cum_last, sCum[i])), sDt[i]);

    // ---- outputs, one t-tile at a time
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int t0 = tt * kTile;
      const int rows_t = min(kTile, Q - t0);
      __syncthreads();  // sC / sB / sX / sW free
      load_tile(sC, ldN, Cr, t_base + t0, bc_row, N, rows_t,
                static_cast<const float*>(nullptr));
      __syncthreads();

      float y_inter[4][4], y_intra[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) y_inter[i][j] = y_intra[i][j] = 0.0f;

      // inter-chunk: C_t . S_prev
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * ldN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sv[j] = sS[min(tx + 16 * j, P - 1) * ldN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y_inter[i][j] = __fmaf_rn(cv[i], sv[j], y_inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        const float e = t < Q ? expf(sCum[t]) : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) y_inter[i][j] = __fmul_rn(e, y_inter[i][j]);
      }

      // intra-chunk: tiles of s at or below the diagonal
      for (int st = 0; st <= tt; ++st) {
        const int s0 = st * kTile;
        const int rows_s = min(kTile, Q - s0);
        __syncthreads();  // sB / sX / sW free
        load_tile(sB, ldN, Br, t_base + s0, bc_row, N, rows_s,
                  static_cast<const float*>(nullptr));
        load_tile(sX, ldP, xr, t_base + s0, x_row, P, rows_s,
                  static_cast<const float*>(nullptr));
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * ldN + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * ldN + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              w[i][j] = __fmaf_rn(cv[i], bv[j], w[i][j]);
        }
        // mask before exp: only s <= t (< Q) ever reaches expf
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float v = 0.0f;
            if (t < Q && s <= t) {
              const float dec = expf(__fsub_rn(sCum[t], sCum[s]));
              v = __fmul_rn(__fmul_rn(w[i][j], dec), sDt[s]);
            }
            sW[(ty + 16 * i) * kLdW + tx + 16 * j] = v;
          }
        }
        __syncthreads();
        for (int s = 0; s < rows_s; ++s) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = sW[(ty + 16 * i) * kLdW + s];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xv[j] = sX[s * ldP + min(tx + 16 * j, P - 1)];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              y_intra[i][j] = __fmaf_rn(wv[i], xv[j], y_intra[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P)
            yr[(t_base + t) * x_row + p] =
                from_f32<T>(__fadd_rn(y_inter[i][j], y_intra[i][j]));
        }
      }
    }

    // ---- state update (after every y of the chunk: they read S_prev)
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int st = 0; st < n_tiles; ++st) {
      const int s0 = st * kTile;
      const int rows_s = min(kTile, Q - s0);
      __syncthreads();  // sB / sX free
      load_tile(sB, ldN, Br, t_base + s0, bc_row, N, rows_s,
                static_cast<const float*>(nullptr));
      load_tile(sX, ldP, xr, t_base + s0, x_row, P, rows_s, sDecay + s0);
      __syncthreads();
      for (int s = 0; s < rows_s; ++s) {
        float xv[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = sX[s * ldP + min(tp + 8 * i, P - 1)];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[s * ldN + min(tn + 32 * j, N - 1)];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(xv[i], bv[j], acc[i][j]);
      }
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = tp + 8 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tn + 32 * j;
        if (n < N)
          sS[p * ldN + n] = __fadd_rn(__fmul_rn(decay, sS[p * ldN + n]), acc[i][j]);
      }
    }
  }
  __syncthreads();
  float* so = state_out + static_cast<int64_t>(row) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    so[i] = sS[p * ldN + n];
  }
}

size_t smem_bytes(int64_t P, int64_t N, int64_t Q) {
  const int64_t floats = P * (N + 1) + 2 * kTile * (N + 1) + kTile * (P + 1) +
                         kTile * kLdW + 3 * Q;
  return static_cast<size_t>(floats) * sizeof(float);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int64_t batch, int64_t S,
           int64_t H, int64_t P, int64_t G, int64_t N, int64_t Q,
           void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxChunk ||
      S % Q != 0 || G < 1 || H % G != 0 || batch * H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * H == 0 || S == 0) return 0;
  const size_t smem = smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<static_cast<unsigned>(batch * H), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(G), static_cast<int>(N), static_cast<int>(Q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, B, C, y float32; dt, A, state float32.
int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, int64_t batch,
                 int64_t S, int64_t H, int64_t P, int64_t G, int64_t N,
                 int64_t chunk, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, state, batch, S, H, P, G, N, chunk,
                       stream);
}

// x, B, C, y bfloat16; dt, A, state float32.
int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                  const void* Cm, void* y, void* state, int64_t batch,
                  int64_t S, int64_t H, int64_t P, int64_t G, int64_t N,
                  int64_t chunk, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, batch, S, H, P, G,
                               N, chunk, stream);
}

}  // extern "C"
