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
//           causal/window blocks out of range skipped with pl.when. Both
//           entry points below compute that function: the prefill with
//           q_offset 0, the decode with a per-row kv_len in place of the
//           causal mask (models/attention.py flash_attention_decode).
//
// What they compute (kernels/flash_attention/ref.py attention_ref):
//   s[q, t] = scale * q . k_t, scale = hd^-0.5
//   s       = cap * tanh(s / cap)                        (when cap > 0)
//   s       = -1e30 where masked
//   out[q]  = sum_t softmax(s[q])_t v_t
// in float32 (scores, softmax and sums), the output in the inputs' type.
//
// - flash_attention_fwd (prefill, q_offset 0): Sq query rows against Skv
//   keys, any Sq and Skv, as the Pallas kernel takes them (the encoder's and
//   a decoder's self-attention have Sq = Skv; cross-attention has Sq
//   decoder tokens against Skv encoder frames). Causal (t <= q) and/or
//   window (t > q - window) masks, aligned top-left as the reference's
//   (query i and key i share a position; not the bottom-right alignment of
//   other flash-attention libraries); the ragged last tiles masked here
//   (keys t >= Skv, zero-filled on load) and not written (queries q >= Sq).
//   A query tile whose window holds no key below Skv copies and computes
//   nothing and writes zeros, as the Pallas kernel's skipped blocks leave
//   its accumulator.
//   Asked for it (a non-null lse), the prefill also writes each row's
//   log-sum-exp m + log(max(l, 1e-30)), (B, H, Sq) f32: the training
//   forward's residual. Serving passes null and launches what it did.
// - flash_attention_bwd (training backward, q_offset 0): the gradients of
//   the prefill from its output and lse. It replaces no Pallas kernel: the
//   reference's backward is pure JAX under a custom_vjp
//   (src/repro/models/attention.py _flash_backward); the f32 design is at
//   fa_bwd_dkdv_kernel below, the bf16 one (wgmma) at
//   fa_bwd_dq_wgmma_kernel.
// - flash_attention_decode (serving decode): no causal or window mask, a
//   per-row kv_len (B,) int32 device tensor, keys t >= kv_len[b] masked and
//   never read (kv_len must be in [1, L]). kv_len is read on the card only,
//   so a decode step never waits for the host.
//
// Layout: the model's own. q and out (B, Sq, H, hd), k and v (B, Skv, KV,
// hd) (the decode's cache: Skv = L), all contiguous; kv head g = h / (H /
// KV) serves G = H / KV query heads, so K and V are never repeated in
// memory. head_dim is a template parameter (16, 32, 64, 128 or 256), so
// every per-thread array lives in registers; the wrapper zero-pads any
// other head dim up to the next of these and passes the true hd's scale.
//
// Bounds at gemma2-9b's serving shapes (16 heads / 8 kv heads x 256, bf16,
// softcap 50), H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
// - prefill, 8 lanes x S 512, causal: 100.7 MB of q, k, v and out, 0.030 ms
//   of HBM time, against 17.2 GFLOP of the causal triangle, 0.017 ms at the
//   bf16 tensor-core rate: bytes bound it (4 lanes: 0.015 ms).
// - decode, 8 lanes, one query token against a 529-slot cache: 34.8 MB of K
//   and V for 69 MFLOP, 10.4 us at 3.35 TB/s (4 lanes: 5.2 us): bytes.
//
// Design, decode (fa_decode_split_kernel, both dtypes): a split-KV pass.
// The grid is (B * KV, n_split): each block takes one contiguous chunk of
// cache slots of one (lane, kv head), the same chunk bounds for every lane
// (the wrapper picks n_split from L and B * KV so that there are at least
// two waves of blocks over the 132 SMs), and serves that kv head's G * Sq
// query rows. In a block of 4 warps a team of TPK lanes owns one key row at
// a time, each lane holding DPL contiguous dims (at hd 256 bf16 a key row is
// one 16-byte load per lane of a full warp, coalesced); the dot for each
// query row is a shuffle reduction inside the team. Each team walks its keys
// U at a time, loading the next U keys' K and V into registers while it
// computes the current ones, and keeps its own online-softmax state (m, l,
// acc) per row; teams merge by shuffles, warps through shared memory, in a
// fixed order. A chunk that starts past kv_len[b] loads nothing and yields
// an empty partial (m = -1e30, l = 0). The n_split partials of a (lane, kv
// head) are merged by the last block of it to finish: each block writes its
// partial (f32, scratch allocated by the wrapper), fences, and bumps a
// per-(lane, kv head) counter; the block that sees n_split - 1 merges the
// partials in split order (so the result is bit-identical from run to run,
// whichever block finishes last) and resets the counter to 0 for the next
// call. The wrapper keeps the scratch and the counters per (device,
// stream), so calls on one stream find the counters at 0 by stream order
// and calls on two streams never share one. This keeps the decode at one
// launch per layer: a second, combining launch would add its host-side
// launch cost to every layer of every decode tick, and the decode is
// host-bound. The design attacks the latency that
// bounded the one-block-per-(lane, kv head) kernel before it (64 blocks,
// two of eight warps scoring, scalar loads, two barriers per 32 keys).
//
// Design, prefill in bf16 (fa_prefill_tc_kernel): QK^T and PV on tensor
// cores with wgmma (bf16 in, f32 accumulate). One warpgroup owns 64 query
// rows of one head; a block holds NWG = 2 warpgroups when G is even, the two
// query heads h0, h0 + 1 of one kv group, so both consume the same K/V
// tiles (half the K/V traffic of one head per block), else NWG = 1. Per
// 64-key tile: S = Q K^T as hd/16 m64n64k16 steps with Q and K both read
// from shared memory (K-major, no transpose); the scale, the softcap (tanhf,
// not an approximation: at softcap 50 tanh.approx moves a score by ~0.02)
// and the causal / window / ragged masks (-1e30; only tiles that cross a
// mask boundary test each entry) applied to the f32 accumulator in
// registers; the online softmax (in log2 units, 2^x on the SFU, O rescaled
// only when a row max grows by more than 2^8) with its row max and sum by
// shuffles among the four threads that share a row of the fragment; then
// O += P V with P taken from registers and V read from shared memory
// (MN-major, trans-b). The O accumulator (64 x hd f32) stays in registers,
// 128 per thread at hd 256.
// K/V tiles flow through a two-stage ring in shared memory, loaded with
// cp.async (16 bytes per thread, zero-filled past S; with two warpgroups
// the first copies K and the second V) a tile ahead of their use. Each
// stage has two mbarriers: `full`, which the copies arrive on as they land
// (cp.async.mbarrier.arrive.noinc), and `empty`, which every warp arrives
// on once its products have read the tile; a warpgroup refills the stage
// of tile i - 1 with tile i + 1 while its S product for tile i runs, and a
// fence.proxy.async orders the cp.async writes (generic proxy) before
// wgmma's reads (async proxy). No block-wide barrier sits in the loop, so
// the two warpgroups drift apart and one's softmax overlaps the other's
// products on the tensor cores. Tiles are stored in the no-swizzle
// wgmma layout (8-row x 16-byte core matrices, 128 contiguous bytes each),
// which serves every hd from 16 to 256 with one layout. Tiles wholly
// outside the causal / window range are skipped (the Pallas kernel's
// pl.when), and the grid runs the query tiles with the most key tiles
// first, so the last wave is not all long rows. At hd 256: Q 2 x 32 KB, two
// stages of K and V 4 x 32 KB, 192 KB of shared memory, one block per SM.
//
// Precision of p before PV. The reference computes PV with p in f32. A bf16
// operand holds 8 significant bits, and rounding p once to bf16 moves a
// gemma2-9b-shaped prefill (S 64 and 512, hd 256, G 2, softcap 50) outside
// fa_tolerance (tests/test_torch_fa_design.py emulates the kernel's
// arithmetic on the CPU). So P goes in as two bf16 operands, hi = bf16(p)
// and lo = bf16(p - hi), whose products are summed in f32: hi + lo keeps 16
// significant bits of p, and the emulation stays within fa_tolerance. It
// costs one more PV product per key tile. QK^T needs no such split: the
// products of two bf16 values are exact and are summed in f32.
//
// The f32 prefill entry (flash_attention_fwd_f32) keeps the CUDA-core
// kernel (fa_prefill_kernel below): wgmma takes no f32 operands, and f32
// attention lies on no serving path (gemma2-9b serves in bf16); it serves
// f32-compute models, which the tests run. This is a dispatch by dtype in
// the entry points, not a fallback.
//
// Entry points take device pointers, sizes as int64_t, the scale and softcap
// as double and the CUDA stream, launch, and return cudaGetLastError() as
// an int (0 = success). flash_attention_fwd_launched() then says which
// prefill kernel the call launched, for the wrapper's launch counters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// f32 prefill on CUDA cores
// ---------------------------------------------------------------------------
//
// One block of 256 threads per (lane*head, 64-query tile). The q tile (64 x
// hd) sits in shared memory; the key loop walks 32-key tiles of K and V
// (rows padded by one float so column walks hit distinct banks) over the
// tile range the causal/window masks leave: S = Q K^T as 4x2 register tiles
// per thread, scale, softcap and masks written to shared memory; one warp
// per 8 rows does the online softmax with a lane per key; the (64 x hd)
// accumulator, 4 rows x hd/16 columns per thread, is rescaled and gets P V.

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;             // query rows per prefill block
constexpr int kBK = 32;             // keys per tile: one per lane of a warp
constexpr int kLdP = kBK + 1;       // padded row of the score tile

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                  int causal, int window, float scale, float softcap) {
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
  const int q_rows = min(kBQ, Sq - q_lo);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const T* qb = q + (static_cast<int64_t>(b) * Sq + q_lo) * q_stride +
                static_cast<int64_t>(h) * HD;
  const T* kb = k + static_cast<int64_t>(b) * Skv * kv_stride +
                static_cast<int64_t>(g) * HD;
  const T* vb = v + static_cast<int64_t>(b) * Skv * kv_stride +
                static_cast<int64_t>(g) * HD;
  T* ob = out + (static_cast<int64_t>(b) * Sq + q_lo) * q_stride +
          static_cast<int64_t>(h) * HD;

  load_rows<T, HD>(sQ, LD, qb, q_stride, q_rows, kBQ);
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
  }

  // the keys any row of this tile may see (_kv_block_range), below Skv;
  // none when the window starts at or past the last of them
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, q_lo + q_rows);
  if (window > 0) lo = max(lo, q_lo - window + 1);
  const int t_begin = lo / kBK, t_end = lo < hi ? (hi + kBK - 1) / kBK : t_begin;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k_lo = kt * kBK;
    const int k_rows = min(kBK, Skv - k_lo);
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
        bool ok = kpos < Skv;
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
      // the row's log-sum-exp for the backward: m + log(max(l, 1e-30))
      if (lse != nullptr && tx == 0)
        lse[static_cast<int64_t>(bh) * Sq + q_lo + r] = sM[r] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 prefill on tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;    // query rows per warpgroup (wgmma's M)
constexpr int kTcKeys = 64;    // keys per K/V tile (N of the S product)
constexpr int kTcStages = 2;   // K/V ring depth

// 2^x by the SFU (ex2.approx, about 2 ulp, as exp2f computes it) with
// results below 2^-126 flushed to 0: weights that small move no sum
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int NWG>
constexpr size_t prefill_tc_smem_bytes() {
  return static_cast<size_t>(NWG + 2 * kTcStages) * kTcRows * HD *
         sizeof(__nv_bfloat16);
}

// Grid (B * H / NWG, ceil(Sq / 64)); block NWG warpgroups; warpgroup w serves
// query head h0 + w of kv head g, rows q_lo .. q_lo + 63.
template <int HD, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
fa_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int Sq, int Skv, int H, int KV, int causal, int window,
                     float scale, float softcap) {
  constexpr int NT = NWG * 128;
  constexpr uint32_t kTile = kTcRows * HD * 2;     // bytes of one tile
  constexpr uint32_t kRows8 = HD * 16;              // bytes of 8 rows
  constexpr int NS = HD < 64 ? HD : 64;             // N of one PV product
  constexpr int NSL = HD / NS;                      // PV products per k-step
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_addr(tc_smem);
  const uint32_t sKV = sQ + NWG * kTile;            // stage s: K at
                                                    // sKV + 2s * kTile, V next

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int wq = (tid >> 5) & 3;                    // warp within warpgroup
  const int n_qt = gridDim.y;
  const int q_lo = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kTcRows;
  const int hpb = H / NWG;
  const int b = blockIdx.x / hpb;
  const int h0 = (blockIdx.x - b * hpb) * NWG;
  const int g = h0 / (H / KV);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * Sq + q_lo) * q_stride +
                            static_cast<int64_t>(h0) * HD;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * Skv * kv_stride +
                            static_cast<int64_t>(g) * HD;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * Skv * kv_stride +
                            static_cast<int64_t>(g) * HD;

  // the key tiles any row of this query tile may see (_kv_block_range),
  // below Skv; none when a window ends before key 0 or starts past Skv
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, q_lo + kTcRows);
  if (window > 0) lo = max(lo, q_lo - window + 1);
  const int t_begin = lo / kTcKeys;
  const int n_tiles = lo < hi ? (hi + kTcKeys - 1) / kTcKeys - t_begin : 0;

  // the ring's barriers: full[s] completes when every thread's copies of
  // the tile in stage s have landed (NT cp.async arrivals), empty[s] when
  // every warp is done reading it (4 * NWG arrivals)
  __shared__ __align__(8) uint64_t ring[2 * kTcStages];
  const uint32_t full0 = smem_addr(ring), empty0 = full0 + 8 * kTcStages;
  if (tid == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(full0 + 8 * st, NT);
      mbar_init(empty0 + 8 * st, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int t = tid & 127;
  // tile i into its stage: with two warpgroups the first copies K and the
  // second V; one warpgroup copies both
  auto load_kv = [&](int i) {
    const int k_lo = (t_begin + i) * kTcKeys;
    const uint32_t st = sKV + 2 * (i % kTcStages) * kTile;
    if (NWG == 1 || wg == 0)
      load_tile_async<HD>(st, kb + k_lo * kv_stride, kv_stride, Skv - k_lo, t);
    if (NWG == 1 || wg == 1)
      load_tile_async<HD>(st + kTile, vb + k_lo * kv_stride, kv_stride, Skv - k_lo, t);
    mbar_arrive_cp_async(full0 + 8 * (i % kTcStages));
  };
  if (n_tiles > 0) {               // else no copy is issued, and none waited on
    load_tile_async<HD>(sQ + wg * kTile, qb + wg * HD, q_stride, Sq - q_lo, t);
    load_kv(0);                    // full[0] covers this warpgroup's Q too
  }
  if (n_tiles > 1) load_kv(1);

  // this thread's fragment rows: r0 and r0 + 8 of the warpgroup's 64
  const int r0 = wq * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);                    // column within 8
  float o[NSL][NS / 2];
#pragma unroll
  for (int s = 0; s < NSL; ++s)
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) o[s][i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};
  const uint32_t qdesc_base = sQ + wg * kTile;
  // scores in log2 units (times log2 e), so the softmax takes 2^x:
  // cap * tanh(s * scale / cap) * log2 e as (cap log2 e) tanh(s (scale /
  // cap)), or s (scale log2 e) without a softcap; the folded constants move
  // a score by an ulp or so, far inside fa_tolerance
  constexpr float kLog2e = 1.4426950408889634f;
  const float arg_mul = softcap > 0.0f ? scale / softcap : scale * kLog2e;
  const float cap_mul = softcap * kLog2e;

  for (int i = 0; i < n_tiles; ++i) {
    const int k_lo = (t_begin + i) * kTcKeys;
    const uint32_t sK = sKV + 2 * (i % kTcStages) * kTile, sV = sK + kTile;
    mbar_wait(full0 + 8 * (i % kTcStages), (i / kTcStages) & 1);
    fence_proxy_async();           // cp.async wrote it; wgmma reads it

    // S = Q K^T over hd / 16 steps
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_m64n64k16(s, gmma_desc(qdesc_base + kk * 256, 128, kRows8),
                         gmma_desc(sK + kk * 256, 128, kRows8), kk > 0);
    wgmma_commit();
    // while it runs: refill the stage of tile i - 1 with tile i + 1 once
    // every warp is done with tile i - 1
    if (i >= 1 && i + 1 < n_tiles) {
      mbar_wait(empty0 + 8 * ((i + 1) % kTcStages), ((i - 1) / kTcStages) & 1);
      load_kv(i + 1);
    }
    wgmma_wait_all();
    fence_regs(s);

    // scale, softcap, masks, log2 units; entry 4j + 2i + e is (row r0 + 8i,
    // key k_lo + 8j + cq + e)
    const bool full = k_lo + kTcKeys <= Skv &&
                      (!causal || k_lo + kTcKeys - 1 <= q_lo) &&
                      (window <= 0 || k_lo > q_lo + kTcRows - 1 - window);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      float sc = s[x] * arg_mul;
      if (softcap > 0.0f) sc = cap_mul * tanhf(sc);
      if (!full) {
        const int qpos = q_lo + r0 + 8 * ((x >> 1) & 1);
        const int kpos = k_lo + 8 * (x >> 2) + cq + (x & 1);
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) sc = kNegInf;
      }
      s[x] = sc;
    }

    // online softmax; a row's 64 entries lie on the 4 threads of a quad.
    // The running max (and with it the scale of O and l) moves only when a
    // row of the warp has grown by more than 8 (log2 units): until then
    // p <= 2^8, and the rescale of O's 128 registers per thread is skipped
    // (the algebra is the same either way)
    float mx[2];
    bool grow = false;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float m = m_run[hr];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        m = fmaxf(m, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      mx[hr] = m;
      grow = grow || m > m_run[hr] + 8.0f;
    }
    if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float alpha = exp2_ftz(m_run[hr] - mx[hr]);
        l_run[hr] *= alpha;
        m_run[hr] = mx[hr];
#pragma unroll
        for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
          for (int j = 0; j < NS / 8; ++j) {
            o[sl][4 * j + 2 * hr] *= alpha;
            o[sl][4 * j + 2 * hr + 1] *= alpha;
          }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_use = m_run[hr] == kNegInf ? 0.0f : m_run[hr];   // no valid key yet
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_ftz(s[4 * j + 2 * hr + e] - m_use);
          s[4 * j + 2 * hr + e] = p;
          sum += p;
        }
      l_run[hr] += sum;                        // this thread's columns only
    }

    // P as wgmma A fragments, two bf16 terms: key step kk covers keys
    // 16kk .. 16kk + 15, register r = (entries 8kk + 2r, 8kk + 2r + 1)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = s[8 * kk + 2 * r], p1 = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][r] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
      }

    // O += P_hi V + P_lo V; V MN-major: 8-column chunks along N 128 bytes
    // apart (SBO), 8-key groups along K kRows8 apart (LBO)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sl = 0; sl < NSL; ++sl) {
        const uint64_t dv = gmma_desc(sV + kk * 2 * kRows8 + sl * (NS / 8) * 128,
                                      kRows8, 128);
        wgmma_rs<NS>(o[sl], ph[kk], dv);
        wgmma_rs<NS>(o[sl], pl[kk], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl) fence_regs(o[sl]);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(empty0 + 8 * (i % kTcStages));
  }

  // finish: quad-sum l, scale by 1 / l (one IEEE division per row, not
  // one per entry: the entries move by an f32 ulp, far inside
  // fa_tolerance), store the rows below Sq
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int row = r0 + 8 * hr;
    // the row's log-sum-exp for the backward, back in natural units:
    // m_run ln 2 + log(max(l, 1e-30)), written once by the quad's first thread
    if (lse != nullptr && (lane & 3) == 0 && q_lo + row < Sq)
      lse[(static_cast<int64_t>(b) * H + h0 + wg) * Sq + q_lo + row] =
          m_run[hr] * 0.6931471805599453f + logf(fmaxf(l, 1e-30f));
    if (q_lo + row < Sq) {
      __nv_bfloat16* orow = out + (static_cast<int64_t>(b) * Sq + q_lo + row) * q_stride +
                            static_cast<int64_t>(h0 + wg) * HD;
#pragma unroll
      for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const int col = sl * NS + 8 * j + cq;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              o[sl][4 * j + 2 * hr] * inv, o[sl][4 * j + 2 * hr + 1] * inv);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// decode: split-KV pass
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxDecodeRows = 16;  // G * Sq rows of one block

// 16 bytes of T as floats
__device__ __forceinline__ void unpack16(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

template <typename T, int HD>
struct DecodeGeom {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int DPL = HD / 32 > VEC ? HD / 32 : VEC;     // dims per lane
  static constexpr int TPK = HD / DPL;                          // lanes per key
  static constexpr int KPW = 32 / TPK;                          // teams per warp
  static constexpr int NLD = DPL / VEC;                         // loads per row
  static constexpr int U = sizeof(T) == 2 ? 4 : 2;              // keys per step
  static constexpr int TEAMS = kDecWarps * KPW;
};

// K and V of keys base + TEAMS * u (u < U) for this lane's dims; zeros for
// keys at or past `end` (never read).
template <typename T, int HD>
__device__ __forceinline__ void load_keys(
    uint4 (&kr)[DecodeGeom<T, HD>::U][DecodeGeom<T, HD>::NLD],
    uint4 (&vr)[DecodeGeom<T, HD>::U][DecodeGeom<T, HD>::NLD], const T* kb,
    const T* vb, int64_t stride, int base, int end) {
  using Geo = DecodeGeom<T, HD>;
#pragma unroll
  for (int u = 0; u < Geo::U; ++u) {
    const int t = base + Geo::TEAMS * u;
#pragma unroll
    for (int n = 0; n < Geo::NLD; ++n) {
      if (t < end) {
        kr[u][n] = __ldg(reinterpret_cast<const uint4*>(kb + t * stride) + n);
        vr[u][n] = __ldg(reinterpret_cast<const uint4*>(vb + t * stride) + n);
      } else {
        kr[u][n] = make_uint4(0u, 0u, 0u, 0u);
        vr[u][n] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

template <int HD, int RB>
constexpr size_t decode_smem_bytes() {
  return sizeof(float) * (RB * HD + kDecWarps * RB * HD + kDecWarps * RB * 2);
}

// Grid (B * KV, n_split), kDecThreads threads. Rows r < R = G * Sq of kv
// head g: query s = r / G, head g * G + r % G. RB >= R bounds the rows at
// compile time (2 or kMaxDecodeRows). With n_split > 1, part_acc (B * KV,
// n_split, R, HD) and part_ml (B * KV, n_split, R, 2) hold the partials and
// counters (B * KV,) must be 0 on entry; they are 0 again on exit.
template <typename T, int HD, int RB>
__global__ void __launch_bounds__(kDecThreads)
fa_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ kv_len,
                       T* __restrict__ out, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int* __restrict__ counters,
                       int Sq, int L, int H, int KV, int chunk, int n_split,
                       float scale, float softcap) {
  using Geo = DecodeGeom<T, HD>;
  constexpr int DPL = Geo::DPL, TPK = Geo::TPK, KPW = Geo::KPW;
  constexpr int U = Geo::U, NLD = Geo::NLD, VEC = Geo::VEC;
  constexpr bool kQInRegs = RB * DPL <= 32;
  extern __shared__ float dsm[];
  float* sQ = dsm;                            // (RB, DPL, TPK): lane-major dims
  float* sAcc = sQ + RB * HD;                 // (kDecWarps, RB, HD)
  float* sML = sAcc + kDecWarps * RB * HD;    // (kDecWarps, RB, 2)
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bg = blockIdx.x, split = blockIdx.y;
  const int b = bg / KV, g = bg - b * KV;
  const int G = H / KV, R = G * Sq;
  const int len = min(max(kv_len[b], 0), L);
  const int c0 = split * chunk, c1 = min(c0 + chunk, len);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;

  for (int i = tid; i < R * HD; i += kDecThreads) {
    const int r = i / HD, dim = i - r * HD;
    const int s = r / G, h = g * G + (r - s * G);
    sQ[(r * DPL + dim % DPL) * TPK + dim / DPL] =
        to_f32(q[(static_cast<int64_t>(b) * Sq + s) * q_stride +
                 static_cast<int64_t>(h) * HD + dim]);
  }
  __syncthreads();

  const int tw = lane / TPK;                  // team within the warp
  const int j = lane - tw * TPK;              // dims j * DPL .. + DPL
  const T* kb = k + static_cast<int64_t>(b) * L * kv_stride +
                static_cast<int64_t>(g) * HD + j * DPL;
  const T* vb = v + static_cast<int64_t>(b) * L * kv_stride +
                static_cast<int64_t>(g) * HD + j * DPL;

  float qr[kQInRegs ? RB : 1][kQInRegs ? DPL : 1];
  if (kQInRegs) {
#pragma unroll
    for (int r = 0; r < (kQInRegs ? RB : 1); ++r)
#pragma unroll
      for (int e = 0; e < (kQInRegs ? DPL : 1); ++e)
        qr[r][e] = r < R ? sQ[(r * DPL + e) * TPK + j] : 0.0f;
  }
  float m[RB], l[RB], acc[RB][DPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.0f;
  }

  // team tw of this warp takes keys first + TEAMS * (U * step + u)
  const int warp_first = c0 + warp * KPW;     // warp-uniform loop bound
  int base = warp_first + tw;
  uint4 kr[U][NLD], vr[U][NLD];
  load_keys<T, HD>(kr, vr, kb, vb, kv_stride, base, c1);
  for (int wb = warp_first; wb < c1; wb += Geo::TEAMS * U, base += Geo::TEAMS * U) {
    uint4 kn[U][NLD], vn[U][NLD];
    load_keys<T, HD>(kn, vn, kb, vb, kv_stride, base + Geo::TEAMS * U, c1);

    float sc[RB][U];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u) sc[r][u] = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NLD; ++n) {
        float kf[VEC];
        unpack16(kr[u][n], kf);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const int d = n * VEC + e;
              const float qv = kQInRegs ? qr[kQInRegs ? r : 0][kQInRegs ? d : 0]
                                        : sQ[(r * DPL + d) * TPK + j];
              sc[r][u] = fmaf(qv, kf[e], sc[r][u]);
            }
          }
        }
      }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int o = TPK / 2; o > 0; o >>= 1)
          sc[r][u] += __shfl_xor_sync(0xffffffffu, sc[r][u], o);

#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        float mx = m[r];
        float x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          x[u] = cap_score(sc[r][u], scale, softcap);
          if (base + Geo::TEAMS * u < c1) mx = fmaxf(mx, x[u]);
        }
        const float alpha = expf(m[r] - mx);
        float lr = l[r] * alpha;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = base + Geo::TEAMS * u < c1 ? expf(x[u] - mx) : 0.0f;
          lr += p;
#pragma unroll
          for (int n = 0; n < NLD; ++n) {
            float vf[VEC];
            unpack16(vr[u][n], vf);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][n * VEC + e] = fmaf(p, vf[e], acc[r][n * VEC + e]);
          }
        }
        l[r] = lr;
        m[r] = mx;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NLD; ++n) {
        kr[u][n] = kn[u][n];
        vr[u][n] = vn[u][n];
      }
  }

  // merge the teams of a warp (lanes with the same dims, xor over teams)
#pragma unroll
  for (int o = TPK; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float mx = fmaxf(m[r], mo);
        const float a = expf(m[r] - mx), c = expf(mo - mx);
        l[r] = l[r] * a + lo * c;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
          acc[r][e] = acc[r][e] * a + ao * c;
        }
        m[r] = mx;
      }
    }
  }
  if (tw == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          sAcc[(warp * RB + r) * HD + j * DPL + e] = acc[r][e];
        if (j == 0) {
          sML[(warp * RB + r) * 2] = m[r];
          sML[(warp * RB + r) * 2 + 1] = l[r];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps in warp order: this block's partial for its chunk
  T* ob = out + static_cast<int64_t>(b) * Sq * q_stride;
  const int64_t part = static_cast<int64_t>(bg) * n_split + split;
  for (int i = tid; i < R * HD; i += kDecThreads) {
    const int r = i / HD, dim = i - r * HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sML[(w * RB + r) * 2]);
    float a = 0.0f, ls = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = expf(sML[(w * RB + r) * 2] - mx);
      a += f * sAcc[(w * RB + r) * HD + dim];
      ls += f * sML[(w * RB + r) * 2 + 1];
    }
    if (n_split == 1) {
      const int s = r / G, h = g * G + (r - s * G);
      ob[s * q_stride + static_cast<int64_t>(h) * HD + dim] =
          from_f32<T>(a / fmaxf(ls, 1e-30f));
    } else {
      part_acc[(part * R + r) * HD + dim] = a;
      if (dim == 0) {
        part_ml[(part * R + r) * 2] = mx;
        part_ml[(part * R + r) * 2 + 1] = ls;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this (lane, kv head) to finish merges all n_split
  // partials, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + bg, 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int64_t first = static_cast<int64_t>(bg) * n_split;
  for (int i = tid; i < R * HD; i += kDecThreads) {
    const int r = i / HD, dim = i - r * HD;
    float mx = kNegInf;
    for (int p = 0; p < n_split; ++p)
      mx = fmaxf(mx, __ldcg(part_ml + ((first + p) * R + r) * 2));
    float a = 0.0f, ls = 0.0f;
    for (int p = 0; p < n_split; ++p) {
      const float f = expf(__ldcg(part_ml + ((first + p) * R + r) * 2) - mx);
      a += f * __ldcg(part_acc + ((first + p) * R + r) * HD + dim);
      ls += f * __ldcg(part_ml + ((first + p) * R + r) * 2 + 1);
    }
    const int s = r / G, h = g * G + (r - s * G);
    ob[s * q_stride + static_cast<int64_t>(h) * HD + dim] =
        from_f32<T>(a / fmaxf(ls, 1e-30f));
  }
  if (tid == 0) counters[bg] = 0;
}

// ---------------------------------------------------------------------------
// backward (flash_attention_bwd): f32 on CUDA cores
// ---------------------------------------------------------------------------
//
// Three passes, launched one after the other by the f32 entry point (the
// bf16 entry runs two wgmma passes instead, below):
// - fa_bwd_delta_kernel: delta[b, h, q] = sum_d g[b, q, h, d] out[b, q, h, d]
//   in f32, one warp per row;
// - fa_bwd_dkdv_kernel: one block per (lane, kv head, 32-key tile). dK and
//   dV of the tile (32 x hd f32 each) stay in registers while the block
//   walks the G query heads of its kv head and, for each, the 32-row query
//   tiles that see the key tile (causal: from the tile's first key; window:
//   up to its last key + window - 1): S = Q K^T and dP = dO V^T recomputed
//   (4 entries a thread), p = exp(s - lse), ds = p (dp - delta), then
//   (1 - tanh^2) under a softcap, then the scale, both tiles to shared
//   memory, then dV += P^T dO and dK += dS^T Q. Each key row is written by
//   its block alone, so no atomics: a call's gradients are the same bits
//   every time.
// - fa_bwd_dq_kernel: one block per (lane, head, 32-row query tile). dQ (32
//   x hd f32) stays in registers while the block walks the key tiles of
//   _kv_block_range, recomputing S, dP and dS as above: dQ += dS K.
// Masked entries (causal, window, queries at or past Sq, keys at or past
// Skv) get s = -1e30, so p = 0 and ds = 0; the ragged tiles are zero-filled
// on load. A key tile that no query sees (causal, at or past Sq) writes
// zero dK and dV.
//
// Bound at gemma2-9b's training shape (B 2, S 4096, 16 heads / 8 kv heads x
// 256, causal, bf16): the five products of the causal triangle, 5 x 2 x
// S^2/2 x hd x B x H = 687 GFLOP, are 0.69 ms at 989 TFLOP/s (bf16 tensor
// cores); the bytes (q, k, v, out, g, lse in; dq, dk, dv out), 403 MB,
// 0.12 ms at 3.35 TB/s: operations bound it. The f32 passes recompute S
// and dP in both passes (seven products) and stage every operand through
// shared memory behind block-wide barriers; the times of both entries
// against the bound are in PERF.md. Shared memory of the f32 passes at hd 256: four 32 x (hd + 1)
// f32 tiles and the two 32 x 33 score tiles, 140 KB (opted in above 48
// KB), one block of 256 threads per SM.

constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 32;          // query rows and keys per tile
constexpr int kLdS = kBwdRows + 1;    // padded row of a score tile

template <int HD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * kBwdRows * (HD + 1) + 2 * kBwdRows * kLdS + 2 * kBwdRows);
}

template <typename T, int HD>
__device__ __forceinline__ void load_rows_bwd(float* dst, const T* src,
                                              int64_t stride, int rows) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < kBwdRows * HD; i += kBwdThreads) {
    const int r = i / HD, c = i - r * HD;
    dst[r * LD + c] = r < rows ? to_f32(src[r * stride + c]) : 0.0f;
  }
}

// p and ds of the (query r, key c) entries of one tile pair that this
// thread owns (r = ty + 16 i, c = tx + 16 j), from the query tile's Q, dO,
// lse and delta and the key tile's K and V in shared memory; written to
// sP (p) and sDS (ds) at [r * kLdS + c]. sP may be null (the dq pass).
template <int HD>
__device__ __forceinline__ void bwd_scores(
    const float* sQ, const float* sG, const float* sK, const float* sV,
    const float* sLse, const float* sDelta, float* sP, float* sDS, int q_lo,
    int k_lo, int Sq, int Skv, int causal, int window, float scale, float softcap) {
  constexpr int LD = HD + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float dp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float qv[2], gv[2], kv[2], vv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qv[i] = sQ[(ty + 16 * i) * LD + d];
      gv[i] = sG[(ty + 16 * i) * LD + d];
      kv[i] = sK[(tx + 16 * i) * LD + d];
      vv[i] = sV[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int qpos = q_lo + r, kpos = k_lo + c;
      bool ok = kpos < Skv && qpos < Sq;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      // the reference's order: s = scale qk; t = tanh(s / cap); s = cap t;
      // mask; p = exp(s - lse); ds = p (dp - delta) (1 - t^2) scale
      float sc = s[i][j] * scale, dcap = 1.0f;
      if (softcap > 0.0f) {
        const float t = tanhf(sc / softcap);
        sc = softcap * t;
        dcap = 1.0f - t * t;
      }
      if (!ok) sc = kNegInf;
      const float p = expf(sc - sLse[r]);
      float ds = p * (dp[i][j] - sDelta[r]);
      if (softcap > 0.0f) ds = ds * dcap;
      ds = ds * scale;
      if (sP != nullptr) sP[r * kLdS + c] = p;
      sDS[r * kLdS + c] = ds;
    }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
fa_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ g,
                    float* __restrict__ delta, int64_t rows, int Sq, int H,
                    int HD) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * HD;
  const T* gg = g + row * HD;
  float acc = 0.0f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(gg[d]), to_f32(o[d]), acc);
  acc = warp_sum(acc);
  // row = (b * Sq + q) * H + h  ->  delta[(b * H + h) * Sq + q]
  const int64_t h = row % H, bq = row / H;
  const int64_t b = bq / Sq, qq = bq - b * Sq;
  if (lane == 0) delta[(b * H + h) * Sq + qq] = acc;
}

// Grid (ceil(Skv / 32), B * KV).
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H,
                   int KV, int causal, int window, float scale, float softcap) {
  constexpr int LD = HD + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBwdRows * LD;
  float* sQ = sV + kBwdRows * LD;
  float* sG = sQ + kBwdRows * LD;
  float* sP = sG + kBwdRows * LD;
  float* sDS = sP + kBwdRows * kLdS;
  float* sLse = sDS + kBwdRows * kLdS;
  float* sDelta = sLse + kBwdRows;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k_lo = blockIdx.x * kBwdRows;
  const int k_rows = min(kBwdRows, Skv - k_lo);
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int G = H / KV;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * Skv + k_lo) * kv_stride +
                         static_cast<int64_t>(kvh) * HD;
  load_rows_bwd<T, HD>(sK, k + kv_off, kv_stride, k_rows);
  load_rows_bwd<T, HD>(sV, v + kv_off, kv_stride, k_rows);

  // the queries that see a key of this tile: causal q >= k_lo; window
  // q <= last key + window - 1; none past Sq
  int q_first = causal ? k_lo : 0, q_last = Sq - 1;
  if (window > 0) q_last = min(q_last, k_lo + k_rows - 1 + window - 1);
  const int qt_begin = q_first / kBwdRows, qt_end = q_last / kBwdRows + 1;

  float ak[2][kCols], av[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) ak[i][j] = av[i][j] = 0.0f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const float* lse_h = lse + (static_cast<int64_t>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<int64_t>(b) * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * kBwdRows;
      const int q_rows = min(kBwdRows, Sq - q_lo);
      const int64_t q_off = (static_cast<int64_t>(b) * Sq + q_lo) * q_stride +
                            static_cast<int64_t>(h) * HD;
      __syncthreads();  // the previous tile's sQ, sG, sP and sDS are consumed
      load_rows_bwd<T, HD>(sQ, q + q_off, q_stride, q_rows);
      load_rows_bwd<T, HD>(sG, g + q_off, q_stride, q_rows);
      if (tid < kBwdRows) {
        sLse[tid] = tid < q_rows ? lse_h[q_lo + tid] : 0.0f;
        sDelta[tid] = tid < q_rows ? delta_h[q_lo + tid] : 0.0f;
      }
      __syncthreads();
      bwd_scores<HD>(sQ, sG, sK, sV, sLse, sDelta, sP, sDS, q_lo, k_lo, Sq, Skv, causal,
                     window, scale, softcap);
      __syncthreads();
      // dV[c] += sum_r P[r, c] dO[r]; dK[c] += sum_r dS[r, c] Q[r]
#pragma unroll 4
      for (int r = 0; r < kBwdRows; ++r) {
        float pr[2], dr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pr[i] = sP[r * kLdS + ty + 16 * i];
          dr[i] = sDS[r * kLdS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float gv = sG[r * LD + tx + 16 * j];
          const float qv = sQ[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            av[i][j] = fmaf(pr[i], gv, av[i][j]);
            ak[i][j] = fmaf(dr[i], qv, ak[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = ty + 16 * i;
    if (c < k_rows) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        dk[kv_off + c * kv_stride + tx + 16 * j] = from_f32<T>(ak[i][j]);
        dv[kv_off + c * kv_stride + tx + 16 * j] = from_f32<T>(av[i][j]);
      }
    }
  }
}

// Grid (ceil(Sq / 32), B * H).
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, int Sq, int Skv, int H, int KV, int causal,
                 int window, float scale, float softcap) {
  constexpr int LD = HD + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kBwdRows * LD;
  float* sK = sG + kBwdRows * LD;
  float* sV = sK + kBwdRows * LD;
  float* sDS = sV + kBwdRows * LD;
  float* sLse = sDS + kBwdRows * kLdS;
  float* sDelta = sLse + kBwdRows;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_lo = blockIdx.x * kBwdRows;
  const int q_rows = min(kBwdRows, Sq - q_lo);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * Sq + q_lo) * q_stride +
                        static_cast<int64_t>(h) * HD;
  load_rows_bwd<T, HD>(sQ, q + q_off, q_stride, q_rows);
  load_rows_bwd<T, HD>(sG, g + q_off, q_stride, q_rows);
  if (tid < kBwdRows) {
    sLse[tid] = tid < q_rows ? lse[static_cast<int64_t>(bh) * Sq + q_lo + tid] : 0.0f;
    sDelta[tid] = tid < q_rows ? delta[static_cast<int64_t>(bh) * Sq + q_lo + tid] : 0.0f;
  }

  // the keys any row of this tile may see (_kv_block_range), below Skv;
  // none when the window starts at or past the last of them
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, q_lo + q_rows);
  if (window > 0) lo = max(lo, q_lo - window + 1);
  const int t_begin = lo / kBwdRows;
  const int t_end = lo < hi ? (hi + kBwdRows - 1) / kBwdRows : t_begin;

  float aq[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) aq[i][j] = 0.0f;

  const T* kb = k + static_cast<int64_t>(b) * Skv * kv_stride + static_cast<int64_t>(kvh) * HD;
  const T* vb = v + static_cast<int64_t>(b) * Skv * kv_stride + static_cast<int64_t>(kvh) * HD;
  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k_lo = kt * kBwdRows;
    __syncthreads();  // the previous tile's sK and sDS are consumed
    load_rows_bwd<T, HD>(sK, kb + k_lo * kv_stride, kv_stride, min(kBwdRows, Skv - k_lo));
    load_rows_bwd<T, HD>(sV, vb + k_lo * kv_stride, kv_stride, min(kBwdRows, Skv - k_lo));
    __syncthreads();
    bwd_scores<HD>(sQ, sG, sK, sV, sLse, sDelta, nullptr, sDS, q_lo, k_lo, Sq, Skv, causal,
                   window, scale, softcap);
    __syncthreads();
    // dQ[r] += sum_c dS[r, c] K[c]
#pragma unroll 4
    for (int c = 0; c < kBwdRows; ++c) {
      float dr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dr[i] = sDS[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = sK[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) aq[i][j] = fmaf(dr[i], kv, aq[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        dq[q_off + r * q_stride + tx + 16 * j] = from_f32<T>(aq[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward in bf16 on tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// The bf16 entry runs two passes, both on wgmma (bf16 operands, f32
// accumulators), launched one after the other on the stream:
// - fa_bwd_dq_wgmma_kernel: one block per (lane, head, 64-row query tile).
//   Its prologue computes the tile's delta = rowsum(g * out) in f32 and
//   writes it for the next pass, so delta costs no launch of its own. It walks the key tiles of _kv_block_range:
//   S = Q K^T and dP = dO V^T, p, ds, then dQ += dS K.
// - fa_bwd_dkdv_wgmma_kernel: one block per (lane, kv head, 64-key tile).
//   It walks the G query heads of its kv head and, for each, the query
//   tiles that see the key tile (the inverse of _kv_block_range: causal
//   from the tile's first key, a window up to its last key + window - 1),
//   from the last: S^T = K Q^T and dP^T = V dO^T with M = keys, p^T and
//   ds^T, then dV += P^T dO and dK += dS^T Q.
// Each output row has one block, and every sum runs in a fixed order: no
// atomics, so a call's gradients are the same bits every time.
//
// The grids run the tile index fastest, heavy tiles first (the query tiles
// with the most key tiles; key tile 0, which the most query tiles see), and
// (lane, head) slowest, so the ~132 blocks resident at a time share one or
// two (lane, kv head) streams of K and V (Q and dO), which stay in the 50 MB
// L2; with (lane, head) fastest they spanned all 16 streams at the cell's
// shape (64 MB of K and V, 134 MB of Q and dO), more than L2 holds.
//
// One skeleton serves both passes. The block's own 64 rows (K and V, or Q
// and dO) are resident in shared memory for the whole block and are the A
// operands of the two score products; the other side's 64-row tiles (Q and
// dO with their lse and delta, or K and V) stream through a two-stage ring.
// At hd >= 64 one thread copies every tile with TMA (boxes of 64 rows x 64
// dims, 128-byte swizzled, rows past Sq or Skv zero-filled) and each stage's
// mbarrier counts its bytes; the lse and delta rows, which need not be
// 16-byte aligned, come by 4-byte cp.async copies that arrive on the same
// barrier. Copied by cp.async, 16 bytes a thread, the tiles of a pass took
// about as long as its products and arithmetic together, and the two passes
// ran 1.5x as long as with TMA (PERF.md, Findings);
// TMA's line-sized requests hide the copies behind the products. At hd 16
// and 32 (no 128-byte rows) the tiles keep cp.async and hopper.cuh's
// no-swizzle layout. The streamed tiles are B operands twice: K-major in the
// score products (S^T = K Q^T reads Q's rows as N), and MN-major (trans-b =
// 1) in the output products (dV += P^T dO reads dO with N = hd and K = the
// query rows). So nothing is staged transposed, and no 2-byte transposing
// store is made.
//
// The register budget at hd 256 is the crux. dK and dV of a 64-key tile are
// 2 x 64 x 256 f32: 256 registers a thread for one warpgroup, over the limit
// of 255 before anything else is held. So a block is two consumer
// warpgroups (256 threads), and warpgroup w owns dims [128 w, 128 w + 128)
// of both dK and dV (64 + 64 registers a thread; the dq pass 64 of dQ) and
// columns [32 w, 32 w + 32) of the 64 x 64 score tiles (S^T and dP^T as
// m64n32 products over hd, 16 + 16 registers). The output products need all
// 64 columns, so each warpgroup writes its half of p^T and ds^T (the dq
// pass: ds) as bf16 hi and lo into four 64 x 64 tiles in shared memory
// (4-byte stores; each warp's fill one 128-byte core matrix, no bank
// conflict), and both read the whole tiles as SS-wgmma A operands (K-major).
// Per streamed tile, two named barriers over the two warpgroups: one after
// the score tiles are written (before the output products read them), one
// once both warpgroups' output products of the previous tile are done (the
// score tiles and that tile's ring stage are free, and the next tile but
// one is copied into the stage). The output products of tile i overlap the
// issue of the score products of tile i + 1 (wgmma.wait_group 1). A
// register-A (RS) dQ += dS K in one warpgroup would hold 128 registers of
// dQ, 64 of S and dP and 32 of dS hi + lo at once; the split keeps the
// dk/dv pass at 221 registers a thread and the dq pass at 158 with no spills
// (ptxas, hd 256; PERF.md has every hd), and the two passes share one code
// path. No producer warpgroup, so no setmaxnreg.
//
// Shared memory at hd 256: resident 2 x 32 KB, the ring 2 stages x 64 KB,
// the score tiles 4 x 8 KB (dq: 2 x 8 KB), lse, delta and the barriers: 225
// KB (dq: 208.5 KB), one block per SM. So the ring cannot deepen at hd 256,
// and the exposed part of a tile is its score products and its per-entry
// arithmetic, which the tensor cores wait on.
//
// Arithmetic, entry by entry, is the reference's and the f32 passes': s =
// scale qk, t = tanhf(s / cap), s = cap t, the mask (-1e30), p =
// expf(s - lse), ds = p (dp - delta), times (1 - t^2), times the scale
// (tanhf and expf, not their approximations). s / cap is taken as s times
// fl(1 / cap), as the references compute it (XLA under jit and PyTorch on
// CUDA divide by a constant so). Only tiles that a causal, window or ragged
// edge cuts test each entry. p and ds enter the output products as hi =
// bf16(x) and lo = bf16(x - hi), two products each, per 16-row k-step hi
// then lo (tests/test_torch_fa_bwd_tiles.py emulates this order within
// bwd_tolerance; one bf16 rounding leaves it,
// tests/test_torch_fa_bwd_design.py). S and dP are recomputed in the dq
// pass, so the two passes run 10 products' worth of work where the
// reference's backward has five.

// The head dims from which the row tiles come by TMA (64 and up: a box row
// is 64 dims, 128 bytes).
template <int HD>
constexpr bool kBwTma = HD >= 64;

constexpr int kBwThreads = 256;                   // two consumer warpgroups
constexpr int kBwStages = 2;                      // streamed-tile ring depth
constexpr uint32_t kBwScore = 64 * 64 * 2;        // bytes of a 64 x 64 bf16 tile

// The row tiles' tensor maps (q and g over (B, Sq, H, hd), k and v over (B,
// Skv, KV, hd); boxes of 64 rows x 64 dims, 128-byte swizzled), read by TMA
// where kBwTma (hd >= 64); below, the tiles are copied by cp.async and these
// are unused.
struct BwdMaps {
  CUtensorMap q, g, k, v;
};

template <int HD, bool DQ>
struct BwdWg {
  static constexpr bool kTma = kBwTma<HD>;
  static constexpr uint32_t kTile = 64 * HD * 2;             // a 64 x hd bf16 tile
  static constexpr int kScores = DQ ? 2 : 4;                 // dS hi, lo (P hi, lo)
  static constexpr uint32_t kRowOff = (2 + 2 * kBwStages) * kTile + kScores * kBwScore;
  // dq: the tile's lse and delta; dk/dv: per stage, the streamed tile's
  static constexpr uint32_t kBarOff = kRowOff + (DQ ? 1 : kBwStages) * 128 * sizeof(float);
  static constexpr size_t smem = kBarOff + kBwStages * sizeof(uint64_t);
  // arrivals per phase of a stage's barrier: with TMA the issuing thread's
  // (its expect_tx), and in dk/dv the first warpgroup's lse / delta copies;
  // else every thread's copies
  static constexpr int kArrivals = kTma ? 1 + (DQ ? 0 : 128) : kBwThreads;
};

// Descriptors of a row tile (64 rows x HD) as a wgmma operand. TMA layout
// (kBwTma): HD / 64 atoms of 64 rows x 128 bytes, 8 KB apart, swizzled;
// else hopper.cuh's no-swizzle layout (tile_offset). K-major: rows
// [row0, ...) (a multiple of 8) as M or N, dims 16 kk .. 16 kk + 15 as K.
template <int HD>
__device__ __forceinline__ uint64_t bw_desc_k(uint32_t base, int row0, int kk) {
  if constexpr (kBwTma<HD>)
    return gmma_desc(base + (kk >> 2) * 8192 + row0 * 128 + (kk & 3) * 32, 16, 1024) |
           kSwizzle128;
  else
    return gmma_desc(base + (row0 >> 3) * HD * 16 + kk * 256, 128, HD * 16);
}
// MN-major (trans-b = 1): dims [dim0, ...) as N, rows 16 kk .. 16 kk + 15 as K
template <int HD>
__device__ __forceinline__ uint64_t bw_desc_mn(uint32_t base, int dim0, int kk) {
  if constexpr (kBwTma<HD>)
    return gmma_desc(base + (dim0 >> 6) * 8192 + (dim0 & 63) * 2 + kk * 2048, 8192, 1024) |
           kSwizzle128;
  else
    return gmma_desc(base + kk * 2 * HD * 16 + (dim0 >> 3) * 128, HD * 16, 128);
}

// The pass DQ of the block (blockIdx.x, blockIdx.y); see above. q, g, out,
// dq (B, Sq, H, hd); k, v, dk, dv (B, Skv, KV, hd); lse, delta (B, H, Sq).
template <int HD, bool DQ>
__device__ __forceinline__ void bwd_wgmma_pass(
    const BwdMaps& maps, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
    int KV, int causal, int window, float scale, float softcap) {
  using Geo = BwdWg<HD, DQ>;
  constexpr uint32_t kTile = Geo::kTile;
  constexpr int NH = HD / 2;                        // output dims per warpgroup
  constexpr int NS = NH < 64 ? NH : 64;             // N of one output product
  constexpr int NSL = NH / NS;
  constexpr int NACC = DQ ? 1 : 2;                  // dQ; or dK, dV
  extern __shared__ __align__(1024) unsigned char bw_smem[];
  const uint32_t sA = smem_addr(bw_smem);           // resident: K or Q, then V or dO
  const uint32_t sB = sA + 2 * kTile;               // stage s: Q or K at sB + 2 s kTile,
                                                    // dO or V next
  const uint32_t sP = sB + 2 * kBwStages * kTile;   // dS hi, dS lo (P hi, P lo)
  float* sRow = reinterpret_cast<float*>(bw_smem + Geo::kRowOff);
  const uint32_t full0 = sA + Geo::kBarOff;         // the stages' mbarriers

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, lane = tid & 31;
  const int wq = (tid >> 5) & 3;
  const int G = H / KV;
  const int n_tiles = gridDim.x;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  int b, h, kvh, r_lo;
  if (DQ) {
    b = blockIdx.y / H;
    h = blockIdx.y - b * H;
    kvh = h / G;
    r_lo = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * 64;   // most key tiles first
  } else {
    b = blockIdx.y / KV;
    kvh = blockIdx.y - b * KV;
    h = kvh * G;
    r_lo = static_cast<int>(blockIdx.x) * 64;
  }
  const int r_rows = DQ ? Sq : Skv;                 // rows of the block's own tensors
  const int r_last = min(r_rows, r_lo + 64) - 1;

  // the streamed tiles: dq, the key tiles of _kv_block_range below Skv;
  // dk/dv, for each of the G heads, the query tiles below Sq that see a key
  // of this tile (none when causal and the tile starts at or past Sq)
  int c_begin, n_c;
  if (DQ) {
    int lo = 0, hi = Skv;
    if (causal) hi = min(hi, r_lo + 64);
    if (window > 0) lo = max(lo, r_lo - window + 1);
    c_begin = lo / 64;
    n_c = lo < hi ? (hi + 63) / 64 - c_begin : 0;
  } else {
    int q_first = causal ? r_lo : 0, q_last = Sq - 1;
    if (window > 0) q_last = min(q_last, r_last + window - 1);
    c_begin = q_first / 64;
    n_c = q_last / 64 + 1 - c_begin;
  }
  const int n_items = DQ ? n_c : G * n_c;      // <= 0: nothing to stream

  if (tid == 0) {
    for (int st = 0; st < kBwStages; ++st) mbar_init(full0 + 8 * st, Geo::kArrivals);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item i: (head, first row) of the streamed tile; dk/dv walks each head's
  // query tiles from the last, so the blocks of one kv head start together
  auto item = [&](int i, int& hi_, int& c_lo) {
    const int hh = DQ ? 0 : i / n_c;
    hi_ = DQ ? h : kvh * G + hh;
    c_lo = (c_begin + (DQ ? i : n_c - 1 - (i - hh * n_c))) * 64;
  };
  // rows row0 .. row0 + 63 of one head of a tensor of `rows` rows into the
  // tile at dst: by TMA (the calling thread; the map zero-fills past its
  // rows), else by this warpgroup's cp.async copies
  auto load_tile = [&](uint32_t dst, const CUtensorMap& map, const __nv_bfloat16* x,
                       int64_t stride, int rows, int head, int row0, uint32_t bar) {
    if constexpr (Geo::kTma) {
#pragma unroll
      for (int a = 0; a < HD / 64; ++a) tma_load_4d(dst + a * 8192, &map, bar, 64 * a, head, row0, b);
    } else {
      load_tile_async<HD>(dst, x + (static_cast<int64_t>(b) * rows + row0) * stride +
                                   static_cast<int64_t>(head) * HD,
                          stride, rows - row0, t);
    }
  };
  // copy item i into its stage (item 0 with the resident tiles): with TMA
  // thread 0 issues every tile; else the first warpgroup copies Q or K,
  // the second dO or V. In dk/dv the first warpgroup also copies the lse
  // and delta rows.
  auto load_item = [&](int i) {
    const int st = i % kBwStages;
    const uint32_t bar = full0 + 8 * st;
    int hi_, c_lo;
    item(i, hi_, c_lo);
    const uint32_t dst = sB + 2 * st * kTile;
    const CUtensorMap& m0 = DQ ? maps.k : maps.q;
    const CUtensorMap& m1 = DQ ? maps.v : maps.g;
    const __nv_bfloat16* x0 = DQ ? k : q;
    const __nv_bfloat16* x1 = DQ ? v : g;
    const int64_t stride = DQ ? kv_stride : q_stride;
    const int rows = DQ ? Skv : Sq;
    const int head = DQ ? kvh : hi_;
    if (Geo::kTma ? tid == 0 : true) {
      if (Geo::kTma) mbar_arrive_expect_tx(bar, (i == 0 ? 4 : 2) * kTile);
      if (i == 0) {
        // the resident tiles ride with item 0's barrier phase
        const CUtensorMap& r0 = DQ ? maps.q : maps.k;
        const CUtensorMap& r1 = DQ ? maps.g : maps.v;
        const __nv_bfloat16* y0 = DQ ? q : k;
        const __nv_bfloat16* y1 = DQ ? g : v;
        const int64_t rstride = DQ ? q_stride : kv_stride;
        if (Geo::kTma || wg == 0)
          load_tile(sA, r0, y0, rstride, r_rows, DQ ? h : kvh, r_lo, bar);
        if (Geo::kTma || wg == 1)
          load_tile(sA + kTile, r1, y1, rstride, r_rows, DQ ? h : kvh, r_lo, bar);
      }
      if (Geo::kTma || wg == 0) load_tile(dst, m0, x0, stride, rows, head, c_lo, bar);
      if (Geo::kTma || wg == 1) load_tile(dst + kTile, m1, x1, stride, rows, head, c_lo, bar);
    }
    if (!DQ && wg == 0) {
      const float* row = (t < 64 ? lse : delta) +
                         (static_cast<int64_t>(b) * H + hi_) * Sq + c_lo + (t & 63);
      const bool ok = c_lo + (t & 63) < Sq;
      cp_async4(smem_addr(sRow + st * 128 + t), ok ? row : lse, ok);
    }
    if (!Geo::kTma || (!DQ && wg == 0)) mbar_arrive_cp_async(bar);
  };

  if (n_items > 0) {
    load_item(0);
    if (n_items > 1) load_item(1);
  }
  if (DQ) {
    // the tile's lse, and its delta = rowsum(g * out) written for the dk/dv
    // pass, while the copies are in flight; each warp 8 rows
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    if (tid < 64) sRow[tid] = r_lo + tid < Sq ? lse[bh * Sq + r_lo + tid] : 0.0f;
    const int warp = tid >> 5;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // lane l takes dims 8l .. 8l + 7 of row 8 warp + j: one 16-byte load
      // of g and of out each, all rows' loads in flight together
      const int r = warp * 8 + j;
      acc[j] = 0.0f;
      if (8 * lane < HD && r_lo + r < Sq) {
        const int64_t off = (static_cast<int64_t>(b) * Sq + r_lo + r) * q_stride +
                            static_cast<int64_t>(h) * HD + 8 * lane;
        float gf[8], of[8];
        unpack16(*reinterpret_cast<const uint4*>(g + off), gf);
        unpack16(*reinterpret_cast<const uint4*>(out + off), of);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j] = fmaf(gf[e], of[e], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = warp * 8 + j;
      const float sum = warp_sum(acc[j]);
      if (lane == 0) {
        sRow[64 + r] = r_lo + r < Sq ? sum : 0.0f;
        if (r_lo + r < Sq) delta[bh * Sq + r_lo + r] = sum;
      }
    }
    __syncthreads();
  }

  // this thread's fragment rows r0 and r0 + 8 of the block's 64, and its
  // columns 8j + cq, + 1 of its warpgroup's 32 score columns
  const int r0 = wq * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float inv_cap = 1.0f / softcap;
  float acc[NACC][NSL][NS / 2];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) acc[a][sl][x] = 0.0f;

  for (int i = 0; i < n_items; ++i) {
    const int st = i % kBwStages;
    int hi_, c_lo;
    item(i, hi_, c_lo);
    const uint32_t sB0 = sB + 2 * st * kTile, sB1 = sB0 + kTile;
    mbar_wait(full0 + 8 * st, (i / kBwStages) & 1);
    fence_proxy_async();           // cp.async (generic proxy) may have written it

    // this warpgroup's 32 columns of S and dP (S^T and dP^T in dk/dv)
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<32, 0>(s, bw_desc_k<HD>(sA, 0, kk), bw_desc_k<HD>(sB0, 32 * wg, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<32, 0>(dp, bw_desc_k<HD>(sA + kTile, 0, kk), bw_desc_k<HD>(sB1, 32 * wg, kk),
                      kk > 0);
    wgmma_commit();
    if (i > 0) {
      // this warpgroup's output products of item i - 1, then the other's:
      // the score tiles and item i - 1's stage are free
      wgmma_wait<1>();
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int sl = 0; sl < NSL; ++sl) fence_regs(acc[a][sl]);
      named_bar_sync(1, kBwThreads);
      if (i + 1 < n_items) load_item(i + 1);
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p and ds of entry x: (row r0 + 8 ((x >> 1) & 1), column 32 wg + 8 (x >> 2)
    // + cq + (x & 1)); rows are queries in dq, keys in dk/dv
    const int q_lo = DQ ? r_lo : c_lo, k_lo = DQ ? c_lo : r_lo;
    const bool full = q_lo + 64 <= Sq && k_lo + 64 <= Skv &&
                      (!causal || k_lo + 63 <= q_lo) &&
                      (window <= 0 || k_lo > q_lo + 63 - window);
    const float* rows = DQ ? sRow : sRow + st * 128;   // lse, then delta at + 64
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int m = r0 + 8 * ((x >> 1) & 1);
      const int n = 32 * wg + 8 * (x >> 2) + cq + (x & 1);
      const int qi = DQ ? m : n;
      float sc = s[x] * scale, dcap = 1.0f;
      if (softcap > 0.0f) {
        const float th = tanhf(sc * inv_cap);
        sc = softcap * th;
        dcap = 1.0f - th * th;
      }
      if (!full) {
        const int qpos = q_lo + qi, kpos = k_lo + (DQ ? n : m);
        bool ok = kpos < Skv && qpos < Sq;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) sc = kNegInf;
      }
      const float p = expf(sc - rows[qi]);
      float ds = p * (dp[x] - rows[64 + qi]);
      if (softcap > 0.0f) ds = ds * dcap;
      ds = ds * scale;
      s[x] = p;
      dp[x] = ds;
    }
    // the score tiles, hi and lo: (row m, column n) of a 64 x 64 tile at
    // tile_offset<64>(m, n / 8) + 2 (n % 8)
#pragma unroll
    for (int x = 0; x < 16; x += 2) {
      const int m = r0 + 8 * ((x >> 1) & 1);
      const int n = 32 * wg + 8 * (x >> 2) + cq;
      const uint32_t off = tile_offset<64>(m, n >> 3) + 2 * (n & 7);
      __nv_bfloat162 hv = __floats2bfloat162_rn(dp[x], dp[x + 1]);
      st_shared_u32(sP + off, *reinterpret_cast<uint32_t*>(&hv));
      st_shared_u32(sP + kBwScore + off, pack_bf16(dp[x] - __low2float(hv),
                                                   dp[x + 1] - __high2float(hv)));
      if (!DQ) {
        hv = __floats2bfloat162_rn(s[x], s[x + 1]);
        st_shared_u32(sP + 2 * kBwScore + off, *reinterpret_cast<uint32_t*>(&hv));
        st_shared_u32(sP + 3 * kBwScore + off, pack_bf16(s[x] - __low2float(hv),
                                                         s[x + 1] - __high2float(hv)));
      }
    }
    fence_proxy_async();           // st.shared wrote them; wgmma reads them
    named_bar_sync(2, kBwThreads);

    // dQ += dS K, or dK += dS^T Q and dV += P^T dO: A the score tiles
    // (K-major, 16 streamed rows a step), B the streamed tile MN-major at
    // this warpgroup's dims
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sl = 0; sl < NSL; ++sl) {
        const int dim0 = wg * NH + sl * NS;
        const uint64_t b0 = bw_desc_mn<HD>(sB0, dim0, kk);
        wgmma_ss<NS, 1>(acc[0][sl], gmma_desc(sP + kk * 256, 128, 1024), b0, 1);
        wgmma_ss<NS, 1>(acc[0][sl], gmma_desc(sP + kBwScore + kk * 256, 128, 1024), b0, 1);
        if (!DQ) {
          const uint64_t b1 = bw_desc_mn<HD>(sB1, dim0, kk);
          wgmma_ss<NS, 1>(acc[NACC - 1][sl],
                          gmma_desc(sP + 2 * kBwScore + kk * 256, 128, 1024), b1, 1);
          wgmma_ss<NS, 1>(acc[NACC - 1][sl],
                          gmma_desc(sP + 3 * kBwScore + kk * 256, 128, 1024), b1, 1);
        }
      }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl) fence_regs(acc[a][sl]);

  // rows below Sq: dQ (query rows of head h); below Skv: dK and dV (keys of
  // kv head kvh)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r_lo + r0 + 8 * hr;
    if (row >= r_rows) continue;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      __nv_bfloat16* dst =
          DQ ? dq + (static_cast<int64_t>(b) * Sq + row) * q_stride + static_cast<int64_t>(h) * HD
             : (a == 0 ? dk : dv) + (static_cast<int64_t>(b) * Skv + row) * kv_stride +
                   static_cast<int64_t>(kvh) * HD;
#pragma unroll
      for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const int col = wg * NH + sl * NS + 8 * j + cq;
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              acc[a][sl][4 * j + 2 * hr], acc[a][sl][4 * j + 2 * hr + 1]);
        }
    }
  }
}

// Grid (ceil(Sq / 64), B * H); kBwThreads threads.
template <int HD>
__global__ void __launch_bounds__(kBwThreads, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                       const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ out,
                       const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
                       float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                       int Skv, int H, int KV, int causal, int window, float scale,
                       float softcap) {
  bwd_wgmma_pass<HD, true>(maps, q, k, v, out, g, lse, delta, dq, nullptr, nullptr, Sq, Skv,
                           H, KV, causal, window, scale, softcap);
}

// Grid (ceil(Skv / 64), B * KV); kBwThreads threads. Reads the dq pass's delta.
template <int HD>
__global__ void __launch_bounds__(kBwThreads, 1)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
                         float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int KV,
                         int causal, int window, float scale, float softcap) {
  bwd_wgmma_pass<HD, false>(maps, q, k, v, nullptr, g, lse, delta, nullptr, dk, dv, Sq, Skv,
                            H, KV, causal, window, scale, softcap);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Which prefill kernel the last flash_attention_fwd_* call on this thread
// launched (flash_attention_fwd_launched below), so that the wrapper counts
// the tensor-core launches by what ran, not by the dtype it passed.
constexpr int kFwdNone = 0, kFwdTensorCores = 1, kFwdCudaCores = 2;
thread_local int g_fwd_launched = kFwdNone;

// Opt the kernel in to `bytes` of dynamic shared memory (needed above 48 KB
// of dynamic and static shared memory together).
template <typename K>
int allow_smem(K* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int HD>
int launch_prefill_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                       int64_t KV, int64_t causal, int64_t window, double scale,
                       double softcap, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<HD>();
  static int configured = allow_smem(fa_prefill_kernel<float, HD>, smem);
  if (configured != 0) return configured;
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * H));
  fa_prefill_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<int>(Sq), static_cast<int>(Skv),
      static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(causal), static_cast<int>(window),
      static_cast<float>(scale), static_cast<float>(softcap));
  g_fwd_launched = kFwdCudaCores;
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int NWG>
int launch_prefill_tc(const void* q, const void* k, const void* v, void* out,
                      void* lse, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                      int64_t KV, int64_t causal, int64_t window, double scale,
                      double softcap, cudaStream_t stream) {
  constexpr size_t smem = prefill_tc_smem_bytes<HD, NWG>();
  static int configured = allow_smem(fa_prefill_tc_kernel<HD, NWG>, smem);
  if (configured != 0) return configured;
  const dim3 grid(static_cast<unsigned>(B * H / NWG),
                  static_cast<unsigned>((Sq + kTcRows - 1) / kTcRows));
  fa_prefill_tc_kernel<HD, NWG><<<grid, NWG * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<int>(Sq), static_cast<int>(Skv),
      static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(causal), static_cast<int>(window),
      static_cast<float>(scale), static_cast<float>(softcap));
  g_fwd_launched = kFwdTensorCores;
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int prefill_tc_by_groups(const void* q, const void* k, const void* v, void* out,
                         void* lse, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                         int64_t KV, int64_t causal, int64_t window, double scale,
                         double softcap, cudaStream_t stream) {
  if ((H / KV) % 2 == 0)
    return launch_prefill_tc<HD, 2>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, window,
                                    scale, softcap, stream);
  return launch_prefill_tc<HD, 1>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, window,
                                  scale, softcap, stream);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* lse, const void* g, void* dq, void* dk, void* dv,
               void* delta, int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV,
               int64_t causal, int64_t window, double scale, double softcap,
               cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  static int configured_dkdv = allow_smem(fa_bwd_dkdv_kernel<T, HD>, smem);
  static int configured_dq = allow_smem(fa_bwd_dq_kernel<T, HD>, smem);
  if (configured_dkdv != 0) return configured_dkdv;
  if (configured_dq != 0) return configured_dq;
  const int64_t rows = B * Sq * H;
  const unsigned rows_per_block = kBwdThreads / 32;
  fa_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
                           kBwdThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(g), static_cast<float*>(delta),
      rows, static_cast<int>(Sq), static_cast<int>(H), HD);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const unsigned k_tiles = static_cast<unsigned>((Skv + kBwdRows - 1) / kBwdRows);
  fa_bwd_dkdv_kernel<T, HD><<<dim3(k_tiles, static_cast<unsigned>(B * KV)), kBwdThreads,
                              smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<int>(Sq), static_cast<int>(Skv), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(causal), static_cast<int>(window), static_cast<float>(scale),
      static_cast<float>(softcap));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const unsigned q_tiles = static_cast<unsigned>((Sq + kBwdRows - 1) / kBwdRows);
  fa_bwd_dq_kernel<T, HD><<<dim3(q_tiles, static_cast<unsigned>(B * H)), kBwdThreads, smem,
                            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<int>(Sq),
      static_cast<int>(Skv), static_cast<int>(H), static_cast<int>(KV), static_cast<int>(causal),
      static_cast<int>(window), static_cast<float>(scale), static_cast<float>(softcap));
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The row tiles of a (B, S, NH, HD) bf16 tensor for TMA: dims (HD, NH, S, B)
// innermost first, boxes of 64 dims x 1 head x 64 rows x 1 lane, 128-byte
// swizzled; rows at or past S (the tensor's own: Sq for q and g, Skv for k
// and v) are zero-filled.
int encode_row_tiles(CUtensorMap* map, const void* x, int64_t B, int64_t S, int64_t NH,
                     int HD) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(NH * HD) * 2,
                                 static_cast<cuuint64_t>(S * NH * HD) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* out,
                     const void* lse, const void* g, void* dq, void* dk, void* dv,
                     void* delta, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                     int64_t KV, int64_t causal, int64_t window, double scale,
                     double softcap, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr size_t smem_dq = BwdWg<HD, true>::smem, smem_kv = BwdWg<HD, false>::smem;
  static int configured_dq = allow_smem(fa_bwd_dq_wgmma_kernel<HD>, smem_dq);
  static int configured_dkdv = allow_smem(fa_bwd_dkdv_wgmma_kernel<HD>, smem_kv);
  if (configured_dq != 0) return configured_dq;
  if (configured_dkdv != 0) return configured_dkdv;
  BwdMaps maps = {};
  if (BwdWg<HD, true>::kTma) {
    int rc = encode_row_tiles(&maps.q, q, B, Sq, H, HD);
    if (rc == 0) rc = encode_row_tiles(&maps.g, g, B, Sq, H, HD);
    if (rc == 0) rc = encode_row_tiles(&maps.k, k, B, Skv, KV, HD);
    if (rc == 0) rc = encode_row_tiles(&maps.v, v, B, Skv, KV, HD);
    if (rc != 0) return rc;
  }
  // the dq pass first: its prologue writes delta, which the dk/dv pass reads
  fa_bwd_dq_wgmma_kernel<HD><<<dim3(static_cast<unsigned>((Sq + 63) / 64),
                                    static_cast<unsigned>(B * H)),
                               kBwThreads, smem_dq, stream>>>(
      maps, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), static_cast<int>(Sq),
      static_cast<int>(Skv), static_cast<int>(H), static_cast<int>(KV), static_cast<int>(causal),
      static_cast<int>(window), static_cast<float>(scale), static_cast<float>(softcap));
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  fa_bwd_dkdv_wgmma_kernel<HD><<<dim3(static_cast<unsigned>((Skv + 63) / 64),
                                      static_cast<unsigned>(B * KV)),
                                 kBwThreads, smem_kv, stream>>>(
      maps, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<int>(Sq), static_cast<int>(Skv),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(causal),
      static_cast<int>(window),
      static_cast<float>(scale), static_cast<float>(softcap));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int RB>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* kv_len, void* out, void* part_acc, void* part_ml,
                  void* counters, int64_t B, int64_t Sq, int64_t L, int64_t H,
                  int64_t KV, int64_t chunk, int64_t n_split, double scale,
                  double softcap, cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<HD, RB>();
  static int configured = allow_smem(fa_decode_split_kernel<T, HD, RB>, smem);
  if (configured != 0) return configured;
  const dim3 grid(static_cast<unsigned>(B * KV), static_cast<unsigned>(n_split));
  fa_decode_split_kernel<T, HD, RB><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(counters),
      static_cast<int>(Sq), static_cast<int>(L), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(chunk), static_cast<int>(n_split),
      static_cast<float>(scale), static_cast<float>(softcap));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int decode_by_rows(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* part_acc, void* part_ml,
                   void* counters, int64_t B, int64_t Sq, int64_t L, int64_t H,
                   int64_t KV, int64_t chunk, int64_t n_split, double scale,
                   double softcap, cudaStream_t stream) {
  const int64_t rows = (H / KV) * Sq;
  if (rows > kMaxDecodeRows) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 2)
    return launch_decode<T, HD, 2>(q, k, v, kv_len, out, part_acc, part_ml, counters,
                                   B, Sq, L, H, KV, chunk, n_split, scale, softcap,
                                   stream);
  return launch_decode<T, HD, kMaxDecodeRows>(q, k, v, kv_len, out, part_acc, part_ml,
                                              counters, B, Sq, L, H, KV, chunk, n_split,
                                              scale, softcap, stream);
}

#define FA_BY_HD(hd, CALL)                                        \
  switch (hd) {                                                   \
    case 16: return CALL(16);                                     \
    case 32: return CALL(32);                                     \
    case 64: return CALL(64);                                     \
    case 128: return CALL(128);                                   \
    case 256: return CALL(256);                                   \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

}  // namespace

// q and out (B, Sq, H, hd), k and v (B, Skv, KV, hd), lse (B, H, Sq);
// softcap <= 0 means none; window <= 0 means none; causal is 0 or 1.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int64_t B, int64_t Sq, int64_t Skv,
                                       int64_t H, int64_t KV,
                                       int64_t hd, int64_t causal,
                                       int64_t window, double scale,
                                       double softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  g_fwd_launched = kFwdNone;
#define FA_CALL(HD) \
  launch_prefill_f32<HD>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, window, scale, \
                         softcap, st)
  FA_BY_HD(hd, FA_CALL)
#undef FA_CALL
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int64_t B, int64_t Sq, int64_t Skv,
                                        int64_t H, int64_t KV,
                                        int64_t hd, int64_t causal,
                                        int64_t window, double scale,
                                        double softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  g_fwd_launched = kFwdNone;
#define FA_CALL(HD) \
  prefill_tc_by_groups<HD>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, window, scale, \
                           softcap, st)
  FA_BY_HD(hd, FA_CALL)
#undef FA_CALL
}

// 1: the last flash_attention_fwd_* call on this thread launched the
// tensor-core kernel; 2: the CUDA-core kernel; 0: none.
extern "C" int flash_attention_fwd_launched() { return g_fwd_launched; }

// part_acc, part_ml and counters: scratch of the split-KV merge (see
// fa_decode_split_kernel); unused when n_split is 1.
extern "C" int flash_attention_decode_f32(
    const void* q, const void* k, const void* v, const void* kv_len, void* out,
    void* part_acc, void* part_ml, void* counters, int64_t B, int64_t Sq,
    int64_t L, int64_t H, int64_t KV, int64_t hd, int64_t chunk,
    int64_t n_split, double scale, double softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_CALL(HD)                                                             \
  decode_by_rows<float, HD>(q, k, v, kv_len, out, part_acc, part_ml, counters, B, \
                            Sq, L, H, KV, chunk, n_split, scale, softcap, st)
  FA_BY_HD(hd, FA_CALL)
#undef FA_CALL
}

extern "C" int flash_attention_decode_bf16(
    const void* q, const void* k, const void* v, const void* kv_len, void* out,
    void* part_acc, void* part_ml, void* counters, int64_t B, int64_t Sq,
    int64_t L, int64_t H, int64_t KV, int64_t hd, int64_t chunk,
    int64_t n_split, double scale, double softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_CALL(HD)                                                          \
  decode_by_rows<__nv_bfloat16, HD>(q, k, v, kv_len, out, part_acc, part_ml, \
                                    counters, B, Sq, L, H, KV, chunk, n_split, \
                                    scale, softcap, st)
  FA_BY_HD(hd, FA_CALL)
#undef FA_CALL
}

// The backward of the prefill (flash_attention_bwd): q, out, g, dq (B, Sq,
// H, hd) and k, v, dk, dv (B, Skv, KV, hd) in the inputs' type, lse (B, H,
// Sq) f32 from the forward; delta (B, H, Sq) f32 scratch. Three launches on
// `stream` in f32, two in bf16 (the dq pass writes delta); returns the
// first error.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out, const void* lse,
    const void* g, void* dq, void* dk, void* dv, void* delta, int64_t B, int64_t Sq,
    int64_t Skv, int64_t H, int64_t KV, int64_t hd, int64_t causal, int64_t window,
    double scale, double softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_CALL(HD)                                                                      \
  launch_bwd<float, HD>(q, k, v, out, lse, g, dq, dk, dv, delta, B, Sq, Skv, H, KV, causal, \
                        window, scale, softcap, st)
  FA_BY_HD(hd, FA_CALL)
#undef FA_CALL
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out, const void* lse,
    const void* g, void* dq, void* dk, void* dv, void* delta, int64_t B, int64_t Sq,
    int64_t Skv, int64_t H, int64_t KV, int64_t hd, int64_t causal, int64_t window,
    double scale, double softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_CALL(HD)                                                                       \
  launch_bwd_wgmma<HD>(q, k, v, out, lse, g, dq, dk, dv, delta, B, Sq, Skv, H, KV, causal, \
                       window, scale, softcap, st)
  FA_BY_HD(hd, FA_CALL)
#undef FA_CALL
}
