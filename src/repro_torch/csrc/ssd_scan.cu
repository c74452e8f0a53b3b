// Hopper (sm_90a) kernels for the Mamba-2 chunked SSD scan, with a plain C
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
// with y written in x's type and the final state in float32, everything
// summed in float32, as the Pallas kernel does (it upcasts its tiles).
//
// Layout: the model's own. x (Bz, S, H, P), dt (Bz, S, H) f32, A (H,) f32,
// B and C (Bz, S, G, N) shared by the H/G heads of a group; y (Bz, S, H, P),
// state (Bz, H, P, N). A block reads its group's B and C rows directly, so
// the per-head broadcast of B and C that the reference wrapper builds in
// HBM (H/G times their bytes) is never materialized.
//
// Bound on this card, at the serving prefill's shape (mamba2-780m: 48 heads
// x 64, one group of state 128, S 512 in chunks of 256, bf16): 65.8 MB of x,
// y, B, C, dt and the final state at 8 lanes, 0.0196 ms at 3.35 TB/s,
// against 16.1 GFLOP of the triangle s <= t, 0.0163 ms at the 989 TFLOP/s
// bf16 tensor-core rate: bytes bound it (4 lanes, 32.9 MB: 0.0098 ms).
//
// Design, bf16 (ssd_scan_bf16): the SSD algorithm's own split into three
// passes (Dao & Gu, "Transformers are SSMs", 2024, section 6: chunk state,
// state passing, chunk scan), one launch each, so that many small blocks
// fill the card at the serving shape where the first port ran one block of
// 256 threads per (lane, head) row, in waves:
// 1. ssd_scan_chunk_state_kernel, one warpgroup per (row, chunk): makes cum
//    once (chunk_cumsum, the warp scan below), writes it to a float32
//    scratch (rows, S) that passes 2 and 3 read, so every pass uses the
//    same bits (exp turns an ulp of cum into relative error), and computes
//    the chunk's own state term sum_s exp(cum_Q - cum_s) dt_s x_s (x) B_s as
//    a (P x Q) . (Q x N) product on the tensor cores: the decayed xw from
//    registers (the A operand, built from the x tile), B from shared memory;
//    the term goes to a float32 scratch (rows, chunks, P, N).
// 2. ssd_scan_state_pass_kernel, over the chunks of each row in order:
//    S_c = exp(cum_Q) S_{c-1} + term_c (the reference kernel's state update),
//    the final state written in float32, and each chunk's S_prev as two bf16
//    terms (below) to a scratch (rows, chunks, 2, P, N) that pass 3 copies
//    straight into its operand tiles.
// 3. ssd_scan_chunk_scan_kernel, one warpgroup per (row, chunk, 64-row
//    t-tile): for each s-tile at or below the diagonal CB = C_t . B_s^T
//    (both from shared memory), W = CB exp(cum_t - cum_s) dt_s in registers
//    and y += W x_s (W from registers, x from shared memory, MN-major); then
//    y += exp(cum_t) C_t . S_prev^T, with S_prev copied into the ring once
//    every s-tile is done, which keeps the block at 64 KB of shared memory
//    (three blocks per SM). The exponent is masked before exp on the tiles
//    that cross the diagonal or the chunk's end: at chunk 256 with strong
//    decay cum_t - cum_s for s > t passes 88, exp overflows to inf, and
//    CB * inf is NaN where CB is 0. The t-tiles of one (row, chunk) are
//    neighbours in launch order, the one with the most s-tiles first, so
//    they run together and share that chunk's B, x and S_prev in L2; the
//    lanes vary faster than the heads, so the blocks in flight spread their
//    reads of each lane's B and C (the heads of a group share them) over
//    more lines of L2.
// Every product is a bf16 wgmma (m64n64k16) with float32 accumulation. The
// B and x s-tiles flow through a two-stage ring in shared memory: tiles 0
// and 1 are copied up front, each stage's mbarrier completes when its
// cp.async copies land, and the stage of tile i takes tile i + 2 once tile
// i's products are complete. All tiles go from device memory straight into
// the no-swizzle wgmma layout by 16-byte cp.async (zero-filled past the
// chunk, past P and past N), with no float32 staging copy; the outputs (the
// term, y) go through shared memory so that whole rows are stored at once.
// Pass 1 holds 48 KB of shared memory. No atomics: every sum is taken in a
// fixed order, so launches repeat bit for bit. The wrapper allocates the
// three scratch buffers; the kernels allocate nothing. What bounds the
// passes in practice is the copying into shared memory, not the products
// (PERF.md has the measurements).
//
// Precision. C, B and x are bf16, so C . B^T is a sum of exact products in
// float32. The three float32 operands go in as two bf16 terms, hi = bf16(v)
// and lo = bf16(v - hi), whose products are summed in float32: hi + lo
// keeps 16 significant bits of v. They are W, S_prev and the decayed xw (x
// times exp(cum_Q - cum_s) dt_s; B is not decayed). One bf16 rounding of W
// or of S_prev leaves ssd_tolerance at mamba2-780m's row shape
// (tests/test_torch_ssd_design.py models the passes' arithmetic on the CPU);
// hi + lo stays within it.
//
// float32 (ssd_scan_f32) keeps the CUDA-core kernel of the first port
// (ssd_scan_f32_kernel below): wgmma takes no float32 operands, and float32
// lies on no running path (serving computes in bf16; FL training runs the
// autograd ssd_chunked). One block per (lane, head) row walks its chunks
// with the (P, N) state in shared memory and 64-row t and s tiles, as 4x4
// register tiles of float32 FMAs. This is a dispatch by dtype in the entry
// points, not a fallback.
//
// Entry points take device pointers, sizes as int64_t and the CUDA stream,
// launch, and return cudaGetLastError() as an int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 256;

// The inclusive cumsum of dt * A over a chunk of Q steps, from sDt into
// sCum: warp 0, each lane a run of consecutive steps, then a shuffle scan
// of the run totals. The one place where cum is made.
__device__ __forceinline__ void chunk_cumsum(const float* sDt, float* sCum,
                                             int Q, float a, int tid) {
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
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, one block per row
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows of t (or s) per tile
constexpr int kLdW = kTile + 1;  // padded row of the W tile

// Copy `rows` rows (from time step `row0` on) of a
// (Bz, S, heads, width) tensor into a (kTile, ld) float32 tile, zeroing the
// rows past `rows`; `scale` (may be null) multiplies row r by scale[r].
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int64_t row0, int64_t row_stride,
                                          int width, int rows,
                                          const float* scale) {
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    float v = 0.0f;
    if (r < rows) {
      v = src[(row0 + r) * row_stride + c];
      if (scale != nullptr) v = __fmul_rn(v, scale[r]);
    }
    dst[r * ld + c] = v;
  }
}

// One block per SM fits (the tiles take ~132 KB of shared memory), so the
// launch bound lets each thread keep its register tiles without spilling.
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ state_out, int64_t S, int H, int P,
                    int G, int N, int Q) {
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
  const float* xr = x + b * S * x_row + static_cast<int64_t>(h) * P;
  float* yr = y + b * S * x_row + static_cast<int64_t>(h) * P;
  const float* Br = Bm + b * S * bc_row + static_cast<int64_t>(g) * N;
  const float* Cr = Cm + b * S * bc_row + static_cast<int64_t>(g) * N;
  const float* dtr = dt + b * S * H + h;

  for (int i = tid; i < P * ldN; i += kThreads) sS[i] = 0.0f;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int64_t n_chunks = S / Q;

  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t t_base = c * Q;
    __syncthreads();  // the previous chunk's readers of sCum/sDt are done
    for (int i = tid; i < Q; i += kThreads) sDt[i] = dtr[(t_base + i) * H];
    __syncthreads();
    chunk_cumsum(sDt, sCum, Q, a, tid);
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      sDecay[i] = __fmul_rn(expf(__fsub_rn(cum_last, sCum[i])), sDt[i]);

    // ---- outputs, one t-tile at a time
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int t0 = tt * kTile;
      const int rows_t = min(kTile, Q - t0);
      __syncthreads();  // sC / sB / sX / sW free
      load_tile(sC, ldN, Cr, t_base + t0, bc_row, N, rows_t, nullptr);
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
        load_tile(sB, ldN, Br, t_base + s0, bc_row, N, rows_s, nullptr);
        load_tile(sX, ldP, xr, t_base + s0, x_row, P, rows_s, nullptr);
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
            yr[(t_base + t) * x_row + p] = __fadd_rn(y_inter[i][j], y_intra[i][j]);
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
      load_tile(sB, ldN, Br, t_base + s0, bc_row, N, rows_s, nullptr);
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

size_t f32_smem_bytes(int64_t P, int64_t N, int64_t Q) {
  const int64_t floats = P * (N + 1) + 2 * kTile * (N + 1) + kTile * (P + 1) +
                         kTile * kLdW + 3 * Q;
  return static_cast<size_t>(floats) * sizeof(float);
}

// ---------------------------------------------------------------------------
// bf16: three passes on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;                  // one warpgroup per block
constexpr int kRows = 64;                        // rows of t, s or p per tile
constexpr int kStages = 2;                       // ring depth of s-tiles
constexpr uint32_t kRowsN8 = kMaxN * 16;         // bytes of 8 rows, B/C/S tile
constexpr uint32_t kRowsP8 = kMaxP * 16;         // bytes of 8 rows, x tile
constexpr uint32_t kTileN = kRows * kRowsN8 / 8; // (64 x 128) bf16, 16 KB
constexpr uint32_t kTileP = kRows * kRowsP8 / 8; // (64 x 64) bf16, 8 KB
// row pitches of the output tiles staged in shared memory for full-row
// stores: past the row by 32 and 16 bytes, so the fragment writes hit 32
// banks
constexpr int kTermPitch = kMaxN * 4 + 32;       // (64 x 128) f32 term
constexpr int kYPitch = kMaxP * 2 + 16;          // (64 x 64) bf16 y

constexpr uint32_t kStage = kTileN + kTileP;     // one s-tile: B, then x
constexpr uint32_t kRing = kStages * kStage;
constexpr size_t kStateSmem = kRing;             // pass 1: the ring
constexpr size_t kScanSmem = kTileN + kRing;     // pass 3: C and the ring
static_assert(kRows * kTermPitch <= kRing, "term staging fits the ring");
static_assert(kRows * kYPitch <= kRing, "y staging fits the ring");
static_assert(2 * kTileN <= kRing, "S_prev (hi, lo) fits the ring");

struct ScanArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  bf16* y;
  float* state;   // (rows, P, N) f32, the final state
  float* cum;     // (rows, S) f32 scratch: cum of every chunk (pass 1)
  float* term;    // (rows, nc, P, N) f32 scratch: each chunk's own term
  bf16* prev;     // (rows, nc, 2, P, N) bf16 scratch: S_prev as hi, lo
  int64_t S;
  int Bz, H, P, G, N, Q, nc;
};

// Where one (row, chunk) starts in the model-layout tensors.
struct ChunkPtrs {
  const bf16* x;    // x of step 0 of the chunk, this head
  const bf16* B;    // B of step 0, this head's group
  const bf16* C;
  const float* dt;
  int64_t x_row;    // elements between two steps of x (and y)
  int64_t bc_row;   // of B and C
  int64_t y_off;    // offset of x (and y) from the tensor's start
  int h;
};

// The row (b * H + h) of launch index i: the lanes vary fastest and the
// heads slowest, so the blocks in flight read the B and C of every lane
// (the heads of a group share theirs) and no few lines of L2 serve them all.
__device__ __forceinline__ int row_at(const ScanArgs& a, int i) {
  const int h = i / a.Bz, b = i - h * a.Bz;
  return b * a.H + h;
}

__device__ __forceinline__ ChunkPtrs chunk_ptrs(const ScanArgs& a, int row,
                                                int c) {
  ChunkPtrs p;
  const int64_t b = row / a.H;
  p.h = row - static_cast<int>(b) * a.H;
  const int g = p.h / (a.H / a.G);
  const int64_t t0 = b * a.S + static_cast<int64_t>(c) * a.Q;
  p.x_row = static_cast<int64_t>(a.H) * a.P;
  p.bc_row = static_cast<int64_t>(a.G) * a.N;
  p.y_off = t0 * p.x_row + static_cast<int64_t>(p.h) * a.P;
  p.x = a.x + p.y_off;
  p.B = a.B + t0 * p.bc_row + static_cast<int64_t>(g) * a.N;
  p.C = a.C + t0 * p.bc_row + static_cast<int64_t>(g) * a.N;
  p.dt = a.dt + t0 * a.H + p.h;
  return p;
}

// s-tile i of the chunk (steps 64 i ..) of B and x into stage i % kStages;
// every thread then arrives on that stage's barrier, which completes when
// all 128 threads' copies (and any this thread issued before) have landed.
__device__ __forceinline__ void load_s_tile(uint32_t ring, uint32_t full0,
                                            int i, const ChunkPtrs& p,
                                            const ScanArgs& a, int t) {
  const uint32_t st = ring + (i % kStages) * kStage;
  const int s0 = i * kRows;
  load_tile_async<kMaxN>(st, p.B + s0 * p.bc_row, p.bc_row, a.Q - s0, t, a.N);
  load_tile_async<kMaxP>(st + kTileN, p.x + s0 * p.x_row, p.x_row, a.Q - s0, t,
                         a.P);
  mbar_arrive_cp_async(full0 + 8 * (i % kStages));
}

// The ring: s-tiles 0 and 1 are copied up front; once tile i's products
// are complete (wgmma_wait_all in every warp: no warp reads the stage any
// more), its stage takes tile i + 2. Each barrier counts the 128 threads'
// copies.
__device__ __forceinline__ void init_bars(uint32_t bar0, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bar0 + 8 * i, kTcThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Wait for s-tile i in its stage, readable by wgmma.
__device__ __forceinline__ void wait_s_tile(uint32_t full0, int i) {
  mbar_wait(full0 + 8 * (i % kStages), (i / kStages) & 1);
  fence_proxy_async();  // cp.async wrote it; wgmma reads it
}

// v as the two bf16 terms hi = bf16(v) and lo = bf16(v - hi), for a pair of
// adjacent columns of a wgmma A fragment register.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(v0, __low2float(h)), __fsub_rn(v1, __high2float(h)));
}

// Pass 1. Grid (rows * nc); block one warpgroup; (row, chunk c).
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_scan_chunk_state_kernel(const ScanArgs a) {
  extern __shared__ __align__(128) unsigned char st_smem[];
  __shared__ float sDt[kMaxChunk], sCum[kMaxChunk], sDecay[kMaxChunk];
  __shared__ __align__(8) uint64_t bars[kStages];
  const uint32_t ring = smem_addr(st_smem), full0 = smem_addr(bars);
  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  const int ri = blockIdx.x / a.nc, c = blockIdx.x - ri * a.nc;
  const int row = row_at(a, ri);
  const int Q = a.Q, n_tiles = (Q + kRows - 1) / kRows;
  const ChunkPtrs p = chunk_ptrs(a, row, c);

  init_bars(full0, kStages);
  for (int i = 0; i < kStages && i < n_tiles; ++i) load_s_tile(ring, full0, i, p, a, tid);

  for (int i = tid; i < Q; i += kTcThreads) sDt[i] = p.dt[i * a.H];
  __syncthreads();
  chunk_cumsum(sDt, sCum, Q, a.A[p.h], tid);
  __syncthreads();
  const float cum_last = sCum[Q - 1];
  float* cum_out = a.cum + static_cast<int64_t>(row) * a.S +
                   static_cast<int64_t>(c) * Q;
  for (int i = tid; i < n_tiles * kRows; i += kTcThreads) {
    float d = 0.0f;   // steps past the chunk: x is zero-filled there too
    if (i < Q) {
      cum_out[i] = sCum[i];
      d = __fmul_rn(expf(__fsub_rn(cum_last, sCum[i])), sDt[i]);
    }
    sDecay[i] = d;
  }
  __syncthreads();

  // this thread's A fragment rows (p) r0 and r0 + 8, columns (s) cq, cq + 1
  // and cq + 8, cq + 9 of each 16-step slice
  const int r0 = wq * 16 + (lane >> 2), cq = 2 * (lane & 3);
  float acc[2][32];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[sl][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const uint32_t sB = ring + (i % kStages) * kStage;
    const unsigned char* xs = st_smem + (i % kStages) * kStage + kTileN;
    const float* dec = sDecay + i * kRows;
    wait_s_tile(full0, i);

    // xw^T (p x s) as A fragments, two bf16 terms: register r of slice kk
    // holds rows r0 + 8 (r & 1), steps 16 kk + cq + 8 (r >> 1) + {0, 1}
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pr = r0 + 8 * (r & 1), s = 16 * kk + cq + 8 * (r >> 1);
        const uint32_t off = tile_offset<kMaxP>(s, pr >> 3) + (pr & 7) * 2;
        const float x0 = __bfloat162float(*reinterpret_cast<const bf16*>(xs + off));
        const float x1 = __bfloat162float(*reinterpret_cast<const bf16*>(xs + off + 16));
        split_pair(__fmul_rn(x0, dec[s]), __fmul_rn(x1, dec[s + 1]), ah[kk][r],
                   al[kk][r]);
      }

    // term (p x n) += xw^T B, B (s x n) MN-major, n in two slices of 64
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const uint64_t db = gmma_desc(sB + kk * 2 * kRowsN8 + sl * 8 * 128, kRowsN8, 128);
        wgmma_rs<64>(acc[sl], ah[kk], db);
        wgmma_rs<64>(acc[sl], al[kk], db);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(ah);
    fence_regs(al);
    if (i + kStages < n_tiles) load_s_tile(ring, full0, i + kStages, p, a, tid);
  }

  // the term through shared memory (the ring is free once every warp is
  // past its last product), then rows of N floats stored whole: entry
  // 4j + 2i + e of slice sl is (p = r0 + 8i, n = 64 sl + 8j + cq + e)
  __syncthreads();
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(st_smem + (r0 + 8 * hr) * kTermPitch +
                                   (64 * sl + 8 * j + cq) * 4) =
            make_float2(acc[sl][4 * j + 2 * hr], acc[sl][4 * j + 2 * hr + 1]);
  __syncthreads();
  float* out = a.term + (static_cast<int64_t>(row) * a.nc + c) * a.P * a.N;
  const int per_row = a.N / 4;   // 16-byte chunks of a row
  for (int e = tid; e < a.P * per_row; e += kTcThreads) {
    const int pr = e / per_row, ch = e - pr * per_row;
    *reinterpret_cast<float4*>(out + pr * a.N + 4 * ch) =
        *reinterpret_cast<const float4*>(st_smem + pr * kTermPitch + 16 * ch);
  }
}

// Pass 2. Grid (rows, ceil(P * N / 512)); each thread 4 consecutive (p, n)
// entries of one row, over its chunks in order.
__global__ void __launch_bounds__(kTcThreads)
ssd_scan_state_pass_kernel(const ScanArgs a) {
  const int row = blockIdx.x;
  const int PN = a.P * a.N;
  const int e = (blockIdx.y * kTcThreads + threadIdx.x) * 4;
  if (e >= PN) return;
  const float* cum_end = a.cum + static_cast<int64_t>(row) * a.S + a.Q - 1;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < a.nc; ++c) {
    const int64_t k = static_cast<int64_t>(row) * a.nc + c;
    if (c > 0) {   // S_prev of chunk c, as hi and lo
      uint32_t hi[2], lo[2];
      split_pair(s[0], s[1], hi[0], lo[0]);
      split_pair(s[2], s[3], hi[1], lo[1]);
      bf16* dst = a.prev + 2 * k * PN + e;
      *reinterpret_cast<uint2*>(dst) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(dst + PN) = make_uint2(lo[0], lo[1]);
    }
    const float4 t = *reinterpret_cast<const float4*>(a.term + k * PN + e);
    const float d = expf(cum_end[static_cast<int64_t>(c) * a.Q]);
    s[0] = __fadd_rn(__fmul_rn(d, s[0]), t.x);
    s[1] = __fadd_rn(__fmul_rn(d, s[1]), t.y);
    s[2] = __fadd_rn(__fmul_rn(d, s[2]), t.z);
    s[3] = __fadd_rn(__fmul_rn(d, s[3]), t.w);
  }
  *reinterpret_cast<float4*>(a.state + static_cast<int64_t>(row) * PN + e) =
      make_float4(s[0], s[1], s[2], s[3]);
}

// Pass 3. Grid (rows * nc * ceil(Q / 64)); block one warpgroup; (row, chunk
// c, t-tile tt). The t-tiles of one (row, chunk) are neighbours in launch
// order, so they run together and share its B, x and S_prev in L2; the last
// t-tile (the most s-tiles) first. 64 KB of shared memory (C and the ring):
// three blocks per SM.
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_scan_chunk_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(128) unsigned char sc_smem[];
  __shared__ float sDt[kMaxChunk], sCum[kMaxChunk];
  __shared__ __align__(8) uint64_t bars[kStages + 1];   // the ring, S_prev
  const uint32_t sC = smem_addr(sc_smem), ring = sC + kTileN;
  const uint32_t full0 = smem_addr(bars), s_bar = full0 + 8 * kStages;
  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  const int Q = a.Q, n_t = (Q + kRows - 1) / kRows;
  const int rc = blockIdx.x / n_t;
  const int tt = n_t - 1 - (blockIdx.x - rc * n_t), t0 = tt * kRows;
  const int ri = rc / a.nc, c = rc - ri * a.nc;
  const int row = row_at(a, ri);
  const ChunkPtrs p = chunk_ptrs(a, row, c);

  init_bars(full0, kStages + 1);
  // stage 0's barrier also covers C's t-tile
  load_tile_async<kMaxN>(sC, p.C + t0 * p.bc_row, p.bc_row, Q - t0, tid, a.N);
  for (int i = 0; i < kStages && i <= tt; ++i) load_s_tile(ring, full0, i, p, a, tid);

  const float* cum_in = a.cum + static_cast<int64_t>(row) * a.S +
                        static_cast<int64_t>(c) * Q;
  for (int i = tid; i < t0 + kRows; i += kTcThreads) {
    sCum[i] = i < Q ? cum_in[i] : 0.0f;
    sDt[i] = i < Q ? p.dt[i * a.H] : 0.0f;
  }
  __syncthreads();

  // accumulator entry 4j + 2i + e is (row r0 + 8i, column 8j + cq + e)
  const int r0 = wq * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const float ct[2] = {sCum[t0 + r0], sCum[t0 + r0 + 8]};
  float y[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) y[x] = 0.0f;

  for (int st = 0; st <= tt; ++st) {
    const int s0 = st * kRows;
    const uint32_t sB = ring + (st % kStages) * kStage, sX = sB + kTileN;
    wait_s_tile(full0, st);

    // CB (t x s) = C B^T, both K-major over n
    float cb[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk)
      wgmma_ss_m64n64k16(cb, gmma_desc(sC + kk * 256, 128, kRowsN8),
                         gmma_desc(sB + kk * 256, 128, kRowsN8), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(cb);

    // W = CB exp(cum_t - cum_s) dt_s; on a tile that crosses the diagonal
    // or the chunk's end, entries with s > t or t >= Q are 0 and never
    // reach expf
    const bool whole = st < tt && t0 + kRows <= Q;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int hr = (x >> 1) & 1;
      const int t = t0 + r0 + 8 * hr, s = s0 + 8 * (x >> 2) + cq + (x & 1);
      float w = 0.0f;
      if (whole || (s <= t && t < Q))
        w = __fmul_rn(__fmul_rn(cb[x], expf(__fsub_rn(ct[hr], sCum[s]))), sDt[s]);
      cb[x] = w;
    }

    // W as A fragments, two bf16 terms: step slice kk covers s 16 kk ..
    // 16 kk + 15, register r = (entries 8 kk + 2 r, 8 kk + 2 r + 1)
    uint32_t wh[4][4], wl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(cb[8 * kk + 2 * r], cb[8 * kk + 2 * r + 1], wh[kk][r], wl[kk][r]);

    // y += W_hi x + W_lo x; x (s x p) MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = gmma_desc(sX + kk * 2 * kRowsP8, kRowsP8, 128);
      wgmma_rs<64>(y, wh[kk], dx);
      wgmma_rs<64>(y, wl[kk], dx);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(y);
    fence_regs(wh);
    fence_regs(wl);
    if (st + kStages <= tt) load_s_tile(ring, full0, st + kStages, p, a, tid);
  }

  if (c > 0) {
    // y += exp(cum_t) (C S_hi^T + C S_lo^T), both K-major over n, with S_prev
    // (hi, lo) copied into the ring (every s-tile is done)
    const int64_t PN = static_cast<int64_t>(a.P) * a.N;
    const bf16* prev = a.prev + 2 * (static_cast<int64_t>(row) * a.nc + c) * PN;
    load_tile_async<kMaxN>(ring, prev, a.N, a.P, tid, a.N);
    load_tile_async<kMaxN>(ring + kTileN, prev + PN, a.N, a.P, tid, a.N);
    mbar_arrive_cp_async(s_bar);
    mbar_wait(s_bar, 0);
    fence_proxy_async();
    float inter[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk)
      wgmma_ss_m64n64k16(inter, gmma_desc(sC + kk * 256, 128, kRowsN8),
                         gmma_desc(ring + kk * 256, 128, kRowsN8), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk)
      wgmma_ss_m64n64k16(inter, gmma_desc(sC + kk * 256, 128, kRowsN8),
                         gmma_desc(ring + kTileN + kk * 256, 128, kRowsN8), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(inter);
    const float e[2] = {expf(ct[0]), expf(ct[1])};
#pragma unroll
    for (int x = 0; x < 32; ++x)
      y[x] = __fadd_rn(y[x], __fmul_rn(e[(x >> 1) & 1], inter[x]));
  }

  // y through shared memory (the ring is free once every warp is past its
  // last product), then rows of P values stored whole
  __syncthreads();
  unsigned char* stage_y = sc_smem + kTileN;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<__nv_bfloat162*>(stage_y + (r0 + 8 * hr) * kYPitch + (8 * j + cq) * 2) =
          __floats2bfloat162_rn(y[4 * j + 2 * hr], y[4 * j + 2 * hr + 1]);
  __syncthreads();
  const int per_row = a.P / 8;   // 16-byte chunks of a row
  const int rows_t = min(kRows, Q - t0);
  for (int e = tid; e < rows_t * per_row; e += kTcThreads) {
    const int r = e / per_row, ch = e - r * per_row;
    *reinterpret_cast<uint4*>(a.y + p.y_off + (t0 + r) * p.x_row + 8 * ch) =
        *reinterpret_cast<const uint4*>(stage_y + r * kYPitch + 16 * ch);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Opt the kernel in to `bytes` of dynamic shared memory (needed above 48 KB
// of dynamic and static shared memory together).
template <typename K>
int allow_smem(K* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool bad_sizes(int64_t batch, int64_t S, int64_t H, int64_t P, int64_t G,
               int64_t N, int64_t Q) {
  return P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxChunk ||
         S % Q != 0 || G < 1 || H % G != 0 || batch * H > 0x7fffffff;
}

int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* state, int64_t batch, int64_t S,
               int64_t H, int64_t P, int64_t G, int64_t N, int64_t Q,
               cudaStream_t stream) {
  if (bad_sizes(batch, S, H, P, G, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * H == 0 || S == 0) return 0;
  const size_t smem = f32_smem_bytes(P, N, Q);
  const int err = allow_smem(ssd_scan_f32_kernel, smem);
  if (err != 0) return err;
  ssd_scan_f32_kernel<<<static_cast<unsigned>(batch * H), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), S, static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(G), static_cast<int>(N), static_cast<int>(Q));
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* state, void* cum, void* term,
                void* prev, int64_t batch, int64_t S, int64_t H, int64_t P,
                int64_t G, int64_t N, int64_t Q, cudaStream_t stream) {
  if (bad_sizes(batch, S, H, P, G, N, Q) || P % 8 != 0 || N % 8 != 0 ||
      batch * H * (S / Q) * ((Q + kRows - 1) / kRows) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * H == 0 || S == 0) return 0;
  static const int configured = [] {
    const int err = allow_smem(ssd_scan_chunk_state_kernel, kStateSmem);
    return err != 0 ? err : allow_smem(ssd_scan_chunk_scan_kernel, kScanSmem);
  }();
  if (configured != 0) return configured;
  const ScanArgs a{static_cast<const bf16*>(x),  static_cast<const float*>(dt),
                   static_cast<const float*>(A), static_cast<const bf16*>(Bm),
                   static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
                   static_cast<float*>(state),   static_cast<float*>(cum),
                   static_cast<float*>(term),    static_cast<bf16*>(prev),
                   S, static_cast<int>(batch), static_cast<int>(H),
                   static_cast<int>(P), static_cast<int>(G), static_cast<int>(N),
                   static_cast<int>(Q), static_cast<int>(S / Q)};
  const unsigned rows = static_cast<unsigned>(batch * H);
  const unsigned row_chunks = rows * static_cast<unsigned>(a.nc);
  ssd_scan_chunk_state_kernel<<<row_chunks, kTcThreads, kStateSmem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned pn_blocks = static_cast<unsigned>((P * N + 4 * kTcThreads - 1) /
                                                   (4 * kTcThreads));
  ssd_scan_state_pass_kernel<<<dim3(rows, pn_blocks), kTcThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned t_tiles = static_cast<unsigned>((Q + kRows - 1) / kRows);
  ssd_scan_chunk_scan_kernel<<<row_chunks * t_tiles, kTcThreads, kScanSmem,
                               stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, B, C, y float32; dt, A, state float32. One launch.
int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, int64_t batch,
                 int64_t S, int64_t H, int64_t P, int64_t G, int64_t N,
                 int64_t chunk, void* stream) {
  return launch_f32(x, dt, A, Bm, Cm, y, state, batch, S, H, P, G, N, chunk,
                    static_cast<cudaStream_t>(stream));
}

// x, B, C, y bfloat16 (P and N multiples of 8, rows 16-byte aligned); dt, A,
// state float32. Scratch from the wrapper: cum (batch * H, S) float32, term
// (batch * H, S / chunk, P, N) float32, prev (batch * H, S / chunk, 2, P, N)
// bfloat16. Three launches, in stream order.
int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                  const void* Cm, void* y, void* state, void* cum, void* term,
                  void* prev, int64_t batch, int64_t S, int64_t H, int64_t P,
                  int64_t G, int64_t N, int64_t chunk, void* stream) {
  return launch_bf16(x, dt, A, Bm, Cm, y, state, cum, term, prev, batch, S, H,
                     P, G, N, chunk, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
