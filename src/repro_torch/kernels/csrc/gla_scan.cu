// Chunked gated linear recurrence for Hopper (sm_90a): the SSD / mLSTM
// primitive.  bf16 runs on the tensor cores (mma.sync, and wgmma at heads
// wider than 128), f32 on the CUDA cores.
//
// Replaces src/repro/kernels/gla_scan.py::_gla_kernel (the Pallas TPU
// kernel behind repro.kernels.gla_scan.gla_scan_fwd).  Per head bh, with a
// zero initial state:
//
//     S_t = e^{a_t} S_{t-1} + k_t^T v_t       (state [dk, dv], f32)
//     n_t = e^{a_t} n_{t-1} + k_t             (normalizer [dk], f32)
//     y_t = q_t S_t  [ / max(|q_t n_t|, 1) ]  (y in v's dtype)
//
// evaluated chunk by chunk as the TPU kernel does: with ca the inclusive
// cumsum of a inside a chunk of W steps and tot = ca[W-1],
//
//     y_i   = sum_{j<=i} (q_i . k_j) e^{ca_i - ca_j} v_j + e^{ca_i} q_i S_in
//     den_i = sum_{j<=i} (q_i . k_j) e^{ca_i - ca_j}     + e^{ca_i} q_i n_in
//     S_out = e^{tot} S_in + sum_j e^{tot - ca_j} k_j^T v_j
//     n_out = e^{tot} n_in + sum_j e^{tot - ca_j} k_j
//
// Every decay is an exponential of a difference (ca_i - ca_j <= 0,
// tot - ca_j <= 0), never a product e^{ca_i} e^{-ca_j}, which overflows
// once the decays are large.  A ragged last chunk (T not a multiple of W)
// is padded with zero q, k, v and a, as repro.models.lm.gla.chunked_gla
// pads: padded steps leave the state untouched and their outputs are not
// written.
//
// Bound on this card.  At fleet-gla's shape (1,024 heads of T = 512,
// dk = dv = 64, W = 128, bf16) the kernel must move 288 MB (q, k, v, y
// once each, a, S and n): 0.086 ms at 3.35 TB/s.  The chunked work
// (_gla_flops of the JAX layer stack) is 25.8 GFLOP: 0.385 ms on the f32
// CUDA cores at 67 TFLOP/s even at peak, 0.026 ms on the bf16 tensor
// cores.  So bytes bound it, but only once the products leave the CUDA
// cores.
//
// Dispatch (dispatch): bf16 with dk and dv multiples of 16 and 16-byte
// aligned q, k, v takes the tensor cores: up to 128 wide (dk <= 128, dv <=
// 128) gla_fwd_bf16<DK, DV>, with DK, DV the widths rounded up to 64 or 128
// (zero-padded in shared memory), which takes every Mamba2 config of the
// port (head_dim 64, d_state 64 or 128); wider (dk up to 512, xLSTM's
// mLSTM heads of 256 and 512) gla_fwd_wide_bf16<64>.  f32, and bf16
// widths that are not multiples of 16, go to gla_fwd<T> on the CUDA
// cores.  The choice is by dtype, shape and alignment alone; no kernel
// falls back to another.
//
// gla_fwd_bf16, the tensor-core kernel.  One block of 4 warps per head
// holds all of dv, so q and k are read once per head (not once per dv
// slice), and walks the head's chunks in order with S (f32, [dk][dv]) and
// n in shared memory.  Within a chunk it takes 64-row query sub-tiles,
// warp w owning rows 16 w .. 16 w + 15, and for each the 64-row key tiles
// at or before it: steps (chunk, query sub-tile, key tile).
//   - Copies (was: scalar 2-byte loads with an integer divide each, between
//     two barriers): cp.async.cg 16-byte copies into bf16 shared memory,
//     rows padded by 16 B (stride d + 8) so every ldmatrix is free of bank
//     conflicts; rows past W or T are zero-filled through the src-size
//     operand.  Two stage buffers: the next step's Q (at a sub-tile's first
//     key tile), K and V tiles, and the next chunk's a (4-byte cp.async),
//     are in flight while this step computes.
//   - Cumsum (was: one warp, seven waiting): every thread sums its run of
//     the chunk's a, then a shuffle scan within each warp and the four warp
//     totals across them.  Rows past W hold a = 0, so ca = tot there.
//   - Products (was: f32 FMAs from shared memory on the CUDA cores):
//       Q K^T  mma.sync m16n8k16 bf16, f32 accumulators; Q's A fragments
//              stay in registers for the sub-tile, K's B fragments by
//              ldmatrix.
//       Q S_in mma.sync m16n8k8 TF32: q in bf16 is exact in TF32, S_in is
//              rounded to nearest (cvt.rna's rounding, done in two integer
//              operations, which was faster on the card than the cvt);
//              S is stored as interleaved row pairs
//              (float2, stride dv + 4) so each B fragment is one conflict-
//              free 8-byte load.  Scaled per row by e^{ca_i} afterwards.
//              den takes q . n_in on the CUDA cores.
//       P V    mma.sync m16n8k8 TF32, P = (q_i . k_j) e^{ca_i - ca_j}
//              rounded the same way; with the k index permuted within each
//              8-key group (slot t <-> key 2 t, slot t + 4 <-> key 2 t + 1)
//              P's A fragments are the scores' C fragments and V's B
//              fragments are the halves of one ldmatrix.trans register, as
//              in flash_fwd_bf16.  The causal mask runs on the diagonal key
//              tile only; tiles after the diagonal are never visited.  On
//              the diagonal, a warp computes and zeroes the products after
//              its rows rather than skipping them: the warp-dependent
//              branches cost more on the card than the skipped products
//              save, since the warp with the last rows sets the step
//              anyway.  den sums
//              the f32 scores before rounding.
//       state  S_new = e^{tot} S_in + (K o w)^T V, w_j = e^{tot - ca_j},
//              mma.sync m16n8k8 TF32, each warp owning 16 rows of dk (32 at
//              dk 128): K o w is formed in f32 from ldmatrix.trans
//              fragments of K and rounded to TF32; V's fragments come by
//              ldmatrix.trans as for P V (its own loop: sharing P V's
//              fragments under a compile-time flag spilled at the register
//              cap and was slower).  n_new sums the f32 K o w on the CUDA
//              cores.
//   - Re-reads (was: K and V loaded again per query sub-tile and once more
//     for the state update, 5 times per chunk at W = 128, 14 at W = 256):
//     the state update rides the last query sub-tile's key loop, which
//     visits every key tile of the chunk, so K and V are not loaded for it
//     again; the key tiles of earlier sub-tiles (n_sub (n_sub + 1) / 2
//     loads per chunk, 3 at W = 128, 10 at W = 256) come from L2.  S_new
//     stays in accumulators until the chunk's last step, when every sub-tile
//     has read S_in.
//   - Shared memory (was: 84 KB of f32 per block, 2 blocks per SM): bf16
//     tiles, 74.5 KB at dk = dv = 64, W = 128 and 76.0 KB at W = 256, and
//     168 registers (the cap for 3 blocks, tc_min_blocks): 3 blocks per
//     SM.  2 blocks with 190 registers were slower on the card.
//   - Epilogue: y = acc / max(|den|, 1) (when normalizing, as a multiply
//     by the reciprocal) in bf16 for rows < W and < T; S and n in f32
//     after the last chunk.
//   What still holds it back (times in PERF.md): three of its four
//   products run in TF32, at half the bf16 rate; each warp runs products,
//   decays and products in sequence with two barriers per step; and 168
//   registers hold it to 3 blocks (12 warps) per SM.  Holding a chunk's
//   whole K and V in shared memory (each element leaving device memory
//   once) was not built: with no tile copies at all the kernel was no
//   faster on the card, and the 64 KB more it needs at W = 256 would leave
//   2 blocks per SM.
//   Precision of each product, from the CPU emulation of these rounding
//   points (tests/test_torch_gla_numerics.py) against the step recurrence
//   at the bf16 TOL of tests/test_kernel_oracle.py: with P, S_in and K o w
//   in TF32 the worst y error is 0.25 of its allowance and S's 0.05.  P in
//   bf16 (m16n8k16, half the tensor time) reaches 2.06 x the y allowance;
//   K o w in bf16 reaches 1.32 x through the state into later chunks' y;
//   S_in in bf16 0.96 x.
//
// gla_fwd_wide_bf16, the tensor-core kernel for bf16 heads wider than
// 128 (it replaced gla_fwd there, which ran xlstm-350m's prefill at 155x
// its bound).  At that prefill (16 heads, dk = dv = 512, W = 256) the
// work is 43 GFLOP of scores (recomputed per dv slice) and 40 GFLOP of the
// other products; the bound is 0.052 ms.
//   - Grid (fill the card): 16 heads cannot fill 132 SMs, so a block of
//     one warpgroup owns one (head, 64-column dv slice), 128 blocks there,
//     and walks the chunks in order with its [DKP, 64] f32 slice of S and
//     all of n in shared memory.  Every slice recomputes the scores and n,
//     which do not depend on v; slice 0 writes n.
//   - Shared memory (the state slice sets it): two stages of a Q and a K
//     piece (64 rows x 64 columns of dk, bf16, 16 KB a stage), V^T of the
//     key tile in TF32 (16 KB), two bf16 V tiles (18 KB), S as row pairs
//     [DKP / 2][68] float2 (136 KB at dk 512), n, and ca (1 KB at W = 256):
//     210,960 B at dk 512, W 256, 226,320 B at the largest chunk (4,096),
//     with 1,024 B to align the tiles, under the 232,448 a block may have:
//     one block per SM.  q and k stream through in 64-column pieces, so
//     shared memory grows with dk only through S and n.  A 32-column slice
//     would not fit two blocks per SM and doubles the scores' work.
//   - Steps (chunk, 64-row query sub-tile, key tile at or before it,
//     piece of dk), one step's copies in flight: cp.async.cg writes the Q
//     and K pieces in the 128-byte swizzle wgmma reads (chunk ch of row r
//     at ch ^ (r & 7); rows past W or n_t and columns past dk zero-filled
//     through the src-size operand), and V with a key tile's first piece.
//     cp.async, not TMA: a 3-D tensor map zero-fills only past T, not past
//     the chunk.  A proxy fence makes the copies visible to wgmma.
//   - Q K^T (512 columns deep at dk 512): wgmma m64n64k16 bf16 with f32
//     accumulators, both operands K-major from the swizzled pieces, four
//     k-steps a piece, in flight while q S_in runs.
//   - P V and the state update (K o w)^T V: wgmma m64n64k8 TF32, A from
//     registers (P from the scores' accumulators, K o w from ldmatrix.trans
//     fragments of K), B = V^T: wgmma takes TF32 operands only K-major, so
//     V is transposed once per key tile into a swizzled TF32 tile whose
//     keys are permuted as the A fragments' (slot t <-> key 2 t, slot
//     t + 4 <-> key 2 t + 1 in each group of 8, as in gla_fwd_bf16).
//   - q S_in: mma.sync m16n8k8 TF32, A from Q's bf16 fragments, B from S's
//     row pairs (S stays f32 and would need a second, TF32-split copy to
//     be a wgmma operand).
//   - Precision: each of the three f32 operands (S_in, P, K o w) is split
//     into two TF32 parts (split_tf32), two products each: on the mLSTM's
//     inputs (k scaled by up to e^8, the normalizer near its floor) one
//     TF32 rounding of all three reaches 2.6x the bf16 y allowance, and
//     leaving S_in or K o w at one rounding still misses it; split, y reads
//     0.12 of it, as the f32 emulation does (tests/test_torch_gla_numerics
//     .py).  den and n are summed in f32 on the CUDA cores.
//   - The state update rides the last sub-tile's key loop, which visits
//     every piece of every key tile: each piece's 64 rows of S are loaded
//     (all before any store), scaled by e^{tot} at the first key tile
//     (after a barrier, so every warp has read those rows of S_in) and
//     updated in place.  The cumsum runs on all threads from device memory.
//   Measured on the card (gla_variants.py; times in PERF.md): the copies
//   alone take about 0.4 of the 0.96 ms at xlstm-350m's prefill and the
//   products without the copies 0.8; q S_in and the state update are the
//   largest parts.  Tried and not kept: two warpgroups a block, each with
//   32 of the slice's columns (5 % slower: both issue the scores); a third
//   copy stage (no faster: the copies are bound by L2 bandwidth, not
//   latency); the next step's copies issued after the step's barrier, with
//   no barrier at its end (no faster); P V and the state update on
//   mma.sync (5 % slower).
//
// gla_fwd, the CUDA-core kernel (f32, and bf16 widths that are not
// multiples of 16).  The f32 TOL of the oracle (1e-4 +
// 64 ulp) is met by no bf16 or TF32 product (TF32 keeps 11 significant
// bits), so f32 stays in f32 FMAs.  A whole [dk, dv] f32 state is 1 MiB at
// 512 x 512, and one SM's shared memory is 227 KB, so one block of 256
// threads owns one (bh, 64-column slice of dv), walks the chunks in a
// loop and holds its [dk, 64] slice of S (128 KB at dk = 512) and n [dk]
// in shared memory; each slice computes n, which depends only on k and a,
// and slice 0 writes it.  q and k are streamed in 64-column pieces of dk,
// so shared memory grows with dk only through the state slice and n.  The
// cumsum runs in one warp (a sequential run per lane, then a shuffle
// scan).  Per chunk:
//   - the inter-chunk term e^{ca_i} (q_i S_in, q_i n_in) accumulates over
//     the pieces of Q's 64-row sub-tile;
//   - the scores Q K^T of each (query sub-tile, key sub-tile at or before
//     it) accumulate over the pieces of Q and K, then P = scores times
//     e^{ca_i - ca_j} goes through shared memory to the P V product; the
//     W x W matrix is never stored;
//   - the state update runs piece by piece over dk: each 64-row piece of
//     S_new = e^{tot} S_in + (K o w)^T V is accumulated in registers over
//     the chunk's key sub-tiles and stored back in place (a thread reads
//     and writes only its own elements, and every query sub-tile has read
//     S_in by then).
// Every product is an f32 FMA on the CUDA cores.  The scores are
// recomputed by each of the dv / 64 slices of a head, and q and k are read
// once per slice.  Shared memory: [DKP][64] state, Q, K and P [64][65], V
// [64][64], n [DKP] and 2 W floats, DKP = dk rounded up to 64: 83,968 B
// at dk = 64, W = 128 and 201,472 B at dk = 512, W = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // query / key sub-tile rows and dv slice width
constexpr int kThreads = 256;
constexpr int kMaxChunk = 4096;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Inclusive cumsum of the chunk's a (steps t0 .. t0 + W, zero past n_t)
// into ca[0 .. W), by the 32 lanes of one warp (lane = tid): a sequential
// run per lane, then a shuffle scan of the run totals.
__device__ __forceinline__ void warp_cumsum(const float* ab, float* ca,
                                            long long t0, int W, int n_t,
                                            int tid) {
  const int per = (W + 31) / 32;
  const int lo = tid * per;
  float run = 0.0f;
  for (int i = lo; i < min(lo + per, W); ++i) {
    run += t0 + i < n_t ? ab[t0 + i] : 0.0f;
    ca[i] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (tid >= off) incl += up;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (tid == 0) before = 0.0f;
  for (int i = lo; i < min(lo + per, W); ++i) ca[i] += before;
}

// y of a 64-row query sub-tile (chunk rows i0 + ty + 16 i, columns c0 +
// tx + 16 j of dv), divided by max(|den|, 1) when normalizing; rows past
// W or n_t and columns past dv are not written.
template <typename T>
__device__ __forceinline__ void store_y(T* yb, const float (&acc)[4][4],
                                        const float (&den)[4], int i0,
                                        long long t0, int c0, int W,
                                        int n_t, int dv, int normalize) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ri = i0 + ty + 16 * i;
    const long long t = t0 + ri;
    if (ri >= W || t >= n_t) continue;
    const float inv = normalize ? fmaxf(fabsf(den[i]), 1.0f) : 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < dv) {
        const float val = normalize ? acc[i][j] / inv : acc[i][j];
        store(yb + t * dv + c, val);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: f32, bf16 shapes the tensor-core kernel does not take, and
// dk > 128; q and k streamed in 64-column pieces of dk.
// ---------------------------------------------------------------------------

// Loads rows [row0, row0 + 64) of a [T, width] matrix (chunk-relative row
// index r0 + r must be < W and the absolute row < n_t, else zero), columns
// [col0, col0 + cols), into dst[r * ld + c] as f32.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int width, int col0, int cols,
                                          long long t_chunk, int r0, int W,
                                          int n_t) {
  for (int e = threadIdx.x; e < kTile * cols; e += kThreads) {
    const int r = e / cols, c = e - r * cols;
    const long long t = t_chunk + r0 + r;
    const bool in = r0 + r < W && t < n_t && col0 + c < width;
    dst[r * ld + c] = in ? load(src + t * width + col0 + c) : 0.0f;
  }
}

constexpr int kMaxDk = 512;

int smem_bytes(int dk, int W) {
  const int dkp = (dk + kTile - 1) / kTile * kTile;
  const int floats = dkp * kTile + 3 * kTile * (kTile + 1) + kTile * kTile +
                     dkp + 2 * W;
  return floats * static_cast<int>(sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_fwd(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ a,
        T* __restrict__ y, float* __restrict__ S_out,
        float* __restrict__ n_out, int n_t, int dk, int dv, int W,
        int n_slices, int normalize) {
  constexpr int KP = kTile + 1;
  const int n_pc = (dk + kTile - 1) / kTile;   // 64-column pieces of dk
  const int dkp = n_pc * kTile;
  extern __shared__ float smem[];
  float* Ss = smem;                     // [dkp][kTile] state slice
  float* Qs = Ss + dkp * kTile;         // [kTile][KP] piece of Q
  float* Ks = Qs + kTile * KP;          // [kTile][KP] piece of K
  float* Vs = Ks + kTile * KP;          // [kTile][kTile]
  float* Ps = Vs + kTile * kTile;       // [kTile][KP]
  float* ns = Ps + kTile * KP;          // [dkp]
  float* ca = ns + dkp;                 // [W]
  float* wf = ca + W;                   // [W] e^{tot - ca_j}

  const int bh = blockIdx.x / n_slices;
  const int slice = blockIdx.x % n_slices;
  const int c0 = slice * kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T* qb = q + static_cast<long long>(bh) * n_t * dk;
  const T* kb = k + static_cast<long long>(bh) * n_t * dk;
  const T* vb = v + static_cast<long long>(bh) * n_t * dv;
  const float* ab = a + static_cast<long long>(bh) * n_t;
  T* yb = y + static_cast<long long>(bh) * n_t * dv;

  for (int e = tid; e < dkp * kTile; e += kThreads) Ss[e] = 0.0f;
  for (int e = tid; e < dkp; e += kThreads) ns[e] = 0.0f;

  const int n_chunks = (n_t + W - 1) / W;
  const int n_sub = (W + kTile - 1) / kTile;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const long long t0 = static_cast<long long>(chunk) * W;
    __syncthreads();  // the previous chunk's state update is stored
    if (tid < 32) warp_cumsum(ab, ca, t0, W, n_t, tid);
    __syncthreads();
    const float tot = ca[W - 1];

    // ---- outputs, one 64-row query sub-tile at a time -------------------
    for (int qs = 0; qs < n_sub; ++qs) {
      const int i0 = qs * kTile;
      float acc[4][4], den[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        den[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      // inter-chunk term: q_i S_in and q_i n_in over the pieces of dk
      for (int pc = 0; pc < n_pc; ++pc) {
        __syncthreads();  // Qs of the previous piece consumed
        load_tile(Qs, KP, qb, dk, pc * kTile, kTile, t0, i0, W, n_t);
        __syncthreads();
        const float* Sp = Ss + pc * kTile * kTile;
        const float* np = ns + pc * kTile;
#pragma unroll 4
        for (int d = 0; d < kTile; ++d) {
          float qv[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * KP + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[j] = Sp[d * kTile + tx + 16 * j];
          const float nv = np[d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            den[i] = fmaf(qv[i], nv, den[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(qv[i], sv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = i0 + ty + 16 * i;
        const float g = ri < W ? expf(ca[ri]) : 0.0f;
        den[i] *= g;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= g;
      }
      // intra-chunk term over key sub-tiles at or before this one
      for (int ks = 0; ks <= qs; ++ks) {
        const int j0 = ks * kTile;
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
        for (int pc = 0; pc < n_pc; ++pc) {
          __syncthreads();  // Qs, Ks (and Vs, Ps) of the last step consumed
          // with one piece, Qs still holds it from the inter-chunk term
          if (n_pc > 1)
            load_tile(Qs, KP, qb, dk, pc * kTile, kTile, t0, i0, W, n_t);
          load_tile(Ks, KP, kb, dk, pc * kTile, kTile, t0, j0, W, n_t);
          if (pc == 0) load_tile(Vs, kTile, vb, dv, c0, kTile, t0, j0, W, n_t);
          __syncthreads();
#pragma unroll 4
          for (int d = 0; d < kTile; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * KP + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = i0 + ty + 16 * i;
          float rs = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cj = j0 + tx + 16 * j;
            const float s = (cj <= ri && ri < W)
                ? sc[i][j] * expf(ca[ri] - ca[cj]) : 0.0f;
            Ps[(ty + 16 * i) * KP + tx + 16 * j] = s;
            rs += s;
          }
          if (normalize) den[i] += half_warp_sum(rs);
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kTile; ++kk) {
          float pv[4], vv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * KP + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kTile + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
      }
      store_y(yb, acc, den, i0, t0, c0, W, n_t, dv, normalize);
    }

    // ---- state update, one 64-row piece of dk at a time -------------------
    for (int i = tid; i < W; i += kThreads) wf[i] = expf(tot - ca[i]);
    const float gt = expf(tot);
    for (int pc = 0; pc < n_pc; ++pc) {
      float* Sp = Ss + pc * kTile * kTile;
      float snew[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          snew[ii][j] = gt * Sp[(ty + 16 * ii) * kTile + tx + 16 * j];
      float nnew = tid < kTile ? gt * ns[pc * kTile + tid] : 0.0f;
      for (int ks = 0; ks < n_sub; ++ks) {
        const int j0 = ks * kTile;
        __syncthreads();  // Ks, Vs (and wf, on the first pass) ready to reuse
        load_tile(Ks, KP, kb, dk, pc * kTile, kTile, t0, j0, W, n_t);
        load_tile(Vs, kTile, vb, dv, c0, kTile, t0, j0, W, n_t);
        __syncthreads();
        const int rows = min(kTile, W - j0);
        for (int kk = 0; kk < rows; ++kk) {
          const float w = wf[j0 + kk];
          float vv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kTile + tx + 16 * j];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float kd = Ks[kk * KP + ty + 16 * ii] * w;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              snew[ii][j] = fmaf(kd, vv[j], snew[ii][j]);
          }
          if (tid < kTile) nnew = fmaf(Ks[kk * KP + tid], w, nnew);
        }
      }
      // a thread rewrites only the elements it read above
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Sp[(ty + 16 * ii) * kTile + tx + 16 * j] = snew[ii][j];
      if (tid < kTile) ns[pc * kTile + tid] = nnew;
    }
  }
  __syncthreads();

  float* Sb = S_out + static_cast<long long>(bh) * dk * dv;
  for (int e = tid; e < dk * kTile; e += kThreads) {
    const int d = e / kTile, c = e - d * kTile;
    if (c0 + c < dv) Sb[static_cast<long long>(d) * dv + c0 + c] = Ss[e];
  }
  if (slice == 0)
    for (int d = tid; d < dk; d += kThreads)
      n_out[static_cast<long long>(bh) * dk + d] = ns[d];
}


// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps, 16 query rows each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> TF32, round to nearest, ties away from zero: cvt.rna.tf32.f32's
// result for every finite x (a carry into the 13 dropped bits rounds the
// magnitude), in two integer operations, which was faster on the card.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The two bf16 of a register (low half: the lower index), widened
// exactly; as bits, each is already a TF32 operand.
__device__ __forceinline__ uint32_t lo_bits(uint32_t x) { return x << 16; }
__device__ __forceinline__ uint32_t hi_bits(uint32_t x) {
  return x & 0xffff0000u;
}
__device__ __forceinline__ float lo_f(uint32_t x) {
  return __uint_as_float(lo_bits(x));
}
__device__ __forceinline__ float hi_f(uint32_t x) {
  return __uint_as_float(hi_bits(x));
}

// Shared memory of gla_fwd_bf16<DK, DV>, in bytes: two stage buffers of
// Q, K [64][DK + 8] and V [64][DV + 8] bf16; S as row pairs float2
// [DK / 2][DV + 4]; n [DK]; four warp totals; then a [2][Wp] (a stage
// each) and ca [Wp] f32, with Wp the chunk rounded up to 64 rows.
template <int DK, int DV>
struct TcSmem {
  static constexpr int KSTR = DK + 8;
  static constexpr int VSTR = DV + 8;
  static constexpr int SSTR = DV + 4;
  static constexpr int Q_BYTES = kTile * KSTR * 2;
  static constexpr int STAGE = 2 * Q_BYTES + kTile * VSTR * 2;
  static constexpr int S_OFF = 2 * STAGE;
  static constexpr int N_OFF = S_OFF + DK / 2 * SSTR * 8;
  static constexpr int RED_OFF = N_OFF + DK * 4;
  static constexpr int A_OFF = RED_OFF + 4 * 4;
  static int bytes(int W) {
    return A_OFF + 3 * ((W + kTile - 1) / kTile * kTile) * 4;
  }
};

// Blocks per SM the register allocation must allow: 3 at dk = dv = 64
// (the shared memory allows 3 there); ptxas chooses at the wider shapes.
template <int DK, int DV>
__host__ __device__ constexpr int tc_min_blocks() {
  return DK == 64 && DV == 64 ? 3 : 1;
}

// Chunk rows [r0, r0 + 64) of a [n_t, ld] bf16 matrix, its first D
// columns (`cols` <= D of them valid), into shared memory at `dst` (row
// stride D + 8); rows at or past W or n_t and columns past `cols` are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int ld,
                                          int cols, long long t0, int r0,
                                          int W, int n_t, int tid) {
  constexpr int CH = D / 8;   // 16-byte chunks per row
  static_assert(kTile * CH % kTcThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kTile * CH / kTcThreads; ++i) {
    const int c = tid + i * kTcThreads;
    const int r = c / CH, ch = c - r * CH;
    const long long t = t0 + r0 + r;
    const bool in = r0 + r < W && t < n_t && ch * 8 < cols;
    cp_async16(dst + (r * (D + 8) + ch * 8) * 2, in ? src + t * ld + ch * 8
                                                    : src, in ? 16 : 0);
  }
}

// Inclusive cumsum of the chunk's a (a_at(i) for rows i in [0, Wp)) into
// ca, by every thread: a run of `per` rows each, a shuffle scan within
// each warp, and the warp totals across them.  Ends before the block's
// barrier that publishes ca.
template <class At>
__device__ __forceinline__ void chunk_cumsum(At a_at, float* ca, float* red,
                                             int Wp, int tid) {
  const int per = (Wp + kTcThreads - 1) / kTcThreads;
  const int lo = tid * per, hi = min(lo + per, Wp);
  const int lane = tid & 31, warp = tid >> 5;
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) run += a_at(i);
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float before = incl - run;
  for (int w = 0; w < warp; ++w) before += red[w];
  for (int i = lo; i < hi; ++i) {
    before += a_at(i);
    ca[i] = before;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<DK, DV>())
gla_fwd_bf16(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ a,
             __nv_bfloat16* __restrict__ y, float* __restrict__ S_out,
             float* __restrict__ n_out, int n_t, int dk, int dv, int W,
             int normalize) {
  using L = TcSmem<DK, DV>;
  constexpr int KS = DK / 16;   // k-steps of Q K^T
  constexpr int NV = DV / 8;    // n-tiles of y and of the state
  constexpr int MT = DK / 64;   // 16-row m-tiles of the state per warp
  constexpr int KSTR = L::KSTR, VSTR = L::VSTR, SSTR = L::SSTR;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const uint32_t base = smem_addr(smem_tc);
  float2* Sp = reinterpret_cast<float2*>(smem_tc + L::S_OFF);
  float* ns = reinterpret_cast<float*>(smem_tc + L::N_OFF);
  float* red = reinterpret_cast<float*>(smem_tc + L::RED_OFF);
  const int n_sub = (W + kTile - 1) / kTile;
  const int Wp = n_sub * kTile;
  float* a_s = reinterpret_cast<float*>(smem_tc + L::A_OFF);   // [2][Wp]
  float* ca = a_s + 2 * Wp;                                  // [Wp]

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // accumulator row / column pair
  const long long head = static_cast<long long>(bh) * n_t;
  const __nv_bfloat16* qb = q + head * dk;
  const __nv_bfloat16* kb = k + head * dk;
  const __nv_bfloat16* vb = v + head * dv;
  const float* ab = a + head;
  __nv_bfloat16* yb = y + head * dv;

  for (int e = tid; e < DK / 2 * SSTR; e += kTcThreads)
    Sp[e] = make_float2(0.0f, 0.0f);
  for (int e = tid; e < DK; e += kTcThreads) ns[e] = 0.0f;

  // The copies of step (c, qs, ks) into stage buffer b: K and V rows of
  // key tile ks of chunk c, Q rows of sub-tile qs at its first key tile,
  // and the chunk's a at its first step.
  auto issue = [&](int ic, int iq, int ik, int ib) {
    const long long t0 = static_cast<long long>(ic) * W;
    const uint32_t st = base + ib * L::STAGE;
    if (ik == 0)
      load_rows<DK>(st, qb, dk, dk, t0, iq * kTile, W, n_t, tid);
    load_rows<DK>(st + L::Q_BYTES, kb, dk, dk, t0, ik * kTile, W, n_t, tid);
    load_rows<DV>(st + 2 * L::Q_BYTES, vb, dv, dv, t0, ik * kTile, W, n_t,
                  tid);
    if (iq == 0 && ik == 0) {
      const uint32_t as = smem_addr(a_s + ib * Wp);
      for (int r = tid; r < Wp; r += kTcThreads) {
        const bool in = r < W && t0 + r < n_t;
        cp_async4(as + r * 4, in ? ab + t0 + r : ab, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  const int n_chunks = (n_t + W - 1) / W;
  uint32_t qf[KS][4];        // Q's A fragments, for the sub-tile
  float acc[NV][4];          // y rows r_lo, r_lo + 8, for the sub-tile
  float den[2];              // this lane's share of den for those rows
  float ca_r[2];             // ca of those rows
  float snew[MT][NV][4];     // sum_j (K o w)^T V, for the chunk
  float nsum[MT][2];         // this lane's share of sum_j (K o w)
  float tot = 0.0f;

  issue(0, 0, 0, 0);
  int c = 0, qs = 0, ks = 0, b = 0;
  for (;;) {
    int nc = c, nq = qs, nk = ks + 1;
    if (nk > nq) {
      nk = 0;
      if (++nq == n_sub) {
        nq = 0;
        ++nc;
      }
    }
    const bool more = nc < n_chunks;
    if (more) {
      issue(nc, nq, nk, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t q_s = base + b * L::STAGE;
    const uint32_t k_s = q_s + L::Q_BYTES;
    const uint32_t v_s = k_s + L::Q_BYTES;
    const bool last = qs == n_sub - 1;   // the state update rides this
    const bool diag = ks == qs;
    const int r_lo = qs * kTile + 16 * warp + g;   // chunk rows r_lo, +8

    if (qs == 0 && ks == 0) {
      const float* as = a_s + b * Wp;
      chunk_cumsum([as](int i) { return as[i]; }, ca, red, Wp, tid);
      __syncthreads();
      tot = ca[W - 1];
    }

    if (ks == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], q_s + ((16 * warp + (lane & 15)) * KSTR +
                                   16 * kk + (lane >> 4) * 8) * 2);
      ca_r[0] = ca[r_lo];
      ca_r[1] = ca[r_lo + 8];
      const float e0 = __expf(ca_r[0]), e1 = __expf(ca_r[1]);
      // Inter-chunk term, TF32: A from Q's bf16 fragments (k permuted
      // within each 8-column group), B from S's row pairs.
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
      for (int k8 = 0; k8 < DK / 8; ++k8) {
        const uint32_t rg = qf[k8 >> 1][(k8 & 1) * 2];       // row g
        const uint32_t rg8 = qf[k8 >> 1][(k8 & 1) * 2 + 1];  // row g + 8
        const uint32_t af[4] = {lo_bits(rg), lo_bits(rg8), hi_bits(rg),
                                hi_bits(rg8)};
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float2 sv = Sp[(4 * k8 + tq) * SSTR + 8 * n + g];
          mma_tf32(acc[n], af, to_tf32(sv.x), to_tf32(sv.y));
        }
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
      den[0] = den[1] = 0.0f;
      if (normalize) {
        float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const float2 n0 =
              *reinterpret_cast<const float2*>(ns + 16 * kk + 2 * tq);
          const float2 n1 =
              *reinterpret_cast<const float2*>(ns + 16 * kk + 8 + 2 * tq);
          d0 += lo_f(qf[kk][0]) * n0.x + hi_f(qf[kk][0]) * n0.y +
                lo_f(qf[kk][2]) * n1.x + hi_f(qf[kk][2]) * n1.y;
          d1 += lo_f(qf[kk][1]) * n0.x + hi_f(qf[kk][1]) * n0.y +
                lo_f(qf[kk][3]) * n1.x + hi_f(qf[kk][3]) * n1.y;
        }
        den[0] = e0 * d0;
        den[1] = e1 * d1;
      }
      if (last) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          nsum[m][0] = nsum[m][1] = 0.0f;
#pragma unroll
          for (int n = 0; n < NV; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) snew[m][n][e] = 0.0f;
        }
      }
    }

    // Scores of the warp's 16 rows against the tile's 64 keys.  The
    // step's loops are kept free of branches (see the note at the top).
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < kTile / 8; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_s + ((8 * j + (lane & 7) + ((lane >> 4) << 3)) *
                               KSTR + 16 * kk + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(s[j], qf[kk], bk[0], bk[1]);
        mma_bf16(s[j + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // P = scores * e^{ca_i - ca_j}, zero after the row on the diagonal.
    const int j0 = ks * kTile;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float2 cj =
          *reinterpret_cast<const float2*>(ca + j0 + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 16 * warp + g + 8 * (e >> 1);
        const int jl = 8 * j + 2 * tq + (e & 1);
        const float p = diag && jl > il ? 0.0f :
            s[j][e] * __expf(ca_r[e >> 1] - ((e & 1) ? cj.y : cj.x));
        s[j][e] = p;
        den[e >> 1] += p;
      }
    }

    // acc += P V, 16 keys at a time, TF32 with the permuted k index.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pa[h][0] = to_tf32(s[2 * kk + h][0]);
        pa[h][1] = to_tf32(s[2 * kk + h][2]);
        pa[h][2] = to_tf32(s[2 * kk + h][1]);
        pa[h][3] = to_tf32(s[2 * kk + h][3]);
      }
#pragma unroll
      for (int n = 0; n < NV; n += 2) {
        uint32_t bv[4];   // keys 16 kk + {0..7, 8..15} x dv 8 n + {0..15}
        ldmatrix_x4_trans(bv, v_s + ((16 * kk + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * VSTR +
                                     8 * n + (lane >> 4) * 8) * 2);
        mma_tf32(acc[n], pa[0], lo_bits(bv[0]), hi_bits(bv[0]));
        mma_tf32(acc[n + 1], pa[0], lo_bits(bv[2]), hi_bits(bv[2]));
        mma_tf32(acc[n], pa[1], lo_bits(bv[1]), hi_bits(bv[1]));
        mma_tf32(acc[n + 1], pa[1], lo_bits(bv[3]), hi_bits(bv[3]));
      }
    }

    // On the last sub-tile: snew += (K o w)^T V over this key tile, TF32
    // with the permuted k index; V's fragments as for P V.
    if (last) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const float2 c0 =
            *reinterpret_cast<const float2*>(ca + j0 + 16 * kk + 2 * tq);
        const float2 c1 =
            *reinterpret_cast<const float2*>(ca + j0 + 16 * kk + 8 + 2 * tq);
        const float w0 = __expf(tot - c0.x), w1 = __expf(tot - c0.y);
        const float w2 = __expf(tot - c1.x), w3 = __expf(tot - c1.y);
        uint32_t ka[MT][2][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // kr[0]: keys 2t, 2t+1 of the group at dk row r0 + g; kr[1]: row
          // r0 + g + 8; kr[2], kr[3]: keys 8 + 2t, 9 + 2t.
          uint32_t kr[4];
          ldmatrix_x4_trans(kr, k_s + ((16 * kk + (lane & 7) +
                                        ((lane >> 4) << 3)) * KSTR +
                                       64 * m + 16 * warp +
                                       ((lane >> 3) & 1) * 8) * 2);
          const float x00 = lo_f(kr[0]) * w0, x01 = hi_f(kr[0]) * w1;
          const float x10 = lo_f(kr[1]) * w0, x11 = hi_f(kr[1]) * w1;
          const float x20 = lo_f(kr[2]) * w2, x21 = hi_f(kr[2]) * w3;
          const float x30 = lo_f(kr[3]) * w2, x31 = hi_f(kr[3]) * w3;
          ka[m][0][0] = to_tf32(x00);
          ka[m][0][1] = to_tf32(x10);
          ka[m][0][2] = to_tf32(x01);
          ka[m][0][3] = to_tf32(x11);
          ka[m][1][0] = to_tf32(x20);
          ka[m][1][1] = to_tf32(x30);
          ka[m][1][2] = to_tf32(x21);
          ka[m][1][3] = to_tf32(x31);
          nsum[m][0] += (x00 + x01) + (x20 + x21);
          nsum[m][1] += (x10 + x11) + (x30 + x31);
        }
#pragma unroll
        for (int n = 0; n < NV; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_s + ((16 * kk + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * VSTR +
                                       8 * n + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_tf32(snew[m][n], ka[m][0], lo_bits(bv[0]), hi_bits(bv[0]));
            mma_tf32(snew[m][n + 1], ka[m][0], lo_bits(bv[2]),
                     hi_bits(bv[2]));
            mma_tf32(snew[m][n], ka[m][1], lo_bits(bv[1]), hi_bits(bv[1]));
            mma_tf32(snew[m][n + 1], ka[m][1], lo_bits(bv[3]),
                     hi_bits(bv[3]));
          }
        }
      }
    }

    if (diag) {   // the sub-tile's last key tile: y
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float d = den[r] + __shfl_xor_sync(0xffffffffu, den[r], 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        inv[r] = normalize ? 1.0f / fmaxf(fabsf(d), 1.0f) : 1.0f;
      }
      const long long t0 = static_cast<long long>(c) * W;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r_lo + 8 * r;
        const long long t = t0 + row;
        if (row >= W || t >= n_t) continue;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int col = 8 * n + 2 * tq;
          if (col < dv)
            *reinterpret_cast<__nv_bfloat162*>(yb + t * dv + col) =
                __floats2bfloat162_rn(acc[n][2 * r] * inv[r],
                                      acc[n][2 * r + 1] * inv[r]);
        }
      }
    }

    if (last && diag) {   // the chunk's last step: S and n for the next
      __syncthreads();    // every warp has read S_in and n_in
      const float gt = __expf(tot);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r0 = 64 * m + 16 * warp + g;
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 8 * (e >> 1);
            float* sp = reinterpret_cast<float*>(
                Sp + (row >> 1) * SSTR + 8 * n + 2 * tq + (e & 1)) +
                (row & 1);
            *sp = gt * *sp + snew[m][n][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sum = nsum[m][r] + __shfl_xor_sync(0xffffffffu, nsum[m][r], 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          if (tq == 0) ns[r0 + 8 * r] = gt * ns[r0 + 8 * r] + sum;
        }
      }
    }
    __syncthreads();   // this buffer is refilled by the next copy
    if (!more) break;
    c = nc;
    qs = nq;
    ks = nk;
    b ^= 1;
  }

  float* Sb = S_out + static_cast<long long>(bh) * dk * dv;
  for (int e = tid; e < dk * dv; e += kTcThreads) {
    const int r = e / dv, col = e - r * dv;
    const float2 p = Sp[(r >> 1) * SSTR + col];
    Sb[e] = (r & 1) ? p.y : p.x;
  }
  for (int r = tid; r < dk; r += kTcThreads)
    n_out[static_cast<long long>(bh) * dk + r] = ns[r];
}

// ---------------------------------------------------------------------------
// bf16 heads wider than 128: tensor cores, dv split across blocks.
// ---------------------------------------------------------------------------

constexpr int kWideDvs = 64;                 // dv columns per wide block
constexpr int kPiece = kTile * kTile * 2;    // one [64][64] bf16 piece

// Byte offset of 16-byte chunk ch (0..7) of row r in a 128-byte-row tile
// stored with the 128-byte swizzle that wgmma's SWIZZLE_128B reads: chunk
// ch of row r sits at chunk ch ^ (r & 7).  Tiles start 1024-byte aligned.
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return static_cast<uint32_t>(r * 128 + ((ch ^ (r & 7)) << 4));
}

// wgmma descriptor of a K-major operand in a swizzled tile: 128-byte rows,
// 8-row groups 1024 bytes apart, 128-byte swizzle.  A k-step (16 bf16 or 8
// TF32 columns) advances the address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async and st.shared write shared memory through the generic proxy;
// wgmma reads it through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving an in-flight accumulator.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The warpgroup's 64 x 64 f32 accumulator d: d[4 j + e] is the m16n8 C
// fragment e of 8-column tile j of the warp's 16 rows.
//
// d += A (64 x 16) B^T (16 x 64), A and B K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 8) B^T (8 x 64), A TF32 from registers (the warp's m16n8k8
// A fragment of its 16 rows), B K-major TF32 in shared memory.
__device__ __forceinline__ void wgmma_64x64x8_tf32(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// x = hi + lo, both TF32 operands: hi is x rounded to TF32, lo the rest
// (x - hi is exact in f32), which the tensor core truncates to TF32 (it
// ignores a TF32 operand's 13 low bits).  Against an operand exact in
// TF32 (bf16 q or v), hi b + lo b misses x b by at most about 2^-21 |x b|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The m16n8k8 A fragment of an 8-key group, keys permuted (slot t <-> key
// 2 t, slot t + 4 <-> key 2 t + 1), from f32 values at (row g, key 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), split into two TF32 parts.
__device__ __forceinline__ void split_frag(float g0, float g1, float g8_0,
                                           float g8_1, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(g0, hi[0], lo[0]);
  split_tf32(g8_0, hi[1], lo[1]);
  split_tf32(g1, hi[2], lo[2]);
  split_tf32(g8_1, hi[3], lo[3]);
}

// Shared memory of gla_fwd_wide_bf16<64>, in bytes from a 1024-byte
// aligned base (1,024 more are allocated to align it): two stages of a Q
// and a K piece (swizzled [64][64] bf16, 16 KB a stage); V^T of the key
// tile as TF32, swizzled, keys permuted as the A fragments' (two [64][32]
// halves of 8 KB); two V tiles [64][72] bf16; S as row pairs float2
// [DKP / 2][68]; n [DKP]; four warp totals; ca [Wp] f32.  DKP is dk and
// Wp the chunk, each rounded up to 64.
struct WideSmem {
  static constexpr int STAGE = 2 * kPiece;
  static constexpr int VT_OFF = 2 * STAGE;
  static constexpr int VSTR = kWideDvs + 8;
  static constexpr int SSTR = kWideDvs + 4;
  static constexpr int V_OFF = VT_OFF + kWideDvs * kTile * 4;
  static constexpr int V_BYTES = kTile * VSTR * 2;
  static constexpr int S_OFF = V_OFF + 2 * V_BYTES;
  __host__ __device__ static int n_off(int dkp) {
    return S_OFF + dkp / 2 * SSTR * 8;
  }
  __host__ __device__ static int red_off(int dkp) {
    return n_off(dkp) + dkp * 4;
  }
  __host__ __device__ static int ca_off(int dkp) { return red_off(dkp) + 16; }
  static int bytes(int dkp, int Wp) { return 1024 + ca_off(dkp) + 4 * Wp; }
};

// Chunk rows [r0, r0 + 64) of a [n_t, ld] bf16 matrix, columns [col0,
// col0 + 64), into the swizzled piece at `dst`; rows at or past W or n_t
// and columns at or past ld are zero-filled.
__device__ __forceinline__ void load_piece(uint32_t dst,
                                           const __nv_bfloat16* src, int ld,
                                           int col0, long long t0, int r0,
                                           int W, int n_t, int tid) {
#pragma unroll
  for (int i = 0; i < kTile * 8 / kTcThreads; ++i) {
    const int c = tid + i * kTcThreads;
    const int r = c >> 3, ch = c & 7;
    const long long t = t0 + r0 + r;
    const int col = col0 + ch * 8;
    const bool in = r0 + r < W && t < n_t && col < ld;
    cp_async16(dst + swz(r, ch), in ? src + t * ld + col : src, in ? 16 : 0);
  }
}

// V^T of a key tile (V: [64 keys][72] bf16 at `v_src`) into the TF32
// tile at `vt`: row c (dv column), slot s of 64, slot 8 G + t holding key
// 8 G + 2 t (t < 4) or 8 G + 2 (t - 4) + 1; slots 32 a .. 32 a + 31 in
// half a (8 KB), each half a K-major [64][32] tile with the 128-byte
// swizzle.  Ends before the proxy fence and barrier that publish it.
__device__ __forceinline__ void transpose_v(unsigned char* vt,
                                            const __nv_bfloat16* v_src,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < kWideDvs * 8 / kTcThreads; ++i) {
    const int task = tid + i * kTcThreads;
    const int c = task & (kWideDvs - 1), grp = task / kWideDvs;
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = __bfloat162float(v_src[(8 * grp + j) * (kWideDvs + 8) + c]);
    unsigned char* half = vt + (grp >> 2) * (kWideDvs * 128);
    const int ch = 2 * (grp & 3);
    *reinterpret_cast<float4*>(half + swz(c, ch)) =
        make_float4(x[0], x[2], x[4], x[6]);
    *reinterpret_cast<float4*>(half + swz(c, ch + 1)) =
        make_float4(x[1], x[3], x[5], x[7]);
  }
}

// wgmma descriptor of k-step j (slots 8 j .. 8 j + 7) of the V^T tile.
__device__ __forceinline__ uint64_t vt_desc(uint32_t vt, int j) {
  return sw128_desc(vt + (j >> 2) * (kWideDvs * 128) + (j & 3) * 32);
}

// Templated on its slice width (only kWideDvs) so that its symbol names
// it, as the other kernels' symbols name their widths.
template <int DVS>
__global__ void __launch_bounds__(kTcThreads, 1)
gla_fwd_wide_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ a, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ S_out, float* __restrict__ n_out,
                  int n_t, int dk, int dv, int W, int n_slices,
                  int normalize) {
  static_assert(DVS == kWideDvs, "the wgmma tiles are 64 columns wide");
  using L = WideSmem;
  constexpr int NV = DVS / 8;   // n-tiles of y and of the state slice
  constexpr int SSTR = L::SSTR;
  extern __shared__ __align__(1024) unsigned char smem_wide[];
  const uint32_t raw = smem_addr(smem_wide);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* sm = smem_wide + pad;
  const uint32_t base = raw + pad;
  const uint32_t vt_s = base + L::VT_OFF;
  const int n_pc = (dk + kTile - 1) / kTile;   // 64-column pieces of dk
  const int dkp = n_pc * kTile;
  const int n_sub = (W + kTile - 1) / kTile;
  const int Wp = n_sub * kTile;
  float2* Sp = reinterpret_cast<float2*>(sm + L::S_OFF);
  float* ns = reinterpret_cast<float*>(sm + L::n_off(dkp));
  float* red = reinterpret_cast<float*>(sm + L::red_off(dkp));
  float* ca = reinterpret_cast<float*>(sm + L::ca_off(dkp));   // [Wp]

  const int bh = blockIdx.x / n_slices;
  const int c0 = (blockIdx.x % n_slices) * DVS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // accumulator row / column pair
  const long long head = static_cast<long long>(bh) * n_t;
  const __nv_bfloat16* qb = q + head * dk;
  const __nv_bfloat16* kb = k + head * dk;
  const __nv_bfloat16* vb = v + head * dv;
  const float* ab = a + head;
  __nv_bfloat16* yb = y + head * dv;

  for (int e = tid; e < dkp / 2 * SSTR; e += kTcThreads)
    Sp[e] = make_float2(0.0f, 0.0f);
  for (int e = tid; e < dkp; e += kTcThreads) ns[e] = 0.0f;

  // A step: (chunk, 64-row query sub-tile, key tile at or before it,
  // 64-column piece of dk), and the step after it.
  struct Step {
    int c, qs, ks, pc;
  };
  auto after = [&](Step t) {
    if (++t.pc == n_pc) {
      t.pc = 0;
      if (++t.ks > t.qs) {
        t.ks = 0;
        if (++t.qs == n_sub) {
          t.qs = 0;
          ++t.c;
        }
      }
    }
    return t;
  };
  // The copies of step t into stage ib: its Q piece (sub-tile qs) and K
  // piece (key tile ks), and at a key tile's first piece its V tile (this
  // block's dv columns) into V buffer iv.
  auto issue = [&](Step t, int ib, int iv) {
    const long long t0 = static_cast<long long>(t.c) * W;
    const uint32_t st = base + ib * L::STAGE;
    load_piece(st, qb, dk, t.pc * kTile, t0, t.qs * kTile, W, n_t, tid);
    load_piece(st + kPiece, kb, dk, t.pc * kTile, t0, t.ks * kTile, W, n_t,
               tid);
    if (t.pc == 0)
      load_rows<kWideDvs>(base + L::V_OFF + iv * L::V_BYTES, vb + c0, dv,
                          dv - c0, t0, t.ks * kTile, W, n_t, tid);
    cp_async_commit();
  };

  const int n_chunks = (n_t + W - 1) / W;
  float acc[32];   // y of the sub-tile's 64 rows (wgmma accumulator layout)
  float sc[32];    // the sub-tile's scores against the key tile
  float den[2];    // this lane's share of den for rows r_lo, r_lo + 8
  float ca_r[2];   // ca of those rows
  float tot = 0.0f;   // ca[W - 1] of the chunk
  float gt = 1.0f;    // e^{tot}

  Step cur = {0, 0, 0, 0};
  issue(cur, 0, 0);
  int b = 0, vbuf = 0;
  for (;;) {
    const Step nxt = after(cur);
    const bool more = nxt.c < n_chunks;
    const int nvbuf = nxt.pc == 0 ? vbuf ^ 1 : vbuf;
    if (more) {
      issue(nxt, b ^ 1, nvbuf);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int c = cur.c, qs = cur.qs, ks = cur.ks, pc = cur.pc;
    const uint32_t q_s = base + b * L::STAGE;
    const uint32_t k_s = q_s + kPiece;
    const bool last = qs == n_sub - 1;   // the state update rides this
    const bool diag = ks == qs;
    const bool inter = ks == 0;          // q S_in rides the first key tile
    const bool end = pc == n_pc - 1;     // the scores are whole
    const int r_lo = qs * kTile + 16 * warp + g;   // chunk rows r_lo, +8

    if (qs == 0 && inter && pc == 0) {
      const long long t0 = static_cast<long long>(c) * W;
      chunk_cumsum([&](int i) { return i < W && t0 + i < n_t ? ab[t0 + i]
                                                           : 0.0f; },
                   ca, red, Wp, tid);
      __syncthreads();
      tot = ca[W - 1];
      gt = __expf(tot);
    }
    if (pc == 0) {   // V^T of this key tile, for P V and the state update
      transpose_v(sm + L::VT_OFF, reinterpret_cast<const __nv_bfloat16*>(
                                      sm + L::V_OFF + vbuf * L::V_BYTES),
                  tid);
      fence_proxy_async();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    }
    if (inter && pc == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      den[0] = den[1] = 0.0f;
      ca_r[0] = ca[r_lo];
      ca_r[1] = ca[r_lo + 8];
    }

    // Scores over this piece's 64 columns of dk: four wgmma k-steps, in
    // flight while q S_in runs.
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_64x64x16(sc, sw128_desc(q_s + 32 * kk), sw128_desc(k_s + 32 * kk));
    wgmma_commit();

    if (inter) {
      // q_i S_in over this piece's rows of S, S_in split into two TF32
      // parts; A from Q's bf16 fragments (k permuted within each group of
      // 8), B from S's row pairs.  q_i n_in on the CUDA cores.
      uint32_t qf[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        ldmatrix_x4(qf[kk], q_s + swz(16 * warp + (lane & 15),
                                      2 * kk + (lane >> 4)));
#pragma unroll
      for (int k8 = 0; k8 < kTile / 8; ++k8) {
        const uint32_t rg = qf[k8 >> 1][(k8 & 1) * 2];       // row g
        const uint32_t rg8 = qf[k8 >> 1][(k8 & 1) * 2 + 1];  // row g + 8
        const uint32_t af[4] = {lo_bits(rg), lo_bits(rg8), hi_bits(rg),
                                hi_bits(rg8)};
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float2 sv = Sp[(32 * pc + 4 * k8 + tq) * SSTR + 8 * n + g];
          uint32_t h0, l0, h1, l1;
          split_tf32(sv.x, h0, l0);
          split_tf32(sv.y, h1, l1);
          float d[4] = {acc[4 * n], acc[4 * n + 1], acc[4 * n + 2],
                        acc[4 * n + 3]};
          mma_tf32(d, af, h0, h1);
          mma_tf32(d, af, l0, l1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * n + e] = d[e];
        }
      }
      if (normalize) {
        float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const float* np_ = ns + kTile * pc + 16 * kk + 2 * tq;
          const float2 n0 = *reinterpret_cast<const float2*>(np_);
          const float2 n1 = *reinterpret_cast<const float2*>(np_ + 8);
          d0 += lo_f(qf[kk][0]) * n0.x + hi_f(qf[kk][0]) * n0.y +
                lo_f(qf[kk][2]) * n1.x + hi_f(qf[kk][2]) * n1.y;
          d1 += lo_f(qf[kk][1]) * n0.x + hi_f(qf[kk][1]) * n0.y +
                lo_f(qf[kk][3]) * n1.x + hi_f(qf[kk][3]) * n1.y;
        }
        den[0] += d0;
        den[1] += d1;
      }
    }
    wgmma_wait_all();
    pin(sc);

    if (last) {
      // This piece's 64 rows of the state: S = [e^{tot}] S + (K o w)^T V
      // over this key tile, on wgmma with K o w split into two TF32 parts
      // as A (from ldmatrix.trans fragments of K) and V^T as B; n from the
      // f32 K o w.  At the first key tile every warp must have read these
      // rows of S_in and n_in first.
      if (inter) __syncthreads();
      uint32_t kh[kTile / 8][4], kl[kTile / 8][4];
      float nsum[2] = {0.0f, 0.0f};
      const int j0 = ks * kTile;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const float2 ca_a =
            *reinterpret_cast<const float2*>(ca + j0 + 16 * kk + 2 * tq);
        const float2 ca_b =
            *reinterpret_cast<const float2*>(ca + j0 + 16 * kk + 8 + 2 * tq);
        const float w0 = __expf(tot - ca_a.x), w1 = __expf(tot - ca_a.y);
        const float w2 = __expf(tot - ca_b.x), w3 = __expf(tot - ca_b.y);
        // kr[0]: keys 2t, 2t+1 of the group at dk row g; kr[1]: row g + 8;
        // kr[2], kr[3]: keys 8 + 2t, 9 + 2t.
        uint32_t kr[4];
        ldmatrix_x4_trans(kr, k_s + swz(16 * kk + (lane & 7) +
                                        ((lane >> 4) << 3),
                                        2 * warp + ((lane >> 3) & 1)));
        const float x00 = lo_f(kr[0]) * w0, x01 = hi_f(kr[0]) * w1;
        const float x10 = lo_f(kr[1]) * w0, x11 = hi_f(kr[1]) * w1;
        const float x20 = lo_f(kr[2]) * w2, x21 = hi_f(kr[2]) * w3;
        const float x30 = lo_f(kr[3]) * w2, x31 = hi_f(kr[3]) * w3;
        split_frag(x00, x01, x10, x11, kh[2 * kk], kl[2 * kk]);
        split_frag(x20, x21, x30, x31, kh[2 * kk + 1], kl[2 * kk + 1]);
        nsum[0] += (x00 + x01) + (x20 + x21);
        nsum[1] += (x10 + x11) + (x30 + x31);
      }
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.0f;
      pin(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        wgmma_64x64x8_tf32(part, kh[j], vt_desc(vt_s, j));
        wgmma_64x64x8_tf32(part, kl[j], vt_desc(vt_s, j));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(part);
      // Rows r0 and r0 + 8 sit in row pairs r0 / 2 and r0 / 2 + 4, at the
      // same half.  All 32 elements are loaded before any is stored, so
      // the loads need not wait on the stores.
      const int r0 = kTile * pc + 16 * warp + g;
      float* s0 = reinterpret_cast<float*>(Sp + (r0 >> 1) * SSTR + 2 * tq) +
                  (r0 & 1);
      float old[32];
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          old[4 * n + e] = s0[2 * (4 * (e >> 1) * SSTR + 8 * n + (e & 1))];
      const float scale = inter ? gt : 1.0f;
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s0[2 * (4 * (e >> 1) * SSTR + 8 * n + (e & 1))] =
              scale * old[4 * n + e] + part[4 * n + e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = nsum[r] + __shfl_xor_sync(0xffffffffu, nsum[r], 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        float* np_ = ns + r0 + 8 * r;
        if (tq == 0) *np_ = (inter ? gt * *np_ : *np_) + sum;
      }
    }

    if (end) {
      if (inter) {   // the inter-chunk term is whole: scale by e^{ca_i}
        const float e0 = __expf(ca_r[0]), e1 = __expf(ca_r[1]);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          acc[4 * n] *= e0;
          acc[4 * n + 1] *= e0;
          acc[4 * n + 2] *= e1;
          acc[4 * n + 3] *= e1;
        }
        den[0] *= e0;
        den[1] *= e1;
      }
      // P = scores * e^{ca_i - ca_j}, zero after the row on the diagonal,
      // split into two TF32 parts as the A fragments of acc += P V (keys
      // permuted as in V^T).
      const int j0 = ks * kTile;
      uint32_t ph[kTile / 8][4], pl[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float2 cj =
            *reinterpret_cast<const float2*>(ca + j0 + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = 16 * warp + g + 8 * (e >> 1);
          const int jl = 8 * j + 2 * tq + (e & 1);
          const float p = diag && jl > il ? 0.0f :
              sc[4 * j + e] * __expf(ca_r[e >> 1] - ((e & 1) ? cj.y : cj.x));
          sc[4 * j + e] = p;
          den[e >> 1] += p;
        }
        split_frag(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3],
                   ph[j], pl[j]);
      }
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        wgmma_64x64x8_tf32(acc, ph[j], vt_desc(vt_s, j));
        wgmma_64x64x8_tf32(acc, pl[j], vt_desc(vt_s, j));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);

      if (diag) {   // the sub-tile's last key tile: y
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float d = den[r] + __shfl_xor_sync(0xffffffffu, den[r], 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          inv[r] = normalize ? 1.0f / fmaxf(fabsf(d), 1.0f) : 1.0f;
        }
        const long long t0 = static_cast<long long>(c) * W;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r_lo + 8 * r;
          const long long t = t0 + row;
          if (row >= W || t >= n_t) continue;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const int col = c0 + 8 * n + 2 * tq;
            if (col < dv)
              *reinterpret_cast<__nv_bfloat162*>(yb + t * dv + col) =
                  __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv[r],
                                        acc[4 * n + 2 * r + 1] * inv[r]);
          }
        }
      }
    }
    __syncthreads();   // this stage, the V buffer and V^T are refilled next
    if (!more) break;
    cur = nxt;
    b ^= 1;
    vbuf = nvbuf;
  }

  float* Sb = S_out + static_cast<long long>(bh) * dk * dv;
  for (int e = tid; e < dk * DVS; e += kTcThreads) {
    const int r = e / DVS, col = e - r * DVS;
    if (c0 + col < dv) {
      const float2 p = Sp[(r >> 1) * SSTR + col];
      Sb[static_cast<long long>(r) * dv + c0 + col] = (r & 1) ? p.y : p.x;
    }
  }
  if (c0 == 0)
    for (int r = tid; r < dk; r += kTcThreads)
      n_out[static_cast<long long>(bh) * dk + r] = ns[r];
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* a,
           void* y, float* S, float* n, int bh, int n_t, int dk, int dv,
           int W, int normalize, cudaStream_t st) {
  const int bytes = smem_bytes(dk, W);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gla_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
    configured = bytes;
  }
  const int n_slices = (dv + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(bh) * n_slices;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  gla_fwd<T><<<static_cast<unsigned>(blocks), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), a, static_cast<T*>(y), S, n, n_t, dk, dv, W,
      n_slices, normalize);
  return int(cudaGetLastError());
}

template <int DK, int DV>
int launch_tc(const void* q, const void* k, const void* v, const float* a,
              void* y, float* S, float* n, int bh, int n_t, int dk, int dv,
              int W, int normalize, cudaStream_t st) {
  using L = TcSmem<DK, DV>;
  static bool configured = false;  // once, for the largest chunk taken
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gla_fwd_bf16<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes(kMaxChunk));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  gla_fwd_bf16<DK, DV><<<bh, kTcThreads, L::bytes(W), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), a,
      static_cast<__nv_bfloat16*>(y), S, n, n_t, dk, dv, W, normalize);
  return int(cudaGetLastError());
}

int launch_wide(const void* q, const void* k, const void* v, const float* a,
                void* y, float* S, float* n, int bh, int n_t, int dk, int dv,
                int W, int normalize, cudaStream_t st) {
  const int bytes = WideSmem::bytes((dk + kTile - 1) / kTile * kTile,
                                    (W + kTile - 1) / kTile * kTile);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gla_fwd_wide_bf16<kWideDvs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
    configured = bytes;
  }
  const int n_slices = (dv + kWideDvs - 1) / kWideDvs;
  const long long blocks = static_cast<long long>(bh) * n_slices;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  gla_fwd_wide_bf16<kWideDvs><<<static_cast<unsigned>(blocks), kTcThreads,
                                bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), a,
      static_cast<__nv_bfloat16*>(y), S, n, n_t, dk, dv, W, n_slices,
      normalize);
  return int(cudaGetLastError());
}

// bf16 with dk, dv multiples of 16 and 16-byte aligned q, k, v (cp.async)
// take the tensor cores: up to 128 wide at widths rounded up to 64 or 128,
// wider (dk up to 512) in dv slices of kWideDvs; everything else takes
// gla_fwd on the CUDA cores.
int dispatch(const void* q, const void* k, const void* v, const float* a,
             void* y, float* S, float* n, int is_bf16, int bh, int n_t,
             int dk, int dv, int W, int normalize, cudaStream_t st) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(y) & 3) == 0;
  const bool tc = is_bf16 && aligned && dk % 16 == 0 && dv % 16 == 0;
  if (tc && (dk > 128 || dv > 128))
    return launch_wide(q, k, v, a, y, S, n, bh, n_t, dk, dv, W, normalize,
                       st);
  if (tc) {
    if (dk <= 64 && dv <= 64)
      return launch_tc<64, 64>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W,
                               normalize, st);
    if (dk <= 64)
      return launch_tc<64, 128>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W,
                                normalize, st);
    if (dv <= 64)
      return launch_tc<128, 64>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W,
                                normalize, st);
    return launch_tc<128, 128>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W,
                               normalize, st);
  }
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W,
                                 normalize, st);
  return launch<float>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W, normalize,
                       st);
}

}  // namespace

// q, k: [bh, n_t, dk]; v: [bh, n_t, dv], all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1); a: [bh, n_t] f32 log-decays; all contiguous.  y: [bh, n_t,
// dv] in v's dtype; S: [bh, dk, dv] f32; n: [bh, dk] f32.  1 <= dk <= 512,
// 1 <= W <= 4096 (the chunk).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int gla_scan_fwd(const void* q, const void* k, const void* v,
                            const float* a, void* y, float* S, float* n,
                            int is_bf16, int bh, int n_t, int dk, int dv,
                            int W, int normalize, void* stream) {
  if (bh <= 0 || n_t <= 0 || dk <= 0 || dk > kMaxDk || dv <= 0 ||
      W <= 0 || W > kMaxChunk)
    return int(cudaErrorInvalidValue);
  return dispatch(q, k, v, a, y, S, n, is_bf16, bh, n_t, dk, dv, W,
                  normalize, static_cast<cudaStream_t>(stream));
}
