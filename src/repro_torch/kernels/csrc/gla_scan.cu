// Chunked gated linear recurrence for Hopper (sm_90a): the SSD / mLSTM
// primitive.  bf16 runs on the tensor cores (wgmma: fed by TMA and
// warp-specialised up to 128 wide, by cp.async wider), f32 on the CUDA
// cores.
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
// once each, a, S and n): 0.086 ms at 3.35 TB/s; at zamba2-7b's prefill
// (448 heads of 2,048, W = 256) 481 MB, 0.144 ms; at its training group
// (896 heads of 512, W = 256) 252 MB, 0.075 ms.  The chunked work
// (_gla_flops of the JAX layer stack) is 25.8 GFLOP at fleet-gla: 0.385 ms
// on the f32 CUDA cores at 67 TFLOP/s even at peak, 0.026 ms on the bf16
// tensor cores.  So bytes bound it, but only once the products leave the
// CUDA cores.
//
// Dispatch (dispatch): bf16 with dk and dv multiples of 16 and 16-byte
// aligned q, k, v takes the tensor cores: up to 128 wide (dk <= 128, dv <=
// 128) gla_fwd_bf16<DK, DV>, with DK, DV the widths rounded up to 64 or 128
// (TMA zero-fills the columns past them), which takes every Mamba2 config
// of the port (head_dim 64, d_state 64 or 128); wider (dk up to 512,
// xLSTM's mLSTM heads of 256 and 512) gla_fwd_wide_bf16<64>.  f32, and
// bf16 widths that are not multiples of 16, go to gla_fwd<T> on the CUDA
// cores.  The choice is by dtype, shape and alignment alone; no kernel
// falls back to another.
//
// gla_fwd_bf16<DK, DV>, the tensor-core kernel up to 128 wide: wgmma fed
// by TMA, warp-specialised.  A persistent grid, one block of 384 threads
// per SM, takes heads blockIdx.x, + gridDim.x, ... and walks each head's
// chunks in order; the next head's copies and scans run under the last
// chunk of this one.
//   - Warpgroup 2 loads (setmaxnreg lowers it to 40 registers).  One
//     thread issues every copy, in the order the consumers take them: per
//     chunk and 128-row query tile, its Q tile, then the 64-row K and V
//     tiles of the key tiles it sees.  3-D tensor maps over [BH, T, d],
//     128-byte swizzle, 64-column boxes (one at d 64, two at 128); two Q
//     stages (one at 128 x 128) and a ring of K / V stages (4 at 64 x 64, 3
//     at 64 x 128, 2 at dk 128: what fits at the largest chunk), each tile
//     with a full mbarrier (TMA completes it) and an empty one (each
//     consumer warp arrives when it has read the tile).  The copies run
//     ahead across chunk and head boundaries.  TMA zero-fills past T but
//     not past W: a tile's rows at or past W belong to the next chunk, so
//     their key weights are 0, the causal mask hides them, and their y
//     rows are not written (the next chunk writes them).  A second warp
//     scans each chunk's a (coalesced loads: a chunk's a is only 4-byte
//     aligned, which a bulk copy does not take; then a shuffle scan) into
//     ca log2(e) and the state's key weights w_j = e^{tot - ca_j}, 0 at or
//     past W or T, a buffer per chunk parity with an mbarrier each way.
//   - Warpgroups 0 and 1 compute (setmaxnreg raises them to 232), 64 query
//     rows each of the query tile, in lockstep through the K / V ring: a
//     query tile visits the key tiles up to its diagonal.  At each key tile
//     a warpgroup whose rows see it runs
//       Q K^T  wgmma m64n64k16 bf16, Q and K K-major from the swizzled
//              tiles, DK / 16 k-steps;
//       P      scores times e^{ca_i - ca_j} (ex2 of a difference of the
//              scaled ca), zero after the row on the diagonal tile; den
//              sums the f32 p.  The two warpgroups take turns at this step
//              (named barriers 3 and 4, kNarrowPingPong), so that one's
//              exponentials run under the other's products rather than
//              beside its exponentials on the same pipe;
//       P V    p split hi + lo (split_pair), two wgmma m64nDVk16 bf16
//              products with A from registers and B the V tile as TMA
//              brought it: V is MN-major (dv contiguous), read through
//              wgmma's transpose flag, never transposed or widened.
//     On the chunk's last query tile every key tile also updates the
//     state: S = e^{tot} S_in + (K o w)^T V on wgmma m64nSNk16, A = (K o w)^T
//     from ldmatrix.trans fragments of the K tile times w_j, split hi + lo,
//     B = V as for P V.  The state stays in its owners' registers across
//     the walk: warpgroup 0's at 64 x 64 (32 a thread), else split between
//     the two by dk rows (dk 128) or by dv boxes (64 x 128); n sums the f32
//     K o w on the CUDA cores.  Each chunk begins with S_in written into
//     shared memory as bf16 hi and lo tiles (MN-major, as V) and n_in in
//     f32, between two named barriers of the consumers; each query tile
//     with q (S_hi + S_lo) (wgmma m64nDVk16, A = Q, B = S; S is zero at the
//     first chunk) and key tile 0's Q K^T in one group, and q . n_in on the
//     CUDA cores under it, both scaled by e^{ca_i}.  y = acc / max(|den|,
//     1) goes out in bf16 from registers for rows < W and < T; S and n in
//     f32 after the last chunk.
//   - Every wgmma is unconditional in its code path: a key tile's flags
//     (rows see it, state, where its Q K^T is issued) are template
//     arguments (Flag), so that no accumulator passes through a branch
//     between a wgmma and its wait, and the warpgroup index is shuffled
//     from lane 0 so that branches on it are warp-uniform to the compiler.
//     With run-time flags ptxas serialized every wgmma of the kernel
//     (performance notes C7520, then C7515) and the kernel was 1.3 x
//     slower.
//   - Precision, from the CPU emulation of these rounding points
//     (tests/test_torch_gla_numerics.py) against the step recurrence at
//     the bf16 TOL of tests/test_kernel_oracle.py: P, S_in and K o w each
//     as hi + lo, both truncated to bf16 by masks and byte permutes (a
//     conversion instruction would share the exponentials' pipe), miss
//     the f32 value by less than 2^-15 of it; y reads 0.108-0.123 of its
//     allowance, as with f32 operands (one TF32 rounding, the earlier
//     mma.sync kernel's: up to 0.25), S at most 0.002.  One bf16 rounding
//     of P reaches 2.06 x the y allowance, of K o w 1.14 x, of S_in 0.80 x.
//   - Occupancy: one block per SM (384 threads: 168 registers at entry, 40
//     in the loads, 232 in the consumers, which spill nothing but at 128 x
//     128).  zamba2-7b's 448 prefill heads come to 3.4 a block (four
//     rounds, the last 0.39 full), its training group's 896 to 6.8 and
//     fleet-gla's 1,024 to 7.8.  Two blocks per SM would leave a consumer
//     112 registers, under what y, the state piece and one key tile's
//     operands take; a dv split would recompute Q K^T and re-read q and k.
//   Measured on the card (kernels/gla_variants.py; times in PERF.md): 1.7 x
//   faster than the mma.sync kernel it replaced at zamba2-7b's prefill and
//   2.1 x its bound there, 1.3 x faster and 1.8 x its bound at fleet-gla.
//   Each consumer's chain per key tile (wait, Q K^T, decays, split, P V)
//   sets the pace: with none of the products the kernel still takes 0.68
//   to 0.78 of its time.  Tried and not kept: hi and lo rounded to nearest by
//   conversions (rn_split, 3-10 % slower: they share the exponentials'
//   pipe); two K / V stages at every width (stages2, within 2 %); a key
//   tile's Q K^T issued beside the previous tile's P V, or that P V in
//   flight under the next tile's decays as flash_fwd_bf16 does (no
//   faster); the warpgroups' decays at once rather than in turns
//   (no_pingpong, up to 4 % slower); a's loads one after another in the
//   scan (no slower: it runs a chunk ahead); a block per head (per_head,
//   5-8 % slower at fleet-gla and the training group, within 1 % at the
//   prefill).
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
//     t + 4 <-> key 2 t + 1 in each group of 8).
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

#include <cuda.h>   // CUtensorMap and its enums only: no libcuda symbol
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
// bf16: tensor cores, helpers of both kernels.
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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
// d = (scale_d ? d : 0) + A (64 x 16) B^T (16 x 64), A and B K-major bf16
// in shared memory.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d = 1) {
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// bf16 heads up to 128: wgmma fed by TMA, warp-specialised.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Box (c0 column, c1 row, c2 head) of `map` into shared memory at dst,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of an MN-major operand (V, S_in: K runs down the rows,
// N along them) in 64-column boxes with the 128-byte swizzle: each box
// holds 8-row groups 1,024 bytes apart (SBO), the boxes are `box_bytes`
// apart (LBO).  A k-step of 16 rows advances the address by 2,048 bytes.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t box_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(box_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d = (scale_d ? d : 0) + A (64 x 16) B (16 x N), A K-major and B MN-major
// bf16 in shared memory.
template <int N>
__device__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da, uint64_t db,
                           int scale_d);
// d += A (64 x 16) B (16 x N), A bf16 from registers (the warp's m16n8k16
// A fragment of its 16 rows), B MN-major bf16 in shared memory.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss_t<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_t<128>(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The pair (x, y) as bf16 hi and lo parts, two to a register (x in the
// low half): hi = x truncated to bf16 (its low 16 bits cleared), lo = x -
// hi (exact in f32) truncated the same way, so hi + lo misses x by less
// than 2^-15 |x|.  Masks and byte permutes only: a conversion instruction
// would share the exponentials' pipe.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  lo = __byte_perm(__float_as_uint(x - __uint_as_float(xb & 0xffff0000u)),
                   __float_as_uint(y - __uint_as_float(yb & 0xffff0000u)),
                   0x7632);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Stages of the K / V ring and of the Q tile of gla_fwd_bf16<DK, DV>: as
// many as fit beside the rest at the largest chunk.
template <int DK, int DV>
__host__ __device__ constexpr int narrow_stages() {
  return DK == 64 ? (DV == 64 ? 4 : 3) : 2;
}
template <int DK, int DV>
__host__ __device__ constexpr int narrow_q_stages() {
  return DK == 128 && DV == 128 ? 1 : 2;
}
// Whether the consumer warpgroups take turns at their decays (named
// barriers 3 and 4), so that one's exponentials run under the other's
// products rather than beside its exponentials on the same pipe.
constexpr bool kNarrowPingPong = true;

// A compile-time flag passed to a generic lambda.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Shared memory of gla_fwd_bf16<DK, DV>, in bytes from a 1,024-byte aligned
// base (1,024 more are allocated to align it).  Tiles are rows of 128 bytes
// (64 bf16) in the 128-byte swizzle, a 64-column box after another:
// QSTAGES stages of the 128-row Q tile; STAGES stages of the 64-row K and
// V tiles; S_in as bf16 hi and lo tiles [DK rows] (MN-major, as V); n_in
// [DK] f32; the mbarriers; then per chunk parity the chunk's ca log2(e)
// [Wp] and w [Wp] f32, Wp the chunk rounded up to 64 rows.
template <int DK, int DV>
struct NarrowTiles {
  static constexpr int NBK = DK / 64;      // 64-column boxes of a q / k row
  static constexpr int NBV = DV / 64;      // of a v row and of S
  static constexpr int STAGES = narrow_stages<DK, DV>();
  static constexpr int QSTAGES = narrow_q_stages<DK, DV>();
  static constexpr int Q_BOX = 128 * 128;  // 128 rows of 128 bytes
  static constexpr int KV_BOX = 64 * 128;  // 64 rows of 128 bytes
  static constexpr int S_BOX = DK * 128;   // DK rows of 128 bytes
  static constexpr int Q_BYTES = NBK * Q_BOX;
  static constexpr int K_BYTES = NBK * KV_BOX;
  static constexpr int V_BYTES = NBV * KV_BOX;
  static constexpr int S_BYTES = NBV * S_BOX;   // one of hi and lo
  static constexpr int K_OFF = QSTAGES * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int SH_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int SL_OFF = SH_OFF + S_BYTES;
  static constexpr int N_OFF = SL_OFF + S_BYTES;
  static constexpr int BAR_OFF = N_OFF + DK * 4;
  // q_full, q_empty per Q stage; k_full, v_full, k_empty, v_empty per
  // stage; ca_full, ca_empty per chunk parity
  static constexpr int BARS = 2 * QSTAGES + 4 * STAGES + 4;
  static constexpr int CA_OFF = BAR_OFF + 8 * BARS;
  static constexpr int THREADS = 384;
  __host__ __device__ static constexpr int bytes(int Wp) {
    return 1024 + CA_OFF + 4 * Wp * 4;
  }
  static_assert(DK % 64 == 0 && DK <= 128 && DV % 64 == 0 && DV <= 128,
                "64 or 128 wide");
  static_assert(bytes(kMaxChunk) <= 232448, "shared memory of one block");
};

// gla_fwd_bf16: see the note at the top of this file.  One block per head:
// warpgroup 2 loads (one thread issues the TMA copies, one warp scans a),
// warpgroups 0 and 1 compute, 64 query rows each of a 128-row query tile.
template <int DK, int DV>
__global__ void __launch_bounds__(NarrowTiles<DK, DV>::THREADS, 1)
gla_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const float* __restrict__ a, __nv_bfloat16* __restrict__ y,
             float* __restrict__ S_out, float* __restrict__ n_out, int n_bh,
             int n_t, int dk, int dv, int W, int normalize) {
  using L = NarrowTiles<DK, DV>;
  constexpr int STAGES = L::STAGES, QSTAGES = L::QSTAGES;
  // The state's owners: a warpgroup holds a 64-row piece of dk (m_tile)
  // by SN columns of dv from col0 in registers.  At 64 x 64 warpgroup 0
  // holds all of it; otherwise the two split it, by dk rows at DK 128, by
  // dv boxes at 64 x 128.
  constexpr int SN = DK == 128 ? DV : 64;
  extern __shared__ __align__(1024) unsigned char smem_nt[];
  const uint32_t raw = smem_addr(smem_nt);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_nt + (base - raw);
  const uint32_t q_s = base;                 // [QSTAGES][NBK][128][128 B]
  const uint32_t k_s = base + L::K_OFF;      // [STAGES][NBK][64][128 B]
  const uint32_t v_s = base + L::V_OFF;      // [STAGES][NBV][64][128 B]
  const uint32_t sh_s = base + L::SH_OFF;    // [NBV][DK][128 B]
  const uint32_t sl_s = base + L::SL_OFF;
  float* n_in = reinterpret_cast<float*>(sm + L::N_OFF);
  const uint32_t q_full = base + L::BAR_OFF;            // + 8 s
  const uint32_t q_empty = q_full + 8 * QSTAGES;        // + 8 s
  const uint32_t k_full = q_empty + 8 * QSTAGES;        // + 8 s
  const uint32_t v_full = k_full + 8 * STAGES;          // + 8 s
  const uint32_t k_empty = v_full + 8 * STAGES;         // + 8 s
  const uint32_t v_empty = k_empty + 8 * STAGES;        // + 8 s
  const uint32_t ca_full = v_empty + 8 * STAGES;        // + 8 b
  const uint32_t ca_empty = ca_full + 16;               // + 8 b
  const int n_sub = (W + 63) / 64;      // 64-row key tiles of a chunk
  const int Wp = n_sub * 64;
  const int n_qt = (W + 127) / 128;     // 128-row query tiles of a chunk
  const int n_chunks = (n_t + W - 1) / W;
  float* ca_s = reinterpret_cast<float*>(sm + L::CA_OFF);   // [2][2][Wp]
  // The block's heads: blockIdx.x, then every gridDim.x-th (a persistent
  // grid, so that the next head's copies and scans run under this one's
  // last chunk).
  const int bh0 = blockIdx.x, bh_step = gridDim.x;
  const int tid = threadIdx.x;
  // Warp-uniform as far as the compiler can tell (a shuffle from lane 0),
  // so that the wgmma under conditions on it are not serialized as if on
  // a divergent path.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    for (int s = 0; s < QSTAGES; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 8);   // one arrival a consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
      mbar_init(v_empty + 8 * s, 8);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(ca_full + 8 * b, 32);  // one arrival a lane of the scan
      mbar_init(ca_empty + 8 * b, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    if (warp == 0 && lane == 0) {
      // The copies, in the order the consumers take them: per head, chunk
      // and query tile, its Q tile, then the K and V tiles of its key
      // tiles.
      int qi = 0, ki = 0;
      for (int bh = bh0; bh < n_bh; bh += bh_step)
      for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * W;
        for (int qt = 0; qt < n_qt; ++qt, ++qi) {
          const int qs = qi % QSTAGES;
          if (qi >= QSTAGES)
            mbar_wait(q_empty + 8 * qs, ((qi / QSTAGES) & 1) ^ 1);
          mbar_expect_tx(q_full + 8 * qs, L::Q_BYTES);
#pragma unroll
          for (int b = 0; b < L::NBK; ++b)
            tma_load(q_s + qs * L::Q_BYTES + b * L::Q_BOX, &tm_q,
                     q_full + 8 * qs, 64 * b, t0 + 128 * qt, bh);
          const int kt_hi = min(2 * qt + 2, n_sub);
          for (int ks = 0; ks < kt_hi; ++ks, ++ki) {
            const int s = ki % STAGES;
            const uint32_t parity = ((ki / STAGES) & 1) ^ 1;
            if (ki >= STAGES) mbar_wait(k_empty + 8 * s, parity);
            mbar_expect_tx(k_full + 8 * s, L::K_BYTES);
#pragma unroll
            for (int b = 0; b < L::NBK; ++b)
              tma_load(k_s + s * L::K_BYTES + b * L::KV_BOX, &tm_k,
                       k_full + 8 * s, 64 * b, t0 + 64 * ks, bh);
            if (ki >= STAGES) mbar_wait(v_empty + 8 * s, parity);
            mbar_expect_tx(v_full + 8 * s, L::V_BYTES);
#pragma unroll
            for (int b = 0; b < L::NBV; ++b)
              tma_load(v_s + s * L::V_BYTES + b * L::KV_BOX, &tm_v,
                       v_full + 8 * s, 64 * b, t0 + 64 * ks, bh);
          }
        }
      }
    } else if (warp == 1) {
      // Per chunk: ca, the inclusive cumsum of a, times log2(e) (rows at
      // or past W or n_t hold a = 0, so ca = tot there), and the state's
      // key weights w_j = e^{tot - ca_j} (0 at or past W or n_t).  a is
      // copied in by coalesced loads (eight in flight a lane), then each
      // lane sums a run of Wp / 32 rows and a shuffle scan joins the runs.
      const int per = Wp / 32, lo = lane * per;
      int cc = 0;   // chunks scanned, over the block's heads
      for (int bh = bh0; bh < n_bh; bh += bh_step)
      for (int c = 0; c < n_chunks; ++c, ++cc) {
        const float* ab = a + static_cast<long long>(bh) * n_t;
        const int b = cc & 1;
        if (cc >= 2) mbar_wait(ca_empty + 8 * b, ((cc >> 1) - 1) & 1);
        float* ca = ca_s + b * 2 * Wp;
        float* wv = ca + Wp;
        const int t0 = c * W;
#pragma unroll 8
        for (int i = lane; i < Wp; i += 32)
          ca[i] = i < W && t0 + i < n_t ? ab[t0 + i] : 0.0f;
        __syncwarp();
        float run = 0.0f;
        for (int i = lo; i < lo + per; ++i) {
          run += ca[i];
          ca[i] = run;
        }
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += up;
        }
        const float before = incl - run;
        for (int i = lo; i < lo + per; ++i) ca[i] = (ca[i] + before) * kLog2e;
        __syncwarp();
        const float tot = ca[W - 1];
        for (int i = lane; i < Wp; i += 32)
          wv[i] = i < W && t0 + i < n_t ? ex2(tot - ca[i]) : 0.0f;
        mbar_arrive(ca_full + 8 * b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;   // accumulator row / column pair
    const bool owner = !(DK == 64 && DV == 64) || wg == 0;
    const bool n_owner = owner && (DK == 128 || wg == 0);
    const int m_tile = DK == 128 ? wg : 0;
    const int col0 = DK == 64 && DV == 128 ? 64 * wg : 0;
    const int s_row = 64 * m_tile + 16 * warp + g;   // state rows s_row, +8

    float acc[DV / 2];       // y of the warpgroup's 64 rows
    float sc[32];            // their scores against a key tile, then p
    uint32_t ph[4][4], pl[4][4];   // p's A fragments, hi and lo
    uint32_t kh[4][4], kl[4][4];   // (K o w)^T's A fragments, hi and lo
    float st[SN / 2];        // the owned piece of S (S_in until the chunk's
                             // last query tile, then S_out of the chunk)
    float nr[2];             // n at rows s_row, s_row + 8 (owners)
    if constexpr (kNarrowPingPong) {
      if (wg == 1) bar_arrive(3, 256);   // warpgroup 0 takes the first turn
    }

    int qi = 0, ki = 0, cc = 0;   // Q tiles, key tiles, chunks taken
    for (int bh = bh0; bh < n_bh; bh += bh_step) {
      __nv_bfloat16* yb = y + static_cast<long long>(bh) * n_t * dv;
#pragma unroll
      for (int i = 0; i < SN / 2; ++i) st[i] = 0.0f;
      nr[0] = nr[1] = 0.0f;
      for (int c = 0; c < n_chunks; ++c, ++cc) {
        const int b = cc & 1;
        const long long t0 = static_cast<long long>(c) * W;
        const float* ca = ca_s + b * 2 * Wp;   // ca log2(e)
        const float* wv = ca + Wp;
        mbar_wait(ca_full + 8 * b, (cc >> 1) & 1);
        const float tot = ca[W - 1];
        // S_in and n_in of this chunk (zero at the first) into shared
        // memory, S_in as bf16 hi and lo, once both warpgroups are done with
        // the last chunk's.
        bar_sync(1, 256);
        if (owner) {
#pragma unroll
          for (int j = 0; j < SN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = s_row + 8 * h;
              const uint32_t off = (col0 / 64 + j / 8) * L::S_BOX + row * 128 +
                                   (((j & 7) ^ (row & 7)) << 4) + 4 * tq;
              uint32_t hi, lo;
              split_pair(st[4 * j + 2 * h], st[4 * j + 2 * h + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(sm + L::SH_OFF + off) = hi;
              *reinterpret_cast<uint32_t*>(sm + L::SL_OFF + off) = lo;
            }
          if (n_owner && tq == 0) {
            n_in[s_row] = nr[0];
            n_in[s_row + 8] = nr[1];
          }
        }
        fence_proxy_async();
        bar_sync(1, 256);
        float nsum[2] = {0.0f, 0.0f};   // this lane's share of sum_j (K o w)
        for (int qt = 0; qt < n_qt; ++qt, ++qi) {
          const int qs = qi % QSTAGES;
          const uint32_t qt_s = q_s + qs * L::Q_BYTES + wg * 64 * 128;
          const int row0 = 128 * qt + 64 * wg;   // chunk row of the first row
          const bool active = row0 < W;
          const int r_lo = row0 + 16 * warp + g;  // chunk rows r_lo, r_lo + 8
          const int kt_hi = min(2 * qt + 2, n_sub);
          // key tiles [0, n_y) reach this warpgroup's rows (up to the
          // diagonal); on the last query tile every key tile updates the
          // state
          const int n_y = active ? 2 * qt + wg + 1 : 0;
          const bool sw = qt == n_qt - 1 && owner;
          const int ki0 = ki;
          ki += kt_hi;
          float ca_r[2] = {0.0f, 0.0f};
          float den[2] = {0.0f, 0.0f};   // this lane's share of den
          if (active) {
            ca_r[0] = ca[r_lo];
            ca_r[1] = ca[r_lo + 8];
          }
          // Key tile ks's ring stage and the parity of its barriers.
          auto stage = [&](int ks) { return (ki0 + ks) % STAGES; };
          auto parity = [&](int ks) {
            return static_cast<uint32_t>(((ki0 + ks) / STAGES) & 1);
          };
          // Issues Q K^T of key tile ks into sc (the caller commits).
          auto issue_qk = [&](int ks) {
            const uint32_t kt_s = k_s + stage(ks) * L::K_BYTES;
#pragma unroll
            for (int kk = 0; kk < DK / 16; ++kk)
              wgmma_64x64x16(sc, sw128_desc(qt_s + (kk >> 2) * L::Q_BOX +
                                            (kk & 3) * 32),
                             sw128_desc(kt_s + (kk >> 2) * L::KV_BOX +
                                        (kk & 3) * 32), kk > 0);
          };
          // P = scores * e^{ca_i - ca_j} in place, zero after the row on the
          // diagonal tile; den sums the f32 p when normalizing.  In this
          // warpgroup's turn: every key tile is one turn of each warpgroup,
          // warpgroup 0 first; the last turn of the block is not handed on,
          // so every bar.sync has its arrive.
          auto decay = [&](int ks, bool y) {
            if constexpr (kNarrowPingPong) bar_sync(3 + wg, 256);
            if (y) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float2 cj = *reinterpret_cast<const float2*>(
                    ca + 64 * ks + 8 * j + 2 * tq);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  sc[4 * j + e] *=
                      ex2(ca_r[e >> 1] - ((e & 1) ? cj.y : cj.x));
              }
              if (ks == n_y - 1) {   // the diagonal tile (warp-uniform)
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    if (8 * j + 2 * tq + (e & 1) >
                        16 * warp + g + 8 * (e >> 1))
                      sc[4 * j + e] = 0.0f;
              }
              if (normalize) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  den[0] += sc[4 * j] + sc[4 * j + 1];
                  den[1] += sc[4 * j + 2] + sc[4 * j + 3];
                }
              }
            }
            if constexpr (kNarrowPingPong) {
              const bool last = bh + bh_step >= n_bh && c == n_chunks - 1 &&
                                qt == n_qt - 1 && ks == kt_hi - 1;
              if (wg == 0 || !last) bar_arrive(3 + (wg ^ 1), 256);
            }
          };
          // p into the hi and lo A fragments of P V (k-step kk: keys 16 kk ..
          // 16 kk + 15, the accumulator's tiles 2 kk and 2 kk + 1).
          auto split_p = [&] {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float* p = sc + 4 * (2 * kk + h);
                split_pair(p[0], p[1], ph[kk][2 * h], pl[kk][2 * h]);
                split_pair(p[2], p[3], ph[kk][2 * h + 1], pl[kk][2 * h + 1]);
              }
          };
          // (K o w)^T's A fragments: ldmatrix.trans of K's swizzled tile
          // gives, for dk rows s_row and s_row + 8, keys 2 tq, 2 tq + 1 and
          // 8 + 2 tq, 9 + 2 tq of each 16; each product split hi + lo.
          auto split_kw = [&](int ks) {
            const uint32_t kt_s = k_s + stage(ks) * L::K_BYTES;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float2 wa = *reinterpret_cast<const float2*>(
                  wv + 64 * ks + 16 * kk + 2 * tq);
              const float2 wb = *reinterpret_cast<const float2*>(
                  wv + 64 * ks + 16 * kk + 8 + 2 * tq);
              uint32_t kr[4];
              ldmatrix_x4_trans(kr, kt_s + m_tile * L::KV_BOX +
                                swz(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                    2 * warp + ((lane >> 3) & 1)));
              const float x00 = lo_f(kr[0]) * wa.x, x01 = hi_f(kr[0]) * wa.y;
              const float x10 = lo_f(kr[1]) * wa.x, x11 = hi_f(kr[1]) * wa.y;
              const float x20 = lo_f(kr[2]) * wb.x, x21 = hi_f(kr[2]) * wb.y;
              const float x30 = lo_f(kr[3]) * wb.x, x31 = hi_f(kr[3]) * wb.y;
              split_pair(x00, x01, kh[kk][0], kl[kk][0]);
              split_pair(x10, x11, kh[kk][1], kl[kk][1]);
              split_pair(x20, x21, kh[kk][2], kl[kk][2]);
              split_pair(x30, x31, kh[kk][3], kl[kk][3]);
              if (n_owner) {
                nsum[0] += (x00 + x01) + (x20 + x21);
                nsum[1] += (x10 + x11) + (x30 + x31);
              }
            }
          };
          // Key tile ks: Y, this warpgroup's rows see it; S, it updates the
          // state; Here, its Q K^T is issued here (key tile 0's went with the
          // inter-chunk term).  Every wgmma below is unconditional within its
          // instantiation, so that no accumulator passes through a branch
          // between a wgmma and its wait (ptxas would serialize them).
          auto step = [&](int ks, auto y_flag, auto s_flag, auto here_flag) {
            constexpr bool Y = decltype(y_flag)::value;
            constexpr bool S = decltype(s_flag)::value;
            constexpr bool Here = decltype(here_flag)::value;
            mbar_wait(k_full + 8 * stage(ks), parity(ks));
            if constexpr (Here) {
              pin(sc);
              wgmma_fence();
              issue_qk(ks);
              wgmma_commit();
              wgmma_wait_all();
              pin(sc);
            }
            decay(ks, Y);
            if constexpr (Y) split_p();
            if constexpr (S) split_kw(ks);
            __syncwarp();
            if (lane == 0) mbar_arrive(k_empty + 8 * stage(ks));   // K is read
            const uint32_t vt_s = v_s + stage(ks) * L::V_BYTES;
            mbar_wait(v_full + 8 * stage(ks), parity(ks));
            if constexpr (Y || S) {
              // acc += P_hi V + P_lo V; S += (K o w)_hi^T V + (K o w)_lo^T V
              // (this warpgroup's columns of V).
              pin(acc);
              pin(st);
              wgmma_fence();
              if constexpr (Y) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                  wgmma_rs<DV>(acc, ph[kk],
                               desc_mn_major(vt_s + kk * 2048, L::KV_BOX));
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                  wgmma_rs<DV>(acc, pl[kk],
                               desc_mn_major(vt_s + kk * 2048, L::KV_BOX));
              }
              if constexpr (S) {
                const uint32_t vc_s = vt_s + (col0 / 64) * L::KV_BOX;
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                  wgmma_rs<SN>(st, kh[kk],
                               desc_mn_major(vc_s + kk * 2048, L::KV_BOX));
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                  wgmma_rs<SN>(st, kl[kk],
                               desc_mn_major(vc_s + kk * 2048, L::KV_BOX));
              }
              wgmma_commit();
              wgmma_wait_all();
              pin(acc);
              pin(st);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(v_empty + 8 * stage(ks));   // V is read
          };
          // The key tiles of this query tile, the state flag fixed for them.
          auto walk = [&](auto s_flag) {
            const Flag<true> yes;
            const Flag<false> no;
            if (n_y > 0) step(0, yes, s_flag, no);
            for (int ks = 1; ks < n_y; ++ks) step(ks, yes, s_flag, yes);
            for (int ks = n_y; ks < kt_hi; ++ks) step(ks, no, s_flag, no);
          };

          // The inter-chunk term e^{ca_i} q_i (S_hi + S_lo) with key tile 0's
          // scores in one group, and q_i . n_in on the CUDA cores under it.
          mbar_wait(q_full + 8 * qs, (qi / QSTAGES) & 1);
          mbar_wait(k_full + 8 * stage(0), parity(0));
          pin(acc);
          pin(sc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk)
            wgmma_ss_t<DV>(acc, sw128_desc(qt_s + (kk >> 2) * L::Q_BOX +
                                           (kk & 3) * 32),
                           desc_mn_major(sh_s + kk * 2048, L::S_BOX), kk > 0);
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk)
            wgmma_ss_t<DV>(acc, sw128_desc(qt_s + (kk >> 2) * L::Q_BOX +
                                           (kk & 3) * 32),
                           desc_mn_major(sl_s + kk * 2048, L::S_BOX), 1);
          issue_qk(0);
          wgmma_commit();
          if (normalize) {
            // lane tq takes the 16-byte chunks tq and tq + 4 of each box
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * warp + g + 8 * h;
#pragma unroll
              for (int bx = 0; bx < L::NBK; ++bx)
#pragma unroll
                for (int hc = 0; hc < 2; ++hc) {
                  const int ch = tq + 4 * hc;
                  const uint4 u = *reinterpret_cast<const uint4*>(
                      sm + (qt_s - base) + bx * L::Q_BOX + row * 128 +
                      ((ch ^ (row & 7)) << 4));
                  const float* np_ = n_in + 64 * bx + 8 * ch;
                  const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    den[h] += lo_f(w4[e]) * np_[2 * e] +
                              hi_f(w4[e]) * np_[2 * e + 1];
                }
            }
          }
          wgmma_wait_all();
          pin(acc);
          pin(sc);
          const float e0 = ex2(ca_r[0]), e1 = ex2(ca_r[1]);
#pragma unroll
          for (int n = 0; n < DV / 8; ++n) {
            acc[4 * n] *= e0;
            acc[4 * n + 1] *= e0;
            acc[4 * n + 2] *= e1;
            acc[4 * n + 3] *= e1;
          }
          den[0] *= e0;
          den[1] *= e1;
          if (sw) {   // S = e^{tot} S_in before the chunk's products add in
            const float gt = ex2(tot);
#pragma unroll
            for (int i = 0; i < SN / 2; ++i) st[i] *= gt;
            walk(Flag<true>());
          } else {
            walk(Flag<false>());
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty + 8 * qs);    // Q is read

          if (active) {   // y of rows < W and < n_t
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float d = den[h] + __shfl_xor_sync(0xffffffffu, den[h], 1);
              d += __shfl_xor_sync(0xffffffffu, d, 2);
              const float inv =
                  normalize ? 1.0f / fmaxf(fabsf(d), 1.0f) : 1.0f;
              const int row = r_lo + 8 * h;
              const long long t = t0 + row;
              if (row >= W || t >= n_t) continue;
#pragma unroll
              for (int n = 0; n < DV / 8; ++n) {
                const int col = 8 * n + 2 * tq;
                if (col < dv)
                  *reinterpret_cast<__nv_bfloat162*>(yb + t * dv + col) =
                      __floats2bfloat162_rn(acc[4 * n + 2 * h] * inv,
                                            acc[4 * n + 2 * h + 1] * inv);
              }
            }
          }
        }
        // n_out of the chunk: e^{tot} n_in + sum_j (K o w)
        if (n_owner) {
          const float gt = ex2(tot);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float sum = nsum[h] + __shfl_xor_sync(0xffffffffu, nsum[h], 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            nr[h] = gt * nr[h] + sum;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ca_empty + 8 * b);      // ca is read
      }

      if (owner) {
        float* Sb = S_out + static_cast<long long>(bh) * dk * dv;
#pragma unroll
        for (int j = 0; j < SN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = s_row + 8 * h;
            const int col = col0 + 8 * j + 2 * tq;
            if (row < dk && col < dv)
              *reinterpret_cast<float2*>(
                  Sb + static_cast<long long>(row) * dv + col) =
                  make_float2(st[4 * j + 2 * h], st[4 * j + 2 * h + 1]);
          }
      }
      if (n_owner && tq == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (s_row + 8 * h < dk)
            n_out[static_cast<long long>(bh) * dk + s_row + 8 * h] = nr[h];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 heads wider than 128: tensor cores, dv split across blocks.
// ---------------------------------------------------------------------------

constexpr int kWideDvs = 64;                 // dv columns per wide block
constexpr int kPiece = kTile * kTile * 2;    // one [64][64] bf16 piece

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime (null
// where libcuda has none).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous bf16 [n, rows, width] at `ptr`: boxes of
// 64 columns by `box_rows` rows of one head, 128-byte swizzle, zeros past
// each dimension.
bool tensor_map(CUtensorMap* map, const void* ptr, int n, int rows,
                int width, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(rows) * width * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV>
int launch_tc(const void* q, const void* k, const void* v, const float* a,
              void* y, float* S, float* n, int bh, int n_t, int dk, int dv,
              int W, int normalize, cudaStream_t st) {
  using L = NarrowTiles<DK, DV>;
  static bool configured = false;  // once, for the largest chunk taken
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gla_fwd_bf16<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes(kMaxChunk));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  static int n_sm = 0;   // one block per SM walks the heads
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, bh, n_t, dk, 128) ||
      !tensor_map(&tk, k, bh, n_t, dk, 64) ||
      !tensor_map(&tv, v, bh, n_t, dv, 64))
    return int(cudaErrorInvalidValue);
  gla_fwd_bf16<DK, DV><<<min(bh, n_sm), L::THREADS,
                         L::bytes((W + 63) / 64 * 64), st>>>(
      tq, tk, tv, a, static_cast<__nv_bfloat16*>(y), S, n, bh, n_t, dk, dv,
      W, normalize);
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

// bf16 with dk, dv multiples of 16 and 16-byte aligned q, k, v (TMA up to
// 128 wide, cp.async wider) take the tensor cores: up to 128 wide at
// widths rounded up to 64 or 128, wider (dk up to 512) in dv slices of
// kWideDvs; everything else takes gla_fwd on the CUDA cores.
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