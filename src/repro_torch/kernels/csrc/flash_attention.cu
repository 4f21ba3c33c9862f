// Flash-attention forward for Hopper (sm_90a): online softmax, GQA,
// causal and sliding-window masks.  bf16 runs on the tensor cores
// (mma.sync), f32 on the CUDA cores.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel behind repro.kernels.flash_attention.flash_attention_fwd).
// For each query head bh (KV head bh / rep, never materialised) and query
// position t:
//
//     s_j  = (q_t . k_j) * scale            scale = 1 / sqrt(hd)
//     s_j  = -1e30 where masked             causal: j <= t; window: j > t - window
//     o_t  = sum_j e^{s_j - m} v_j / max(l, 1e-30),   l = sum_j e^{s_j - m}
//     lse_t = m + log(max(l, 1e-30))
//
// o is written in q's dtype and lse in f32 [BH, T] (no lane padding).
//
// Bound on this card.  The work is 2 (T + 2 S) hd BH bytes of q, k, v and
// o (bf16) plus 4 T BH of lse, against 4 hd BH FLOPs per unmasked (query,
// key) pair.  At fleet-gla's 512 heads of 512 x 512 x 64, causal, that is
// 135 MB (0.040 ms at 3.35 TB/s) against 17.2 GFLOP (0.017 ms at the
// tensor cores' 989 TFLOP/s): bytes bound it, and a kernel that keeps its
// products on the tensor cores and its loads in flight can approach it.
//
// What still holds the bf16 kernel back (its times are in PERF.md): P V in
// TF32 takes twice the tensor time of bf16, each warp runs its products,
// its softmax and its next products in sequence, and mma.sync reaches only
// part of the rate of wgmma.  wgmma fed by TMA, with one warpgroup's
// softmax overlapping another's products, is the later design.
//
// Dispatch by dtype (dispatch_hd): bf16 inputs go to flash_fwd_bf16, f32
// inputs to flash_fwd_f32.  Each dtype has one kernel; neither falls back
// to the other.
//
// flash_fwd_bf16, the tensor-core kernel (the FlashAttention-2 shape).
// One block per (bh, BQ-row query tile), a warp per 16 query rows: warp w
// owns rows 16 w .. 16 w + 15 of the tile.  BQ is 64 (4 warps) at hd 64,
// 112 and 128, and 128 (8 warps) at hd 256 (bf16_block_q, below).
//   - Copies: the Q tile and 64-key K and V tiles go to shared memory by
//     cp.async.cg (16 B per thread and copy), K and V double-buffered, so
//     the next tile's copy is in flight while this tile's products and
//     softmax run.  Rows past T or S are zero-filled through cp.async's
//     src-size operand.  Every row is padded by 16 B (stride hd + 8), which
//     puts the 8 rows of each ldmatrix on distinct banks at hd 64, 112, 128
//     and 256 (a stride of 16 mod 128 bytes).
//   - S = Q K^T: mma.sync m16n8k16 bf16 -> f32.  Up to hd 128, Q's A
//     fragments are loaded once by ldmatrix and stay in registers; at
//     hd 256 they are loaded by ldmatrix from the Q tile at each k-step
//     (see "hd 256" below).  K's B fragments come by ldmatrix from the
//     [key][hd] rows.
//   - Masks run only on the tiles that straddle the causal diagonal, the
//     window edge or S (decided per warp).  Key tiles hidden from every row
//     of the query tile are skipped when T == S (below).
//   - Online softmax in registers, on the unscaled f32 scores: a thread
//     holds two rows (g and g + 8 of the accumulator layout); row max and
//     row sum reduce over the 4 lanes of a row by shuffles.  The scale
//     enters the exponent, p = 2^{(s - m) scale log2 e} (ex2.approx), and
//     lse = m scale + log l; the TPU kernel scales q before the product,
//     which differs in the last bits (the TOL decides; this was faster on
//     the card than scaling every score).  l accumulates the f32 p before
//     any rounding.
//   - O += P V: mma.sync m16n8k8 in TF32, p rounded to TF32 (cvt.rna), V's
//     bf16 widened exactly.  p in bf16 (m16n8k16) would halve this
//     product's tensor time but misses the bf16 flash_o TOL at T = 512 (up
//     to 1.5 x the allowance; TF32 stays at 0.24 x, f32 p at 0.22 x:
//     tests/test_torch_flash_numerics.py).  With the k index permuted
//     within each 8-key group, P's A fragments are S's C fragments and V's
//     B fragments are the halves of an ldmatrix.trans register, so P never
//     goes through shared memory.  O stays in f32 registers (hd / 8
//     n-tiles).
//   - Epilogue: o / max(l, 1e-30) in bf16, staged through the warp's own Q
//     rows in shared memory and written in 16-byte stores; lse in f32.
//   Shared memory: (BQ + 4 * 64) rows of (hd + 8) bf16 = 46,080 B at hd 64,
//   76,800 B at hd 112, 87,040 B at hd 128, 202,752 B at hd 256.
//   Registers are held to 4 blocks per SM at hd 64 and 3 at hd 112
//   (bf16_min_blocks).
//   hd 256: what runs out is registers, not shared memory.  Holding Q's
//   fragments (qf[16][4], 64 registers), the O accumulator (acc[32][4],
//   128) and the scores (s[8][4], 32) would take 224 of a thread's 255
//   before addresses and softmax state, and spill.  So Q's fragments are
//   read from the Q tile, which stays in shared memory for the whole loop,
//   at each k-step of Q K^T (one more ldmatrix per two mma.sync), leaving
//   the accumulator and the scores in registers (ptxas still takes all 255
//   and spills 212 bytes, against 280 with Q in registers).  The tile then
//   fits one block per SM, so the block takes 128 query rows (8 warps)
//   instead of 64: each K/V tile copied feeds twice as many rows, and the
//   SM has 8 warps, not 4, to hide latency (1.32x faster on the card than
//   64 rows at gemma3-12b's prefill, 1.73x than Q in registers:
//   kernels/flash_variants.py, PERF.md).  The arithmetic and its
//   rounding points are those of the narrower widths: which query rows
//   share a block does not change any row's sequence of key tiles (a tile
//   the mask hides from a row adds exact zeros to it, see below).
//
// flash_fwd_f32, the CUDA-core kernel.  The f32 TOL of the oracle
// (2e-6 + 16 ulp) is met by no bf16 or TF32 tensor-core product, so f32
// stays in f32 FMAs.  One block of 256 threads per (bh, 64-row query tile)
// stages its scaled Q tile once, then walks 64-key K/V tiles through shared
// memory, keeping the running max, sum and the [64, hd] accumulator in
// registers: thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 4),
// score columns tx + 16 j (j < 4) and output columns tx + 16 j
// (j < hd / 16).  Shared memory (f32): Q and K tiles [64][hd + 1], V
// [64][hd] and P [64][65]: 115,456 B at hd 128, 213,760 B at hd 256.
//
// Both kernels: rows past T are computed on zeros and never written; keys
// past S get a score of -inf, so they add nothing even to a row whose keys
// are all masked (which then averages v over the real keys, as the TPU
// kernel does).  Key tiles that the causal or window mask hides from every
// row of the query tile are skipped when T == S.  That gives the TPU
// kernel's result: there a masked tile adds e^{-1e30 - m} = 0 once a real
// key has set m, or ones that the first real key wipes with
// alpha = e^{-1e30 - m} = 0, and with T == S every row has a real key (its
// own position).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kNeg = -1e30f;

// The key tiles [lo, hi) a query tile of `bq` rows starting at q0 has to
// visit.
__device__ __forceinline__ void key_tiles(int q0, int bq, int n_q, int S,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = 0;
  hi = (S + kBK - 1) / kBK;
  if (n_q == S) {
    const int q_last = min(q0 + bq, n_q) - 1;
    if (causal) hi = min(hi, q_last / kBK + 1);
    if (window > 0) lo = max(0, q0 - window + 1) / kBK;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------

// Query rows per block: 64, or 128 at hd 256 (one block per SM there, see
// "hd 256" above).
template <int HD>
__host__ __device__ constexpr int bf16_block_q() {
  return HD == 256 ? 128 : 64;
}

// A warp per 16 query rows.
template <int HD>
__host__ __device__ constexpr int bf16_threads() {
  return 32 * bf16_block_q<HD>() / 16;
}

// Whether Q's A fragments stay in registers for the whole loop (else they
// are read from the Q tile at each k-step).
template <int HD>
__host__ __device__ constexpr bool bf16_q_in_registers() {
  return HD <= 128;
}

template <int HD>
constexpr int bf16_smem_bytes() {
  return (bf16_block_q<HD>() + 4 * kBK) * (HD + 8) * 2;
}

// Blocks per SM the register allocation must allow: 4 at hd 64 (128
// registers), 3 at hd 112 (168 registers and some spill, still faster on
// the card than 2 blocks without); at hd 128 ptxas chooses (2 blocks),
// since a cap there was slower; at hd 256 shared memory allows one.
template <int HD>
__host__ __device__ constexpr int bf16_min_blocks() {
  return HD == 64 ? 4 : HD == 112 ? 3 : 1;
}

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

// f32 -> TF32, round to nearest, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of a [n_rows, HD] bf16 matrix into shared
// memory at `dst` (row stride HD + 8), by THREADS threads; rows past n_rows
// are zero-filled.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows, int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CH, ch = c - r * CH;
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* from =
        in ? src + static_cast<long long>(row0 + r) * HD + ch * 8 : src;
    cp_async16(dst + (r * (HD + 8) + ch * 8) * 2, from, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(bf16_threads<HD>(), bf16_min_blocks<HD>())
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int n_q, int S, int rep, int n_qt, int causal, int window,
               float scale) {
  constexpr int STR = HD + 8;           // shared row stride (bf16)
  constexpr int KS = HD / 16;           // k-steps of Q K^T
  constexpr int NO = HD / 8;            // n-tiles of O
  constexpr int NS = kBK / 8;           // n-tiles of S
  constexpr int BQ = bf16_block_q<HD>();
  constexpr int NT = bf16_threads<HD>();
  constexpr bool QREG = bf16_q_in_registers<HD>();
  constexpr uint32_t TILE = kBK * STR * 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const uint32_t qs = smem_addr(smem);
  const uint32_t ks = qs + BQ * STR * 2;    // [2][kBK][STR]
  const uint32_t vs = ks + 2 * TILE;        // [2][kBK][STR]
  const float c2 = scale * 1.4426950408889634f;   // scale * log2(e)

  // The query tiles of a head are adjacent blocks (they share K and V in
  // L2), the longest causal rows first.
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x % n_qt)) * BQ;
  const int kvh = bh / rep;
  const __nv_bfloat16* qb = q + static_cast<long long>(bh) * n_q * HD;
  const __nv_bfloat16* kb = k + static_cast<long long>(kvh) * S * HD;
  const __nv_bfloat16* vb = v + static_cast<long long>(kvh) * S * HD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // accumulator row / column pair
  const int r_lo = q0 + 16 * warp;          // the warp's first query row

  int kt_lo, kt_hi;
  key_tiles(q0, BQ, n_q, S, causal, window, kt_lo, kt_hi);

  load_tile<HD, BQ, NT>(qs, qb, q0, n_q, tid);
  cp_async_commit();
  load_tile<HD, kBK, NT>(ks, kb, kt_lo * kBK, S, tid);
  load_tile<HD, kBK, NT>(vs, vb, kt_lo * kBK, S, tid);
  cp_async_commit();

  // The lane's ldmatrix address in the warp's Q rows, at k-step 0.
  const uint32_t q_lane =
      qs + ((16 * warp + (lane & 15)) * STR + (lane >> 4) * 8) * 2;
  // Q's A fragments, while the first K and V tiles are in flight (up to
  // hd 128; at hd 256 the loop reads them, after its first wait, which
  // also covers the Q tile's copy).
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], q_lane + 32 * kk);
  }

  float acc[NO][4];
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.0f, 0.0f};   // this lane's share of the row sums
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_tile<HD, kBK, NT>(ks + (buf ^ 1) * TILE, kb, (kt + 1) * kBK, S,
                             tid);
      load_tile<HD, kBK, NT>(vs + (buf ^ 1) * TILE, vb, (kt + 1) * kBK, S,
                             tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kt_s = ks + buf * TILE;
    const uint32_t vt_s = vs + buf * TILE;

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys, left
    // unscaled: the softmax below folds the scale into its exponent.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, q_lane + 32 * kk);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kt_s + ((8 * j + (lane & 7) + ((lane >> 4) << 3)) * STR
                               + 16 * kk + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(s[j], qa, b[0], b[1]);
        mma_bf16(s[j + 1], qa, b[2], b[3]);
      }
    }

    const int k0 = kt * kBK;
    const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > r_lo) ||
                        (window > 0 && k0 <= r_lo + 15 - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int kp = k0 + 8 * j + 2 * tq + (e & 1);
          const int qp = r_lo + g + 8 * (e >> 1);
          if (kp >= S)
            s[j][e] = -INFINITY;
          else if ((causal && qp < kp) || (window > 0 && kp <= qp - window))
            s[j][e] = kNeg;
        }
      }

    // Online softmax on unscaled scores: rows g (e = 0, 1) and g + 8
    // (e = 2, 3).  The max commutes with the positive scale, and
    // e^{(s - m) scale} = 2^{(s - m) scale log2 e}: one subtract, one
    // multiply, one ex2.  A masked score is -1e30 here as there, so
    // -1e30 - -1e30 = 0 still gives the TPU's ones for a row that has no
    // real key yet.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mc = fmaxf(mc, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[r], mc);
      alpha[r] = ex2((m[r] - mn) * c2);
      m[r] = mn;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * r] = ex2((s[j][2 * r] - mn) * c2);
        s[j][2 * r + 1] = ex2((s[j][2 * r + 1] - mn) * c2);
        rs += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = alpha[r] * l[r] + rs;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V in TF32, 8 keys per product.  The k index of m16n8k8 is
    // permuted within each 8-key group (slot t holds key 2 t, slot t + 4
    // key 2 t + 1), the same for P and V, which leaves the sum unchanged
    // and makes both fragments fall out of registers already held: P's are
    // S's C fragments (c0, c2, c1, c3), V's the two bf16 halves of an
    // ldmatrix.trans register, widened exactly.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[h][0] = to_tf32(s[2 * kk + h][0]);
        a[h][1] = to_tf32(s[2 * kk + h][2]);
        a[h][2] = to_tf32(s[2 * kk + h][1]);
        a[h][3] = to_tf32(s[2 * kk + h][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];   // keys 16 kk + {0..7, 8..15} x hd 8 n + {0..15}
        ldmatrix_x4_trans(b, vt_s + ((16 * kk + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * STR +
                                     8 * n + (lane >> 4) * 8) * 2);
        mma_tf32(acc[n], a[0], b[0] << 16, b[0] & 0xffff0000u);
        mma_tf32(acc[n], a[1], b[1] << 16, b[1] & 0xffff0000u);
        mma_tf32(acc[n + 1], a[0], b[2] << 16, b[2] & 0xffff0000u);
        mma_tf32(acc[n + 1], a[1], b[3] << 16, b[3] & 0xffff0000u);
      }
    }
    __syncthreads();  // this buffer is refilled by the next copy
  }

  // Epilogue: the warp's 16 rows through its own Q rows in shared memory
  // (the loop's last __syncthreads ends every read of them).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float safe = fmaxf(lt, 1e-30f);
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          acc[n][2 * r] / safe, acc[n][2 * r + 1] / safe);
      *reinterpret_cast<__nv_bfloat162*>(Qs + row * STR + 8 * n + 2 * tq) =
          pair;
    }
    // m is an unscaled max, or -1e30 for a row without a real key.
    const float ms = m[r] == kNeg ? kNeg : m[r] * scale;
    if (tq == 0 && q0 + row < n_q)
      lse[static_cast<long long>(bh) * n_q + q0 + row] = ms + logf(safe);
  }
  __syncwarp();
  constexpr int CH = HD / 8;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / CH, ch = c - r * CH;
    const int row = r_lo + r;
    if (row < n_q)
      *reinterpret_cast<uint4*>(o + (static_cast<long long>(bh) * n_q + row)
                                * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(Qs + (16 * warp + r) * STR + ch * 8);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;

// Reduce over the 16 lanes of a half warp (lanes that share ty).
__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr int f32_smem_bytes() {
  return (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int n_q, int S, int rep, int n_qt,
              int causal, int window, float scale) {
  constexpr int QP = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;               // [kBQ][QP]
  float* Ks = Qs + kBQ * QP;        // [kBK][QP]
  float* Vs = Ks + kBK * QP;        // [kBK][HD]
  float* Ps = Vs + kBK * HD;        // [kBQ][kBK + 1]

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBQ;
  const int kvh = bh / rep;
  const float* qb = q + static_cast<long long>(bh) * n_q * HD;
  const float* kb = k + static_cast<long long>(kvh) * S * HD;
  const float* vb = v + static_cast<long long>(kvh) * S * HD;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid; e < kBQ * HD; e += kF32Threads) {
    const int r = e / HD, d = e - r * HD;
    Qs[r * QP + d] = q0 + r < n_q
        ? qb[static_cast<long long>(q0 + r) * HD + d] * scale : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  int kt_lo, kt_hi;
  key_tiles(q0, kBQ, n_q, S, causal, window, kt_lo, kt_hi);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * HD; e += kF32Threads) {
      const int r = e / HD, d = e - r * HD;
      const bool in = k0 + r < S;
      const long long off = static_cast<long long>(k0 + r) * HD + d;
      Ks[r * QP + d] = in ? kb[off] : 0.0f;
      Vs[r * HD + d] = in ? vb[off] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= S) {
          s[i][j] = -INFINITY;
        } else {
          bool keep = true;
          if (causal) keep = keep && qp >= kp;
          if (window > 0) keep = keep && kp > qp - window;
          if (!keep) s[i][j] = kNeg;
        }
        mc = fmaxf(mc, s[i][j]);
      }
      mc = half_warp_max(mc);
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= n_q) continue;
    const float safe = fmaxf(l[i], 1e-30f);
    float* orow = o + (static_cast<long long>(bh) * n_q + r) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = acc[i][j] / safe;
    if (tx == 0) lse[static_cast<long long>(bh) * n_q + r] = m[i] + logf(safe);
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Launch `kernel` with `bytes` of dynamic shared memory, raising the
// kernel's limit once (outside any graph capture) per instance.
template <typename T, typename Kernel>
int run(Kernel kernel, bool& configured, int threads, int bq, int bytes,
        const void* q, const void* k, const void* v, void* o, float* lse,
        int bh, int n_q, int S, int rep, int causal, int window, float scale,
        cudaStream_t st) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const int n_qt = (n_q + bq - 1) / bq;
  const long long blocks = static_cast<long long>(bh) * n_qt;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), threads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n_q, S, rep, n_qt,
      causal, window, scale);
  return int(cudaGetLastError());
}

template <int HD>
int launch(int is_bf16, const void* q, const void* k, const void* v,
           void* o, float* lse, int bh, int n_q, int S, int rep, int causal,
           int window, float scale, cudaStream_t st) {
  static bool bf16_configured = false;
  static bool f32_configured = false;
  if (is_bf16) {
    // cp.async and the 16-byte stores need 16-byte aligned rows.
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
        15)
      return int(cudaErrorMisalignedAddress);
    return run<__nv_bfloat16>(flash_fwd_bf16<HD>, bf16_configured,
                              bf16_threads<HD>(), bf16_block_q<HD>(),
                              bf16_smem_bytes<HD>(), q, k, v, o, lse, bh,
                              n_q, S, rep, causal, window, scale, st);
  }
  return run<float>(flash_fwd_f32<HD>, f32_configured, kF32Threads, kBQ,
                    f32_smem_bytes<HD>(), q, k, v, o, lse, bh, n_q, S, rep,
                    causal, window, scale, st);
}

int dispatch_hd(int hd, int is_bf16, const void* q, const void* k,
                const void* v, void* o, float* lse, int bh, int n_q, int S,
                int rep, int causal, int window, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<64>(is_bf16, q, k, v, o, lse, bh, n_q, S, rep, causal,
                        window, scale, st);
    case 112:
      return launch<112>(is_bf16, q, k, v, o, lse, bh, n_q, S, rep, causal,
                         window, scale, st);
    case 128:
      return launch<128>(is_bf16, q, k, v, o, lse, bh, n_q, S, rep, causal,
                         window, scale, st);
    case 256:
      return launch<256>(is_bf16, q, k, v, o, lse, bh, n_q, S, rep, causal,
                         window, scale, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [bh, n_q, hd]; k, v: [bkv, S, hd], all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1, 16-byte aligned), contiguous; bh = bkv * rep.
// o: [bh, n_q, hd] in q's dtype; lse: [bh, n_q] f32.  hd is 64, 112, 128
// or 256.  window <= 0 means no window.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int is_bf16, int bh, int bkv, int n_q,
                                   int S, int hd, int causal, int window,
                                   float scale, void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv != 0 || n_q <= 0 || S <= 0)
    return int(cudaErrorInvalidValue);
  return dispatch_hd(hd, is_bf16, q, k, v, o, lse, bh, n_q, S, bh / bkv,
                     causal, window, scale,
                     static_cast<cudaStream_t>(stream));
}
