// Flash-attention forward for Hopper (sm_90a): online softmax, GQA,
// causal and sliding-window masks.  bf16 runs on the tensor cores (wgmma
// fed by TMA, warp-specialised), f32 on the CUDA cores.
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
// tensor cores' 989 TFLOP/s): bytes bound it.  At the prefills' T = S =
// 2,048 the operations do (0.070 ms at qwen2.5-3b's 64 heads of 128
// against 0.020 ms of bytes), so there the kernel has to keep the tensor
// cores busy: every product on wgmma, the copies on TMA, and the softmax
// of one warpgroup beside the products of the other.
//
// Dispatch by dtype (dispatch_hd): bf16 inputs go to flash_fwd_bf16, f32
// inputs to flash_fwd_f32.  Each dtype has one kernel; neither falls back
// to the other, and an input either kernel does not take returns a CUDA
// error, which the wrapper raises.
//
// flash_fwd_bf16, the tensor-core kernel (warp-specialised, the
// FlashAttention-3 shape).  One block per (bh, 128-row query tile), the
// longest causal tiles first and, within a tile index, the query heads in
// order, so that the blocks sharing a KV head run together (K and V come
// from L2).  384 threads in three warpgroups:
//   - warpgroup 2, the producer: setmaxnreg lowers it to 24 registers and
//     one thread issues every copy: the Q tile once, then K and V tiles of
//     BK keys through a ring of STAGES stages, each tile of a stage with
//     a "full" mbarrier (TMA completes it) and an "empty" one (each
//     consumer warp arrives when its products have read the tile).
//   - warpgroups 0 and 1, the consumers (setmaxnreg raises them to 240):
//     64 query rows each.
// Copies: 3-D tensor maps over q [BH, T, hd], k and v [BKV, S, hd] and o,
// bf16, 128-byte swizzle, boxes 64 columns wide (one box per 64 columns of
// hd: 1, 2, 2 and 4 at hd 64, 112, 128 and 256).  Rows past T or S, and at
// hd 112 columns 112..127 of the second box, arrive as zeros.  The maps
// are encoded on the host at each call (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPointByVersion, so nothing links libcuda) and
// passed by value as __grid_constant__ parameters (captured by value in a
// CUDA graph).
// Per key tile, in each consumer warpgroup:
//   - S = Q K^T: wgmma m64nBKk16 bf16 -> f32, Q and K from shared memory
//     (both K-major: hd is contiguous in their rows), hd / 16 k-steps (7
//     at hd 112: the zero columns are not read).  BK is 128 keys up to hd
//     128 and 64 at hd 256, where the O accumulator takes 128 registers a
//     thread (bf16_block_k).
//   - Masks only on the tiles that straddle the causal diagonal, the
//     window edge or S (decided per warp); key tiles hidden from every row
//     of the query tile are skipped when T == S (key_tiles).
//   - Online softmax in registers on the unscaled f32 scores: wgmma's
//     accumulator gives each thread rows g and g + 8 of its warp's 16, as
//     mma.sync's did, so row max and row sum reduce over the 4 lanes of a
//     row by shuffles.  The scale enters the exponent, p = 2^{(s - m)
//     scale log2 e} (ex2.approx), and lse = m scale + log l; l sums the
//     f32 p before any rounding.
//   - O += P V: p is split into hi = bf16(p) and lo = bf16(p - hi), and two
//     wgmma m64nHDk16 bf16 products (hi V, then lo V) keep about 16
//     significant bits of p at the tensor time of one TF32 product.  p in
//     bf16 alone misses the bf16 flash_o TOL at T = 512 (by 1.5 x; the
//     split stays at about the f32-p error: tests/test_torch_flash_numerics.py).
//     A comes from registers (the S accumulator's layout is the register A
//     layout of k16), B is the V tile as TMA brought it: V is MN-major (hd
//     contiguous), which wgmma reads through its transpose flag, so nothing
//     is transposed or widened.  At hd 112 the product is 112 wide, over
//     one whole box and 48 columns of the second.
//   - O stays in f32 registers; the warpgroup's own Q rows stage o / max(l,
//     1e-30) in bf16 (with the swizzle), and a TMA store writes them, which
//     clips rows past T and hd 112's padding; lse is stored in f32.
// Schedule.  A warpgroup issues tile i's Q K^T beside tile i - 1's P V (two
// commit groups), waits for the first, runs tile i's softmax under the P
// V, then waits for it, rescales O and splits p (kOverlap).  The two
// warpgroups take turns at issuing their products (named barriers 3 and
// 4, kPingPong), so that one's softmax runs under the other's products.
// Each paid a few per cent on the card against the plain order
// (kernels/flash_variants.py, PERF.md).  K and V of a stage have empty
// barriers of their own, so K is refilled as soon as its Q K^T is done.
//   Shared memory (1,024-byte aligned tiles): Q 128 x hd, and STAGES (2)
//   stages of K and V, BK x hd each: 80 KB at hd 64, 160 KB at hd 112 and
//   128, 192 KB at hd 256 (one block per SM).
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
// own position).  A tile visited but hidden from some of a block's rows
// adds exact zeros to those rows for the same reason.

#include <cuda.h>   // CUtensorMap and its enums only: no libcuda symbol
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kNeg = -1e30f;

// The key tiles [lo, hi) of BK keys a query tile of `bq` rows starting at
// q0 has to visit.
template <int BK = kBK>
__device__ __forceinline__ void key_tiles(int q0, int bq, int n_q, int S,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = 0;
  hi = (S + BK - 1) / BK;
  if (n_q == S) {
    const int q_last = min(q0 + bq, n_q) - 1;
    if (causal) hi = min(hi, q_last / BK + 1);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, warp specialisation.
// ---------------------------------------------------------------------------

// Consumer warpgroups per block, 64 query rows each.
constexpr int kConsumers = 2;
// Whether the consumer warpgroups take turns at issuing their products
// (named barriers), so that one's softmax runs under the other's products.
constexpr bool kPingPong = true;
// Whether a warpgroup issues tile i's Q K^T beside tile i - 1's P V and
// runs tile i's softmax under that P V.
constexpr bool kOverlap = true;

// Keys per tile: 128, or 64 at hd 256, where the O accumulator (128
// registers a thread) leaves room for 32 of scores and 32 of p.
template <int HD>
__host__ __device__ constexpr int bf16_block_k() {
  return HD == 256 ? 64 : 128;
}

// Stages of the K / V ring: two fit at every width (a third does not at
// hd 256).
template <int HD>
__host__ __device__ constexpr int bf16_stages() {
  return 2;
}

template <int HD>
struct Tiles {
  static constexpr int BQ = 64 * kConsumers;
  static constexpr int BK = bf16_block_k<HD>();
  static constexpr int STAGES = bf16_stages<HD>();
  static constexpr int NB = (HD + 63) / 64;     // 64-column boxes of a row
  static constexpr int PVN = HD;                // N of P V (a multiple of 8)
  static constexpr int KS = HD / 16;            // k-steps of Q K^T
  static constexpr int Q_BOX = BQ * 128;        // bytes of one Q box
  static constexpr int KV_BOX = BK * 128;       // bytes of one K or V box
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, then k_full, v_full, k_empty and v_empty per stage
  static constexpr int BARS = 1 + 4 * STAGES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * BARS;  // 1,024 to align
  static constexpr int THREADS = 128 * (kConsumers + 1);
  static_assert(HD % 16 == 0 && HD <= 256, "wgmma k-steps of 16, N <= 256");
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(!kPingPong || kConsumers == 2, "turns of two warpgroups");
};

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
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n"
               "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// st.shared writes through the generic proxy; wgmma and TMA read shared
// memory through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving an accumulator wgmma is writing.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma descriptor of a K-major operand (Q, K) in 64-column boxes with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart
// (SBO).  A k-step of 16 columns advances the address by 32 bytes.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
// wgmma descriptor of the MN-major operand V (keys are K, hd is N): each
// 64-column box holds 8-key groups 1,024 bytes apart (SBO), the boxes are
// `box_bytes` apart (LBO).  A k-step of 16 keys advances the address by
// 2,048 bytes.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t box_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(box_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The warpgroup's 64 x N f32 accumulator d: d[4 j + e] is, for the warp's
// rows 16 w .. 16 w + 15, row g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
// (g = lane / 4, t = lane % 4).
//
// d = (scale_d ? d : 0) + A (64 x 16) B (16 x N), A and B K-major bf16 in
// shared memory.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
// d += A (64 x 16) B (16 x N), A bf16 from registers (the warp's m16n8k16
// A fragment of its 16 rows), B MN-major bf16 in shared memory.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

// The shapes used: S = Q K^T at N = BK, O += P V at N = hd.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
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
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// bf16 (hi, lo) of p's pair (x, y) as two packed registers: hi = bf16(p),
// lo = bf16(p - hi) (p - hi is exact in f32).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int HD>
__global__ void __launch_bounds__(Tiles<HD>::THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o,
               float* __restrict__ lse, int n_bh, int n_q, int S, int rep,
               int n_qt, int causal, int window, float scale) {
  using L = Tiles<HD>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::K_OFF;   // [STAGES][NB][BK][128 B]
  const uint32_t v_s = base + L::V_OFF;   // [STAGES][NB][BK][128 B]
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t k_full = q_full + 8;              // + 8 s
  const uint32_t v_full = k_full + 8 * L::STAGES;    // + 8 s
  const uint32_t k_empty = v_full + 8 * L::STAGES;   // + 8 s
  const uint32_t v_empty = k_empty + 8 * L::STAGES;  // + 8 s

  // Tile-major, the longest causal tiles first; the query heads of a KV
  // head are adjacent blocks.
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / n_bh)) * L::BQ;
  const int kvh = bh / rep;
  int kt_lo, kt_hi;
  key_tiles<BK>(q0, L::BQ, n_q, S, causal, window, kt_lo, kt_hi);
  const int n_kt = kt_hi - kt_lo;
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * kConsumers);   // one arrival a warp
      mbar_init(v_empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // The producer: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 128 * kConsumers) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
        tma_load(q_s + b * L::Q_BOX, &tm_q, q_full, 64 * b, q0, bh);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % L::STAGES;
        const uint32_t parity = ((i / L::STAGES) & 1) ^ 1;
        const int k0 = (kt_lo + i) * BK;
        if (i >= L::STAGES) mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
          tma_load(k_s + s * L::KV_BYTES + b * L::KV_BOX, &tm_k,
                   k_full + 8 * s, 64 * b, k0, kvh);
        if (i >= L::STAGES) mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
          tma_load(v_s + s * L::KV_BYTES + b * L::KV_BOX, &tm_v,
                   v_full + 8 * s, 64 * b, k0, kvh);
      }
    }
  } else {
    // A consumer warpgroup: query rows row0 .. row0 + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wt = tid % 128;
    const int warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;   // accumulator row / column pair
    const int row0 = 64 * wg;
    const int r_lo = q0 + row0 + 16 * warp;   // the warp's first query row
    const float c2 = scale * 1.4426950408889634f;   // scale * log2(e)

    float o[L::PVN / 2];
    float sc[BK / 2];                 // scores, then p, of one key tile
    uint32_t ph[BK / 16][4], pl[BK / 16][4];   // p's A fragments, hi / lo
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.0f, 0.0f};   // this lane's share of the row sums
#pragma unroll
    for (int i = 0; i < L::PVN / 2; ++i) o[i] = 0.0f;

    // The steps of key tile i (stage i % STAGES).
    // S = Q K^T for the warpgroup's 64 rows and the tile's BK keys, left
    // unscaled (the softmax folds the scale into its exponent); issued,
    // not waited for.
    auto issue_qk = [&](int i) {
      const int s = i % L::STAGES;
      const uint32_t kt_s = k_s + s * L::KV_BYTES;
      mbar_wait(k_full + 8 * s, (i / L::STAGES) & 1);
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::KS; ++kk)
        wgmma_ss<BK>(sc,
                     desc_k_major(q_s + (kk >> 2) * L::Q_BOX + row0 * 128 +
                                  (kk & 3) * 32),
                     desc_k_major(kt_s + (kk >> 2) * L::KV_BOX +
                                  (kk & 3) * 32),
                     kk > 0);
      wgmma_commit();
    };
    // O += P_hi V + P_lo V; issued, not waited for.
    auto issue_pv = [&](int i) {
      const int s = i % L::STAGES;
      const uint32_t vt_s = v_s + s * L::KV_BYTES;
      mbar_wait(v_full + 8 * s, (i / L::STAGES) & 1);
      pin(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<L::PVN>(o, ph[kk],
                         desc_mn_major(vt_s + kk * 2048, L::KV_BOX));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<L::PVN>(o, pl[kk],
                         desc_mn_major(vt_s + kk * 2048, L::KV_BOX));
      wgmma_commit();
    };
    // Masks and the online softmax of tile i's scores (waited for): sc
    // becomes p, m and l move on, alpha rescales O.
    auto softmax = [&](int i, float (&alpha)[2]) {
      const int k0 = (kt_lo + i) * BK;
      const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > r_lo) ||
                          (window > 0 && k0 <= r_lo + 15 - window);
      if (masked) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * tq + (e & 1);
            const int qp = r_lo + g + 8 * (e >> 1);
            if (kp >= S)
              sc[4 * j + e] = -INFINITY;
            else if ((causal && qp < kp) || (window > 0 && kp <= qp - window))
              sc[4 * j + e] = kNeg;
          }
      }
      // Rows g (e = 0, 1) and g + 8 (e = 2, 3).  The max commutes with
      // the positive scale, and e^{(s - m) scale} = 2^{(s - m) scale log2
      // e}: one subtract, one multiply, one ex2.  A masked score is -1e30
      // here as there, so -1e30 - -1e30 = 0 still gives the TPU's ones for
      // a row that has no real key yet.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mc = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mc = fmaxf(mc, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
        const float mn = fmaxf(m[r], mc);
        alpha[r] = ex2((m[r] - mn) * c2);
        m[r] = mn;
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          sc[4 * j + 2 * r] = ex2((sc[4 * j + 2 * r] - mn) * c2);
          sc[4 * j + 2 * r + 1] = ex2((sc[4 * j + 2 * r + 1] - mn) * c2);
          rs += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
        }
        l[r] = alpha[r] * l[r] + rs;
      }
    };
    // O *= alpha (no product in flight), and p into the A fragments of
    // k-step kk (keys 16 kk .. 16 kk + 15: the accumulator's 8-column
    // tiles 2 kk and 2 kk + 1), split hi + lo.
    auto rescale_split = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int n = 0; n < L::PVN / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* p = sc + 4 * (2 * kk + h);
          split_pair(p[0], p[1], ph[kk][2 * h], pl[kk][2 * h]);
          split_pair(p[2], p[3], ph[kk][2 * h + 1], pl[kk][2 * h + 1]);
        }
    };
    // Tile i's K (or V) is read: its stage may be refilled.
    auto release = [&](uint32_t empty, int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (i % L::STAGES));
    };
    // Ping-pong: warpgroup wg issues its products between turn_begin and
    // turn_end, the other's turn in between.  Warpgroup 0 goes first, and
    // the last turn is not handed on, so every bar.sync has its arrive.
    auto turn_begin = [&] {
      if constexpr (kPingPong) bar_sync(3 + wg, 256);
    };
    auto turn_end = [&](bool last) {
      if constexpr (kPingPong) {
        if (wg == 0 || !last) bar_arrive(3 + (wg ^ 1), 256);
      }
    };
    if constexpr (kPingPong) {
      if (wg == 1) bar_arrive(3, 256);
    }

    float alpha[2];
    mbar_wait(q_full, 0);
    if constexpr (kOverlap) {
      // Tile i's Q K^T and tile i - 1's P V in flight together; tile i's
      // softmax runs under the P V.
      turn_begin();
      issue_qk(0);
      turn_end(false);
      wgmma_wait<0>();
      pin(sc);
      release(k_empty, 0);
      softmax(0, alpha);
      rescale_split(alpha);
      for (int i = 1; i < n_kt; ++i) {
        turn_begin();
        issue_qk(i);
        issue_pv(i - 1);
        turn_end(false);
        wgmma_wait<1>();   // Q K^T (the older group) is done
        pin(sc);
        release(k_empty, i);
        softmax(i, alpha);
        wgmma_wait<0>();
        pin(o);
        release(v_empty, i - 1);
        rescale_split(alpha);
      }
      turn_begin();
      issue_pv(n_kt - 1);
      turn_end(true);
      wgmma_wait<0>();
      pin(o);
      release(v_empty, n_kt - 1);
    } else {
      for (int i = 0; i < n_kt; ++i) {
        turn_begin();
        issue_qk(i);
        turn_end(false);
        wgmma_wait<0>();
        pin(sc);
        release(k_empty, i);
        softmax(i, alpha);
        rescale_split(alpha);
        turn_begin();
        issue_pv(i);
        turn_end(i + 1 == n_kt);
        wgmma_wait<0>();
        pin(o);
        release(v_empty, i);
      }
    }

    // Epilogue: the warpgroup's rows, o / max(l, 1e-30) in bf16, into its
    // own Q rows (its last product has read them) with the 128-byte
    // swizzle, then one TMA store per box.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float safe = fmaxf(lt, 1e-30f);
      const int row = row0 + 16 * warp + g + 8 * r;   // row of the tile
#pragma unroll
      for (int n = 0; n < L::PVN / 8; ++n) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(
            o[4 * n + 2 * r] / safe, o[4 * n + 2 * r + 1] / safe);
        *reinterpret_cast<__nv_bfloat162*>(
            sm + (n >> 3) * L::Q_BOX + row * 128 +
            (((n & 7) ^ (row & 7)) << 4) + 4 * tq) = pair;
      }
      // m is an unscaled max, or -1e30 for a row without a real key.
      const float ms = m[r] == kNeg ? kNeg : m[r] * scale;
      if (tq == 0 && q0 + row < n_q)
        lse[static_cast<long long>(bh) * n_q + q0 + row] = ms + logf(safe);
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if (wt == 0 && q0 + row0 < n_q) {
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
        tma_store(&tm_o, q_s + b * L::Q_BOX + row0 * 128, 64 * b, q0 + row0,
                  bh);
      tma_store_wait();
    }
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

// The tensor map of a contiguous bf16 [n, rows, hd] at `ptr`: boxes of 64
// columns by `box_rows` rows of one head, 128-byte swizzle, zeros outside.
bool tensor_map(CUtensorMap* map, const void* ptr, int n, int rows, int hd,
                int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int run_bf16(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int n_q, int S, int rep, int causal,
             int window, float scale, cudaStream_t st) {
  using L = Tiles<HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::SMEM);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  CUtensorMap tq, tk, tv, to;
  const int bkv = bh / rep;
  if (!tensor_map(&tq, q, bh, n_q, HD, L::BQ) ||
      !tensor_map(&tk, k, bkv, S, HD, L::BK) ||
      !tensor_map(&tv, v, bkv, S, HD, L::BK) ||
      !tensor_map(&to, o, bh, n_q, HD, 64))
    return int(cudaErrorInvalidValue);
  const int n_qt = (n_q + L::BQ - 1) / L::BQ;
  const long long blocks = static_cast<long long>(bh) * n_qt;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  flash_fwd_bf16<HD><<<static_cast<unsigned>(blocks), L::THREADS, L::SMEM,
                       st>>>(tq, tk, tv, to, lse, bh, n_q, S, rep, n_qt,
                             causal, window, scale);
  return int(cudaGetLastError());
}

template <int HD>
int launch(int is_bf16, const void* q, const void* k, const void* v,
           void* o, float* lse, int bh, int n_q, int S, int rep, int causal,
           int window, float scale, cudaStream_t st) {
  static bool f32_configured = false;
  if (is_bf16) {
    // TMA reads and writes 16-byte aligned tensors.
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
        15)
      return int(cudaErrorMisalignedAddress);
    return run_bf16<HD>(q, k, v, o, lse, bh, n_q, S, rep, causal, window,
                        scale, st);
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
