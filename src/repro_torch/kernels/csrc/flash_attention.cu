// Flash-attention forward for Hopper (sm_90a): online softmax, GQA,
// causal and sliding-window masks, f32 arithmetic on the CUDA cores.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel behind repro.kernels.flash_attention.flash_attention_fwd).
// For each query head bh (KV head bh / rep, never materialised) and query
// position t:
//
//     s_j  = (q_t * scale) . k_j           scale = 1 / sqrt(hd)
//     s_j  = -1e30 where masked            causal: j <= t; window: j > t - window
//     o_t  = sum_j e^{s_j - m} v_j / max(l, 1e-30),   l = sum_j e^{s_j - m}
//     lse_t = m + log(max(l, 1e-30))
//
// o is written in q's dtype and lse in f32 [BH, T] (no lane padding).
//
// Design: one block of 256 threads per (bh, 64-row query tile).  The block
// stages its scaled Q tile once, then walks 64-key K/V tiles through shared
// memory (converted to f32 on load), keeping the running max, sum and the
// [64, hd] accumulator in registers: thread (ty, tx) of a 16 x 16 grid owns
// rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output
// columns tx + 16 j (j < hd / 16).  Row max and row sum reduce over the 16
// lanes that share a row.  Ragged T and S edges are masked here: rows past
// T are computed on zeros and never written, keys past S get a score of
// -inf, so they add nothing even to a row whose keys are all masked (which
// then averages v over the real keys, as the TPU kernel does).
//
// Key tiles that the causal or window mask hides from every row of the
// query tile are skipped when T == S.  That gives the TPU kernel's result:
// there a masked tile adds e^{-1e30 - m} = 0 once a real key has set m, or
// ones that the first real key wipes with alpha = e^{-1e30 - m} = 0, and
// with T == S every row has a real key (its own position).
//
// Shared memory per block (f32): Q and K tiles [64][hd + 1] (the pad keeps
// the column reads of the QK^T loop on distinct banks), V [64][hd] and
// P [64][65]: 115,456 B at hd = 128, 103,168 B at hd = 112, 66,816 B at
// hd = 64, of the 227 KB a block may take (1, 2 and 3 blocks per SM).
//
// Bound on this card: the work is 4 T S hd BH multiply-adds-as-FLOPs
// (halved by the causal mask) against 2 (T + 2 S) hd BH + 4 T BH bytes, far
// above the H100's ridge point, so the bound is the tensor cores' 989
// TFLOP/s (bf16) or the CUDA cores' 67 TFLOP/s (f32).  What holds this
// kernel back: it runs every product on the CUDA cores in f32 from shared
// memory (two shared loads per FMA pair), one block per SM at hd = 128, and
// no copy overlaps compute.  wgmma on bf16 tiles fed by TMA, with the
// softmax of one tile overlapping the products of the next, is the later
// design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int n_q, int S, int rep, int n_qt,
          int causal, int window, float scale) {
  constexpr int QP = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][QP]
  float* Ks = Qs + kBQ * QP;        // [kBK][QP]
  float* Vs = Ks + kBK * QP;        // [kBK][HD]
  float* Ps = Vs + kBK * HD;        // [kBQ][kBK + 1]

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBQ;
  const int kvh = bh / rep;
  const T* qb = q + static_cast<long long>(bh) * n_q * HD;
  const T* kb = k + static_cast<long long>(kvh) * S * HD;
  const T* vb = v + static_cast<long long>(kvh) * S * HD;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    Qs[r * QP + d] = q0 + r < n_q
        ? load(qb + static_cast<long long>(q0 + r) * HD + d) * scale : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  int kt_lo = 0;
  int kt_hi = (S + kBK - 1) / kBK;
  if (n_q == S) {
    const int q_last = min(q0 + kBQ, n_q) - 1;
    if (causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD;
      const bool in = k0 + r < S;
      const long long off = static_cast<long long>(k0 + r) * HD + d;
      Ks[r * QP + d] = in ? load(kb + off) : 0.0f;
      Vs[r * HD + d] = in ? load(vb + off) : 0.0f;
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
    T* orow = o + (static_cast<long long>(bh) * n_q + r) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(orow + tx + 16 * j, acc[i][j] / safe);
    if (tx == 0) lse[static_cast<long long>(bh) * n_q + r] = m[i] + logf(safe);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int n_q, int S, int rep, int causal, int window,
           float scale, cudaStream_t st) {
  const int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  static bool configured = false;  // once, outside any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const int n_qt = (n_q + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(bh) * n_qt;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  flash_fwd<T, HD><<<static_cast<unsigned>(blocks), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n_q, S, rep, n_qt,
      causal, window, scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int n_q, int S, int rep, int causal,
                int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, n_q, S, rep, causal, window,
                           scale, st);
    case 112:
      return launch<T, 112>(q, k, v, o, lse, bh, n_q, S, rep, causal,
                            window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, n_q, S, rep, causal,
                            window, scale, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [bh, n_q, hd]; k, v: [bkv, S, hd], all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1), contiguous; bh = bkv * rep.  o: [bh, n_q, hd] in q's dtype;
// lse: [bh, n_q] f32.  hd is 64, 112 or 128.  window <= 0 means no window.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int is_bf16, int bh, int bkv, int n_q,
                                   int S, int hd, int causal, int window,
                                   float scale, void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv != 0 || n_q <= 0 || S <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = bh / bkv;
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, bh, n_q, S, rep,
                                      causal, window, scale, st);
  return dispatch_hd<float>(hd, q, k, v, o, lse, bh, n_q, S, rep, causal,
                            window, scale, st);
}
