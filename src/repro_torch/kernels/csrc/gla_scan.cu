// Chunked gated linear recurrence for Hopper (sm_90a): the SSD / mLSTM
// primitive, f32 arithmetic on the CUDA cores.
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
// once the decays are large.
//
// Design.  The TPU walks the chunks on its sequential grid axis; here one
// block of 256 threads per (bh, 64-column slice of dv) walks them in a loop,
// holding its [dk, 64] slice of S (and the whole n) in shared memory.  Each
// slice computes n, which depends only on k and a, and slice 0 writes it.
// The TPU holds a whole chunk and its W x W decay and score matrices in
// its on-chip memory; at W = 256 that is 768 KB in f32, which no Hopper
// block has.  So the intra-chunk term is built per (64-row query sub-tile,
// 64-row key sub-tile at or before it): scores [64, 64] go through shared
// memory to the P.V product and the W x W matrix is never stored.  The
// cumsum runs in one warp (a sequential run per lane, then a shuffle scan).
// A ragged last chunk (T not a multiple of W) is padded with zero k, v and
// a, as repro.models.lm.gla.chunked_gla pads: padded steps leave the state
// untouched and their outputs are not written.
//
// Shared memory per block (f32): state [DKP][64], Q and K sub-tiles
// [64][DKP + 1], V [64][64], P [64][65], n [DKP], and 2 W floats of
// cumsum and state weights, with DKP = 64 for dk <= 64 and 128 for
// dk <= 128: 83,968 B at dk = 64, W = 128 (2 blocks per SM), 84,992 B at
// dk = 64, W = 256, and 134,400 B at dk = 128, W = 256 (1 block per SM),
// of the 227 KB a block may take.
//
// Bound on this card: the chunked work (_gla_flops of the JAX layer stack)
// is small against the bytes (q, k, v, y once each, plus the states), so
// the bound is bytes at 3.35 TB/s, or the tensor cores for large W.  What
// holds this kernel back: every product runs on the CUDA cores in f32 from
// shared memory, the blocks of one head re-read q and k per dv slice, the
// key sub-tiles are loaded again for the state update, and the chunk loop
// is serial inside a block with no copy overlapping compute.  wgmma on bf16
// sub-tiles, with the next chunk's tiles loaded by TMA during this chunk's
// products, is the later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <int DKP>
int smem_bytes(int W) {
  const int floats = DKP * kTile + 2 * kTile * (DKP + 1) + kTile * kTile +
                     kTile * (kTile + 1) + DKP + 2 * W;
  return floats * static_cast<int>(sizeof(float));
}

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

template <typename T, int DKP>
__global__ void __launch_bounds__(kThreads)
gla_fwd(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ a,
        T* __restrict__ y, float* __restrict__ S_out,
        float* __restrict__ n_out, int n_t, int dk, int dv, int W,
        int n_slices, int normalize) {
  constexpr int KP = DKP + 1;
  constexpr int NI = DKP / 16;          // state rows per thread
  extern __shared__ float smem[];
  float* Ss = smem;                     // [DKP][kTile] state slice
  float* Qs = Ss + DKP * kTile;         // [kTile][KP]
  float* Ks = Qs + kTile * KP;          // [kTile][KP]
  float* Vs = Ks + kTile * KP;          // [kTile][kTile]
  float* Ps = Vs + kTile * kTile;       // [kTile][kTile + 1]
  float* ns = Ps + kTile * (kTile + 1); // [DKP]
  float* ca = ns + DKP;                 // [W]
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

  for (int e = tid; e < DKP * kTile; e += kThreads) Ss[e] = 0.0f;
  for (int e = tid; e < DKP; e += kThreads) ns[e] = 0.0f;

  const int n_chunks = (n_t + W - 1) / W;
  const int n_sub = (W + kTile - 1) / kTile;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const long long t0 = static_cast<long long>(chunk) * W;
    __syncthreads();  // the previous chunk's state update is stored
    if (tid < 32) {   // inclusive cumsum of a over the chunk, in one warp
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
    __syncthreads();
    const float tot = ca[W - 1];

    // ---- outputs, one 64-row query sub-tile at a time -------------------
    for (int qs = 0; qs < n_sub; ++qs) {
      const int i0 = qs * kTile;
      __syncthreads();  // Qs, Ks, Vs, Ps of the previous sub-tile consumed
      load_tile(Qs, KP, qb, dk, 0, dk, t0, i0, W, n_t);
      __syncthreads();
      float acc[4][4], den[4];
      // inter-chunk term: e^{ca_i} q_i S_in (and q_i n_in)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        den[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      for (int d = 0; d < dk; ++d) {
        float qv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * KP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = Ss[d * kTile + tx + 16 * j];
        const float nv = ns[d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          den[i] = fmaf(qv[i], nv, den[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], sv[j], acc[i][j]);
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
        __syncthreads();
        load_tile(Ks, KP, kb, dk, 0, dk, t0, j0, W, n_t);
        load_tile(Vs, kTile, vb, dv, c0, kTile, t0, j0, W, n_t);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
        for (int d = 0; d < dk; ++d) {
          float qv[4], kv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * KP + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
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
            Ps[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = s;
            rs += s;
          }
          if (normalize) den[i] += half_warp_sum(rs);
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kTile; ++kk) {
          float pv[4], vv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kTile + 1) + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kTile + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
      }
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

    // ---- state update ----------------------------------------------------
    for (int i = tid; i < W; i += kThreads) wf[i] = expf(tot - ca[i]);
    const float gt = expf(tot);
    float snew[NI][4];
#pragma unroll
    for (int ii = 0; ii < NI; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        snew[ii][j] = gt * Ss[(ty + 16 * ii) * kTile + tx + 16 * j];
    float nnew = tid < DKP ? gt * ns[tid] : 0.0f;
    for (int ks = 0; ks < n_sub; ++ks) {
      const int j0 = ks * kTile;
      __syncthreads();
      load_tile(Ks, KP, kb, dk, 0, dk, t0, j0, W, n_t);
      load_tile(Vs, kTile, vb, dv, c0, kTile, t0, j0, W, n_t);
      __syncthreads();
      const int rows = min(kTile, W - j0);
      for (int kk = 0; kk < rows; ++kk) {
        const float w = wf[j0 + kk];
        float vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kTile + tx + 16 * j];
#pragma unroll
        for (int ii = 0; ii < NI; ++ii) {
          const float kd = Ks[kk * KP + ty + 16 * ii] * w;
#pragma unroll
          for (int j = 0; j < 4; ++j) snew[ii][j] = fmaf(kd, vv[j], snew[ii][j]);
        }
        if (tid < DKP) nnew = fmaf(Ks[kk * KP + tid], w, nnew);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < NI; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * ii) * kTile + tx + 16 * j] = snew[ii][j];
    if (tid < DKP) ns[tid] = nnew;
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

template <typename T, int DKP>
int launch(const void* q, const void* k, const void* v, const float* a,
           void* y, float* S, float* n, int bh, int n_t, int dk, int dv,
           int W, int normalize, cudaStream_t st) {
  const int bytes = smem_bytes<DKP>(W);
  static bool configured = false;  // once, for the largest chunk taken
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gla_fwd<T, DKP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<DKP>(kMaxChunk));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const int n_slices = (dv + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(bh) * n_slices;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  gla_fwd<T, DKP><<<static_cast<unsigned>(blocks), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), a, static_cast<T*>(y), S, n, n_t, dk, dv, W,
      n_slices, normalize);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_dk(const void* q, const void* k, const void* v, const float* a,
                void* y, float* S, float* n, int bh, int n_t, int dk, int dv,
                int W, int normalize, cudaStream_t st) {
  if (dk <= 64)
    return launch<T, 64>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W, normalize,
                         st);
  return launch<T, 128>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W, normalize,
                        st);
}

}  // namespace

// q, k: [bh, n_t, dk]; v: [bh, n_t, dv], all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1); a: [bh, n_t] f32 log-decays; all contiguous.  y: [bh, n_t,
// dv] in v's dtype; S: [bh, dk, dv] f32; n: [bh, dk] f32.  1 <= dk <= 128,
// 1 <= W <= 4096 (the chunk).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int gla_scan_fwd(const void* q, const void* k, const void* v,
                            const float* a, void* y, float* S, float* n,
                            int is_bf16, int bh, int n_t, int dk, int dv,
                            int W, int normalize, void* stream) {
  if (bh <= 0 || n_t <= 0 || dk <= 0 || dk > 128 || dv <= 0 || W <= 0 ||
      W > kMaxChunk)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dk<__nv_bfloat16>(q, k, v, a, y, S, n, bh, n_t, dk, dv,
                                      W, normalize, st);
  return dispatch_dk<float>(q, k, v, a, y, S, n, bh, n_t, dk, dv, W,
                            normalize, st);
}
