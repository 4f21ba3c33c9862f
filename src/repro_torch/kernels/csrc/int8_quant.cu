// Per-row absmax int8 quantizer for Hopper (sm_90a).
//
// Replaces src/repro/kernels/int8_quant.py::_quant_kernel (the Pallas TPU
// kernel behind repro.kernels.int8_quant.quantize_int8).  For each row i of
// x [M, N]:
//
//     scale_i = max(max_j |x_ij|, 1e-30) / 127
//     q_ij    = clip(floor(x_ij / scale_i + u_ij), -127, 127)   as int8
//
// with u either an f32 [M, N] tensor (stochastic rounding) or one constant
// (0.5 on the wire codec, which then never materialises a [M, N] tensor).
//
// Numerics match the plain PyTorch version bit for bit: true IEEE division
// (no --use_fast_math, never a multiply by 127/absmax), floorf(. + u) rather
// than round-half-even, and a NaN in a row propagates into its scale as
// jnp.max does (fmaxf alone would drop it).  A NaN code is written as 0, as
// XLA's float->int conversion does.
//
// Bound: bytes.  Each element is read once as f32 (4 B; bf16: 2 B) and
// written once as int8 (1 B), plus 4 B more when u is a tensor; at the
// H100's 3.35 TB/s that is the floor.  The design is the simple one: one
// block of 256 threads per row, pass 1 a strided absmax reduced through
// warp shuffles and shared memory, pass 2 the quantization of the same row
// (its second read mostly hits L2).  One block per row fills only as many
// SMs as there are rows: at the wire's main-path shape (39 samples of
// 50,176 elements) that is 39 of the 132 SMs.  A row-split two-pass design
// (partial maxima per row slice, then quantize) is the later fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max that keeps a NaN from either side, as jnp.max / jnp.maximum do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_rows(const T* __restrict__ x, const float* __restrict__ u, float u_const,
           int8_t* __restrict__ q, float* __restrict__ scale, long long n) {
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  const float* ur = u == nullptr ? nullptr : u + row * n;
  int8_t* qr = q + row * n;

  // Pass 1: row absmax.
  float m = 0.0f;
  for (long long j = threadIdx.x; j < n; j += kThreads) {
    m = nan_max(m, fabsf(to_f32(xr[j])));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_scale;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) {
      const float s = nan_max(m, 1e-30f) / 127.0f;
      row_scale = s;
      scale[row] = s;
    }
  }
  __syncthreads();
  const float s = row_scale;

  // Pass 2: quantize.
  for (long long j = threadIdx.x; j < n; j += kThreads) {
    const float uj = ur == nullptr ? u_const : ur[j];
    const float v = floorf(to_f32(xr[j]) / s + uj);
    qr[j] = v != v ? int8_t(0)
                   : static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
}

}  // namespace

// x: [m, n] f32 (x_is_bf16 = 0) or bf16 (x_is_bf16 = 1), row-major.
// u: [m, n] f32 row-major, or NULL to use u_const for every element.
// q: [m, n] int8; scale: [m] f32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int int8_quant_rows(const void* x, int x_is_bf16, const float* u,
                               float u_const, int8_t* q, float* scale,
                               long long m, long long n, void* stream) {
  if (m <= 0 || n <= 0 || m > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    quant_rows<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), u, u_const, q, scale, n);
  } else {
    quant_rows<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), u, u_const, q, scale, n);
  }
  return int(cudaGetLastError());
}
