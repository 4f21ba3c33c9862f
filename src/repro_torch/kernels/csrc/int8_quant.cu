// Per-row absmax int8 quantizer, and the int8 wire's fused
// quantize->dequantize, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/int8_quant.py::_quant_kernel (the Pallas TPU
// kernel behind repro.kernels.int8_quant.quantize_int8) and, for the wire,
// its composition with dequantize_int8 and the cast back to x's dtype in
// src/repro/kernels/ops.py::wire_qdq_int8.  For each row i of x [M, N]:
//
//     scale_i = max(max_j |x_ij|, 1e-30) / 127
//     q_ij    = clip(floor(x_ij / scale_i + u_ij), -127, 127)   as int8
//     wire_ij = T(float(q_ij) * scale_i)                  (T = x's dtype)
//
// with u either an f32 [M, N] tensor (stochastic rounding) or one constant
// (0.5 on the wire, which then never materialises a [M, N] tensor).
// int8_quant_rows writes q and scale; int8_wire_qdq writes only the wire
// values and never q.
//
// Numerics match the plain PyTorch version bit for bit: x / s rounded as
// the IEEE division rounds it (no --use_fast_math, never a plain multiply
// by 127/absmax; see quotient() below), floorf(. + u) rather than
// round-half-even, and a NaN in a row propagates into its scale as
// jnp.max does (fmaxf alone would drop it).  A NaN code is written as 0, as
// XLA's float->int conversion does.  The wire value is the product of the
// integer code and the scale, rounded once to T (__float2bfloat16_rn for
// bf16), as q.float() * scale then .to(bf16) rounds it.
//
// Bound: bytes.  Each element is read once as f32 (4 B; bf16: 2 B) and
// written once as int8 (1 B; the wire: once in x's dtype), plus 4 B more
// when u is a tensor; at the H100's 3.35 TB/s that is the floor.  What the
// design does about it:
// - Each row is split over many blocks.  The grid is M * S blocks, (row,
//   slice) pairs; the host picks S (int8_quant.py::plan_slices) so that the
//   grid has about four blocks on each of the 132 SMs, with slice edges on
//   16-byte multiples.  One block per row filled 35-39 of the SMs.
// - 16-byte loads and stores, kUnroll of them issued by each thread before
//   any is used, so about 8 MB is in flight across the card (HBM3 needs
//   about 2 MB by Little's law); scalar 2- or 4-byte loads kept about 40 KB
//   in flight.
// - Two launches.  Pass 1 (quant_rows_absmax) writes one partial maximum
//   per (row, slice) to an [M, S] f32 scratch: no atomics, no zero fill,
//   and max is order-free, so the split keeps bitwise equality.  Pass 2
//   (quant_rows_apply) has each warp reduce its row's S partials to the
//   scale on its own (no block barrier), then maps its slice; its read of
//   x can hit the 50 MB L2 (the bf16 wire tensor is 18.4 MB).
// - The wire entry writes T(q * scale) straight from pass 2: 8 B per
//   element on f32 and 4 B on bf16 instead of the 19 B (bf16) that q, the
//   f32 dequantize and the cast moved as three PyTorch passes.
// - No division per element.  The IEEE division is a reciprocal on the
//   quarter-rate special-function unit plus a checked refinement, per
//   element; it held the second launch above its byte time.  quotient()
//   takes the reciprocal once per thread and refines x * y with two FMA
//   corrections.
// - A row whose start is not on a 16-byte boundary (N * sizeof(T) not a
//   multiple of 16) takes scalar head elements up to the first boundary,
//   and every slice a scalar tail.  When a base pointer is not 16-byte
//   aligned (a storage offset), every element takes the scalar path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // 16-byte loads each thread has in flight
constexpr int kMinBlocks = 4;  // resident blocks per SM: <= 64 registers

// 16 bytes of T as kVec floats, and back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // Little-endian: the low half of each word is the lower element; a bf16
  // is the top half of the f32 with the same bits, so widening is exact.
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// max that keeps a NaN from either side, as jnp.max / jnp.maximum do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

// A row's scale s with its reciprocal y = RN(1 / s), taken once per
// thread, and the magnitude above which quotient() may use it.
struct Divisor {
  float s, y, tiny;
};

__device__ __forceinline__ Divisor divisor(float s) {
  const bool finite = fabsf(s) <= 3.402823466e38f;
  const float inf = __int_as_float(0x7f800000);
  return {s, 1.0f / s, finite ? fmaxf(0x1p-100f, s * 0x1p-100f) : inf};
}

// x / s rounded to nearest, bit for bit what the IEEE division gives,
// without a reciprocal per element: q = x * y, then two corrections
// q += (x - q * s) * y with the residual exact in an FMA (Markstein).
// Where a residual or the quotient could underflow (|x| <= d.tiny),
// where s is not finite and where x is NaN, it divides.
// check_quotient_kernel holds it against the division on the card.
__device__ __forceinline__ float quotient(float x, const Divisor& d) {
  if (!(fabsf(x) > d.tiny)) return x / d.s;
  float q = x * d.y;
  q = fmaf(fmaf(-q, d.s, x), d.y, q);
  return fmaf(fmaf(-q, d.s, x), d.y, q);
}

// The integer code of x at scale d.s and noise u (NaN -> 0), as an int.
__device__ __forceinline__ int code(float x, const Divisor& d, float u) {
  const float v = floorf(quotient(x, d) + u);
  return v != v ? 0 : static_cast<int>(fminf(fmaxf(v, -127.0f), 127.0f));
}

// The elements of one (row, slice): [j0, jb) and [je, j1) scalar, [jb, je)
// whole 16-byte vectors.  tests/test_torch_quant_wire.py mirrors the split.
struct Span {
  long long j0, jb, je, j1;
};

template <int V>
__device__ __forceinline__ Span span(long long row, long long n, int s,
                                     long long slice, bool vec_ok) {
  Span p;
  p.j0 = s * slice;
  p.j1 = min(p.j0 + slice, n);
  if (vec_ok) {
    const long long mis = (row * n + p.j0) % V;
    p.jb = min(p.j0 + (mis ? V - mis : 0), p.j1);
  } else {
    p.jb = p.j1;
  }
  p.je = p.jb + (p.j1 - p.jb) / V * V;
  return p;
}

// Pass 1: partial[row * S + s] = max |x| over the slice (NaN-propagating).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quant_rows_absmax(const T* __restrict__ x, long long n, long long slice,
                  int S, bool vec_ok, float* __restrict__ partial) {
  constexpr int V = Vec<T>::kVec;
  const long long row = blockIdx.x / S;
  const int s = blockIdx.x % S;
  const T* xr = x + row * n;
  const Span p = span<V>(row, n, s, slice, vec_ok);

  float m = 0.0f;
  for (long long j = p.j0 + threadIdx.x; j < p.jb; j += kThreads) {
    m = nan_max(m, fabsf(to_f32(xr[j])));
  }
  for (long long j = p.je + threadIdx.x; j < p.j1; j += kThreads) {
    m = nan_max(m, fabsf(to_f32(xr[j])));
  }
  const uint4* xv = reinterpret_cast<const uint4*>(xr + p.jb);
  const long long nv = (p.je - p.jb) / V;
  for (long long i0 = threadIdx.x; i0 < nv; i0 += kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + k * kThreads;
      r[k] = i < nv ? __ldg(xv + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      float f[V];
      Vec<T>::unpack(r[k], f);
#pragma unroll
      for (int e = 0; e < V; ++e) m = nan_max(m, fabsf(f[e]));
    }
  }

  m = warp_max(m);
  __shared__ float warp_m[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < kThreads / 32 ? warp_m[lane] : 0.0f);
    if (lane == 0) partial[blockIdx.x] = m;
  }
}

// Pass 2: the row's scale from its S partials, then the slice's codes:
// q and scale (kWire false) or T(q * scale) (kWire true); the noise is u
// (kNoise) or u_const.
template <typename T, bool kWire, bool kNoise>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quant_rows_apply(const T* __restrict__ x, const float* __restrict__ u,
                 float u_const, const float* __restrict__ partial,
                 int8_t* __restrict__ q, float* __restrict__ scale,
                 T* __restrict__ out, long long n, long long slice, int S,
                 bool vec_ok) {
  constexpr int V = Vec<T>::kVec;
  const long long row = blockIdx.x / S;
  const int s = blockIdx.x % S;

  float m = 0.0f;
  for (int i = threadIdx.x & 31; i < S; i += 32) {
    m = nan_max(m, partial[row * S + i]);
  }
  const float sc = nan_max(warp_max(m), 1e-30f) / 127.0f;
  if constexpr (!kWire) {
    if (s == 0 && threadIdx.x == 0) scale[row] = sc;
  }
  const Divisor d = divisor(sc);

  const long long base = row * n;
  const Span p = span<V>(row, n, s, slice, vec_ok);
  auto one = [&](long long j) {
    const int c = code(to_f32(x[base + j]), d,
                       kNoise ? u[base + j] : u_const);
    if constexpr (kWire) {
      store(out + base + j, static_cast<float>(c) * sc);
    } else {
      q[base + j] = static_cast<int8_t>(c);
    }
  };
  for (long long j = p.j0 + threadIdx.x; j < p.jb; j += kThreads) one(j);
  for (long long j = p.je + threadIdx.x; j < p.j1; j += kThreads) one(j);

  const uint4* xv = reinterpret_cast<const uint4*>(x + base + p.jb);
  const long long nv = (p.je - p.jb) / V;
  for (long long i0 = threadIdx.x; i0 < nv; i0 += kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + k * kThreads;
      r[k] = i < nv ? __ldg(xv + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + k * kThreads;
      if (i >= nv) break;
      float f[V];
      Vec<T>::unpack(r[k], f);
      float uf[V];
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        const float4 w = kNoise
            ? __ldg(reinterpret_cast<const float4*>(u + base + p.jb) +
                    i * (V / 4) + h)
            : make_float4(u_const, u_const, u_const, u_const);
        uf[4 * h] = w.x;
        uf[4 * h + 1] = w.y;
        uf[4 * h + 2] = w.z;
        uf[4 * h + 3] = w.w;
      }
      int c[V];
#pragma unroll
      for (int e = 0; e < V; ++e) c[e] = code(f[e], d, uf[e]);
      if constexpr (kWire) {
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = static_cast<float>(c[e]) * sc;
        reinterpret_cast<uint4*>(out + base + p.jb)[i] = Vec<T>::pack(f);
      } else {
        uint32_t w[V / 4];
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          w[h] = static_cast<uint32_t>(c[4 * h] & 0xff) |
                 static_cast<uint32_t>(c[4 * h + 1] & 0xff) << 8 |
                 static_cast<uint32_t>(c[4 * h + 2] & 0xff) << 16 |
                 static_cast<uint32_t>(c[4 * h + 3] & 0xff) << 24;
        }
        int8_t* qp = q + base + p.jb + i * V;
        if constexpr (V == 4) {
          *reinterpret_cast<uint32_t*>(qp) = w[0];
        } else {
          *reinterpret_cast<uint2*>(qp) = make_uint2(w[0], w[1]);
        }
      }
    }
  }
}

// For each divisor s[d] and each x = +-(1 + i 2^-23) 2^(e_s + k), i over
// all 2^23 significands and k over kOffsets: counts the x whose
// quotient() differs in any bit from x / s.  The offsets put the quotient
// just above the 2^-100 cut, at 2^-24, about 1, and up to 2^7 (|x / s| <=
// 127 on the wire); scaling both by a power of two scales the quotient
// exactly, so a divisor's significand stands for every exponent.
__global__ void __launch_bounds__(kThreads)
check_quotient_kernel(const float* __restrict__ divisors,
                      unsigned long long* __restrict__ mismatches) {
  constexpr int kOffsets[6] = {-99, -24, -1, 0, 1, 6};
  const Divisor d = divisor(divisors[blockIdx.y]);
  int es;
  frexpf(d.s, &es);
  unsigned long long bad = 0;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < (1u << 23);
       i += gridDim.x * kThreads) {
    const float sig = __uint_as_float(0x3f800000u | i);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float x = ldexpf(sig, es + kOffsets[k]);
      if (isinf(x)) continue;    // |x| <= 127 s on the wire
      bad += __float_as_uint(quotient(x, d)) != __float_as_uint(x / d.s);
      bad += __float_as_uint(quotient(-x, d)) != __float_as_uint(-x / d.s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
  }
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(mismatches, bad);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Checks the (m, n, slices, slice_elems) plan: the slices tile each row
// exactly, slice edges fall on whole vectors, and the grid fits.
bool plan_ok(long long m, long long n, long long slices, long long slice,
             int vec) {
  return m > 0 && n > 0 && slices > 0 && slice > 0 && slice % vec == 0 &&
         (slices - 1) * slice < n && slices * slice >= n &&
         m * slices <= 0x7fffffffLL;
}

template <typename T, bool kWire>
int launch(const T* x, const float* u, float u_const, int8_t* q,
           float* scale, T* out, float* partial, long long m, long long n,
           long long slices, long long slice, cudaStream_t st) {
  if (!plan_ok(m, n, slices, slice, Vec<T>::kVec)) {
    return int(cudaErrorInvalidValue);
  }
  const bool vec_ok = aligned16(x) && (u == nullptr || aligned16(u)) &&
                      (q == nullptr || aligned16(q)) &&
                      (out == nullptr || aligned16(out));
  const dim3 grid(static_cast<unsigned>(m * slices));
  const int S = static_cast<int>(slices);
  quant_rows_absmax<T><<<grid, kThreads, 0, st>>>(x, n, slice, S, vec_ok,
                                                   partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (u != nullptr) {
    quant_rows_apply<T, kWire, true><<<grid, kThreads, 0, st>>>(
        x, u, u_const, partial, q, scale, out, n, slice, S, vec_ok);
  } else {
    quant_rows_apply<T, kWire, false><<<grid, kThreads, 0, st>>>(
        x, u, u_const, partial, q, scale, out, n, slice, S, vec_ok);
  }
  return int(cudaGetLastError());
}

}  // namespace

// x: [m, n] f32 (x_is_bf16 = 0) or bf16 (x_is_bf16 = 1), row-major.
// u: [m, n] f32 row-major, or NULL to use u_const for every element.
// q: [m, n] int8; scale: [m] f32; partial: [m, slices] f32 scratch.
// slices * slice_elems covers n, slice_elems a multiple of 16 bytes of x.
// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise.
extern "C" int int8_quant_rows(const void* x, int x_is_bf16, const float* u,
                               float u_const, int8_t* q, float* scale,
                               float* partial, long long m, long long n,
                               long long slices, long long slice_elems,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(x), u, u_const, q, scale, nullptr,
        partial, m, n, slices, slice_elems, st);
  }
  return launch<float, false>(static_cast<const float*>(x), u, u_const, q,
                              scale, nullptr, partial, m, n, slices,
                              slice_elems, st);
}

// The wire's round trip: out [m, n] in x's dtype = dequantize(quantize(x,
// u = 0.5)) rounded to that dtype.  Arguments as for int8_quant_rows.
extern "C" int int8_wire_qdq(const void* x, int x_is_bf16, void* out,
                             float* partial, long long m, long long n,
                             long long slices, long long slice_elems,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(x), nullptr, 0.5f, nullptr,
        nullptr, static_cast<__nv_bfloat16*>(out), partial, m, n, slices,
        slice_elems, st);
  }
  return launch<float, true>(static_cast<const float*>(x), nullptr, 0.5f,
                             nullptr, nullptr, static_cast<float*>(out),
                             partial, m, n, slices, slice_elems, st);
}

// Holds quotient() against the IEEE division for every divisor of
// divisors [n] (f32, finite, positive) over 12 * 2^23 dividends each;
// adds the count of results that differ in any bit to *mismatches (a
// zeroed u64 on the card).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int int8_check_quotients(const float* divisors, int n,
                                    unsigned long long* mismatches,
                                    void* stream) {
  if (n <= 0 || n > 65535) return int(cudaErrorInvalidValue);
  check_quotient_kernel<<<dim3(64, n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(divisors,
                                                               mismatches);
  return int(cudaGetLastError());
}
