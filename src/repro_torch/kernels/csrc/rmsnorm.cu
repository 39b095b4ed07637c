// Fused RMSNorm and RMSNorm-with-residual for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/rmsnorm.py::rmsnorm (kernel
// _kernel, :17) and ::rmsnorm_residual (kernel _kernel_residual, :24).
//
// What it computes, per row of x (n, d), in float32 whatever the I/O type:
//   rmsnorm:           y = x * rsqrt(mean(x*x) + eps) * scale, rounded once to x's type
//   rmsnorm_residual:  s = x + residual (float32); r_out = s rounded to x's type;
//                      y = s * rsqrt(mean(s*s) + eps) * scale (the norm of the
//                      float32 sum, as the TPU kernel takes it), rounded once.
//
// Bound on this card: bytes.  One read of each input element and one write of
// each output element at ~1 flop/byte, far below the ridge.
//
// rmsnorm has two kernels; the wrapper picks one by shape and alignment:
//
// - rmsnorm_warp_kernel<T, V> (d a multiple of 16 bytes, x and scale
//   16-byte aligned, d <= 32 lanes x V vectors): one warp per row, 4 rows
//   per block, no block barrier.  Each lane loads its V 16-byte vectors of
//   the row (lane-interleaved, so a warp reads 512 contiguous bytes per
//   vector) into registers in one go, sums their squares in a fixed order,
//   and the warp adds the lanes' sums by shuffles (a fixed tree), so every
//   row is summed the same way on every run and device memory sees each
//   element once.  scale is read as float4.  V is a template parameter,
//   instantiated for the widths of the configs (d 2560, 3584, 4096, 5120 up
//   to 8192 in bf16; up to 4096 in float32), the last vectors masked.
// - rmsnorm_kernel<T> (everything else: d not a multiple of 8 (bf16) or 4
//   (float32), a misaligned pointer, or a wider d): one 256-thread block per
//   row, threads striding over the row, a block reduction, a second pass
//   that re-reads the row (from L1/L2).
//
// rmsnorm_residual keeps the second shape.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch.  dtype: 0 = float32, 1 = bfloat16 (x, residual and outputs
// share it); scale is float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 32;  // 16-byte vectors per lane of the warp kernel: 8192 bf16, 4096 fp32

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v) {
  __shared__ float part[kThreads / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? part[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) w += __shfl_xor_sync(0xffffffffu, w, off);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int64_t d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.0f;
  for (int64_t j = threadIdx.x; j < d; j += kThreads) {
    const float v = to_f32(xr[j]);
    ss += v * v;
  }
  const float var = block_sum(ss) / static_cast<float>(d);
  const float r = rsqrtf(var + eps);
  for (int64_t j = threadIdx.x; j < d; j += kThreads) {
    orow[j] = from_f32<T>(to_f32(xr[j]) * r * scale[j]);
  }
}

constexpr int kRowsPerBlock = 4;  // warps, one row each

// 16 bytes of T as E floats, and back
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// 16 bytes of a row that is read once: not kept in L1, and L2 fetches the
// surrounding 256 bytes (a warp's vector spans 512)
__device__ __forceinline__ uint4 ld_once(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

template <typename T, int V>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, int64_t n, int d, float eps) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int nvec = d / E;  // 16-byte vectors in the row
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
  uint4 reg[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = j * 32 + lane;
    reg[j] = i < nvec ? ld_once(xr + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float f[E];
    unpack(reg[j], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss += f[e] * f[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float4* sc = reinterpret_cast<const float4*>(scale);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = j * 32 + lane;
    if (i < nvec) {
      float f[E];
      unpack(reg[j], f);
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 s4 = __ldg(sc + (i * E + e) / 4);
        f[e] = f[e] * r * s4.x;
        f[e + 1] = f[e + 1] * r * s4.y;
        f[e + 2] = f[e + 2] * r * s4.z;
        f[e + 3] = f[e + 3] * r * s4.w;
      }
      orow[i] = pack(f);
    }
  }
}

template <typename T, int V>
cudaError_t launch_warp(const void* x, const float* scale, void* out, int64_t n, int64_t d,
                        float eps, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  rmsnorm_warp_kernel<T, V><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), n, static_cast<int>(d), eps);
  return cudaGetLastError();
}

// the smallest instantiated V that holds the row: 16-byte vectors per lane
template <typename T>
cudaError_t rmsnorm_warp(const void* x, const float* scale, void* out, int64_t n, int64_t d,
                         float eps, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const int64_t v = (d / E + 31) / 32;
  if (v <= 2) return launch_warp<T, 2>(x, scale, out, n, d, eps, st);
  if (v <= 4) return launch_warp<T, 4>(x, scale, out, n, d, eps, st);
  if (v <= 8) return launch_warp<T, 8>(x, scale, out, n, d, eps, st);
  if (v <= 10) return launch_warp<T, 10>(x, scale, out, n, d, eps, st);
  if (v <= 12) return launch_warp<T, 12>(x, scale, out, n, d, eps, st);
  if (v <= 14) return launch_warp<T, 14>(x, scale, out, n, d, eps, st);
  if (v <= 16) return launch_warp<T, 16>(x, scale, out, n, d, eps, st);
  if (v <= 20) return launch_warp<T, 20>(x, scale, out, n, d, eps, st);
  if (v <= 24) return launch_warp<T, 24>(x, scale, out, n, d, eps, st);
  if (v <= 28) return launch_warp<T, 28>(x, scale, out, n, d, eps, st);
  if (v <= kMaxVec) return launch_warp<T, kMaxVec>(x, scale, out, n, d, eps, st);
  return cudaErrorInvalidValue;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_residual_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const float* __restrict__ scale, T* __restrict__ out,
                        T* __restrict__ r_out, int64_t d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* rr = res + row * d;
  float ss = 0.0f;
  for (int64_t j = threadIdx.x; j < d; j += kThreads) {
    const float s = to_f32(xr[j]) + to_f32(rr[j]);
    r_out[row * d + j] = from_f32<T>(s);
    ss += s * s;
  }
  const float var = block_sum(ss) / static_cast<float>(d);
  const float r = rsqrtf(var + eps);
  for (int64_t j = threadIdx.x; j < d; j += kThreads) {
    const float s = to_f32(xr[j]) + to_f32(rr[j]);
    out[row * d + j] = from_f32<T>(s * r * scale[j]);
  }
}

}  // namespace

extern "C" {

// warp: 1 for the warp-per-row kernel (the wrapper checks its conditions),
// 0 for the block-per-row kernel
int rmsnorm(const void* x, const float* scale, void* out, int64_t n, int64_t d,
            float eps, int dtype, int warp, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {
    return static_cast<int>(dtype == 1
        ? rmsnorm_warp<__nv_bfloat16>(x, scale, out, n, d, eps, st)
        : rmsnorm_warp<float>(x, scale, out, n, d, eps, st));
  }
  if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), scale, static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    rmsnorm_kernel<float><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
        static_cast<const float*>(x), scale, static_cast<float*>(out), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

int rmsnorm_residual(const void* x, const void* res, const float* scale, void* out,
                     void* r_out, int64_t n, int64_t d, float eps, int dtype,
                     void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    rmsnorm_residual_kernel<__nv_bfloat16><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(res), scale,
        static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(r_out), d, eps);
  } else {
    rmsnorm_residual_kernel<float><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(res), scale,
        static_cast<float*>(out), static_cast<float*>(r_out), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
