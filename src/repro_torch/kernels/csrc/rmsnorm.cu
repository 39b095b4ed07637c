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
// each output element at ~1 flop/byte, far below the ridge.  Design: one
// block per row (a full-width forward has 4096 rows, enough blocks for 132
// SMs), threads striding over the row so that a warp touches consecutive
// elements; the float32 sum of squares is reduced with warp shuffles and one
// shared-memory step.  The second pass re-reads the row, which a 2560-wide
// row leaves in L1/L2, so device memory sees each element once.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch.  dtype: 0 = float32, 1 = bfloat16 (x, residual and outputs
// share it); scale is float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

int rmsnorm(const void* x, const float* scale, void* out, int64_t n, int64_t d,
            float eps, int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
