// Flash attention forward (causal / sliding-window, GQA) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (kernel _kernel, :27; pallas_call :99).
//
// What it computes: q (B, S, H, hd), k/v (B, T, K, hd), query head h reads KV
// head h / G (G = H / K).  Scores q.k * scale in float32; keys outside the
// causal / window band get -1e30 (not -inf, so a tile whose every key is
// masked cannot make exp(m_prev - m_new) a NaN); online softmax and the PV
// accumulator in float32; l == 0 -> 1 guard; one rounding to q's type at the
// end.  Whole key tiles outside the band are skipped, as the TPU kernel skips
// its out-of-band blocks.
//
// Bound on this card: operations.  At full width (S = T = 4096, hd = 80,
// causal) the work is ~86 GFLOP per call against ~42 MB of I/O.  This first
// version runs them on the CUDA cores in float32, not on the tensor cores:
// one block of 256 threads per (q tile of 64 rows, head, batch row); the Q
// tile, one K tile and one V tile (64 keys each) are staged in shared memory
// as float32 (rows padded to an odd stride, so the 16 threads that read 16
// different K rows hit 16 different banks).  Each thread owns a 4 x 4 patch
// of the 64 x 64 score tile and a 4 x (16 * DJ) patch of the output
// accumulator, kept in registers; a row's max and sum are reduced across the
// 16 threads that share it with warp shuffles.  A wgmma/TMA version is the
// later PR's work.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); window <= 0
// means no window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPS = kBK + 1;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ __forceinline__ int padded(int hd) { return hd | 1; }

// DJ: output columns per thread in chunks of 16 (16 * DJ >= hd)
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                       int H, int K, int hd, float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int ks = padded(hd);
  float* q_s = sm;                // kBQ * ks
  float* k_s = q_s + kBQ * ks;    // kBK * ks
  float* v_s = k_s + kBK * ks;    // kBK * hd
  float* p_s = v_s + kBK * hd;    // kBQ * kPS

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / K);
  const int q_start = blockIdx.x * kBQ;
  const int q_last = min(q_start + kBQ, S) - 1;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int s = q_start + r;
    q_s[r * ks + d] = s < S ? to_f32(q[((static_cast<int64_t>(b) * S + s) * H + h) * hd + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int k_begin = 0, k_end = Tk;
  if (causal) k_end = min(Tk, q_last + 1);
  if (window > 0) k_begin = max(0, q_start - window + 1);

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int c = i / hd, d = i - c * hd;
      const int t = kt + c;
      float kv = 0.0f, vv = 0.0f;
      if (t < Tk) {
        const int64_t off = ((static_cast<int64_t>(b) * Tk + t) * K + kvh) * hd + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[c * ks + d] = kv;
      v_s[c * hd + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * ks + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * ks + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q_start + ty * 4 + i;
      float mb = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = kt + tx + 16 * j;
        if (t >= Tk) {
          s[i][j] = -INFINITY;  // past the end of the keys: weight exactly 0
        } else {
          bool ok = true;
          if (causal) ok = ok && r >= t;
          if (window > 0) ok = ok && r - t < window;
          s[i][j] = ok ? s[i][j] * scale : kNegInf;
        }
        mb = fmaxf(mb, s[i][j]);
      }
      mb = row_max(mb);
      const float m_new = fmaxf(m[i], mb);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty * 4 + i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < hd ? v_s[c * hd + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q_start + ty * 4 + i;
    if (r >= S) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = out + ((static_cast<int64_t>(b) * S + r) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) orow[d] = from_f32<T>(acc[i][j] / li);
    }
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
           int H, int K, int hd, float scale, int causal, int window, cudaStream_t st) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBQ + kBK) * padded(hd) +
                                       static_cast<size_t>(kBK) * hd + kBQ * kPS);
  auto kern = flash_attention_kernel<T, DJ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(out), S, Tk,
                                     H, K, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
             int H, int K, int hd, float scale, int causal, int window, cudaStream_t st) {
  const int need = (hd + 15) / 16;
#define FA_CASE(DJ) \
  if (need <= DJ) return launch<T, DJ>(q, k, v, out, B, S, Tk, H, K, hd, scale, causal, window, st);
  FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(8) FA_CASE(10)
  FA_CASE(16)
#undef FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // hd > 256
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int B, int S, int T, int H, int K, int hd, float scale,
                               int causal, int window, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T, H, K, hd, scale, causal, window, st);
  return dispatch<float>(q, k, v, out, B, S, T, H, K, hd, scale, causal, window, st);
}
