// Single-token decode attention over a (ring-buffered) KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention (kernel _kernel, :24; pallas_call :71).  The caller builds
// the slot-validity mask (unwritten slots, ring wrap, window ageing), as
// repro/kernels/ops.py:38-41 does; the kernel stays pure attention.
//
// What it computes: q (B, H, hd), k/v (B, C, K, hd), mask (B, C) bool;
// query head h reads KV head h / G (G = H / K).  Scores q.k * scale in
// float32 (masked slots -1e30, not -inf), an online softmax in float32 over
// tiles of the cache, probabilities kept in float32 for the PV product, and
// the l == 0 -> 1 guard; the result is rounded once to q's type.  A fully
// masked row therefore gets equal weights on every slot, as the TPU kernel
// and the softmax oracle give it.
//
// Bound on this card: bytes (each K/V element is read once and used for ~2G
// flops).  Design: a split over the cache, then a combine.  One block per
// (KV head, batch row, split of kSplit slots) serves that head's G query
// heads, so the cache is read once, not G times; at full width (B = 4,
// K = 8, C = 1024) that is 256 blocks.  The block walks its split in tiles
// of kTile slots: a warp per slot computes the G dot products (lanes over
// hd, coalesced loads, warp-shuffle sums), a warp per query head updates
// that head's running max and sum, and the threads add the tile's PV product
// to a float32 accumulator in shared memory, with the V tile staged there.
// Each block writes its (max, sum, unnormalized accumulator); the combine
// kernel rescales the splits to their common max and divides.  A split with
// no valid slot keeps max -1e30, so its weight vanishes beside any valid
// slot, and a row with none at all averages every slot, as in one pass.
// No assumption on hd (at most 256), C or G.

// Plain C interface for ctypes; returns cudaGetLastError() after the launches.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  The caller
// allocates the float32 scratch for the splits' partial results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kSplit = 128;  // cache slots per block
constexpr int kMaxJ = 8;  // hd <= 32 * kMaxJ
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       float* __restrict__ part_ml, float* __restrict__ part_acc,
                       int C, int K, int G, int hd, float scale) {
  extern __shared__ float sm[];
  float* q_s = sm;                    // G * hd
  float* acc_s = q_s + G * hd;        // G * hd
  float* v_s = acc_s + G * hd;        // kTile * hd
  float* s_s = v_s + kTile * hd;      // G * kTile
  float* m_s = s_s + G * kTile;       // G
  float* l_s = m_s + G;               // G
  float* a_s = l_s + G;               // G

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = K * G;
  const int64_t q_off = (static_cast<int64_t>(b) * H + static_cast<int64_t>(kvh) * G) * hd;
  const int c_begin = split * kSplit, c_end = min(C, c_begin + kSplit);

  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(q[q_off + i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  __syncthreads();

  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    const int n = min(kTile, c_end - c0);
    // stage the V tile as float32
    for (int i = tid; i < n * hd; i += kThreads) {
      const int c = i / hd, d = i - c * hd;
      v_s[i] = to_f32(v[((static_cast<int64_t>(b) * C + c0 + c) * K + kvh) * hd + d]);
    }
    // scores: one warp per slot, lanes over hd
    for (int c = warp; c < n; c += kWarps) {
      const T* kr = k + ((static_cast<int64_t>(b) * C + c0 + c) * K + kvh) * hd;
      float kreg[kMaxJ];
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int d = lane + 32 * j;
        kreg[j] = d < hd ? to_f32(kr[d]) : 0.0f;
      }
      const bool valid = mask[static_cast<int64_t>(b) * C + c0 + c] != 0;
      for (int g = 0; g < G; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) dot += q_s[g * hd + d] * kreg[j];
        }
        dot = warp_sum(dot);
        if (lane == 0) s_s[g * kTile + c] = valid ? dot * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mb = kNegInf;
      for (int i = lane; i < n; i += 32) mb = fmaxf(mb, s_s[g * kTile + i]);
      mb = warp_max(mb);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mb);
      float sum = 0.0f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(s_s[g * kTile + i] - m_new);
        s_s[g * kTile + i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = alpha * acc + P V
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* p = s_s + g * kTile;
      float pv = 0.0f;
      for (int c = 0; c < n; ++c) pv += p[c] * v_s[c * hd + d];
      acc_s[i] = a_s[g] * acc_s[i] + pv;
    }
    __syncthreads();
  }

  // this split's partial result, laid out (b, kvh, split, g[, d])
  const int64_t part = (static_cast<int64_t>(b) * K + kvh) * gridDim.z + split;
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(part * G + g) * 2] = m_s[g];
    part_ml[(part * G + g) * 2 + 1] = l_s[g];
  }
  for (int i = tid; i < G * hd; i += kThreads) part_acc[part * G * hd + i] = acc_s[i];
}

// One block per (KV head, batch row): rescale the splits to their common max,
// sum, apply the l == 0 -> 1 guard, divide and round once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                         T* __restrict__ out, int K, int G, int hd, int n_split) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int H = K * G;
  const int64_t part0 = (static_cast<int64_t>(b) * K + kvh) * n_split;
  const int64_t q_off = (static_cast<int64_t>(b) * H + static_cast<int64_t>(kvh) * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_ml[((part0 + s) * G + g) * 2]);
    float l = 0.0f, acc = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(part_ml[((part0 + s) * G + g) * 2] - m);
      l += w * part_ml[((part0 + s) * G + g) * 2 + 1];
      acc += w * part_acc[(part0 + s) * G * hd + i];
    }
    l = l == 0.0f ? 1.0f : l;
    out[q_off + i] = from_f32<T>(acc / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
           float* part_ml, float* part_acc, int B, int C, int K, int G, int hd, float scale,
           cudaStream_t st) {
  const int n_split = (C + kSplit - 1) / kSplit;
  const size_t smem = sizeof(float) * (2 * G * hd + kTile * hd + G * kTile + 3 * G);
  auto kern = decode_attention_split<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_split > 0) {  // an empty cache leaves only the combine: zeros
    kern<<<dim3(K, B, n_split), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        part_ml, part_acc, C, K, G, hd, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attention_combine<T><<<dim3(K, B), kThreads, 0, st>>>(
      part_ml, part_acc, static_cast<T*>(out), K, G, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part_ml: float32 scratch of B * K * ceil(C / 128) * G * 2 values;
// part_acc: float32 scratch of B * K * ceil(C / 128) * G * hd values.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* part_ml, void* part_acc,
                                int B, int C, int K, int G, int hd, float scale, int dtype,
                                void* stream) {
  if (B == 0 || K == 0 || G == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, m, out, ml, acc, B, C, K, G, hd, scale, st);
  return launch<float>(q, k, v, m, out, ml, acc, B, C, K, G, hd, scale, st);
}
