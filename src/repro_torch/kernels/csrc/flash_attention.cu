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
// causal) the work is ~86 GFLOP per call against ~42 MB of I/O.  Two routes:
//
// bfloat16 (flash_attention_bf16): the tensor cores.  One block of 8 warps
// per (128-row q tile, head, batch row), heaviest causal tiles launched
// first, two blocks per SM up to hd 128.  Each warp owns 16 query rows; S =
// QK^T and O = PV accumulate in registers in the m16n8 accumulator layout of
// mma.sync.m16n8k16 (bf16 in, float32 accumulate), with operands from shared
// memory by ldmatrix (.trans for V).  The Q fragments are re-read from shared
// memory at every k-step: held in registers they take 20-28 more a thread,
// and under the 128 that two blocks per SM allow, hd 112 then spills and runs
// slower (measured on the H100).  A row's max and sum come from the 4 lanes
// of its quad; exp2 takes scale * log2(e) folded into the scores; P
// goes from the S accumulators straight into the A fragments of the PV
// product (their layouts match).  P is split as hi + lo in bf16 and takes two
// PV products: P rounded once to bf16 puts the answer up to ~30x outside the
// port's limit of 2e-5 + 2^-6 |want| (tests/test_torch_flash_numerics.py),
// the split stays within half of it.  K/V tiles of 64 keys come in by
// 16-byte cp.async into two stages, the next tile's copy overlapping this
// tile's math, one barrier per tile; each shared row is padded by 16 bytes so
// the 8 rows an ldmatrix reads fall on 8 different bank groups.  The head dim
// is zero-padded in shared memory to the template's HD (a multiple of 16).
// Only the tiles a mask edge crosses compute masks, per warp; a warp whose 16
// rows see none of a tile's keys skips it.
//
// float32 (flash_attention_f32): the CUDA cores, as the first version: one
// block of 256 threads per (q tile of 64 rows, head, batch row); the Q tile,
// one K tile and one V tile (64 keys each) are staged in shared memory as
// float32 (rows padded to an odd stride, so the 16 threads that read 16
// different K rows hit 16 different banks).  Each thread owns a 4 x 4 patch
// of the 64 x 64 score tile and a 4 x (16 * DJ) patch of the output
// accumulator, kept in registers; a row's max and sum are reduced across the
// 16 threads that share it with warp shuffles.  TF32 would keep ~3 digits,
// and the float32 route is held to atol 2e-5.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after the launch.  window <= 0 means no window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPS = kBK + 1;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

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
template <int DJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int S, int Tk,
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
    q_s[r * ks + d] = s < S ? q[((static_cast<int64_t>(b) * S + s) * H + h) * hd + d] : 0.0f;
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
        kv = k[off];
        vv = v[off];
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
    float* orow = out + ((static_cast<int64_t>(b) * S + r) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) orow[d] = acc[i][j] / li;
    }
  }
}

template <int DJ>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
           int H, int K, int hd, float scale, int causal, int window, cudaStream_t st) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBQ + kBK) * padded(hd) +
                                       static_cast<size_t>(kBK) * hd + kBQ * kPS);
  auto kern = flash_attention_kernel<DJ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                     static_cast<const float*>(v), static_cast<float*>(out), S,
                                     Tk, H, K, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
             int H, int K, int hd, float scale, int causal, int window, cudaStream_t st) {
  const int need = (hd + 15) / 16;
#define FA_CASE(DJ) \
  if (need <= DJ) return launch<DJ>(q, k, v, out, B, S, Tk, H, K, hd, scale, causal, window, st);
  FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(8) FA_CASE(10)
  FA_CASE(16)
#undef FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // hd > 256
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (mma.sync.m16n8k16, split P)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;            // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;     // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: the Q tile, then two stages of (K tile, V tile), all rows
// HD + 8 elements apart (16 bytes of padding: 8 consecutive rows of an
// ldmatrix land on 8 different 16-byte bank groups, since (HD + 8) / 8 is odd)
template <int HD>
struct Tiles {
  static constexpr int kStride = HD + 8;
  static constexpr int kRows = kBQ + 4 * kBK;
  static constexpr int kQElems = kBQ * kStride;
  static constexpr int kKVElems = kBK * kStride;
  static constexpr size_t kBytes = sizeof(bf16) * static_cast<size_t>(kRows) * kStride;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past src_bytes (0 or 16)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU.EX2 (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) = hi + lo with hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows [row0, row0 + ROWS) of one head (row stride `stride` elements) into a
// shared tile; rows at or past `limit` are zero-filled, columns [hd, HD) are
// left alone (zeroed once at the start).  vec: 16-byte cp.async (hd % 8 == 0
// and 16-byte aligned pointers), else plain 2-byte loads.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t stride, int row0,
                                          int limit, int hd, bool vec) {
  constexpr int kStride = HD + 8;
  if (vec) {
    constexpr int kChunks = HD / 8;
    constexpr int kIters = (ROWS * kChunks + kThreads - 1) / kThreads;
    const int chunks = hd >> 3;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = it * kThreads + static_cast<int>(threadIdx.x);
      const int r = i / kChunks, c = i - r * kChunks;
      if (r < ROWS && c < chunks) {
        const int row = row0 + r;
        const bool in = row < limit;
        cp_async16(smem_u32(dst + r * kStride + c * 8), in ? src + row * stride + c * 8 : src,
                   in ? 16 : 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
      const int r = i / HD, c = i - r * HD;
      if (c < hd) {
        const int row = row0 + r;
        dst[r * kStride + c] = row < limit ? src[row * stride + c] : __float2bfloat16_rn(0.0f);
      }
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* row, int c, int hd, float x, float y) {
  if (c + 1 < hd && (hd & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
  } else {
    if (c < hd) row[c] = __float2bfloat16_rn(x);
    if (c + 1 < hd) row[c + 1] = __float2bfloat16_rn(y);
  }
}

// Two blocks per SM (at most 128 registers a thread) up to HD 128, where
// shared memory holds two; one above.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int B, int S, int Tk, int H,
                int K, int hd, float scale_log2, int causal, int window, int vec) {
  using Tl = Tiles<HD>;
  constexpr int kStride = Tl::kStride;
  constexpr int kKS = HD / 16;  // k-steps of QK^T
  constexpr int kNT = HD / 8;   // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* const kv_s = q_s + Tl::kQElems;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int heads = H * B;
  const int n_qt = (S + kBQ - 1) / kBQ;
  // the heaviest causal q tiles are launched first, so the tail balances
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / heads);
  const int hb = static_cast<int>(blockIdx.x % heads);
  const int h = hb % H, b = hb / H, kvh = h / (H / K);
  const int q0 = qt * kBQ;
  const int64_t q_stride = static_cast<int64_t>(H) * hd, kv_stride = static_cast<int64_t>(K) * hd;
  const bf16* qb = q + (static_cast<int64_t>(b) * S * H + h) * hd;
  const bf16* kb = k + (static_cast<int64_t>(b) * Tk * K + kvh) * hd;
  const bf16* vb = v + (static_cast<int64_t>(b) * Tk * K + kvh) * hd;

  // key tiles that the band reaches
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tk, min(q0 + kBQ, S)) : Tk;
  const int kt0 = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + kBK - 1) / kBK : 0;

  if (hd < HD) {  // the padded columns of every tile stay zero
    const int pad = HD - hd;
    for (int i = tid; i < Tl::kRows * pad; i += kThreads) {
      const int r = i / pad;
      q_s[r * kStride + hd + (i - r * pad)] = __float2bfloat16_rn(0.0f);
    }
  }
  load_tile<HD, kBQ>(q_s, qb, q_stride, q0, S, hd, vec);
  if (n_tiles > 0) {
    load_tile<HD, kBK>(kv_s, kb, kv_stride, kt0, Tk, hd, vec);
    load_tile<HD, kBK>(kv_s + Tl::kKVElems, vb, kv_stride, kt0, Tk, hd, vec);
  }
  cp_async_commit();

  // this thread's rows in the m16n8 accumulator layout: g and g + 8 of the
  // warp's 16; its columns 2 * t4 and 2 * t4 + 1 of each 8-wide n-tile
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = q0 + 16 * warp;
  const int r0 = wrow + g, r1 = r0 + 8;
  // ldmatrix row addresses: A (Q, 16 x 16), B of QK^T (K rows, 16 keys x 16
  // dims), B of PV (V rows, transposed: 16 keys x 16 dims)
  const uint32_t q_addr =
      smem_u32(q_s + (16 * warp + (lane & 15)) * kStride + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * kStride + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kStride + (lane >> 4) * 8;

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt0 + it * kBK;
    const bf16* k_s = kv_s + (it & 1) * 2 * Tl::kKVElems;
    const bf16* v_s = k_s + Tl::kKVElems;
    cp_async_wait<0>();  // this tile has landed ...
    __syncthreads();     // ... for every thread, and every warp is done with the last one
    if (it + 1 < n_tiles) {  // so the next tile goes into the other stage during this one's math
      bf16* k_n = kv_s + ((it + 1) & 1) * 2 * Tl::kKVElems;
      load_tile<HD, kBK>(k_n, kb, kv_stride, kt + kBK, Tk, hd, vec);
      load_tile<HD, kBK>(k_n + Tl::kKVElems, vb, kv_stride, kt + kBK, Tk, hd, vec);
      cp_async_commit();
    }
    // does any (row, key) pair of this warp's rows and this tile lie in the band?
    const bool live = wrow < S && (!causal || kt <= wrow + 15) &&
                      (window <= 0 || kt + kBK - 1 > wrow - window);
    if (live) {
      float s[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const uint32_t k_addr = smem_u32(k_s + k_off);
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t a[4];
        ldsm_x4(q_addr + kk * 32, a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(k_addr + (np * 16 * kStride + kk * 16) * 2, b0, b1, b2, b3);
          mma_bf16(s[2 * np], a, b0, b1);
          mma_bf16(s[2 * np + 1], a, b2, b3);
        }
      }

      // scale (log2 units); masks only where the tile crosses a band edge or T
      const bool edge = (causal && kt + kBK - 1 > wrow) ||
                        (window > 0 && wrow + 15 - kt >= window) || kt + kBK > Tk;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = kt + 8 * j + 2 * t4 + (e & 1);
            const int r = e < 2 ? r0 : r1;
            if (t >= Tk)
              s[j][e] = -INFINITY;  // past the end of the keys: weight exactly 0
            else if ((causal && t > r) || (window > 0 && r - t >= window))
              s[j][e] = kNegInf;
          }
      }

      // online softmax over the quad that shares each row
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float a0 = fast_exp2(m0 - mx0), a1 = fast_exp2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[j][0] = fast_exp2(s[j][0] - mx0);
        s[j][1] = fast_exp2(s[j][1] - mx0);
        s[j][2] = fast_exp2(s[j][2] - mx1);
        s[j][3] = fast_exp2(s[j][3] - mx1);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 = l0 * a0 + ps0;  // this lane's part of the row sum; the quad adds at the end
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }

      // O += P V: the S accumulators of n-tiles 2kk, 2kk + 1 are the A
      // fragment of k-step kk; P = hi + lo, two products
      const uint32_t v_addr = smem_u32(v_s + v_off);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < kNT / 2; ++dp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(v_addr + (kk * 16 * kStride + dp * 16) * 2, b0, b1, b2, b3);
          mma_bf16(o[2 * dp], ph, b0, b1);
          mma_bf16(o[2 * dp], pl, b0, b1);
          mma_bf16(o[2 * dp + 1], ph, b2, b3);
          mma_bf16(o[2 * dp + 1], pl, b2, b3);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
  const float inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
  bf16* ob = out + (static_cast<int64_t>(b) * S * H + h) * hd;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int c = 8 * n + 2 * t4;
    if (r0 < S) store_pair(ob + r0 * q_stride, c, hd, o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < S) store_pair(ob + r1 * q_stride, c, hd, o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
           int K, int hd, float scale, int causal, int window, cudaStream_t st) {
  const size_t smem = Tiles<HD>::kBytes;
  auto kern = flash_tc_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>((S + kBQ - 1) / kBQ) * H * B;
  if (blocks >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), B, S, Tk, H, K, hd, scale * kLog2e, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
             int K, int hd, float scale, int causal, int window, cudaStream_t st) {
#define FA_CASE(HD) \
  if (hd <= HD) return launch<HD>(q, k, v, out, B, S, Tk, H, K, hd, scale, causal, window, st);
  FA_CASE(32) FA_CASE(64) FA_CASE(80) FA_CASE(96) FA_CASE(112) FA_CASE(128) FA_CASE(160)
  FA_CASE(192) FA_CASE(256)
#undef FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // hd > 256
}

}  // namespace tc

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int T, int H, int K, int hd, float scale,
                                   int causal, int window, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  return dispatch(q, k, v, out, B, S, T, H, K, hd, scale, causal, window,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int T, int H, int K, int hd, float scale,
                                    int causal, int window, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  return tc::dispatch(q, k, v, out, B, S, T, H, K, hd, scale, causal, window,
                      static_cast<cudaStream_t>(stream));
}
