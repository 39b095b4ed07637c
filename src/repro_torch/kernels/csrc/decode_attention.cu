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
// Bound on this card: bytes (each live K/V element is read once and used for
// ~2G flops, far below the ridge; the CUDA cores suffice).  Design:
//
// - A split over the cache, then a combine.  One block per (KV head, group
//   of up to 8 of its query heads, batch row, split), so K/V are read once
//   per group, not once per query head.  The wrapper sizes the split from the
//   grid: as many splits as let B x K x groups x splits blocks run in one
//   wave (decode_attention_blocks_per_sm: 2 blocks per SM in bf16 at hd 80
//   and 112, where registers, not shared memory, bound it), in whole 64-slot
//   tiles, at most 32 tiles.
// - Dead tiles skipped.  Each warp ballots its split's tiles for a valid
//   slot into a bit mask of its own (no barrier before the first load).  A
//   tile with none is never loaded.  A split with none scans its
//   batch row's whole mask (__syncthreads_or): if the row has a valid slot,
//   the split writes (max -1e30, sum 0) and exits, since a masked slot's
//   weight exp(-1e30 - m) is exactly 0 beside any valid slot; if not, the
//   split reads every tile, and the row averages V over all slots, as the
//   oracle's softmax gives it.
// - 16-byte loads.  K and V tiles go to shared memory as the input type by
//   cp.async, 16 bytes a thread over the flattened (slot, 16-byte chunk)
//   index (hd 80 is 10 chunks in bf16, hd 112 is 14), in two stages: the
//   first two live tiles are copied at once, then each next live tile's copy
//   overlaps this tile's arithmetic.  Rows are padded
//   to an odd number of chunks, so a quarter-warp's 16-byte reads hit 8
//   different bank groups.  When hd * sizeof(T) is not a multiple of 16 or
//   a K/V base pointer is not 16-byte aligned, the wrapper asks for plain
//   element loads into the same layout (columns past hd zeroed).
// - Two barriers per tile: the cp.async wait, then one after the scores.
//   Scores: R lanes per (query head, slot) over the head dim, reduced by
//   shuffles, into a 64 x 8 float32 tile.  PV: each thread owns fixed
//   (query head, 16-byte chunk of hd, slot phase j) accumulators in
//   registers, runs the online softmax itself (every owner of a head
//   computes the same running max from the same scores; exponentials by
//   the SFU's ex2), and adds the slots j, j + S, ... of each tile; the
//   phases are summed in a fixed order once per split.
// - Second pass: a combine kernel rescales the splits to their common max,
//   sums in split order, divides and rounds once.  Both kernels are
//   programmatic dependent launches: the combine's blocks are scheduled
//   while the split pass runs and wait for it on the card, and the split
//   pass's likewise behind the kernel before it, which hides each launch's
//   latency.
//   Folding it into the last block of each row (an arrival counter) was
//   slower on the card: one block then sums a row's splits alone.  No
//   atomics: the result is the same on every run.
// - Optional log-sum-exp: given an lse pointer, the combine also writes each
//   (row, head)'s natural log of its softmax denominator, m ln 2 + log(l)
//   from the max and sum it already holds (-1e30 for a row with no valid
//   slot, as the oracle's float32 logsumexp rounds it), so that partial
//   attentions over slices of one cache (a cache split over devices) can be
//   merged by their weights.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the
// launches.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// The caller allocates the float32 scratch for the splits' partial results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // cache slots per tile
constexpr int kGroup = 8;      // query heads of one KV head per block
constexpr int kMaxTiles = 32;  // tiles per split (the wrapper keeps splits within it)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp, 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of T in shared memory as E floats
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* s, float (&f)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* s, float (&f)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(s);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared-memory layout, shared by the kernel and its launcher: the two K/V
// stages (later reused for the per-split reduction), then q and the scores.
struct Layout {
  int E, nchunk, stride;  // floats per chunk, chunks of hd, elements per shared row
  size_t stage_elems, union_bytes, q_off, s_off, total;
  __host__ __device__ Layout(int hd, int elem_bytes) {
    E = 16 / elem_bytes;
    nchunk = (hd + E - 1) / E;
    stride = (nchunk | 1) * E;
    stage_elems = static_cast<size_t>(2) * kTile * stride;  // K and V of one tile
    const size_t stages_bytes = 2 * stage_elems * elem_bytes;
    const int own = kThreads > kGroup * nchunk ? kThreads : kGroup * nchunk;
    const size_t red = (static_cast<size_t>(own) * E + kThreads + kGroup) * sizeof(float);
    union_bytes = ((stages_bytes > red ? stages_bytes : red) + 15) / 16 * 16;
    q_off = union_bytes;
    s_off = q_off + static_cast<size_t>(kGroup) * nchunk * E * sizeof(float);
    total = s_off + static_cast<size_t>(kGroup) * kTile * sizeof(float);
  }
};

// at most 128 registers a thread: two blocks on an SM, and no spills
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_split(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       float* __restrict__ part_ml, float* __restrict__ part_acc,
                       int C, int K, int G, int hd, int split, float scale2, int vec) {
  constexpr int E = Chunk<T>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(hd, sizeof(T));
  const int nchunk = lay.nchunk, stride = lay.stride;
  T* kv_s = reinterpret_cast<T*>(smem);  // [stage][K, V][kTile][stride]
  float* q_s = reinterpret_cast<float*>(smem + lay.q_off);  // [kGroup][nchunk * E]
  float* s_s = reinterpret_cast<float*>(smem + lay.s_off);  // [kGroup][kTile]

  const int n_gb = (G + kGroup - 1) / kGroup;
  const int kvh = blockIdx.x / n_gb, g0 = (blockIdx.x - kvh * n_gb) * kGroup;
  const int gn = min(kGroup, G - g0);
  const int b = blockIdx.y, sp = blockIdx.z, n_split = gridDim.z;
  const int H = K * G, h0 = kvh * G + g0;
  const int c0 = sp * split, c1 = min(C, c0 + split);
  const int n_tiles = (c1 - c0 + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint8_t* mrow = mask + static_cast<int64_t>(b) * C;
  // launched early (programmatic dependent launch): wait until the kernels
  // before it (which write q and the cache) have finished; then the combine
  // may be scheduled, and it waits for this grid to finish
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // q of this block's heads as float32, zero past hd
  for (int i = tid; i < gn * nchunk * E; i += kThreads) {
    const int g = i / (nchunk * E), d = i - g * nchunk * E;
    q_s[i] = d < hd ? to_f32(q[(static_cast<int64_t>(b) * H + h0 + g) * hd + d]) : 0.0f;
  }
  // which of this split's tiles hold a valid slot, as a bit mask that every
  // warp computes for itself (no barrier on the way to the first load)
  uint32_t todo = 0;
  for (int t = 0; t < n_tiles; ++t) {
    bool valid = false;
    for (int c = c0 + t * kTile + lane; c < min(c1, c0 + (t + 1) * kTile); c += 32)
      valid |= mrow[c] != 0;
    if (__any_sync(0xffffffffu, valid)) todo |= 1u << t;
  }
  if (todo == 0) {  // only a split with none needs the row rule
    int any = 0;
    for (int c = tid; c < C; c += kThreads) any |= mrow[c];
    if (__syncthreads_or(any)) {  // weight 0 in the combine
      for (int g = tid; g < gn; g += kThreads) {
        const int64_t p = (static_cast<int64_t>(b) * H + h0 + g) * n_split + sp;
        part_ml[2 * p] = kNegInf;
        part_ml[2 * p + 1] = 0.0f;
      }
      return;
    }
    todo = n_tiles == 32 ? ~0u : (1u << n_tiles) - 1;  // no valid slot in the row: all
  }
  auto next_tile = [&](int t) {  // the first tile >= t to read, or n_tiles
    const uint32_t rest = t < 32 ? todo >> t << t : 0u;
    return rest ? __ffs(rest) - 1 : n_tiles;
  };
  int t = next_tile(0);

  auto load = [&](int tile, int stage) {
    T* ks = kv_s + stage * lay.stage_elems;
    T* vs = ks + kTile * stride;
    const int cb = c0 + tile * kTile;
    if (vec) {
      for (int i = tid; i < kTile * nchunk; i += kThreads) {
        const int r = i / nchunk, ch = i - r * nchunk;
        const bool in = cb + r < c1;
        const int64_t off =
            ((static_cast<int64_t>(b) * C + (in ? cb + r : c0)) * K + kvh) * hd + ch * E;
        cp_async16(smem_u32(ks + r * stride + ch * E), k + off, in ? 16 : 0);
        cp_async16(smem_u32(vs + r * stride + ch * E), v + off, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kTile * nchunk * E; i += kThreads) {
        const int r = i / (nchunk * E), d = i - r * (nchunk * E);
        const bool in = cb + r < c1 && d < hd;
        const int64_t off = ((static_cast<int64_t>(b) * C + cb + r) * K + kvh) * hd + d;
        ks[r * stride + d] = in ? k[off] : from_f32<T>(0.0f);
        vs[r * stride + d] = in ? v[off] : from_f32<T>(0.0f);
      }
    }
  };

  // scores: R lanes (a power of two) per (query head, slot)
  const int P = kTile * gn;
  int R = 1;
  while (R < 32 && 2 * R * P <= kThreads) R *= 2;
  const int per_pass = kThreads / R;
  // PV: owner o = (j, g, chunk) over n_own = S * gn * nchunk
  const int n_pairs = gn * nchunk;
  const int s_sub = max(1, kThreads / n_pairs);
  const int n_own = n_pairs * s_sub;
  // PV accumulators per thread: up to 8 heads x 32 chunks (bf16 hd 256) fit
  // one per thread, 8 x 64 (float32 hd 256) two
  constexpr int kMaxOwn = E == 8 ? 1 : 2;
  float acc[kMaxOwn][E], l_own[kMaxOwn], m_own[kMaxOwn];
#pragma unroll
  for (int n = 0; n < kMaxOwn; ++n) {
    l_own[n] = 0.0f;
    m_own[n] = kNegInf;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[n][e] = 0.0f;
  }

  // both stages start full: the first two live tiles are copied at once
  int stage = 0;
  load(t, 0);
  cp_async_commit();
  int tn = next_tile(t + 1);
  if (tn < n_tiles) {
    load(tn, 1);
    cp_async_commit();
  }
  for (bool first = true; t < n_tiles; first = false) {
    if (first && tn < n_tiles)
      cp_async_wait_all_but_one();
    else
      cp_async_wait_all();
    __syncthreads();  // tile t has landed for all; all are done with the last tile
    if (!first) {  // the next live tile into the stage the last one held
      tn = next_tile(t + 1);
      if (tn < n_tiles) {
        load(tn, stage ^ 1);
        cp_async_commit();
      }
    }
    const T* ks = kv_s + stage * lay.stage_elems;
    const T* vs = ks + kTile * stride;
    const int cb = c0 + t * kTile;
    for (int base = 0; base < P; base += per_pass) {
      const int p = base + tid / R, r = tid % R;
      const int g = p / kTile, sl = p - g * kTile;
      float dot = 0.0f;
      if (p < P) {
        for (int ch = r; ch < nchunk; ch += R) {
          float kf[E];
          Chunk<T>::load(ks + sl * stride + ch * E, kf);
          const float* qg = q_s + (g * nchunk + ch) * E;
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + e);
            dot += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] + qv.w * kf[e + 3];
          }
        }
      }
      for (int off = R / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (p < P && r == 0) {
        const int c = cb + sl;
        s_s[g * kTile + sl] = c >= c1 ? -CUDART_INF_F : (mrow[c] ? dot * scale2 : kNegInf);
      }
    }
    __syncthreads();  // the tile's scores are in
#pragma unroll
    for (int n = 0; n < kMaxOwn; ++n) {
      const int o = tid + n * kThreads;
      if (o < n_own) {
        const int pair = o % n_pairs, j = o / n_pairs;
        const int g = pair / nchunk, ch = pair - g * nchunk;
        const float* sg = s_s + g * kTile;
        float mt = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < kTile; i += 4) {
          const float4 s4 = *reinterpret_cast<const float4*>(sg + i);
          mt = fmaxf(fmaxf(mt, s4.x), fmaxf(s4.y, fmaxf(s4.z, s4.w)));
        }
        const float m_new = fmaxf(m_own[n], mt);
        const float alpha = ex2(m_own[n] - m_new);
        m_own[n] = m_new;
        l_own[n] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[n][e] *= alpha;
        for (int sl = j; sl < kTile; sl += s_sub) {
          const float pw = ex2(sg[sl] - m_new);
          l_own[n] += pw;
          float vf[E];
          Chunk<T>::load(vs + sl * stride + ch * E, vf);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[n][e] += pw * vf[e];
        }
      }
    }
    t = tn;
    stage ^= 1;
  }

  // sum the slot phases in a fixed order; the reduction reuses the stages
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [n_own][E]
  float* red_l = red + n_own * E;               // [s_sub][gn]
  float* red_m = red_l + s_sub * gn;            // [gn]
#pragma unroll
  for (int n = 0; n < kMaxOwn; ++n) {
    const int o = tid + n * kThreads;
    if (o < n_own) {
      const int pair = o % n_pairs, j = o / n_pairs;
      const int g = pair / nchunk, ch = pair - g * nchunk;
#pragma unroll
      for (int e = 0; e < E; ++e) red[o * E + e] = acc[n][e];
      if (ch == 0) {
        red_l[j * gn + g] = l_own[n];
        if (j == 0) red_m[g] = m_own[n];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    const int pair = g * nchunk + d / E, e = d % E;
    float a = 0.0f;
    for (int j = 0; j < s_sub; ++j) a += red[(j * n_pairs + pair) * E + e];
    part_acc[((static_cast<int64_t>(b) * H + h0 + g) * n_split + sp) * hd + d] = a;
  }
  for (int g = tid; g < gn; g += kThreads) {
    float l = 0.0f;
    for (int j = 0; j < s_sub; ++j) l += red_l[j * gn + g];
    const int64_t p = (static_cast<int64_t>(b) * H + h0 + g) * n_split + sp;
    part_ml[2 * p] = red_m[g];
    part_ml[2 * p + 1] = l;
  }
}

// One thread per (batch row, query head, d): rescale the splits to their
// common max, sum in split order (a split of weight 0, such as a skipped
// one, is passed over without reading its accumulator), apply the
// l == 0 -> 1 guard, divide and round once; with lse, the d == 0 thread of
// each (row, head) also writes its log-sum-exp.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                         T* __restrict__ out, float* __restrict__ lse, int H, int hd,
                         int n_split) {
  // launched early (programmatic dependent launch): wait until the split
  // pass has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= H * hd) return;
  const int h = i / hd, d = i - h * hd;
  const int64_t p0 = (static_cast<int64_t>(b) * H + h) * n_split;
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_ml[2 * (p0 + s)]);
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float w = ex2(part_ml[2 * (p0 + s)] - m);
    if (w != 0.0f) {
      l += w * part_ml[2 * (p0 + s) + 1];
      acc += w * part_acc[(p0 + s) * hd + d];
    }
  }
  l = l == 0.0f ? 1.0f : l;
  out[(static_cast<int64_t>(b) * H + h) * hd + d] = from_f32<T>(acc / l);
  if (lse != nullptr && d == 0)
    lse[static_cast<int64_t>(b) * H + h] = m == kNegInf ? kNegInf : m * kLn2 + logf(l);
}

// Both kernels are programmatic dependent launches: a kernel's blocks may be
// scheduled while the kernel before it in the stream still runs, and wait
// for it on the card (griddepcontrol.wait), which hides each launch's
// latency behind the work before it.
void pdl_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, dim3 grid, size_t smem,
                cudaStream_t st) {
  *cfg = {};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr->val.programmaticStreamSerializationAllowed = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The split kernel's dynamic shared memory allowed above 48 KB where needed
// (hd 80 and up in bf16).  cudaFuncSetAttribute is a host call of its own, so
// it is made once per (type, device) for each larger size asked for, not on
// every launch: a larger allowance serves every smaller layout.
template <typename T>
cudaError_t prepare(const Layout& lay) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> allowed[kMaxDevices];  // bytes set so far, 0: none
  const int need = static_cast<int>(lay.total);
  if (need <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<int>* seen = dev < kMaxDevices ? &allowed[dev] : nullptr;
  if (seen != nullptr && seen->load(std::memory_order_acquire) >= need) return cudaSuccess;
  e = cudaFuncSetAttribute(decode_attention_split<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, need);
  if (e == cudaSuccess && seen != nullptr) {
    int cur = seen->load(std::memory_order_acquire);
    while (cur < need && !seen->compare_exchange_weak(cur, need, std::memory_order_acq_rel)) {
    }
  }
  return e;
}

template <typename T>
cudaError_t occupancy(int hd, int* blocks) {
  const Layout lay(hd, sizeof(T));
  cudaError_t e = prepare<T>(lay);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, decode_attention_split<T>,
                                                       kThreads, lay.total);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
           float* lse, float* part_ml, float* part_acc, int B, int C, int K, int G, int hd,
           int split, float scale, int vec, cudaStream_t st) {
  const int H = K * G;
  const int n_split = C > 0 ? (C + split - 1) / split : 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (n_split > 0) {  // an empty cache leaves only the combine: zeros
    const Layout lay(hd, sizeof(T));
    cudaError_t e = prepare<T>(lay);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_gb = (G + kGroup - 1) / kGroup;
    pdl_config(&cfg, &attr, dim3(K * n_gb, B, n_split), lay.total, st);
    e = cudaLaunchKernelEx(&cfg, decode_attention_split<T>, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v), mask, part_ml,
                           part_acc, C, K, G, hd, split, scale * kLog2e, vec);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pdl_config(&cfg, &attr, dim3((H * hd + kThreads - 1) / kThreads, B), 0, st);
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attention_combine<T>,
                                     static_cast<const float*>(part_ml),
                                     static_cast<const float*>(part_acc), static_cast<T*>(out),
                                     lse, H, hd, n_split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many split-pass blocks of head dim hd fit on one SM at once (shared
// memory and registers); the wrapper sizes the split so that the grid runs
// in one wave.  Returns a negative cudaError_t on failure.
extern "C" int decode_attention_blocks_per_sm(int hd, int dtype) {
  int n = 0;
  cudaError_t e = dtype == 1 ? occupancy<__nv_bfloat16>(hd, &n) : occupancy<float>(hd, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// split: cache slots per block, a multiple of 64 and at most 64 * 32 (the
// wrapper sizes it from the grid); vec: 1 for 16-byte K/V loads (hd *
// sizeof(T) a multiple of 16 and both base pointers 16-byte aligned).
// part_ml: float32 scratch of B * H * ceil(C / split) * 2 values;
// part_acc: float32 scratch of B * H * ceil(C / split) * hd values;
// lse: null, or float32 (B, H) for each (row, head)'s log-sum-exp.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse, void* part_ml,
                                void* part_acc, int B, int C, int K, int G, int hd, int split,
                                float scale, int dtype, int vec, void* stream) {
  if (B == 0 || K == 0 || G == 0 || hd == 0) return 0;
  if (split <= 0 || split % kTile != 0 || split > kTile * kMaxTiles) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  float* ls = static_cast<float*>(lse);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, m, out, ls, ml, acc, B, C, K, G, hd, split, scale,
                                 vec, st);
  return launch<float>(q, k, v, m, out, ls, ml, acc, B, C, K, G, hd, split, scale, vec, st);
}
