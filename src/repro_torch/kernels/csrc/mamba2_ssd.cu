// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a): the three products on
// the tensor cores in compensated TF32.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba2_ssd.py::
// ssd_intra_chunk (kernel _kernel, :23; pallas_call :60).
//
// What it computes, per (batch row b, chunk c, SSD head h), in float32:
//   cum_i = sum_{t <= i} dt_t * A_h                           (inclusive)
//   y_i   = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   S     = sum_j (B_j * exp(cum_{Q-1} - cum_j) * dt_j)^T x_j     (N x P)
//   decay = exp(cum_{Q-1})
// x (B, nc, Q, H, P), dt (B, nc, Q, H), A (H,), B/C (B, nc, Q, N); y in x's
// layout, S (B, nc, H, N, P), decay (B, nc, H): the reference's layouts.
//
// Bound on this card: bytes.  At zamba2-7b's full width (B = 1, nc = 16,
// Q = 256, H = 112, P = N = 64) the function needs 11.4 GFLOP (the causal
// pairs' C.B scores once per chunk, then per head the pairs' w x and the
// state) against 268 MB of I/O.  The fastest float32-accurate rate on the
// card is three TF32 tensor-core products per product, 495 / 3 = 165
// TFLOP/s: 0.069 ms; the bytes take 0.080 ms at 3.35 TB/s.
//
// Design.  Two launches on the stream, the second a programmatic dependent
// launch (it is scheduled while the first runs and waits for it on the card
// before it reads the scores).
//
//  1. ssd_scores_kernel, once per (batch row, chunk): the scores C.B^T do
//     not depend on the head.  One warp per 16 x 8 tile of the causal score
//     matrix (16-row tile m, 8-key block kb <= 2m + 1) computes it with
//     mma.sync and writes it to scratch in the order of the heads kernel's
//     A fragment (a float4 per lane; 139 KB a chunk at Q = 256, read back
//     from L2).  Other warps copy B into the A-fragment order of the state
//     product (B^T, 16 state rows x 8 keys a tile).
//  2. ssd_heads_kernel, one block of 8 warps per (batch row, chunk, group of
//     heads); the wrapper sizes the group so that the grid runs in one wave
//     of one block per SM (14 heads a block at full width: 128 blocks on the
//     H100's 132 SMs).  Per head the block scans dt * A into `cum` (warp
//     shuffles, then the warp totals) while the
//     next head's x rows (256 contiguous bytes each, a row stride of H * P
//     floats) are in flight by 16-byte cp.async into the other half of a
//     two-head ring, zero-filled past Q; then x is split for the tensor cores
//     once, hi in place and lo beside it.  Warp w owns y's 16-row tiles w and
//     Mq - 1 - w, whose causal key blocks add up to Mq + 1 for every warp,
//     and the state's rows [16 (w % 4), + 16) over one half of the keys (the
//     two halves are added through shared memory at the end).  It walks the
//     8-key blocks in order: for each it forms the weights of every product
//     that takes the block, w_ij = s_ij * exp(cum_i - cum_j) * dt_j (a
//     select on j <= i: above the diagonal cum_i - cum_j > 0 and the exp may
//     overflow; 0 * inf would be a NaN), then issues all of its mma.sync
//     m16n8k8 together, one pass per compensation term, so that up to 24
//     accumulator chains interleave.  The blocks fall into at most five
//     phases over which the same products take every block; each phase runs
//     a straight-line body of its own.  x sits in shared memory at a row
//     stride of 72 floats, so the B fragment's 32 loads (rows t, columns g)
//     hit 32 banks; the score fragments come from L2 two blocks ahead.
//     At 239 registers a thread the kernel runs 8 warps per SM, and the
//     time goes to stalls more than to the tensor cores (PERF.md).
//
// Precision: the products are held to float32 (atol 2e-5 + 1e-4 |want|
// against the plain version; TF32 alone keeps ~3 digits and breaks that,
// tests/test_torch_ssd_numerics.py).  Each operand is split as hi = a
// rounded to TF32 (to nearest, ties away, as cvt.rna) and lo = a - hi cut
// to TF32, and a b is summed as hi.lo + lo.hi + hi.hi into float32
// accumulators (3xTF32; the split leaves < 2^-21 |a|, the dropped lo.lo
// term is < 2^-22 |a b|).  The weights, the select, the scan and the
// decays (expf) stay in float32 on the CUDA cores.
//
// Limits: Q <= 256, P <= 64, N <= 64 (the configs use Q in {16, 32, 64,
// 256}, P and N in {16, 32, 64}); Q, P and N need not be multiples of a
// tile: rows past Q are zero-filled, columns past P and N are never stored.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXS = 72;        // row stride of x in shared memory (floats)
constexpr int kMaxRows = 256;  // Q <= 256

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
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

// a = hi + lo, both TF32 (float32 with the low 13 bits zero): hi is a
// rounded to nearest, ties away from zero (cvt.rna's rounding, done on the
// bits in two instructions: ptxas expands cvt.rna.tf32.f32 into several,
// with checks for NaN and infinity), lo the remainder a - hi (exact in
// float32) cut to TF32; |a - hi - lo| < 2^-21 |a|.  Finite |a| < 2^127
// only: the inputs and the weights here are far from it.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a (16 x 8, row) * b (8 x 8, col); TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in compensated TF32: the two cross terms, then hi * hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split(a[r], hi[r], lo[r]);
}

// ---------------------------------------------------------------- launch 1

// element (r, c) of a 16 x 8 A-operand tile: lane (r % 8) * 4 + c % 4,
// register r / 8 + 2 (c / 4)
__device__ __forceinline__ void put_a(float* tile, int r, int c, float v) {
  tile[((r & 7) * 4 + (c & 3)) * 4 + (r >> 3) + 2 * (c >> 2)] = v;
}

__device__ __forceinline__ float at(const float* m, int r, int c, int Q, int N) {
  return (r < Q && c < N) ? m[r * N + c] : 0.0f;
}

// unit u < Mq (Mq + 1): score tile (m, kb) with u = m (m + 1) + kb, kb < 2 (m + 1);
// then Nt * KB units of B^T: (state row tile nm, key block kb)
__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ sc, float4* __restrict__ bt, int nc, int Q, int N) {
  const int Mq = (Q + 15) >> 4, KB = 2 * Mq, n_pairs = Mq * (Mq + 1), Nt = (N + 15) >> 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t chunk = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  // the heads kernel may be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const float* Bc = Bm + chunk * Q * N;
  const float* Cc = Cm + chunk * Q * N;
  if (u < n_pairs) {
    int m = 0;
    while ((m + 1) * (m + 2) <= u) ++m;
    const int kb = u - m * (m + 1);
    const int i0 = 16 * m + g, i1 = i0 + 8, j = 8 * kb + g;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < N; k += 8) {
      const float a[4] = {at(Cc, i0, k + t, Q, N), at(Cc, i1, k + t, Q, N),
                          at(Cc, i0, k + t + 4, Q, N), at(Cc, i1, k + t + 4, Q, N)};
      uint32_t ah[4], al[4], bh[2], bl[2];
      split4(a, ah, al);
      split(at(Bc, j, k + t, Q, N), bh[0], bl[0]);
      split(at(Bc, j, k + t + 4, Q, N), bh[1], bl[1]);
      mma3(c, ah, al, bh, bl);
    }
    // c = S(i0, 2t), S(i0, 2t + 1), S(i1, 2t), S(i1, 2t + 1) of the tile
    float* tile = sc + (chunk * n_pairs + u) * 128;
    put_a(tile, g, 2 * t, c[0]);
    put_a(tile, g, 2 * t + 1, c[1]);
    put_a(tile, g + 8, 2 * t, c[2]);
    put_a(tile, g + 8, 2 * t + 1, c[3]);
  } else if (u < n_pairs + Nt * KB) {
    const int v = u - n_pairs, nm = v / KB, kb = v - nm * KB;
    const int j0 = 8 * kb + t, j1 = j0 + 4, n0 = 16 * nm + g, n1 = n0 + 8;
    bt[((chunk * Nt + nm) * KB + kb) * 32 + lane] =
        make_float4(at(Bc, j0, n0, Q, N), at(Bc, j0, n1, Q, N), at(Bc, j1, n0, Q, N),
                    at(Bc, j1, n1, Q, N));
  }
}

// ---------------------------------------------------------------- launch 2

// head h's x rows [0, Qp) into xb (zero past Q): 16-byte copies where P is
// whole 16-byte vectors and x is aligned, else 4-byte ones
__device__ __forceinline__ void load_x(float* xb, const float* x, int64_t chunk, int h, int Q,
                                       int Qp, int H, int P, bool vec) {
  const int tid = threadIdx.x;
  const int64_t rs = static_cast<int64_t>(H) * P;
  const float* src = x + (chunk * Q * H + h) * P;
  if (vec) {
    const int c = (tid & 15) * 4;
    if (c < P)
      for (int r = tid >> 4; r < Qp; r += kThreads / 16) {
        const bool in = r < Q;
        cp_async16(smem_u32(xb + r * kXS + c), in ? src + r * rs + c : src, in ? 16 : 0);
      }
  } else {
    const int c = tid & 63;
    if (c < P)
      for (int r = tid >> 6; r < Qp; r += kThreads / 64) {
        const bool in = r < Q;
        cp_async4(smem_u32(xb + r * kXS + c), in ? src + r * rs + c : src, in ? 4 : 0);
      }
  }
}

// the four weights of one 16 x 8 tile that a lane holds, in A-fragment
// order (rows i0, i0 + 8; columns j0, j0 + 4), split for the tensor cores
__device__ __forceinline__ void weights(float4 s, float ci0, float ci1, int i0, int j0,
                                        float cj0, float cj1, float dj0, float dj1,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int i1 = i0 + 8, j1 = j0 + 4;
  const bool k0 = j0 <= i0, k1 = j0 <= i1, k2 = j1 <= i0, k3 = j1 <= i1;
  const float e0 = expf(k0 ? ci0 - cj0 : 0.0f), e1 = expf(k1 ? ci1 - cj0 : 0.0f);
  const float e2 = expf(k2 ? ci0 - cj1 : 0.0f), e3 = expf(k3 ? ci1 - cj1 : 0.0f);
  const float w[4] = {k0 ? s.x * e0 * dj0 : 0.0f, k1 ? s.y * e1 * dj0 : 0.0f,
                      k2 ? s.z * e2 * dj1 : 0.0f, k3 ? s.w * e3 * dj1 : 0.0f};
  split4(w, ah, al);
}

// one 8-key block of a warp's products, with the weights of every product
// formed first and the mma of all of them issued together, one pass per
// compensation term, so that up to 3 x NT accumulator chains interleave.
// DA, DB: y's row tiles A and B take this block; DS: the state takes it.
template <int NT, bool DA, bool DB, bool DS>
__device__ __forceinline__ void kb_step(float (&accA)[8][4], float (&accB)[8][4],
                                        float (&sacc)[8][4], float4 fA, float4 fB, float4 fS,
                                        const float (&ci)[4], int iA, int iB,
                                        const uint32_t* xhi, const uint32_t* xlo,
                                        const float* cum, const float* dts, const float* dsc,
                                        int kb, int g, int t) {
  const int j0 = 8 * kb + t, j1 = j0 + 4;
  // x's B fragment (split once per head): rows j0 and j1, column 8 nt + g
  uint32_t xh[NT][2], xl[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    xh[nt][0] = xhi[j0 * kXS + 8 * nt + g];
    xh[nt][1] = xhi[j1 * kXS + 8 * nt + g];
    xl[nt][0] = xlo[j0 * kXS + 8 * nt + g];
    xl[nt][1] = xlo[j1 * kXS + 8 * nt + g];
  }
  uint32_t ah[3][4], al[3][4];
  if (DA || DB) {
    const float cj0 = cum[j0], cj1 = cum[j1], dj0 = dts[j0], dj1 = dts[j1];
    // w_ij = s_ij * exp(cum_i - cum_j) * dt_j, and 0 above the diagonal by a
    // select, as jnp.where (there the exp may overflow, and 0 * inf would be
    // a NaN): the exp's argument is 0 there, so every lane runs the same code
    if (DA) weights(fA, ci[0], ci[1], iA, j0, cj0, cj1, dj0, dj1, ah[0], al[0]);
    if (DB) weights(fB, ci[2], ci[3], iB, j0, cj0, cj1, dj0, dj1, ah[1], al[1]);
  }
  if (DS) {  // (B_j * exp(cum_{Q-1} - cum_j) * dt_j)^T: rows n, columns j0, j1
    const float e0 = dsc[j0], e1 = dsc[j1];
    const float a[4] = {fS.x * e0, fS.y * e0, fS.z * e1, fS.w * e1};
    split4(a, ah[2], al[2]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (DA) mma_tf32(accA[nt], ah[0], xl[nt][0], xl[nt][1]);
    if (DB) mma_tf32(accB[nt], ah[1], xl[nt][0], xl[nt][1]);
    if (DS) mma_tf32(sacc[nt], ah[2], xl[nt][0], xl[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (DA) mma_tf32(accA[nt], al[0], xh[nt][0], xh[nt][1]);
    if (DB) mma_tf32(accB[nt], al[1], xh[nt][0], xh[nt][1]);
    if (DS) mma_tf32(sacc[nt], al[2], xh[nt][0], xh[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (DA) mma_tf32(accA[nt], ah[0], xh[nt][0], xh[nt][1]);
    if (DB) mma_tf32(accB[nt], ah[1], xh[nt][0], xh[nt][1]);
    if (DS) mma_tf32(sacc[nt], ah[2], xh[nt][0], xh[nt][1]);
  }
}

// one product's A-operand fragments (scores or B^T) from L2, two key blocks
// ahead of their use: f for this block, f1 for the next, p at the one after
struct Frags {
  const float4* p;
  float4 f, f1;
  __device__ __forceinline__ void advance(bool more) {
    f = f1;
    f1 = more ? __ldg(p) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    p += 32;
  }
};

// the key blocks [kb, end), in which the same products (DA, DB, DS) take
// every block: one straight-line body, chosen once per phase
template <int NT, bool DA, bool DB, bool DS>
__device__ __forceinline__ void run_blocks(int kb, int end, int kbA, int kbB, int s1, Frags& fa,
                                           Frags& fb, Frags& fs, float (&accA)[8][4],
                                           float (&accB)[8][4], float (&sacc)[8][4],
                                           const float (&ci)[4], int iA, int iB,
                                           const uint32_t* xhi, const uint32_t* xlo,
                                           const float* cum, const float* dts, const float* dsc,
                                           int g, int t) {
#pragma unroll 1
  for (; kb < end; ++kb) {
    kb_step<NT, DA, DB, DS>(accA, accB, sacc, fa.f, fb.f, fs.f, ci, iA, iB, xhi, xlo, cum, dts,
                            dsc, kb, g, t);
    if (DA) fa.advance(kb + 2 < kbA);
    if (DB) fb.advance(kb + 2 < kbB);
    if (DS) fs.advance(kb + 2 < s1);
  }
}

// (v0, v1) into row[p], row[p + 1] where they exist
__device__ __forceinline__ void store2(float* row, int p, int P, float v0, float v1) {
  if (p + 1 < P && !(P & 1)) {
    *reinterpret_cast<float2*>(row + p) = make_float2(v0, v1);
  } else if (p < P) {
    row[p] = v0;
    if (p + 1 < P) row[p + 1] = v1;
  }
}

// NT: y's n-tiles of 8 columns, ceil(P / 8)
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_heads_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float4* __restrict__ sc,
                 const float4* __restrict__ bt, float* __restrict__ y, float* __restrict__ st,
                 float* __restrict__ dec, int nc, int Q, int H, int P, int N, int G, int vec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float warp_tot[kWarps];
  const int Mq = (Q + 15) >> 4, Qp = 16 * Mq, KB = 2 * Mq, Nt = (N + 15) >> 4;
  float* xring = sm;                       // two heads' x, Qp * kXS each
  uint32_t* xlo = reinterpret_cast<uint32_t*>(sm + 2 * Qp * kXS);  // max(Qp, 64) * kXS
  float* part = sm + 2 * Qp * kXS;         // after the products: the state's second
                                           // key half, 4 x 16 x kXS, over xlo
  float* cum = sm + (2 * Qp + max(Qp, 64)) * kXS;  // Qp each
  float* dts = cum + Qp;
  float* dsc = dts + Qp;                   // exp(cum_{Q-1} - cum_j) * dt_j, 0 past Q

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t chunk = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const int h0 = blockIdx.x * G, nh = min(G, H - h0);
  const float4* scc = sc + chunk * Mq * (Mq + 1) * 32 + lane;
  const float4* btc = bt + chunk * Nt * KB * 32 + lane;

  // this warp's work: y's row tiles mA and mB (key blocks [0, kbA) and
  // [0, kbB); 0: none), and the state's rows [16 nm, 16 nm + 16) over the key
  // blocks [s0, s1), one half of them (KB is even; the halves are added at
  // the end)
  const int mA = warp, mB = Mq - 1 - warp;
  const int kbA = mA <= mB ? 2 * (mA + 1) : 0, kbB = mB > mA ? 2 * (mB + 1) : 0;
  const int nm = warp & 3, kh = warp >> 2;
  const int s0 = nm < Nt ? kh * (KB / 2) : 0, s1 = nm < Nt ? (kh ? KB : KB / 2) : 0;
  const int kb_end = max(max(kbA, kbB), s1);
  const float4* sA = scc + static_cast<int64_t>(mA) * (mA + 1) * 32;
  const float4* sB = scc + static_cast<int64_t>(mB) * (mB + 1) * 32;
  const float4* bq = btc + static_cast<int64_t>(nm) * KB * 32;

  load_x(xring, x, chunk, h0, Q, Qp, H, P, vec);
  cp_async_commit();
  const int64_t dt_row = (chunk * Q + tid) * H;
  float d_next = tid < Q ? dt[dt_row + h0] : 0.0f, a_next = A[h0];

  for (int hl = 0; hl < nh; ++hl) {
    const int h = h0 + hl;
    float* xs = xring + (hl & 1) * Qp * kXS;
    __syncthreads();  // the previous head's readers of the ring half and cum are done
    if (hl + 1 < nh) load_x(xring + ((hl + 1) & 1) * Qp * kXS, x, chunk, h + 1, Q, Qp, H, P, vec);
    cp_async_commit();
    const float d = d_next, a_h = a_next;
    if (hl + 1 < nh) {
      a_next = A[h + 1];
      if (tid < Q) d_next = dt[dt_row + h + 1];
    }

    // inclusive cumsum of dt * A over the chunk (one row per thread)
    float v = tid < Q ? d * a_h : 0.0f;
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float s = lane < kWarps ? warp_tot[lane] : 0.0f;
      for (int off = 1; off < kWarps; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += u;
      }
      if (lane < kWarps) warp_tot[lane] = s;
    }
    __syncthreads();
    if (warp > 0) v += warp_tot[warp - 1];
    if (tid < Qp) {
      cum[tid] = tid < Q ? v : 0.0f;
      dts[tid] = tid < Q ? d : 0.0f;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    if (tid < Qp) dsc[tid] = tid < Q ? expf(cum_last - cum[tid]) * dts[tid] : 0.0f;
    if (tid == 0) dec[chunk * H + h] = expf(cum_last);
    cp_async_wait<1>();  // this head's x has landed (the next head's may be in flight)
    if (hl == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the scores
    __syncthreads();
    // x split once for every warp's products: hi in place, lo beside it
    uint32_t* xhi = reinterpret_cast<uint32_t*>(xs);
    for (int i = tid; i < Qp * 16; i += kThreads) {
      const int o = (i >> 4) * kXS + (i & 15) * 4;
      const float4 v = *reinterpret_cast<const float4*>(xs + o);
      uint4 h, l;
      split(v.x, h.x, l.x);
      split(v.y, h.y, l.y);
      split(v.z, h.z, l.z);
      split(v.w, h.w, l.w);
      *reinterpret_cast<uint4*>(xhi + o) = h;
      *reinterpret_cast<uint4*>(xlo + o) = l;
    }
    __syncthreads();

    float accA[8][4], accB[8][4], sacc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) accA[nt][r] = accB[nt][r] = sacc[nt][r] = 0.0f;
    const int iA = 16 * mA + g, iB = 16 * mB + g;
    const float ci[4] = {kbA ? cum[iA] : 0.0f, kbA ? cum[iA + 8] : 0.0f,
                         kbB ? cum[iB] : 0.0f, kbB ? cum[iB + 8] : 0.0f};
    // score and B^T fragments two key blocks ahead of their use (from L2)
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    Frags fa = {sA + 64, kbA > 0 ? __ldg(sA) : zero, kbA > 1 ? __ldg(sA + 32) : zero};
    Frags fb = {sB + 64, kbB > 0 ? __ldg(sB) : zero, kbB > 1 ? __ldg(sB + 32) : zero};
    Frags fs = {bq + (s0 + 2) * 32, s0 < s1 ? __ldg(bq + s0 * 32) : zero,
                s0 + 1 < s1 ? __ldg(bq + (s0 + 1) * 32) : zero};

    // the key blocks in phases over which the same products take every block
    for (int kb = 0; kb < kb_end;) {
      const bool da = kb < kbA, db = kb < kbB, ds = kb >= s0 && kb < s1;
      int end = kb_end;
      if (da) end = min(end, kbA);
      if (db) end = min(end, kbB);
      end = min(end, ds ? s1 : (kb < s0 ? s0 : end));
      switch (4 * da + 2 * db + ds) {  // the same for the whole warp
#define SSD_PHASE(DA, DB, DS)                                                                \
  case 4 * DA + 2 * DB + DS:                                                               \
    run_blocks<NT, DA, DB, DS>(kb, end, kbA, kbB, s1, fa, fb, fs, accA, accB, sacc, ci, iA, \
                               iB, xhi, xlo, cum, dts, dsc, g, t);                         \
    break;
        SSD_PHASE(1, 1, 1)
        SSD_PHASE(1, 1, 0)
        SSD_PHASE(1, 0, 1)
        SSD_PHASE(1, 0, 0)
        SSD_PHASE(0, 1, 1)
        SSD_PHASE(0, 1, 0)
        SSD_PHASE(0, 0, 1)
#undef SSD_PHASE
        default:
          break;
      }
      kb = end;
    }

    // y: c0, c1 at row 16 m + g, columns 8 nt + 2t, + 1; c2, c3 eight rows down
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = iA + 8 * hr;
      if (kbA && i < Q) {
        float* yrow = y + ((chunk * Q + i) * H + h) * P;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          store2(yrow, 8 * nt + 2 * t, P, accA[nt][2 * hr], accA[nt][2 * hr + 1]);
      }
      const int k = iB + 8 * hr;
      if (kbB && k < Q) {
        float* yrow = y + ((chunk * Q + k) * H + h) * P;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          store2(yrow, 8 * nt + 2 * t, P, accB[nt][2 * hr], accB[nt][2 * hr + 1]);
      }
    }
    // the state: the second key half through shared memory (over xlo, once
    // every warp is done with it) into the first
    __syncthreads();
    float* pw = part + nm * 16 * kXS;
    if (kh == 1 && s0 < s1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        pw[g * kXS + 8 * nt + 2 * t] = sacc[nt][0];
        pw[g * kXS + 8 * nt + 2 * t + 1] = sacc[nt][1];
        pw[(g + 8) * kXS + 8 * nt + 2 * t] = sacc[nt][2];
        pw[(g + 8) * kXS + 8 * nt + 2 * t + 1] = sacc[nt][3];
      }
    }
    __syncthreads();
    if (kh == 0 && s0 < s1) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = 16 * nm + g + 8 * hr;
        if (n >= N) continue;
        float* srow = st + ((chunk * H + h) * N + n) * P;
        const float* prow = pw + (g + 8 * hr) * kXS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int p = 8 * nt + 2 * t;
          store2(srow, p, P, sacc[nt][2 * hr] + prow[p], sacc[nt][2 * hr + 1] + prow[p + 1]);
        }
      }
    }
  }
}

size_t heads_smem(int Q) {
  const size_t qp = 16 * static_cast<size_t>((Q + 15) / 16);
  return sizeof(float) * ((2 * qp + (qp > 64 ? qp : 64)) * kXS + 3 * qp);
}

// The heads kernel's shared memory above 48 KB: allowed once per
// (instantiation, device), at the largest layout (Q = 256), which serves
// every smaller one.
template <int NT>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(ssd_heads_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(heads_smem(kMaxRows)));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return e;
}

template <int NT>
cudaError_t launch_heads(const float* x, const float* dt, const float* A, const float4* sc,
                         const float4* bt, float* y, float* st, float* dec, int B, int nc,
                         int Q, int H, int P, int N, int G, int vec, cudaStream_t s) {
  cudaError_t e = prepare<NT>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((H + G - 1) / G, nc, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = heads_smem(Q);
  cfg.stream = s;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ssd_heads_kernel<NT>, x, dt, A, sc, bt, y, st, dec, nc, Q, H,
                            P, N, G, vec);
}

}  // namespace

// sc: B * nc * Mq (Mq + 1) * 128 floats and bt: B * nc * ceil(N / 16) * 2 Mq
// * 128 floats of scratch (Mq = ceil(Q / 16)); G heads per block of the
// heads kernel; vec: x's rows may be copied as 16-byte vectors (P % 4 == 0,
// x 16-byte aligned).
extern "C" int ssd_intra_chunk(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* sc, void* bt, void* y, void* st, void* dec,
                               int B, int nc, int Q, int H, int P, int N, int G, int vec,
                               void* stream) {
  if (B == 0 || nc == 0 || H == 0) return 0;
  if (Q < 1 || Q > kMaxRows || P < 1 || P > 64 || N < 1 || N > 64 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Mq = (Q + 15) / 16, units = Mq * (Mq + 1) + ((N + 15) / 16) * 2 * Mq;
  ssd_scores_kernel<<<dim3((units + kWarps - 1) / kWarps, nc, B), kThreads, 0, s>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(sc),
      static_cast<float4*>(bt), nc, Q, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float *xf = static_cast<const float*>(x), *dtf = static_cast<const float*>(dt),
              *af = static_cast<const float*>(A);
  const float4 *scf = static_cast<const float4*>(sc), *btf = static_cast<const float4*>(bt);
  float *yf = static_cast<float*>(y), *sf = static_cast<float*>(st),
        *df = static_cast<float*>(dec);
  switch ((P + 7) / 8) {
#define SSD_HEADS(NT)                                                                       \
  case NT:                                                                                  \
    e = launch_heads<NT>(xf, dtf, af, scf, btf, yf, sf, df, B, nc, Q, H, P, N, G, vec, s); \
    break;
    SSD_HEADS(1)
    SSD_HEADS(2)
    SSD_HEADS(3)
    SSD_HEADS(4)
    SSD_HEADS(5)
    SSD_HEADS(6)
    SSD_HEADS(7)
    SSD_HEADS(8)
#undef SSD_HEADS
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
