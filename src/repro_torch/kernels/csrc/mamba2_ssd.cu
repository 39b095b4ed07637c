// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
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
// Bound on this card: operations.  At zamba2-7b's full width (B = 1,
// nc = 16, Q = 256, H = 112, P = N = 64) the function needs ~11.4 GFLOP
// (the causal pairs of y, the state, the C.B scores once per chunk) against
// ~268 MB of I/O: ~0.17 ms at the 67 TFLOP/s float32 peak of the CUDA
// cores against ~0.08 ms for the bytes.
//
// Design.  The TPU block holds the whole (Q, Q) decay-weighted score matrix
// in VMEM; at Q = 256 that is 256 KiB of float32, more than the 227 KB of
// shared memory a block may have.  Here one block of 256 threads per
// (head, chunk, batch row) scans dt * A into `cum` in shared memory (warp
// shuffles, then the warp totals), then walks 64-row output tiles i and, for
// each, the key tiles j <= i: C_i, B_j and x_j are staged in shared memory
// (B/C rows padded to an odd stride, so the 16 threads that read 16 rows hit
// 16 banks), each thread forms a 4 x 4 patch of w_ij = (C_i . B_j) *
// exp(cum_i - cum_j) * dt_j with a select on j <= i (above the diagonal
// cum_i - cum_j > 0 and the exp may overflow; 0 * inf would be a NaN), the
// 64 x 64 tile of w goes through shared memory, and each thread adds w x_j
// into its 4 x (16 * PJ) patch of y_i in registers.  On the last output tile
// the same key tiles also feed the chunk state, a 4 x (16 * PJ) patch of the
// (N, P) state per thread.  Every sum runs over j (or n) in order.
//
// Float32 on the CUDA cores: the inputs are float32 and the function is held
// to atol 2e-4 against the sequential SSD, at |y| of O(1-10); TF32 keeps ~3
// digits.  The C.B scores do not depend on the head (one B/C group), so a
// later version can compute them once per chunk for all heads, and move the
// products to the tensor cores (TF32 with error compensation, or bf16x3).
//
// Limits: Q <= 256, P <= 64, N <= 64 (the configs use Q in {16, 32, 64,
// 256}, P and N in {16, 32, 64}); every edge is bound-checked.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;        // rows of an output tile and of a key tile
constexpr int kWS = kT + 1;   // row stride of the weight tile

// PJ: output columns per thread in chunks of 16 (16 * PJ >= P)
template <int PJ>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       float* __restrict__ st, float* __restrict__ dec, int nc, int Q,
                       int H, int P, int N) {
  extern __shared__ float sm[];
  __shared__ float warp_tot[kWarps];
  const int ns = N | 1;
  float* c_s = sm;               // kT * ns
  float* b_s = c_s + kT * ns;    // kT * ns
  float* x_s = b_s + kT * ns;    // kT * P
  float* w_s = x_s + kT * P;     // kT * kWS
  float* cum = w_s + kT * kWS;   // Q
  float* dts = cum + Q;          // Q
  float* dsc = dts + Q;          // Q: exp(cum_{Q-1} - cum_j) * dt_j

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x;
  const int64_t chunk = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;

  // inclusive cumsum of dt * A over the chunk (Q <= kThreads: one per thread)
  float v = 0.0f;
  if (tid < Q) {
    const float d = dt[(chunk * Q + tid) * H + h];
    dts[tid] = d;
    v = d * A[h];
  }
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? warp_tot[lane] : 0.0f;
    for (int off = 1; off < kWarps; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += u;
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  if (tid < Q) cum[tid] = v;
  __syncthreads();
  const float cum_last = cum[Q - 1];
  if (tid < Q) dsc[tid] = expf(cum_last - cum[tid]) * dts[tid];
  if (tid == 0) dec[chunk * H + h] = expf(cum_last);

  float sacc[4][PJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < PJ; ++j) sacc[r][j] = 0.0f;

  const int n_tiles = (Q + kT - 1) / kT;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kT;
    const bool last = it == n_tiles - 1;
    __syncthreads();  // the previous tile's readers of c_s are done
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      const int q = i0 + r;
      c_s[r * ns + n] = q < Q ? Cm[(chunk * Q + q) * N + n] : 0.0f;
    }
    float acc[4][PJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[r][j] = 0.0f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // the previous key tile's readers are done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        const int q = j0 + r;
        b_s[r * ns + n] = q < Q ? Bm[(chunk * Q + q) * N + n] : 0.0f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        const int q = j0 + r;
        x_s[r * P + p] = q < Q ? x[((chunk * Q + q) * H + h) * P + p] : 0.0f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[r][k] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = c_s[(ty * 4 + r) * ns + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = b_s[(tx + 16 * k) * ns + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[r][k] += cv[r] * bv[k];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + tx + 16 * k;
          // a select, as jnp.where: the exp is never taken above the diagonal
          const float w = (i < Q && j <= i) ? s[r][k] * expf(cum[i] - cum[j]) * dts[j] : 0.0f;
          w_s[(ty * 4 + r) * kWS + tx + 16 * k] = w;
        }
      }
      __syncthreads();

      for (int c = 0; c < kT; ++c) {
        float wv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = w_s[(ty * 4 + r) * kWS + c];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          const float xv = p < P ? x_s[c * P + p] : 0.0f;
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] += wv[r] * xv;
        }
      }
      if (last) {
        for (int c = 0; c < kT; ++c) {
          const int j = j0 + c;
          const float d = j < Q ? dsc[j] : 0.0f;
          float bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int n = ty * 4 + r;
            bv[r] = n < N ? b_s[c * ns + n] * d : 0.0f;
          }
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) {
            const int p = tx + 16 * jj;
            const float xv = p < P ? x_s[c * P + p] : 0.0f;
#pragma unroll
            for (int r = 0; r < 4; ++r) sacc[r][jj] += bv[r] * xv;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= Q) continue;
      float* yrow = y + ((chunk * Q + i) * H + h) * P;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int p = tx + 16 * j;
        if (p < P) yrow[p] = acc[r][j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = ty * 4 + r;
    if (n >= N) continue;
    float* srow = st + ((chunk * H + h) * N + n) * P;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int p = tx + 16 * j;
      if (p < P) srow[p] = sacc[r][j];
    }
  }
}

template <int PJ>
int launch(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           float* y, float* st, float* dec, int B, int nc, int Q, int H, int P, int N,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(kT) * (N | 1) +
                                       static_cast<size_t>(kT) * P + kT * kWS + 3 * Q);
  auto kern = ssd_intra_chunk_kernel<PJ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, nc, B);
  kern<<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, Cm, y, st, dec, nc, Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_intra_chunk(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* st, void* dec, int B, int nc,
                               int Q, int H, int P, int N, void* stream) {
  if (B == 0 || nc == 0 || H == 0) return 0;
  if (Q < 1 || Q > kThreads || P < 1 || P > 64 || N < 1 || N > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *dtf = static_cast<const float*>(dt),
              *af = static_cast<const float*>(A), *bf = static_cast<const float*>(Bm),
              *cf = static_cast<const float*>(Cm);
  float *yf = static_cast<float*>(y), *sf = static_cast<float*>(st),
        *df = static_cast<float*>(dec);
  switch ((P + 15) / 16) {
    case 1: return launch<1>(xf, dtf, af, bf, cf, yf, sf, df, B, nc, Q, H, P, N, s);
    case 2: return launch<2>(xf, dtf, af, bf, cf, yf, sf, df, B, nc, Q, H, P, N, s);
    case 3: return launch<3>(xf, dtf, af, bf, cf, yf, sf, df, B, nc, Q, H, P, N, s);
    default: return launch<4>(xf, dtf, af, bf, cf, yf, sf, df, B, nc, Q, H, P, N, s);
  }
}
