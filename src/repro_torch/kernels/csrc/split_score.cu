// Split-scoring kernels for Hopper (sm_90a), float64.
//
// Replaces the TPU kernels of the JAX reference
//   repro/kernels/split_score.py::score_2way_pallas  (kernel _score2_kernel)
//   repro/kernels/split_score.py::score_3way_pallas  (kernel _score3_kernel)
// which score every candidate split of each batch row's worst interval for
// the lockstep splitting loop of the Section-5 campaign.
//
// What bounds them: a fused elementwise pass in fp64 with no reduction across
// threads.  A 2-way call moves about 64 bytes per (row, cut lane) for ~22
// fp64 operations; a 3-way call about 312 bytes per (row, pair lane) for ~90
// operations, ~0.3 flop/byte in both, far below the card's fp64 ridge
// (~10 flop/byte).  They are bound by device-memory bytes.
//
// What the design does about it: one thread per (row, lane), lanes on
// threadIdx.x so that every load and store of a warp is one contiguous,
// coalesced 256-byte run; each input is read once and each output written
// once, straight into its final place (both placement orders of the 2-way
// call go to the two halves of the (A, 2K) outputs, no concatenation pass).
// The few per-row values (interval ends, inverse speeds, the 6x3 permuted
// speeds of the 3-way call) are the same address for all lanes of a row and
// are served from L1/L2.  Lanes at or past the row's live-lane bound `need`
// skip their loads and write zeros.
//
// Exactness: the outputs are bit-identical to numpy's float64.  Every product
// and sum is an explicit round-to-nearest intrinsic (__dmul_rn, __dadd_rn,
// __dsub_rn, __ddiv_rn), which nvcc never contracts into an FMA, the library
// is built with -fmad=false as well, and the reference's runtime `zero` guard
// (a * b + zero) and left-associated 3-part sum ((c0 + c1) + c2) are kept.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxGridY = 65535;

// numpy's max: NaN wins, otherwise the larger value (the first on ties).
__device__ __forceinline__ double np_max(double m, double x) {
  return (m != m || m >= x) ? m : x;
}

// kBPtr: `b` is read from device memory (`bp`, one float64) instead of being
// passed by value, so that a launch captured in a CUDA graph serves any
// bandwidth; the same double, the same quotients.
template <bool kBPtr>
__global__ void score_2way_kernel(
    const double* __restrict__ pre_d1, const double* __restrict__ pre_C,
    const double* __restrict__ pre_e, const double* __restrict__ del_d1,
    const double* __restrict__ del_C, const double* __restrict__ del_e,
    const double* __restrict__ inv_j, const double* __restrict__ inv_p,
    const int64_t* __restrict__ need, double b_val,
    const double* __restrict__ bp, double zero,
    double* __restrict__ cyc1, double* __restrict__ cyc2,
    double* __restrict__ dlat, int64_t A, int64_t K) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const double b = kBPtr ? *bp : b_val;
  for (int64_t a = blockIdx.y; a < A; a += gridDim.y) {
    const int64_t lane = a * K + k;
    double* c1 = cyc1 + a * 2 * K;
    double* c2 = cyc2 + a * 2 * K;
    double* dl = dlat + a * 2 * K;
    if (k >= need[a]) {
      c1[k] = 0.0; c1[K + k] = 0.0;
      c2[k] = 0.0; c2[K + k] = 0.0;
      dl[k] = 0.0; dl[K + k] = 0.0;
      continue;
    }
    const double pc = pre_C[lane];
    const double W1 = __dsub_rn(pc, pre_d1[a]);
    const double W2 = __dsub_rn(pre_e[a], pc);
    const double dIn = __ddiv_rn(del_d1[a], b);
    const double dMid = __ddiv_rn(del_C[lane], b);
    const double dOut = __ddiv_rn(del_e[a], b);
    const double ij = inv_j[a];
    const double ip = inv_p[a];
    const double dinv = __dsub_rn(ip, ij);
    // order A: first part stays on j; order B: swapped
    c1[k] = __dadd_rn(__dadd_rn(dIn, __dadd_rn(__dmul_rn(W1, ij), zero)), dMid);
    c1[K + k] = __dadd_rn(__dadd_rn(dIn, __dadd_rn(__dmul_rn(W1, ip), zero)), dMid);
    c2[k] = __dadd_rn(__dadd_rn(dMid, __dadd_rn(__dmul_rn(W2, ip), zero)), dOut);
    c2[K + k] = __dadd_rn(__dadd_rn(dMid, __dadd_rn(__dmul_rn(W2, ij), zero)), dOut);
    dl[k] = __dadd_rn(dMid, __dadd_rn(__dmul_rn(W2, dinv), zero));
    dl[K + k] = __dadd_rn(dMid, __dadd_rn(__dmul_rn(W1, dinv), zero));
  }
}

__global__ void score_3way_kernel(
    const double* __restrict__ dI, const double* __restrict__ W,
    const double* __restrict__ dO, const double* __restrict__ invp,
    const double* __restrict__ base, const int64_t* __restrict__ need,
    double zero, double* __restrict__ cyc, double* __restrict__ dlat,
    double* __restrict__ mx, int64_t A, int64_t K) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  for (int64_t a = blockIdx.y; a < A; a += gridDim.y) {
    double* cy = cyc + a * 18 * K;    // (6 perms, 3 parts, K)
    double* dl = dlat + a * 6 * K;    // (6 perms, K)
    double* m = mx + a * 6 * K;
    if (k >= need[a]) {
      for (int q = 0; q < 18; ++q) cy[q * K + k] = 0.0;
      for (int pi = 0; pi < 6; ++pi) { dl[pi * K + k] = 0.0; m[pi * K + k] = 0.0; }
      continue;
    }
    double di[3], w[3], d_o[3];
    for (int q = 0; q < 3; ++q) {
      const int64_t lane = (a * 3 + q) * K + k;
      di[q] = dI[lane];
      w[q] = W[lane];
      d_o[q] = dO[lane];
    }
    const double bt = base[a];
    const double* ip = invp + a * 18;
    for (int pi = 0; pi < 6; ++pi) {
      double comp[3], c[3];
      for (int q = 0; q < 3; ++q) {
        comp[q] = __dadd_rn(di[q], __dadd_rn(__dmul_rn(w[q], ip[pi * 3 + q]), zero));
        c[q] = __dadd_rn(comp[q], d_o[q]);
        cy[(pi * 3 + q) * K + k] = c[q];
      }
      dl[pi * K + k] = __dsub_rn(__dadd_rn(__dadd_rn(comp[0], comp[1]), comp[2]), bt);
      m[pi * K + k] = np_max(np_max(c[0], c[1]), c[2]);
    }
  }
}

dim3 grid_for(int64_t A, int64_t K) {
  const int64_t gx = (K + kThreads - 1) / kThreads;
  const unsigned gy = (unsigned)(A < (int64_t)kMaxGridY ? A : kMaxGridY);
  return dim3((unsigned)gx, gy, 1);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous float64 / int64 tensors; the launch goes on `stream`.  Returns
// the cudaError_t of the launch (0 on success); nothing is synchronised.
extern "C" int score_2way_f64(
    const double* pre_d1, const double* pre_C, const double* pre_e,
    const double* del_d1, const double* del_C, const double* del_e,
    const double* inv_j, const double* inv_p, const int64_t* need,
    double b, double zero, double* cyc1, double* cyc2, double* dlat,
    int64_t A, int64_t K, void* stream) {
  if (A <= 0 || K <= 0) return 0;
  score_2way_kernel<false><<<grid_for(A, K), kThreads, 0, (cudaStream_t)stream>>>(
      pre_d1, pre_C, pre_e, del_d1, del_C, del_e, inv_j, inv_p, need, b, nullptr,
      zero, cyc1, cyc2, dlat, A, K);
  return (int)cudaGetLastError();
}

// The same, with `b` read on the device from `b_ptr` (a 0-dim float64
// tensor): the entry point of the fused engine, whose launches are captured
// in CUDA graphs and replayed for any batch.
extern "C" int score_2way_f64_bptr(
    const double* pre_d1, const double* pre_C, const double* pre_e,
    const double* del_d1, const double* del_C, const double* del_e,
    const double* inv_j, const double* inv_p, const int64_t* need,
    const double* b_ptr, double zero, double* cyc1, double* cyc2, double* dlat,
    int64_t A, int64_t K, void* stream) {
  if (A <= 0 || K <= 0) return 0;
  score_2way_kernel<true><<<grid_for(A, K), kThreads, 0, (cudaStream_t)stream>>>(
      pre_d1, pre_C, pre_e, del_d1, del_C, del_e, inv_j, inv_p, need, 0.0, b_ptr,
      zero, cyc1, cyc2, dlat, A, K);
  return (int)cudaGetLastError();
}

extern "C" int score_3way_f64(
    const double* dI, const double* W, const double* dO, const double* invp,
    const double* base, const int64_t* need, double zero, double* cyc,
    double* dlat, double* mx, int64_t A, int64_t K, void* stream) {
  if (A <= 0 || K <= 0) return 0;
  score_3way_kernel<<<grid_for(A, K), kThreads, 0, (cudaStream_t)stream>>>(
      dI, W, dO, invp, base, need, zero, cyc, dlat, mx, A, K);
  return (int)cudaGetLastError();
}
