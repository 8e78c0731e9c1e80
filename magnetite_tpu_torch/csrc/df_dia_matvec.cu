// Double-float banded block SpMV on Hopper (sm_90a): an f64-grade
//
//     y[i, n] = sum_d sum_j K_d[i, j, n] * u[j, n + off_d],   0 <= n + off_d < N
//
// for 2x2 blocks, computed in f32 from hi/lo pairs. bands_hl [D, 2, 2, 2, N]
// holds (Kh, Kl) = df_split(K) at axis 1, split once when the problem is
// compiled; u [2, N] is f64 and is split per element in the kernel
// (uh = f32(u), ul = f32(u - uh)); y [2, N] is f64.
//
// Replaces magnetite_tpu/pallas/dia_kernel.py::_df_kernel (launched by
// _df_dia_matvec_tiled, built by make_df_dia_operator), with its arithmetic:
// Kh and uh are Veltkamp-split (factor 4097) into exact 12-bit halves
// (b1 + b2, u1 + u2); the three exact products b1*u1, b1*u2, b2*u1 go
// through branch-free two-sum into (S, C); b2*u2 + Kh*ul + Kl*uh add plainly
// into C; Kl*ul (2^-48 of the term) is dropped; y = f64(S) + f64(C). The
// error is about 1.3e-14 of sum |K||u| (pallas/dia_kernel.py:266-267).
//
// Veltkamp and two-sum are exact only when every product and sum rounds on
// its own. nvcc contracts a*b + c into one FMA by default, which breaks
// both, and the other kernels of this library are built with that default.
// So every operation here is an explicit __fmul_rn / __fadd_rn / __fsub_rn
// intrinsic, which nvcc never contracts: the arithmetic matches the plain
// PyTorch version (kernels/df_kernel.py) operation for operation.
//
// What bounds it: device-memory bandwidth, as for dia_matvec<double>. The
// hi/lo pair streams 8 bytes per band entry, as f64 does, and ~30 f32 flops
// per entry stay far below the card's f32 rate. Design as dia_matvec.cu:
// one thread per node, coalesced band planes, offsets in shared memory,
// u's window in L2, out-of-range columns skipped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kVeltkamp = 4097.0f;  // 2^12 + 1: exact 12-bit halves of an f32

__device__ __forceinline__ void veltkamp(float x, float& hi, float& lo) {
  const float t = __fmul_rn(kVeltkamp, x);
  hi = __fsub_rn(t, __fsub_rn(t, x));
  lo = __fsub_rn(x, hi);
}

// (s, c) <- (s + p, c + rounding error of s + p): Knuth's two-sum
__device__ __forceinline__ void two_sum_acc(float& s, float& c, float p) {
  const float s2 = __fadd_rn(s, p);
  const float z = __fsub_rn(s2, s);
  const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(s2, z)), __fsub_rn(p, z));
  s = s2;
  c = __fadd_rn(c, e);
}

__global__ void __launch_bounds__(kThreads) df_dia_matvec_kernel(
    const float* __restrict__ bands, const int* __restrict__ offsets,
    int n_diags, const double* __restrict__ u, double* __restrict__ y,
    int64_t n) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < n_diags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;

  float s[2] = {0.0f, 0.0f};
  float c[2] = {0.0f, 0.0f};
  const int64_t plane = n;
  const float* b = bands + row;
  for (int d = 0; d < n_diags; ++d, b += 8 * plane) {
    const int64_t col = row + s_off[d];
    if (col < 0 || col >= n) continue;
    float uh[2], ul[2], u1[2], u2[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const double v = __ldg(u + j * plane + col);
      uh[j] = __double2float_rn(v);
      ul[j] = __double2float_rn(__dsub_rn(v, static_cast<double>(uh[j])));
      veltkamp(uh[j], u1[j], u2[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bh = __ldg(b + (i * 2 + j) * plane);
        const float bl = __ldg(b + (4 + i * 2 + j) * plane);
        float b1, b2;
        veltkamp(bh, b1, b2);
        two_sum_acc(s[i], c[i], __fmul_rn(b1, u1[j]));
        two_sum_acc(s[i], c[i], __fmul_rn(b1, u2[j]));
        two_sum_acc(s[i], c[i], __fmul_rn(b2, u1[j]));
        c[i] = __fadd_rn(
            __fadd_rn(__fadd_rn(c[i], __fmul_rn(b2, u2[j])), __fmul_rn(bh, ul[j])),
            __fmul_rn(bl, uh[j]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    y[i * plane + row] = __dadd_rn(static_cast<double>(s[i]), static_cast<double>(c[i]));
  }
}

}  // namespace

// Returns a cudaError_t code (0 = launched).
extern "C" int mt_df_dia_matvec(const void* bands_hl, const void* offsets,
                                int n_diags, const void* u, void* y, int64_t n,
                                void* stream) {
  if (n <= 0 || n_diags <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  df_dia_matvec_kernel<<<static_cast<unsigned>(blocks), kThreads,
                         n_diags * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bands_hl), static_cast<const int*>(offsets),
      n_diags, static_cast<const double*>(u), static_cast<double*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
