// Fused device assembly on Hopper (sm_90a): closed-form CST pair blocks
// scattered into the operator's slots, in one pass, without atomics.
//
//   out[i, j, s] = sum over the (a, b, e) with slots[(3a + b) E + e] == s of
//                  k_ij(a, b, e)
//
// k(a, b, e) is the 2x2 stiffness block coupling local nodes a and b of
// element e (magnetite_tpu/fem/element.py::pair_block_fields: t / (2 A2) *
// B_a^T D B_b expanded, A2 twice the signed area); `slots` are the
// pair-major slot ids of the operator (DIA: band * N + row, hybrid: the
// same plus D N + r for the COO remainder, ELL: row * K + k). out [2, 2, S]
// is f64 whatever the solve's type.
//
// No TPU kernel stands behind this one: the JAX package computes the same
// function as fem/dia.py::assemble_dia_fused / assemble_hybrid_fused and
// fem/solve.py::assemble_ell_arrays_fused -- four scalar segment_sums over
// [3, 3, E] fields -- and leaves it to XLA; there is no `pallas_call`.
//
// What bounds it: device memory. The mesh (coords, tris), the slot ids and
// the output are each touched once in the bound; the kernel also reads the
// sorted order of the slot ids (8 bytes per pair) and gathers each pair's
// three node coordinates. ~40 flops per pair leave the bytes the bound.
//
// Design: the slot ids are sorted once on the device (a stable sort by the
// wrapper, with the run boundaries from bincount + cumsum), and one thread
// owns one output slot: it walks its run of pairs in pair-major order,
// evaluates each pair's block from the element's coordinates (the
// [3, 3, E] fields never exist in device memory) and accumulates the four
// scalars in registers. No floating-point atomics: every slot's sum runs in
// the same order on every call, so the operator, and the CG iteration
// counts after it, repeat bit for bit. The arithmetic is written with
// round-to-nearest intrinsics, so no multiply-add is contracted and the
// result is the plain version's (pair_block_fields + four index_add_) to
// the last bit wherever index_add_ sums in index order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

__global__ void __launch_bounds__(kThreads) assemble_pairs_kernel(
    const double* __restrict__ coords, const int64_t* __restrict__ tris,
    const int64_t* __restrict__ order, const int64_t* __restrict__ starts,
    int64_t n_elem, int64_t n_slots, double d0, double d1, double d2, double thick,
    double* __restrict__ out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  double k00 = 0.0, k01 = 0.0, k10 = 0.0, k11 = 0.0;
  const int64_t end = ld(starts + s + 1);
  for (int64_t q = ld(starts + s); q < end; ++q) {
    const int64_t idx = ld(order + q);
    const int64_t pair = idx / n_elem;
    const int64_t e = idx - pair * n_elem;
    const int a = static_cast<int>(pair / 3), b = static_cast<int>(pair % 3);
    double x[3], y[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t node = ld(tris + 3 * e + c);
      x[c] = __ldg(coords + 2 * node);
      y[c] = __ldg(coords + 2 * node + 1);
    }
    // beta_c = y[c+1] - y[c+2], gamma_c = x[c+2] - x[c+1] (indices mod 3)
    const double ba = sub(y[(a + 1) % 3], y[(a + 2) % 3]);
    const double bb = sub(y[(b + 1) % 3], y[(b + 2) % 3]);
    const double ga = sub(x[(a + 2) % 3], x[(a + 1) % 3]);
    const double gb = sub(x[(b + 2) % 3], x[(b + 1) % 3]);
    const double area2 = add(add(mul(x[0], sub(y[1], y[2])), mul(x[1], sub(y[2], y[0]))),
                             mul(x[2], sub(y[0], y[1])));
    const double coef = __ddiv_rn(thick, mul(2.0, area2));
    k00 = add(k00, mul(coef, add(mul(mul(d0, ba), bb), mul(mul(d2, ga), gb))));
    k01 = add(k01, mul(coef, add(mul(mul(d1, ba), gb), mul(mul(d2, ga), bb))));
    k10 = add(k10, mul(coef, add(mul(mul(d1, ga), bb), mul(mul(d2, ba), gb))));
    k11 = add(k11, mul(coef, add(mul(mul(d0, ga), gb), mul(mul(d2, ba), bb))));
  }
  out[s] = k00;
  out[n_slots + s] = k01;
  out[2 * n_slots + s] = k10;
  out[3 * n_slots + s] = k11;
}

}  // namespace

// coords [N, 2] f64, tris [E, 3] int64, order [9E] int64 (pair-major
// indices sorted by slot), starts [S + 1] int64 (each slot's run in
// order), out [2, 2, S] f64. d0 = E / (1 - nu^2), d1 = nu d0, d2 = (1 -
// nu) d0 / 2. Returns a cudaError_t code (0 = launched).
extern "C" int mt_assemble_pairs(const void* coords, const void* tris, const void* order,
                                 const void* starts, int64_t n_elem, int64_t n_slots,
                                 double d0, double d1, double d2, double thick, void* out,
                                 void* stream) {
  if (n_elem <= 0 || n_slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_slots + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  assemble_pairs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(coords), static_cast<const int64_t*>(tris),
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(starts), n_elem, n_slots,
      d0, d1, d2, thick, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
