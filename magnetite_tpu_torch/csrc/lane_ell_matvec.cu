// Lane-batched block-ELL SpMV on Hopper (sm_90a), the operator of the
// design sweeps' fallback route for band-hostile meshes:
//
//   y[i, n, b] = sum_k sum_j ell[n, k, i, j] * u[j, cols[n, k], b]
//
// ell [N, W, 2, 2] (a node's W blocks of 2x2, row-major), cols [N, W]
// int32 (padding slots point at the row's own node and hold zero blocks),
// y [2, N, B] and u [2, N_u, B] lane fields (B minormost), N_u >= N: the
// sweeps run N_u = N; the all-gather sharded batch solve
// (parallel/sharding.py) runs a shard's N rows against the whole gathered
// field, its cols global indices. f32 and f64 instances; the per-lane
// stiffness scale stays outside, as for the lane band kernel.
//
// No TPU kernel stands behind this one: the JAX package computes the same
// function as magnetite_tpu/fem/operator.py:27 (`ell_matvec`, a gather and
// an einsum) under `jax.vmap` over the lanes (parallel/sweep.py:692,
// `_sweep_vmap`), which XLA fuses; there is no `pallas_call`. Its plain
// PyTorch form gathers [2, N, W, B] per matvec (0.99 GB in f32 at the
// shuffled sweep plate, N = 3,774, W = 8, B = 4,096), hence the kernel.
//
// What bounds it: device memory. u is read once and y written once (4 N B
// values), the blocks and cols once (4 N W values + 4 N W bytes); 8 flops
// per (slot, lane) leave the bytes the bound by ~5x in f32.
//
// Design: one thread per (node, vector of V consecutive lanes). V is 16
// bytes of lanes (4 f32 / 2 f64) when B and the pointers allow it, else 1.
// A team of `team` consecutive threads (a power of two, <= 32) takes
// `team` consecutive lane vectors of one node, so its u loads are one
// coalesced run per slot and component, and its cols / ell loads are
// broadcasts; a block holds kThreads / team nodes. The lane tile (team
// vectors) is the SLOWEST grid index: the blocks in flight work on one
// tile's slice of u (2 N team V values, 3.9 MB in f32 at the shuffled
// plate and B = 4,096), which stays in L2 while scattered cols gather
// from it -- u as a whole (124 MB in f32) does not fit in the 50 MB L2.
// Sums run over the slots in order, component 0 before 1, as the plain
// version's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// V consecutive values from p (16-byte vector loads when V * sizeof(T) is
// 16; the wrapper guarantees the alignment then).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&out)[V]) {
  if constexpr (V * sizeof(T) == 16 && sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  } else if constexpr (V * sizeof(T) == 16 && sizeof(T) == 8) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    out[0] = q.x; out[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = __ldg(p + k);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const T (&v)[V]) {
  if constexpr (V * sizeof(T) == 16 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V * sizeof(T) == 16 && sizeof(T) == 8) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) lane_ell_kernel(
    const T* __restrict__ ell, const int* __restrict__ cols, const T* __restrict__ u,
    T* __restrict__ y, int64_t n, int64_t n_u, int width, int64_t nb, int team,
    int64_t node_blocks) {
  const int64_t nvec = nb / V;
  const int64_t tile = blockIdx.x / node_blocks;  // the lane tile: slowest index
  const int64_t node = (blockIdx.x % node_blocks) * (kThreads / team) + threadIdx.x / team;
  const int64_t vec = tile * team + threadIdx.x % team;
  if (node >= n || vec >= nvec) return;
  const int64_t lane0 = vec * V;
  const int64_t comp_u = n_u * nb, comp_y = n * nb;  // one component field
  const int* __restrict__ c = cols + node * width;
  const T* __restrict__ e = ell + node * width * 4;
  T acc0[V], acc1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    acc0[k] = T(0);
    acc1[k] = T(0);
  }
#pragma unroll 4
  for (int s = 0; s < width; ++s) {
    const int64_t src = __ldg(c + s);
    const T e00 = __ldg(e + 4 * s), e01 = __ldg(e + 4 * s + 1);
    const T e10 = __ldg(e + 4 * s + 2), e11 = __ldg(e + 4 * s + 3);
    T u0[V], u1[V];
    load_vec<T, V>(u + src * nb + lane0, u0);
    load_vec<T, V>(u + comp_u + src * nb + lane0, u1);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      acc0[k] = acc0[k] + e00 * u0[k] + e01 * u1[k];
      acc1[k] = acc1[k] + e10 * u0[k] + e11 * u1[k];
    }
  }
  store_vec<T, V>(y + node * nb + lane0, acc0);
  store_vec<T, V>(y + comp_y + node * nb + lane0, acc1);
}

template <typename T, int V>
int launch(const void* ell, const void* cols, const void* u, void* y, int64_t n, int64_t n_u,
           int width, int64_t nb, int team, cudaStream_t stream) {
  const int64_t node_blocks = (n + kThreads / team - 1) / (kThreads / team);
  const int64_t tiles = (nb / V + team - 1) / team;
  const int64_t blocks = node_blocks * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  lane_ell_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(ell), static_cast<const int*>(cols), static_cast<const T*>(u),
      static_cast<T*>(y), n, n_u, width, nb, team, node_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int vec, const void* ell, const void* cols, const void* u, void* y, int64_t n,
             int64_t n_u, int width, int64_t nb, int team, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec && nb % kVec == 0) {
    return launch<T, kVec>(ell, cols, u, y, n, n_u, width, nb, team, s);
  }
  if (vec == 1) return launch<T, 1>(ell, cols, u, y, n, n_u, width, nb, team, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; vec: lanes per thread (16 bytes of
// lanes, or 1); team: threads per node (a power of two, 1..32); n_u: the
// nodes of u (>= n). Returns a cudaError_t code (0 = launched).
extern "C" int mt_lane_ell_matvec(int dtype, int vec, int team, const void* ell,
                                  const void* cols, const void* u, void* y, int64_t n,
                                  int64_t n_u, int width, int64_t nb, void* stream) {
  if (n <= 0 || n_u < n || width <= 0 || nb <= 0 || team < 1 || team > 32 ||
      (team & (team - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(vec, ell, cols, u, y, n, n_u, width, nb, team, s);
  if (dtype == 1) return dispatch<double>(vec, ell, cols, u, y, n, n_u, width, nb, team, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
