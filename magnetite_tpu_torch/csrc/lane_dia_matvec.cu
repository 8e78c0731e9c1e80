// Lane-batched banded SpMV on Hopper (sm_90a), the design-sweep operator:
//
//   K7  y[ci, n, b] = sum_d sum_cj B_d[ci, cj, n] * u[cj, n + off_d, b]
//   K8  y[ci, n, b] = wa[b] (Ka u_b)[ci, n] + wb[b] (Kb u_b)[ci, n] + wc[b] (Kc u_b)[ci, n]
//
// for 0 <= n + off_d < N. bands [D, 2, 2, N] (N minormost; K8 takes three
// such basis band sets), u / y [2, N, B] lane fields (B minormost), the
// per-lane basis weights of K8 [B] each. f32 and f64 instances.
//
// Replaces magnetite_tpu/pallas/lane_dia_kernel.py::_kernel (K7, launched
// by _lane_dia_matvec) and ::_kernel3 (K8, launched by _lane_dia_matvec3).
// The TPU kernels put node rows on sublanes, pre-tile the bands into
// [G, tn, D*m*m] VMEM blocks and read u through a two-block window that
// limits the band reach to tn, with B >= 128 and f32 only. None of that
// carries over: any B >= 1, any offsets, f32 and f64.
//
// What bounds them: at the sweep's shape (D = 35, N = 3,774, B = 4,096) K7
// streams u and y once (2 x 2 x N x B values) plus the bands, and does 4
// FMAs per band entry and lane: in f32 its compute time is 87% of its byte
// time, so it is just bytes-bound. K8 does 3 FMAs per band entry and lane
// (12 per offset) on the same u traffic and is compute-bound.
// Design: one thread per (node n, lane b) output pair; a warp holds 32
// consecutive lanes of one node, so every u / y access coalesces along b
// and every band coefficient is one broadcast read. A block covers 8 nodes
// of one 32-lane chunk; the grid walks the nodes fastest, so the blocks in
// flight cover a window of rows around the current one and the u rows that
// D offsets revisit are served from L1 / L2. The offsets are staged in
// shared memory once per block. K8 keeps six accumulators (3 bases x 2
// rows) and combines them with the lane's weights once at the end -- the
// plain version's order (parallel/sweep.py::_lane_weighted_band_matvec);
// the TPU kernel combined the coefficients first only to fit its VMEM
// stack. A term whose row n + off_d leaves [0, N) is skipped, never read:
// the DIA contract zeroes those coefficients, but 0 x (Inf or NaN) is NaN
// and the read would leave the array. Indices are 64-bit: 2 N B passes
// 2^31 at 262k nodes x 4,096 lanes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;  // threadIdx.x: lanes of one node (one warp)
constexpr int kRows = 8;    // threadIdx.y: nodes per block
constexpr int kMaxLaneBlocks = 65535;  // gridDim.y limit

__device__ __forceinline__ void stage_offsets(const int* offsets, int n_diags, int* s_off) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int d = tid; d < n_diags; d += kLanes * kRows) s_off[d] = offsets[d];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kRows) lane_dia_kernel(
    const T* __restrict__ bands, const int* __restrict__ offsets, int n_diags,
    const T* __restrict__ u, T* __restrict__ y, int64_t n, int64_t nb) {
  extern __shared__ int s_off[];
  stage_offsets(offsets, n_diags, s_off);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.y;
  const int64_t lane = static_cast<int64_t>(blockIdx.y) * kLanes + threadIdx.x;
  if (row >= n || lane >= nb) return;

  const int64_t comp = n * nb;  // stride between the two DOF components
  const int64_t plane = n;      // stride between (ci, cj) band planes
  T acc0 = T(0), acc1 = T(0);
  const T* b = bands + row;
  for (int d = 0; d < n_diags; ++d, b += 4 * plane) {
    const int64_t col = row + s_off[d];
    if (col < 0 || col >= n) continue;
    const T* uc = u + col * nb + lane;
    const T u0 = __ldg(uc), u1 = __ldg(uc + comp);
    acc0 = acc0 + __ldg(b) * u0;
    acc0 = acc0 + __ldg(b + plane) * u1;
    acc1 = acc1 + __ldg(b + 2 * plane) * u0;
    acc1 = acc1 + __ldg(b + 3 * plane) * u1;
  }
  y[row * nb + lane] = acc0;
  y[comp + row * nb + lane] = acc1;
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kRows) lane_dia3_kernel(
    const T* __restrict__ ba, const T* __restrict__ bb, const T* __restrict__ bc,
    const T* __restrict__ wa, const T* __restrict__ wb, const T* __restrict__ wc,
    const int* __restrict__ offsets, int n_diags, const T* __restrict__ u,
    T* __restrict__ y, int64_t n, int64_t nb) {
  extern __shared__ int s_off[];
  stage_offsets(offsets, n_diags, s_off);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.y;
  const int64_t lane = static_cast<int64_t>(blockIdx.y) * kLanes + threadIdx.x;
  if (row >= n || lane >= nb) return;

  const int64_t comp = n * nb;
  const int64_t plane = n;
  const T* bk[3] = {ba + row, bb + row, bc + row};
  T acc0[3] = {T(0), T(0), T(0)};
  T acc1[3] = {T(0), T(0), T(0)};
  for (int d = 0; d < n_diags; ++d) {
    const int64_t col = row + s_off[d];
    if (col < 0 || col >= n) continue;
    const T* uc = u + col * nb + lane;
    const T u0 = __ldg(uc), u1 = __ldg(uc + comp);
    const int64_t at = static_cast<int64_t>(d) * 4 * plane;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T* b = bk[k] + at;
      acc0[k] = acc0[k] + __ldg(b) * u0;
      acc0[k] = acc0[k] + __ldg(b + plane) * u1;
      acc1[k] = acc1[k] + __ldg(b + 2 * plane) * u0;
      acc1[k] = acc1[k] + __ldg(b + 3 * plane) * u1;
    }
  }
  const T w0 = __ldg(wa + lane), w1 = __ldg(wb + lane), w2 = __ldg(wc + lane);
  y[row * nb + lane] = acc0[0] * w0 + acc0[1] * w1 + acc0[2] * w2;
  y[comp + row * nb + lane] = acc1[0] * w0 + acc1[1] * w1 + acc1[2] * w2;
}

dim3 grid_of(int64_t n, int64_t nb) {
  return dim3(static_cast<unsigned>((n + kRows - 1) / kRows),
              static_cast<unsigned>((nb + kLanes - 1) / kLanes));
}

bool valid(int64_t n, int64_t nb, int n_diags) {
  return n > 0 && nb > 0 && n_diags > 0 && (nb + kLanes - 1) / kLanes <= kMaxLaneBlocks &&
         (n + kRows - 1) / kRows <= INT32_MAX;
}

template <typename T>
int launch(const void* bands, const void* offsets, int n_diags, const void* u, void* y,
           int64_t n, int64_t nb, cudaStream_t stream) {
  lane_dia_kernel<T><<<grid_of(n, nb), dim3(kLanes, kRows), n_diags * sizeof(int), stream>>>(
      static_cast<const T*>(bands), static_cast<const int*>(offsets), n_diags,
      static_cast<const T*>(u), static_cast<T*>(y), n, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch3(const void* ba, const void* bb, const void* bc, const void* wa, const void* wb,
            const void* wc, const void* offsets, int n_diags, const void* u, void* y,
            int64_t n, int64_t nb, cudaStream_t stream) {
  lane_dia3_kernel<T><<<grid_of(n, nb), dim3(kLanes, kRows), n_diags * sizeof(int), stream>>>(
      static_cast<const T*>(ba), static_cast<const T*>(bb), static_cast<const T*>(bc),
      static_cast<const T*>(wa), static_cast<const T*>(wb), static_cast<const T*>(wc),
      static_cast<const int*>(offsets), n_diags, static_cast<const T*>(u), static_cast<T*>(y),
      n, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Returns a cudaError_t code (0 = launched).
extern "C" int mt_lane_dia_matvec(int dtype, const void* bands, const void* offsets,
                                  int n_diags, const void* u, void* y, int64_t n, int64_t nb,
                                  void* stream) {
  if (!valid(n, nb, n_diags)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(bands, offsets, n_diags, u, y, n, nb, s);
  if (dtype == 1) return launch<double>(bands, offsets, n_diags, u, y, n, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mt_lane_dia_matvec3(int dtype, const void* ba, const void* bb, const void* bc,
                                   const void* wa, const void* wb, const void* wc,
                                   const void* offsets, int n_diags, const void* u, void* y,
                                   int64_t n, int64_t nb, void* stream) {
  if (!valid(n, nb, n_diags)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch3<float>(ba, bb, bc, wa, wb, wc, offsets, n_diags, u, y, n, nb, s);
  if (dtype == 1) return launch3<double>(ba, bb, bc, wa, wb, wc, offsets, n_diags, u, y, n, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
