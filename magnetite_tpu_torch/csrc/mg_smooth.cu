// Fused geometric-multigrid smoothing on Hopper (sm_90a): one V-cycle level
// in two launches.
//
//   mg_presmooth:  e  = smooth^2(0; r),  rc = restrict(r - S e)
//   mg_postsmooth: e' = smooth^2(e + prolong(ec); r)
//
// smooth(e; r) = e + w Dinv (r - S e) is one damped block-Jacobi sweep
// (w = 0.7), S the level's 9-point 2x2-block stencil [9, 2, 2, R, C],
// Dinv [2, 2, R, C] its inverse center blocks, fields [2, R, C] with cols
// minormost. Rows outside the grid contribute 0; columns wrap (WRAP,
// annulus meshes) or contribute 0 outside. restrict is the adjoint of
// bilinear prolongation on fine grids of 2 Rc - 1 rows and 2 Cc (WRAP) or
// 2 Cc - 1 cols. mg_postsmooth takes no e (e = 0) and no ec (no
// correction) for the coarsest level's smoothing solve.
//
// Replaces the V-cycle's use of magnetite_tpu/pallas/stencil_kernel.py::_kernel
// (and ::_kernel_blocked on large grids): the JAX package's cycle calls the
// stencil kernel five times per level and leaves the Jacobi updates and the
// transfers to XLA's fusions. Unfused here, a level took ~64 launches per
// V-cycle, each paying the card's fixed cost of ~7 us, and read the 36
// stencil planes three times per smoothing phase.
//
// What bounds it: device-memory bandwidth at the finest levels (S is 36 of
// the ~45 values per node moved), and at the coarse ones the card's cost
// per launch and the latency of one block's dependent phases. Design: a
// block owns a 16 x 16 tile of fine nodes aligned to even rows and cols (8
// x 8 coarse nodes) and runs both sweeps, the residual and the restriction
// in shared memory, recomputing a halo (each step shrinks the valid region
// by one node):
//   presmooth:  e1 = w Dinv r on halo 3 (top/left) / 2 (bottom/right), e2
//               on 2 / 1, the residual on 1 / 0 -- the restriction of an
//               even-aligned tile reads fine rows 2 cr - 1 .. 2 cr + 1;
//   postsmooth: e0 = e + P ec on halo 2, e1 on 1, e2 on the tile.
// One thread owns one node of the middle region (19 x 19 and 18 x 18
// nodes) and loads that node's 36 stencil values, 4 inverse values and r
// into registers before the first phase, all at once and coalesced along
// cols: the block's only wait on device memory overlaps the first phase,
// and the same registers serve the node's two stencil applications, so S
// is read once per launch (1.4x for the halo). Only the fields that
// neighbours read live in shared memory. A node outside the grid holds
// zeros, so its e and residual come out 0 without a branch. Halo nodes are
// loaded by (c mod cols), so a tile wider than a narrow wrapped level reads
// its own nodes again, and only nodes inside the grid are written. One
// launch covers any level.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr double kOmega = 0.7;
constexpr int kTile = 16;  // fine nodes a side of a block's tile
constexpr int kPreThreads = 384;   // >= 19 * 19 e2 nodes
constexpr int kPostThreads = 352;  // >= 18 * 18 e1 nodes

// (gr, gc) inside the grid; gc folded into [0, cols) when WRAP
template <bool WRAP>
__device__ __forceinline__ bool in_grid(int gr, int& gc, int rows, int cols) {
  if (gr < 0 || gr >= rows) return false;
  if (WRAP) {
    gc %= cols;
    if (gc < 0) gc += cols;
    return true;
  }
  return gc >= 0 && gc < cols;
}

// one node's operator rows and right-hand side, in registers
template <typename T>
struct Node {
  T s[36];  // S[k / 4, (k / 2) % 2, k % 2] at the node
  T d[4];   // Dinv
  T r0, r1;
};

template <typename T>
__device__ __forceinline__ void load_node(Node<T>& nd, bool valid, const T* __restrict__ st,
                                          const T* __restrict__ dinv,
                                          const T* __restrict__ r, int64_t plane, int64_t n) {
#pragma unroll
  for (int k = 0; k < 36; ++k) nd.s[k] = valid ? __ldg(st + k * plane + n) : T(0);
#pragma unroll
  for (int k = 0; k < 4; ++k) nd.d[k] = valid ? __ldg(dinv + k * plane + n) : T(0);
  nd.r0 = valid ? __ldg(r + n) : T(0);
  nd.r1 = valid ? __ldg(r + plane + n) : T(0);
}

// q = r - S u at the node, its neighbours' u at c +- W +- 1 in shared
// memory (zero outside the grid). The association of the sums is the plain
// version's: y += S_i0 u0, then y += S_i1 u1, offset by offset.
template <typename T, int W>
__device__ __forceinline__ void residual(const Node<T>& nd, const T* u0, const T* u1, int c,
                                         T& q0, T& q1) {
  T a0 = T(0), a1 = T(0);
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int k = c + (s / 3 - 1) * W + (s % 3 - 1);
    const T v0 = u0[k], v1 = u1[k];
    a0 += nd.s[4 * s] * v0;
    a0 += nd.s[4 * s + 1] * v1;
    a1 += nd.s[4 * s + 2] * v0;
    a1 += nd.s[4 * s + 3] * v1;
  }
  q0 = nd.r0 - a0;
  q1 = nd.r1 - a1;
}

// e + w Dinv q
template <typename T>
__device__ __forceinline__ void jacobi(const T* d, T e0, T e1, T q0, T q1, T& o0, T& o1) {
  const T w = T(kOmega);
  o0 = e0 + w * (d[0] * q0 + d[1] * q1);
  o1 = e1 + w * (d[2] * q0 + d[3] * q1);
}

template <typename T, bool WRAP>
__global__ void __launch_bounds__(kPreThreads) mg_presmooth_kernel(
    const T* __restrict__ st, const T* __restrict__ dinv, const T* __restrict__ r,
    T* __restrict__ e, T* __restrict__ rc, int rows, int cols, int rcs, int ccs) {
  constexpr int WA = kTile + 5, WB = kTile + 3, WC = kTile + 1, TC = kTile / 2;
  __shared__ T s_a[2][WA * WA];  // e1, then the residual (WC x WC)
  __shared__ T s_b[2][WB * WB];  // e2
  const int64_t plane = static_cast<int64_t>(rows) * cols;
  const int cr0 = blockIdx.y * TC, cc0 = blockIdx.x * TC;
  const int r0 = 2 * cr0, c0 = 2 * cc0;
  const int t = threadIdx.x;

  // the thread's e2 node (WB x WB region, offset -2), loaded up front
  const bool owner = t < WB * WB;
  const int bi = t / WB, bj = t - (t / WB) * WB;
  const int gr = r0 - 2 + bi, gc_raw = c0 - 2 + bj;
  int gc = gc_raw;
  const bool valid = owner && in_grid<WRAP>(gr, gc, rows, cols);
  const int64_t n = valid ? static_cast<int64_t>(gr) * cols + gc : 0;
  Node<T> nd;
  load_node(nd, valid, st, dinv, r, plane, n);

  // 1. e1 = w Dinv r (the first sweep from e = 0)
  for (int k = t; k < WA * WA; k += kPreThreads) {
    const int i = k / WA, j = k - i * WA;
    int c = c0 - 3 + j;
    T v0 = T(0), v1 = T(0);
    if (in_grid<WRAP>(r0 - 3 + i, c, rows, cols)) {
      const int64_t m = static_cast<int64_t>(r0 - 3 + i) * cols + c;
      const T d[4] = {__ldg(dinv + m), __ldg(dinv + plane + m), __ldg(dinv + 2 * plane + m),
                      __ldg(dinv + 3 * plane + m)};
      jacobi(d, T(0), T(0), __ldg(r + m), __ldg(r + plane + m), v0, v1);
    }
    s_a[0][k] = v0;
    s_a[1][k] = v1;
  }
  __syncthreads();

  // 2. e2 = e1 + w Dinv (r - S e1)
  T e20 = T(0), e21 = T(0);
  if (owner) {
    const int c = (bi + 1) * WA + bj + 1;
    T q0, q1;
    residual<T, WA>(nd, s_a[0], s_a[1], c, q0, q1);
    jacobi(nd.d, s_a[0][c], s_a[1][c], q0, q1, e20, e21);
    s_b[0][t] = e20;
    s_b[1][t] = e21;
  }
  __syncthreads();

  // 3. the residual r - S e2 on the WC x WC region (offset -1) into s_a;
  // the tile's own nodes write e2
  if (owner && bi >= 1 && bi <= WC && bj >= 1 && bj <= WC) {
    T q0, q1;
    residual<T, WB>(nd, s_b[0], s_b[1], t, q0, q1);
    const int k = (bi - 1) * WC + bj - 1;
    s_a[0][k] = q0;
    s_a[1][k] = q1;
    if (valid && bi >= 2 && bj >= 2 && gc_raw < cols) {
      e[n] = e20;
      e[plane + n] = e21;
    }
  }
  __syncthreads();

  // 4. rc = restrict(residual): rows first, then cols, as the plain version
  const int64_t cplane = static_cast<int64_t>(rcs) * ccs;
  if (t < TC * TC) {
    const int i = t / TC, j = t - (t / TC) * TC;
    const int cr = cr0 + i, cc = cc0 + j;
    if (cr < rcs && cc < ccs) {
      const int c = (2 * i + 1) * WC + 2 * j + 1;
      const int64_t m = static_cast<int64_t>(cr) * ccs + cc;
#pragma unroll
      for (int comp = 0; comp < 2; ++comp) {
        const T* q = s_a[comp];
        T x[3];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          x[u] = q[c + u - 1] + T(0.5) * (q[c - WC + u - 1] + q[c + WC + u - 1]);
        }
        rc[comp * cplane + m] = x[1] + T(0.5) * (x[0] + x[2]);
      }
    }
  }
}

// bilinear prolongation of ec at fine node (gr, gc) inside the grid: cols
// first, then rows, as the plain version
template <typename T, bool WRAP>
__device__ __forceinline__ T prolong_at(const T* __restrict__ ec, int gr, int gc, int ccs) {
  const int a = gr >> 1, b = gc >> 1;
  int b1 = b + 1;
  if (WRAP && b1 == ccs) b1 = 0;
  const bool odd_c = gc & 1;
  const T* p = ec + static_cast<int64_t>(a) * ccs;
  const T x0 = odd_c ? T(0.5) * (__ldg(p + b) + __ldg(p + b1)) : __ldg(p + b);
  if (!(gr & 1)) return x0;
  p += ccs;
  const T x1 = odd_c ? T(0.5) * (__ldg(p + b) + __ldg(p + b1)) : __ldg(p + b);
  return T(0.5) * (x0 + x1);
}

template <typename T, bool WRAP>
__global__ void __launch_bounds__(kPostThreads) mg_postsmooth_kernel(
    const T* __restrict__ st, const T* __restrict__ dinv, const T* __restrict__ r,
    const T* __restrict__ e_in, const T* __restrict__ ec, T* __restrict__ e_out, int rows,
    int cols, int rcs, int ccs) {
  constexpr int WA = kTile + 4, WB = kTile + 2;
  __shared__ T s_a[2][WA * WA];  // e0 = e + P ec
  __shared__ T s_b[2][WB * WB];  // e1
  const int64_t plane = static_cast<int64_t>(rows) * cols;
  const int64_t cplane = static_cast<int64_t>(rcs) * ccs;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int t = threadIdx.x;

  // the thread's e1 node (WB x WB region, offset -1), loaded up front
  const bool owner = t < WB * WB;
  const int bi = t / WB, bj = t - (t / WB) * WB;
  const int gr = r0 - 1 + bi, gc_raw = c0 - 1 + bj;
  int gc = gc_raw;
  const bool valid = owner && in_grid<WRAP>(gr, gc, rows, cols);
  const int64_t n = valid ? static_cast<int64_t>(gr) * cols + gc : 0;
  Node<T> nd;
  load_node(nd, valid, st, dinv, r, plane, n);

  // 1. e0 = e + P ec (either may be absent)
  for (int k = t; k < WA * WA; k += kPostThreads) {
    const int i = k / WA, j = k - i * WA;
    const int g = r0 - 2 + i;
    int c = c0 - 2 + j;
    T v0 = T(0), v1 = T(0);
    if (in_grid<WRAP>(g, c, rows, cols)) {
      const int64_t m = static_cast<int64_t>(g) * cols + c;
      if (e_in != nullptr) {
        v0 = __ldg(e_in + m);
        v1 = __ldg(e_in + plane + m);
      }
      if (ec != nullptr) {
        v0 = v0 + prolong_at<T, WRAP>(ec, g, c, ccs);
        v1 = v1 + prolong_at<T, WRAP>(ec + cplane, g, c, ccs);
      }
    }
    s_a[0][k] = v0;
    s_a[1][k] = v1;
  }
  __syncthreads();

  // 2. e1 = e0 + w Dinv (r - S e0)
  if (owner) {
    const int c = (bi + 1) * WA + bj + 1;
    T q0, q1, v0, v1;
    residual<T, WA>(nd, s_a[0], s_a[1], c, q0, q1);
    jacobi(nd.d, s_a[0][c], s_a[1][c], q0, q1, v0, v1);
    s_b[0][t] = v0;
    s_b[1][t] = v1;
  }
  __syncthreads();

  // 3. e2 = e1 + w Dinv (r - S e1) on the tile
  if (valid && bi >= 1 && bi <= kTile && bj >= 1 && bj <= kTile && gc_raw < cols) {
    T q0, q1, v0, v1;
    residual<T, WB>(nd, s_b[0], s_b[1], t, q0, q1);
    jacobi(nd.d, s_b[0][t], s_b[1][t], q0, q1, v0, v1);
    e_out[n] = v0;
    e_out[plane + n] = v1;
  }
}

int blocks_of(int n, int per) { return (n + per - 1) / per; }

// the coarse grid of a fine (rows, cols) grid, or false when it has none
bool coarse_of(int wrap, int rows, int cols, int* rcs, int* ccs) {
  if (rows < 3 || rows % 2 == 0 || cols < 2) return false;
  if (wrap ? cols % 2 != 0 : cols % 2 == 0) return false;
  *rcs = (rows + 1) / 2;
  *ccs = wrap ? cols / 2 : (cols + 1) / 2;
  return true;
}

template <typename T, bool WRAP>
int pre(const void* st, const void* dinv, const void* r, void* e, void* rc, int rows,
        int cols, int rcs, int ccs, cudaStream_t stream) {
  const dim3 grid(blocks_of(ccs, kTile / 2), blocks_of(rcs, kTile / 2));
  mg_presmooth_kernel<T, WRAP><<<grid, kPreThreads, 0, stream>>>(
      static_cast<const T*>(st), static_cast<const T*>(dinv), static_cast<const T*>(r),
      static_cast<T*>(e), static_cast<T*>(rc), rows, cols, rcs, ccs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool WRAP>
int post(const void* st, const void* dinv, const void* r, const void* e_in, const void* ec,
         void* e_out, int rows, int cols, int rcs, int ccs, cudaStream_t stream) {
  const dim3 grid(blocks_of(cols, kTile), blocks_of(rows, kTile));
  mg_postsmooth_kernel<T, WRAP><<<grid, kPostThreads, 0, stream>>>(
      static_cast<const T*>(st), static_cast<const T*>(dinv), static_cast<const T*>(r),
      static_cast<const T*>(e_in), static_cast<const T*>(ec), static_cast<T*>(e_out), rows,
      cols, rcs, ccs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Returns a cudaError_t code (0 =
// launched). rows must be odd and cols even (wrap) or odd, so that the
// level has a coarse grid.
extern "C" int mt_mg_presmooth(int dtype, int wrap, const void* st, const void* dinv,
                               const void* r, void* e, void* rc, int rows, int cols,
                               void* stream) {
  int rcs, ccs;
  if (!coarse_of(wrap, rows, cols, &rcs, &ccs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wrap) return pre<float, true>(st, dinv, r, e, rc, rows, cols, rcs, ccs, s);
  if (dtype == 0) return pre<float, false>(st, dinv, r, e, rc, rows, cols, rcs, ccs, s);
  if (dtype == 1 && wrap) return pre<double, true>(st, dinv, r, e, rc, rows, cols, rcs, ccs, s);
  if (dtype == 1) return pre<double, false>(st, dinv, r, e, rc, rows, cols, rcs, ccs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// e_in and ec may be null (e = 0; no coarse correction); with ec, the level
// must have a coarse grid as for mt_mg_presmooth.
extern "C" int mt_mg_postsmooth(int dtype, int wrap, const void* st, const void* dinv,
                                const void* r, const void* e_in, const void* ec, void* e_out,
                                int rows, int cols, void* stream) {
  int rcs = 0, ccs = 0;
  if (rows <= 0 || cols < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (ec != nullptr && !coarse_of(wrap, rows, cols, &rcs, &ccs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wrap)
    return post<float, true>(st, dinv, r, e_in, ec, e_out, rows, cols, rcs, ccs, s);
  if (dtype == 0)
    return post<float, false>(st, dinv, r, e_in, ec, e_out, rows, cols, rcs, ccs, s);
  if (dtype == 1 && wrap)
    return post<double, true>(st, dinv, r, e_in, ec, e_out, rows, cols, rcs, ccs, s);
  if (dtype == 1)
    return post<double, false>(st, dinv, r, e_in, ec, e_out, rows, cols, rcs, ccs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
