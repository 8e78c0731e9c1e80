// Lane-batched 9-point 2x2-block stencil SpMV on Hopper (sm_90a), the
// operator of the structured-grid design sweeps:
//
//   S = 1  y[i, r, c, b] = sum_s sum_j S[s, i, j, r, c] * u[j, r + dr_s, c + dt_s, b]
//   S = 3  the same, the block of offset s per lane b being
//          wa[b] Sa[s] + wb[b] Sb[s] + wc[b] Sc[s] + Sfix[s]
//
// stencils [9, 2, 2, R, C] (cols minormost; offset s = (dr+1)*3 + dt+1),
// u / y [2, R, C, B] lane fields (B minormost), the material weights [B]
// each. Rows outside the grid read zero; columns wrap (annulus meshes) or
// read zero outside the grid. f32 and f64 instances.
//
// No TPU kernel stands behind this one: the JAX package computes the same
// function in plain XLA (magnetite_tpu/parallel/sweep.py::
// _lane_stencil_matvec for S = 1, ::_lane_material_matvec for S = 3),
// which fuses the pad, the nine slices and the FMA chain into one pass. In
// eager PyTorch that chain is ~40 (S = 1) or ~150 (S = 3) launches per
// matvec, and a sweep's V-cycles make hundreds of matvecs per solve.
//
// What bounds it: device memory. At the bench grid (33 x 65 nodes, B =
// 4,096) u and y are 70 MB each in f32, the stencils 0.3 MB (S = 1) or 1.2
// MB (S = 3); S = 1 does 8 flops per stencil term and lane (bytes bound it
// 4x over the flops in f32), S = 3 four times that (bytes and flops bound
// it about equally in f32; in f64 its flops take 0.074 ms of 34 TFLOP/s
// against 0.085 ms of bytes).
//
// Design: one thread per (vector of V consecutive lanes, column c, strip
// of rows). V is 16 bytes of lanes (4 f32 / 2 f64) when B and the
// pointers allow it, else 1; consecutive threads take consecutive lane
// vectors, so every u / y access of a warp is one coalesced run of lanes.
// The thread walks its strip down the rows with a 3 x 3 window of u
// vectors (rows r-1, r, r+1 x columns c-1, c, c+1, both components) in
// registers: each step loads the three vectors of row r+1 and reuses the
// other six, so u crosses from L2 to the SM ~(strip + 2) / strip times,
// not nine times. The node's stencil values are the same for all lanes:
// the warp reads each as one broadcast. Out-of-grid neighbours are zero in
// the window, never read. Sums run over s = 0..8 in order, component 0
// before 1. S = 1 forms each output as the plain version does; S = 3
// keeps four sums per output (Sa, Sb, Sc, Sfix applied to u) and combines
// them with the lane's weights (loaded once per thread) at the end, where
// the plain version combines the coefficients first: the two agree to
// rounding. S = 3 also loads the window's next row one step ahead. Both
// measured on an H100 at the bench grid (PERF.md): as first written, with
// the coefficient combined per term and no load ahead, S = 3 ran 0.81 ms
// in f64 (10% of its bound), a dependent chain per stencil term at 128
// registers; with four independent sums and the row ahead, 0.43-0.45 ms
// at 254 registers. In f32 both ran 0.19 ms. S = 1 keeps the first form
// (a load-ahead variant was slower). The wrap is a run-time flag: as a
// template parameter the wrapped f64 S = 3 instance compiled to 172
// registers and ran 1.09 ms, against 0.40 ms now.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, int S>
struct Operands {
  const T* st[4];  // S = 1: st[0]; S = 3: Sa, Sb, Sc, Sfix
  const T* w[3];   // S = 3: wa, wb, wc
};

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

template <typename T, int S, int V>
__global__ void __launch_bounds__(kThreads) lane_stencil_kernel(
    const Operands<T, S> op, const T* __restrict__ u, T* __restrict__ y, int rows, int cols,
    int64_t nb, int strip_rows, bool wrap) {
  const int64_t nvec = nb / V;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int strips = (rows + strip_rows - 1) / strip_rows;
  if (idx >= nvec * cols * strips) return;
  const int64_t lane0 = (idx % nvec) * V;
  const int64_t rest = idx / nvec;
  const int c = static_cast<int>(rest % cols);
  const int strip = static_cast<int>(rest / cols);
  const int r0 = strip * strip_rows;
  const int r1 = min(rows, r0 + strip_rows);
  const int64_t plane = static_cast<int64_t>(rows) * cols;  // nodes
  const int64_t comp = plane * nb;                            // one component field

  int col[3] = {c - 1, c, c + 1};
  bool col_ok[3] = {true, true, true};
  if (wrap) {
    col[0] = c == 0 ? cols - 1 : c - 1;
    col[2] = c == cols - 1 ? 0 : c + 1;
  } else {
    col_ok[0] = c > 0;
    col_ok[2] = c + 1 < cols;
  }

  T w[3][V];
  if constexpr (S == 3) {
#pragma unroll
    for (int m = 0; m < 3; ++m) load_vec<T, V>(op.w[m] + lane0, w[m]);
  }

  // win[row r-1 / r / r+1][column c-1 / c / c+1][component][lane]
  T win[3][3][2][V];
  auto load_row = [&](T (&dst)[3][2][V], int r) {
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const bool ok = r >= 0 && r < rows && col_ok[dt];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (ok) {
          load_vec<T, V>(u + j * comp + (static_cast<int64_t>(r) * cols + col[dt]) * nb + lane0,
                         dst[dt][j]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) dst[dt][j][k] = T(0);
        }
      }
    }
  };
  load_row(win[0], r0 - 1);
  load_row(win[1], r0);
  // S = 3 loads row r + 2 while it computes row r (see the header note)
  T ahead[3][2][V];
  if constexpr (S == 3) load_row(ahead, r0 + 1);

  for (int r = r0; r < r1; ++r) {
    if constexpr (S == 3) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int k = 0; k < V; ++k) win[2][dt][j][k] = ahead[dt][j][k];
      if (r + 1 < r1) load_row(ahead, r + 2);
    } else {
      load_row(win[2], r + 1);
    }
    const int64_t node = static_cast<int64_t>(r) * cols + c;
    // acc[0]: S's sum (S = 3: Sfix's); S = 3 adds Sa's, Sb's, Sc's in acc[1..3]
    T acc[S == 3 ? 4 : 1][2][V];
#pragma unroll
    for (int m = 0; m < (S == 3 ? 4 : 1); ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < V; ++k) acc[m][i][k] = T(0);
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int dr = s / 3, dt = s % 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int64_t at = (static_cast<int64_t>(s) * 4 + i * 2 + j) * plane + node;
          if constexpr (S == 1) {
            const T b = __ldg(op.st[0] + at);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[0][i][k] += b * win[dr][dt][j][k];
          } else {
            const T sa = __ldg(op.st[0] + at), sb = __ldg(op.st[1] + at);
            const T sc = __ldg(op.st[2] + at), sf = __ldg(op.st[3] + at);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const T x = win[dr][dt][j][k];
              acc[1][i][k] += sa * x;
              acc[2][i][k] += sb * x;
              acc[3][i][k] += sc * x;
              acc[0][i][k] += sf * x;
            }
          }
        }
      }
    }
    if constexpr (S == 3) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[0][i][k] += acc[1][i][k] * w[0][k] + acc[2][i][k] * w[1][k] + acc[3][i][k] * w[2][k];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) store_vec<T, V>(y + i * comp + node * nb + lane0, acc[0][i]);
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          win[0][dt][j][k] = win[1][dt][j][k];
          win[1][dt][j][k] = win[2][dt][j][k];
        }
  }
}

template <typename T, int S, int V>
int launch(const Operands<T, S>& op, const void* u, void* y, int rows, int cols, int64_t nb,
           int strip_rows, bool wrap, cudaStream_t stream) {
  const int64_t strips = (rows + strip_rows - 1) / strip_rows;
  const int64_t threads = nb / V * cols * strips;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  lane_stencil_kernel<T, S, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      op, static_cast<const T*>(u), static_cast<T*>(y), rows, cols, nb, strip_rows, wrap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int dispatch(const Operands<T, S>& op, int wrap, int vec, const void* u, void* y, int rows,
             int cols, int64_t nb, int strip_rows, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec && nb % kVec == 0) {
    return launch<T, S, kVec>(op, u, y, rows, cols, nb, strip_rows, wrap != 0, s);
  }
  if (vec == 1) return launch<T, S, 1>(op, u, y, rows, cols, nb, strip_rows, wrap != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid(int rows, int cols, int64_t nb, int strip_rows) {
  return rows > 0 && cols >= 2 && nb > 0 && strip_rows > 0;
}

}  // namespace

// S = 1. dtype: 0 = float32, 1 = float64; vec: lanes per thread (16 bytes
// of lanes, or 1); strip_rows: the rows each thread walks. Returns a
// cudaError_t code (0 = launched).
extern "C" int mt_lane_stencil_matvec(int dtype, int wrap, int vec, const void* st,
                                      const void* u, void* y, int rows, int cols, int64_t nb,
                                      int strip_rows, void* stream) {
  if (!valid(rows, cols, nb, strip_rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Operands<float, 1> op{{static_cast<const float*>(st)}, {nullptr}};
    return dispatch<float, 1>(op, wrap, vec, u, y, rows, cols, nb, strip_rows, s);
  }
  if (dtype == 1) {
    const Operands<double, 1> op{{static_cast<const double*>(st)}, {nullptr}};
    return dispatch<double, 1>(op, wrap, vec, u, y, rows, cols, nb, strip_rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {
template <typename T>
int launch3(const void* sa, const void* sb, const void* sc, const void* sf, const void* wa,
            const void* wb, const void* wc, int wrap, int vec, const void* u, void* y, int rows,
            int cols, int64_t nb, int strip_rows, cudaStream_t s) {
  const Operands<T, 3> op{
      {static_cast<const T*>(sa), static_cast<const T*>(sb), static_cast<const T*>(sc),
       static_cast<const T*>(sf)},
      {static_cast<const T*>(wa), static_cast<const T*>(wb), static_cast<const T*>(wc)}};
  return dispatch<T, 3>(op, wrap, vec, u, y, rows, cols, nb, strip_rows, s);
}
}  // namespace

// S = 3: the three basis stencils, the fixed-DOF stencil and the per-lane
// weights; the rest as mt_lane_stencil_matvec.
extern "C" int mt_lane_stencil_matvec3(int dtype, int wrap, int vec, const void* sa,
                                       const void* sb, const void* sc, const void* sfix,
                                       const void* wa, const void* wb, const void* wc,
                                       const void* u, void* y, int rows, int cols, int64_t nb,
                                       int strip_rows, void* stream) {
  if (!valid(rows, cols, nb, strip_rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch3<float>(sa, sb, sc, sfix, wa, wb, wc, wrap, vec, u, y, rows, cols, nb,
                          strip_rows, s);
  }
  if (dtype == 1) {
    return launch3<double>(sa, sb, sc, sfix, wa, wb, wc, wrap, vec, u, y, rows, cols, nb,
                           strip_rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
