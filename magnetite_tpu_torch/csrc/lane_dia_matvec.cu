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
// What bounds K7: at the sweep's shape (D = 35 offsets reaching +-200,
// N = 3,774, B = 4,096) it must stream u and y once (2 x 2 x N x B values)
// plus the bands, and do 4 FMAs per band entry and lane: in f32 its FMA
// time is 87% of its byte time, so it sits at the balance point and has to
// move each u value through the SM about once. The first design (one
// thread per (node, lane), blocks walking the nodes fastest, the "direct"
// kernel below) relied on the blocks in flight sharing a window of u rows
// in L1 / L2. They do not: the blocks in flight span all 132 SMs, so every
// offset re-reads u from L2 (35 x 2 x N x B x 4 B = 4.3 GB per call, ~5
// TB/s at 0.85 ms, the L2's rate).
//
// The ring kernel (lane_dia_ring_kernel<T, S>, S basis band sets: 1 for
// K7, 3 for K8) answers that. A block owns one lane tile (128 bytes of
// each component row: 32 f32 / 16 f64 lanes) and one strip of consecutive
// rows, walked in steps of P rows. It keeps the u rows [row + min_off,
// row + max_off + P) of its tile in a ring in dynamic shared memory (span
// + m P rows x 2 components, span = max_off - min_off: the step being
// computed plus the steps whose rows the copies in flight bring), and
// beside it stages of band coefficients, staged plane by plane ([offsets
// x S x 4][P]: 16-byte copies where the source is aligned, no bank
// conflicts). The copies of the stages ahead (cp.async, and with a step's
// first stage the step's new ring rows) are in flight while the block
// computes. Each u value then enters the SM once per strip; the halo costs
// (strip + span) / strip of the u reads. Ring rows outside [0, N) and
// lanes past B are zero-filled in shared memory, never read from device
// memory: uninitialised shared memory may hold a NaN, and 0 x NaN is NaN
// (the direct kernel skips those terms for the same reason). Each thread
// carries 16 bytes of lanes (4 f32 / 2 f64) over K rows, so u and y move
// as float4 / double2 copies and ring reads, and one read of a band
// coefficient serves all its lanes. A lane vector that is cut by B or not
// 16-byte aligned takes a scalar path in the same kernel. Sums run over
// d = 0..D-1 in order, as in the direct kernel, and each output is written
// once.
//
// K7 (S = 1) stages all D offsets of a step at once, in two stages (one
// step in flight), K = 2 rows per thread in f32 and 1 in f64, where two
// measured 20-25% slower. What bounds it (measured on an H100 at the
// sweep's shape, PERF.md): not device memory. Shared memory delivers 128
// bytes per clock to each SM whether or not threads share an address, and
// each FMA needs 3 bytes of it in f32 (2 of ring, 1 of band coefficients;
// 8 in f64); and every lane tile fetches the whole band slab (B / 32 x 2.1
// MB = 270 MB per f32 call, 1.1 GB in f64 at 16 lanes), which the compute
// of a step only partly hides. Reading each ring row once for the K rows
// of a run of consecutive offsets halves the ring reads and did not move
// the time; neither did staging the bands row by row ([P][D * 4]), so
// neither is kept. A wider tile would cut the band traffic but not fit:
// the ring holds span + 2P rows of the tile.
//
// K8 (S = 3) crosses shared memory with u once for all three basis
// operators, and keeps six accumulators per row (3 bases x 2 components)
// summed over d = 0..D-1 in order and combined with the lane's weights
// once at the end -- the plain version's order
// (parallel/sweep.py::_lane_weighted_band_matvec); the TPU kernel combined
// the coefficients first only to fit its VMEM stack. Staging all D offsets
// of three band sets per step, as K7 does, leaves room for 32 f32 / 16 f64
// rows per step, 4 warps per SM (1.0 / 4.4 ms at the plate); so K8 stages
// 9 (f32) / 5 (f64) offsets at a time through three stages, two in flight
// while the block computes the third, which fits 64-row steps: 16 warps,
// one row each (2% faster than two rows at 256 threads). What bounds it
// (measured on an H100 at the sweep plate, PERF.md: 0.82 ms f32, 1.87 ms
// f64, 20-23% of its FMA bound): staging the band slab, three times K7's
// and fetched by every lane tile (B / 32 x 6.3 MB = 0.8 GB per f32 call,
// 3.2 GB in f64 at 16 lanes). A first version that advanced each thread's
// (plane, chunk) pair by a loop of blockDim / chunks steps per 16-byte
// copy, and left the offset loop rolled, took 1.14 / 2.5 ms, 0.74 / 1.6 ms
// of it without the arithmetic: issuing the copies, not moving them. Not
// kept (measured with that loader, each slower): one producer warp issuing
// every copy (2.7 ms f32), bulk copies (cp.async.bulk, one per plane; 1.30
// ms), and 16-byte-aligned shifted copies of the planes (1.28 ms).
//
// Tensor cores fit neither: a dense-block MMA over a tile's R x (R + span)
// slice of the operator would multiply at most 6 useful columns of every
// R + 400 (three times over in K8), and TF32 would break the f32 bar (the
// port never runs an f32 product in TF32).
//
// Route rule (kernels/lane_dia_kernel.py::lane_window_plan): the ring runs
// when its rows and staged band values fit shared memory at the full
// 128-byte tile width; offset spans too wide for that (e.g. +-1300 past
// N = 997) take the direct kernel. Both are checked against the plain
// version; neither falls back to the other at run time.
//
// Both lane kernels' direct route skips a term whose row n + off_d leaves
// [0, N), never reads it. Indices are 64-bit: 2 N B passes 2^31 at 262k
// nodes x 4,096 lanes.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kLanes = 32;  // threadIdx.x: lanes of one node (one warp)
constexpr int kRows = 8;    // threadIdx.y: nodes per block
constexpr int kMaxLaneBlocks = 65535;  // gridDim.y limit
constexpr int kRingMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may use

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

// ---- the ring kernel ------------------------------------------------------

// 16 bytes of lanes: the unit of every u / y copy and ring read
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int kN = 4;
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int kN = 2;
};

// The ring kernel's geometry with S basis band sets (lane_window_plan's
// RING_GEOMETRY, the fastest measured at the sweep plate): kK rows per
// thread; the band coefficients of kGroup offsets at a time (0: all D, one
// stage per step) pass through kStages shared-memory stages, kStages - 1
// of them in flight while the block computes on the last.
template <typename T, int S> struct Ring;
template <> struct Ring<float, 1> {
  static constexpr int kK = 2, kGroup = 0, kStages = 2;
};
template <> struct Ring<double, 1> {
  static constexpr int kK = 1, kGroup = 0, kStages = 2;
};
template <> struct Ring<float, 3> {
  static constexpr int kK = 1, kGroup = 9, kStages = 3;
};
template <> struct Ring<double, 3> {
  static constexpr int kK = 1, kGroup = 5, kStages = 3;
};

// the S basis band sets [D, 2, 2, N] and, for K8, their per-lane weights
template <typename T, int S> struct Operands {
  const T* bands[S];
  const T* weights[S];
};

// offsets per band stage
__host__ __device__ __forceinline__ int ring_group(int n_diags, int group) {
  return group == 0 || n_diags < group ? n_diags : group;
}

// Steps of rows the ring holds beyond the span: the copies of stage
// idx + stages - 1 are issued once the block has computed stage idx - 1,
// so a step's new rows land stages - 1 stages before the previous step
// ends; the slots they fill must by then hold rows of finished steps only.
__host__ __device__ __forceinline__ int ring_steps(int n_diags, int group, int stages) {
  const int chunks = (n_diags + group - 1) / group;
  return 1 + (stages - 1 + chunks - 1) / chunks;
}

__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ double2 vzero(double2) { return make_double2(0.0, 0.0); }

// acc += b * a, lane by lane (the direct kernel's `acc = acc + b * u`)
__device__ __forceinline__ void axpy(float4& acc, float b, const float4& a) {
  acc.x = acc.x + b * a.x;
  acc.y = acc.y + b * a.y;
  acc.z = acc.z + b * a.z;
  acc.w = acc.w + b * a.w;
}
__device__ __forceinline__ void axpy(double2& acc, double b, const double2& a) {
  acc.x = acc.x + b * a.x;
  acc.y = acc.y + b * a.y;
}

// the first `count` lanes of a vector (the tail of B, or an unaligned y)
__device__ __forceinline__ void store_lanes(float* dst, const float4& a, int64_t count) {
  dst[0] = a.x;
  if (count > 1) dst[1] = a.y;
  if (count > 2) dst[2] = a.z;
  if (count > 3) dst[3] = a.w;
}
__device__ __forceinline__ void store_lanes(double* dst, const double2& a, int64_t count) {
  dst[0] = a.x;
  if (count > 1) dst[1] = a.y;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy the u rows [ga, gb) of the block's lane tile into their ring slots
// (row g lives in slot (g - g0) mod R). Thread `tid` always copies the same
// (component, lane vector) of every (rows_per_pass)-th row, so no index is
// divided inside the loop.
template <typename T>
__device__ __forceinline__ void ring_load(typename Vec<T>::type* ring, const T* __restrict__ u,
                                          int64_t n, int64_t nb, int64_t lane0, int lt,
                                          int ring_rows, int64_t g0, int64_t ga, int64_t gb) {
  using V = typename Vec<T>::type;
  constexpr int kV = Vec<T>::kN;
  const int per_row = 2 * lt;
  const int cv = threadIdx.x % per_row;
  const int c = cv / lt, v = cv % lt;
  const int rows_per_pass = blockDim.x / per_row;
  const int64_t lane = lane0 + static_cast<int64_t>(v) * kV;
  int64_t g = ga + threadIdx.x / per_row;
  int slot = static_cast<int>((g - g0) % ring_rows);
  for (; g < gb; g += rows_per_pass) {
    V* dst = ring + (slot * 2 + c) * lt + v;
    if (g >= 0 && g < n && lane < nb) {
      const T* src = u + (c * n + g) * nb + lane;
      if (lane + kV <= nb && aligned16(src)) {
        cp_async16(dst, src);
      } else {
        T* d = reinterpret_cast<T*>(dst);
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          if (lane + e < nb) {
            cp_async_small<sizeof(T)>(d + e, src + e);
          } else {
            d[e] = T(0);
          }
        }
      }
    } else {
      *dst = vzero(V{});
    }
    slot += rows_per_pass;
    if (slot >= ring_rows) slot -= ring_rows;
  }
}

// Copy `count` (>= 1) values of one band plane, at most 16 bytes: one
// 16-byte copy where the source is aligned and the chunk whole (8 or 4
// bytes otherwise, and at the strip's end).
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int count) {
  constexpr int kE = 16 / sizeof(T);
  if (count >= kE && aligned16(src)) {
    cp_async16(dst, src);
  } else if (sizeof(T) == 4 && count >= kE && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    cp_async_small<8>(dst, src);
    cp_async_small<8>(dst + 2, src + 2);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e < count) cp_async_small<sizeof(T)>(dst + e, src + e);
    }
  }
}

// Copy the band coefficients of offsets [d0, d0 + gc), rows [row0,
// min(row0 + rows, s1)), into a stage [gc][S * 4][rows] (plane
// (d - d0) 4 S + 4 s + e: basis s, block entry e; plane-major, the rows of
// one plane side by side, as they lie in device memory). Thread `tid`
// copies 16-byte chunk c of plane p for every blockDim.x-th (p, c), the
// pair advanced without a division.
template <typename T, int S>
__device__ __forceinline__ void band_load(T* st, const Operands<T, S>& op, int64_t n, int d0,
                                          int gc, int rows, int64_t row0, int64_t s1) {
  constexpr int kE = 16 / sizeof(T);
  const int chunks = rows / kE;
  const int dp = blockDim.x / chunks, dc = blockDim.x - dp * chunks;
  const int valid = static_cast<int>(s1 - row0 < rows ? s1 - row0 : rows);
  int plane = threadIdx.x / chunks, c = threadIdx.x - plane * chunks;
  while (plane < gc * 4 * S) {
    const int r = c * kE;
    if (r < valid) {
      const int dd = plane / (4 * S), se = plane - dd * 4 * S;
      const T* base = op.bands[0];
      if constexpr (S == 3) base = se < 4 ? base : (se < 8 ? op.bands[1] : op.bands[2]);
      copy_chunk(st + plane * rows + r,
                 base + static_cast<int64_t>((d0 + dd) * 4 + (se & 3)) * n + row0 + r,
                 valid - r);
    }
    plane += dp;
    c += dc;
    if (c >= chunks) c -= chunks, ++plane;
  }
}

// the K consecutive rows of one band plane a thread reads (f32 K = 2: one
// 8-byte read)
__device__ __forceinline__ void load_rows(const float* s, float (&b)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(s);
  b[0] = v.x, b[1] = v.y;
}
__device__ __forceinline__ void load_rows(const float* s, float (&b)[1]) { b[0] = s[0]; }
__device__ __forceinline__ void load_rows(const double* s, double (&b)[1]) { b[0] = s[0]; }

// K8's per-lane weights of one lane vector: one 16-byte read, or lane by
// lane (zero past B) for the tail of B or an unaligned weight vector
template <typename T>
__device__ __forceinline__ typename Vec<T>::type load_lanes(const T* __restrict__ w,
                                                            int64_t lane, int64_t nb) {
  using V = typename Vec<T>::type;
  constexpr int kV = Vec<T>::kN;
  if (lane + kV <= nb && aligned16(w + lane)) return *reinterpret_cast<const V*>(w + lane);
  V out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int e = 0; e < kV; ++e) o[e] = lane + e < nb ? w[lane + e] : T(0);
  return out;
}

// a wa + b wb + c wc, lane by lane: the plain version's combination of the
// three bases' sums
__device__ __forceinline__ float4 combine3(const float4& a, const float4& b, const float4& c,
                                           const float4 (&w)[3]) {
  return make_float4(a.x * w[0].x + b.x * w[1].x + c.x * w[2].x,
                     a.y * w[0].y + b.y * w[1].y + c.y * w[2].y,
                     a.z * w[0].z + b.z * w[1].z + c.z * w[2].z,
                     a.w * w[0].w + b.w * w[1].w + c.w * w[2].w);
}
__device__ __forceinline__ double2 combine3(const double2& a, const double2& b,
                                            const double2& c, const double2 (&w)[3]) {
  return make_double2(a.x * w[0].x + b.x * w[1].x + c.x * w[2].x,
                      a.y * w[0].y + b.y * w[1].y + c.y * w[2].y);
}

// One block: lane tile blockIdx.y (lt lane vectors), row strip blockIdx.x
// ([s0, s1), strip_rows long), walked in steps of `rows` rows, each step in
// stages of `group` offsets (idx = t * chunks + c). At stage idx every
// thread waits for its own copies of stage idx, the block syncs, and then
// issues stage idx + kStages - 1 (the band coefficients of its offsets,
// and with a step's first stage the step's new ring rows) into the buffer
// stage idx - 1 used, and computes stage idx. Thread (g = tid / lt,
// v = tid % lt) computes the K rows row0 + g K + j of lane vector v: 2 S
// accumulators per row (basis x component) summed over d = 0..D-1 in order
// across the stages; K8 combines them with the lane's three weights once,
// after the step's last stage.
template <typename T, int S>
__global__ void __launch_bounds__(kRingMaxThreads) lane_dia_ring_kernel(
    Operands<T, S> op, const int* __restrict__ offsets, int n_diags, const T* __restrict__ u,
    T* __restrict__ y, int64_t n, int64_t nb, int min_off, int max_off, int lt, int rows,
    int64_t strip_rows) {
  using V = typename Vec<T>::type;
  using G = Ring<T, S>;
  constexpr int kV = Vec<T>::kN, K = G::kK, kStages = G::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = ring_group(n_diags, G::kGroup);
  const int ring_rows = max_off - min_off + ring_steps(n_diags, group, kStages) * rows;
  const int stage_size = group * 4 * S * rows;
  V* ring = reinterpret_cast<V*>(smem);  // [ring_rows][2][lt]
  // kStages stages of band values, [group][S * 4][rows] each
  T* stages = reinterpret_cast<T*>(ring + static_cast<int64_t>(ring_rows) * 2 * lt);
  int* s_so = reinterpret_cast<int*>(stages + kStages * stage_size);  // [D]: offset - min_off

  for (int d = threadIdx.x; d < n_diags; d += blockDim.x) s_so[d] = offsets[d] - min_off;

  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * strip_rows;
  const int64_t s1 = s0 + strip_rows < n ? s0 + strip_rows : n;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.y) * lt * kV;
  const int64_t g0 = s0 + min_off;  // the ring row in slot 0
  const int steps = static_cast<int>((s1 - s0 + rows - 1) / rows);
  // stages per step (one when a stage holds all D offsets)
  const int chunks = G::kGroup == 0 ? 1 : (n_diags + group - 1) / group;
  const int total = steps * chunks;

  // stage j's copies: step t's new rows with its first stage (step 0: all
  // it reads), and the band coefficients of offsets [c group, ...)
  const auto issue = [&](int j) {
    const int t = j / chunks, c = j - t * chunks;
    const int64_t row0 = s0 + static_cast<int64_t>(t) * rows;
    if (c == 0) {
      ring_load<T>(ring, u, n, nb, lane0, lt, ring_rows, g0, t == 0 ? g0 : row0 + max_off,
                   row0 + max_off + rows);
    }
    const int d0 = c * group;
    band_load<T, S>(stages + (j % kStages) * stage_size, op, n, d0,
                    n_diags - d0 < group ? n_diags - d0 : group, rows, row0, s1);
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1 && j < total; ++j) issue(j);

  const int v = threadIdx.x % lt, g = threadIdx.x / lt;
  const int64_t lane = lane0 + static_cast<int64_t>(v) * kV;
  const bool worker = lane < nb;
  const int64_t comp = n * nb;
  V w[S];
  if constexpr (S == 3) {
    if (worker) {
#pragma unroll
      for (int s = 0; s < 3; ++s) w[s] = load_lanes(op.weights[s], lane, nb);
    }
  }
  int qs = g * K;  // slot of row row0 + g K + min_off: (t rows + g K) mod ring_rows
  for (int t = 0, idx = 0; t < steps; ++t) {
    const int64_t rowk = s0 + static_cast<int64_t>(t) * rows + g * K;
    // a row past s1 computes on band values never loaded; it is not stored
    const bool active = worker && rowk < s1;
    V acc0[S][K], acc1[S][K];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < K; ++j) acc0[s][j] = acc1[s][j] = vzero(V{});
    }
    for (int c = 0; c < chunks; ++c, ++idx) {
      if (idx + kStages - 2 < total) {
        cp_async_wait<kStages - 2>();
      } else {
        cp_async_wait<0>();
      }
      // stage idx has landed for every thread, and every thread is done
      // with stage idx - 1, whose buffer stage idx + kStages - 1 refills
      __syncthreads();
      if (idx + kStages - 1 < total) issue(idx + kStages - 1);
      if (active) {
        const int d1 = (c + 1) * group < n_diags ? (c + 1) * group : n_diags;
        const T* b = stages + (idx % kStages) * stage_size + g * K;
        const V* rv = ring + v;
#pragma unroll 5
        for (int d = c * group; d < d1; ++d, b += 4 * S * rows) {
          int slot = qs + s_so[d];
          if (slot >= ring_rows) slot -= ring_rows;
          T b00[S][K], b01[S][K], b10[S][K], b11[S][K];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            load_rows(b + 4 * s * rows, b00[s]);
            load_rows(b + (4 * s + 1) * rows, b01[s]);
            load_rows(b + (4 * s + 2) * rows, b10[s]);
            load_rows(b + (4 * s + 3) * rows, b11[s]);
          }
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const V a0 = rv[slot * 2 * lt];
            const V a1 = rv[slot * 2 * lt + lt];
#pragma unroll
            for (int s = 0; s < S; ++s) {
              axpy(acc0[s][j], b00[s][j], a0);
              axpy(acc0[s][j], b01[s][j], a1);
              axpy(acc1[s][j], b10[s][j], a0);
              axpy(acc1[s][j], b11[s][j], a1);
            }
            if (++slot == ring_rows) slot = 0;
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (rowk + j < s1) {
          V o0 = acc0[0][j], o1 = acc1[0][j];
          if constexpr (S == 3) {
            o0 = combine3(acc0[0][j], acc0[1][j], acc0[2][j], w);
            o1 = combine3(acc1[0][j], acc1[1][j], acc1[2][j], w);
          }
          T* y0 = y + (rowk + j) * nb + lane;
          T* y1 = y0 + comp;
          if (lane + kV <= nb && aligned16(y0) && aligned16(y1)) {
            *reinterpret_cast<V*>(y0) = o0;
            *reinterpret_cast<V*>(y1) = o1;
          } else {
            store_lanes(y0, o0, nb - lane);
            store_lanes(y1, o1, nb - lane);
          }
        }
      }
    }
    qs += rows;
    if (qs >= ring_rows) qs -= ring_rows;
  }
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

// The ring's shared memory: span + ring_steps steps of rows x 2 components
// x lanes values, kStages stages of band coefficients (offsets per stage x
// S bases x 4 x rows each), the D shifted offsets (lane_window_plan's
// ring_smem_bytes computes the same).
template <typename T, int S>
int64_t ring_smem_bytes(int64_t span, int lanes, int rows, int n_diags) {
  using G = Ring<T, S>;
  const int group = ring_group(n_diags, G::kGroup);
  return ((span + ring_steps(n_diags, group, G::kStages) * rows) * 2 * lanes +
          static_cast<int64_t>(G::kStages) * group * 4 * S * rows) * sizeof(T) +
         4 * static_cast<int64_t>(n_diags);
}

template <typename T, int S>
int launch_ring(const Operands<T, S>& op, const void* offsets, int n_diags, const void* u,
                void* y, int64_t n, int64_t nb, int min_off, int max_off, int lanes, int rows,
                int64_t strip_rows, int smem_bytes, cudaStream_t stream) {
  constexpr int kV = Vec<T>::kN;
  constexpr int K = Ring<T, S>::kK;
  const int lt = lanes / kV;
  const int64_t span = static_cast<int64_t>(max_off) - min_off;
  const int64_t tiles = (nb + lanes - 1) / lanes;
  const int64_t strips = (n + strip_rows - 1) / strip_rows;
  if (lanes % kV != 0 || lt < 1 || rows < 2 * K || rows % (2 * K) != 0 || rows % kV != 0 ||
      lt * rows / K > kRingMaxThreads || span < 0 || strip_rows < 1 ||
      tiles > kMaxLaneBlocks || strips > INT32_MAX || smem_bytes > kMaxSmem ||
      smem_bytes < ring_smem_bytes<T, S>(span, lanes, rows, n_diags)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB a block's dynamic shared memory must be allowed first, once
  // per instance (the allowance is a cap: it reserves nothing)
  static std::atomic<bool> allowed{false};
  if (smem_bytes > 48 * 1024 && !allowed.load()) {
    cudaError_t err = cudaFuncSetAttribute(
        lane_dia_ring_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) {  // and the largest shared-memory share of each SM
      err = cudaFuncSetAttribute(lane_dia_ring_kernel<T, S>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed.store(true);
  }
  const dim3 grid(static_cast<unsigned>(strips), static_cast<unsigned>(tiles));
  lane_dia_ring_kernel<T, S><<<grid, lt * rows / K, smem_bytes, stream>>>(
      op, static_cast<const int*>(offsets), n_diags, static_cast<const T*>(u),
      static_cast<T*>(y), n, nb, min_off, max_off, lt, rows, strip_rows);
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

// K7 through the ring: min_off / max_off the extreme offsets, `lanes` the
// lane tile (a multiple of 4 f32 / 2 f64 lanes), `rows` the rows per step
// (a multiple of 2 K and of 16 bytes of values; K = Ring<T, 1>::kK rows
// per thread), `strip_rows` the rows of each block's strip, `smem_bytes`
// the dynamic shared memory (at least ring_smem_bytes).
extern "C" int mt_lane_dia_ring(int dtype, const void* bands, const void* offsets, int n_diags,
                                const void* u, void* y, int64_t n, int64_t nb, int min_off,
                                int max_off, int lanes, int rows, int64_t strip_rows,
                                int smem_bytes, void* stream) {
  if (n <= 0 || nb <= 0 || n_diags <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Operands<float, 1> op{{static_cast<const float*>(bands)}, {nullptr}};
    return launch_ring<float, 1>(op, offsets, n_diags, u, y, n, nb, min_off, max_off, lanes,
                                 rows, strip_rows, smem_bytes, s);
  }
  if (dtype == 1) {
    const Operands<double, 1> op{{static_cast<const double*>(bands)}, {nullptr}};
    return launch_ring<double, 1>(op, offsets, n_diags, u, y, n, nb, min_off, max_off, lanes,
                                  rows, strip_rows, smem_bytes, s);
  }
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

namespace {
template <typename T>
int launch_ring3(const void* ba, const void* bb, const void* bc, const void* wa, const void* wb,
                 const void* wc, const void* offsets, int n_diags, const void* u, void* y,
                 int64_t n, int64_t nb, int min_off, int max_off, int lanes, int rows,
                 int64_t strip_rows, int smem_bytes, cudaStream_t stream) {
  const Operands<T, 3> op{
      {static_cast<const T*>(ba), static_cast<const T*>(bb), static_cast<const T*>(bc)},
      {static_cast<const T*>(wa), static_cast<const T*>(wb), static_cast<const T*>(wc)}};
  return launch_ring<T, 3>(op, offsets, n_diags, u, y, n, nb, min_off, max_off, lanes, rows,
                           strip_rows, smem_bytes, stream);
}
}  // namespace

// K8 through the ring: the three basis band sets and their per-lane
// weights, the rest as mt_lane_dia_ring (K = Ring<T, 3>::kK).
extern "C" int mt_lane_dia_ring3(int dtype, const void* ba, const void* bb, const void* bc,
                                 const void* wa, const void* wb, const void* wc,
                                 const void* offsets, int n_diags, const void* u, void* y,
                                 int64_t n, int64_t nb, int min_off, int max_off, int lanes,
                                 int rows, int64_t strip_rows, int smem_bytes, void* stream) {
  if (n <= 0 || nb <= 0 || n_diags <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_ring3<float>(ba, bb, bc, wa, wb, wc, offsets, n_diags, u, y, n, nb, min_off,
                               max_off, lanes, rows, strip_rows, smem_bytes, s);
  }
  if (dtype == 1) {
    return launch_ring3<double>(ba, bb, bc, wa, wb, wc, offsets, n_diags, u, y, n, nb, min_off,
                                max_off, lanes, rows, strip_rows, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
