// Fused device assembly on Hopper (sm_90a): closed-form CST pair blocks
// summed into the operator's slots and written in the operator's own
// layout, without floating-point atomics.
//
//   sum[i, j, s] = sum over the (a, b, e) with slot_ids[9 e + 3 a + b] == s of
//                  k_ij(a, b, e), taken in pair-major order p = (3 a + b) E + e
//
// k(a, b, e) is the 2x2 stiffness block coupling local nodes a and b of
// element e (magnetite_tpu/fem/element.py::pair_block_fields: t / (2 A2) *
// B_a^T D B_b expanded, A2 twice the signed area); `slot_ids` are the
// structure's a-major slot ids as uploaded (DIA: band * N + row, hybrid:
// the same plus D N + r for the COO remainder, ELL: row * K + k). The sums
// are taken in f64 and rounded once to the output's type, which gives
// .to(float32)'s bits; they land in the layout the operator keeps: bands
// [D, 2, 2, N] (DIA and hybrid bands) or [K, 2, 2, N] (ELL, slot-major),
// and the hybrid remainder [R, 2, 2].
//
// No TPU kernel stands behind these: the JAX package computes the same
// function as fem/dia.py::assemble_dia_fused / assemble_hybrid_fused and
// fem/solve.py::assemble_ell_arrays_fused -- four scalar segment_sums over
// [3, 3, E] fields -- and leaves it to XLA; there is no `pallas_call`.
//
// What bounds it: device memory. Read once, the mesh (coords, tris) and
// the slot ids are 16 N + 96 E bytes; the output, written once, is 32 S
// (f64) -- 656 MB at the DIA slots of a 1M-element plate, where about 83%
// of the slots are empty, so the output write is most of the bound. ~40
// flops a pair leave the bytes the bound.
//
// Design, three kernels and a scan (kernels/assembly_kernel.py):
//  1. assemble_count_kernel, one thread an element: the element's three
//     betas, three gammas and coef = t / (2 A2) -- its one division --
//     into a 64-byte record, and one integer atomic add a pair onto its
//     slot's count (integer atomics: the same counts on every run). The
//     slot ids are read in their a-major layout; no pair-major copy.
//  2. an inclusive scan of the counts (torch.cumsum, glue): each slot's
//     end in the grouped order.
//  3. assemble_fill_kernel, one thread a pair: an atomic decrement of its
//     slot's end gives the pair a place in its slot's run, and the bounds
//     become the runs' starts. The place within a run varies from run to
//     run; the order of the sum does not (4.).
//  4. assemble_runs_kernel: a warp owns 32 consecutive slots, one lane
//     each (DIA tiles are 32 nodes of one band, taken node range by node
//     range over every band, so an element's nine pairs meet its record in
//     cache). The lanes first take the tile's pairs (contiguous in the
//     grouped order), one a lane, all of their gathers in flight at once,
//     and stage each pair's four block scalars and its pair-major key in
//     shared memory. Then each lane sums its slot's run in pair-major
//     order (the run's keys selected smallest first: runs hold a few
//     pairs), with the parent kernel's operations, so the operator has the
//     bits of a sequential pair-major sum on every call, and the CG
//     iteration counts after it repeat. A tile with more pairs than the
//     stage holds (kCap; the DIA diagonal band's, ~6 a slot) sums them from
//     device memory, in the same order. Warps wait on no other warp; empty
//     slots cost one coalesced store of zeros.
// Order, bounds and indices are int32: 9 E and S + 1 must stay below 2^31
// (the wrapper raises past them, and so do these entries).
// The arithmetic is written with round-to-nearest intrinsics, so no
// multiply-add is contracted: every value is the plain version's
// (pair_block_fields + four index_add_) to the last bit wherever
// index_add_ sums in index order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kElemThreads = 256;  // count: one thread an element
constexpr int kFillThreads = 256;  // fill: one thread a pair
constexpr int kGeom = 8;           // doubles an element: beta0..2, coef, gamma0..2, 0

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

__global__ void __launch_bounds__(kElemThreads) assemble_count_kernel(
    const double* __restrict__ coords, const int64_t* __restrict__ tris,
    const int64_t* __restrict__ slot_ids, int n_elem, int n_slots, double thick,
    double* __restrict__ geom, int* __restrict__ counts) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n_elem) return;
  double x[3], y[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t node = __ldg(reinterpret_cast<const long long*>(tris) + 3 * e + c);
    const double2 xy = __ldg(reinterpret_cast<const double2*>(coords) + node);
    x[c] = xy.x;
    y[c] = xy.y;
  }
  // beta_c = y[c+1] - y[c+2], gamma_c = x[c+2] - x[c+1] (indices mod 3)
  const double b0 = sub(y[1], y[2]), b1 = sub(y[2], y[0]), b2 = sub(y[0], y[1]);
  const double area2 = add(add(mul(x[0], b0), mul(x[1], b1)), mul(x[2], b2));
  double2* g = reinterpret_cast<double2*>(geom + static_cast<int64_t>(kGeom) * e);
  g[0] = make_double2(b0, b1);
  g[1] = make_double2(b2, __ddiv_rn(thick, mul(2.0, area2)));
  g[2] = make_double2(sub(x[2], x[1]), sub(x[0], x[2]));
  g[3] = make_double2(sub(x[1], x[0]), 0.0);
  const long long* ids = reinterpret_cast<const long long*>(slot_ids) + 9 * static_cast<int64_t>(e);
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const long long s = __ldg(ids + j);
    if (s >= 0 && s < n_slots) atomicAdd(counts + s, 1);
  }
}

__global__ void __launch_bounds__(kFillThreads) assemble_fill_kernel(
    const int64_t* __restrict__ slot_ids, int n_pairs, int n_slots, int* __restrict__ bounds,
    int* __restrict__ order) {
  const int i = blockIdx.x * kFillThreads + threadIdx.x;
  if (i >= n_pairs) return;
  const long long s = __ldg(reinterpret_cast<const long long*>(slot_ids) + i);
  if (s < 0 || s >= n_slots) return;
  order[atomicSub(bounds + s, 1) - 1] = i;
}

// One pair's operands: its element's geometry and its pair-major key.
struct Pair {
  double ba, bb, ga, gb, coef;
  int key;
};

__device__ __forceinline__ int pair_key(int i, int n_elem) {
  const int e = static_cast<int>(static_cast<unsigned>(i) / 9u);
  return (i - 9 * e) * n_elem + e;
}

__device__ __forceinline__ Pair load_pair(const double* __restrict__ geom, int i, int n_elem) {
  const int e = static_cast<int>(static_cast<unsigned>(i) / 9u);
  const int ab = i - 9 * e;
  const int a = ab / 3, b = ab - 3 * (ab / 3);
  const double* g = geom + static_cast<int64_t>(kGeom) * e;
  return Pair{__ldg(g + a), __ldg(g + b), __ldg(g + 4 + a), __ldg(g + 4 + b), __ldg(g + 3),
              ab * n_elem + e};
}

// The pair's four block scalars k00, k01, k10, k11.
__device__ __forceinline__ void pair_block(const Pair& p, double d0, double d1, double d2,
                                           double k[4]) {
  k[0] = mul(p.coef, add(mul(mul(d0, p.ba), p.bb), mul(mul(d2, p.ga), p.gb)));
  k[1] = mul(p.coef, add(mul(mul(d1, p.ba), p.gb), mul(mul(d2, p.ga), p.bb)));
  k[2] = mul(p.coef, add(mul(mul(d1, p.ga), p.bb), mul(mul(d2, p.ba), p.gb)));
  k[3] = mul(p.coef, add(mul(mul(d0, p.ga), p.gb), mul(mul(d2, p.ba), p.bb)));
}

template <typename T>
__device__ __forceinline__ T narrow(double v);
template <>
__device__ __forceinline__ double narrow<double>(double v) { return v; }
template <>
__device__ __forceinline__ float narrow<float>(double v) { return __double2float_rn(v); }

// The assembly kernel's body. A warp owns a tile of 32 consecutive slots, one
// lane each: DIA / hybrid band slots are tiled 32 nodes of one band at a
// time, the tiles of one node range over every band taking consecutive
// warps (kNodeMajor), so the elements around those nodes are read while
// they are in cache; ELL slots (node K + band) are tiled as they lie; the
// hybrid remainder's slots come last. The tile's pairs are contiguous in
// the grouped order. The warp stages them (up to kCap, kUnroll a lane in
// flight at once) and each lane then sums its run; a tile with more pairs
// sums them from device memory. Warps wait on nothing but their own lanes.
template <typename T, int kCap, int kWarps, int kUnroll, bool kNodeMajor>
__device__ __forceinline__ void assemble_runs(
    const double* __restrict__ geom, const int* __restrict__ order,
    const int* __restrict__ bounds, int n_elem, int n_slots, int n_band_slots, int n_nodes,
    int n_bands, int ell_width, int n_tiles, double d0, double d1, double d2,
    T* __restrict__ bands, T* __restrict__ rem) {
  __shared__ int s_key[kWarps][kCap];
  __shared__ double2 s_val[kWarps][kCap][2];  // (k00, k01), (k10, k11)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= n_tiles) return;
  int first, valid;  // the tile's first slot, and how many of its 32 are slots
  T* out;            // the lane's k00; k01, k10, k11 follow `stride` apart
  int64_t stride;
  if (ell_width > 0) {
    first = tile * 32;
    valid = min(32, n_slots - first);
    const int s = first + lane, node = s / ell_width;
    out = bands + 4 * static_cast<int64_t>(n_nodes) * (s - node * ell_width) + node;
    stride = n_nodes;
  } else {
    const int per_band = (n_nodes + 31) / 32, band_tiles = per_band * n_bands;
    if (tile < band_tiles) {
      const int nt = kNodeMajor ? tile / n_bands : tile % per_band;
      const int band = kNodeMajor ? tile - nt * n_bands : tile / per_band;
      first = band * n_nodes + 32 * nt;
      valid = min(32, n_nodes - 32 * nt);
      out = bands + 4 * static_cast<int64_t>(n_nodes) * band + 32 * nt + lane;
      stride = n_nodes;
    } else {
      first = n_band_slots + 32 * (tile - band_tiles);
      valid = min(32, n_slots - first);
      out = rem + 4 * static_cast<int64_t>(first - n_band_slots + lane);
      stride = 1;
    }
  }
  const int lo = __ldg(bounds + first + min(lane, valid));
  const int hi = __ldg(bounds + first + min(lane + 1, valid));
  const int p0 = __shfl_sync(0xffffffffu, lo, 0);
  const int n_pairs = __shfl_sync(0xffffffffu, hi, 31) - p0;
  const bool staged = n_pairs <= kCap;  // the same in every lane
  int* key = s_key[warp];
  double2(*val)[2] = s_val[warp];
  if (staged) {
    for (int q0 = lane; q0 < n_pairs; q0 += 32 * kUnroll) {
      Pair p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + 32 * u;
        if (q < n_pairs) p[u] = load_pair(geom, __ldg(order + p0 + q), n_elem);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + 32 * u;
        if (q < n_pairs) {
          double k[4];
          pair_block(p[u], d0, d1, d2, k);
          key[q] = p[u].key;
          val[q][0] = make_double2(k[0], k[1]);
          val[q][1] = make_double2(k[2], k[3]);
        }
      }
    }
    __syncwarp();
  }
  if (lane >= valid) return;
  const int a = lo - p0, b = hi - p0;  // the lane's run in the tile's pairs
  double k00 = 0.0, k01 = 0.0, k10 = 0.0, k11 = 0.0;
  int last = -1;
  for (int r = a; r < b; ++r) {
    // the run's pair with the smallest key above the last one summed
    int best = INT_MAX, at = a;
    for (int q = a; q < b; ++q) {
      const int kq = staged ? key[q] : pair_key(__ldg(order + p0 + q), n_elem);
      if (kq > last && kq < best) {
        best = kq;
        at = q;
      }
    }
    last = best;
    double k[4];
    if (staged) {
      const double2 v0 = val[at][0], v1 = val[at][1];
      k[0] = v0.x;
      k[1] = v0.y;
      k[2] = v1.x;
      k[3] = v1.y;
    } else {
      pair_block(load_pair(geom, __ldg(order + p0 + at), n_elem), d0, d1, d2, k);
    }
    k00 = add(k00, k[0]);
    k01 = add(k01, k[1]);
    k10 = add(k10, k[2]);
    k11 = add(k11, k[3]);
  }
  out[0] = narrow<T>(k00);
  out[stride] = narrow<T>(k01);
  out[2 * stride] = narrow<T>(k10);
  out[3 * stride] = narrow<T>(k11);
}

template <typename T, int kCap, int kWarps, int kUnroll, bool kNodeMajor>
__global__ void __launch_bounds__(32 * kWarps) assemble_runs_kernel(
    const double* __restrict__ geom, const int* __restrict__ order,
    const int* __restrict__ bounds, int n_elem, int n_slots, int n_band_slots, int n_nodes,
    int n_bands, int ell_width, int n_tiles, double d0, double d1, double d2,
    T* __restrict__ bands, T* __restrict__ rem) {
  assemble_runs<T, kCap, kWarps, kUnroll, kNodeMajor>(geom, order, bounds, n_elem, n_slots,
                                                      n_band_slots, n_nodes, n_bands,
                                                      ell_width, n_tiles, d0, d1, d2, bands,
                                                      rem);
}

// One launch of an assembly kernel of kWarps warps a block (the shipped
// one below; scripts/assembly_variants.cu as of commit b558abc launched
// others).
template <typename T, int kWarps, typename Kernel>
int launch_tiles(Kernel kernel, const void* geom, const void* order, const void* bounds,
                 int n_elem, int n_slots, int n_band_slots, int n_nodes, int ell_width,
                 double d0, double d1, double d2, void* bands, void* rem,
                 cudaStream_t stream) {
  const int n_bands = ell_width > 0 ? ell_width : n_band_slots / n_nodes;
  const int n_tiles = ell_width > 0
                          ? (n_slots + 31) / 32
                          : (n_nodes + 31) / 32 * n_bands + (n_slots - n_band_slots + 31) / 32;
  const int blocks = (n_tiles + kWarps - 1) / kWarps;
  kernel<<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const double*>(geom), static_cast<const int*>(order),
      static_cast<const int*>(bounds), n_elem, n_slots, n_band_slots, n_nodes, n_bands,
      ell_width, n_tiles, d0, d1, d2, static_cast<T*>(bands), static_cast<T*>(rem));
  return static_cast<int>(cudaGetLastError());
}

// The shipped geometry: 96 staged pairs a warp (3 a slot), 4 warps a
// block, 2 pairs a lane in flight, node-major tiles
// (scripts/assembly_variants.py as of commit b558abc timed the others).
constexpr int kRunsCap = 96, kRunsWarps = 4, kRunsUnroll = 2;

template <typename T>
int launch_runs(const void* geom, const void* order, const void* bounds, int n_elem,
                int n_slots, int n_band_slots, int n_nodes, int ell_width, double d0, double d1,
                double d2, void* bands, void* rem, cudaStream_t stream) {
  return launch_tiles<T, kRunsWarps>(
      assemble_runs_kernel<T, kRunsCap, kRunsWarps, kRunsUnroll, true>, geom, order, bounds,
      n_elem, n_slots, n_band_slots, n_nodes, ell_width, d0, d1, d2, bands, rem, stream);
}

bool fits_int32(int64_t n_pairs, int64_t n_slots) {
  return n_pairs >= 0 && n_pairs <= INT_MAX && n_slots >= 0 && n_slots < INT_MAX;
}

}  // namespace

// coords [N, 2] f64, tris [E, 3] int64, slot_ids [9E] int64 (a-major),
// counts [S + 1] int32 zeroed by the caller; writes geom [E, 8] f64 and
// adds each pair to its slot's count (slot ids outside [0, S) are
// skipped, as segment_sum drops them). Returns a cudaError_t code (0 =
// launched).
extern "C" int mt_assemble_count(const void* coords, const void* tris, const void* slot_ids,
                                 int64_t n_elem, int64_t n_slots, double thick, void* geom,
                                 void* counts, void* stream) {
  if (n_elem <= 0 || n_slots <= 0 || !fits_int32(9 * n_elem, n_slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_elem + kElemThreads - 1) / kElemThreads;
  assemble_count_kernel<<<static_cast<unsigned>(blocks), kElemThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(coords), static_cast<const int64_t*>(tris),
      static_cast<const int64_t*>(slot_ids), static_cast<int>(n_elem),
      static_cast<int>(n_slots), thick, static_cast<double*>(geom), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// slot_ids [n_pairs] int64 (a-major), bounds [S + 1] int32 holding each
// slot's end (the inclusive scan of the counts); writes order [n_pairs]
// int32, the a-major pair indices grouped by slot, and leaves each slot's
// start in bounds.
extern "C" int mt_assemble_fill(const void* slot_ids, int64_t n_pairs, int64_t n_slots,
                                void* bounds, void* order, void* stream) {
  if (n_pairs <= 0 || n_slots <= 0 || !fits_int32(n_pairs, n_slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_pairs + kFillThreads - 1) / kFillThreads;
  assemble_fill_kernel<<<static_cast<unsigned>(blocks), kFillThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(slot_ids), static_cast<int>(n_pairs),
      static_cast<int>(n_slots), static_cast<int*>(bounds), static_cast<int*>(order));
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 = f32, 1 = f64 (the outputs'); geom [E, 8] f64, order [9E] and
// bounds [S + 1] int32 from the two kernels above; bands [n_band_slots /
// N, 2, 2, N], rem [S - n_band_slots, 2, 2]. ell_width = K > 0: slot s =
// node K + band (n_band_slots = S); 0: s = band N + node, the slots from
// n_band_slots on the remainder's. d0 = E / (1 - nu^2), d1 = nu d0, d2 =
// (1 - nu) d0 / 2.
extern "C" int mt_assemble_runs(int dtype, const void* geom, const void* order,
                                const void* bounds, int64_t n_elem, int64_t n_slots,
                                int64_t n_band_slots, int64_t n_nodes, int64_t ell_width,
                                double d0, double d1, double d2, void* bands, void* rem,
                                void* stream) {
  if (n_elem <= 0 || n_slots <= 0 || n_nodes <= 0 || n_band_slots <= 0 ||
      n_band_slots > n_slots || ell_width < 0 || ell_width > INT_MAX ||
      n_band_slots % n_nodes != 0 || (ell_width > 0 && n_band_slots != n_slots) ||
      !fits_int32(9 * n_elem, n_slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = static_cast<int>(n_elem), s = static_cast<int>(n_slots),
            sb = static_cast<int>(n_band_slots), n = static_cast<int>(n_nodes),
            k = static_cast<int>(ell_width);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_runs<double>(geom, order, bounds, e, s, sb, n, k, d0, d1, d2,
                                              bands, rem, st);
  if (dtype == 0) return launch_runs<float>(geom, order, bounds, e, s, sb, n, k, d0, d1, d2,
                                             bands, rem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
