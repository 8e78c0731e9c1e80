// Geometries of the device assembly's kernel (csrc/assemble_pairs.cu) that
// it does not ship, and the first design tried, built as a library of
// their own for scripts/assembly_variants.py to time against the shipped
// kernel. Every variant sums each run in pair-major order with the same
// operations, so each gives the shipped kernel's bits.
//
// var_runs variant 0: one block of 128 slots, one thread a slot, staging
// up to 1,024 pairs (36 KB of shared memory, 6 blocks an SM) with 4 pairs
// a thread in flight, slots in slot order (band-major for DIA); a block
// whose pairs exceed the stage reads them all from device memory.
// Variants 1-8: the shipped warp-tile kernel's body, assemble_runs<double,
// kCap, kWarps, kUnroll, kNodeMajor>, in the geometries of VAR_RUNS, one
// of them under a register cap. var_count_rank / var_fill_rank: the runs built with each
// pair's rank taken from the count's atomic add, so the fill needs none.

#include "../magnetite_tpu_torch/csrc/assemble_pairs.cu"

namespace asmv {

constexpr int kSlots = 128, kBlockCap = 1024, kBlockUnroll = 4;

__global__ void __launch_bounds__(kSlots) block_kernel(
    const double* __restrict__ geom, const int* __restrict__ order,
    const int* __restrict__ bounds, int n_elem, int n_slots, int n_band_slots, int n_nodes,
    int ell_width, double d0, double d1, double d2, double* __restrict__ bands,
    double* __restrict__ rem) {
  __shared__ int s_bound[kSlots + 1];
  __shared__ int s_key[kBlockCap];
  __shared__ double2 s_val[kBlockCap][2];
  const int s0 = blockIdx.x * kSlots;
  const int n_own = min(kSlots, n_slots - s0);
  for (int j = threadIdx.x; j <= n_own; j += kSlots) s_bound[j] = __ldg(bounds + s0 + j);
  __syncthreads();
  const int p0 = s_bound[0];
  const int n_pairs = s_bound[n_own] - p0;
  const bool staged = n_pairs <= kBlockCap;
  if (staged) {
    for (int q0 = threadIdx.x; q0 < n_pairs; q0 += kBlockUnroll * kSlots) {
      Pair p[kBlockUnroll];
#pragma unroll
      for (int u = 0; u < kBlockUnroll; ++u) {
        const int q = q0 + u * kSlots;
        if (q < n_pairs) p[u] = load_pair(geom, __ldg(order + p0 + q), n_elem);
      }
#pragma unroll
      for (int u = 0; u < kBlockUnroll; ++u) {
        const int q = q0 + u * kSlots;
        if (q < n_pairs) {
          double k[4];
          pair_block(p[u], d0, d1, d2, k);
          s_key[q] = p[u].key;
          s_val[q][0] = make_double2(k[0], k[1]);
          s_val[q][1] = make_double2(k[2], k[3]);
        }
      }
    }
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= n_own) return;
  const int lo = s_bound[j] - p0, hi = s_bound[j + 1] - p0;
  double k00 = 0.0, k01 = 0.0, k10 = 0.0, k11 = 0.0;
  int last = -1;
  for (int r = lo; r < hi; ++r) {
    int best = INT_MAX, at = lo;
    for (int q = lo; q < hi; ++q) {
      const int key = staged ? s_key[q] : pair_key(__ldg(order + p0 + q), n_elem);
      if (key > last && key < best) {
        best = key;
        at = q;
      }
    }
    last = best;
    double k[4];
    if (staged) {
      const double2 v0 = s_val[at][0], v1 = s_val[at][1];
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
  const int s = s0 + j;
  double* o;
  int64_t stride;
  if (s < n_band_slots) {
    const int major = ell_width > 0 ? s / ell_width : s / n_nodes;
    const int band = ell_width > 0 ? s - major * ell_width : major;
    const int node = ell_width > 0 ? major : s - major * n_nodes;
    o = bands + 4 * static_cast<int64_t>(n_nodes) * band + node;
    stride = n_nodes;
  } else {
    o = rem + 4 * static_cast<int64_t>(s - n_band_slots);
    stride = 1;
  }
  o[0] = k00;
  o[stride] = k01;
  o[2 * stride] = k10;
  o[3 * stride] = k11;
}

}  // namespace asmv

namespace asmv {

// The runs through per-pair ranks: the count kernel takes each pair's
// place in its slot's run from its atomic add (counts land one slot up, so
// the inclusive scan gives the starts) and the fill writes each pair to
// its start plus its rank, with no atomics.
__global__ void __launch_bounds__(256) count_rank_kernel(
    const double* __restrict__ coords, const int64_t* __restrict__ tris,
    const int64_t* __restrict__ slot_ids, int n_elem, int n_slots, double thick,
    double* __restrict__ geom, int* __restrict__ counts, int* __restrict__ rank) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n_elem) return;
  double x[3], y[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t node = __ldg(reinterpret_cast<const long long*>(tris) + 3 * e + c);
    const double2 xy = __ldg(reinterpret_cast<const double2*>(coords) + node);
    x[c] = xy.x;
    y[c] = xy.y;
  }
  const double b0 = sub(y[1], y[2]), b1 = sub(y[2], y[0]), b2 = sub(y[0], y[1]);
  const double area2 = add(add(mul(x[0], b0), mul(x[1], b1)), mul(x[2], b2));
  double2* g = reinterpret_cast<double2*>(geom + static_cast<int64_t>(kGeom) * e);
  g[0] = make_double2(b0, b1);
  g[1] = make_double2(b2, __ddiv_rn(thick, mul(2.0, area2)));
  g[2] = make_double2(sub(x[2], x[1]), sub(x[0], x[2]));
  g[3] = make_double2(sub(x[1], x[0]), 0.0);
  const long long* ids = reinterpret_cast<const long long*>(slot_ids) + 9 * static_cast<int64_t>(e);
  int r[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const long long s = __ldg(ids + j);
    r[j] = (s >= 0 && s < n_slots) ? atomicAdd(counts + s + 1, 1) : 0;
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) rank[9 * static_cast<int64_t>(e) + j] = r[j];
}

__global__ void __launch_bounds__(256) fill_rank_kernel(
    const int64_t* __restrict__ slot_ids, const int* __restrict__ rank, int n_pairs,
    int n_slots, const int* __restrict__ starts, int* __restrict__ order) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n_pairs) return;
  const long long s = __ldg(reinterpret_cast<const long long*>(slot_ids) + i);
  if (s < 0 || s >= n_slots) return;
  order[__ldg(starts + s) + __ldg(rank + i)] = i;
}

}  // namespace asmv

// counts [S + 1] zeroed; rank [9E] int32; geom [E, 8].
extern "C" int var_count_rank(const void* coords, const void* tris, const void* slot_ids,
                              int64_t n_elem, int64_t n_slots, double thick, void* geom,
                              void* counts, void* rank, void* stream) {
  asmv::count_rank_kernel<<<static_cast<unsigned>((n_elem + 255) / 256), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(coords), static_cast<const int64_t*>(tris),
      static_cast<const int64_t*>(slot_ids), static_cast<int>(n_elem),
      static_cast<int>(n_slots), thick, static_cast<double*>(geom), static_cast<int*>(counts),
      static_cast<int*>(rank));
  return static_cast<int>(cudaGetLastError());
}

// starts [S + 1] (the inclusive scan of var_count_rank's counts).
extern "C" int var_fill_rank(const void* slot_ids, const void* rank, int64_t n_pairs,
                             int64_t n_slots, const void* starts, void* order, void* stream) {
  asmv::fill_rank_kernel<<<static_cast<unsigned>((n_pairs + 255) / 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(slot_ids), static_cast<const int*>(rank),
      static_cast<int>(n_pairs), static_cast<int>(n_slots), static_cast<const int*>(starts),
      static_cast<int*>(order));
  return static_cast<int>(cudaGetLastError());
}

namespace asmv {

// The shipped kernel's body under a register cap: kMinBlocks blocks an SM.
template <int kCap, int kWarps, int kUnroll, bool kNodeMajor, int kMinBlocks>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks) capped_kernel(
    const double* __restrict__ geom, const int* __restrict__ order,
    const int* __restrict__ bounds, int n_elem, int n_slots, int n_band_slots, int n_nodes,
    int n_bands, int ell_width, int n_tiles, double d0, double d1, double d2,
    double* __restrict__ bands, double* __restrict__ rem) {
  assemble_runs<double, kCap, kWarps, kUnroll, kNodeMajor>(
      geom, order, bounds, n_elem, n_slots, n_band_slots, n_nodes, n_bands, ell_width, n_tiles,
      d0, d1, d2, bands, rem);
}

}  // namespace asmv

// (kCap, kWarps, kUnroll, kNodeMajor, kMinBlocks) of variants 1, 2, ...;
// 1 is the shipped geometry, and kMinBlocks 0 leaves the registers uncapped
#define VAR_RUNS(X)                                                                      \
  X(1, 96, 4, 2, true, 0) X(2, 96, 2, 2, true, 0) X(3, 64, 4, 2, true, 0)               \
  X(4, 128, 4, 2, true, 0) X(5, 96, 8, 2, true, 0) X(6, 96, 4, 1, true, 0)              \
  X(7, 96, 4, 2, false, 0) X(8, 96, 4, 2, true, 12)

template <int kCap, int kWarps, int kUnroll, bool kNodeMajor, int kMinBlocks>
int var_launch(const void* geom, const void* order, const void* bounds, int e, int s, int sb,
               int n, int k, double d0, double d1, double d2, void* bands, void* rem,
               cudaStream_t st) {
  if constexpr (kMinBlocks > 0) {
    return launch_tiles<double, kWarps>(
        asmv::capped_kernel<kCap, kWarps, kUnroll, kNodeMajor, kMinBlocks>, geom, order,
        bounds, e, s, sb, n, k, d0, d1, d2, bands, rem, st);
  } else {
    return launch_tiles<double, kWarps>(
        assemble_runs_kernel<double, kCap, kWarps, kUnroll, kNodeMajor>, geom, order, bounds,
        e, s, sb, n, k, d0, d1, d2, bands, rem, st);
  }
}

// mt_assemble_runs's operands (f64 outputs) through variant `variant`.
extern "C" int var_runs(int variant, const void* geom, const void* order, const void* bounds,
                        int64_t n_elem, int64_t n_slots, int64_t n_band_slots, int64_t n_nodes,
                        int64_t ell_width, double d0, double d1, double d2, void* bands,
                        void* rem, void* stream) {
  const int e = static_cast<int>(n_elem), s = static_cast<int>(n_slots),
            sb = static_cast<int>(n_band_slots), n = static_cast<int>(n_nodes),
            k = static_cast<int>(ell_width);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    asmv::block_kernel<<<(s + asmv::kSlots - 1) / asmv::kSlots, asmv::kSlots, 0, st>>>(
        static_cast<const double*>(geom), static_cast<const int*>(order),
        static_cast<const int*>(bounds), e, s, sb, n, k, d0, d1, d2,
        static_cast<double*>(bands), static_cast<double*>(rem));
    return static_cast<int>(cudaGetLastError());
  }
#define VAR_RUNS_CASE(V, CAP, WARPS, UNROLL, NODE_MAJOR, MIN_BLOCKS)                     \
  if (variant == V)                                                                      \
    return var_launch<CAP, WARPS, UNROLL, NODE_MAJOR, MIN_BLOCKS>(geom, order, bounds, e, \
                                                                 s, sb, n, k, d0, d1, d2, \
                                                                 bands, rem, st);
  VAR_RUNS(VAR_RUNS_CASE)
#undef VAR_RUNS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
