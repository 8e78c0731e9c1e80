// Variants of the ELL kernel (csrc/ell_matvec.cu) and geometries of the
// fused coarse smoother (csrc/lane_coarse_smooth.cu) that the kernels do
// not ship, built as a library of their own for
// scripts/ell_coarse_variants.py to time against the shipped kernels.
//
// ELL (var_ell): one thread a row, as shipped, with the slot loop unrolled
// 4 or 8 times, an L2 evict-first policy on the streams, every slot's cols
// loaded before any u gather (K = 8 only), in any block size; and the split
// plan, t = 2 or 4 adjacent threads a row, thread p taking the slots
// k = p (mod t), two a round (their cols, then their u gathers, then the
// block values), the t partial sums met by __shfl_xor_sync. Each thread
// adds its slots in order (p, p + t, p + 2t, ...), and the shuffles add
// the threads' sums pairwise, so a row's sum is the plain version's within
// rounding, not bit for bit.
//
// Coarse smoother (var_coarse): the shipped kernel template, through any
// geometry (M rows a thread, L lanes a slab, the block bound) listed in
// VAR_COARSE_F32 / VAR_COARSE_F64.

#include "../magnetite_tpu_torch/csrc/lane_coarse_smooth.cu"

namespace ellv {

template <int kPol>
__device__ __forceinline__ double lds(const double* p, uint64_t pol) {
  double v;
  if (kPol)
    asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.L2::256B.f64 %0, [%1], %2;"
                 : "=d"(v) : "l"(p), "l"(pol));
  else
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
template <int kPol>
__device__ __forceinline__ float lds(const float* p, uint64_t pol) {
  float v;
  if (kPol)
    asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.L2::256B.f32 %0, [%1], %2;"
                 : "=f"(v) : "l"(p), "l"(pol));
  else
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
template <int kPol>
__device__ __forceinline__ int lds(const int* p, uint64_t pol) {
  int v;
  if (kPol)
    asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.L2::256B.s32 %0, [%1], %2;"
                 : "=r"(v) : "l"(p), "l"(pol));
  else
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// One thread a row. kU: the slot loop's unroll; kPol: evict-first on the
// streams; kStage: all 8 slots' cols, then their u gathers, then the
// blocks.
template <typename T, int kU, int kPol, int kStage>
__global__ void __launch_bounds__(768) one_thread(const T* __restrict__ data,
                                                  const int* __restrict__ cols,
                                                  const T* __restrict__ u, T* __restrict__ y,
                                                  int64_t n, int64_t n_u, int width) {
  const int64_t node = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (node >= n) return;
  uint64_t pol = 0;
  if (kPol) asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  const int64_t plane = n;
  const T* __restrict__ u1 = u + n_u;
  T acc0 = T(0), acc1 = T(0);
  if (kStage) {
    int src[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) src[k] = lds<kPol>(cols + k * plane + node, pol);
    T v0[8], v1[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v0[k] = __ldg(u + src[k]);
      v1[k] = __ldg(u1 + src[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const T* __restrict__ blk = data + 4 * k * plane + node;
      const T e00 = lds<kPol>(blk, pol), e01 = lds<kPol>(blk + plane, pol);
      const T e10 = lds<kPol>(blk + 2 * plane, pol), e11 = lds<kPol>(blk + 3 * plane, pol);
      acc0 = acc0 + e00 * v0[k] + e01 * v1[k];
      acc1 = acc1 + e10 * v0[k] + e11 * v1[k];
    }
  } else {
#pragma unroll kU
    for (int k = 0; k < width; ++k) {
      const int64_t src = lds<kPol>(cols + k * plane + node, pol);
      const T* __restrict__ blk = data + 4 * k * plane + node;
      const T e00 = lds<kPol>(blk, pol), e01 = lds<kPol>(blk + plane, pol);
      const T e10 = lds<kPol>(blk + 2 * plane, pol), e11 = lds<kPol>(blk + 3 * plane, pol);
      const T v0 = __ldg(u + src), v1 = __ldg(u1 + src);
      acc0 = acc0 + e00 * v0 + e01 * v1;
      acc1 = acc1 + e10 * v0 + e11 * v1;
    }
  }
  y[node] = acc0;
  y[n + node] = acc1;
}

// kSplit threads a row, each two of its slots a round. Every thread of a
// warp reaches the shuffles (no early return; blockDim is a multiple of 32,
// and a row's kSplit threads lie in one warp). The bound caps the
// registers (40), so two blocks of 768 fit an SM.
template <typename T, int kSplit>
__global__ void __launch_bounds__(768, 2) split(const T* __restrict__ data,
                                                const int* __restrict__ cols,
                                                const T* __restrict__ u, T* __restrict__ y,
                                                int64_t n, int64_t n_u, int width) {
  constexpr int kSlots = 2;
  const int64_t node = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kSplit;
  const int part = static_cast<int>(threadIdx.x % kSplit);
  const bool live = node < n;
  const int64_t plane = n;
  const T* __restrict__ u1 = u + n_u;
  T acc0 = T(0), acc1 = T(0);
  for (int k0 = part; k0 < width; k0 += kSplit * kSlots) {
    int src[kSlots];
    bool ok[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int k = k0 + s * kSplit;
      ok[s] = live && k < width;
      src[s] = ok[s] ? lds<0>(cols + k * plane + node, 0) : 0;
    }
    T v[kSlots][2];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      v[s][0] = ok[s] ? __ldg(u + src[s]) : T(0);
      v[s][1] = ok[s] ? __ldg(u1 + src[s]) : T(0);
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (ok[s]) {
        const T* __restrict__ blk =
            data + 4 * static_cast<int64_t>(k0 + s * kSplit) * plane + node;
        const T e00 = lds<0>(blk, 0), e01 = lds<0>(blk + plane, 0);
        const T e10 = lds<0>(blk + 2 * plane, 0), e11 = lds<0>(blk + 3 * plane, 0);
        acc0 = acc0 + e00 * v[s][0] + e01 * v[s][1];
        acc1 = acc1 + e10 * v[s][0] + e11 * v[s][1];
      }
    }
  }
#pragma unroll
  for (int m = 1; m < kSplit; m <<= 1) {
    acc0 = acc0 + __shfl_xor_sync(0xffffffffu, acc0, m);
    acc1 = acc1 + __shfl_xor_sync(0xffffffffu, acc1, m);
  }
  if (live && part == 0) {
    y[node] = acc0;
    y[n + node] = acc1;
  }
}

template <typename T>
int run(int variant, const void* data, const void* cols, const void* u, void* y, int64_t n,
        int64_t n_u, int width, int threads, cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  const int* c = static_cast<const int*>(cols);
  const T* uu = static_cast<const T*>(u);
  T* yy = static_cast<T*>(y);
  if (threads < 32 || threads > 768 || threads % 32 != 0) return cudaErrorInvalidValue;
  const int per_row = variant == 5 ? 2 : variant == 6 ? 4 : 1;
  const unsigned b = static_cast<unsigned>((n * per_row + threads - 1) / threads);
  switch (variant) {
    case 0: one_thread<T, 4, 0, 0><<<b, threads, 0, s>>>(d, c, uu, yy, n, n_u, width); break;
    case 1: one_thread<T, 8, 0, 0><<<b, threads, 0, s>>>(d, c, uu, yy, n, n_u, width); break;
    case 2: one_thread<T, 8, 1, 0><<<b, threads, 0, s>>>(d, c, uu, yy, n, n_u, width); break;
    case 3: one_thread<T, 4, 1, 0><<<b, threads, 0, s>>>(d, c, uu, yy, n, n_u, width); break;
    case 4:
      if (width != 8) return cudaErrorInvalidValue;
      one_thread<T, 4, 0, 1><<<b, threads, 0, s>>>(d, c, uu, yy, n, n_u, width);
      break;
    case 5: split<T, 2><<<b, threads, 0, s>>>(d, c, uu, yy, n, n_u, width); break;
    case 6: split<T, 4><<<b, threads, 0, s>>>(d, c, uu, yy, n, n_u, width); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ellv

// variant: 0 one thread a row, unroll 4 (the shipped kernel's loop); 1
// unroll 8; 2 unroll 8 and evict-first; 3 unroll 4 and evict-first; 4 the
// cols of all 8 slots first; 5 / 6 split over 2 / 4 threads a row.
// `threads` a block. Returns a cudaError_t code.
extern "C" int var_ell(int variant, int dtype, const void* data, const void* cols,
                       const void* u, void* y, int64_t n, int64_t n_u, int width, int threads,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ellv::run<float>(variant, data, cols, u, y, n, n_u, width, threads, s);
  if (dtype == 1) return ellv::run<double>(variant, data, cols, u, y, n, n_u, width, threads, s);
  return cudaErrorInvalidValue;
}

// Registers a thread of an ELL variant holds, or minus a cudaError_t code.
extern "C" int var_ell_regs(int variant, int dtype) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && variant == 5) err = cudaFuncGetAttributes(&attr, ellv::split<double, 2>);
  if (dtype == 1 && variant == 6) err = cudaFuncGetAttributes(&attr, ellv::split<double, 4>);
  if (dtype == 0 && variant == 5) err = cudaFuncGetAttributes(&attr, ellv::split<float, 2>);
  if (dtype == 0 && variant == 6) err = cudaFuncGetAttributes(&attr, ellv::split<float, 4>);
  return err == cudaSuccess ? attr.numRegs : -static_cast<int>(err);
}

// (M, L, the block bound): the shipped geometries and others
#define VAR_COARSE_F32(X) X(3, 7, 384) X(3, 4, 256) X(1, 2, 320)
#define VAR_COARSE_F64(X) X(2, 3, 256) X(2, 2, 192) X(1, 2, 320)

template <typename T>
int var_coarse_run(int m, int lanes, const void* packed, const void* dinv, const void* wa,
                   const void* wb, const void* wc, const void* r, void* e, int rows, int cols,
                   int64_t nb, int sweeps, double omega, int wrap, cudaStream_t s) {
#define VAR_COARSE_RUN(M, L, CAP)                                                        \
  if (m == M && lanes == L) {                                                            \
    return launch<T, M, L, CAP>(packed, dinv, wa, wb, wc, r, e, rows, cols, nb, sweeps, \
                                omega, wrap, s);                                         \
  }
  if constexpr (sizeof(T) == 4) {
    VAR_COARSE_F32(VAR_COARSE_RUN)
  } else {
    VAR_COARSE_F64(VAR_COARSE_RUN)
  }
#undef VAR_COARSE_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

// mt_lane_coarse_smooth3's operands through the geometry (m, lanes).
extern "C" int var_coarse(int dtype, int m, int lanes, int wrap, const void* packed,
                          const void* dinv, const void* wa, const void* wb, const void* wc,
                          const void* r, void* e, int rows, int cols, int64_t nb, int sweeps,
                          double omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return var_coarse_run<float>(m, lanes, packed, dinv, wa, wb, wc, r, e, rows, cols, nb,
                                 sweeps, omega, wrap, s);
  if (dtype == 1)
    return var_coarse_run<double>(m, lanes, packed, dinv, wa, wb, wc, r, e, rows, cols, nb,
                                  sweeps, omega, wrap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
