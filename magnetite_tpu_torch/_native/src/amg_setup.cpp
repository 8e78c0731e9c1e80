// AMG setup hot loops (native host runtime).
//
// The smoothed-aggregation hierarchy build (magnetite_tpu/fem/amg.py) is
// host-side by design (irregular, data-dependent, one-time, persisted with
// case checkpoints); these kernels replace its two dominant numpy costs at
// 1M-element scale:
//
//   amg_assemble: the BC-masked closed-form stiffness assembly into the
//     ELL-flat value array -- one pass over elements computing the four
//     2x2-block component fields (k_ab = t/(4A) * B_a^T D B_b expanded;
//     reference math src/solver.rs:204-278) and scatter-adding through the
//     precomputed slot ids. numpy needs four 9E-sized bincount passes plus
//     several [3,3,E] broadcast temporaries.
//
//   sort_reduce_blocks: sum duplicate (int64 key, f64[k] block) entries --
//     the core of every Galerkin-product reduction. numpy's
//     unique+bincount does one argsort plus k bincount passes; here one
//     pair sort + one accumulation pass.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// Closed-form masked assembly: accumulate the 2x2 pair blocks of every
// element into flat [n_slots, 4] storage (component-major last axis, row
// major), through pair-major slot ids slot_ids_pm[(a*3+b)*E + e].
// coords [N*2], tris [E*3] i32, free_mask [N*2] f64 (1 = unknown DOF).
// Returns 0.
int amg_assemble(const double* coords, const int32_t* tris, int64_t n_elems,
                 const double* free_mask, double e_mod, double nu, double t,
                 const int64_t* slot_ids_pm, double* flat /* [n_slots*4] */) {
  const double d0 = e_mod / (1.0 - nu * nu);
  const double d1 = nu * d0;
  const double d2 = 0.5 * (1.0 - nu) * d0;
  for (int64_t e = 0; e < n_elems; ++e) {
    const int32_t n0 = tris[3 * e], n1 = tris[3 * e + 1], n2 = tris[3 * e + 2];
    const double x0 = coords[2 * n0], y0 = coords[2 * n0 + 1];
    const double x1 = coords[2 * n1], y1 = coords[2 * n1 + 1];
    const double x2 = coords[2 * n2], y2 = coords[2 * n2 + 1];
    const double beta[3] = {y1 - y2, y2 - y0, y0 - y1};
    const double gamma[3] = {x2 - x1, x0 - x2, x1 - x0};
    const double area2 =
        x0 * (y1 - y2) + x1 * (y2 - y0) + x2 * (y0 - y1);
    const double coef = t / (2.0 * area2);
    const int32_t nodes[3] = {n0, n1, n2};
    for (int a = 0; a < 3; ++a) {
      const double fxa = free_mask[2 * nodes[a]];
      const double fya = free_mask[2 * nodes[a] + 1];
      const double ba = beta[a], ga = gamma[a];
      for (int b = 0; b < 3; ++b) {
        const double fxb = free_mask[2 * nodes[b]];
        const double fyb = free_mask[2 * nodes[b] + 1];
        const double bb = beta[b], gb = gamma[b];
        const int64_t slot = slot_ids_pm[(int64_t)(a * 3 + b) * n_elems + e];
        double* out = flat + 4 * slot;
        out[0] += coef * (d0 * ba * bb + d2 * ga * gb) * fxa * fxb;
        out[1] += coef * (d1 * ba * gb + d2 * ga * bb) * fxa * fyb;
        out[2] += coef * (d1 * ga * bb + d2 * ba * gb) * fya * fxb;
        out[3] += coef * (d0 * ga * gb + d2 * ba * bb) * fya * fyb;
      }
    }
  }
  return 0;
}

// Sum duplicate keys: sorts (key, index) pairs, then accumulates the k-wide
// value rows of equal-key runs. out_keys/out_vals must hold m entries;
// returns the number of unique keys.
int64_t sort_reduce_blocks(const int64_t* keys, const double* vals, int64_t m,
                           int64_t k, int64_t* out_keys, double* out_vals) {
  if (m == 0) return 0;
  std::vector<std::pair<int64_t, int64_t>> order(m);
  for (int64_t i = 0; i < m; ++i) order[i] = {keys[i], i};
  std::sort(order.begin(), order.end());
  int64_t u = -1;
  int64_t prev = order[0].first - 1;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t key = order[i].first;
    const double* row = vals + k * order[i].second;
    if (key != prev) {
      ++u;
      out_keys[u] = key;
      std::memcpy(out_vals + k * u, row, sizeof(double) * k);
      prev = key;
    } else {
      double* acc = out_vals + k * u;
      for (int64_t c = 0; c < k; ++c) acc[c] += row[c];
    }
  }
  return u + 1;
}

// Direct block-COO stiffness assembly: sort the 9E (row*N+col) pair keys,
// then one accumulation pass computing each pair's BC-masked 2x2 block in
// closed form on the fly (no ELL structure, no scatter storage). Output is
// sorted unique keys + [u, 4] blocks; returns u. out_keys holds >= 9E
// entries, out_vals >= 9E*4.
int64_t assemble_coo_blocks(const double* coords, const int32_t* tris,
                            int64_t n_elems, const double* free_mask,
                            double e_mod, double nu, double t, int64_t n_nodes,
                            int64_t* out_keys, double* out_vals) {
  const int64_t total = 9 * n_elems;
  if (total == 0) return 0;
  std::vector<std::pair<int64_t, int64_t>> order(total);
  for (int64_t e = 0; e < n_elems; ++e) {
    const int64_t n0 = tris[3 * e], n1 = tris[3 * e + 1], n2 = tris[3 * e + 2];
    const int64_t nodes[3] = {n0, n1, n2};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        order[9 * e + 3 * a + b] = {nodes[a] * n_nodes + nodes[b],
                                    9 * e + 3 * a + b};
  }
  std::sort(order.begin(), order.end());
  const double d0 = e_mod / (1.0 - nu * nu);
  const double d1 = nu * d0;
  const double d2 = 0.5 * (1.0 - nu) * d0;
  int64_t u = -1;
  int64_t prev = order[0].first - 1;
  for (int64_t i = 0; i < total; ++i) {
    const int64_t key = order[i].first;
    const int64_t aux = order[i].second;
    const int64_t e = aux / 9;
    const int a = (int)((aux % 9) / 3), b = (int)(aux % 3);
    const int32_t m0 = tris[3 * e], m1 = tris[3 * e + 1], m2 = tris[3 * e + 2];
    const double x0 = coords[2 * m0], y0 = coords[2 * m0 + 1];
    const double x1 = coords[2 * m1], y1 = coords[2 * m1 + 1];
    const double x2 = coords[2 * m2], y2 = coords[2 * m2 + 1];
    const double beta[3] = {y1 - y2, y2 - y0, y0 - y1};
    const double gamma[3] = {x2 - x1, x0 - x2, x1 - x0};
    const double area2 = x0 * (y1 - y2) + x1 * (y2 - y0) + x2 * (y0 - y1);
    const double coef = t / (2.0 * area2);
    const int32_t nodes[3] = {m0, m1, m2};
    const double fxa = free_mask[2 * nodes[a]], fya = free_mask[2 * nodes[a] + 1];
    const double fxb = free_mask[2 * nodes[b]], fyb = free_mask[2 * nodes[b] + 1];
    const double ba = beta[a], ga = gamma[a], bb = beta[b], gb = gamma[b];
    if (key != prev) {
      ++u;
      out_keys[u] = key;
      double* o = out_vals + 4 * u;
      o[0] = o[1] = o[2] = o[3] = 0.0;
      prev = key;
    }
    double* o = out_vals + 4 * u;
    o[0] += coef * (d0 * ba * bb + d2 * ga * gb) * fxa * fxb;
    o[1] += coef * (d1 * ba * gb + d2 * ga * bb) * fxa * fyb;
    o[2] += coef * (d1 * ga * bb + d2 * ba * gb) * fya * fxb;
    o[3] += coef * (d0 * ga * gb + d2 * ba * bb) * fya * fyb;
  }
  return u + 1;
}

// y = A x for block-COO A (sorted keys row*n+col, [nnz, m*m] blocks),
// x/y [n, m] row-major. The power-iteration hot loop.
int coo_matvec_blocks(const int64_t* keys, const double* vals, int64_t nnz,
                      int64_t m, int64_t n, const double* x, double* y) {
  std::memset(y, 0, sizeof(double) * n * m);
  for (int64_t idx = 0; idx < nnz; ++idx) {
    const int64_t i = keys[idx] / n, j = keys[idx] % n;
    const double* blk = vals + idx * m * m;
    const double* xj = x + j * m;
    double* yi = y + i * m;
    for (int64_t r = 0; r < m; ++r) {
      double s = 0.0;
      for (int64_t c = 0; c < m; ++c) s += blk[r * m + c] * xj[c];
      yi[r] += s;
    }
  }
  return 0;
}

// P = (I - omega D^-1 A) P0 in block-COO keyed (fine row * n_agg + coarse
// col), sorted + reduced. A: sorted keys (i*n+j), [nnz, m*m]. diag_inv
// [n, m*m]; p0 [n, m*mc] (each fine node's single block, coarse col =
// agg[node]). out_keys/out_vals sized >= nnz + n. Returns unique count.
int64_t smooth_prolongator_blocks(const int64_t* a_keys, const double* a_vals,
                                  int64_t nnz, int64_t m, int64_t n,
                                  const double* diag_inv, const double* p0,
                                  int64_t mc, const int64_t* agg,
                                  int64_t n_agg, double omega,
                                  int64_t* out_keys, double* out_vals) {
  const int64_t k = m * mc;
  const int64_t total = nnz + n;
  std::vector<int64_t> keys(total);
  std::vector<double> vals(total * k);
  double tmp[9];  // Dinv[i] @ A[ij], m <= 3
  for (int64_t idx = 0; idx < nnz; ++idx) {
    const int64_t i = a_keys[idx] / n, j = a_keys[idx] % n;
    const double* di = diag_inv + i * m * m;
    const double* ab = a_vals + idx * m * m;
    for (int64_t r = 0; r < m; ++r)
      for (int64_t c = 0; c < m; ++c) {
        double s = 0.0;
        for (int64_t q = 0; q < m; ++q) s += di[r * m + q] * ab[q * m + c];
        tmp[r * m + c] = s;
      }
    const double* pj = p0 + j * k;
    double* o = vals.data() + idx * k;
    for (int64_t r = 0; r < m; ++r)
      for (int64_t c = 0; c < mc; ++c) {
        double s = 0.0;
        for (int64_t q = 0; q < m; ++q) s += tmp[r * m + q] * pj[q * mc + c];
        o[r * mc + c] = -omega * s;
      }
    keys[idx] = i * n_agg + agg[j];
  }
  for (int64_t i = 0; i < n; ++i) {
    keys[nnz + i] = i * n_agg + agg[i];
    std::memcpy(vals.data() + (nnz + i) * k, p0 + i * k, sizeof(double) * k);
  }
  return sort_reduce_blocks(keys.data(), vals.data(), total, k, out_keys,
                            out_vals);
}

// Galerkin product C = P^T A P in block-COO.
// A: sorted keys (i*n+j), [nnz_a, m*m] over n fine rows.
// P: sorted keys (i*n_agg+a), [nnz_p, m*mc].
// out keyed (b*n_agg+a) sorted unique, [*, mc*mc]; returns count, or -1 if
// it would exceed `cap` entries (caller falls back / retries bigger).
// Classic two-phase SpGEMM with dense per-row accumulators + touched lists.
int64_t rap_blocks(const int64_t* a_keys, const double* a_vals, int64_t nnz_a,
                   int64_t m, int64_t n, const int64_t* p_keys,
                   const double* p_vals, int64_t nnz_p, int64_t mc,
                   int64_t n_agg, int64_t* out_keys, double* out_vals,
                   int64_t cap) {
  // row pointers (keys sorted -> one counting pass each)
  std::vector<int64_t> a_ptr(n + 1, 0), p_ptr(n + 1, 0);
  for (int64_t idx = 0; idx < nnz_a; ++idx) ++a_ptr[a_keys[idx] / n + 1];
  for (int64_t idx = 0; idx < nnz_p; ++idx) ++p_ptr[p_keys[idx] / n_agg + 1];
  for (int64_t i = 0; i < n; ++i) {
    a_ptr[i + 1] += a_ptr[i];
    p_ptr[i + 1] += p_ptr[i];
  }

  // phase A: AP[i, a] = sum_j A[i,j] P[j, a]
  const int64_t kap = m * mc;
  std::vector<double> acc(n_agg * kap);
  std::vector<int64_t> stamp(n_agg, -1);
  std::vector<int64_t> touched;
  std::vector<int64_t> ap_ptr(n + 1, 0);
  std::vector<int64_t> ap_cols;
  std::vector<double> ap_vals;
  ap_cols.reserve(nnz_a);
  ap_vals.reserve(nnz_a * kap);
  for (int64_t i = 0; i < n; ++i) {
    touched.clear();
    for (int64_t idx = a_ptr[i]; idx < a_ptr[i + 1]; ++idx) {
      const int64_t j = a_keys[idx] % n;
      const double* ab = a_vals + idx * m * m;
      for (int64_t pidx = p_ptr[j]; pidx < p_ptr[j + 1]; ++pidx) {
        const int64_t a = p_keys[pidx] % n_agg;
        const double* pb = p_vals + pidx * m * mc;
        if (stamp[a] != i) {
          stamp[a] = i;
          touched.push_back(a);
          std::memset(acc.data() + a * kap, 0, sizeof(double) * kap);
        }
        double* o = acc.data() + a * kap;
        for (int64_t r = 0; r < m; ++r)
          for (int64_t c = 0; c < mc; ++c) {
            double s = 0.0;
            for (int64_t q = 0; q < m; ++q) s += ab[r * m + q] * pb[q * mc + c];
            o[r * mc + c] += s;
          }
      }
    }
    std::sort(touched.begin(), touched.end());
    ap_ptr[i + 1] = ap_ptr[i] + (int64_t)touched.size();
    for (int64_t a : touched) {
      ap_cols.push_back(a);
      const double* o = acc.data() + a * kap;
      ap_vals.insert(ap_vals.end(), o, o + kap);
    }
  }

  // transpose P: entry indices ordered by (coarse col, fine row)
  std::vector<std::pair<int64_t, int64_t>> pt(nnz_p);
  for (int64_t pidx = 0; pidx < nnz_p; ++pidx) {
    const int64_t i = p_keys[pidx] / n_agg, a = p_keys[pidx] % n_agg;
    pt[pidx] = {a * n + i, pidx};
  }
  std::sort(pt.begin(), pt.end());
  std::vector<int64_t> pt_ptr(n_agg + 1, 0);
  for (int64_t idx = 0; idx < nnz_p; ++idx) ++pt_ptr[pt[idx].first / n + 1];
  for (int64_t b = 0; b < n_agg; ++b) pt_ptr[b + 1] += pt_ptr[b];

  // phase B: C[b, a] = sum_i P[i,b]^T AP[i,a], per coarse row
  const int64_t kc = mc * mc;
  acc.assign(n_agg * kc, 0.0);
  std::fill(stamp.begin(), stamp.end(), -1);
  int64_t u = 0;
  for (int64_t b = 0; b < n_agg; ++b) {
    touched.clear();
    for (int64_t tidx = pt_ptr[b]; tidx < pt_ptr[b + 1]; ++tidx) {
      const int64_t pidx = pt[tidx].second;
      const int64_t i = p_keys[pidx] / n_agg;
      const double* pb = p_vals + pidx * m * mc;  // P[i,b], m x mc
      for (int64_t aidx = ap_ptr[i]; aidx < ap_ptr[i + 1]; ++aidx) {
        const int64_t a = ap_cols[aidx];
        const double* apb = ap_vals.data() + aidx * kap;  // AP[i,a], m x mc
        if (stamp[a] != b) {
          stamp[a] = b;
          touched.push_back(a);
          std::memset(acc.data() + a * kc, 0, sizeof(double) * kc);
        }
        double* o = acc.data() + a * kc;
        for (int64_t r = 0; r < mc; ++r)
          for (int64_t c = 0; c < mc; ++c) {
            double s = 0.0;
            for (int64_t q = 0; q < m; ++q)
              s += pb[q * mc + r] * apb[q * mc + c];
            o[r * mc + c] += s;
          }
      }
    }
    std::sort(touched.begin(), touched.end());
    if (u + (int64_t)touched.size() > cap) return -1;
    for (int64_t a : touched) {
      out_keys[u] = b * n_agg + a;
      std::memcpy(out_vals + u * kc, acc.data() + a * kc, sizeof(double) * kc);
      ++u;
    }
  }
  return u;
}

}  // extern "C"
