// Sparsity-structure builders (native host runtime).
//
// The analog of the reference's assembly bookkeeping (reference:
// src/solver.rs:290-331 walks elements scatter-adding into a dense matrix).
// Here the host derives static scatter patterns once per mesh; the numeric
// assembly runs on-device. numpy's np.unique over the 9E pair keys costs
// ~3 s at 1M elements; this sort-based builder is the fast path.
//
// Block-ELL:
//   ell_structure_width(tris, E, N, scratch[9E]) -> width (or <0 error)
//   ell_structure_fill(tris, E, N, width, cols[N*width], slot_ids[9E],
//                      scratch[9E])
// DIA:
//   dia_structure(tris, E, N, max_diags, offsets[max_diags],
//                 slot_ids[9E]) -> n_diags (or <0 if over max_diags)

#include <algorithm>
#include <cstdint>

namespace {

// enumerate the 9 ordered node pairs of element e in (a-major) order
// matching assembly.element_blocks
inline void pair_at(const int32_t* tris, int64_t idx, int64_t* row,
                    int64_t* col) {
  int64_t e = idx / 9;
  int64_t a = (idx % 9) / 3;
  int64_t b = idx % 3;
  *row = tris[3 * e + a];
  *col = tris[3 * e + b];
}

}  // namespace

extern "C" {

// Pass 1: sort pair keys, count unique pairs per row, return max row width.
// scratch must hold 9E int64.
int64_t ell_structure_width(const int32_t* tris, int64_t n_elems,
                            int64_t n_nodes, int64_t* scratch) {
  const int64_t m = 9 * n_elems;
  for (int64_t i = 0; i < m; ++i) {
    int64_t r, c;
    pair_at(tris, i, &r, &c);
    if (r < 0 || r >= n_nodes || c < 0 || c >= n_nodes) return -1;
    scratch[i] = r * n_nodes + c;
  }
  std::sort(scratch, scratch + m);
  int64_t width = 0, run = 0;
  int64_t prev_row = -1;
  int64_t prev_key = -1;
  for (int64_t i = 0; i < m; ++i) {
    if (scratch[i] == prev_key) continue;
    prev_key = scratch[i];
    int64_t row = scratch[i] / n_nodes;
    if (row != prev_row) {
      prev_row = row;
      run = 0;
    }
    ++run;
    if (run > width) width = run;
  }
  return width;
}

// Pass 2: fill cols (padded with own row index) and per-pair slot ids.
int ell_structure_fill(const int32_t* tris, int64_t n_elems, int64_t n_nodes,
                       int64_t width, int32_t* cols, int32_t* slot_ids,
                       int64_t* scratch) {
  const int64_t m = 9 * n_elems;
  for (int64_t i = 0; i < m; ++i) {
    int64_t r, c;
    pair_at(tris, i, &r, &c);
    scratch[i] = r * n_nodes + c;
  }
  // sorted unique keys
  int64_t* sorted = new int64_t[m];
  std::copy(scratch, scratch + m, sorted);
  std::sort(sorted, sorted + m);
  int64_t n_uniq = 0;
  for (int64_t i = 0; i < m; ++i) {
    if (n_uniq == 0 || sorted[n_uniq - 1] != sorted[i])
      sorted[n_uniq++] = sorted[i];
  }
  // default cols: own row index (padding)
  for (int64_t r = 0; r < n_nodes; ++r)
    for (int64_t k = 0; k < width; ++k) cols[r * width + k] = (int32_t)r;
  // rank of each unique key within its row; record slot for lookup
  int64_t* key_slot = new int64_t[n_uniq];
  {
    int64_t prev_row = -1, rank = 0;
    for (int64_t i = 0; i < n_uniq; ++i) {
      int64_t row = sorted[i] / n_nodes;
      int64_t col = sorted[i] % n_nodes;
      if (row != prev_row) {
        prev_row = row;
        rank = 0;
      }
      if (rank >= width) {
        delete[] sorted;
        delete[] key_slot;
        return -2;
      }
      cols[row * width + rank] = (int32_t)col;
      key_slot[i] = row * width + rank;
      ++rank;
    }
  }
  // map every pair to its slot via binary search over the unique keys
  for (int64_t i = 0; i < m; ++i) {
    const int64_t* it =
        std::lower_bound(sorted, sorted + n_uniq, scratch[i]);
    slot_ids[i] = (int32_t)key_slot[it - sorted];
  }
  delete[] sorted;
  delete[] key_slot;
  return 0;
}

// DIA: distinct (col-row) offsets + slot ids (d_idx * N + row).
// offsets must hold max_diags int64; slot_ids 9E int32 (written on success).
// Returns n_diags, or -(actual_diags) if it exceeds max_diags.
int64_t dia_structure(const int32_t* tris, int64_t n_elems, int64_t n_nodes,
                      int64_t max_diags, int64_t* offsets,
                      int32_t* slot_ids) {
  const int64_t m = 9 * n_elems;
  // collect distinct offsets (bounded: typically < 32)
  int64_t n_diags = 0;
  int64_t local[512];
  for (int64_t i = 0; i < m; ++i) {
    int64_t r, c;
    pair_at(tris, i, &r, &c);
    int64_t off = c - r;
    int64_t* end = local + n_diags;
    int64_t* it = std::lower_bound(local, end, off);
    if (it == end || *it != off) {
      if (n_diags >= max_diags || n_diags >= 512) {
        // keep scanning to report the true count? not needed -- fail fast
        return -(n_diags + 1);
      }
      int64_t pos = it - local;
      for (int64_t j = n_diags; j > pos; --j) local[j] = local[j - 1];
      local[pos] = off;
      ++n_diags;
    }
  }
  for (int64_t d = 0; d < n_diags; ++d) offsets[d] = local[d];
  for (int64_t i = 0; i < m; ++i) {
    int64_t r, c;
    pair_at(tris, i, &r, &c);
    int64_t off = c - r;
    int64_t d = std::lower_bound(local, local + n_diags, off) - local;
    slot_ids[i] = (int32_t)(d * n_nodes + r);
  }
  return n_diags;
}

}  // extern "C"
