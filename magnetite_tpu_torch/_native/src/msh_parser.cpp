// Fast MSH 4.1 ASCII parser (native host runtime).
//
// The reference parses .msh files with a per-line Rust state machine
// (reference: src/mesher.rs:536-704). At 1M-element scale a Python line
// loop takes seconds; this parser walks the buffer once with strtod/strtol.
//
// Two-pass C API (caller allocates):
//   msh_count(text, len, &n_nodes, &n_tris, &max_tag) -> 0 on success
//   msh_fill(text, len, coords[2*max_tag], tags[n_nodes], tris[3*n_tris])
//     coords are written at slot (tag-1); tags records which slots are live.
// Only entityDim==2, elementType==2 (3-node triangle) element blocks are
// kept; other sections are skipped wholesale.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Cursor {
  const char* p;
  const char* end;

  bool at_end() const { return p >= end; }

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
  }

  // advance to the start of the next line
  void next_line() {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }

  long read_long() {
    skip_ws();
    char* out = nullptr;
    long v = strtol(p, &out, 10);
    p = out;
    return v;
  }

  double read_double() {
    skip_ws();
    char* out = nullptr;
    double v = strtod(p, &out);
    p = out;
    return v;
  }

  bool line_starts_with(const char* prefix) {
    size_t n = strlen(prefix);
    return (size_t)(end - p) >= n && memcmp(p, prefix, n) == 0;
  }

  // skip until the line "$End<section>"
  void skip_section() {
    while (p < end) {
      next_line();
      if (p < end && *p == '$' && line_starts_with("$End")) {
        next_line();
        return;
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success; negative error codes otherwise.
int msh_count(const char* text, int64_t len, int64_t* n_nodes,
              int64_t* n_tris, int64_t* max_tag) {
  Cursor c{text, text + len};
  *n_nodes = 0;
  *n_tris = 0;
  *max_tag = 0;
  bool saw_nodes = false, saw_elements = false;

  while (!c.at_end()) {
    c.skip_ws();
    if (c.at_end()) break;
    if (*c.p != '$') {
      c.next_line();
      continue;
    }
    if (c.line_starts_with("$Nodes")) {
      saw_nodes = true;
      c.next_line();
      long num_blocks = c.read_long();
      (void)c.read_long();  // numNodes
      (void)c.read_long();  // minTag
      long mx = c.read_long();
      *max_tag = mx;
      c.next_line();
      for (long b = 0; b < num_blocks; ++b) {
        (void)c.read_long();  // dim
        (void)c.read_long();  // entity tag
        (void)c.read_long();  // parametric
        long block_n = c.read_long();
        c.next_line();
        *n_nodes += block_n;
        for (long i = 0; i < 2 * block_n; ++i) c.next_line();
      }
    } else if (c.line_starts_with("$Elements")) {
      saw_elements = true;
      c.next_line();
      long num_blocks = c.read_long();
      c.next_line();
      for (long b = 0; b < num_blocks; ++b) {
        long dim = c.read_long();
        (void)c.read_long();
        long etype = c.read_long();
        long block_n = c.read_long();
        c.next_line();
        if (dim == 2) {
          if (etype != 2) return -3;  // unsupported 2D element type
          *n_tris += block_n;
        }
        for (long i = 0; i < block_n; ++i) c.next_line();
      }
    } else if (c.line_starts_with("$End")) {
      c.next_line();
    } else {
      c.skip_section();
      continue;
    }
  }
  if (!saw_nodes) return -1;
  if (!saw_elements) return -2;
  return 0;
}

int msh_fill(const char* text, int64_t len, double* coords, int64_t* tags,
             int64_t max_tag, int32_t* tris) {
  Cursor c{text, text + len};
  int64_t node_i = 0, tri_i = 0;

  while (!c.at_end()) {
    c.skip_ws();
    if (c.at_end()) break;
    if (*c.p != '$') {
      c.next_line();
      continue;
    }
    if (c.line_starts_with("$Nodes")) {
      c.next_line();
      long num_blocks = c.read_long();
      c.next_line();
      for (long b = 0; b < num_blocks; ++b) {
        (void)c.read_long();
        (void)c.read_long();
        (void)c.read_long();
        long block_n = c.read_long();
        c.next_line();
        int64_t tag_start = node_i;
        for (long i = 0; i < block_n; ++i) {
          long tag = c.read_long();
          if (tag < 1 || tag > max_tag) return -4;
          tags[node_i + i] = tag;
          c.next_line();
        }
        for (long i = 0; i < block_n; ++i) {
          double x = c.read_double();
          double y = c.read_double();
          (void)c.read_double();  // z
          int64_t tag = tags[tag_start + i];
          coords[2 * (tag - 1)] = x;
          coords[2 * (tag - 1) + 1] = y;
          c.next_line();
        }
        node_i += block_n;
      }
    } else if (c.line_starts_with("$Elements")) {
      c.next_line();
      long num_blocks = c.read_long();
      c.next_line();
      for (long b = 0; b < num_blocks; ++b) {
        long dim = c.read_long();
        (void)c.read_long();
        (void)c.read_long();
        long block_n = c.read_long();
        c.next_line();
        for (long i = 0; i < block_n; ++i) {
          if (dim == 2) {
            (void)c.read_long();  // element tag
            tris[3 * tri_i] = (int32_t)(c.read_long() - 1);
            tris[3 * tri_i + 1] = (int32_t)(c.read_long() - 1);
            tris[3 * tri_i + 2] = (int32_t)(c.read_long() - 1);
            ++tri_i;
          }
          c.next_line();
        }
      }
    } else if (c.line_starts_with("$End")) {
      c.next_line();
    } else {
      c.skip_section();
      continue;
    }
  }
  return 0;
}

}  // extern "C"
