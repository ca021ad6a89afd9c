// The build's reverse-edge pass (core/build.py, _add_reverse_edges) as one
// host loop: for each edge u -> v of the first n rows, add v -> u unless row
// v holds u already; into v's first free (negative) slot, or, with no free
// slot, with probability 1/2 over a slot drawn uniformly.
//
// It draws from the caller's numpy generator through its bit generator's own
// function pointers, in the Python loop's order: next_double is
// Generator.random(), and bounded() is Generator.integers(R). So the table,
// and the generator's state afterwards, are what the Python loop leaves,
// buffered half-words of a 64-bit generator included. The caller holds the
// bit generator's lock and checks the table (C-contiguous int32, n <= rows).
#include <cstdint>

typedef double (*next_double_fn)(void *);
typedef uint32_t (*next_uint32_fn)(void *);

namespace {

// Generator.integers(R) for 1 < R < 2^32: numpy's Lemire draw over 32-bit
// words (distributions.c, buffered_bounded_lemire_uint32), with the range
// R - 1 and its rejection threshold (2^32 - R) % R. For R == 1 numpy draws
// nothing and returns 0.
inline uint32_t bounded(void *state, next_uint32_fn next_uint32, uint32_t R) {
  if (R == 1) return 0;
  uint64_t m = (uint64_t)next_uint32(state) * R;
  uint32_t leftover = (uint32_t)m;
  if (leftover < R) {
    const uint32_t threshold = (uint32_t)(0u - R) % R;
    while (leftover < threshold) {
      m = (uint64_t)next_uint32(state) * R;
      leftover = (uint32_t)m;
    }
  }
  return (uint32_t)(m >> 32);
}

}  // namespace

// nbrs: [rows, R] int32, row-major; the first n rows hold the edges. Returns
// -1, or the flat index of the first id that lies past the table's rows
// (the pass stops there; the rows before it are done).
extern "C" int64_t reverse_edges(int32_t *nbrs, int64_t rows, int64_t n,
                                 int64_t R, void *state,
                                 next_double_fn next_double,
                                 next_uint32_fn next_uint32) {
  for (int64_t u = 0; u < n; ++u) {
    const int32_t uid = (int32_t)u;
    for (int64_t j = 0; j < R; ++j) {
      const int64_t v = nbrs[u * R + j];
      if (v < 0) continue;
      if (v >= rows) return u * R + j;
      int32_t *row = nbrs + v * R;
      int64_t free = -1;
      bool has_u = false;
      for (int64_t s = 0; s < R; ++s) {
        if (row[s] == uid) { has_u = true; break; }
        if (free < 0 && row[s] < 0) free = s;
      }
      if (has_u) continue;
      if (free >= 0) {
        row[free] = uid;
      } else if (next_double(state) < 0.5) {
        row[bounded(state, next_uint32, (uint32_t)R)] = uid;
      }
    }
  }
  return -1;
}
