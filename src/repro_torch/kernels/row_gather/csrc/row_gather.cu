// Hopper (sm_90a) port of the row_gather TPU kernel
// (src/repro/kernels/row_gather/kernel.py: row_gather, body _kernel).
//
// out[b, w, :] = table[h2s[ids[b, w]], :], and the whole row is -1 where
// ids[b, w] < 0 or h2s[ids[b, w]] < 0. This is the fused PQ loop's
// topology read: the frontier ids of one round resolve through the
// device-resident topology cache (directory h2s, then the cached
// adjacency rows). The -1 sentinel is load-bearing: downstream it marks
// invalid candidates, and the loop's stall test tells "not resident"
// (id >= 0, slot < 0) from "idle lane" (id < 0). Ids clip to the
// directory and slots to the table before each read. The output must
// equal the plain version (ref.py) exactly.
//
// Bound: memory. Per call it must read the ids (B*W*4 bytes), one
// directory entry per live id (4 bytes), one cached row per resident id
// (R*4 bytes) and write the output (B*W*R*4 bytes), over 3.35 TB/s on an
// H100 SXM. There is no arithmetic. At the main path's round (B=1024,
// W=16, R=32) that is ~4 MB, ~1.3 us at full bandwidth, below the time
// the card takes to launch and retire a grid; what a kernel can reach
// is three dependent memory latencies (id, directory, row) in one wave.
//
// The first design (kept below as the "lanes" path) ran one warp per
// (b, w) lane: lane 0 alone made two dependent 4-byte loads (id, then
// directory), and the warp then copied the row with 4-byte loads. At the
// main shape that is 16,384 warps in two waves, each with one row in
// flight behind two dependent latencies: 7.1-7.7 us on an H100 80GB HBM3
// at 700 W, 12% of the bound. This design takes 6.4-6.7 us there, of
// which ~5 us is what the same timing gives a near-empty launch.
//
// Design ("tiles" path: R a multiple of 4 and at most 128, table and
// output 16-byte aligned):
// - A warp serves 32 consecutive lanes. It reads their 32 ids in one
//   coalesced load, and each thread resolves its own id's directory slot,
//   so 32 directory reads are in flight at once.
// - Slots are handed out by shuffle to groups of G threads, G the power
//   of two at or above R/4: a group copies one row as 16-byte vectors, so
//   a warp moves 32/G rows a step (4 rows of 8 threads at R = 32).
// - kInFlight steps of row loads are started before any store (all 32
//   rows at R = 32); stores are 16-byte, and -1 rows are written the
//   same way.
// - kTileWarps warps a block: the main shape's 512 warps make 256
//   blocks, one wave spread over the 132 SMs.
// The host (kernel.py, launch_geometry) chooses the path, G and the
// grid; this file only checks and launches them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneWarps = 8;  // lanes path: lanes (one warp each) a block
constexpr int kTileWarps = 2;  // tiles path: 32-lane tiles (warps) a block
constexpr int kInFlight = 8;   // tiles path: row vectors loaded before storing

// ---------------------------------------------------------------------
// tiles path
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(kTileWarps * 32)
    row_gather_tiles(const int4* __restrict__ table,
                     const int32_t* __restrict__ h2s,
                     const int32_t* __restrict__ ids, int4* __restrict__ out,
                     long long lanes, long long S, long long N, int nvec,
                     int log2g) {
  const int t = threadIdx.x & 31;
  const long long base =
      ((long long)blockIdx.x * kTileWarps + (threadIdx.x >> 5)) * 32;
  if (base >= lanes) return;  // whole warp
  // this thread's lane: its id, then its directory slot (-1: idle lane,
  // non-resident id, or past the last lane)
  int slot = -1;
  if (base + t < lanes) {
    const int id = __ldg(ids + base + t);
    if (id >= 0) slot = __ldg(h2s + min((long long)id, N - 1));
  }
  const int G = 1 << log2g;           // threads per row
  const int per_step = 32 >> log2g;   // rows per step; G steps cover 32
  const int grp = t >> log2g, sub = t & (G - 1);
  for (int s0 = 0; s0 < G; s0 += kInFlight) {
    int4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = (s0 + u) * per_step + grp;  // row of the tile
      const int sl = __shfl_sync(kFull, slot, r & 31);
      v[u] = make_int4(-1, -1, -1, -1);
      if (s0 + u < G && sub < nvec && sl >= 0)
        v[u] = __ldg(table + min((long long)sl, S - 1) * nvec + sub);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = (s0 + u) * per_step + grp;
      if (s0 + u < G && sub < nvec && base + r < lanes)
        out[(base + r) * nvec + sub] = v[u];
    }
  }
}

// ---------------------------------------------------------------------
// lanes path (any R, any alignment): the first design
// ---------------------------------------------------------------------
//
// One warp per (b, w) lane. Lane 0 of the warp reads the id and, for a
// live id, the directory entry at the id clipped to the directory; the
// slot is broadcast with __shfl_sync. The warp then copies the R-int row
// with coalesced loads, the slot clipped to the table, or writes -1
// across the row.
__global__ void __launch_bounds__(kLaneWarps * 32)
    row_gather_kernel(const int32_t* __restrict__ table,
                      const int32_t* __restrict__ h2s,
                      const int32_t* __restrict__ ids,
                      int32_t* __restrict__ out, long long lanes,
                      long long S, long long N, int R) {
  const long long lane_id =
      (long long)blockIdx.x * kLaneWarps + (threadIdx.x >> 5);
  if (lane_id >= lanes) return;  // warp-uniform
  const int t = threadIdx.x & 31;
  int slot = -1;
  if (t == 0) {
    const int id = __ldg(ids + lane_id);
    if (id >= 0) slot = __ldg(h2s + min((long long)id, N - 1));
  }
  slot = __shfl_sync(kFull, slot, 0);
  int32_t* dst = out + lane_id * R;
  if (slot < 0) {
    for (int j = t; j < R; j += 32) dst[j] = -1;
    return;
  }
  const int32_t* src = table + min((long long)slot, S - 1) * R;
  for (int j = t; j < R; j += 32) dst[j] = __ldg(src + j);
}

}  // namespace

// C interface, loaded with ctypes. lanes = B*W. path 0 = lanes path,
// `blocks` = ceil(lanes / 8). path 1 = tiles path: R a multiple of 4 and
// at most 128, table and out 16-byte aligned, groups of 1 << log2g
// threads with 1 << log2g the power of two at or above R/4, `blocks` =
// ceil(ceil(lanes / 32) / 2). kernel.py's launch_geometry chooses them;
// they are checked here. Returns the launch's cudaGetLastError(), 0 on
// success.
extern "C" int row_gather_launch(const int32_t* table, const int32_t* h2s,
                                 const int32_t* ids, int32_t* out,
                                 long long lanes, long long S, long long N,
                                 int R, int path, int log2g, long long blocks,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || S < 1 || N < 1 || R < 1) return (int)cudaErrorInvalidValue;
  if (path == 1) {
    const int nvec = R / 4;
    const bool aligned = ((reinterpret_cast<uintptr_t>(table) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (R % 4 != 0 || R > 128 || !aligned || log2g < 0 || log2g > 5 ||
        (1 << log2g) < nvec || (log2g > 0 && (1 << (log2g - 1)) >= nvec) ||
        blocks != ((lanes + 31) / 32 + kTileWarps - 1) / kTileWarps ||
        blocks > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    row_gather_tiles<<<(unsigned)blocks, kTileWarps * 32, 0, s>>>(
        reinterpret_cast<const int4*>(table), h2s, ids,
        reinterpret_cast<int4*>(out), lanes, S, N, nvec, log2g);
    return (int)cudaGetLastError();
  }
  if (path != 0 || blocks != (lanes + kLaneWarps - 1) / kLaneWarps ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  row_gather_kernel<<<(unsigned)blocks, kLaneWarps * 32, 0, s>>>(
      table, h2s, ids, out, lanes, S, N, R);
  return (int)cudaGetLastError();
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
