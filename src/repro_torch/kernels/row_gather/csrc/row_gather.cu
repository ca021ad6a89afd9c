// Hopper (sm_90a) port of the row_gather TPU kernel
// (src/repro/kernels/row_gather/kernel.py: row_gather, body _kernel).
//
// out[b, w, :] = table[h2s[ids[b, w]], :], and the whole row is -1 where
// ids[b, w] < 0 or h2s[ids[b, w]] < 0. This is the fused PQ loop's
// topology read: the frontier ids of one round resolve through the
// device-resident topology cache (directory h2s, then the cached
// adjacency rows). The -1 sentinel is load-bearing: downstream it marks
// invalid candidates, and the loop's stall test tells "not resident"
// (id >= 0, slot < 0) from "idle lane" (id < 0). The output must equal
// the plain version (ref.py) exactly.
//
// Bound: memory. Per call it must read the ids (B*W*4 bytes), one
// directory entry per live id (4 bytes), one cached row per resident id
// (R*4 bytes) and write the output (B*W*R*4 bytes), over 3.35 TB/s on an
// H100 SXM. There is no arithmetic. At the main path's round (B=1024,
// W=16, R=32) that is ~4 MB, ~1.3 us at full bandwidth: launch latency
// dominates.
//
// Design: one warp per (b, w) lane. Lane 0 of the warp reads the id and,
// for a live id, the directory entry at the id clipped to the directory;
// the slot is broadcast with __shfl_sync. The warp then copies the R-int
// row with coalesced loads (R=32 is one load per thread), the slot
// clipped to the table, or writes -1 across the row. The TPU body's
// chained per-lane DMAs become one dependent load pair per warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // lanes per block

__global__ void __launch_bounds__(kWarps * 32)
    row_gather_kernel(const int32_t* __restrict__ table,
                      const int32_t* __restrict__ h2s,
                      const int32_t* __restrict__ ids,
                      int32_t* __restrict__ out, long long lanes,
                      long long S, long long N, int R) {
  const long long lane_id =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (lane_id >= lanes) return;  // warp-uniform
  const int t = threadIdx.x & 31;
  int slot = -1;
  if (t == 0) {
    const int id = __ldg(ids + lane_id);
    if (id >= 0) slot = __ldg(h2s + min((long long)id, N - 1));
  }
  slot = __shfl_sync(0xffffffffu, slot, 0);
  int32_t* dst = out + lane_id * R;
  if (slot < 0) {
    for (int j = t; j < R; j += 32) dst[j] = -1;
    return;
  }
  const int32_t* src = table + min((long long)slot, S - 1) * R;
  for (int j = t; j < R; j += 32) dst[j] = __ldg(src + j);
}

}  // namespace

// C interface, loaded with ctypes. lanes = B*W. Returns the launch's
// cudaGetLastError(), 0 on success.
extern "C" int row_gather_launch(const int32_t* table, const int32_t* h2s,
                                 const int32_t* ids, int32_t* out,
                                 long long lanes, long long S, long long N,
                                 int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (lanes + kWarps - 1) / kWarps;
  row_gather_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(table, h2s, ids,
                                                           out, lanes, S, N,
                                                           R);
  return (int)cudaGetLastError();
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
