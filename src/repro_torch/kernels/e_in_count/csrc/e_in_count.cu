// Hopper (sm_90a) kernel for the port's in-degree count,
// build.compute_e_in (twin of src/repro/core/build.py: compute_e_in).
//
// out[v] = the number of slots of the flattened [N, R] neighbour table
// that hold v, for 0 <= v < n_max; -1 marks an empty slot. It replaces no
// TPU kernel: the reference computes it with one scatter-add,
// zeros(n_max).at[clip(flat, 0)].add(flat >= 0), which sends every empty
// slot to id 0 with an add of 0. XLA on a TPU does not pay for that; the
// port's first version, the same formula as one index_add_ (ref.py),
// does: every -1 lane becomes an atomic add on bin 0, one after another.
// The table is mostly -1 (the cells' 2^21 x 32 table holds 262,144 to
// ~800,000 rows of ids), so ~55-60M atomics serialise on one address,
// 30-45 ms a call at every insert chunk, repair, consolidation and merge.
// It exists to take them off the card. The output must equal the plain
// version exactly; integer adds commute, so it does in any order.
//
// Bound: memory. Per call it must read the table (N*R*4 bytes) and zero
// the output (n_max*4 bytes, the wrapper's torch.zeros), over 3.35 TB/s
// on an H100 SXM: 276 MB, ~82 us, at the cells' 2^21 x 32. The atomics
// are one per slot that holds an id, spread over all live ids (in-degree
// ~32 each), and the output stays in L2, so no address is hot.
//
// Design:
// - One grid-stride pass over the flattened table as 16-byte int4
//   vectors, kUnroll vectors loaded before any is counted, so a thread
//   has 64 bytes in flight; the ids before the first 16-byte boundary
//   and after the last whole vector (at most 3 each) go to the grid's
//   first threads as scalars.
// - A persistent grid of a few blocks an SM (the host, kernel.py's
//   launch_geometry, sizes it from the SM count).
// - An id v with 0 <= v < n_max is counted with atomicAdd(out + v, 1),
//   its result unused, so it compiles to a fire-and-forget RED. A -1
//   touches no memory; an id >= n_max is dropped, as the reference's
//   .at[].add drops an index out of bounds (no caller makes one).
// - It scans the whole table, not rows [0, n): reading n would need a
//   device read; the rows past n cost only their bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kUnroll = 4;     // 16-byte vectors a thread loads at once

__device__ __forceinline__ void count(int id, int32_t* out,
                                      unsigned n_max) {
  if ((unsigned)id < n_max) atomicAdd(out + id, 1);
}

__device__ __forceinline__ void count4(const int4& v, int32_t* out,
                                       unsigned n_max) {
  count(v.x, out, n_max);
  count(v.y, out, n_max);
  count(v.z, out, n_max);
  count(v.w, out, n_max);
}

// ids: the flattened table, `total` int32; `head` (0-3) ids before the
// first 16-byte boundary, then `nvec` int4 vectors, then the tail.
__global__ void __launch_bounds__(kThreads)
    e_in_count_kernel(const int32_t* __restrict__ ids, long long total,
                      int head, int32_t* __restrict__ out, unsigned n_max) {
  const long long nvec = (total - head) >> 2;
  const long long tail = head + nvec * 4;  // first id after the vectors
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the scalar ends: ids [0, head) and [tail, total)
  if (i < head + (total - tail))
    count(__ldg(ids + (i < head ? i : tail + (i - head))), out, n_max);
  const int4* __restrict__ body = reinterpret_cast<const int4*>(ids + head);
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(body + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count4(v[u], out, n_max);
  }
  for (; i < nvec; i += stride) count4(__ldg(body + i), out, n_max);
}

}  // namespace

// C interface, loaded with ctypes. ids: `total` int32 (the flattened
// table, 4-byte aligned, any 16-byte offset); out: n_max int32, zeroed by
// the caller on `stream`; `blocks` >= 1, chosen by kernel.py's
// launch_geometry. Returns the launch's cudaGetLastError(), 0 on success.
extern "C" int e_in_count_launch(const int32_t* ids, long long total,
                                 int32_t* out, long long n_max,
                                 long long blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(ids);
  if (total < 1 || n_max < 1 || n_max > 0x7fffffffLL || blocks < 1 ||
      blocks > 0x7fffffffLL || (a & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  long long head = (long long)(((16 - (a & 15)) & 15) >> 2);
  if (head > total) head = total;
  e_in_count_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      ids, total, (int)head, out, (unsigned)n_max);
  return (int)cudaGetLastError();
}

extern "C" const char* e_in_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
