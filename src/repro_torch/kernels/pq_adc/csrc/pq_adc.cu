// Hopper (sm_90a) port of the pq_adc TPU kernel
// (src/repro/kernels/pq_adc/kernel.py: pq_adc, body _kernel).
//
// out[b, c] = sum_s lut[b, s, codes[ids[b, c], s]] in fp32, and +inf where
// ids[b, c] < 0. The PQ lane's executor feeds it the (queries, pool) entry
// id matrix and every round's (queries, beam*degree) candidate matrix, so
// ids carry duplicates and -1 lanes (idle beam slots, pruned edges).
//
// Arithmetic: the sum runs over s = 0..m-1 in order, in fp32, as the
// plain version (ref.py) defines it. The Pallas body's one-hot MXU
// contraction is not copied: on Hopper a LUT lookup is a shared-memory
// load, and a one-hot product would spend m*K multiply-adds per candidate
// on zeros. A code at or above K reads LUT entry K-1 instead of leaving
// the query's table (codes from encode are always below K).
//
// Bound: memory. Per call it must read each distinct code row once (m
// bytes), the ids (B*C*4), each query's LUT once (B*m*K*4: 16 KiB at
// m=16, K=256) and write the output (B*C*4), over 3.35 TB/s on an H100
// SXM. The B*C*m adds are ~1000x below the card's fp32 rate. At the main
// path's round (B=1024, C=512) that is ~28 MB, ~8 us at full bandwidth;
// the LUT is 60% of it.
//
// The first design (a block of 256 threads per query) reached 47% of the
// bound on a round and 57% on the entry: 1,024 blocks are about one wave
// on 132 SMs, so nothing hid a block's three round trips in a row: stage
// the LUT, wait at the barrier, only then read the ids and behind them
// the code rows. At the entry's C=64, 192 of the 256 threads idled.
//
// Design: one block per query and chunk of candidates, as before, but
// - the three round trips overlap: each thread first reads the ids of
//   its kPer candidates, then starts its share of the LUT copy
//   asynchronously (cp.async, 16 bytes a copy, into shared memory without
//   a register hop), then, while the copy flies, reads the 16-byte code
//   rows behind its ids into registers; only then does the block wait for
//   the copy and meet at the barrier. (Reading the ids before starting
//   the copy puts the dependent code reads earlier; one TMA bulk copy of
//   the LUT behind an mbarrier timed slower than the cp.async copies.)
// - The block is sized to C (kernel.py, launch_geometry): 32..256
//   threads with one or two candidates each, so the entry's C=64 runs 64
//   threads and none idles.
// What is left: lookups read lut_s[s*K + code], and random codes meet
// bank conflicts (the bank is code mod 32), but a variant with
// conflict-free addresses timed no faster, and with the lookups removed
// the kernel is only a little faster: the rest is the LUT, id and code
// traffic of a single wave of blocks, and the launch.
// Code rows are read as one 16-byte vector when m=16 and the table is
// 16-byte aligned, byte by byte (after the barrier) otherwise; the LUT
// is copied synchronously when it is not a whole number of 16-byte
// vectors on 16-byte boundaries.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <bool kVec16, int kPer>
__global__ void __launch_bounds__(kMaxThreads)
    pq_adc_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ lut,
                  const int32_t* __restrict__ ids, float* __restrict__ out,
                  int C, long long N, int m, int K, int lut_async) {
  extern __shared__ __align__(16) float lut_s[];
  const long long b = blockIdx.x;
  const int n_lut = m * K;
  const float* lut_b = lut + b * n_lut;
  const int nt = blockDim.x;

  // 1. this thread's ids (first: the code rows wait on them)
  const int32_t* id_row = ids + b * C;
  const int c0 = blockIdx.y * nt * kPer + threadIdx.x;
  const int c_end = min((int)(blockIdx.y + 1) * nt * kPer, C);
  int id[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int c = c0 + p * nt;
    id[p] = c < c_end ? __ldg(id_row + c) : -1;
  }

  // 2. start the LUT copy
  if (lut_async) {
    for (int j = threadIdx.x; j < n_lut / 4; j += nt)
      cp_async16(lut_s + 4 * j, lut_b + 4 * j);
  }

  // 3. while it flies: the code rows behind the ids
  uint4 raw[kPer];
  if (kVec16) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      raw[p] = make_uint4(0u, 0u, 0u, 0u);
      if (id[p] >= 0)
        raw[p] = __ldg(reinterpret_cast<const uint4*>(
            codes + min((long long)id[p], N - 1) * 16));
    }
  }

  // 4. the LUT is in shared memory
  if (lut_async) {
    cp_async_wait_all();
  } else {
    for (int j = threadIdx.x; j < n_lut; j += nt) lut_s[j] = __ldg(lut_b + j);
  }
  __syncthreads();

  // 5. lookups, summed over s in order
  float* out_row = out + b * C;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int c = c0 + p * nt;
    if (c >= c_end) continue;
    if (id[p] < 0) {
      out_row[c] = INFINITY;
      continue;
    }
    float s = 0.f;
    if (kVec16) {
      const uint32_t w[4] = {raw[p].x, raw[p].y, raw[p].z, raw[p].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int code = (w[j >> 2] >> (8 * (j & 3))) & 0xff;
        s += lut_s[j * K + min(code, K - 1)];
      }
    } else {
      const uint8_t* row = codes + min((long long)id[p], N - 1) * m;
      for (int j = 0; j < m; ++j)
        s += lut_s[j * K + min((int)__ldg(row + j), K - 1)];
    }
    out_row[c] = s;
  }
}

template <bool kVec16, int kPer>
cudaError_t launch(const uint8_t* codes, const float* lut, const int32_t* ids,
                   float* out, int B, int C, long long N, int m, int K,
                   int threads, int lut_async, cudaStream_t s) {
  const size_t smem = (size_t)m * K * sizeof(float);
  if (smem > 48 * 1024) {  // above the static limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        pq_adc_kernel<kVec16, kPer>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int chunk = threads * kPer;
  const dim3 grid(B, (C + chunk - 1) / chunk);
  pq_adc_kernel<kVec16, kPer><<<grid, threads, smem, s>>>(
      codes, lut, ids, out, C, N, m, K, lut_async);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. vec16 != 0 only when m == 16 and the
// code table is 16-byte aligned; lut_async != 0 only when m*K is a
// multiple of 4 and the LUT is 16-byte aligned (the wrapper checks all
// of them). threads (a multiple of 32, at most 256) and per (1 or 2
// candidates a thread) come from kernel.py's launch_geometry. Returns
// the launch's cudaGetLastError(), 0 on success.
extern "C" int pq_adc_launch(const uint8_t* codes, const float* lut,
                             const int32_t* ids, float* out, int B, int C,
                             long long N, int m, int K, int vec16,
                             int lut_async, int threads, int per,
                             void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (per != 1 && per != 2) || (vec16 && m != 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec16)
    err = per == 1 ? launch<true, 1>(codes, lut, ids, out, B, C, N, m, K,
                                     threads, lut_async, s)
                   : launch<true, 2>(codes, lut, ids, out, B, C, N, m, K,
                                     threads, lut_async, s);
  else
    err = per == 1 ? launch<false, 1>(codes, lut, ids, out, B, C, N, m, K,
                                      threads, lut_async, s)
                   : launch<false, 2>(codes, lut, ids, out, B, C, N, m, K,
                                      threads, lut_async, s);
  return (int)err;
}

extern "C" const char* pq_adc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
