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
// on zeros.
//
// Bound: memory. Per call it must read each distinct code row once (m
// bytes), the ids (B*C*4), each query's LUT once (B*m*K*4: 16 KiB at
// m=16, K=256) and write the output (B*C*4), over 3.35 TB/s on an H100
// SXM. The B*C*m adds are ~1000x below the card's fp32 rate. At the main
// path's round (B=1024, C=512) that is ~28 MB, ~8 us at full bandwidth;
// the LUT is 60% of it.
//
// Design: one block covers one query and a chunk of kChunk candidates (a
// whole round of one query at beam 16 x degree 32), so a query's LUT is
// staged into shared memory once per round (float4 loads when its length
// allows). Then one thread per candidate: the id is clipped to the table
// before the row is read, a -1 lane writes +inf without touching the
// codes, and the m-byte code row is read as one 16-byte vector when m=16
// (rows are then 16-byte aligned if the table is), byte by byte otherwise.
// A code at or above K reads LUT entry K-1 instead of leaving the
// query's table (codes from encode are always below K).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;  // candidates per block

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
    pq_adc_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ lut,
                  const int32_t* __restrict__ ids, float* __restrict__ out,
                  int C, long long N, int m, int K) {
  extern __shared__ float lut_s[];
  const long long b = blockIdx.x;
  const int n_lut = m * K;
  const float* lut_b = lut + b * n_lut;
  if ((n_lut & 3) == 0 && (reinterpret_cast<uintptr_t>(lut_b) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(lut_b);
    float4* dst = reinterpret_cast<float4*>(lut_s);
    for (int j = threadIdx.x; j < n_lut / 4; j += kThreads)
      dst[j] = __ldg(src + j);
  } else {
    for (int j = threadIdx.x; j < n_lut; j += kThreads)
      lut_s[j] = __ldg(lut_b + j);
  }
  __syncthreads();

  const int32_t* id_row = ids + b * C;
  float* out_row = out + b * C;
  const int c_end = min((int)(blockIdx.y + 1) * kChunk, C);
  for (int c = blockIdx.y * kChunk + threadIdx.x; c < c_end; c += kThreads) {
    const int id = __ldg(id_row + c);
    if (id < 0) {
      out_row[c] = INFINITY;
      continue;
    }
    const uint8_t* row = codes + min((long long)id, N - 1) * m;
    float s = 0.f;
    if (kVec16) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int code = (w[j >> 2] >> (8 * (j & 3))) & 0xff;
        s += lut_s[j * K + min(code, K - 1)];
      }
    } else {
      for (int j = 0; j < m; ++j)
        s += lut_s[j * K + min((int)__ldg(row + j), K - 1)];
    }
    out_row[c] = s;
  }
}

template <bool kVec16>
cudaError_t launch(const uint8_t* codes, const float* lut, const int32_t* ids,
                   float* out, int B, int C, long long N, int m, int K,
                   cudaStream_t s) {
  const size_t smem = (size_t)m * K * sizeof(float);
  if (smem > 48 * 1024) {  // above the static limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        pq_adc_kernel<kVec16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, (C + kChunk - 1) / kChunk);
  pq_adc_kernel<kVec16><<<grid, kThreads, smem, s>>>(codes, lut, ids, out, C,
                                                     N, m, K);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. vec16 != 0 only when m == 16 and the
// code table is 16-byte aligned (the wrapper checks both). Returns the
// launch's cudaGetLastError(), 0 on success.
extern "C" int pq_adc_launch(const uint8_t* codes, const float* lut,
                             const int32_t* ids, float* out, int B, int C,
                             long long N, int m, int K, int vec16, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = vec16 ? launch<true>(codes, lut, ids, out, B, C, N, m, K, s)
              : launch<false>(codes, lut, ids, out, B, C, N, m, K, s);
  return (int)err;
}

extern "C" const char* pq_adc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
