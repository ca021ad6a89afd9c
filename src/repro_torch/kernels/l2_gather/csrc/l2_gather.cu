// Hopper (sm_90a) port of the l2_gather TPU kernel
// (src/repro/kernels/l2_gather/kernel.py: l2_gather, body _kernel).
//
// out[b, k] = sum_d (table[ids[b, k], d] - queries[b, d])^2 in fp32, and
// +inf where ids[b, k] < 0. The frontier executor feeds it the whole
// (queries, beam*degree) id matrix of one expansion round, so ids carry
// duplicates and -1 lanes (idle beam slots, pruned edges).
//
// Arithmetic: subtract, then square, as the plain version (ref.py) does
// and as the reference serves (ops.gather_l2 defaults to the jnp ref).
// The Pallas body's ||x||^2 - 2 x.q + ||q||^2 form is not used: it is
// exact only on integer data and cancels badly when x is close to q,
// which is exactly where the search ranks its best candidates. bf16
// tables are upcast on load and the difference is taken in fp32 (the
// plain version subtracts in bf16; both round within the 2e-2 tolerance).
//
// Bound: memory. Per call it must move the gathered rows (at most
// B*K*D*4 bytes, fewer where ids repeat), B*K*4 bytes of ids and B*K*4
// bytes of output, over 3.35 TB/s on an H100 SXM; the 3*B*K*D fp32
// operations are ~1000x below the card's rate. At the main path's
// B=1024, K=512, D=96 that is ~0.2 GB, ~60 us at full bandwidth.
//
// Design: one block covers one query and a chunk of kChunk candidates and
// holds the query row in shared memory. Each warp takes one candidate at
// a time: the id is read once (broadcast to the warp), an invalid lane
// writes +inf without touching the table, a valid id is clipped to the
// table and its row is read in 16-byte vectors (float4, or 8 bf16) when
// the row length allows it, element by element otherwise. Lanes sum
// their share in fp32 and the warp reduces with shuffles. The random row
// gather is the whole cost; no staging (TMA, cp.async rings) yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;  // candidates per block

// Squared distance of one 16-byte vector of row elements against the
// matching query slice (query in shared memory, fp32).
__device__ __forceinline__ float vec_sq(const float* row, const float* q,
                                        int j) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(row) + j);
  const float4 y = reinterpret_cast<const float4*>(q)[j];
  const float a = x.x - y.x, b = x.y - y.y, c = x.z - y.z, d = x.w - y.w;
  return a * a + b * b + c * c + d * d;
}

__device__ __forceinline__ float vec_sq(const __nv_bfloat16* row,
                                        const float* q, int j) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + j);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float* y = q + 8 * j;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    const float a = x.x - y[2 * i], b = x.y - y[2 * i + 1];
    s += a * a + b * b;
  }
  return s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    l2_gather_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ ids,
                     const float* __restrict__ queries,
                     float* __restrict__ out, int K, long long N, int D,
                     int vec) {
  extern __shared__ float q_s[];
  const long long b = blockIdx.x;
  const float* q = queries + b * D;
  for (int j = threadIdx.x; j < D; j += kThreads) q_s[j] = q[j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c_end = min((int)(blockIdx.y + 1) * kChunk, K);
  const int32_t* id_row = ids + b * K;
  float* out_row = out + b * K;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector

  for (int c = blockIdx.y * kChunk + warp; c < c_end; c += kWarps) {
    const int id = id_row[c];
    if (id < 0) {  // warp-uniform: the whole warp skips the row
      if (lane == 0) out_row[c] = INFINITY;
      continue;
    }
    const T* row = table + min((long long)id, N - 1) * D;
    float s = 0.f;
    if (vec) {
      for (int j = lane; j < D / V; j += 32) s += vec_sq(row, q_s, j);
    } else {
      for (int j = lane; j < D; j += 32) {
        const float d = to_f32(row[j]) - q_s[j];
        s += d * d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out_row[c] = s;
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = fp32 table, 1 = bf16 table.
// vec != 0 only when D is a multiple of the 16-byte vector width and the
// table is 16-byte aligned (the wrapper checks both). Returns
// cudaGetLastError() after the launch, 0 on success.
extern "C" int l2_gather_launch(const void* table, int dtype,
                                const int32_t* ids, const float* queries,
                                float* out, int B, int K, long long N, int D,
                                int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (K + kChunk - 1) / kChunk);
  const size_t smem = (size_t)D * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    l2_gather_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(table), ids, queries, out, K, N, D, vec);
  } else if (dtype == 1) {
    l2_gather_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(table), ids, queries, out, K, N,
        D, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* l2_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
