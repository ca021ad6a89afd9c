// Hopper (sm_90a) port of the topk_merge TPU kernel
// (src/repro/kernels/topk_merge/kernel.py: topk_merge, bitonic network
// _bitonic, body _kernel).
//
// Merges a candidate pool (d, id, visited) [B, L] with new candidates
// (d, id) [B, R] and keeps the best L per row, exactly as the plain
// version (ref.py, the reference's stable lexsort) orders them: by
// distance, then id, then original lane ([pool | new]), so a full tie
// on (d, id) keeps the earlier lane first. New lanes carry visited=0.
// The lane vector is padded to P = next_pow2(L+R) and padding sorts
// after every real lane, whatever its distance. The TPU kernel pads
// with (+inf, -1) and orders by (d, id) alone: its pads outrank a real
// (+inf, id >= 0) lane and its unstable network leaves `visited` order-
// dependent on full ties. This kernel does neither.
//
// Order key: one 64-bit word per lane, (ordered bits of d) << 32 |
// (id ^ 0x80000000), compared with the lane index as a final tiebreak,
// so every key is distinct and the sort result is unique. -0.0 orders
// as +0.0 and NaN after +inf, as the plain version's sort orders them.
// Padding takes the key ~0, which no real lane reaches (the largest
// real key is that of NaN, 0xffc00000 in its top word).
//
// Bound: memory. Per row it must read the pool (L*9 bytes) and the new
// candidates (R*8 bytes) and write L*9 bytes; the network does
// P*log2(P)*(log2(P)+1)/4 compare-exchanges per row. At the executor's
// merge shape (B=1024, L=64, R=512, P=1024) that is ~5.4 MB (1.6 us at
// 3.35 TB/s) against 28.8M compare-exchanges (0.43 us at 67 TOP/s).
//
// Design: one block per row, P/E threads, each holding E = max(1,
// P/1024) lanes in registers at positions j = e*(P/E) + thread. A
// compare-exchange partner j ^ stride is then in the same thread for
// stride >= P/E (a register swap), in the same warp for stride < 32
// (__shfl_xor_sync of key and lane) and otherwise in another warp
// (through shared memory, 12 bytes per lane, with __syncthreads on
// either side). Only (key, lane) move through the network; the first L
// threads' lanes then gather d, id and visited from the inputs, so the
// outputs are the inputs' own bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t make_key(float d, int32_t id) {
  uint32_t u = __float_as_uint(d);
  if (isnan(d)) u = 0x7fc00000u;     // one NaN, after +inf
  if ((u << 1) == 0) u = 0;          // -0.0 orders as +0.0
  const uint32_t dk = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)dk << 32) | (uint32_t)(id ^ (int32_t)0x80000000);
}

__device__ __forceinline__ bool less(uint64_t ka, uint32_t la, uint64_t kb,
                                     uint32_t lb) {
  return ka < kb || (ka == kb && la < lb);
}

template <int E>
__global__ void __launch_bounds__(1024)
    topk_merge_kernel(const float* __restrict__ pool_d,
                      const int32_t* __restrict__ pool_i,
                      const uint8_t* __restrict__ pool_v,
                      const float* __restrict__ new_d,
                      const int32_t* __restrict__ new_i,
                      float* __restrict__ out_d, int32_t* __restrict__ out_i,
                      uint8_t* __restrict__ out_v, int L, int R, int P) {
  extern __shared__ unsigned char smem[];
  uint64_t* sk = reinterpret_cast<uint64_t*>(smem);
  uint32_t* sl = reinterpret_cast<uint32_t*>(sk + P);
  const int NT = blockDim.x;  // P / E
  const int t = threadIdx.x;
  const long long b = blockIdx.x;
  const int T = L + R;
  uint64_t k[E];
  uint32_t ln[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = e * NT + t;
    ln[e] = j;
    if (j < L)
      k[e] = make_key(__ldg(pool_d + b * L + j), __ldg(pool_i + b * L + j));
    else if (j < T)
      k[e] = make_key(__ldg(new_d + b * R + (j - L)),
                      __ldg(new_i + b * R + (j - L)));
    else
      k[e] = ~0ull;  // padding: after every real lane
  }
  const unsigned mask = NT >= 32 ? 0xffffffffu : ((1u << NT) - 1u);
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= NT) {  // partner lane held by this thread
        const int es = stride / NT;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int pe = e ^ es;
          if (pe < e) continue;  // each pair once, from its lower lane
          const bool asc = ((e * NT + t) & size) == 0;
          const bool swap = asc ? less(k[pe], ln[pe], k[e], ln[e])
                                : less(k[e], ln[e], k[pe], ln[pe]);
          if (swap) {
            const uint64_t tk = k[e];
            const uint32_t tl = ln[e];
            k[e] = k[pe];
            ln[e] = ln[pe];
            k[pe] = tk;
            ln[pe] = tl;
          }
        }
        continue;
      }
      uint64_t pk[E];
      uint32_t pl[E];
      if (stride >= 32) {  // partner in another warp
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sk[e * NT + t] = k[e];
          sl[e * NT + t] = ln[e];
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = (e * NT + t) ^ stride;
          pk[e] = sk[p];
          pl[e] = sl[p];
        }
      } else {  // partner in this warp
#pragma unroll
        for (int e = 0; e < E; ++e) {
          pk[e] = __shfl_xor_sync(mask, k[e], stride);
          pl[e] = __shfl_xor_sync(mask, ln[e], stride);
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = e * NT + t;
        const bool asc = (j & size) == 0;
        const bool lower = (j & stride) == 0;
        const bool self_less = less(k[e], ln[e], pk[e], pl[e]);
        if ((lower == asc) != self_less) {  // keep the partner's lane
          k[e] = pk[e];
          ln[e] = pl[e];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = e * NT + t;
    if (j >= L) continue;
    const int lane = (int)ln[e];
    float d = INFINITY;
    int32_t id = -1;
    uint8_t v = 0;
    if (lane < L) {
      d = __ldg(pool_d + b * L + lane);
      id = __ldg(pool_i + b * L + lane);
      v = __ldg(pool_v + b * L + lane) != 0;
    } else if (lane < T) {
      d = __ldg(new_d + b * R + (lane - L));
      id = __ldg(new_i + b * R + (lane - L));
    }
    out_d[b * L + j] = d;
    out_i[b * L + j] = id;
    out_v[b * L + j] = v;
  }
}

template <int E>
cudaError_t launch(const float* pool_d, const int32_t* pool_i,
                   const uint8_t* pool_v, const float* new_d,
                   const int32_t* new_i, float* out_d, int32_t* out_i,
                   uint8_t* out_v, int B, int L, int R, int P,
                   cudaStream_t s) {
  const size_t smem = (size_t)P * (sizeof(uint64_t) + sizeof(uint32_t));
  if (smem > 48 * 1024) {  // above the static limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        topk_merge_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  topk_merge_kernel<E><<<B, P / E, smem, s>>>(pool_d, pool_i, pool_v, new_d,
                                              new_i, out_d, out_i, out_v, L,
                                              R, P);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. P is next_pow2(L + R), at most 16384
// (the wrapper checks). Returns the launch's cudaGetLastError(), 0 on
// success.
extern "C" int topk_merge_launch(const float* pool_d, const int32_t* pool_i,
                                 const uint8_t* pool_v, const float* new_d,
                                 const int32_t* new_i, float* out_d,
                                 int32_t* out_i, uint8_t* out_v, int B, int L,
                                 int R, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = P > 1024 ? P / 1024 : 1;
  switch (E) {
    case 1:
      err = launch<1>(pool_d, pool_i, pool_v, new_d, new_i, out_d, out_i,
                      out_v, B, L, R, P, s);
      break;
    case 2:
      err = launch<2>(pool_d, pool_i, pool_v, new_d, new_i, out_d, out_i,
                      out_v, B, L, R, P, s);
      break;
    case 4:
      err = launch<4>(pool_d, pool_i, pool_v, new_d, new_i, out_d, out_i,
                      out_v, B, L, R, P, s);
      break;
    case 8:
      err = launch<8>(pool_d, pool_i, pool_v, new_d, new_i, out_d, out_i,
                      out_v, B, L, R, P, s);
      break;
    case 16:
      err = launch<16>(pool_d, pool_i, pool_v, new_d, new_i, out_d, out_i,
                       out_v, B, L, R, P, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* topk_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
