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
// Sums inside a row run in another order than the plain version's; on
// integer-valued data every order gives the same bits.
//
// Bound: memory. Per call it must move the gathered rows (at most
// B*K*D*4 bytes, fewer where ids repeat), B*K*4 bytes of ids and B*K*4
// bytes of output, over 3.35 TB/s on an H100 SXM; the 3*B*K*D fp32
// operations are ~1000x below the card's rate. At the main path's
// B=1024, K=512, D=96 that is ~0.13 GB of distinct rows, 40 us at full
// bandwidth. Every row is a random 384-byte read behind a dependent id
// read, so what sets the rate is how many row bytes are in flight.
//
// The first design (a warp per candidate, query staged in shared memory
// behind a barrier, 64 candidates per block) reached 44% of the bound:
// at D=96 a row is 24 float4, so 8 of 32 lanes idled on every row, each
// warp held one row in flight, and it read the next id only after the
// reduction and the store.
//
// Design ("groups" path, any D that is a whole number of 16-byte vectors
// and at most 128 of them, tables and queries 16-byte aligned):
// - A warp takes a tile of 32 consecutive candidates of one query and
//   reads their 32 ids with one coalesced load; lanes hand them out by
//   shuffle. A block is kWarps such tiles (a whole K=512 row is two
//   blocks; at the entry's K=64 a block covers four queries). No shared
//   memory, no barrier.
// - The warp is split into groups of G lanes (G a power of two), one
//   candidate per group, so a warp scores 32/G rows at a time. Lane s of
//   a group holds vectors s, s+G, ..., at most kMaxPerLane of them, with
//   the matching slice of the query in registers: at D=96, G=8 in fp32
//   (24 float4, 3 a lane) and G=4 in bf16 (12 uint4, 3 a lane), no lane
//   idle. Each load instruction of a group covers G*16 contiguous bytes.
// - kUnroll steps are loaded into registers before any is reduced, so a
//   warp keeps kUnroll*32/G rows in flight (16 at D=96 fp32; 1 to 4
//   steps timed close to each other on the card, 4 the fastest on most
//   of the main paths' shapes); the group reduces in log2(G) shuffles.
// - Results are shuffled to the lane that owns the candidate and the warp
//   writes its 32 outputs with one coalesced store.
// The host (kernel.py, launch_geometry) chooses the path, G, the vectors
// per lane and the grid; this file only checks and launches them.
//
// General ("rows") path, kept from the first design for a D that is not
// a whole number of 16-byte vectors, a misaligned operand or a row wider
// than 32*kMaxPerLane vectors: one block per query and kChunk
// candidates, the query in shared memory, a warp per candidate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;       // candidates per block, rows path
constexpr int kMaxPerLane = 4;   // 16-byte vectors per lane, groups path
constexpr int kUnroll = 4;       // group steps loaded before reducing
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------
// groups path
// ---------------------------------------------------------------------

// One 16-byte vector of a row: float4 (4 fp32) or uint4 (8 bf16).
template <typename T> struct Vec;
template <> struct Vec<float> {
  using raw = float4;
  static constexpr int kFloats = 4;   // query floats per vector
};
template <> struct Vec<__nv_bfloat16> {
  using raw = uint4;
  static constexpr int kFloats = 8;
};

__device__ __forceinline__ float sq_diff(const float4& x, const float* q) {
  const float a = x.x - q[0], b = x.y - q[1], c = x.z - q[2],
              d = x.w - q[3];
  return a * a + b * b + c * c + d * d;
}

__device__ __forceinline__ float sq_diff(const uint4& raw, const float* q) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    const float a = x.x - q[2 * i], b = x.y - q[2 * i + 1];
    s += a * a + b * b;
  }
  return s;
}

template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads)
    l2_gather_groups(const T* __restrict__ table,
                     const int32_t* __restrict__ ids,
                     const float* __restrict__ queries,
                     float* __restrict__ out, long long B, int K,
                     long long N, int D, int log2g) {
  using Raw = typename Vec<T>::raw;
  constexpr int kF = Vec<T>::kFloats;
  const int lane = threadIdx.x & 31;
  const long long tiles_per_row = (K + 31) >> 5;
  const long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= B * tiles_per_row) return;          // whole warp
  const long long b = tile / tiles_per_row;
  const int c = (int)(tile - b * tiles_per_row) * 32 + lane;

  const int G = 1 << log2g;
  const int per_step = 32 >> log2g;               // candidates per step
  const int grp = lane >> log2g, sub = lane & (G - 1);
  const int nvec = D / kF;

  // This lane's candidate id (coalesced: one 128-byte load per warp).
  const int my_id = c < K ? __ldg(ids + b * K + c) : -1;

  // This lane's slice of the query: vectors sub, sub+G, ... (zeros past
  // the row's end, where the row vector is zero too and adds nothing).
  float q[kPerLane][kF];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int v = j * G + sub;
#pragma unroll
    for (int f = 0; f < kF; f += 4) {
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < nvec)
        y = __ldg(reinterpret_cast<const float4*>(queries + b * D +
                                                  (long long)v * kF + f));
      q[j][f] = y.x; q[j][f + 1] = y.y; q[j][f + 2] = y.z; q[j][f + 3] = y.w;
    }
  }

  // Lane l owns candidate l of the tile: step l / per_step, group
  // l % per_step (whose lane 0 holds the sum after the reduction).
  const int my_step = lane / per_step;
  const int src_lane = (lane % per_step) << log2g;
  float res = 0.f;
  for (int s0 = 0; s0 < G; s0 += kUnroll) {
    int id[kUnroll];
    Raw x[kUnroll][kPerLane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // every lane shuffles (s0 + u may pass G only when G == 1)
      id[u] = __shfl_sync(kFull, my_id, ((s0 + u) * per_step + grp) & 31);
      const bool live = s0 + u < G && id[u] >= 0;
      const Raw* row = reinterpret_cast<const Raw*>(
          table + min((long long)max(id[u], 0), N - 1) * D);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int v = j * G + sub;
        if (live && v < nvec) x[u][j] = __ldg(row + v);
        else x[u][j] = Raw{};
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) sum += sq_diff(x[u][j], q[j]);
      for (int o = G >> 1; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      const float got = __shfl_sync(kFull, sum, src_lane);
      if (my_step == s0 + u) res = got;
    }
  }
  if (c < K) out[b * K + c] = my_id < 0 ? INFINITY : res;
}

// ---------------------------------------------------------------------
// rows path (general D)
// ---------------------------------------------------------------------

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
  return sq_diff(raw, q + 8 * j);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    l2_gather_rows(const T* __restrict__ table,
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
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) out_row[c] = s;
  }
}

template <typename T>
cudaError_t launch_groups(const T* table, const int32_t* ids,
                          const float* queries, float* out, long long B,
                          int K, long long N, int D, int log2g,
                          int per_lane, long long blocks, cudaStream_t s) {
  const dim3 grid((unsigned)blocks);
  switch (per_lane) {
    case 1: l2_gather_groups<T, 1><<<grid, kThreads, 0, s>>>(
        table, ids, queries, out, B, K, N, D, log2g); break;
    case 2: l2_gather_groups<T, 2><<<grid, kThreads, 0, s>>>(
        table, ids, queries, out, B, K, N, D, log2g); break;
    case 3: l2_gather_groups<T, 3><<<grid, kThreads, 0, s>>>(
        table, ids, queries, out, B, K, N, D, log2g); break;
    case 4: l2_gather_groups<T, 4><<<grid, kThreads, 0, s>>>(
        table, ids, queries, out, B, K, N, D, log2g); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* table, const int32_t* ids, const float* queries,
                   float* out, int B, int K, long long N, int D, int path,
                   int log2g, int per_lane, long long blocks,
                   cudaStream_t s) {
  if (path == 2) {
    constexpr int kF = 16 / sizeof(T);
    const int G = 1 << log2g;
    if (log2g < 0 || log2g > 5 || D % kF != 0 ||
        (D / kF + G - 1) / G != per_lane ||
        blocks != ((long long)B * ((K + 31) / 32) + kWarps - 1) / kWarps)
      return cudaErrorInvalidValue;
    return launch_groups<T>(table, ids, queries, out, B, K, N, D, log2g,
                            per_lane, blocks, s);
  }
  if (path != 0 && path != 1) return cudaErrorInvalidValue;
  const dim3 grid(B, (K + kChunk - 1) / kChunk);
  l2_gather_rows<T><<<grid, kThreads, (size_t)D * sizeof(float), s>>>(
      table, ids, queries, out, K, N, D, path);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = fp32 table, 1 = bf16 table.
// path: 0 = rows path, element loads; 1 = rows path, 16-byte loads (D a
// whole number of vectors, table 16-byte aligned); 2 = groups path, with
// group width 1 << log2g, per_lane vectors a lane and `blocks` blocks
// (kernel.py's launch_geometry; checked here against D, B and K).
// Returns cudaGetLastError() after the launch, 0 on success.
extern "C" int l2_gather_launch(const void* table, int dtype,
                                const int32_t* ids, const float* queries,
                                float* out, int B, int K, long long N, int D,
                                int path, int log2g, int per_lane,
                                long long blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(static_cast<const float*>(table), ids, queries, out,
                        B, K, N, D, path, log2g, per_lane, blocks, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(table),
                                ids, queries, out, B, K, N, D, path, log2g,
                                per_lane, blocks, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* l2_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
