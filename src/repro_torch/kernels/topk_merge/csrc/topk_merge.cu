// Hopper (sm_90a) port of the topk_merge TPU kernel
// (src/repro/kernels/topk_merge/kernel.py: topk_merge, bitonic network
// _bitonic, body _kernel).
//
// Merges a candidate pool (d, id, visited) [B, L] with new candidates
// (d, id) [B, R] and keeps the best L per row, exactly as the plain
// version (ref.py, the reference's stable lexsort) orders them: by
// distance, then id, then original lane ([pool | new]), so a full tie
// on (d, id) keeps the earlier lane first. New lanes carry visited=0.
// Lanes past L+R are padding and sort after every real lane, whatever
// its distance. The TPU kernel pads with (+inf, -1) and orders by (d, id)
// alone: its pads outrank a real (+inf, id >= 0) lane and its unstable
// network leaves `visited` order-dependent on full ties. This kernel
// does neither.
//
// Order key: one 64-bit word per lane, (ordered bits of d) << 32 |
// (id ^ 0x80000000), compared with the lane index as a final tiebreak,
// so every key is distinct and the result is unique. -0.0 orders as
// +0.0 and NaN after +inf, as the plain version's sort orders them.
// Padding takes the key ~0, which no real lane reaches (the largest real
// key is that of NaN, 0xffc00000 in its top word). Only (key, lane)
// move; at the end the winning lanes gather d, id and visited from the
// inputs, so the outputs are the inputs' own bits.
//
// Bound: memory. Per row it must read the pool (L*9 bytes) and the new
// candidates (R*8 bytes) and write L*9 bytes. At the executor's merge
// shape (B=1024, L=64, R=512) that is ~5.4 MB, 1.6 us at 3.35 TB/s; the
// compare-exchanges are far below the card's rate. What a kernel can
// reach is set by the latency of its dependent steps.
//
// The first design (kept below as the "block" path) ran one 1,024-thread
// block per row and a full bitonic sort of all P = next_pow2(L+R) lanes:
// 55 dependent compare-exchange steps at P = 1,024, every stride >= 32
// through shared memory between two block barriers, to keep 64 lanes.
// It took 89 us at that shape on an H100 80GB HBM3 at 700 W, 2% of the
// bound and twice torch.sort's time on the same lanes.
//
// Design ("warp" path, L <= 256): one warp per row, kRowsPerBlock rows
// a block, no block barrier.
// - The warp keeps a running sorted list of the best M = max(32,
//   next_pow2(L)) (key, lane) pairs in registers, E = M/32 a lane, item
//   i at lane i/E, register i%E ("blocked"), so strides below E are
//   register swaps and the rest are __shfl_xor_sync.
// - It walks the [pool | new] lanes in chunks of M, chunk c covering
//   lanes c*M .. c*M+M-1. Each thread copies its E consecutive lanes into
//   a per-warp ring in shared memory with cp.async, 8- or 16-byte copies
//   where they lie in one input and are aligned (4-byte ones otherwise),
//   kInFlight/E chunks ahead of the one it filters, so the row's reads
//   overlap the network without holding registers.
// - Filter: every lane of a chunk comes after every lane already seen,
//   so a lane whose key is at or above the list's L-th key cannot enter.
//   The others join a per-warp candidate ring in shared memory, placed by
//   a ballot and a popcount per register; a chunk with no candidate
//   costs only its ballots.
// - Each time M candidates have gathered (and once at the end for the
//   rest), the batch is sorted descending by a warp bitonic network
//   (log2(M)(log2(M)+1)/2 steps), the list takes the elementwise minimum
//   of itself and the batch (a bitonic sequence holding the best M of
//   both), a bitonic merge of log2(M) steps sorts it again, and the
//   filter takes the new L-th key. The list starts as padding, so the
//   first batch needs no special case.
// At L=64, R=512 that is 9 chunks of 64 lanes and as many batches of at
// most 27 dependent steps as the candidates fill: from one (the pool,
// when the new lanes are all farther, as late in a search) to nine.
// Batching matters because the merges' dependent steps (three shuffles
// and a 96-bit compare an item, ~50 ns each on an H100 80GB HBM3 at
// 700 W) are what bounds the kernel: merging every chunk that held a
// candidate (all 9 on chip_smoke.py's data, against 5 batches) took
// 18.7-19.0 us at that shape, this 16.6-16.9 us.
//
// The host (kernel.py, launch_geometry) chooses the path, M, E and the
// grid; this file only checks and launches them. An L above 256 (more
// than 8 items a lane) takes the block path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 4;  // warp path: rows (one warp each) a block
constexpr int kInFlight = 8;      // warp path: lanes a thread has in flight

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

// ---------------------------------------------------------------------
// warp path
// ---------------------------------------------------------------------

struct Item {
  uint64_t k;   // order key (make_key), ~0 for padding
  uint32_t l;   // lane in [pool | new]
};

__device__ __forceinline__ bool before(const Item& a, const Item& b) {
  return less(a.k, a.l, b.k, b.l);
}

// One compare-exchange step of a bitonic network over the warp's 32*E
// items (item i = lane*E + e): i and i^s are put in ascending order when
// ((i & size) == 0) != desc, in descending order otherwise.
template <int E>
__device__ __forceinline__ void cx_step(Item (&x)[E], int t, int size, int s,
                                        bool desc) {
  if (s < E) {  // partner in this thread
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int pe = e ^ s;
      if (pe < e) continue;  // each pair once, from its lower item
      const bool asc = (((t * E + e) & size) == 0) != desc;
      if (before(x[pe], x[e]) == asc) {
        const Item tmp = x[e];
        x[e] = x[pe];
        x[pe] = tmp;
      }
    }
  } else {  // partner on lane t ^ (s / E), same register
    const int m = s / E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      Item p;
      p.k = __shfl_xor_sync(kFull, x[e].k, m);
      p.l = __shfl_xor_sync(kFull, x[e].l, m);
      const int i = t * E + e;
      const bool asc = ((i & size) == 0) != desc;
      const bool lower = (i & s) == 0;
      // the lower item keeps the smaller of an ascending pair
      if (before(p, x[e]) == (lower == asc)) x[e] = p;
    }
  }
}

// cp.async of N bytes (4, 8 or 16) from device memory into shared memory;
// the copy bypasses the registers, so a thread can keep several chunks
// of its row in flight without spending registers on them.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy this thread's E consecutive lanes j0 .. j0+E-1 of a row (d and id)
// into sd/si: from the pool (j < L) or the new candidates (L <= j < T),
// as 8- or 16-byte copies where all E lie in one input and are aligned,
// lane by lane otherwise. Lanes past T are padding and are not read.
template <int E>
__device__ __forceinline__ void stage_lanes(float* sd, int32_t* si,
                                            const float* pd,
                                            const int32_t* pi,
                                            const float* nd,
                                            const int32_t* ni, int L, int T,
                                            int j0) {
  constexpr int V = E < 4 ? E : 4;  // lanes per copy
  const float* vd = nullptr;
  const int32_t* vi = nullptr;
  if (E > 1 && j0 + E <= L) {
    vd = pd + j0;
    vi = pi + j0;
  } else if (E > 1 && j0 >= L && j0 + E <= T) {
    vd = nd + (j0 - L);
    vi = ni + (j0 - L);
  }
  if (vd != nullptr &&
      ((reinterpret_cast<uintptr_t>(vd) | reinterpret_cast<uintptr_t>(vi)) &
       (V * 4 - 1)) == 0) {
#pragma unroll
    for (int e = 0; e < E; e += V) {
      cp_async<V * 4>(sd + e, vd + e);
      cp_async<V * 4>(si + e, vi + e);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = j0 + e;
    if (j < L) {
      cp_async<4>(sd + e, pd + j);
      cp_async<4>(si + e, pi + j);
    } else if (j < T) {
      cp_async<4>(sd + e, nd + (j - L));
      cp_async<4>(si + e, ni + (j - L));
    }
  }
}

// The list's item i (lane i / E, register i % E), on every lane.
template <int E>
__device__ __forceinline__ uint64_t list_key(const Item (&list)[E], int lane,
                                             int reg) {
  uint64_t k = 0;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e == reg) k = list[e].k;
  return __shfl_sync(kFull, k, lane);
}

// Merge `count` (1..M) candidates of a warp's ring, from `head`, into the
// running list: sort them descending (padding past `count`), take the
// elementwise minimum with the ascending list (a bitonic sequence that
// holds the best M of both), and merge it ascending.
template <int E>
__device__ __forceinline__ void merge_batch(Item (&list)[E],
                                            const uint64_t* ck,
                                            const uint32_t* cl, int head,
                                            int count, int t) {
  constexpr int M = 32 * E;
  constexpr int kLogM = E == 1 ? 5 : E == 2 ? 6 : E == 4 ? 7 : 8;
  __syncwarp();  // the other lanes' ring writes
  Item x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    const int pos = (head + i) & (2 * M - 1);
    x[e] = i < count ? Item{ck[pos], cl[pos]} : Item{~0ull, 0xffffffffu};
  }
  __syncwarp();  // read before the next chunk's writes
#pragma unroll
  for (int ls = 1; ls <= kLogM; ++ls)
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj)
      cx_step<E>(x, t, 1 << ls, 1 << lj, true);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (before(x[e], list[e])) list[e] = x[e];
#pragma unroll
  for (int lj = kLogM - 1; lj >= 0; --lj)
    cx_step<E>(list, t, M, 1 << lj, false);
}

template <int E>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    topk_merge_warp(const float* __restrict__ pool_d,
                    const int32_t* __restrict__ pool_i,
                    const uint8_t* __restrict__ pool_v,
                    const float* __restrict__ new_d,
                    const int32_t* __restrict__ new_i,
                    float* __restrict__ out_d, int32_t* __restrict__ out_i,
                    uint8_t* __restrict__ out_v, long long B, int L, int R) {
  constexpr int M = 32 * E;                 // list and chunk size
  constexpr int PF = kInFlight / E;         // chunks in flight
  // a ring of PF chunks per warp; each thread reads back only the lanes
  // it copied itself, so no barrier is needed
  __shared__ __align__(16) float ring_d[kRowsPerBlock][PF][M];
  __shared__ __align__(16) int32_t ring_i[kRowsPerBlock][PF][M];
  // the candidates that passed the filter and wait for a merge, a ring of
  // 2M per warp (a chunk adds at most M to fewer than M)
  __shared__ uint64_t cand_k[kRowsPerBlock][2 * M];
  __shared__ uint32_t cand_l[kRowsPerBlock][2 * M];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kRowsPerBlock + w;
  if (b >= B) return;  // whole warp
  const int T = L + R;
  const int nch = (T + M - 1) / M;
  const float* pd = pool_d + b * L;
  const int32_t* pi = pool_i + b * L;
  const float* nd = new_d + b * R;
  const int32_t* ni = new_i + b * R;

#pragma unroll
  for (int p = 0; p < PF; ++p) {
    if (p < nch)
      stage_lanes<E>(&ring_d[w][p][t * E], &ring_i[w][p][t * E], pd, pi, nd,
                     ni, L, T, p * M + t * E);
    cp_async_commit();  // one group per chunk, empty past the row's end
  }

  Item list[E];
#pragma unroll
  for (int e = 0; e < E; ++e) list[e] = Item{~0ull, 0xffffffffu};
  const int kth_lane = (L - 1) / E, kth_reg = (L - 1) % E;
  uint64_t kth = ~0ull;  // the list's L-th key, refreshed after each merge
  int head = 0, n = 0;   // the candidate ring: n items from head

  for (int c = 0; c < nch; ++c) {
    const int slot = c % PF;
    cp_async_wait<PF - 1>();  // chunk c's group has landed
    Item x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = c * M + t * E + e;
      x[e].k = j < T ? make_key(ring_d[w][slot][t * E + e],
                                ring_i[w][slot][t * E + e])
                     : ~0ull;
      x[e].l = (uint32_t)j;
    }
    if (c + PF < nch)  // refill the slot just read
      stage_lanes<E>(&ring_d[w][slot][t * E], &ring_i[w][slot][t * E], pd,
                     pi, nd, ni, L, T, (c + PF) * M + t * E);
    cp_async_commit();
    // filter: the chunk's lanes all come after every lane seen so far, so
    // a key at or above the L-th key (even an equal one) cannot enter;
    // the others join the ring in (register, lane) order
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool pass = x[e].k < kth;
      const unsigned bal = __ballot_sync(kFull, pass);
      if (pass) {
        const int pos = (head + n + __popc(bal & ((1u << t) - 1u))) &
                        (2 * M - 1);
        cand_k[w][pos] = x[e].k;
        cand_l[w][pos] = x[e].l;
      }
      n += __popc(bal);
    }
    if (n >= M) {  // a full batch: merge it
      merge_batch<E>(list, cand_k[w], cand_l[w], head, M, t);
      head = (head + M) & (2 * M - 1);
      n -= M;
      kth = list_key<E>(list, kth_lane, kth_reg);
    }
  }
  if (n > 0) merge_batch<E>(list, cand_k[w], cand_l[w], head, n, t);
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    if (i >= L) continue;
    const int lane = (int)list[e].l;  // a real lane: T >= L
    float d;
    int32_t id;
    uint8_t v = 0;
    if (lane < L) {
      d = __ldg(pd + lane);
      id = __ldg(pi + lane);
      v = __ldg(pool_v + b * L + lane) != 0;
    } else {
      d = __ldg(nd + (lane - L));
      id = __ldg(ni + (lane - L));
    }
    out_d[b * L + i] = d;
    out_i[b * L + i] = id;
    out_v[b * L + i] = v;
  }
}

// ---------------------------------------------------------------------
// block path (L > 256): the first design
// ---------------------------------------------------------------------
//
// One block per row, P/E threads, each holding E = max(1, P/1024) lanes
// in registers at positions j = e*(P/E) + thread. A compare-exchange
// partner j ^ stride is then in the same thread for stride >= P/E (a
// register swap), in the same warp for stride < 32 (__shfl_xor_sync of
// key and lane) and otherwise in another warp (through shared memory,
// 12 bytes per lane, with __syncthreads on either side). The first L
// threads' lanes then gather d, id and visited from the inputs.
template <int E>
__global__ void __launch_bounds__(1024)
    topk_merge_block(const float* __restrict__ pool_d,
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
  const unsigned mask = NT >= 32 ? kFull : ((1u << NT) - 1u);
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

struct Args {
  const float* pool_d;
  const int32_t* pool_i;
  const uint8_t* pool_v;
  const float* new_d;
  const int32_t* new_i;
  float* out_d;
  int32_t* out_i;
  uint8_t* out_v;
};

template <int E>
cudaError_t launch_warp(const Args& a, long long B, int L, int R,
                        long long grid, cudaStream_t s) {
  topk_merge_warp<E><<<(unsigned)grid, kRowsPerBlock * 32, 0, s>>>(
      a.pool_d, a.pool_i, a.pool_v, a.new_d, a.new_i, a.out_d, a.out_i,
      a.out_v, B, L, R);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_block(const Args& a, int B, int L, int R, int P,
                         cudaStream_t s) {
  const size_t smem = (size_t)P * (sizeof(uint64_t) + sizeof(uint32_t));
  if (smem > 48 * 1024) {  // above the static limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        topk_merge_block<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  topk_merge_block<E><<<B, P / E, smem, s>>>(a.pool_d, a.pool_i, a.pool_v,
                                             a.new_d, a.new_i, a.out_d,
                                             a.out_i, a.out_v, L, R, P);
  return cudaGetLastError();
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// C interface, loaded with ctypes. path 0 = warp path: `lanes` is the
// list size M = max(32, next_pow2(L)) with L <= 256, per_lane = M/32, and
// `grid` = ceil(B / 4) blocks of 4 warps. path 1 = block path: `lanes` is
// P = next_pow2(L + R) <= 16384, per_lane = max(1, P/1024), `grid` = B.
// kernel.py's launch_geometry chooses them; they are checked here.
// Returns the launch's cudaGetLastError(), 0 on success.
extern "C" int topk_merge_launch(const float* pool_d, const int32_t* pool_i,
                                 const uint8_t* pool_v, const float* new_d,
                                 const int32_t* new_i, float* out_d,
                                 int32_t* out_i, uint8_t* out_v, int B, int L,
                                 int R, int path, int lanes, int per_lane,
                                 long long grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{pool_d, pool_i, pool_v, new_d, new_i, out_d, out_i, out_v};
  if (B < 1 || L < 1 || R < 0) return (int)cudaErrorInvalidValue;
  if (path == 0) {
    const int M = next_pow2(L) < 32 ? 32 : next_pow2(L);
    if (L > 256 || lanes != M || per_lane != M / 32 ||
        grid != ((long long)B + kRowsPerBlock - 1) / kRowsPerBlock)
      return (int)cudaErrorInvalidValue;
    switch (per_lane) {
      case 1: return (int)launch_warp<1>(a, B, L, R, grid, s);
      case 2: return (int)launch_warp<2>(a, B, L, R, grid, s);
      case 4: return (int)launch_warp<4>(a, B, L, R, grid, s);
      case 8: return (int)launch_warp<8>(a, B, L, R, grid, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const int P = lanes;
  if (path != 1 || (long long)L + R > 16384 || P != next_pow2(L + R) ||
      per_lane != (P > 1024 ? P / 1024 : 1) || grid != B)
    return (int)cudaErrorInvalidValue;
  switch (per_lane) {
    case 1: return (int)launch_block<1>(a, B, L, R, P, s);
    case 2: return (int)launch_block<2>(a, B, L, R, P, s);
    case 4: return (int)launch_block<4>(a, B, L, R, P, s);
    case 8: return (int)launch_block<8>(a, B, L, R, P, s);
    case 16: return (int)launch_block<16>(a, B, L, R, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* topk_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
