// Bitonic sorting network over one array of 2^m keys (m <= 20), keys-only
// or carrying an int32 payload, and runs of its passes, executing a launch
// plan made on the host (tpubz_torch/kernels/bitonic.py:plan).
//
// Replaces the TPU kernels
//   tools/probe_pallas_sort.py:110 bitonic_1op  (body _kernel_1op :98)
//   tools/probe_pallas_sort.py:121 bitonic_2op  (body _kernel_2op :103)
//   tools/probe_pallas_pass.py:83  make_stage_kernel(js, mode).run
// and runs their network pass for pass (_bitonic_body :86, _cex :55): for
// stage k = 1..m and j = k-1..0, element i meets i ^ 2^j; the pair is put in
// ascending order where bit k of the lower index is 0, descending elsewhere;
// on equal keys neither side moves, so the payload order on duplicate keys
// is the Pallas kernel's.
//
// What bounds it on an H100. The TPU kernels held all 2^20 keys in VMEM for
// the whole network; an SM has at most 227 KB of shared memory. A sort of
// 2^20 int64 keys with a payload is 210 passes over 12 MB. Moved once, that
// is 25 MB (7.5 us at 3.35 TB/s); each extra sweep of the array costs
// another 24 MB of L2 traffic (the 50 MB L2 holds it) and each launch a few
// microseconds, and the compare-exchanges themselves are ~10 instructions a
// pair, ~35 us of issue for the 210 passes. So the design cuts sweeps,
// launches and barriers:
//   - Registers. A thread holds E = 2^R elements of each array (R <= 5):
//     the coset of R index bits ("register bits") that a group of passes
//     needs, so those passes run in registers with no barrier and no
//     shared-memory traffic.
//   - bitonic_tile takes a tile of T = 2^t keys (t <= 14, up to 192 KB of
//     dynamic shared memory) and runs a list of groups, each of passes whose
//     distances are register bits of that group; between groups the tile
//     goes through shared memory with one barrier. The first group reads
//     device memory and the last writes it, so a one-group launch touches
//     no shared memory. Shared memory is XOR-swizzled in 16-byte units
//     within each 128-byte line, so a warp's accesses are conflict-free
//     both when a thread holds E consecutive elements (read as 16-byte
//     vectors) and when the lanes walk consecutive elements. Warp shuffles
//     are not used: a shuffle moves 4 bytes a lane per pass, a group moves
//     each element through shared memory twice per R passes.
//   - bitonic_global runs r <= 5 consecutive passes of one stage at
//     distances >= T: a thread loads the 2^r elements the passes touch (a
//     set closed under those distances), runs them in registers and stores
//     once, so r passes cost one sweep and one launch.
// The host plan folds a 2^20 sort into one tile launch for stages 1..t,
// then per later stage its global passes in groups of up to r and one tile
// launch for its last t passes.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitonic.cuh"

namespace {

constexpr int kMaxRegsLog2 = 5;
constexpr int kMaxTileLog2 = 14;
// threads of a tile block: up to 1024 with at most 8 elements a thread
// (<= 64 registers), up to 512 with 16 or 32 (<= 128 registers)
constexpr int max_tile_threads(int R) { return R <= 3 ? 1024 : 512; }
constexpr int kMaxTilePasses = 128;
constexpr int kMaxGroups = 64;
constexpr int kGlobalThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory on sm_90

// One tile launch's plan, passed by value (well inside the 4 KB of
// parameters): the groups in order, each with its register bits, and every
// pass with the register position q of its distance bit, its stage k and
// the register position of bit k (0xFF when bit k is no register bit).
struct TilePlan {
  int ngroups;
  uint8_t bits[kMaxGroups][kMaxRegsLog2];  // ascending
  uint8_t contiguous[kMaxGroups];          // bits are 0..R-1
  uint8_t end[kMaxGroups];                 // one past the group's last pass
  uint8_t q[kMaxTilePasses];
  uint8_t k[kMaxTilePasses];
  uint8_t qk[kMaxTilePasses];
};

// Shared-memory position of element e of a 4- or 8-byte array: the 16-byte
// unit of e is XORed with its 128-byte line index mod 8.
template <typename T>
__device__ __forceinline__ int swz(int e) {
  constexpr int kLogPerUnit = sizeof(T) == 8 ? 1 : 2;
  return e ^ (((e >> (kLogPerUnit + 3)) & 7) << kLogPerUnit);
}

__device__ __forceinline__ int swz_unit(int u) { return u ^ ((u >> 3) & 7); }

// A compare-exchange that swaps only when the pair is strictly out of order.
template <typename K, bool kPayload>
__device__ __forceinline__ void cex(K& a, K& b, int32_t& pa, int32_t& pb, bool desc) {
  const bool sw = desc ? (a < b) : (b < a);
  const K x = sw ? b : a;
  const K y = sw ? a : b;
  a = x;
  b = y;
  if constexpr (kPayload) {
    const int32_t u = sw ? pb : pa;
    const int32_t v = sw ? pa : pb;
    pa = u;
    pb = v;
  }
}

// The pass on register bit Q: pairs (c, c | 2^Q), in the direction of bit
// k of the lower element's index. QK >= 0: bit k is register bit QK, so the
// direction is fixed for each c. QK == -1: it is the thread's, `desc`
// (a constant where the warp agrees on it, then the selects fold away).
template <typename K, bool kPayload, int R, int Q, int QK>
__device__ __forceinline__ void reg_pass(K (&rk)[1 << R], int32_t (&rp)[1 << R], bool desc) {
  if constexpr (Q < R && QK < R && Q != QK) {
#pragma unroll
    for (int c = 0; c < (1 << R); ++c) {
      if (c & (1 << Q)) continue;
      bool d = desc;
      if constexpr (QK >= 0) d = ((c >> QK) & 1) != 0;
      cex<K, kPayload>(rk[c], rk[c | (1 << Q)], rp[c], rp[c | (1 << Q)], d);
    }
  }
}

template <typename K, bool kPayload, int R, int Q>
__device__ __forceinline__ void reg_pass_k(int qk, K (&rk)[1 << R], int32_t (&rp)[1 << R],
                                           bool desc) {
  switch (qk) {
    case 0: reg_pass<K, kPayload, R, Q, 0>(rk, rp, false); break;
    case 1: reg_pass<K, kPayload, R, Q, 1>(rk, rp, false); break;
    case 2: reg_pass<K, kPayload, R, Q, 2>(rk, rp, false); break;
    case 3: reg_pass<K, kPayload, R, Q, 3>(rk, rp, false); break;
    case 4: reg_pass<K, kPayload, R, Q, 4>(rk, rp, false); break;
    default:
      // the lanes of a warp usually agree on the direction: then it is a
      // constant of the branch taken
      if (__all_sync(0xffffffffu, desc)) {
        reg_pass<K, kPayload, R, Q, -1>(rk, rp, true);
      } else if (!__any_sync(0xffffffffu, desc)) {
        reg_pass<K, kPayload, R, Q, -1>(rk, rp, false);
      } else {
        reg_pass<K, kPayload, R, Q, -1>(rk, rp, desc);
      }
  }
}

// qk: the register position of bit k, or -1
template <typename K, bool kPayload, int R>
__device__ __forceinline__ void reg_pass_q(int q, int qk, K (&rk)[1 << R],
                                           int32_t (&rp)[1 << R], bool desc) {
  switch (q) {
    case 0: reg_pass_k<K, kPayload, R, 0>(qk, rk, rp, desc); break;
    case 1: reg_pass_k<K, kPayload, R, 1>(qk, rk, rp, desc); break;
    case 2: reg_pass_k<K, kPayload, R, 2>(qk, rk, rp, desc); break;
    case 3: reg_pass_k<K, kPayload, R, 3>(qk, rk, rp, desc); break;
    case 4: reg_pass_k<K, kPayload, R, 4>(qk, rk, rp, desc); break;
  }
}

// 16-byte vectors to and from registers
__device__ __forceinline__ void unpack(const int4& x, int64_t* d) {
  d[0] = (static_cast<int64_t>(x.y) << 32) | static_cast<uint32_t>(x.x);
  d[1] = (static_cast<int64_t>(x.w) << 32) | static_cast<uint32_t>(x.z);
}
__device__ __forceinline__ void unpack(const int4& x, int32_t* d) {
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}
__device__ __forceinline__ int4 pack(const int64_t* s) {
  return make_int4(static_cast<int>(s[0]), static_cast<int>(s[0] >> 32),
                   static_cast<int>(s[1]), static_cast<int>(s[1] >> 32));
}
__device__ __forceinline__ int4 pack(const int32_t* s) { return make_int4(s[0], s[1], s[2], s[3]); }

// E = 2^R elements of one array between registers and device memory (src
// at the tile's base) or swizzled shared memory. `contiguous`: the thread's
// elements are base .. base+E-1, moved as 16-byte vectors when E elements
// fill whole vectors; otherwise element c is at e[c].
template <typename T, int R, bool kShared>
__device__ __forceinline__ void load(T (&r)[1 << R], const T* src, int base,
                                     const int (&e)[1 << R], bool contiguous) {
  constexpr int kPer = 16 / sizeof(T);
  if constexpr ((1 << R) % kPer == 0) {
    if (contiguous) {
      const int4* v = reinterpret_cast<const int4*>(src);
      const int u0 = base / kPer;
#pragma unroll
      for (int w = 0; w < (1 << R) / kPer; ++w) {
        const int4 x = v[kShared ? swz_unit(u0 + w) : u0 + w];
        unpack(x, &r[w * kPer]);
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < (1 << R); ++c) r[c] = src[kShared ? swz<T>(e[c]) : e[c]];
}

template <typename T, int R, bool kShared>
__device__ __forceinline__ void store(const T (&r)[1 << R], T* dst, int base,
                                      const int (&e)[1 << R], bool contiguous) {
  constexpr int kPer = 16 / sizeof(T);
  if constexpr ((1 << R) % kPer == 0) {
    if (contiguous) {
      int4* v = reinterpret_cast<int4*>(dst);
      const int u0 = base / kPer;
#pragma unroll
      for (int w = 0; w < (1 << R) / kPer; ++w) {
        v[kShared ? swz_unit(u0 + w) : u0 + w] = pack(&r[w * kPer]);
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < (1 << R); ++c) dst[kShared ? swz<T>(e[c]) : e[c]] = r[c];
}

// The whole tile between device memory and swizzled shared memory, 16-byte
// units with consecutive threads on consecutive units (count elements, a
// multiple of 16 bytes).
template <typename T>
__device__ __forceinline__ void copy_in(T* s, const T* g, int count) {
  const int4* src = reinterpret_cast<const int4*>(g);
  int4* dst = reinterpret_cast<int4*>(s);
  for (int u = threadIdx.x; u < count * static_cast<int>(sizeof(T)) / 16; u += blockDim.x) {
    dst[swz_unit(u)] = src[u];
  }
}

template <typename T>
__device__ __forceinline__ void copy_out(T* g, const T* s, int count) {
  const int4* src = reinterpret_cast<const int4*>(s);
  int4* dst = reinterpret_cast<int4*>(g);
  for (int u = threadIdx.x; u < count * static_cast<int>(sizeof(T)) / 16; u += blockDim.x) {
    dst[u] = src[swz_unit(u)];
  }
}

template <typename K, bool kPayload, int R>
__global__ void __launch_bounds__(max_tile_threads(R))
    bitonic_tile(K* __restrict__ keys, int32_t* __restrict__ payload, int log2_tile,
                 TilePlan plan, const int* __restrict__ done) {
  constexpr int E = 1 << R;
  if (done != nullptr && *done != 0) return;  // the whole grid agrees
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  int32_t* sp = reinterpret_cast<int32_t*>(smem + (sizeof(K) << log2_tile));
  const int tile_base = blockIdx.x << log2_tile;
  K* gk = keys + tile_base;
  int32_t* gp = kPayload ? payload + tile_base : nullptr;
  K rk[E];
  int32_t rp[E];
  // A thread that holds consecutive elements would read and write device
  // memory 16 bytes at every 16*E: a first or last group of that kind
  // goes through shared memory, which the block fills and empties in
  // coalesced 16-byte units (E >= 4 makes both arrays whole units).
  const int tile = 1 << log2_tile;
  const bool staged_first = E >= 4 && plan.contiguous[0];
  const bool staged_last = E >= 4 && plan.contiguous[plan.ngroups - 1];
  if (staged_first) {
    copy_in(sk, gk, tile);
    if constexpr (kPayload) copy_in(sp, gp, tile);
  }
  int p = 0;
  for (int g = 0; g < plan.ngroups; ++g) {
    // this group's layout: the thread index with a zero inserted at each
    // register bit, and the tile index of each register
    int base = threadIdx.x;
    int boff[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int bit = plan.bits[g][b];
      base = ((base >> bit) << (bit + 1)) | (base & ((1 << bit) - 1));
      boff[b] = 1 << bit;
    }
    // the registers' tile indices
    int e[E];
#pragma unroll
    for (int c = 0; c < E; ++c) {
      e[c] = base;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        if (c & (1 << b)) e[c] += boff[b];
      }
    }
    const bool contiguous = plan.contiguous[g];
    if (g == 0 && !staged_first) {
      load<K, R, false>(rk, gk, base, e, contiguous);
      if constexpr (kPayload) load<int32_t, R, false>(rp, gp, base, e, contiguous);
    } else {
      __syncthreads();
      load<K, R, true>(rk, sk, base, e, contiguous);
      if constexpr (kPayload) load<int32_t, R, true>(rp, sp, base, e, contiguous);
    }
    for (; p < plan.end[g]; ++p) {
      const bool desc = ((tile_base + base) >> plan.k[p]) & 1;
      reg_pass_q<K, kPayload, R>(plan.q[p], plan.qk[p] == 0xFF ? -1 : plan.qk[p], rk, rp, desc);
    }
    // each thread stores exactly the elements it loaded, so the next
    // group's loads need the one barrier above and no second one
    if (g == plan.ngroups - 1 && !staged_last) {
      store<K, R, false>(rk, gk, base, e, contiguous);
      if constexpr (kPayload) store<int32_t, R, false>(rp, gp, base, e, contiguous);
    } else {
      store<K, R, true>(rk, sk, base, e, contiguous);
      if constexpr (kPayload) store<int32_t, R, true>(rp, sp, base, e, contiguous);
    }
  }
  if (staged_last) {
    __syncthreads();
    copy_out(gk, sk, tile);
    if constexpr (kPayload) copy_out(gp, sp, tile);
  }
}

// Passes (k, j_lo + R - 1), ..., (k, j_lo) in device memory, j_lo >= the
// tile bits; bit k of every index a thread holds is its base's. Both pass
// kernels take `done`: null, or a device int written before the launch; when
// it is not 0 the kernel returns at once (a doubling round of the BWT that
// was enqueued before the host knew the sort had converged).
template <typename K, bool kPayload, int R>
__global__ void __launch_bounds__(kGlobalThreads)
    bitonic_global(K* __restrict__ keys, int32_t* __restrict__ payload, int n, int j_lo, int k,
                   const int* __restrict__ done) {
  constexpr int E = 1 << R;
  if (done != nullptr && *done != 0) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (n >> R)) return;
  const int low = t & ((1 << j_lo) - 1);
  const int base = ((t - low) << R) | low;
  K rk[E];
  int32_t rp[E];
#pragma unroll
  for (int c = 0; c < E; ++c) {
    rk[c] = keys[base + (c << j_lo)];
    if constexpr (kPayload) rp[c] = payload[base + (c << j_lo)];
  }
  // the direction is one per block (bit k lies above its 256 threads' bits)
  const bool desc = (base >> k) & 1;
#pragma unroll
  for (int q = R - 1; q >= 0; --q) {
#pragma unroll
    for (int c = 0; c < E; ++c) {
      if (c & (1 << q)) continue;
      if (desc) {
        cex<K, kPayload>(rk[c], rk[c | (1 << q)], rp[c], rp[c | (1 << q)], true);
      } else {
        cex<K, kPayload>(rk[c], rk[c | (1 << q)], rp[c], rp[c | (1 << q)], false);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < E; ++c) {
    keys[base + (c << j_lo)] = rk[c];
    if constexpr (kPayload) payload[base + (c << j_lo)] = rp[c];
  }
}

template <typename K, bool kPayload, int R>
cudaError_t launch_tile(K* keys, int32_t* payload, int n, int log2_tile, const TilePlan& plan,
                        const int* done, cudaStream_t stream) {
  const int smem = (sizeof(K) + (kPayload ? sizeof(int32_t) : 0)) << log2_tile;
  static bool big_smem = false;  // the attribute is set once per instantiation
  if (smem > 48 * 1024 && !big_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        bitonic_tile<K, kPayload, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    big_smem = true;
  }
  bitonic_tile<K, kPayload, R>
      <<<n >> log2_tile, (1 << log2_tile) >> R, smem, stream>>>(keys, payload, log2_tile, plan,
                                                                 done);
  return cudaGetLastError();
}

template <typename K, bool kPayload>
cudaError_t launch_tile_r(int R, K* keys, int32_t* payload, int n, int log2_tile,
                          const TilePlan& plan, const int* done, cudaStream_t stream) {
  switch (R) {
    case 1: return launch_tile<K, kPayload, 1>(keys, payload, n, log2_tile, plan, done, stream);
    case 2: return launch_tile<K, kPayload, 2>(keys, payload, n, log2_tile, plan, done, stream);
    case 3: return launch_tile<K, kPayload, 3>(keys, payload, n, log2_tile, plan, done, stream);
    case 4: return launch_tile<K, kPayload, 4>(keys, payload, n, log2_tile, plan, done, stream);
    case 5: return launch_tile<K, kPayload, 5>(keys, payload, n, log2_tile, plan, done, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename K, bool kPayload, int R>
cudaError_t launch_global(K* keys, int32_t* payload, int n, int j_lo, int k, const int* done,
                          cudaStream_t stream) {
  const int threads = n >> R;
  bitonic_global<K, kPayload, R>
      <<<(threads + kGlobalThreads - 1) / kGlobalThreads, kGlobalThreads, 0, stream>>>(
          keys, payload, n, j_lo, k, done);
  return cudaGetLastError();
}

template <typename K, bool kPayload>
cudaError_t launch_global_r(int r, K* keys, int32_t* payload, int n, int j_lo, int k,
                            const int* done, cudaStream_t stream) {
  switch (r) {
    case 1: return launch_global<K, kPayload, 1>(keys, payload, n, j_lo, k, done, stream);
    case 2: return launch_global<K, kPayload, 2>(keys, payload, n, j_lo, k, done, stream);
    case 3: return launch_global<K, kPayload, 3>(keys, payload, n, j_lo, k, done, stream);
    case 4: return launch_global<K, kPayload, 4>(keys, payload, n, j_lo, k, done, stream);
    case 5: return launch_global<K, kPayload, 5>(keys, payload, n, j_lo, k, done, stream);
  }
  return cudaErrorInvalidValue;
}

int log2_of(int n) {
  int m = 0;
  while ((1 << m) < n) ++m;
  return m;
}

// Runs the encoded plan (see bitonic.py:encode) on n = 2^m keys, adding its
// kernel launches to *launched; every pass kernel gets `done`. A record
// that does not fit the kernels' limits returns cudaErrorInvalidValue before
// any launch of its own.
template <typename K>
int run_plan(void* keys_v, void* payload_v, int n, const int* plan, int plan_len, int* launched,
             const int* done, cudaStream_t stream) {
  K* keys = static_cast<K*>(keys_v);
  int32_t* payload = static_cast<int32_t*>(payload_v);
  const int m = log2_of(n);
  int i = 0;
  while (i < plan_len) {
    cudaError_t err;
    if (plan[i] == 0 && i + 4 <= plan_len) {
      const int k = plan[i + 1], j_lo = plan[i + 2], r = plan[i + 3];
      i += 4;
      // bit k must lie above the group's bits: the direction is per thread
      if (r < 1 || r > kMaxRegsLog2 || j_lo < 0 || j_lo + r > m || k < j_lo + r) {
        return cudaErrorInvalidValue;
      }
      err = payload ? launch_global_r<K, true>(r, keys, payload, n, j_lo, k, done, stream)
                    : launch_global_r<K, false>(r, keys, nullptr, n, j_lo, k, done, stream);
    } else if (plan[i] == 1 && i + 5 <= plan_len) {
      const int t = plan[i + 1], R = plan[i + 2], ng = plan[i + 3], np = plan[i + 4];
      i += 5;
      if (t < 1 || t > kMaxTileLog2 || t > m || R < 1 || R > kMaxRegsLog2 || R > t ||
          ((1 << t) >> R) > max_tile_threads(R) || ng < 1 || ng > kMaxGroups || np < 1 ||
          np > kMaxTilePasses || i + ng * (R + 2) + np * 3 > plan_len) {
        return cudaErrorInvalidValue;
      }
      TilePlan tp;
      tp.ngroups = ng;
      for (int g = 0; g < ng; ++g) {
        for (int b = 0; b < R; ++b) tp.bits[g][b] = static_cast<uint8_t>(plan[i++]);
        tp.contiguous[g] = static_cast<uint8_t>(plan[i++]);
        tp.end[g] = static_cast<uint8_t>(plan[i++]);
      }
      for (int p = 0; p < np; ++p) {
        tp.q[p] = static_cast<uint8_t>(plan[i++]);
        tp.k[p] = static_cast<uint8_t>(plan[i++]);
        tp.qk[p] = static_cast<uint8_t>(plan[i++]);
      }
      err = payload ? launch_tile_r<K, true>(R, keys, payload, n, t, tp, done, stream)
                    : launch_tile_r<K, false>(R, keys, nullptr, n, t, tp, done, stream);
    } else {
      return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace

int tpubz::bitonic_run_i64(void* keys, void* payload, int n, const int* plan, int plan_len,
                           int* launched, const int* done, cudaStream_t stream) {
  return run_plan<int64_t>(keys, payload, n, plan, plan_len, launched, done, stream);
}

// keys (and payload, int32, or null for keys only): device pointers to n
// contiguous elements, 16-byte aligned, n a power of two up to 2^20. Runs
// the plan (a host array of plan_len ints) in place on `stream`, writes the
// number of kernel launches to *launched and returns cudaGetLastError() as
// an int (0 on success).
extern "C" int tpubz_bitonic_run_i32(void* keys, void* payload, int n, const int* plan,
                                     int plan_len, int* launched, void* stream) {
  *launched = 0;
  return run_plan<int32_t>(keys, payload, n, plan, plan_len, launched, nullptr,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int tpubz_bitonic_run_i64(void* keys, void* payload, int n, const int* plan,
                                     int plan_len, int* launched, void* stream) {
  *launched = 0;
  return tpubz::bitonic_run_i64(keys, payload, n, plan, plan_len, launched, nullptr,
                                static_cast<cudaStream_t>(stream));
}
