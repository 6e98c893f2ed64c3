// Bitonic sorting network over one array of 2^m keys (m <= 20), keys-only
// or carrying an int32 payload, and runs of its passes.
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
// Design. The TPU kernels held all 2^20 keys in VMEM for the whole network;
// an SM has at most 227 KB of shared memory, so here the network is cut by
// distance:
//   - bitonic_tile loads a tile of T = min(2048, 2^m) keys (1024 threads, one
//     pair each) into shared memory, runs a list of passes whose distance is
//     below T there, and writes back. A pair at distance < T never leaves
//     its T-aligned tile, so the tiling does not change the network. It is
//     the counterpart of the lane passes (_cex_lane, mode "lane").
//   - bitonic_global_pass runs one pass at distance >= T from device memory,
//     one thread per pair: the counterpart of _cex_row (mode "row").
// The host code walks the pass list and folds every run of consecutive
// short passes into one tile launch: a sort of 2^20 keys is 1 tile launch
// for stages 1..11, then per stage k = 12..20 the k-11 global passes and one
// tile launch for its last 11 passes: 45 global and 10 tile launches.
//
// What bounds it on an H100: each global pass reads and writes the whole
// array (12 MB for int64 keys with an int32 payload), which the 50 MB L2
// holds, so the 45 global passes are bound by L2 bandwidth and by the launch
// of each; the tile kernel is bound by shared memory (one load and store of
// a pair per pass per thread, a barrier between passes) with 24 KB a block.
// Several global passes per launch, register exchanges and TMA are later
// work.
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace {

constexpr int kTile = 2048;          // keys per tile
constexpr int kGlobalThreads = 256;  // threads per block of a global pass
constexpr int kMaxTilePasses = 128;  // passes per tile launch

// the (k, j) passes of one tile launch, passed by value
struct TilePasses {
  int count;
  uint8_t k[kMaxTilePasses];
  uint8_t j[kMaxTilePasses];
};

// lower index of pair t at distance 2^j
__device__ __forceinline__ int pair_lo(int t, int j) {
  return ((t >> j) << (j + 1)) | (t & ((1 << j) - 1));
}

template <typename K, bool kPayload>
__global__ void __launch_bounds__(kTile / 2)
    bitonic_tile(K* __restrict__ keys, int32_t* __restrict__ payload,
                 TilePasses passes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = blockDim.x;
  const int tile = 2 * half;
  K* sk = reinterpret_cast<K*>(smem);
  int32_t* sp = reinterpret_cast<int32_t*>(sk + tile);
  const int t = threadIdx.x;
  const int base = blockIdx.x * tile;

  sk[t] = keys[base + t];
  sk[t + half] = keys[base + t + half];
  if constexpr (kPayload) {
    sp[t] = payload[base + t];
    sp[t + half] = payload[base + t + half];
  }
  __syncthreads();
  for (int p = 0; p < passes.count; ++p) {
    const int j = passes.j[p];
    const int k = passes.k[p];
    const int lo = pair_lo(t, j);
    const int hi = lo + (1 << j);
    const bool asc = (((base + lo) >> k) & 1) == 0;
    const K a = sk[lo];
    const K b = sk[hi];
    if (asc ? (b < a) : (a < b)) {
      sk[lo] = b;
      sk[hi] = a;
      if constexpr (kPayload) {
        const int32_t q = sp[lo];
        sp[lo] = sp[hi];
        sp[hi] = q;
      }
    }
    __syncthreads();
  }
  keys[base + t] = sk[t];
  keys[base + t + half] = sk[t + half];
  if constexpr (kPayload) {
    payload[base + t] = sp[t];
    payload[base + t + half] = sp[t + half];
  }
}

template <typename K, bool kPayload>
__global__ void __launch_bounds__(kGlobalThreads)
    bitonic_global_pass(K* __restrict__ keys, int32_t* __restrict__ payload,
                        int pairs, int j, int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const int lo = pair_lo(t, j);
  const int hi = lo + (1 << j);
  const bool asc = ((lo >> k) & 1) == 0;
  const K a = keys[lo];
  const K b = keys[hi];
  if (asc ? (b < a) : (a < b)) {
    keys[lo] = b;
    keys[hi] = a;
    if constexpr (kPayload) {
      const int32_t q = payload[lo];
      payload[lo] = payload[hi];
      payload[hi] = q;
    }
  }
}

int log2_of(int n) {
  int m = 0;
  while ((1 << m) < n) ++m;
  return m;
}

// Runs passes (ks[p], js[p]), p = 0..count-1, in order on n = 2^m keys,
// counting kernel launches into *launched.
template <typename K, bool kPayload>
cudaError_t run_passes(K* keys, int32_t* payload, int n, const int* ks,
                       const int* js, int count, int* launched,
                       cudaStream_t stream) {
  const int tile = n < kTile ? n : kTile;
  const int log2_tile = log2_of(tile);
  const size_t smem = tile * (sizeof(K) + (kPayload ? sizeof(int32_t) : 0));
  int p = 0;
  while (p < count) {
    if (js[p] >= log2_tile) {
      const int pairs = n / 2;
      bitonic_global_pass<K, kPayload>
          <<<(pairs + kGlobalThreads - 1) / kGlobalThreads, kGlobalThreads, 0,
             stream>>>(keys, payload, pairs, js[p], ks[p]);
      ++p;
    } else {
      TilePasses passes;
      passes.count = 0;
      while (p < count && js[p] < log2_tile && passes.count < kMaxTilePasses) {
        passes.k[passes.count] = static_cast<uint8_t>(ks[p]);
        passes.j[passes.count] = static_cast<uint8_t>(js[p]);
        ++passes.count;
        ++p;
      }
      bitonic_tile<K, kPayload>
          <<<n / tile, tile / 2, smem, stream>>>(keys, payload, passes);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

template <typename K>
int sort_all(void* keys, void* payload, int n, int* launched, void* stream) {
  *launched = 0;
  const int m = log2_of(n);
  std::vector<int> ks, js;
  for (int k = 1; k <= m; ++k) {
    for (int j = k - 1; j >= 0; --j) {
      ks.push_back(k);
      js.push_back(j);
    }
  }
  const auto s = static_cast<cudaStream_t>(stream);
  K* kp = static_cast<K*>(keys);
  const int count = static_cast<int>(js.size());
  cudaError_t err;
  if (payload) {
    err = run_passes<K, true>(kp, static_cast<int32_t*>(payload), n, ks.data(),
                              js.data(), count, launched, s);
  } else {
    err = run_passes<K, false>(kp, nullptr, n, ks.data(), js.data(), count,
                               launched, s);
  }
  return static_cast<int>(err);
}

template <typename K>
int stage_all(void* keys, int n, const int* js, int count, int* launched,
              void* stream) {
  *launched = 0;
  // every pass ascending: bit m of an index below 2^m is 0
  const std::vector<int> ks(count > 0 ? count : 1, log2_of(n));
  return static_cast<int>(run_passes<K, false>(
      static_cast<K*>(keys), nullptr, n, ks.data(), js, count, launched,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// keys (and payload, int32, or null for keys only): device pointers to n
// contiguous elements, n a power of two up to 2^20. Sorts in place on
// `stream`, writes the number of kernel launches to *launched and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int tpubz_bitonic_sort_i32(void* keys, void* payload, int n,
                                      int* launched, void* stream) {
  return sort_all<int32_t>(keys, payload, n, launched, stream);
}

extern "C" int tpubz_bitonic_sort_i64(void* keys, void* payload, int n,
                                      int* launched, void* stream) {
  return sort_all<int64_t>(keys, payload, n, launched, stream);
}

// Ascending passes at distances 2^js[p] (host array of count ints, each
// below log2 n), in order, in place on n keys.
extern "C" int tpubz_bitonic_stage_i32(void* keys, int n, const int* js,
                                       int count, int* launched,
                                       void* stream) {
  return stage_all<int32_t>(keys, n, js, count, launched, stream);
}

extern "C" int tpubz_bitonic_stage_i64(void* keys, int n, const int* js,
                                       int count, int* launched,
                                       void* stream) {
  return stage_all<int64_t>(keys, n, js, count, launched, stream);
}
