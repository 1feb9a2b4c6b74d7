// Stable sort of entity slots by grid-cell row, for Hopper (sm_90a).
//
// Replaces: goworld_tpu/ops/sort.py:157 counting_sort_cells_pallas, the
// TPU kernel that computes pass 3 of a stable counting sort,
// dst[i] = row_start[key_i] + #{j < i : key_j == key_i}, with a per-bin
// fill histogram carried in VMEM across a sequential grid. Here the
// result is the same (order, sorted_row) pair: bit-identical to a stable
// argsort of the keys, which decides which entities a cell_cap overflow
// drops.
//
// Why an LSD radix sort: the TPU's 352,837-bin histogram (1.4 MB at the
// 1M-entity shape) is six times a block's shared memory, GPU blocks run
// in no order so nothing can carry a fill count from one block to the
// next, and an atomicAdd rank is not stable. So the sort is a chain of
// stable counting passes over digits of the key, low digit first; the
// caller picks the plan (passes x digit_bits, at most 8 bits a digit).
//
// What bounds it on this card: latency and launches, not bytes. At 2^20
// keys a pass moves 16 MB of (key, slot) pairs, most of it through the
// 50 MB L2, a few microseconds of traffic; but all 256 tiles of a pass
// run at once, so a pass takes one tile's chain of dependent steps
// (load, 16 ranking rounds, look-back, reorder, store), and each launch
// or single-block step adds to it. So the design spends as few launches
// and block-wide steps as it can (the one-sweep scheme of Merrill and
// Adinets, 2022):
//   1. radix_hist, once per call: every block counts the digits of ALL
//      passes of its keys in shared memory and adds its counts into one
//      global table with one atomic a bin; the last block to finish (an
//      atomic ticket) scans that table (passes x 2^digit_bits entries,
//      independent of n) into each pass's digit offsets.
//   2. radix_scatter, once per pass. A block takes its tile from an
//      atomic ticket (so every earlier tile is already running and the
//      look-back below always makes progress), loads its 4096 keys into
//      registers, and ranks them stably: a warp ranks its lanes among
//      equal digits (found with one ballot a digit bit, faster here than
//      __match_any_sync), round by round in index order, and the warps
//      are combined in warp order. It publishes its digit counts (flag
//      AGGREGATE), looks back over its predecessors' records, kWindow at
//      a time, until it meets an INCLUSIVE prefix, and publishes its own.
//      It then reorders the tile by digit in shared memory, so that
//      neighbouring threads store neighbouring slots of one digit's run
//      at offset + prefix + rank.
// So a call is passes + 1 kernels and one memset; a composition of
// stable passes from the low digit up is a stable sort.
//
// Several Spaces in one call: the keys are S Spaces' rows laid end to
// end, n_per each. The kernels read key i of Space s = i / n_per as
// s * key_stride + row (key_stride = n_rows + 1), so one stable sort of
// those Space-major keys is the S per-Space sorts laid end to end; the
// last pass writes each Space's own order and rows back (less s * n_per
// and s * key_stride). The launches are the same for any S.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxDigitBits = 8;
constexpr int kMaxBins = 1 << kMaxDigitBits;
constexpr int kHistThreads = 1024;
constexpr int kHistItems = 8;               // keys a thread loads at once
constexpr int kHistKeysPerBlock = kHistItems * kHistThreads;
constexpr int kHistMaxBlocks = 128;
constexpr int kHistMaxEntries = 4096;       // passes x bins of the plan
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // keys per thread of a tile
constexpr int kTile = kThreads * kItems;    // 4096 keys a tile
constexpr int kWindow = 4;                  // look-back records read at once
constexpr unsigned kFlagAggregate = 1u << 30;
constexpr unsigned kFlagPrefix = 2u << 30;
constexpr unsigned kValueMask = kFlagAggregate - 1u;

// The lanes whose digit equals this lane's, from one ballot a bit
// (dbits + 1 bits: lanes past n carry the digit `bins`); on this card it
// is faster than __match_any_sync.
__device__ __forceinline__ unsigned match_digit(unsigned d, int dbits) {
  unsigned peers = 0xffffffffu;
  for (int b = 0; b <= dbits; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Key i of the caller's rows as a Space-major key: Space i / n_per's
// rows shifted by key_stride each (key_stride 0: one Space).
__device__ __forceinline__ int space_key(const int* keys, int i, int n_per,
                                         int key_stride) {
  const int k = keys[i];
  return key_stride != 0 ? k + (i / n_per) * key_stride : k;
}

// Digit histograms of every pass, then (last block) their exclusive
// scans in place: hist[p * bins + d] becomes the first output position
// of digit d in pass p. hist and ticket come in zeroed.
__global__ void __launch_bounds__(kHistThreads)
radix_hist(const int* __restrict__ keys, int n, int n_per, int key_stride,
           int passes, int dbits, int* __restrict__ hist,
           unsigned* __restrict__ ticket) {
  __shared__ int h[kHistMaxEntries];
  __shared__ int warp_sums[kHistThreads / 32];
  __shared__ bool last;
  const int bins = 1 << dbits;
  const unsigned mask = bins - 1;
  const int total = passes * bins;
  for (int e = threadIdx.x; e < total; e += kHistThreads) h[e] = 0;
  __syncthreads();
  for (int base = blockIdx.x * kHistKeysPerBlock; base < n;
       base += gridDim.x * kHistKeysPerBlock) {
    unsigned key[kHistItems];  // all loads first, then the counts
#pragma unroll
    for (int u = 0; u < kHistItems; ++u) {
      const int i = base + u * kHistThreads + threadIdx.x;
      key[u] = i < n ? static_cast<unsigned>(
                           space_key(keys, i, n_per, key_stride))
                     : 0u;
    }
#pragma unroll
    for (int u = 0; u < kHistItems; ++u) {
      if (base + u * kHistThreads + threadIdx.x >= n) break;
      for (int p = 0; p < passes; ++p)
        atomicAdd(&h[p * bins + ((key[u] >> (p * dbits)) & mask)], 1);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += kHistThreads)
    if (h[e] != 0) atomicAdd(&hist[e], h[e]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = 0; p < passes; ++p) {  // bins <= kHistThreads: one a thread
    int* row = hist + p * bins;
    const int x = threadIdx.x < bins ? __ldcg(row + threadIdx.x) : 0;
    int v = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += t;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    if (threadIdx.x < bins)
      row[threadIdx.x] = v - x + (warp > 0 ? warp_sums[warp - 1] : 0);
    __syncthreads();
  }
}

// One stable counting pass by the digit (key >> shift) & (bins - 1).
// vals_in == nullptr means the identity permutation (the first pass).
// status (tiles x bins) and ticket come in zeroed. stride_in != 0: the
// keys come in as the caller's rows (the first pass of several Spaces);
// stride_out != 0: the pass writes Space-local rows and slots (the last).
__global__ void __launch_bounds__(kThreads)
radix_scatter(const int* __restrict__ keys_in,
              const int* __restrict__ vals_in, int n, int n_per,
              int stride_in, int stride_out, int shift, int dbits,
              const int* __restrict__ offsets, unsigned* __restrict__ status,
              unsigned* __restrict__ ticket, int* __restrict__ keys_out,
              int* __restrict__ vals_out) {
  // wcnt[w][d]: warp w's count of digit d, then its exclusive prefix over
  // the warps before it. Once every key knows its place in the tile, the
  // same memory holds the tile's keys and slots in digit order.
  __shared__ union {
    int wcnt[kWarps][kMaxBins];
    struct {
      int keys[kTile];
      int vals[kTile];
    } sorted;
  } sh;
  __shared__ int tile_excl[kMaxBins];  // the tile's first slot of digit d
  __shared__ int out_base[kMaxBins];   // its global slot, less tile_excl
  __shared__ int thread_sums[kThreads];
  __shared__ int tile_sh;
  const int bins = 1 << dbits;
  const unsigned mask = bins - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  if (threadIdx.x == 0) tile_sh = static_cast<int>(atomicAdd(ticket, 1u));
  for (int e = threadIdx.x; e < kWarps * bins; e += kThreads)
    sh.wcnt[e >> dbits][e & mask] = 0;
  __syncthreads();
  const int tile = tile_sh;
  const int tile_n = min(kTile, n - tile * kTile);
  const int first = tile * kTile + warp * (32 * kItems) + lane;

  int key[kItems], val[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + 32 * j;
    key[j] = i < n ? space_key(keys_in, i, n_per, stride_in) : 0;
    val[j] = i < n ? (vals_in != nullptr ? vals_in[i] : i) : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool in = first + 32 * j < n;
    // lanes past n get a digit of their own (bins) and are never counted
    const unsigned d =
        in ? (static_cast<unsigned>(key[j]) >> shift) & mask : bins;
    const unsigned peers = match_digit(d, dbits);
    const int lrank = __popc(peers & lanemask_lt);
    const int before = in ? sh.wcnt[warp][d] : 0;
    __syncwarp();
    if (in && lrank == 0) sh.wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + lrank;
  }
  __syncthreads();

  // each thread owns `per` consecutive digits: their warp prefixes, the
  // tile's counts (published at once: the inclusive prefix for tile 0),
  // and the tile's exclusive scan over digits
  const int per = (bins + kThreads - 1) / kThreads;
  const int d0 = threadIdx.x * per;
  int own = 0;
  for (int d = d0; d < min(d0 + per, bins); ++d) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = sh.wcnt[w][d];
      sh.wcnt[w][d] = s;
      s += c;
    }
    tile_excl[d] = own;
    out_base[d] = s;
    own += s;
    store_relaxed(status + static_cast<size_t>(tile) * bins + d,
                  (tile == 0 ? kFlagPrefix : kFlagAggregate) |
                      static_cast<unsigned>(s));
  }
  thread_sums[threadIdx.x] = own;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the kThreads sums, 8 a lane
    constexpr int kPerLane = kThreads / 32;
    int v[kPerLane], run = 0;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      v[u] = thread_sums[lane * kPerLane + u];
      run += v[u];
    }
    int incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    run = incl - run;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      thread_sums[lane * kPerLane + u] = run;
      run += v[u];
    }
  }
  __syncthreads();
  // decoupled look-back over windows of kWindow predecessors, whose
  // records are read together
  for (int d = d0; d < min(d0 + per, bins); ++d) {
    tile_excl[d] += thread_sums[threadIdx.x];
    unsigned excl = 0;
    for (int t = tile - 1; t >= 0;) {
      unsigned v[kWindow];
#pragma unroll
      for (int w = 0; w < kWindow; ++w)
        v[w] = t - w >= 0
                   ? load_relaxed(status + static_cast<size_t>(t - w) * bins +
                                  d)
                   : kFlagPrefix;
      int w = 0;
      bool done = false;
#pragma unroll
      for (int u = 0; u < kWindow; ++u) {
        if (done || v[u] == 0) break;
        excl += v[u] & kValueMask;
        done = (v[u] & kFlagPrefix) != 0;
        w = u + 1;
      }
      if (done) break;
      t -= w;  // on from the first record not yet published
    }
    if (tile > 0)
      store_relaxed(status + static_cast<size_t>(tile) * bins + d,
                    kFlagPrefix | (excl + static_cast<unsigned>(out_base[d])));
    out_base[d] = offsets[d] + static_cast<int>(excl) - tile_excl[d];
  }
  __syncthreads();
  // every key's place in the tile, then the tile in digit order
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (first + 32 * j < n) {
      const unsigned d = (static_cast<unsigned>(key[j]) >> shift) & mask;
      rank[j] += tile_excl[d] + sh.wcnt[warp][d];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (first + 32 * j < n) {
      sh.sorted.keys[rank[j]] = key[j];
      sh.sorted.vals[rank[j]] = val[j];
    }
  }
  __syncthreads();
  // neighbouring threads write neighbouring slots of one digit's run
  for (int i = threadIdx.x; i < tile_n; i += kThreads) {
    const int k = sh.sorted.keys[i];
    const int dst = out_base[(static_cast<unsigned>(k) >> shift) & mask] + i;
    const int sp = stride_out != 0 ? dst / n_per : 0;
    keys_out[dst] = k - sp * stride_out;
    vals_out[dst] = sh.sorted.vals[i] - sp * n_per;
  }
}

size_t tiles_of(int n) { return (static_cast<size_t>(n) + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// Ints of scratch that gw_counting_sort needs for n keys under a plan:
// ping-pong keys and slots (2n), the digit table, the tickets and the
// look-back records.
long long gw_counting_sort_scratch_len(int n, int passes, int digit_bits) {
  const size_t bins = size_t{1} << digit_bits;
  return static_cast<long long>(2 * static_cast<size_t>(n) + passes * bins +
                                1 + passes + passes * tiles_of(n) * bins);
}

// Stable sort of keys srow[0..n) in [0, 2^(passes * digit_bits)) with
// n < 2^30: order is the permutation (a stable argsort) and
// sorted_row = srow[order]. With spaces > 1 and key_stride > 0, srow
// holds `spaces` Spaces' rows of n / spaces keys each, every key in
// [0, key_stride), and each Space is sorted on its own: order and
// sorted_row hold each Space's local slots and rows in its own block
// (the plan must cover spaces * key_stride - 1). scratch holds
// scratch_len ints (at least gw_counting_sort_scratch_len). Launches
// passes + 1 kernels and one memset on `stream`; returns a CUDA error
// code (cudaErrorInvalidValue for a plan, split or scratch the kernels
// do not take).
int gw_counting_sort(const int* srow, int n, int spaces, int key_stride,
                     int passes, int digit_bits, int* scratch,
                     long long scratch_len, int* order, int* sorted_row,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int bins = 1 << digit_bits;
  if (digit_bits < 1 || digit_bits > kMaxDigitBits || passes < 1 ||
      (passes - 1) * digit_bits > 31 || passes * bins > kHistMaxEntries ||
      n >= (1 << 30) || spaces < 1 || n % spaces != 0 || key_stride < 0 ||
      (spaces > 1) != (key_stride > 0) ||
      scratch_len < gw_counting_sort_scratch_len(n, passes, digit_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_per = n / spaces;
  const size_t tiles = tiles_of(n);
  int* tmp_keys = scratch;
  int* tmp_vals = scratch + n;
  int* hist = scratch + 2 * static_cast<size_t>(n);
  unsigned* tickets = reinterpret_cast<unsigned*>(hist + passes * bins);
  unsigned* status = tickets + 1 + passes;
  const size_t zeroed = passes * bins + 1 + passes + passes * tiles * bins;
  cudaError_t err = cudaMemsetAsync(hist, 0, zeroed * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hist_blocks =
      std::min((n + kHistKeysPerBlock - 1) / kHistKeysPerBlock,
               kHistMaxBlocks);
  radix_hist<<<hist_blocks, kHistThreads, 0, s>>>(
      srow, n, n_per, key_stride, passes, digit_bits, hist, tickets);
  // pass p writes the outputs when passes - 1 - p is even, the scratch
  // pair otherwise, so the last pass lands in (sorted_row, order)
  const int* kin = srow;
  const int* vin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    int* kout = to_out ? sorted_row : tmp_keys;
    int* vout = to_out ? order : tmp_vals;
    radix_scatter<<<static_cast<int>(tiles), kThreads, 0, s>>>(
        kin, vin, n, n_per, p == 0 ? key_stride : 0,
        p == passes - 1 ? key_stride : 0, p * digit_bits, digit_bits,
        hist + p * bins, status + p * tiles * bins, tickets + 1 + p, kout,
        vout);
    kin = kout;
    vin = vout;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
