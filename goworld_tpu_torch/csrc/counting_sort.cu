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
// What bounds it on this card: bytes and launches. At 2^20 keys each
// pass reads and writes 8 MB of (key, slot) pairs, about 5 us at
// 3.35 TB/s, so the few launches of a pass cost as much as its traffic.
//
// Why this design: the TPU design does not carry over. Its histogram has
// 352,837 bins at the 1M-entity shape (1.4 MB, over six times a block's
// shared memory), GPU blocks run in no order so nothing can carry a fill
// count from one block to the next, and an atomicAdd rank is not stable.
// So the sort is an LSD radix sort over the key's bits, 2-3 passes of at
// most 8-bit digits. Each pass is a stable counting sort over <= 256
// digit bins, in three kernels:
//   1. digit_hist: per-chunk digit histograms in shared memory, written
//      digit-major so that one exclusive scan gives every (digit, chunk)
//      its output offset;
//   2. exclusive_scan: one block scans the digit-major table;
//   3. digit_scatter: each block walks its chunk in order, 256 elements
//      at a time; a warp ranks its lanes among equal digits with
//      __match_any_sync and popc(peers & lanemask_lt), and the warps of
//      the block are combined in warp order through shared memory. The
//      rank is therefore the element's position among equal digits, and
//      each pass is stable.
// A composition of stable passes from the low digit up is a stable sort.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                   // elements per thread per chunk
constexpr int kChunk = kThreads * kItems;    // 4096 elements per block
constexpr int kMaxDigitBits = 8;
constexpr int kMaxBins = 1 << kMaxDigitBits;
constexpr int kScanThreads = 1024;

__global__ void digit_hist(const int* __restrict__ keys, int n, int shift,
                           int mask, int nblocks, int* __restrict__ hist) {
  __shared__ int h[kMaxBins];
  for (int d = threadIdx.x; d <= mask; d += kThreads) h[d] = 0;
  __syncthreads();
  const int base = blockIdx.x * kChunk;
  const int end = min(base + kChunk, n);
  for (int i = base + threadIdx.x; i < end; i += kThreads)
    atomicAdd(&h[(keys[i] >> shift) & mask], 1);
  __syncthreads();
  for (int d = threadIdx.x; d <= mask; d += kThreads)
    hist[d * nblocks + blockIdx.x] = h[d];
}

// In-place exclusive scan of m ints by one block: each thread sums a
// contiguous segment, the block scans the segment sums, then each thread
// rewrites its segment.
__global__ void exclusive_scan(int* __restrict__ data, int m) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (m + kScanThreads - 1) / kScanThreads;
  const int begin = threadIdx.x * per;
  const int end = min(begin + per, m);
  int local = 0;
  for (int i = begin; i < end; ++i) local += data[i];
  int v = local;  // inclusive scan across the warp
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
  int run = v - local + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = begin; i < end; ++i) {
    const int x = data[i];
    data[i] = run;
    run += x;
  }
}

// One stable counting-sort pass by the digit (key >> shift) & mask.
// vals_in == nullptr means the identity permutation (the first pass).
__global__ void digit_scatter(const int* __restrict__ keys_in,
                              const int* __restrict__ vals_in, int n,
                              int shift, int mask, int nblocks,
                              const int* __restrict__ offsets,
                              int* __restrict__ keys_out,
                              int* __restrict__ vals_out) {
  // running output position of each digit in this chunk; the extra bin
  // (mask + 1) collects the lanes past n
  __shared__ int run[kMaxBins + 1];
  __shared__ int wcnt[kWarps][kMaxBins + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  for (int d = threadIdx.x; d <= mask; d += kThreads)
    run[d] = offsets[d * nblocks + blockIdx.x];
  for (int i = threadIdx.x; i < kWarps * (kMaxBins + 1); i += kThreads)
    (&wcnt[0][0])[i] = 0;
  __syncthreads();
  const int base = blockIdx.x * kChunk;
  for (int t = 0; t < kItems; ++t) {
    const int tile = base + t * kThreads;
    if (tile >= n) break;  // uniform across the block
    const int i = tile + threadIdx.x;
    const bool in = i < n;
    int key = 0, val = 0, d = mask + 1;
    if (in) {
      key = keys_in[i];
      val = vals_in ? vals_in[i] : i;
      d = (key >> shift) & mask;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int lrank = __popc(peers & lanemask_lt);
    if (lrank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    if (in) {
      int r = run[d] + lrank;
      for (int w = 0; w < warp; ++w) r += wcnt[w][d];
      keys_out[r] = key;
      vals_out[r] = val;
    }
    __syncthreads();
    for (int dd = threadIdx.x; dd <= mask + 1; dd += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) {
        s += wcnt[w][dd];
        wcnt[w][dd] = 0;
      }
      if (dd <= mask) run[dd] += s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Scratch the caller allocates: tmp_keys and tmp_vals of 2*n ints, and
// hist of gw_counting_sort_hist_len(n, key_bits) ints.
int gw_counting_sort_hist_len(int n, int key_bits) {
  const int bits = key_bits < 1 ? 1 : key_bits;
  const int passes = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  const int dbits = (bits + passes - 1) / passes;
  const int nblocks = (n + kChunk - 1) / kChunk;
  return (1 << dbits) * (nblocks > 0 ? nblocks : 1);
}

// Stable sort of keys srow[0..n) in [0, 2^key_bits): order is the
// permutation (a stable argsort) and sorted_row = srow[order].
int gw_counting_sort(const int* srow, int n, int key_bits, int* tmp_keys,
                     int* tmp_vals, int* hist, int* order, int* sorted_row,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int bits = key_bits < 1 ? 1 : key_bits;
  const int passes = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  const int dbits = (bits + passes - 1) / passes;
  const int mask = (1 << dbits) - 1;
  const int nblocks = (n + kChunk - 1) / kChunk;
  for (int p = 0; p < passes; ++p) {
    const int* kin = p == 0 ? srow : tmp_keys + ((p - 1) & 1) * n;
    const int* vin = p == 0 ? nullptr : tmp_vals + ((p - 1) & 1) * n;
    const bool last = p == passes - 1;
    int* kout = last ? sorted_row : tmp_keys + (p & 1) * n;
    int* vout = last ? order : tmp_vals + (p & 1) * n;
    const int shift = p * dbits;
    digit_hist<<<nblocks, kThreads, 0, s>>>(kin, n, shift, mask, nblocks,
                                            hist);
    exclusive_scan<<<1, kScanThreads, 0, s>>>(hist, (mask + 1) * nblocks);
    digit_scatter<<<nblocks, kThreads, 0, s>>>(kin, vin, n, shift, mask,
                                               nblocks, hist, kout, vout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
