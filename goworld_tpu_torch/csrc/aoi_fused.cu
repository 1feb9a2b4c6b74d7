// Fused AOI back half for Hopper (sm_90a): window gather, key pack and
// top-k selection in one kernel.
//
// Replaces: goworld_tpu/ops/aoi.py:919 _sweep_fused, the TPU kernel that
// stages the whole cell-sorted world in VMEM, slices each query's three
// contiguous z-triple runs of 3*cell_cap lanes, packs (distance, id,
// flags) ranking keys and keeps the k smallest by unrolled min-extract.
// The output is the same: each query row's k smallest packed keys in
// ascending order (invalid keys pad the tail), and under stats the count
// of valid candidates (the demand gauge).
//
// What bounds it on this card: instruction issue and the latency of each
// warp's chain of dependent reads, not bytes or stores. The call moves
// ~190 MB (the [N, k] keys are 134 MB of it at k = 32), some 57 us at
// 3.35 TB/s, and a copy without the key stores is only ~1% faster; a
// bench query has ~27 in-range candidates among the 108 lanes of its
// 3x3 window and ~12 valid ones. So the design spends few instructions
// a row and keeps the run reads in L1:
//
// 1. Rows are walked in cell order. Work item i handles row
//    s_w[i] >> id_shift (skipped when >= q): the sorted view's slot words
//    are a permutation of [0, n), so every query row is visited once.
//    A warp takes 32 consecutive items, i.e. ~10 neighbouring cells along
//    z; the three rows of a cell read the same three runs and the next
//    cell shares two of them, so most run reads hit L1. The output stays
//    indexed by row, one full 128-byte line a row at k = 32.
// 2. Candidates are packed onto the lanes: candidate c is the c-th
//    in-range lane of the row's three runs, so the bench row's ~27
//    candidates take one round of 32 lanes instead of four rounds over
//    the 108 lanes of the 3x3 window, with no divide. A row's run
//    bounds, position and reach come in with one load a lane, spread by
//    shuffles, and are fetched while the row before is worked on.
// 3. Selection without k rounds: the valid keys are compacted across the
//    warp by ballot and prefix popcount into 32 shared-memory slots; when
//    the row's demand is <= 32 (all but ~1 row in 2^20 at the bench
//    shape) one key a lane is sorted by the 15-step bitonic network of
//    __shfl_xor_sync compare-exchanges, cut after the first stage whose
//    blocks hold all `demand` keys (10 steps at demand <= 16), and
//    written with one coalesced store (the invalid key pads the rest). A
//    row with demand > 32 takes the warp-minimum rounds on its register
//    keys instead, on a warp-uniform branch of the same kernel. Valid
//    keys are unique (their id bits differ), so both give
//    sort(keys)[:k] exactly. The demand gauge is the sum of the ballots'
//    popcounts, the count of valid candidates the plain version sums.
//
// 4. Several Spaces in one launch: blockIdx.y is the Space, whose
//    sorted view, runs, positions, reach and outputs lie at its own
//    offset (the caller's lanes carry a leading [S] axis). Ids stay
//    Space-local, so the keys are those of S separate launches.
//
// 5. A device gate (the Verlet rebuild decision, computed on the card):
//    every block reads it first and leaves when it is 0, so a tick that
//    reuses its candidate cache pays one empty launch and the outputs
//    keep what the last open launch wrote. A null gate always runs.
//
// Exactness traps kept here: the slot words come in as an int32 array
// (as float bit patterns they would be subnormal and a flush-to-zero
// float op would zero them), the key scale arrives as the float32 the
// JAX encoder rounds to, the product is rounded to nearest and the
// float-to-int cast truncates, and the file is built without fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItemsPerWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

struct KeyCode {
  int id_shift;     // slot id = word >> id_shift (2 when flags ride it)
  int qd_shift;     // quantized distance sits at bit qd_shift of the key
  int qd_cap;       // quantized distance clamp before the bias
  int qd_bias;      // 1 on the 8-bit encoding (keeps f32 keys normal)
  float scale;      // float32(levels / qmax)
  int invalid_key;  // ranks above every valid key
};

// PER: rounds of 32 candidates a row can need (9 * cell_cap / 32)
template <int PER>
__global__ void __launch_bounds__(kThreads)
sweep_fused_kernel(const float* __restrict__ s_xz,
                   const int* __restrict__ sw, int s_len, int n_items,
                   const int* __restrict__ lo,
                   const int* __restrict__ hi,
                   const float* __restrict__ pos,
                   const float* __restrict__ reach, int q, int k, int cc,
                   int sentinel, KeyCode code,
                   const int* __restrict__ gate, int* __restrict__ top,
                   int* __restrict__ dem) {
  if (gate != nullptr && *gate == 0) return;  // the whole block leaves
  // this block's Space: every lane at its own offset
  const size_t space = blockIdx.y;
  const float* __restrict__ spx = s_xz + space * 2 * s_len;
  const float* __restrict__ spz = spx + s_len;
  sw += space * s_len;
  lo += space * q * 3;
  hi += space * q * 3;
  pos += space * sentinel * 3;
  reach += space * sentinel;
  top += space * q * k;
  if (dem != nullptr) dem += space * q;
  __shared__ int packed[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int first = (blockIdx.x * kWarps + warp) * kItemsPerWarp;
  if (first >= n_items) return;  // the whole warp leaves together
  const int run = 3 * cc;
  const int items = min(kItemsPerWarp, n_items - first);
  const int words = lane < items ? sw[first + lane] : 0;
  auto row_of = [&](int t) {
    return __shfl_sync(kFull, words, t) >> code.id_shift;
  };
  // a row's run starts (lanes 0-2), run ends (3-5), x and z (6-7) and
  // reach (8), one word a lane
  auto fetch = [&](int row) {
    int v = 0;
    if (row < q) {
      if (lane < 3) {
        v = lo[3 * row + lane];
      } else if (lane < 6) {
        v = hi[3 * row + lane - 3];
      } else if (lane < 8) {
        v = __float_as_int(pos[3 * row + 2 * (lane - 6)]);
      } else if (lane == 8) {
        v = __float_as_int(reach[row]);
      }
    }
    return v;
  };
  int next_row = row_of(0);
  int next = fetch(next_row);
  for (int t = 0; t < items; ++t) {
    const int row = next_row;
    const int v = next;
    if (t + 1 < items) {  // the next row's words load under this one
      next_row = row_of(t + 1);
      next = fetch(next_row);
    }
    if (row >= q) continue;  // a row past the queries (a ghost)
    // lanes 0-2: how many lanes of each run are in range (<= 3*cell_cap)
    const int len = min(__shfl_down_sync(kFull, v, 3) - v, run);
    const int lo0 = __shfl_sync(kFull, v, 0);
    const int lo1 = __shfl_sync(kFull, v, 1);
    const int lo2 = __shfl_sync(kFull, v, 2);
    const int n0 = __shfl_sync(kFull, len, 0);
    const int n01 = n0 + __shfl_sync(kFull, len, 1);
    const int total = n01 + __shfl_sync(kFull, len, 2);
    const float qx = __int_as_float(__shfl_sync(kFull, v, 6));
    const float qz = __int_as_float(__shfl_sync(kFull, v, 7));
    const float qr = __int_as_float(__shfl_sync(kFull, v, 8));
    // candidate c = 32 r + lane is the c-th in-range lane of the three
    // runs taken in order; a round past `total` is skipped
    int keys[PER];
    int demand = 0;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      keys[r] = code.invalid_key;
      if (32 * r >= total) continue;
      const int c = 32 * r + lane;
      bool ok = false;
      if (c < total) {
        const int s = c < n0 ? lo0 + c : c < n01 ? lo1 + c - n0
                                                 : lo2 + c - n01;
        const int w = sw[s];
        const int cid = w >> code.id_shift;
        const float dist = fmaxf(fabsf(__fsub_rn(spx[s], qx)),
                                 fabsf(__fsub_rn(spz[s], qz)));
        if (cid != sentinel && dist <= qr && cid != row) {
          int qd = __float2int_rz(__fmul_rn(dist, code.scale));
          qd = min(qd, code.qd_cap) + code.qd_bias;
          keys[r] = (qd << code.qd_shift) | w;
          ok = true;
        }
      }
      // compaction: the valid keys, in (r, lane) order, into slots 0..31
      const unsigned m = __ballot_sync(kFull, ok);
      const int at = demand + __popc(m & lanemask_lt);
      if (ok && at < 32) packed[warp][at] = keys[r];
      demand += __popc(m);
    }
    __syncwarp();
    if (dem != nullptr && lane == 0) dem[row] = demand;
    int* out = top + static_cast<size_t>(row) * k;
    if (demand <= 32) {
      int x = lane < demand ? packed[warp][lane] : code.invalid_key;
      // bitonic sort of the 32 lanes, ascending: after the stage of
      // `size`, blocks of `size` lanes are sorted, up where
      // (lane & size) == 0, and the lower lane of each pair keeps the
      // minimum there. The valid keys sit in lanes 0..demand-1 and the
      // rest hold the invalid key, so the stages stop once one block
      // holds them all.
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
        if (size / 2 >= demand) break;
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const int y = __shfl_xor_sync(kFull, x, stride);
          const bool up = (lane & size) == 0;
          const bool lower = (lane & stride) == 0;
          x = lower == up ? min(x, y) : max(x, y);
        }
      }
      if (lane < k) out[lane] = x;
      for (int r = 32 + lane; r < k; r += 32) out[r] = code.invalid_key;
    } else {
      // more valid keys than lanes: k rounds of a warp-wide minimum; the
      // lane that holds it retires it, and an invalid minimum ends the row
      for (int r = 0; r < k; ++r) {
        int m = keys[0];
#pragma unroll
        for (int j = 1; j < PER; ++j) m = min(m, keys[j]);
        m = __reduce_min_sync(kFull, m);
        if (m == code.invalid_key) {
          for (int rr = r + lane; rr < k; rr += 32)
            out[rr] = code.invalid_key;
          break;
        }
        if (lane == (r & 31)) out[r] = m;
#pragma unroll
        for (int j = 0; j < PER; ++j)
          if (keys[j] == m) keys[j] = code.invalid_key;
      }
    }
    __syncwarp();  // every lane has read `packed` before the next row
  }
}

template <int PER>
void launch(const float* s_xz, const int* s_w, int s_len, const int* lo,
            const int* hi, const float* pos, const float* reach, int q,
            int k, int cc, int sentinel, int spaces, KeyCode code,
            const int* gate, int* top, int* dem, cudaStream_t stream) {
  const int n_items = s_len - 3 * cc;
  const int per_block = kWarps * kItemsPerWarp;
  const dim3 blocks((n_items + per_block - 1) / per_block, spaces);
  sweep_fused_kernel<PER><<<blocks, kThreads, 0, stream>>>(
      s_xz, s_w, s_len, n_items, lo, hi, pos, reach, q, k, cc, sentinel,
      code, gate, top, dem);
}

}  // namespace

extern "C" {

// s_xz: f32 [2, s_len] sorted x / z rows (3*cc sentinel lanes at the
// end); s_w: i32 [s_len] packed slot words, whose first s_len - 3*cc
// ids (word >> id_shift) are a permutation of the rows; lo, hi: i32
// [q, 3] run bounds; pos: f32 [>= q, 3]; reach: f32 [>= q]; top: i32
// [q, k] out; dem: i32 [q] out, or null to skip the demand gauge;
// gate: i32 on the card, or null: when it reads 0 the launch writes
// nothing. With spaces > 1 every array holds that many Spaces laid end
// to end (s_xz [spaces, 2, s_len], ..., pos [spaces, sentinel, 3], top
// [spaces, q, k]), each swept on its own in the same launch. Returns the
// CUDA error code of the launch (cudaErrorInvalidValue when 9*cc > 256
// or spaces is out of range).
int gw_sweep_fused(const float* s_xz, const int* s_w, int s_len,
                   const int* lo, const int* hi, const float* pos,
                   const float* reach, int q, int k, int cc, int sentinel,
                   int spaces, int id_shift, int qd_shift, int qd_cap,
                   int qd_bias, float scale, int invalid_key,
                   const int* gate, int* top, int* dem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KeyCode code{id_shift, qd_shift, qd_cap, qd_bias, scale,
                     invalid_key};
  if (spaces < 1 || spaces > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q <= 0 || s_len <= 3 * cc) return static_cast<int>(cudaGetLastError());
  const int per = (9 * cc + 31) / 32;
#define GW_SWEEP_CASE(P)                                                  \
  case P:                                                                 \
    launch<P>(s_xz, s_w, s_len, lo, hi, pos, reach, q, k, cc, sentinel,   \
              spaces, code, gate, top, dem, s);                           \
    break;
  switch (per) {
    GW_SWEEP_CASE(1)
    GW_SWEEP_CASE(2)
    GW_SWEEP_CASE(3)
    GW_SWEEP_CASE(4)
    GW_SWEEP_CASE(5)
    GW_SWEEP_CASE(6)
    GW_SWEEP_CASE(7)
    GW_SWEEP_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GW_SWEEP_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
