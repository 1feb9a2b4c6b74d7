// One phase of the megaspace halo exchange, for Hopper (sm_90a).
//
// Replaces: goworld_tpu/parallel/halo.py:91 _async_ship, the TPU kernel
// in which every device starts one make_async_remote_copy of its packed
// strip (i32[H, 5]: pos bits, yaw bits, a gid/dirty/valid meta word)
// into the receive buffer of device (d + shift) % n_dev, over a periodic
// ring, and waits on a send/recv semaphore pair; receivers that take no
// part (world-edge tiles) then zero their block, which makes the result
// equal to lax.ppermute with its fill.
//
// The TPU ships one contiguous buffer because that is what a remote DMA
// moves. Here every tile lives in one tensor on one card, so one launch
// does the whole phase: both ship directions for all tiles, reading each
// strip row where it lies and writing the five ghost lanes of the
// receiver in place. For receiver r, direction k and row j < H, with
// t = (r - shift_k) mod n_dev, v = recv_k(r) && j < min(count_k[t], H),
// s = flat_k[t, j] and c = col0 + k*H + j:
//
//   gvalid[r, c] = v
//   gpos  [r, c] = v ? pos[t, s] : 0            (3 words, copied as bits)
//   gdirty[r, c] = v && dirty[t, s]
//   gyaw  [r, c] = gdirty[r, c] ? yaw[t, s] : 0
//   ggid  [r, c] = v ? gid[t, s] : 0
//
// The source has two segments: slot s < M reads the tile's own lanes,
// slot s >= M reads row s - M of the output block itself (its columns
// [0, col0), which the previous phase's launch wrote; phase 2 of the 2D
// exchange sees the phase-1 ghosts so). The columns written, [col0,
// col0 + 2H), never overlap the ones read.
//
// What bounds it on this card: launch latency. At the 2^20-entity 2x2
// megaspace a phase moves ~0.8 MB in and ~0.7 MB out, ~0.0005 ms at
// 3.35 TB/s, below the few microseconds any launch costs. So the design
// cuts launches and the host's work around them: one launch a phase
// (it replaces the parent's pack, ring shift, unpack and cat ops), and a
// parameter struct of scalars only, passed by value: base pointers and
// row counts (every lane is contiguous over its rows, so a tile's stride
// follows from them), and per direction the shift, the receivers as a
// bitmask, and the extraction's flat/count pointers. No pointer table is
// built on the host and the host never waits. Tiles on several cards
// would need one pointer per tile again (peer placement).
//
// Grid (row chunks of H, receiver tile, direction), one thread per output
// row: a warp's stores are contiguous, and flat ascends within a (tile,
// direction), so a warp's gathers move forward through the source.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 64;   // bits of a receiver mask

struct Direction {
  const int* flat;               // [n_dev, flat_stride], first H used
  const int* count;              // [n_dev]
  long long flat_stride;         // elements between tiles' rows
  unsigned long long recv;       // bit r: tile r receives
  int shift;                     // in [0, n_dev)
};

struct PhaseParams {
  // segment 0: the tiles' own lanes, m rows a tile
  const uint32_t* pos;           // [n_dev, m, 3] f32 bits
  const uint32_t* yaw;           // [n_dev, m] f32 bits
  const uint8_t* dirty;          // [n_dev, m] bool
  const int* gid;                // [n_dev, m]
  // the output block, g rows a tile; also segment 1 (columns [0, col0))
  uint32_t* gpos;                // [n_dev, g, 3]
  uint32_t* gyaw;                // [n_dev, g]
  uint8_t* gdirty;               // [n_dev, g]
  uint8_t* gvalid;               // [n_dev, g]
  int* ggid;                     // [n_dev, g]
  Direction dir[2];
  int m, g, h, n_dev, col0;
};

__global__ void __launch_bounds__(kThreads)
halo_ship_phase(const __grid_constant__ PhaseParams p) {
  const int k = blockIdx.z;
  const int r = blockIdx.y;
  const Direction& d = p.dir[k];
  int t = r - d.shift;
  if (t < 0) t += p.n_dev;
  __shared__ int s_live;         // rows of the strip this receiver takes
  if (threadIdx.x == 0) {
    const int c = d.count[t];
    s_live = ((d.recv >> r) & 1ull) ? (c < p.h ? c : p.h) : 0;
  }
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= p.h) return;
  const bool v = j < s_live;
  uint32_t x = 0, y = 0, z = 0, yaw = 0;
  int gid = 0;
  bool dirty = false;
  if (v) {
    const long long s = d.flat[t * d.flat_stride + j];
    const uint32_t *pos, *yw;
    const uint8_t* dt;
    const int* gd;
    long long row;
    if (s < p.m) {
      row = static_cast<long long>(t) * p.m + s;
      pos = p.pos; yw = p.yaw; dt = p.dirty; gd = p.gid;
    } else {
      row = static_cast<long long>(t) * p.g + (s - p.m);
      pos = p.gpos; yw = p.gyaw; dt = p.gdirty; gd = p.ggid;
    }
    x = pos[3 * row];
    y = pos[3 * row + 1];
    z = pos[3 * row + 2];
    dirty = dt[row] != 0;
    if (dirty) yaw = yw[row];
    gid = gd[row];
  }
  const long long o = static_cast<long long>(r) * p.g + p.col0 +
                      static_cast<long long>(k) * p.h + j;
  p.gpos[3 * o] = x;
  p.gpos[3 * o + 1] = y;
  p.gpos[3 * o + 2] = z;
  p.gyaw[o] = yaw;
  p.gdirty[o] = dirty;
  p.gvalid[o] = v;
  p.ggid[o] = gid;
}

}  // namespace

extern "C" {

// One phase: own lanes pos/yaw/dirty/gid of m rows a tile, the output
// lanes of g rows a tile (written at columns [col0, col0 + 2h)), and per
// direction k the extraction (flat_k, its tile stride, count_k), the
// shift in [0, n_dev) and the receiver bitmask. Returns the CUDA error of
// the launch (0 = none).
int gw_halo_ship_phase(const void* pos, const void* yaw, const void* dirty,
                       const void* gid, int m, void* gpos, void* gyaw,
                       void* gdirty, void* gvalid, void* ggid, int g,
                       int n_dev, int h, int col0,
                       const void* flat0, long long flat_stride0,
                       const void* count0, int shift0,
                       unsigned long long recv0,
                       const void* flat1, long long flat_stride1,
                       const void* count1, int shift1,
                       unsigned long long recv1, void* stream) {
  if (n_dev < 1 || n_dev > kMaxTiles || m < 0 || h < 0 || col0 < 0 ||
      static_cast<long long>(col0) + 2ll * h > g || shift0 < 0 ||
      shift0 >= n_dev || shift1 < 0 || shift1 >= n_dev)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0) return static_cast<int>(cudaGetLastError());
  PhaseParams p;
  p.pos = static_cast<const uint32_t*>(pos);
  p.yaw = static_cast<const uint32_t*>(yaw);
  p.dirty = static_cast<const uint8_t*>(dirty);
  p.gid = static_cast<const int*>(gid);
  p.gpos = static_cast<uint32_t*>(gpos);
  p.gyaw = static_cast<uint32_t*>(gyaw);
  p.gdirty = static_cast<uint8_t*>(gdirty);
  p.gvalid = static_cast<uint8_t*>(gvalid);
  p.ggid = static_cast<int*>(ggid);
  p.dir[0] = {static_cast<const int*>(flat0), static_cast<const int*>(count0),
              flat_stride0, recv0, shift0};
  p.dir[1] = {static_cast<const int*>(flat1), static_cast<const int*>(count1),
              flat_stride1, recv1, shift1};
  p.m = m;
  p.g = g;
  p.h = h;
  p.n_dev = n_dev;
  p.col0 = col0;
  const dim3 grid((h + kThreads - 1) / kThreads, n_dev, 2);
  halo_ship_phase<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
