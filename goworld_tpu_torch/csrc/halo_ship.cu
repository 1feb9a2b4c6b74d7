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
// slot s >= M reads row s - M of the tile's output block itself (its
// columns [0, col0), which the previous phase's launch wrote; phase 2 of
// the 2D exchange sees the phase-1 ghosts so). The columns written, [col0,
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
// A game of several controller processes holds tiles [tile0, tile0 +
// n_local) of the n_dev here: the lanes above hold those tiles only
// (tile t at row t - tile0), and the ring still turns over all n_dev. A
// leg whose sender and receiver live in different processes moves as
// words (i32[H, 5]: pos bits, yaw bits, meta = (gid + 1) << 2 | dirty <<
// 1 | valid), as the TPU kernel's buffer does. The sender's launch in
// pack mode gathers each of its crossing legs' strips from its own lanes
// (and ghost columns [0, col0)) and writes its words into row slot[sender]
// of the send buffer, every leg of the phase in one launch; the receiver's
// phase launch reads a receiver whose slot[receiver] is set from that row
// of the received buffer, valid where its meta says so, and writes the
// five lanes as above. The slots are a table by value in the parameters
// (-1: the leg stays in this process). On one controller tile0 = 0,
// n_local = n_dev and every slot is -1.
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
  const int* flat;               // [n_local, flat_stride], first H used
  const int* count;              // [n_local]
  const uint32_t* remote;        // ship: the received words [rows, H, 5]
  long long flat_stride;         // elements between tiles' rows
  unsigned long long recv;       // bit r: tile r (of n_dev) receives
  int shift;                     // in [0, n_dev)
  short slot[kMaxTiles];         // by local tile: its leg's row of the
                                 // received (ship) or send (pack) words
};

struct PhaseParams {
  // segment 0: the tiles' own lanes, m rows a tile
  const uint32_t* pos;           // [n_local, m, 3] f32 bits
  const uint32_t* yaw;           // [n_local, m] f32 bits
  const uint8_t* dirty;          // [n_local, m] bool
  const int* gid;                // [n_local, m]
  // the output block, g rows a tile; also segment 1 (columns [0, col0))
  uint32_t* gpos;                // [n_local, g, 3]
  uint32_t* gyaw;                // [n_local, g]
  uint8_t* gdirty;               // [n_local, g]
  uint8_t* gvalid;               // [n_local, g]
  int* ggid;                     // [n_local, g]
  uint32_t* send;                // pack: the words [rows, H, 5]
  Direction dir[2];
  int m, g, h, n_dev, col0, tile0;
};

// Row s of local tile tl's strip source: its own lanes (s < m) or row
// s - m of its ghost block.
__device__ __forceinline__ void gather_row(const PhaseParams& p, int tl,
                                           long long s, uint32_t& x,
                                           uint32_t& y, uint32_t& z,
                                           uint32_t& yaw, bool& dirty,
                                           int& gid) {
  const uint32_t *pos, *yw;
  const uint8_t* dt;
  const int* gd;
  long long row;
  if (s < p.m) {
    row = static_cast<long long>(tl) * p.m + s;
    pos = p.pos; yw = p.yaw; dt = p.dirty; gd = p.gid;
  } else {
    row = static_cast<long long>(tl) * p.g + (s - p.m);
    pos = p.gpos; yw = p.gyaw; dt = p.gdirty; gd = p.ggid;
  }
  x = pos[3 * row];
  y = pos[3 * row + 1];
  z = pos[3 * row + 2];
  dirty = dt[row] != 0;
  yaw = dirty ? yw[row] : 0u;
  gid = gd[row];
}

template <bool kPack>
__global__ void __launch_bounds__(kThreads)
halo_ship_phase(const __grid_constant__ PhaseParams p) {
  const int k = blockIdx.z;
  const int rl = blockIdx.y;     // local receiver (pack: local sender)
  const Direction& d = p.dir[k];
  const int slot = d.slot[rl];
  if (kPack) {
    if (slot < 0) return;        // no leg of this sender crosses
    const int c = d.count[rl];
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j >= p.h) return;
    const bool v = j < (c < p.h ? c : p.h);
    uint32_t x = 0, y = 0, z = 0, yaw = 0;
    int gid = -1;
    bool dirty = false;
    if (v) gather_row(p, rl, d.flat[rl * d.flat_stride + j], x, y, z, yaw,
                      dirty, gid);
    uint32_t* w = p.send + (static_cast<long long>(slot) * p.h + j) * 5;
    w[0] = x;
    w[1] = y;
    w[2] = z;
    w[3] = yaw;
    w[4] = (static_cast<uint32_t>(gid + 1) << 2) |
           (static_cast<uint32_t>(dirty) << 1) | static_cast<uint32_t>(v);
    return;
  }
  const int r = p.tile0 + rl;    // its tile of n_dev
  int t = r - d.shift;
  if (t < 0) t += p.n_dev;
  const bool afar = slot >= 0;
  const int tl = t - p.tile0;    // the sender's row here, when it is here
  __shared__ int s_live;         // rows of the strip this receiver takes
  if (threadIdx.x == 0) {
    const int c = afar ? p.h : d.count[tl];
    s_live = ((d.recv >> r) & 1ull) ? (c < p.h ? c : p.h) : 0;
  }
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= p.h) return;
  bool v = j < s_live;
  uint32_t x = 0, y = 0, z = 0, yaw = 0;
  int gid = 0;
  bool dirty = false;
  if (v && afar) {
    const uint32_t* w =
        d.remote + (static_cast<long long>(slot) * p.h + j) * 5;
    const uint32_t meta = w[4];
    v = (meta & 1u) != 0;
    if (v) {
      x = w[0];
      y = w[1];
      z = w[2];
      dirty = ((meta >> 1) & 1u) != 0;
      if (dirty) yaw = w[3];
      gid = static_cast<int>(meta >> 2) - 1;
    }
  } else if (v) {
    gather_row(p, tl, d.flat[tl * d.flat_stride + j], x, y, z, yaw, dirty,
               gid);
  }
  const long long o = static_cast<long long>(rl) * p.g + p.col0 +
                      static_cast<long long>(k) * p.h + j;
  p.gpos[3 * o] = x;
  p.gpos[3 * o + 1] = y;
  p.gpos[3 * o + 2] = z;
  p.gyaw[o] = yaw;
  p.gdirty[o] = dirty;
  p.gvalid[o] = v;
  p.ggid[o] = gid;
}

// Copy a host slot table (n_local entries, each -1 or a row below rows)
// into d; false if an entry is out of range.
bool set_slots(Direction& d, const short* slots, int n_local, int rows) {
  for (int i = 0; i < kMaxTiles; ++i) {
    d.slot[i] = (slots != nullptr && i < n_local) ? slots[i] : -1;
    if (d.slot[i] < -1 || d.slot[i] >= rows) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// One phase: own lanes pos/yaw/dirty/gid of m rows a tile for the
// n_local tiles from tile0, the output lanes of g rows a tile (written at
// columns [col0, col0 + 2h)), and per direction k the extraction
// (flat_k, its tile stride, count_k), the shift in [0, n_dev), the
// receiver bitmask over the n_dev tiles, and the received words (rows_k
// of them) with the host table slots_k (n_local shorts) of the receivers
// whose sender is another process's (null and 0 rows on one controller).
// Returns the CUDA error of the launch (0 = none).
int gw_halo_ship_phase(const void* pos, const void* yaw, const void* dirty,
                       const void* gid, int m, void* gpos, void* gyaw,
                       void* gdirty, void* gvalid, void* ggid, int g,
                       int n_dev, int tile0, int n_local, int h, int col0,
                       const void* flat0, long long flat_stride0,
                       const void* count0, int shift0,
                       unsigned long long recv0, const void* remote0,
                       int rows0, const short* slots0,
                       const void* flat1, long long flat_stride1,
                       const void* count1, int shift1,
                       unsigned long long recv1, const void* remote1,
                       int rows1, const short* slots1, void* stream) {
  if (n_dev < 1 || n_dev > kMaxTiles || n_local < 1 || tile0 < 0 ||
      tile0 + n_local > n_dev || m < 0 || h < 0 || col0 < 0 ||
      static_cast<long long>(col0) + 2ll * h > g || shift0 < 0 ||
      shift0 >= n_dev || shift1 < 0 || shift1 >= n_dev ||
      (rows0 && !remote0) || (rows1 && !remote1))
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
  p.send = nullptr;
  p.dir[0].flat = static_cast<const int*>(flat0);
  p.dir[0].count = static_cast<const int*>(count0);
  p.dir[0].remote = static_cast<const uint32_t*>(remote0);
  p.dir[0].flat_stride = flat_stride0;
  p.dir[0].recv = recv0;
  p.dir[0].shift = shift0;
  p.dir[1].flat = static_cast<const int*>(flat1);
  p.dir[1].count = static_cast<const int*>(count1);
  p.dir[1].remote = static_cast<const uint32_t*>(remote1);
  p.dir[1].flat_stride = flat_stride1;
  p.dir[1].recv = recv1;
  p.dir[1].shift = shift1;
  if (!set_slots(p.dir[0], slots0, n_local, rows0) ||
      !set_slots(p.dir[1], slots1, n_local, rows1))
    return static_cast<int>(cudaErrorInvalidValue);
  p.m = m;
  p.g = g;
  p.h = h;
  p.n_dev = n_dev;
  p.col0 = col0;
  p.tile0 = tile0;
  const dim3 grid((h + kThreads - 1) / kThreads, n_local, 2);
  halo_ship_phase<false>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The phase's pack mode, on the sender's side: for every local tile
// whose leg in direction k crosses processes (slots_k[tile] >= 0), its
// strip gathered as above from the own lanes of m rows a tile and the
// ghost block's columns [0, col0) (g rows a tile), written as words into
// row slots_k[tile] of send (i32[rows, h, 5]). Returns the CUDA error of
// the launch (0 = none).
int gw_halo_pack_legs(const void* pos, const void* yaw, const void* dirty,
                      const void* gid, int m, const void* gpos,
                      const void* gyaw, const void* gdirty,
                      const void* ggid, int g, int n_local, int h, int col0,
                      const void* flat0, long long flat_stride0,
                      const void* count0, const short* slots0,
                      const void* flat1, long long flat_stride1,
                      const void* count1, const short* slots1, void* send,
                      int rows, void* stream) {
  if (n_local < 1 || n_local > kMaxTiles || m < 0 || h < 0 || col0 < 0 ||
      col0 > g || rows < 0 || (rows && !send))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || rows == 0) return static_cast<int>(cudaGetLastError());
  PhaseParams p;
  p.pos = static_cast<const uint32_t*>(pos);
  p.yaw = static_cast<const uint32_t*>(yaw);
  p.dirty = static_cast<const uint8_t*>(dirty);
  p.gid = static_cast<const int*>(gid);
  p.gpos = static_cast<uint32_t*>(const_cast<void*>(gpos));
  p.gyaw = static_cast<uint32_t*>(const_cast<void*>(gyaw));
  p.gdirty = static_cast<uint8_t*>(const_cast<void*>(gdirty));
  p.gvalid = nullptr;
  p.ggid = static_cast<int*>(const_cast<void*>(ggid));
  p.send = static_cast<uint32_t*>(send);
  p.dir[0] = {};
  p.dir[1] = {};
  p.dir[0].flat = static_cast<const int*>(flat0);
  p.dir[0].count = static_cast<const int*>(count0);
  p.dir[0].flat_stride = flat_stride0;
  p.dir[1].flat = static_cast<const int*>(flat1);
  p.dir[1].count = static_cast<const int*>(count1);
  p.dir[1].flat_stride = flat_stride1;
  if (!set_slots(p.dir[0], slots0, n_local, rows) ||
      !set_slots(p.dir[1], slots1, n_local, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  p.m = m;
  p.g = g;
  p.h = h;
  p.n_dev = n_local;
  p.col0 = col0;
  p.tile0 = 0;
  const dim3 grid((h + kThreads - 1) / kThreads, n_local, 2);
  halo_ship_phase<true>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
