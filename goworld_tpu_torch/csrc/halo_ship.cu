// Ring shift of the megaspace halo strips, for Hopper (sm_90a).
//
// Replaces: goworld_tpu/parallel/halo.py:91 _async_ship, the TPU kernel
// in which every device starts one make_async_remote_copy of its packed
// strip (i32[H, 5]: pos bits, yaw bits, a gid/dirty/valid meta word)
// into the receive buffer of device (d + shift) % n_dev, over a periodic
// ring, and waits on a send/recv semaphore pair. Receivers that take no
// part (world-edge tiles) then zero their block, which makes the result
// equal to lax.ppermute with its fill. Here that mask is folded in:
//
//   out[t] = (recv_ok >> t) & 1 ? in[(t - shift) mod n_dev] : 0
//
// What bounds it on this card: launch latency. At the 2^20-entity 2x2
// megaspace a launch moves 4 x 4096 x 20 B = 320 KB each way, 0.0002 ms
// at 3.35 TB/s, far below the few microseconds any launch costs.
//
// Why this design: it pushes, as the TPU DMA does. The blocks of sender
// tile s store s's strip into its receiver's buffer, so a receiver's
// block has exactly one writer and nothing waits on anything. Each
// tile's source and destination pointer goes into the launch by value,
// in a fixed-size parameter struct (up to 64 tiles, the 64-device mesh
// of the JAX package's largest megaspace), with recv_ok as a bitmask:
// no device-side pointer table is copied and the host never waits. Tiles
// on several cards would need only peer access and peer pointers in the
// same struct. Each thread moves 4-byte words, coalesced across the
// warp.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTiles = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocksPerTile = 1024;

struct ShipParams {
  const int* src[kMaxTiles];
  int* dst[kMaxTiles];
  unsigned long long recv_ok;
  int n_dev;
  int shift;   // in [0, n_dev)
  int words;   // ints per tile
};

__global__ void halo_ship(const __grid_constant__ ShipParams p) {
  const int s = blockIdx.y;
  int r = s + p.shift;
  if (r >= p.n_dev) r -= p.n_dev;
  const bool ok = (p.recv_ok >> r) & 1ull;
  const int stride = gridDim.x * blockDim.x;
  const int* src = p.src[s];
  int* dst = p.dst[r];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.words;
       i += stride)
    dst[i] = ok ? src[i] : 0;
}

}  // namespace

extern "C" {

// src[t], dst[t]: tile t's strip of `words` ints in the input and the
// output; shift in [0, n_dev); bit t of recv_ok says whether tile t
// receives. Returns the CUDA error of the launch (0 = none).
int gw_halo_ship(const void* const* src, void* const* dst, int n_dev,
                 int words, int shift, unsigned long long recv_ok,
                 void* stream) {
  if (n_dev < 1 || n_dev > kMaxTiles || shift < 0 || shift >= n_dev ||
      words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (words == 0) return static_cast<int>(cudaGetLastError());
  ShipParams p;
  for (int t = 0; t < n_dev; ++t) {
    p.src[t] = static_cast<const int*>(src[t]);
    p.dst[t] = static_cast<int*>(dst[t]);
  }
  for (int t = n_dev; t < kMaxTiles; ++t) {
    p.src[t] = nullptr;
    p.dst[t] = nullptr;
  }
  p.recv_ok = recv_ok;
  p.n_dev = n_dev;
  p.shift = shift;
  p.words = words;
  int bx = (words + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerTile) bx = kMaxBlocksPerTile;
  halo_ship<<<dim3(bx, n_dev), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
