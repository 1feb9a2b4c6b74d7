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
// What bounds it on this card: bytes. At 2^20 queries the kernel reads
// lo/hi (24 MB), the query positions and reach (16 MB) and the sorted
// view (12.6 MB, which fits the 50 MB L2 so its re-reads by
// neighbouring queries mostly hit there), and writes the [N, k] keys
// (134 MB at k = 32): about 190 MB, some 57 us at 3.35 TB/s. The
// selection is integer work in registers, about 3.5 k operations a
// query.
//
// Why this design: the [N, 9*cell_cap] candidate and key arrays never
// exist in device memory. One warp owns one query row. Its lanes load the
// three runs, which are contiguous in the sorted view, so the loads
// coalesce; each lane keeps ceil(9*cell_cap / 32) keys in registers. Then
// k rounds of a warp-wide minimum (__reduce_min_sync) each emit the
// smallest key left, and the lane that holds it retires it. Valid keys
// are unique (their id bits differ), so each round retires exactly one
// lane, and once the minimum is the invalid key every later output is
// invalid: the loop stops there. This gives sort(keys)[:k] exactly.
//
// Exactness traps kept here: the slot words come in as an int32 array
// (as float bit patterns they would be subnormal and a flush-to-zero
// float op would zero them), the key scale arrives as the float32 the
// JAX encoder rounds to, the product is rounded to nearest and the
// float-to-int cast truncates, and the file is built without fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

struct KeyCode {
  int id_shift;     // slot id = word >> id_shift (2 when flags ride it)
  int qd_shift;     // quantized distance sits at bit qd_shift of the key
  int qd_cap;       // quantized distance clamp before the bias
  int qd_bias;      // 1 on the 8-bit encoding (keeps f32 keys normal)
  float scale;      // float32(levels / qmax)
  int invalid_key;  // ranks above every valid key
};

template <int PER>
__global__ void __launch_bounds__(kThreads)
sweep_fused_kernel(const float* __restrict__ spx,
                   const float* __restrict__ spz,
                   const int* __restrict__ sw,
                   const int* __restrict__ lo,
                   const int* __restrict__ hi,
                   const float* __restrict__ pos,
                   const float* __restrict__ reach, int q, int k, int cc,
                   int sentinel, KeyCode code, int* __restrict__ top,
                   int* __restrict__ dem) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= q) return;  // the whole warp leaves together
  const int run = 3 * cc;
  const float qx = pos[3 * row];
  const float qz = pos[3 * row + 2];
  const float qr = reach[row];
  int lo3[3], len3[3];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    lo3[dx] = lo[3 * row + dx];
    len3[dx] = hi[3 * row + dx] - lo3[dx];
  }
  int keys[PER];
  int nvalid = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    int key = code.invalid_key;
    if (c < 3 * run) {
      const int dx = c / run;
      const int off = c - dx * run;
      if (off < len3[dx]) {
        const int s = lo3[dx] + off;
        const int w = sw[s];
        const int cid = w >> code.id_shift;
        const float dist = fmaxf(fabsf(__fsub_rn(spx[s], qx)),
                                 fabsf(__fsub_rn(spz[s], qz)));
        if (cid != sentinel && dist <= qr && cid != row) {
          int qd = __float2int_rz(__fmul_rn(dist, code.scale));
          qd = min(qd, code.qd_cap) + code.qd_bias;
          key = (qd << code.qd_shift) | w;
          ++nvalid;
        }
      }
    }
    keys[j] = key;
  }
  if (dem != nullptr) {
    const int total = __reduce_add_sync(0xffffffffu, nvalid);
    if (lane == 0) dem[row] = total;
  }
  int* out = top + static_cast<size_t>(row) * k;
  for (int r = 0; r < k; ++r) {
    int m = keys[0];
#pragma unroll
    for (int j = 1; j < PER; ++j) m = min(m, keys[j]);
    m = __reduce_min_sync(0xffffffffu, m);
    if (m == code.invalid_key) {
      for (int rr = r + lane; rr < k; rr += 32) out[rr] = code.invalid_key;
      break;
    }
    if (lane == (r & 31)) out[r] = m;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (keys[j] == m) keys[j] = code.invalid_key;
  }
}

template <int PER>
void launch(const float* s_xz, const int* s_w, int s_len, const int* lo,
            const int* hi, const float* pos, const float* reach, int q,
            int k, int cc, int sentinel, KeyCode code, int* top, int* dem,
            cudaStream_t stream) {
  const int blocks = (q + kRowsPerBlock - 1) / kRowsPerBlock;
  sweep_fused_kernel<PER><<<blocks, kThreads, 0, stream>>>(
      s_xz, s_xz + s_len, s_w, lo, hi, pos, reach, q, k, cc, sentinel, code,
      top, dem);
}

}  // namespace

extern "C" {

// s_xz: f32 [2, s_len] sorted x / z rows (3*cc sentinel lanes at the
// end); s_w: i32 [s_len] packed slot words; lo, hi: i32 [q, 3] run
// bounds; pos: f32 [>= q, 3]; reach: f32 [>= q]; top: i32 [q, k] out;
// dem: i32 [q] out, or null to skip the demand gauge. Returns the CUDA
// error code of the launch (cudaErrorInvalidValue when 9*cc > 256).
int gw_sweep_fused(const float* s_xz, const int* s_w, int s_len,
                   const int* lo, const int* hi, const float* pos,
                   const float* reach, int q, int k, int cc, int sentinel,
                   int id_shift, int qd_shift, int qd_cap, int qd_bias,
                   float scale, int invalid_key, int* top, int* dem,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KeyCode code{id_shift, qd_shift, qd_cap, qd_bias, scale,
                     invalid_key};
  if (q <= 0) return static_cast<int>(cudaGetLastError());
  const int per = (9 * cc + 31) / 32;
#define GW_SWEEP_CASE(P)                                                  \
  case P:                                                                 \
    launch<P>(s_xz, s_w, s_len, lo, hi, pos, reach, q, k, cc, sentinel,   \
              code, top, dem, s);                                         \
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
