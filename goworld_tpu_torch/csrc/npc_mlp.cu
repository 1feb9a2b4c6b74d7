// The NPC behavior policy's forward pass (the bf16 MLP of
// models/npc_policy.py policy_accel) as one kernel for Hopper (sm_90a):
//
//   obs f32[N, 10] -> bf16 -> tanh(. W1 + b1) -> tanh(. W2 + b2)
//                  -> . W3 + b3 -> f32[N, 3]
//
// with the bits of the JAX package's jitted forward on the CPU. There
// every dot is a float32 dot of the bf16 values, rounded to bf16; the
// bias is added in float32 and the sum rounded to bf16; tanh runs on
// that value and is rounded to bf16; the last layer's bias sum stays
// float32. The dot's order is XLA's (ops/xla_order.py dot_lanes): the
// products of output column c summed in k order (lanes == 1), or in
// `lanes` partial sums over k mod lanes added pairwise, the K mod lanes
// last terms summed apart and added last. Each product and sum is
// rounded on its own (__fmul_rn / __fadd_rn: no contraction), so the
// kernel, the plain version and the CPU agree.
//
// Layout: the weights (bf16, ~36 KB at hidden 128) are staged in shared
// memory once a block. A warp carries ROWS rows at once; its hidden
// vectors live in a per-warp shared buffer (ping-pong between layers).
// A layer's work items are (column c, partial l) pairs, item t = c *
// lanes + l, laid out t = lane + 32 * i: every lane then has the same l
// in all its slots, the partials of one column sit in adjacent lanes
// and are added by __shfl_xor_sync, and no column is summed across
// lanes in any other way. tanh runs in double and is rounded to float,
// then to bf16, as the plain version rounds. Built without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;     // rows a warp carries at once
constexpr int kMaxH = 128;   // widest hidden layer
constexpr int kSlots = 4;    // work items a lane holds per layer
constexpr int kObs = 10;
constexpr int kOut = 3;

__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float tanh_bf(float x) {
  return round_bf(__double2float_rn(tanh(static_cast<double>(x))));
}

// One dense layer for the warp's kRows rows: in[r][0..K) (smem, float
// holding bf16 values) times W[K][M] (smem bf16). Returns in res[i][r]
// the dot of column c_i = (lane + 32 i) / lanes, valid at the lanes
// whose l == 0 (and c_i < M).
__device__ __forceinline__ void dense(
    const float (*in)[kMaxH], int K, const __nv_bfloat16* W, int M,
    int lanes, int lane, float res[kSlots][kRows]) {
  const int l = lane % lanes;
  const int kv = K - K % lanes;
  int col[kSlots];
  bool live[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    col[i] = (lane + 32 * i) / lanes;
    live[i] = col[i] < M;
#pragma unroll
    for (int r = 0; r < kRows; ++r) res[i][r] = 0.0f;
  }
  for (int k = l; k < kv; k += lanes) {
    float x[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r] = in[r][k];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (!live[i]) continue;
      const float w = __bfloat162float(W[k * M + col[i]]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        res[i][r] = __fadd_rn(res[i][r], __fmul_rn(x[r], w));
    }
  }
  // pairwise: (p0 + p1) + (p2 + p3); every lane shuffles
  for (int off = 1; off < lanes; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        res[i][r] = __fadd_rn(res[i][r],
                              __shfl_xor_sync(0xffffffffu, res[i][r], off));
  }
  if (kv < K) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float tail = 0.0f;
        for (int k = kv; k < K; ++k)
          tail = __fadd_rn(tail, __fmul_rn(
              in[r][k], __bfloat162float(W[k * M + col[i]])));
        res[i][r] = __fadd_rn(res[i][r], tail);
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
npc_mlp_kernel(const float* __restrict__ obs, int n, int hidden,
               const __nv_bfloat16* __restrict__ w1,
               const __nv_bfloat16* __restrict__ b1,
               const __nv_bfloat16* __restrict__ w2,
               const __nv_bfloat16* __restrict__ b2,
               const __nv_bfloat16* __restrict__ w3,
               const __nv_bfloat16* __restrict__ b3,
               int l1, int l2, int l3, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = hidden;
  // [kWarps][2][kRows][kMaxH] float buffers, then the bf16 weights
  float (*hbuf)[2][kRows][kMaxH] =
      reinterpret_cast<float (*)[2][kRows][kMaxH]>(smem);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(
      smem + sizeof(float) * kWarps * 2 * kRows * kMaxH);
  __nv_bfloat16* sw1 = sw;
  __nv_bfloat16* sw2 = sw1 + kObs * h;
  __nv_bfloat16* sw3 = sw2 + h * h;
  __nv_bfloat16* sb1 = sw3 + h * kOut;
  __nv_bfloat16* sb2 = sb1 + h;
  __nv_bfloat16* sb3 = sb2 + h;
  for (int t = threadIdx.x; t < kObs * h; t += blockDim.x) sw1[t] = w1[t];
  for (int t = threadIdx.x; t < h * h; t += blockDim.x) sw2[t] = w2[t];
  for (int t = threadIdx.x; t < h * kOut; t += blockDim.x) sw3[t] = w3[t];
  for (int t = threadIdx.x; t < h; t += blockDim.x) {
    sb1[t] = b1[t];
    sb2[t] = b2[t];
  }
  if (threadIdx.x < kOut) sb3[threadIdx.x] = b3[threadIdx.x];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float (*ha)[kMaxH] = hbuf[warp][0];
  float (*hb)[kMaxH] = hbuf[warp][1];
  float res[kSlots][kRows];
  const int stride = gridDim.x * kWarps * kRows;

  for (int base = (blockIdx.x * kWarps + warp) * kRows; base < n;
       base += stride) {
    // the observation rows, rounded to bf16 (rows past n read zeros)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r;
      if (lane < kObs)
        ha[r][lane] = row < n ? round_bf(obs[(int64_t)row * kObs + lane])
                              : 0.0f;
    }
    __syncwarp();

    // two hidden layers: bf16(bf16(dot) + b) -> tanh -> bf16
#pragma unroll 1
    for (int layer = 0; layer < 2; ++layer) {
      const float (*in)[kMaxH] = layer == 0 ? ha : hb;
      float (*dst)[kMaxH] = layer == 0 ? hb : ha;
      const int K = layer == 0 ? kObs : h;
      const __nv_bfloat16* W = layer == 0 ? sw1 : sw2;
      const __nv_bfloat16* B = layer == 0 ? sb1 : sb2;
      const int lanes = layer == 0 ? l1 : l2;
      dense(in, K, W, h, lanes, lane, res);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int c = (lane + 32 * i) / lanes;
        if (c >= h || lane % lanes != 0) continue;
        const float bias = __bfloat162float(B[c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          dst[r][c] = tanh_bf(round_bf(__fadd_rn(round_bf(res[i][r]),
                                                 bias)));
      }
      __syncwarp();
    }

    // the output layer: bf16(dot) + b3 in float32
    dense(ha, h, sw3, kOut, l3, lane, res);
    {
      const int c = lane / l3;   // slot 0 holds every column (3 * l3 <= 32)
      if (c < kOut && lane % l3 == 0) {
        const float bias = __bfloat162float(sb3[c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = base + r;
          if (row < n)
            out[(int64_t)row * kOut + c] =
                __fadd_rn(round_bf(res[0][r]), bias);
        }
      }
    }
    __syncwarp();
  }
}

size_t smem_bytes(int hidden) {
  return sizeof(float) * kWarps * 2 * kRows * kMaxH
         + sizeof(__nv_bfloat16)
               * (kObs * hidden + hidden * hidden + hidden * kOut
                  + 2 * hidden + kOut);
}

}  // namespace

extern "C" {

// Widest hidden layer the kernel takes.
int gw_npc_mlp_max_hidden() { return kMaxH; }

// out f32[n, 3] = the policy's forward pass over obs f32[n, 10]; the
// weights are bf16 words, row major (w1 [10, hidden], w2 [hidden,
// hidden], w3 [hidden, 3]); l1, l2, l3 are each layer's partial sums
// (1, 2 or 4). Returns a CUDA error code.
int gw_npc_mlp(const float* obs, int n, int hidden, const uint16_t* w1,
               const uint16_t* b1, const uint16_t* w2, const uint16_t* b2,
               const uint16_t* w3, const uint16_t* b3, int l1, int l2,
               int l3, float* out, void* stream) {
  if (n <= 0) return 0;
  if (hidden < 1 || hidden > kMaxH) return cudaErrorInvalidValue;
  const int ls[3] = {l1, l2, l3};
  for (int i = 0; i < 3; ++i)
    if (ls[i] != 1 && ls[i] != 2 && ls[i] != 4) return cudaErrorInvalidValue;
  // every (column, partial) item of a layer must fit a lane's slots
  if (hidden * l1 > 32 * kSlots || hidden * l2 > 32 * kSlots)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hidden);
  cudaError_t err = cudaFuncSetAttribute(
      npc_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, npc_mlp_kernel, kWarps * 32, smem);
  if (err != cudaSuccess) return err;
  const long long need = (n + kWarps * kRows - 1) / (kWarps * kRows);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > need) blocks = need;
  npc_mlp_kernel<<<static_cast<int>(blocks), kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      obs, n, hidden, reinterpret_cast<const __nv_bfloat16*>(w1),
      reinterpret_cast<const __nv_bfloat16*>(b1),
      reinterpret_cast<const __nv_bfloat16*>(w2),
      reinterpret_cast<const __nv_bfloat16*>(b2),
      reinterpret_cast<const __nv_bfloat16*>(w3),
      reinterpret_cast<const __nv_bfloat16*>(b3), l1, l2, l3, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
