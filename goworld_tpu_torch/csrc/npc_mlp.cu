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
// last terms summed apart and added last. It replaces no TPU kernel:
// the JAX package leaves these dots to XLA, and no matmul library on
// the card sums in XLA's order (nor do mma / wgmma), so the bound of
// this design is the float32 rate of the CUDA cores: 2 (10 H + H^2 +
// 3 H) operations a row, 3.79e10 at 2^20 rows and H 128.
//
// Design (a CUDA-core SGEMM, one output summed by one thread):
//
// * A block carries a tile of kTile = 128 rows through all three
//   layers; the activations stay in shared memory, k-major (act[k][row],
//   a thread's rows contiguous). The weights are staged once a block as
//   float32 (w2 64 KB) and the grid is one persistent block an SM that
//   loops over row tiles.
// * Each thread owns an 8-row x (8 / L) column x L partial register
//   tile: per k two 16-byte loads of its rows and one or two of its
//   columns, then 8 (8 / L) products. Each output (or each of its L
//   partials) is summed by one thread in strict k order, so XLA's order
//   holds by construction; the partials are added pairwise and the K
//   mod L tail last, as dot_f32 does.
// * Exact FFMA. A bf16 x bf16 product has at most 16 significant bits,
//   so it is exact in float32 while it neither overflows nor drops bits
//   below 2^-149; there fmaf(x, w, acc) rounds once what __fmul_rn then
//   __fadd_rn round twice, to the same bits, in one issue slot instead
//   of two. A product of bf16 values whose lowest significand bits sit
//   at 2^(max(Ex,1)-134) and 2^(max(Ew,1)-134) (E the biased exponent
//   field) is on the 2^-149 grid when max(Ex,1) + max(Ew,1) >= 119
//   (kExactLo). Layer 2 multiplies tanh outputs (|x| <= 1, so every
//   product is at most |w|: no overflow) and takes FFMA unless a row
//   tile's activations could fall below that grid: the smallest such
//   exponent of the nonzero w2 words is found once a block, that of the
//   tile's nonzero activations as layer 1 writes them, and the tile
//   then runs layer 2 on the rounded mul and add (the same template, a
//   uniform branch). Layer 1 multiplies the raw observations (up to
//   +-3e38: 1.5 2^127 x 2 + -3e38 gives 2.104e38 as one FFMA and inf as
//   a mul and an add) and the output layer is 3 columns at lanes 4;
//   both keep the rounded mul and add (about 9% of the products).
// * tanh by a table. tanh's input is always a bf16 value; the wrapper
//   builds tanh_bf16 (float64 tanh rounded to float32, then bf16: the
//   function this kernel computed before) over the 32,768 magnitudes
//   once per device, and the kernel stages it in shared memory and
//   looks up |x|, the sign applied by oddness (held on all 65,536
//   inputs by the CPU tests).
//
// Built without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // rows a block carries through the layers
constexpr int kLda = 132;    // act row stride (floats): 16-byte rows,
                             // fewer bank conflicts on the stores
constexpr int kMaxH = 128;   // widest hidden layer
constexpr int kObs = 10;
constexpr int kOut = 3;
constexpr int kTanh = 32768; // bf16 magnitudes
constexpr int kExactLo = 119;

struct Smem {
  float act[kMaxH][kLda];    // a layer's activations, k-major
  float w2[kMaxH][kMaxH];
  uint16_t tanh_mag[kTanh];
  float x0[kObs][kLda];      // the observation tile, bf16 values
  float w1[kObs][kMaxH];
  float w3[kMaxH][4];        // column 3 zero
  float b1[kMaxH];
  float b2[kMaxH];
  float b3[4];
  int wexp;                  // min max(E, 1) over nonzero w2 words
};

__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// max(E, 1) of a float32 holding a bf16 value
__device__ __forceinline__ int lo_exp(float x) {
  return max(static_cast<int>((__float_as_uint(x) >> 23) & 0xffu), 1);
}

__device__ __forceinline__ float tanh_lookup(const uint16_t* tab, float x) {
  const uint32_t u = __float_as_uint(x) >> 16;
  return __uint_as_float(
      (static_cast<uint32_t>(tab[u & 0x7fffu]) | (u & 0x8000u)) << 16);
}

template <bool kFma>
__device__ __forceinline__ float mac(float x, float w, float acc) {
  if constexpr (kFma) {
    return fmaf(x, w, acc);
  } else {
    return __fadd_rn(acc, __fmul_rn(x, w));
  }
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// The thread's columns: C = 8 / L of them, C / 2 from c0 and C / 2 from
// 64 / L + c0, so that a block covers 128 / L columns.
template <int L>
__device__ __forceinline__ int col_of(int c0, int j) {
  constexpr int kHalf = 4 / L;
  return j < kHalf ? c0 + j : 64 / L + c0 + j - kHalf;
}

// acc[r][c] = the dot of the thread's rows (r0 + 0..3, r0 + 64 + 0..3)
// of a (k-major, stride kLda) with its columns of w (k-major, stride
// kMaxH) over k < K, in XLA's order with L partial sums.
template <int L, bool kFma>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a,
                                         const float* __restrict__ w,
                                         int K, int r0, int c0,
                                         float acc[8][8 / L]) {
  constexpr int C = 8 / L;
  constexpr int kHalf = C / 2;
  float part[L][8][C];
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) part[l][r][c] = 0.0f;
  const int kv = K - K % L;
#pragma unroll 8
  for (int k0 = 0; k0 < kv; k0 += L) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int k = k0 + l;
      float x[8], wv[C];
      lds<4>(a + k * kLda + r0, x);
      lds<4>(a + k * kLda + r0 + 64, x + 4);
      lds<kHalf>(w + k * kMaxH + c0, wv);
      lds<kHalf>(w + k * kMaxH + 64 / L + c0, wv + kHalf);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          part[l][r][c] = mac<kFma>(x[r], wv[c], part[l][r][c]);
    }
  }
  // pairwise: (p0 + p1) + (p2 + p3)
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (L == 1) {
        acc[r][c] = part[0][r][c];
      } else if constexpr (L == 2) {
        acc[r][c] = __fadd_rn(part[0][r][c], part[1][r][c]);
      } else {
        acc[r][c] = __fadd_rn(__fadd_rn(part[0][r][c], part[1][r][c]),
                              __fadd_rn(part[2][r][c], part[3][r][c]));
      }
    }
  if (kv < K) {
    float tail[8][C];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) tail[r][c] = 0.0f;
    for (int k = kv; k < K; ++k) {
      float x[8], wv[C];
      lds<4>(a + k * kLda + r0, x);
      lds<4>(a + k * kLda + r0 + 64, x + 4);
      lds<kHalf>(w + k * kMaxH + c0, wv);
      lds<kHalf>(w + k * kMaxH + 64 / L + c0, wv + kHalf);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          tail[r][c] = mac<kFma>(x[r], wv[c], tail[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = __fadd_rn(acc[r][c], tail[r][c]);
  }
}

// tanh(bf16(bf16(acc) + b)) into act[col][rows] for the thread's
// columns below h; with kCheck, whether a nonzero value lies below thr
// (its max(E, 1) below the tile's bound: layer 2 then runs rounded).
template <int L, bool kCheck>
__device__ __forceinline__ bool store_hidden(Smem& s, float acc[8][8 / L],
                                             const float* bias, int h,
                                             int r0, int c0, float thr) {
  bool low = false;
#pragma unroll
  for (int j = 0; j < 8 / L; ++j) {
    const int col = col_of<L>(c0, j);
    if (col >= h) continue;
    const float b = bias[col];
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      v[r] = tanh_lookup(s.tanh_mag,
                         round_bf(__fadd_rn(round_bf(acc[r][j]), b)));
      if (kCheck) low |= v[r] != 0.0f && fabsf(v[r]) < thr;
    }
    *reinterpret_cast<float4*>(&s.act[col][r0]) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&s.act[col][r0 + 64]) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
  return low;
}

template <int L>
__device__ __forceinline__ bool layer1(Smem& s, int h, int r0, int cg,
                                       float thr) {
  float acc[8][8 / L];
  const int c0 = cg * (4 / L);
  tile_dot<L, false>(&s.x0[0][0], &s.w1[0][0], kObs, r0, c0, acc);
  return store_hidden<L, true>(s, acc, s.b1, h, r0, c0, thr);
}

template <int L, bool kFma>
__device__ __forceinline__ void layer2(Smem& s, int h, int r0, int cg) {
  float acc[8][8 / L];
  const int c0 = cg * (4 / L);
  tile_dot<L, kFma>(&s.act[0][0], &s.w2[0][0], h, r0, c0, acc);
  __syncthreads();  // every read of act is done: overwrite it in place
  store_hidden<L, false>(s, acc, s.b2, h, r0, c0, 0.0f);
}

// The output layer: item q = row * L + l holds partial l of the row's
// three columns; the L partials of a row sit in adjacent lanes and meet
// by __shfl_xor_sync in the pairwise order; lane l == 0 adds the tail.
// A thread holds items q and q + kThreads (rows r and r + kThreads / L,
// the same l) in one k loop, while there are kTile * L items.
template <int L>
__device__ __forceinline__ void layer3(const Smem& s, int h, int base, int n,
                                       float* __restrict__ out) {
  constexpr int kItems = kTile * L;
  constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  constexpr int kStride = kThreads / L;
  if (static_cast<int>(threadIdx.x & ~31u) >= kItems) return;
  const int r = static_cast<int>(threadIdx.x) / L;
  const int l = static_cast<int>(threadIdx.x) % L;
  const int kv = h - h % L;
  float p[kPer][kOut] = {};
  for (int k = l; k < kv; k += L) {
    const float4 w = *reinterpret_cast<const float4*>(&s.w3[k][0]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float x = s.act[k][r + j * kStride];
      p[j][0] = __fadd_rn(p[j][0], __fmul_rn(x, w.x));
      p[j][1] = __fadd_rn(p[j][1], __fmul_rn(x, w.y));
      p[j][2] = __fadd_rn(p[j][2], __fmul_rn(x, w.z));
    }
  }
#pragma unroll
  for (int off = 1; off < L; off <<= 1)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        p[j][c] = __fadd_rn(p[j][c],
                            __shfl_xor_sync(0xffffffffu, p[j][c], off));
  if (l != 0) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int rj = r + j * kStride;
    if (kv < h) {
      float t[kOut] = {0.0f, 0.0f, 0.0f};
      for (int k = kv; k < h; ++k) {
        const float x = s.act[k][rj];
#pragma unroll
        for (int c = 0; c < kOut; ++c)
          t[c] = __fadd_rn(t[c], __fmul_rn(x, s.w3[k][c]));
      }
#pragma unroll
      for (int c = 0; c < kOut; ++c) p[j][c] = __fadd_rn(p[j][c], t[c]);
    }
    const int row = base + rj;
    if (row < n) {
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        out[static_cast<int64_t>(row) * kOut + c] =
            __fadd_rn(round_bf(p[j][c]), s.b3[c]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
npc_mlp_kernel(const float* __restrict__ obs, int n, int h,
               const __nv_bfloat16* __restrict__ w1,
               const __nv_bfloat16* __restrict__ b1,
               const __nv_bfloat16* __restrict__ w2,
               const __nv_bfloat16* __restrict__ b2,
               const __nv_bfloat16* __restrict__ w3,
               const __nv_bfloat16* __restrict__ b3,
               const uint16_t* __restrict__ tanh_mag,
               int l1, int l2, int l3, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int tid = threadIdx.x;
  if (tid == 0) s.wexp = 1 << 20;
  __syncthreads();
  // the weights as float32, zero past h; the tanh table
  int wmin = 1 << 20;
  for (int t = tid; t < kMaxH * kMaxH; t += kThreads) {
    const int k = t / kMaxH, c = t % kMaxH;
    const float v = (k < h && c < h) ? __bfloat162float(w2[k * h + c]) : 0.0f;
    s.w2[k][c] = v;
    if (v != 0.0f) wmin = min(wmin, lo_exp(v));
  }
  atomicMin(&s.wexp, wmin);
  for (int t = tid; t < kObs * kMaxH; t += kThreads) {
    const int k = t / kMaxH, c = t % kMaxH;
    s.w1[k][c] = c < h ? __bfloat162float(w1[k * h + c]) : 0.0f;
  }
  for (int t = tid; t < kMaxH * 4; t += kThreads) {
    const int k = t / 4, c = t % 4;
    s.w3[k][c] = (k < h && c < kOut) ? __bfloat162float(w3[k * kOut + c])
                                     : 0.0f;
  }
  for (int t = tid; t < kMaxH; t += kThreads) {
    s.b1[t] = t < h ? __bfloat162float(b1[t]) : 0.0f;
    s.b2[t] = t < h ? __bfloat162float(b2[t]) : 0.0f;
  }
  if (tid < 4) s.b3[tid] = tid < kOut ? __bfloat162float(b3[tid]) : 0.0f;
  {
    const uint4* src = reinterpret_cast<const uint4*>(tanh_mag);
    uint4* dst = reinterpret_cast<uint4*>(s.tanh_mag);
    for (int t = tid; t < kTanh * 2 / 16; t += kThreads) dst[t] = src[t];
  }
  __syncthreads();
  // an activation with max(E, 1) < lo is |x| < 2^(lo - 127) (lo >= 2)
  const int lo = kExactLo - s.wexp;
  const float thr =
      lo >= 2 ? __uint_as_float(static_cast<uint32_t>(lo) << 23) : 0.0f;

  // the thread's register tile: a warp spans 4 row groups x 8 column
  // groups
  const int warp = tid / 32, lane = tid % 32;
  const int rg = (warp / 2) * 4 + lane / 8;
  const int cg = (warp % 2) * 8 + lane % 8;
  const int r0 = rg * 4;
  const int tiles = (n + kTile - 1) / kTile;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * kTile;
    // the observation rows, rounded to bf16 (rows past n read zeros)
    const float* src = obs + static_cast<int64_t>(base) * kObs;
    const int live = min(kTile, n - base) * kObs;
    for (int t = tid; t < kTile * kObs; t += kThreads)
      s.x0[t % kObs][t / kObs] = t < live ? round_bf(src[t]) : 0.0f;
    __syncthreads();

    bool low;
    switch (l1) {
      case 1: low = layer1<1>(s, h, r0, cg, thr); break;
      case 2: low = layer1<2>(s, h, r0, cg, thr); break;
      default: low = layer1<4>(s, h, r0, cg, thr); break;
    }
    const bool rounded = __syncthreads_or(low);

    switch (l2 * 2 + rounded) {
      case 2: layer2<1, true>(s, h, r0, cg); break;
      case 3: layer2<1, false>(s, h, r0, cg); break;
      case 4: layer2<2, true>(s, h, r0, cg); break;
      case 5: layer2<2, false>(s, h, r0, cg); break;
      case 8: layer2<4, true>(s, h, r0, cg); break;
      default: layer2<4, false>(s, h, r0, cg); break;
    }
    __syncthreads();

    switch (l3) {
      case 1: layer3<1>(s, h, base, n, out); break;
      case 2: layer3<2>(s, h, base, n, out); break;
      default: layer3<4>(s, h, base, n, out); break;
    }
  }
}

}  // namespace

extern "C" {

// Widest hidden layer the kernel takes.
int gw_npc_mlp_max_hidden() { return kMaxH; }

// out f32[n, 3] = the policy's forward pass over obs f32[n, 10]; the
// weights are bf16 words, row major (w1 [10, hidden], w2 [hidden,
// hidden], w3 [hidden, 3]); l1, l2, l3 are each layer's partial sums
// (1, 2 or 4); tanh_mag holds the bf16 words of tanh_bf16 over the
// 32,768 bf16 magnitudes (ops/mlp.py tanh_table). Returns a CUDA error
// code.
int gw_npc_mlp(const float* obs, int n, int hidden, const uint16_t* w1,
               const uint16_t* b1, const uint16_t* w2, const uint16_t* b2,
               const uint16_t* w3, const uint16_t* b3, int l1, int l2,
               int l3, const uint16_t* tanh_mag, float* out, void* stream) {
  if (n <= 0) return 0;
  if (hidden < 1 || hidden > kMaxH) return cudaErrorInvalidValue;
  const int ls[3] = {l1, l2, l3};
  for (int i = 0; i < 3; ++i)
    if (ls[i] != 1 && ls[i] != 2 && ls[i] != 4) return cudaErrorInvalidValue;
  // a block covers 128 / lanes columns of a hidden layer
  if (hidden * l1 > kMaxH || hidden * l2 > kMaxH)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(tanh_mag) % 16 != 0)
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      npc_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, npc_mlp_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  npc_mlp_kernel<<<static_cast<int>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      obs, n, hidden, reinterpret_cast<const __nv_bfloat16*>(w1),
      reinterpret_cast<const __nv_bfloat16*>(b1),
      reinterpret_cast<const __nv_bfloat16*>(w2),
      reinterpret_cast<const __nv_bfloat16*>(b2),
      reinterpret_cast<const __nv_bfloat16*>(w3),
      reinterpret_cast<const __nv_bfloat16*>(b3), tanh_mag, l1, l2, l3,
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
