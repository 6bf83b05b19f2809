// The hash field's sigma MLP in float32, forward and backward, for Hopper (sm_90a):
// D hash features, one hidden layer of H = 64 with ReLU, one output, no biases
// (upstream LONER's cfg/nerf_config/default_nerf_hash.yaml: D = 32; built for every D
// that is a multiple of 4 from 4 to 64, LT_SIGMA_MLP_DS; lt_sigma_mlp_supported says
// which heads it takes).
//
// Not a TPU kernel: the JAX package leaves this MLP to XLA
// (loner_tpu/models/field.py::_apply_mlp at compute_dtype float32). No TPU kernel
// is replaced. It gets a hand-written pair here because, as plain PyTorch, it took
// 3.13 ms of the reference's 9.85-ms W=8 iteration (2,097,152 points): three cuBLAS
// products, a gemv and elementwise passes, each reading or writing an (N, 64) f32
// array (537 MB at that N), and the input-gradient product in 32 blocked launches
// to keep it batch-invariant.
//
//   forward   z = x W0 (N x H), sigma = relu(z) w1            (N x 1)
//   backward  gz = (z > 0) g w1^T, dx = gz W0^T                (N x D)
//             dW0 = x^T gz, dW1 = relu(z)^T g
//
// What bounds it: operations. 6 x 2,112 multiply-adds a point at D = 32 (the
// forward's and the backward's products, recomputation not counted), 26.6 GFLOP an
// iteration: 0.397 ms on the CUDA cores at 67 TFLOP/s, 0.161 ms as three TF32
// products on the tensor cores; its bytes (x and g read once, sigma and dx written
// once, 264 bytes a point) take 0.165 ms at 3.35 TB/s. Both kernels do every product
// as an f32 FMA chain on the CUDA cores (the forward 2,112 a point, the backward
// 6,208 with its recomputed z), so the floor they can reach is 0.53 ms.
//
// Design:
// - Nothing of size N x H leaves the chip. A block keeps W0 (D x H, 8 KB at D = 32),
//   its transpose and w1 in shared memory, stages a tile of 128 points' features
//   (rows padded to D + 4 floats, so the float4 loads of neighbouring rows fall in
//   other banks), and forms z in registers as a register-tiled outer product: 256
//   threads, each 8 points (pg, pg + 16, ..., pg + 112) x 4 hidden units (4 hg ..
//   4 hg + 3), 12 float4 shared loads to 128 FMAs a step of 4 features.
// - Every point's sums have one order that depends on nothing else in the batch:
//   z[h] adds the features in order 0 .. D - 1 in one FMA chain; sigma adds a
//   thread's four hidden units in order, then the 16 threads of the point in a fixed
//   xor-shuffle tree; dx[d] adds the hidden units 0 .. H - 1 in one FMA chain. So a
//   point's sigma and dx have the same bits at any N and in any split of the points,
//   which cuBLAS, picking its kernel by the row count, did not give (the plain
//   version, field.py::mlp_apply, runs its input-gradient product in blocks of
//   MLP_GRAD_ROWS rows for that).
// - The backward recomputes z with the forward's own code (hidden_tile), so its
//   ReLU masks are the forward's bits; forms gz = (z > 0) g w1 in registers and
//   stages it in shared memory (128 x 68 floats); then writes dx = gz W0^T (a thread
//   4 points x 4 features) and adds x^T gz into 16 registers a thread (4 features x
//   4 hidden units, the tile's points split in 256 / (4 D) interleaved sets).
// - dW0 and dW1 without float atomics: a block takes a fixed contiguous range of
//   tiles, keeps its sums in registers across them, and writes its (D H + H) partial
//   once; sigma_mlp_dw_reduce_kernel sums the partials in block order (8 slices a
//   column, each in order, then the slices in order). The grid is min(tiles,
//   kBwdBlocks) and the ranges follow from it: both depend on N alone, so two calls
//   give the same bits on any card.
//
// Measured (an H100 80GB HBM3 at 700 W, 2,097,152 points at D = 32, CUDA events, median
// of 30): forward 0.276-0.288 ms, backward with its reduce 0.771-0.804 ms, against 3.314
// ms for the plain version's forward and backward (cuBLAS and elementwise passes);
// through the wrapper, median of 5 (chip_smoke.check_sigma_mlp_kernels): 0.312 and 0.866
// ms against mlp_apply's 1.179 and 2.101, at D = 12 0.219 and 0.536. In the reference's
// traced W=8 iteration: 0.265 and 0.745-0.750 ms, 16.2-16.3% of the bound. Both reach
// about half the CUDA cores' FMA rate for the FMAs they issue. ptxas: the forward (80
// registers at 3 blocks an SM) spills 20-48 bytes at D = 12 and above, 24 at D = 32; the
// backward (128 registers) 4-36 bytes at some D, none at 4, 12, 20, 24, 32 or 64. The 16 widths
// take nvcc about 30 s, inside the time the other sources take beside them.
// Levers tried, each beside this build in one call: the feature loop unrolled by 2,
// 0.285-0.302 / 0.790-0.798 (kept: fully unrolled); the forward at 2 blocks an SM (99
// registers, no spill; at 3 it spills 24 bytes), 0.284-0.286, no gain; the backward's
// grid at 264 / 1056 blocks, 0.770-0.791 / 0.807-0.810 against 528's 0.781-0.798, kept
// 528; the forward's grid from 264 to 16,384 blocks, 0.276-0.303, kept 4096; cp.async
// double buffers, the next tile's features and gradient in flight while this one is
// used, 0.278 / 0.781-0.793, no gain (the blocks an SM already hide the loads); a
// forward thread of 8 points x 8 hidden units (256-point tiles, 16 float4 loads to
// 256 FMAs; 128 registers, 44 bytes spilled), 0.289-0.296 against 0.286-0.288. Both
// dropped. Untried: the products as split TF32 mma.sync, as csrc/fourier_mlp_f32.cu.
//
// Plain C interface (no PyTorch headers); built by loner_tpu_torch/ops/build.py and
// bound with ctypes in loner_tpu_torch/ops/sigma_mlp.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;         // hidden units
constexpr int kThreads = 256;
constexpr int kHG = kH / 4;    // hidden groups of 4 (a thread's columns of z)
constexpr int kPG = kThreads / kHG;  // point groups (16)
constexpr int kPT = 8;         // points a thread in the z tile
constexpr int kTile = kPG * kPT;     // points a tile (128)
constexpr int kGZ = kH + 4;    // row stride of the staged gz
constexpr int kFwdBlocks = 4096;  // the forward's grid at most (blocks loop over tiles)
// Blocks of the backward at most: a block takes ceil or floor of tiles / grid
// contiguous tiles. A constant, so the partials' order depends on N alone. A test
// may build the source with fewer (-DLT_SIGMA_MLP_BWD_BLOCKS=3) to give a few
// hundred points ranges of several tiles.
#ifndef LT_SIGMA_MLP_BWD_BLOCKS
#define LT_SIGMA_MLP_BWD_BLOCKS 528
#endif
constexpr int kBwdBlocks = LT_SIGMA_MLP_BWD_BLOCKS;
constexpr int kSlices = 8;     // the reduce's slices of a column of partials

template <int D>
struct Smem {
  static constexpr int kXS = D + 4;  // row stride of the staged features
  static constexpr int w0 = 0;                    // W0, D x H
  static constexpr int w0t = w0 + D * kH;         // W0^T, H x D (backward)
  static constexpr int w1 = w0t + kH * D;         // w1, H
  static constexpr int xs = w1 + kH;              // features, kTile x kXS
  static constexpr int gz = xs + kTile * kXS;     // gz, kTile x kGZ (backward)
  static constexpr int g = gz + kTile * kGZ;      // upstream gradient, kTile (backward)
  static constexpr int bwd_floats = g + kTile;
  static constexpr int fwd_floats = gz;           // the forward stops at the features
};

__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

// The weights into shared memory: W0 (and with `transposed` W0^T) and w1.
template <int D>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w0,
                                              const float* __restrict__ w1, float* smem,
                                              bool transposed) {
  using S = Smem<D>;
  for (int e = threadIdx.x; e < D * kH; e += kThreads) {
    const float v = w0[e];
    smem[S::w0 + e] = v;
    if (transposed) smem[S::w0t + (e % kH) * D + e / kH] = v;
  }
  for (int e = threadIdx.x; e < kH; e += kThreads) smem[S::w1 + e] = w1[e];
}

// A tile of features into shared memory, rows past n zero.
template <int D>
__device__ __forceinline__ void stage_features(const float* __restrict__ x, long long base,
                                               long long n, float* smem) {
  using S = Smem<D>;
  constexpr int kQ = D / 4;
  for (int e = threadIdx.x; e < kTile * kQ; e += kThreads) {
    const int p = e / kQ, q = e % kQ;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (base + p < n) v = *reinterpret_cast<const float4*>(x + (base + p) * D + 4 * q);
    *reinterpret_cast<float4*>(smem + S::xs + p * S::kXS + 4 * q) = v;
  }
}

// z for the thread's 8 points (pg + 16 i) x 4 hidden units (4 hg + j): each sum
// over the features in order 0 .. D - 1, one FMA chain. The forward and the
// backward's recomputation both take this code, so their ReLU masks agree.
template <int D>
__device__ __forceinline__ void hidden_tile(const float* smem, int pg, int hg,
                                            float (&z)[kPT][4]) {
  using S = Smem<D>;
#pragma unroll
  for (int i = 0; i < kPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float4 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = *reinterpret_cast<const float4*>(smem + S::w0 + (4 * d4 + k) * kH + 4 * hg);
#pragma unroll
    for (int i = 0; i < kPT; ++i) {
      const float4 xv =
          *reinterpret_cast<const float4*>(smem + S::xs + (pg + kPG * i) * S::kXS + 4 * d4);
      const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z[i][0] = __fmaf_rn(xk[k], w[k].x, z[i][0]);
        z[i][1] = __fmaf_rn(xk[k], w[k].y, z[i][1]);
        z[i][2] = __fmaf_rn(xk[k], w[k].z, z[i][2]);
        z[i][3] = __fmaf_rn(xk[k], w[k].w, z[i][3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
sigma_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                     const float* __restrict__ w1, long long n, long long tiles,
                     float* __restrict__ sigma) {
  extern __shared__ __align__(16) float smem[];
  using S = Smem<D>;
  stage_weights<D>(w0, w1, smem, false);
  const int hg = threadIdx.x % kHG, pg = threadIdx.x / kHG;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kTile;
    __syncthreads();  // the last tile's features are read; the weights are staged
    stage_features<D>(x, base, n, smem);
    __syncthreads();
    float z[kPT][4];
    hidden_tile<D>(smem, pg, hg, z);
    const float4 w1v = *reinterpret_cast<const float4*>(smem + S::w1 + 4 * hg);
#pragma unroll
    for (int i = 0; i < kPT; ++i) {
      float s = relu(z[i][0]) * w1v.x;
      s = __fmaf_rn(relu(z[i][1]), w1v.y, s);
      s = __fmaf_rn(relu(z[i][2]), w1v.z, s);
      s = __fmaf_rn(relu(z[i][3]), w1v.w, s);
      // The point's 16 threads are 16 consecutive lanes; an xor tree gives every
      // one of them the same bits.
#pragma unroll
      for (int m = kHG / 2; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      const long long p = base + pg + kPG * i;
      if (hg == i && p < n) sigma[p] = s;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
sigma_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                     const float* __restrict__ w1, const float* __restrict__ g, long long n,
                     long long tiles, float* __restrict__ dx, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  using S = Smem<D>;
  constexpr int kDG = D / 4;            // feature groups of 4
  constexpr int kU = kDG * kHG;         // dW0 units of 4 x 4
  constexpr int kKS = kThreads / kU;    // interleaved point sets of a tile for dW0
  constexpr int kCount = D * kH + kH;   // a block's partial
  static_assert(D % 4 == 0 && kKS >= 1, "D a multiple of 4, at most kThreads / 4");
  static_assert((kKS - 1) * kU * 16 <= kTile * kGZ + kTile && kPG * kH <= kTile * S::kXS,
                "the partial's scratch fits in the gz and feature buffers");
  stage_weights<D>(w0, w1, smem, true);
  const int tid = threadIdx.x;
  const int hg = tid % kHG, pg = tid / kHG;
  // dW0: unit (dg, hg2) of the point set ks.
  const int ks = tid / kU, u = tid % kU, dg = u % kDG, hg2 = u / kDG;
  float dw0[4][4], dw1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dw1[k] = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) dw0[k][m] = 0.f;
  }
  // The block's contiguous range of tiles.
  const long long t0 = blockIdx.x * tiles / gridDim.x;
  const long long t1 = (blockIdx.x + 1) * tiles / gridDim.x;
  for (long long t = t0; t < t1; ++t) {
    const long long base = t * kTile;
    const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
    __syncthreads();  // the last tile's buffers are read; the weights are staged
    stage_features<D>(x, base, n, smem);
    for (int p = tid; p < kTile; p += kThreads) smem[S::g + p] = p < valid ? g[base + p] : 0.f;
    __syncthreads();
    {
      float z[kPT][4];
      hidden_tile<D>(smem, pg, hg, z);
      const float4 w1v = *reinterpret_cast<const float4*>(smem + S::w1 + 4 * hg);
#pragma unroll
      for (int i = 0; i < kPT; ++i) {
        const int p = pg + kPG * i;
        const float gi = smem[S::g + p];
        dw1[0] = __fmaf_rn(relu(z[i][0]), gi, dw1[0]);
        dw1[1] = __fmaf_rn(relu(z[i][1]), gi, dw1[1]);
        dw1[2] = __fmaf_rn(relu(z[i][2]), gi, dw1[2]);
        dw1[3] = __fmaf_rn(relu(z[i][3]), gi, dw1[3]);
        float4 gz;
        gz.x = z[i][0] <= 0.f ? 0.f : gi * w1v.x;
        gz.y = z[i][1] <= 0.f ? 0.f : gi * w1v.y;
        gz.z = z[i][2] <= 0.f ? 0.f : gi * w1v.z;
        gz.w = z[i][3] <= 0.f ? 0.f : gi * w1v.w;
        *reinterpret_cast<float4*>(smem + S::gz + p * kGZ + 4 * hg) = gz;
      }
    }
    __syncthreads();
    {
      // dx = gz W0^T: unit (pq, dg) takes the points pq + 32 j, 4 features each,
      // every sum over the hidden units in order.
      for (int e = tid; e < (kTile / 4) * kDG; e += kThreads) {
        const int xdg = e % kDG, pq = e / kDG;
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[j][m] = 0.f;
#pragma unroll 4
        for (int h4 = 0; h4 < kHG; ++h4) {
          float4 w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = *reinterpret_cast<const float4*>(smem + S::w0t + (4 * h4 + k) * D + 4 * xdg);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 gv =
                *reinterpret_cast<const float4*>(smem + S::gz + (pq + 32 * j) * kGZ + 4 * h4);
            const float gk[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[j][0] = __fmaf_rn(gk[k], w[k].x, acc[j][0]);
              acc[j][1] = __fmaf_rn(gk[k], w[k].y, acc[j][1]);
              acc[j][2] = __fmaf_rn(gk[k], w[k].z, acc[j][2]);
              acc[j][3] = __fmaf_rn(gk[k], w[k].w, acc[j][3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = pq + 32 * j;
          if (p < valid)
            *reinterpret_cast<float4*>(dx + (base + p) * D + 4 * xdg) =
                make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        }
      }
    }
    if (ks < kKS) {
      // dW0 += x^T gz over the tile's points ks, ks + kKS, ... in order.
      for (int p = ks; p < valid; p += kKS) {
        const float4 xv = *reinterpret_cast<const float4*>(smem + S::xs + p * S::kXS + 4 * dg);
        const float4 gv = *reinterpret_cast<const float4*>(smem + S::gz + p * kGZ + 4 * hg2);
        const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dw0[k][0] = __fmaf_rn(xk[k], gv.x, dw0[k][0]);
          dw0[k][1] = __fmaf_rn(xk[k], gv.y, dw0[k][1]);
          dw0[k][2] = __fmaf_rn(xk[k], gv.z, dw0[k][2]);
          dw0[k][3] = __fmaf_rn(xk[k], gv.w, dw0[k][3]);
        }
      }
    }
  }
  // The block's partial: the point sets' dW0 added in set order, the point groups'
  // dW1 in group order, each entry written once.
  __syncthreads();
  float* scratch = smem + S::gz;  // (kKS - 1) x kU x 16 floats
  float* scratch1 = smem + S::xs;  // kPG x kH floats
  if (ks >= 1 && ks < kKS) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) scratch[((ks - 1) * kU + u) * 16 + 4 * k + m] = dw0[k][m];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) scratch1[pg * kH + 4 * hg + j] = dw1[j];
  __syncthreads();
  float* part = partial + static_cast<long long>(blockIdx.x) * kCount;
  if (ks == 0) {
    for (int s = 1; s < kKS; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) dw0[k][m] += scratch[((s - 1) * kU + u) * 16 + 4 * k + m];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(part + (4 * dg + k) * kH + 4 * hg2) =
          make_float4(dw0[k][0], dw0[k][1], dw0[k][2], dw0[k][3]);
  }
  if (tid < kH) {
    float s = scratch1[tid];
    for (int q = 1; q < kPG; ++q) s += scratch1[q * kH + tid];
    part[D * kH + tid] = s;
  }
}

// grads[e] = the blocks' partials of entry e summed in block order: slice r of a
// column takes the blocks r, r + 8, ... in order, then the slices are added in order.
__global__ void __launch_bounds__(kThreads)
sigma_mlp_dw_reduce_kernel(const float* __restrict__ partial, int blocks, int count,
                           float* __restrict__ grads) {
  __shared__ float sums[kSlices][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < count)
    for (int b = slice; b < blocks; b += kSlices)
      s += partial[static_cast<long long>(b) * count + e];
  sums[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && e < count) {
    float total = sums[0][lane];
    for (int r = 1; r < kSlices; ++r) total += sums[r][lane];
    grads[e] = total;
  }
}

using FwdFn = void (*)(const float*, const float*, const float*, long long, long long, float*);
using BwdFn = void (*)(const float*, const float*, const float*, const float*, long long,
                       long long, float*, float*);

// The feature counts built: every multiple of 4 (a row is read as float4) up to 64,
// where the backward's shared memory is 103 KB. cfg/'s heads take 12 (box_room_tiny.yaml's
// 6 levels) and 32 (16 levels), x 2 features a level.
#define LT_SIGMA_MLP_DS(X) \
  X(4) X(8) X(12) X(16) X(20) X(24) X(28) X(32) X(36) X(40) X(44) X(48) X(52) X(56) X(60) X(64)

bool choose(int d, int h, FwdFn* fwd, BwdFn* bwd, int* fwd_floats, int* bwd_floats) {
  if (h != kH) return false;
  switch (d) {
#define LT_CASE(DD)                                   \
  case DD:                                            \
    *fwd = sigma_mlp_fwd_kernel<DD>;                  \
    *bwd = sigma_mlp_bwd_kernel<DD>;                  \
    *fwd_floats = Smem<DD>::fwd_floats;               \
    *bwd_floats = Smem<DD>::bwd_floats;               \
    return true;
    LT_SIGMA_MLP_DS(LT_CASE)
#undef LT_CASE
    default:
      return false;
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// 1 if the kernels take a head of d features and h hidden units, else 0.
extern "C" int lt_sigma_mlp_supported(int d, int h) {
  FwdFn fwd;
  BwdFn bwd;
  int ff, bf;
  return choose(d, h, &fwd, &bwd, &ff, &bf) ? 1 : 0;
}

// The backward's grid (its partials' count) for n points.
extern "C" long long lt_sigma_mlp_bwd_grid(long long n) {
  const long long t = tiles_of(n);
  return t < kBwdBlocks ? t : kBwdBlocks;
}

extern "C" int lt_sigma_mlp_fwd(const float* x, const float* w0, const float* w1, long long n,
                                int d, int h, float* sigma, void* stream) {
  FwdFn fwd;
  BwdFn bwd;
  int ff, bf;
  if (n <= 0 || !choose(d, h, &fwd, &bwd, &ff, &bf))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fwd),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * ff);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = tiles_of(n);
  const int grid = static_cast<int>(tiles < kFwdBlocks ? tiles : kFwdBlocks);
  fwd<<<grid, kThreads, 4 * ff, static_cast<cudaStream_t>(stream)>>>(x, w0, w1, n, tiles, sigma);
  return static_cast<int>(cudaGetLastError());
}

// dx (N x d), then dW0 (d x h, row-major) and dW1 (h) into grads through partial
// (lt_sigma_mlp_bwd_grid(n) x (d h + h) floats).
extern "C" int lt_sigma_mlp_bwd(const float* x, const float* w0, const float* w1, const float* g,
                                long long n, int d, int h, float* dx, float* partial,
                                float* grads, void* stream) {
  FwdFn fwd;
  BwdFn bwd;
  int ff, bf;
  if (n <= 0 || !choose(d, h, &fwd, &bwd, &ff, &bf))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(bwd),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * bf);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = tiles_of(n);
  const int grid = static_cast<int>(lt_sigma_mlp_bwd_grid(n));
  bwd<<<grid, kThreads, 4 * bf, s>>>(x, w0, w1, g, n, tiles, dx, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count = d * h + h;
  sigma_mlp_dw_reduce_kernel<<<(count + 31) / 32, kThreads, 0, s>>>(partial, grid, count, grads);
  return static_cast<int>(cudaGetLastError());
}
