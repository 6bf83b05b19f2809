// Multiresolution hash-grid encode, forward and backward, for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package computes this function in XLA
// (loner_tpu/models/hash_encoding.py::hash_encode and the custom VJP
// hash_encode_vjp). It gets a hand-written kernel here because it is the training
// hot path of the reference's own field (2.1 M points an iteration at window 8) and
// because the plain form materialises (N, L, 8) int64 corner indices.
//
// For a point p in [0, 1]^3 (clipped) and each of L levels of resolution R_l:
//   scaled = p R_l, cell = min(floor(scaled), R_l - 1), frac = scaled - cell
//   corner k = 4 ix + 2 iy + iz at cell + (ix, iy, iz), weight wx[ix] wy[iy] wz[iz]
//     with wx = (1 - frac_x, frac_x), ...
//   index: dense levels x + y (R+1) + z (R+1)^2; hashed levels
//     (x * 1) ^ (y * 2654435761) ^ (z * 805459861) in uint32, masked to 2^log2 - 1;
//     plus the level's offset into the concatenated (T, 2) f32 table
//   out[l] = sum_k w_k table[idx_k]                        (f32 mode)
//   out[l] = bf16(sum_k bf16(bf16(table) bf16(w_k)))       (bf16 mode, f32 sum)
// Backward, for the upstream gradient g (N, 2L):
//   dtable[idx_k] += w_k g_l           (f32 atomics: the order changes per run)
//   dpos = clip_w * sum_l R_l dfrac_l, dfrac_x = sum_{iy,iz} (s[1,iy,iz] - s[0,iy,iz])
//     wy[iy] wz[iz] with s_k = <table[idx_k], g_l> (bf16-rounded table in bf16 mode),
//     clip_w 1 inside (0, 1), 1/2 at exactly 0 or 1, 0 outside.
// Every product and sum is a rounded intrinsic (no FMA contraction) in the order of
// the plain version (loner_tpu_torch/ops/hash_grid.py), so the forward and dpos match
// it to the bit; the table gradient matches it up to the order of the atomics.
//
// What bounds it: neither HBM bytes nor operations. Each point reads 12 bytes and
// writes 128 (forward), or reads 140 and writes 12 (backward); the whole table is 29.7
// MB at the reference's 16 levels x 2^18 and stays in the 50 MB L2. The bound that
// counts is L2 latency and atomic throughput: 8 random 8-byte gathers per (point,
// level), and in the backward 8 float2 atomics more, 268 M of them at 2.1 M points.
// Design, simple first: the forward runs one thread per (point, level), so a warp's
// 8-byte outputs are contiguous; the backward runs one thread per point, looping over
// the levels, so dpos is summed in registers in a fixed order and written once. The
// backward re-gathers the corner features from the table instead of saving the
// forward's (N, 8 L) residual (1.07 GB in bf16 at 2.1 M points): the table does not
// change between the two, so the values are the same. Per-warp aggregation of the
// atomics and shared-memory staging of the coarse levels are left for later.
//
// Plain C interface (no PyTorch headers); built by loner_tpu_torch/ops/build.py and
// bound with ctypes in loner_tpu_torch/ops/hash_grid.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr unsigned kPrime1 = 2654435761u;
constexpr unsigned kPrime2 = 805459861u;

struct Levels {
  int n_levels;
  unsigned hash_mask;
  unsigned res[kMaxLevels];
  unsigned offset[kMaxLevels];
  unsigned dense[kMaxLevels];
};

struct Corners {
  unsigned idx[8];
  float w[8];
  float wx[2], wy[2], wz[2];
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// The 8 corners of level l around p (already clipped to [0, 1]).
__device__ __forceinline__ void corners(const float p[3], const Levels& lv, int l, Corners& c) {
  const unsigned r = lv.res[l];
  const float rf = static_cast<float>(r);
  unsigned c0[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fmul_rn(p[a], rf);
    const float cell = fminf(floorf(s), rf - 1.0f);
    f[a] = __fsub_rn(s, cell);
    c0[a] = static_cast<unsigned>(cell);
  }
  c.wx[0] = __fsub_rn(1.0f, f[0]);
  c.wx[1] = f[0];
  c.wy[0] = __fsub_rn(1.0f, f[1]);
  c.wy[1] = f[1];
  c.wz[0] = __fsub_rn(1.0f, f[2]);
  c.wz[1] = f[2];
  const unsigned r1 = r + 1u;
  const bool dense = lv.dense[l] != 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k >> 2, iy = (k >> 1) & 1, iz = k & 1;
    const unsigned x = c0[0] + ix, y = c0[1] + iy, z = c0[2] + iz;
    const unsigned i = dense ? x + y * r1 + z * (r1 * r1)
                             : (x ^ (y * kPrime1) ^ (z * kPrime2)) & lv.hash_mask;
    c.idx[k] = i + lv.offset[l];
    c.w[k] = __fmul_rn(__fmul_rn(c.wx[ix], c.wy[iy]), c.wz[iz]);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    hash_fwd_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                    long long n, Levels lv, float2* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * lv.n_levels) return;
  const long long i = t / lv.n_levels;
  const int l = static_cast<int>(t - i * lv.n_levels);
  const float p[3] = {clip01(__ldg(pos + 3 * i)), clip01(__ldg(pos + 3 * i + 1)),
                      clip01(__ldg(pos + 3 * i + 2))};
  Corners c;
  corners(p, lv, l, c);
  float2 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __ldg(table + c.idx[k]);  // all 8 gathers in flight
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (kBf16) {
      const float w = bf16_round(c.w[k]);
      a0 = __fadd_rn(a0, bf16_round(__fmul_rn(bf16_round(v[k].x), w)));
      a1 = __fadd_rn(a1, bf16_round(__fmul_rn(bf16_round(v[k].y), w)));
    } else {
      a0 = __fadd_rn(a0, __fmul_rn(v[k].x, c.w[k]));
      a1 = __fadd_rn(a1, __fmul_rn(v[k].y, c.w[k]));
    }
  }
  if (kBf16) {
    a0 = bf16_round(a0);
    a1 = bf16_round(a1);
  }
  out[t] = make_float2(a0, a1);  // out[i, 2 l .. 2 l + 1]
}

__device__ __forceinline__ void atomic_add2(float2* dst, float x, float y) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, make_float2(x, y));  // one 8-byte reduction (sm_90)
#else
  atomicAdd(&dst->x, x);
  atomicAdd(&dst->y, y);
#endif
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    hash_bwd_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                    const float2* __restrict__ dout, long long n, Levels lv,
                    float2* __restrict__ dtable, float* __restrict__ dpos) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x[3] = {__ldg(pos + 3 * i), __ldg(pos + 3 * i + 1), __ldg(pos + 3 * i + 2)};
  const float p[3] = {clip01(x[0]), clip01(x[1]), clip01(x[2])};
  float d[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < lv.n_levels; ++l) {
    Corners c;
    corners(p, lv, l, c);
    const float2 g = __ldg(dout + i * lv.n_levels + l);
    float s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float2 v = __ldg(table + c.idx[k]);
      if (kBf16) {
        v.x = bf16_round(v.x);
        v.y = bf16_round(v.y);
      }
      s[k] = __fadd_rn(__fmul_rn(v.x, g.x), __fmul_rn(v.y, g.y));
      atomic_add2(dtable + c.idx[k], __fmul_rn(c.w[k], g.x), __fmul_rn(c.w[k], g.y));
    }
    float df[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        // x: corners (1, a, b) - (0, a, b); y: (a, 1, b) - (a, 0, b); z: (a, b, 1) - (a, b, 0).
        df[0] = __fadd_rn(df[0], __fmul_rn(__fsub_rn(s[4 + 2 * a + b], s[2 * a + b]),
                                           __fmul_rn(c.wy[a], c.wz[b])));
        df[1] = __fadd_rn(df[1], __fmul_rn(__fsub_rn(s[4 * a + 2 + b], s[4 * a + b]),
                                           __fmul_rn(c.wx[a], c.wz[b])));
        df[2] = __fadd_rn(df[2], __fmul_rn(__fsub_rn(s[4 * a + 2 * b + 1], s[4 * a + 2 * b]),
                                           __fmul_rn(c.wx[a], c.wy[b])));
      }
    }
    const float rf = static_cast<float>(lv.res[l]);
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = __fadd_rn(d[a], __fmul_rn(df[a], rf));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float cw = (x[a] > 0.0f && x[a] < 1.0f) ? 1.0f
                     : (x[a] == 0.0f || x[a] == 1.0f) ? 0.5f : 0.0f;
    dpos[3 * i + a] = __fmul_rn(d[a], cw);
  }
}

bool make_levels(int n_levels, unsigned hash_mask, const unsigned* res, const unsigned* offset,
                 const unsigned* dense, Levels* lv) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  lv->n_levels = n_levels;
  lv->hash_mask = hash_mask;
  for (int l = 0; l < n_levels; ++l) {
    if (res[l] < 1u) return false;
    lv->res[l] = res[l];
    lv->offset[l] = offset[l];
    lv->dense[l] = dense[l];
  }
  return true;
}

unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

}  // namespace

// out (n, 2 L) f32. The wrapper checks shapes, alignment and the 32-bit guards.
extern "C" int lt_hash_fwd(const float* pos, const float* table, long long n, int n_levels,
                           unsigned hash_mask, const unsigned* res, const unsigned* offset,
                           const unsigned* dense, int bf16, float* out, void* stream) {
  Levels lv;
  if (n < 1 || !make_levels(n_levels, hash_mask, res, offset, dense, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float2* t = reinterpret_cast<const float2*>(table);
  float2* o = reinterpret_cast<float2*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for(n * n_levels);
  if (bf16) {
    hash_fwd_kernel<true><<<grid, kThreads, 0, s>>>(pos, t, n, lv, o);
  } else {
    hash_fwd_kernel<false><<<grid, kThreads, 0, s>>>(pos, t, n, lv, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtable (T, 2) f32, zeroed by the caller; dpos (n, 3) f32.
extern "C" int lt_hash_bwd(const float* pos, const float* table, const float* dout, long long n,
                           int n_levels, unsigned hash_mask, const unsigned* res,
                           const unsigned* offset, const unsigned* dense, int bf16,
                           float* dtable, float* dpos, void* stream) {
  Levels lv;
  if (n < 1 || !make_levels(n_levels, hash_mask, res, offset, dense, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float2* t = reinterpret_cast<const float2*>(table);
  const float2* g = reinterpret_cast<const float2*>(dout);
  float2* dt = reinterpret_cast<float2*>(dtable);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for(n);
  if (bf16) {
    hash_bwd_kernel<true><<<grid, kThreads, 0, s>>>(pos, t, g, n, lv, dt, dpos);
  } else {
    hash_bwd_kernel<false><<<grid, kThreads, 0, s>>>(pos, t, g, n, lv, dt, dpos);
  }
  return static_cast<int>(cudaGetLastError());
}
