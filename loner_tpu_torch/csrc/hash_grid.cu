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
//   dtable[idx_k] += w_k g_l in fixed point: the f32 product scaled by 2^S (exact) and
//     rounded half to even to int64 (__float2ll_rn), summed in int64 (two's complement:
//     no order), converted to f32 once by the wrapper (loner_tpu_torch/ops/fixed_point.py)
//   dpos = clip_w * sum_l R_l dfrac_l, dfrac_x = sum_{iy,iz} (s[1,iy,iz] - s[0,iy,iz])
//     wy[iy] wz[iz] with s_k = <table[idx_k], g_l> (bf16-rounded table in bf16 mode),
//     clip_w 1 inside (0, 1), 1/2 at exactly 0 or 1, 0 outside.
// Every product and sum is a rounded intrinsic (no FMA contraction) in the order of
// the plain version (loner_tpu_torch/ops/hash_grid.py), so the forward and dpos match
// it to the bit; the table gradient's integer sums match it to the bit too, and are
// the same under any permutation of the points and when the points are split into
// parts whose int64 sums are added (a mesh's ranks).
//
// S = 40 (fixed_point.HASH_BITS), from readings on an H100 (chip_smoke.py phases 10,
// 11 and 18; PERF.md section 6): the reference's 150-scan SLAM run summed at most
// 13.0 of |w_k g| into one call's sums (14.3 bits below the guard's 2^58), its largest
// contribution was 8.6e-4 and its largest entry sum 2.2e-2 (28.5 bits below 2^63).
// The kernel adds every |w_k g| into mag[0] (an f32 sum a block, one atomic a block)
// and keeps the largest in mag[1]; the wrapper flags a sum whose magnitude passes
// 2^(58 - S), so no partial sum of any order or of up to 16 added parts wraps.
//
// What bounds it on this card: neither HBM bytes nor operations. Each point reads 12
// bytes and writes 128 (forward), or reads 140 and writes 12 (backward); the table is
// 29.7 MB at the reference's 16 levels x 2^18 and stays in the 50 MB L2. What counts
// is L2 traffic: 8 gathers of 8 bytes per (point, level), and in the backward up to 16
// 8-byte integer reductions (Hopper has no vector form of the integer atomic), which
// serialise at one L2 slice when many lanes add to one entry. In a mapping iteration
// the points come ray by ray, each ray's samples sorted along it, so on the coarse
// levels (up to ~7) neighbouring samples share cells.
//
// Design: level-major blocks of kPoints consecutive points x all levels (the backward:
// x the levels of one launch); a warp task is 32 consecutive points of one level, so a
// ray's samples that share a cell gather it, and add to it, in one instruction. Points
// and the upstream gradient are read into shared memory once a block; the forward's
// outputs are staged there and written back as whole rows. The two x-neighbour corners
// of a cell are adjacent entries on a dense level and, when the cell's x is even, on a
// hashed one; when they form one aligned 16-byte pair the forward loads them with one
// float4. The backward converts each term to int64, sums each x-pair's terms over every
// run of lanes that add to the same entries (a segmented shuffle scan) and only the
// run's last lane adds; lanes add in pairs, one entry's two features an instruction
// (see scatter). The int64 sums of all 16 levels are 59 MB, more than the L2: the
// wrapper launches the levels in groups whose slice is at most ops/hash_grid.py::
// BWD_GROUP_BYTES (24 MB), and dpos carries its running level sum across the groups in
// the plain version's order. Without dpos (frozen poses: a null dpos) the backward
// neither re-gathers the corners nor forms their dot products; with dpos each lane
// writes R_l dfrac to shared memory and, after the block's barrier, one thread a point
// sums the group's levels in order, so dpos keeps the plain version's bits.
// Levers (PERF.md section 6; an H100 at 700 W, ms of the backward at 2,097,152 bf16
// points, ray order with dpos / without, random with dpos): the f32-atomic design this
// replaced, 2.905 / 1.503, 6.768 (not exact); this kernel with all levels in one
// launch, 4.928 / 3.206, 10.529; in level groups of 32 / 24 / 16 / 8 MB, 4.015 / 2.572,
// 6.355; 3.279 / 2.749, 5.173; 3.244 / 2.757, 5.154; 3.868 / 3.181, 5.426
// (analysis/hash_breakdown.py). Each lane adding its own four values, in place of the
// lane pairs, was slower at every budget. Earlier, for the f32 design: __match_any_sync
// with a lane-ordered leader sum, no aggregation, float2 atomics only, 128-point blocks
// and 8 blocks an SM were all slower; the forward without the float4 pair loads too.
// Level 0 of the table gradient in shared memory was not tried.
//
// Plain C interface (no PyTorch headers); built by loner_tpu_torch/ops/build.py and
// bound with ctypes in loner_tpu_torch/ops/hash_grid.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
// Launch bounds (kThreads, 1): ptxas then gives the kernels more registers than with
// the thread count alone (ptxas -v in chip_smoke.py); the forward runs 2.6% faster at
// ray order, 2.4% slower at random points (PERF.md section 6).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 64;            // points a block
constexpr int kChunks = kPoints / 32;  // warp tasks a level: 32 consecutive points each
constexpr int kStride = kPoints + 1;   // float2 row of one level in shared memory, padded
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoEntry = ~0ull;  // the key of a lane past the last point
constexpr unsigned kPrime1 = 2654435761u;
constexpr unsigned kPrime2 = 805459861u;
constexpr size_t kStaticSmemLimit = 48 * 1024;

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

// Corners k and k + 4 differ only in x. On a dense level their entries are adjacent;
// on a hashed level too whenever the cell's x is even ((x + 1) ^ h = (x ^ h) ^ 1).
// When both lie in one aligned 16-byte pair of entries, one float4 load takes them.
__device__ __forceinline__ bool one_pair(unsigned a, unsigned b) { return ((a ^ b) >> 1) == 0u; }

__device__ __forceinline__ void gather(const float2* __restrict__ table, bool paired,
                                       const Corners& c, float2 v[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned a = c.idx[k], b = c.idx[k + 4];
    if (paired && one_pair(a, b)) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(table) + (a >> 1));
      const float2 lo = make_float2(q.x, q.y), hi = make_float2(q.z, q.w);
      v[k] = (a & 1u) ? hi : lo;
      v[k + 4] = (a & 1u) ? lo : hi;
    } else {
      v[k] = __ldg(table + a);
      v[k + 4] = __ldg(table + b);
    }
  }
}

// Rows [i0, i0 + nb) of an (n, L) float2 array, src = its row i0, columns [l0, l0 + lg),
// into shared memory as s[(l - l0) * kStride + p]: 16-byte accesses when L, l0 and lg
// are even and the rows are 16-byte aligned, 8-byte ones otherwise. The padded stride
// keeps both sides free of bank conflicts.
__device__ __forceinline__ void stage_in(const float2* __restrict__ src, int nb, int L, int l0,
                                         int lg, bool vec, float2* s) {
  if (vec) {
    const int half = lg >> 1;
    for (int q = threadIdx.x; q < nb * half; q += kThreads) {
      const int p = q / half, j = q - p * half;
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + p * L + l0) + j);
      s[2 * j * kStride + p] = make_float2(v.x, v.y);
      s[(2 * j + 1) * kStride + p] = make_float2(v.z, v.w);
    }
  } else {
    for (int q = threadIdx.x; q < nb * lg; q += kThreads) {
      const int p = q / lg, l = q - p * lg;
      s[l * kStride + p] = __ldg(src + p * L + l0 + l);
    }
  }
}

__device__ __forceinline__ void stage_out(float2* __restrict__ dst, int nb, int L, bool vec,
                                          const float2* s) {
  if (vec) {
    const int half = L >> 1;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int q = threadIdx.x; q < nb * half; q += kThreads) {
      const int p = q / half, j = q - p * half;
      const float2 a = s[2 * j * kStride + p], b = s[(2 * j + 1) * kStride + p];
      dst4[q] = make_float4(a.x, a.y, b.x, b.y);
    }
  } else {
    for (int q = threadIdx.x; q < nb * L; q += kThreads) {
      const int p = q / L, l = q - p * L;
      dst[q] = s[l * kStride + p];
    }
  }
}

// Level-major: a block takes kPoints consecutive points and every level; a warp task
// is 32 consecutive points of one level, so the samples of one ray that share a
// coarse cell gather it in one instruction. Points are read once into shared memory,
// the (kPoints, L) outputs staged there and written back as whole rows.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    hash_fwd_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                    long long n, Levels lv, bool paired, bool vec, float2* __restrict__ out) {
  extern __shared__ float4 smem[];
  float* s_pos = reinterpret_cast<float*>(smem);                 // [kPoints][3]
  float2* s_out = reinterpret_cast<float2*>(s_pos + 3 * kPoints);  // [L][kStride]
  const int L = lv.n_levels;
  const long long i0 = static_cast<long long>(blockIdx.x) * kPoints;
  const int nb = static_cast<int>(min(static_cast<long long>(kPoints), n - i0));
  for (int t = threadIdx.x; t < 3 * nb; t += kThreads) s_pos[t] = __ldg(pos + 3 * i0 + t);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = warp; task < kChunks * L; task += kWarps) {
    const int l = task / kChunks, p = (task % kChunks) * 32 + lane;
    if (p >= nb) continue;
    const float x[3] = {clip01(s_pos[3 * p]), clip01(s_pos[3 * p + 1]),
                        clip01(s_pos[3 * p + 2])};
    Corners c;
    corners(x, lv, l, c);
    float2 v[8];
    gather(table, paired, c, v);  // all 8 corners in flight
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
    s_out[l * kStride + p] = make_float2(a0, a1);
  }
  __syncthreads();
  stage_out(out + i0 * L, nb, L, vec, s_out);
}

// Sum v over each run of equal keys on consecutive lanes (the samples of one ray that
// share a cell), in int64 (two's complement, so the order does not matter); true on
// the run's last lane, which holds the sum. Every lane of the warp takes part.
template <int V>
__device__ __forceinline__ bool run_sum(unsigned long long key, unsigned long long (&v)[V],
                                        int lane) {
  const unsigned long long prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  if (heads == kFull) return true;  // no two neighbours share an entry
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
  const int span =
      static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(lane - start)));
  for (int d = 1; d <= span; d <<= 1) {
    unsigned long long u[V];
#pragma unroll
    for (int j = 0; j < V; ++j) u[j] = __shfl_up_sync(kFull, v[j], d);
    if (lane - d >= start) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] += u[j];
    }
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

// w g in fixed point: the f32 product scaled by 2^S (exact) and rounded half to even
// to int64, the plain version's torch.round; held as unsigned for wrapping adds.
__device__ __forceinline__ unsigned long long to_fixed(float c, float scale) {
  return static_cast<unsigned long long>(__float2ll_rn(__fmul_rn(c, scale)));
}

// The table gradient of one (point, level): w_k g added to entry idx_k in int64
// fixed point, first summed over each run of lanes that add to the same entries (the
// run's last lane holds the sum). The reductions go out in lane pairs: lanes 2m and
// 2m + 1 add one entry's two features (16 contiguous bytes) in one instruction, the
// even lane feature 0 and the odd lane feature 1, first for the even lane's x-corner
// pair of entries, then for the odd lane's; each lane hands its partner the feature
// the partner adds for it. The L2 then takes half as many sectors an instruction as
// with each lane adding its own four values. |w_k g| goes into the lane's magnitude
// sum and maximum (the guard of ops/fixed_point.py).
__device__ __forceinline__ void scatter(const Corners& c, float2 g, bool valid, float scale,
                                        int lane, unsigned long long* __restrict__ dacc,
                                        float& mag_sum, float& mag_max) {
  const bool odd = lane & 1;
  const size_t feature = odd ? 1 : 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned a = c.idx[k], b = c.idx[k + 4];
    const unsigned long long key =
        valid ? (static_cast<unsigned long long>(b) << 32 | a) : kNoEntry;
    const float f[4] = {__fmul_rn(c.w[k], g.x), __fmul_rn(c.w[k], g.y),
                        __fmul_rn(c.w[k + 4], g.x), __fmul_rn(c.w[k + 4], g.y)};
    unsigned long long v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = to_fixed(f[j], scale);
      mag_sum += fabsf(f[j]);
      mag_max = fmaxf(mag_max, fabsf(f[j]));
    }
    const bool lead = run_sum<4>(key, v, lane) && valid;
    const bool partner_leads = __shfl_xor_sync(kFull, lead ? 1 : 0, 1) != 0;
    const unsigned pa = __shfl_xor_sync(kFull, a, 1), pb = __shfl_xor_sync(kFull, b, 1);
    // Mine: this lane's feature of its own entries; theirs: its feature of the partner's.
    const unsigned long long theirs_a = __shfl_xor_sync(kFull, odd ? v[0] : v[1], 1);
    const unsigned long long theirs_b = __shfl_xor_sync(kFull, odd ? v[2] : v[3], 1);
    const unsigned long long mine_a = odd ? v[1] : v[0], mine_b = odd ? v[3] : v[2];
    // First the even lane's entries, then the odd lane's.
    if (odd ? partner_leads : lead) {
      atomicAdd(dacc + 2 * static_cast<size_t>(odd ? pa : a) + feature, odd ? theirs_a : mine_a);
      atomicAdd(dacc + 2 * static_cast<size_t>(odd ? pb : b) + feature, odd ? theirs_b : mine_b);
    }
    if (odd ? lead : partner_leads) {
      atomicAdd(dacc + 2 * static_cast<size_t>(odd ? a : pa) + feature, odd ? mine_a : theirs_a);
      atomicAdd(dacc + 2 * static_cast<size_t>(odd ? b : pb) + feature, odd ? mine_b : theirs_b);
    }
  }
}

// The block's magnitude sum and maximum into mag[0] (an f32 atomic add) and mag[1]
// (an integer max on the bits of a non-negative float). Every thread takes part.
__device__ __forceinline__ void add_magnitude(float mag_sum, float mag_max, float* mag) {
  __shared__ float s_mag[2][kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mag_sum += __shfl_xor_sync(kFull, mag_sum, o);
    mag_max = fmaxf(mag_max, __shfl_xor_sync(kFull, mag_max, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_mag[0][warp] = mag_sum;
    s_mag[1][warp] = mag_max;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, b = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      a += s_mag[0][w];
      b = fmaxf(b, s_mag[1][w]);
    }
    atomicAdd(mag, a);
    atomicMax(reinterpret_cast<int*>(mag + 1), __float_as_int(b));
  }
}

// Level-major as the forward, over the levels [l0, l0 + lg) of one launch (a group
// whose slice of the int64 sums stays in L2). A warp task adds its 32 points' table
// gradient for one level to the int64 sums, each entry once per run of lanes that
// share it. With kDpos it also re-gathers the corners (with the forward's pair loads
// where `paired`; without dpos nothing is gathered), writes R_l dfrac of each
// (point, level) to shared memory, and after the block's barrier one thread a point
// adds the group's levels in order to the running sum dpos holds (from 0 in the first
// group) and, in the last group, applies the clip's weight: the plain version's
// sequential sum over the levels, split across launches.
template <bool kBf16, bool kDpos>
__global__ void __launch_bounds__(kThreads, 1)
    hash_bwd_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                    const float2* __restrict__ dout, long long n, Levels lv, int l0, int lg,
                    bool first, bool last, bool paired, bool vec, float scale,
                    unsigned long long* __restrict__ dacc, float* __restrict__ mag,
                    float* __restrict__ dpos) {
  extern __shared__ float4 smem[];
  const int L = lv.n_levels;
  float* s_pos = reinterpret_cast<float*>(smem);                 // [kPoints][3], as given
  float2* s_g = reinterpret_cast<float2*>(s_pos + 3 * kPoints);  // [lg][kStride]
  float* s_df = reinterpret_cast<float*>(s_g + lg * kStride);    // [lg][kPoints][3]
  const long long i0 = static_cast<long long>(blockIdx.x) * kPoints;
  const int nb = static_cast<int>(min(static_cast<long long>(kPoints), n - i0));
  for (int t = threadIdx.x; t < 3 * nb; t += kThreads) s_pos[t] = __ldg(pos + 3 * i0 + t);
  stage_in(dout + i0 * L, nb, L, l0, lg, vec, s_g);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float mag_sum = 0.0f, mag_max = 0.0f;
  for (int task = warp; task < kChunks * lg; task += kWarps) {
    // Lanes past the last point stay in the warp for its collectives, on point 0's
    // corners with a key no entry has, and add nothing.
    const int j = task / kChunks, l = l0 + j, p = (task % kChunks) * 32 + lane;
    const bool valid = p < nb;
    const int q = valid ? p : 0;
    const float x[3] = {clip01(s_pos[3 * q]), clip01(s_pos[3 * q + 1]),
                        clip01(s_pos[3 * q + 2])};
    const float2 g = valid ? s_g[j * kStride + p] : make_float2(0.0f, 0.0f);
    Corners c;
    corners(x, lv, l, c);
    if (kDpos && valid) {
      float2 v[8];
      gather(table, paired, c, v);
      float s[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (kBf16) {
          v[k].x = bf16_round(v[k].x);
          v[k].y = bf16_round(v[k].y);
        }
        s[k] = __fadd_rn(__fmul_rn(v[k].x, g.x), __fmul_rn(v[k].y, g.y));
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
      float* d = s_df + (j * kPoints + p) * 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) d[a] = __fmul_rn(df[a], rf);
    }
    scatter(c, g, valid, scale, lane, dacc, mag_sum, mag_max);
  }
  add_magnitude(mag_sum, mag_max, mag);  // its barrier also orders s_df for the dpos sum
  if (!kDpos) return;
  for (int p = threadIdx.x; p < nb; p += kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float* out = dpos + 3 * (i0 + p) + a;
      float d = first ? 0.0f : *out;
      for (int j = 0; j < lg; ++j) d = __fadd_rn(d, s_df[(j * kPoints + p) * 3 + a]);
      if (last) {
        const float xa = s_pos[3 * p + a];
        const float cw = (xa > 0.0f && xa < 1.0f)     ? 1.0f
                         : (xa == 0.0f || xa == 1.0f) ? 0.5f
                                                      : 0.0f;
        d = __fmul_rn(d, cw);
      }
      *out = d;
    }
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launch with `smem` bytes of dynamic shared memory (above 48 KB only after the
// kernel's opt-in) and return the launch's error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long n, size_t smem, cudaStream_t s, Args... args) {
  if (smem > kStaticSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((n + kPoints - 1) / kPoints);
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

size_t staged_bytes(int n_levels) {
  return 3 * kPoints * sizeof(float) + static_cast<size_t>(n_levels) * kStride * sizeof(float2);
}

}  // namespace

// out (n, 2 L) f32. The wrapper checks shapes, 8-byte alignment and the 32-bit guards.
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
  const bool paired = aligned16(table);
  const bool vec = n_levels % 2 == 0 && aligned16(out);
  const size_t smem = staged_bytes(n_levels);
  return bf16 ? launch(hash_fwd_kernel<true>, n, smem, s, pos, t, n, lv, paired, vec, o)
              : launch(hash_fwd_kernel<false>, n, smem, s, pos, t, n, lv, paired, vec, o);
}

// The levels [l0, l0 + lg) of the backward (a group; the wrapper launches the groups
// in order). dacc (T, 2) int64: the table gradient's fixed-point sums at scale (2^S),
// added to (the caller zeroes them or keeps adding); mag (2,) f32: the sum of every
// |w_k g| added to, and the largest (max'ed); dpos (n, 3) f32: the running sum over the
// levels, begun in the first group and weighted by the clip in the last; or null when
// the position gradient is not needed (frozen poses): then the kernel neither
// re-gathers the corners nor forms their dot products.
extern "C" int lt_hash_bwd(const float* pos, const float* table, const float* dout, long long n,
                           int n_levels, unsigned hash_mask, const unsigned* res,
                           const unsigned* offset, const unsigned* dense, int bf16, int l0,
                           int lg, int first, int last, float scale, long long* dacc, float* mag,
                           float* dpos, void* stream) {
  Levels lv;
  if (n < 1 || !make_levels(n_levels, hash_mask, res, offset, dense, &lv) || l0 < 0 || lg < 1 ||
      l0 + lg > n_levels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float2* t = reinterpret_cast<const float2*>(table);
  const float2* g = reinterpret_cast<const float2*>(dout);
  unsigned long long* dt = reinterpret_cast<unsigned long long*>(dacc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool paired = aligned16(table);
  const bool vec = n_levels % 2 == 0 && l0 % 2 == 0 && lg % 2 == 0 && aligned16(dout);
  const bool f = first != 0, z = last != 0;
  size_t smem = staged_bytes(lg);
  if (dpos == nullptr) {
    return bf16 ? launch(hash_bwd_kernel<true, false>, n, smem, s, pos, t, g, n, lv, l0, lg, f, z,
                         paired, vec, scale, dt, mag, dpos)
                : launch(hash_bwd_kernel<false, false>, n, smem, s, pos, t, g, n, lv, l0, lg, f,
                         z, paired, vec, scale, dt, mag, dpos);
  }
  smem += static_cast<size_t>(lg) * kPoints * 3 * sizeof(float);
  return bf16 ? launch(hash_bwd_kernel<true, true>, n, smem, s, pos, t, g, n, lv, l0, lg, f, z,
                       paired, vec, scale, dt, mag, dpos)
              : launch(hash_bwd_kernel<false, true>, n, smem, s, pos, t, g, n, lv, l0, lg, f, z,
                       paired, vec, scale, dt, mag, dpos);
}
