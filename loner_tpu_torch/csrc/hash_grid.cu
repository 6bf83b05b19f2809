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
// it to the bit; the table gradient matches it up to the order of the float additions.
//
// What bounds it on this card: neither HBM bytes nor operations. Each point reads 12
// bytes and writes 128 (forward), or reads 140 and writes 12 (backward); the table is
// 29.7 MB at the reference's 16 levels x 2^18 and stays in the 50 MB L2. What counts
// is L2 traffic: 8 gathers of 8 bytes per (point, level), and in the backward as many
// float atomics, which serialise at one L2 slice when many lanes add to one entry. In
// a mapping iteration the points come ray by ray, each ray's samples sorted along it,
// so on the coarse levels (up to ~7) neighbouring samples share cells.
//
// Design: level-major blocks of kPoints consecutive points x all levels; a warp task
// is 32 consecutive points of one level, so a ray's samples that share a cell gather
// it, and add to it, in one instruction. Points and the upstream gradient are read
// into shared memory once a block; the forward's outputs are staged there and written
// back as whole rows. The two x-neighbour corners of a cell are adjacent entries on a
// dense level and, when the cell's x is even, on a hashed one; when they form one
// aligned 16-byte pair the forward loads them with one float4 and the backward adds
// to them with one float4 atomic. The backward sums each x-pair's terms over every run
// of lanes that add to the same entries (a segmented shuffle scan, a fixed tree order)
// and only the run's last lane issues the atomics. Without dpos (frozen poses: a null
// dpos) it neither re-gathers the corners nor forms their dot products; with dpos each
// lane writes R_l dfrac to shared memory and, after the block's barrier, one thread a
// point sums the levels in order, so dpos keeps the plain version's bits.
// Levers tried and dropped (PERF.md section 6; ab_compare.py on an H100 at 700 W, ms
// of the backward at 2,097,152 ray-ordered points with dpos / without, against 2.734 /
// 1.361 for this design in the same calls): __match_any_sync with a lane-ordered
// leader sum, 2.748 / 1.714; no aggregation (the level-major split alone), 5.569 /
// 3.135; float2 atomics only, 3.061 / 1.724; 128-point blocks, 2.732 / 1.367 and 3-6%
// slower at the bootstrap's 262,144 points; 8 blocks an SM (32 registers, spills),
// 4.440 / 1.781. The forward without the float4 pair loads: 0.762 ms against 0.742.
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

// Rows [i0, i0 + nb) of an (n, L) float2 array, src = its row i0, into shared memory
// as s[l * kStride + p] (and back): 16-byte accesses when L is even and the rows are
// 16-byte aligned, 8-byte ones otherwise. The padded stride keeps both sides free of
// bank conflicts.
__device__ __forceinline__ void stage_in(const float2* __restrict__ src, int nb, int L, bool vec,
                                         float2* s) {
  if (vec) {
    const int half = L >> 1;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = threadIdx.x; q < nb * half; q += kThreads) {
      const int p = q / half, j = q - p * half;
      const float4 v = __ldg(src4 + q);
      s[2 * j * kStride + p] = make_float2(v.x, v.y);
      s[(2 * j + 1) * kStride + p] = make_float2(v.z, v.w);
    }
  } else {
    for (int q = threadIdx.x; q < nb * L; q += kThreads) {
      const int p = q / L, l = q - p * L;
      s[l * kStride + p] = __ldg(src + q);
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

__device__ __forceinline__ void atomic_add2(float2* dst, float x, float y) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, make_float2(x, y));  // one 8-byte reduction (sm_90)
#else
  atomicAdd(&dst->x, x);
  atomicAdd(&dst->y, y);
#endif
}

// Sum v over each run of equal keys on consecutive lanes (the samples of one ray that
// share a cell), in a fixed tree order; true on the run's last lane, which holds the
// sum. Every lane of the warp takes part.
template <int V>
__device__ __forceinline__ bool run_sum(unsigned long long key, float (&v)[V], int lane) {
  const unsigned long long prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  if (heads == kFull) return true;  // no two neighbours share an entry
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
  const int span =
      static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(lane - start)));
  for (int d = 1; d <= span; d <<= 1) {
    float u[V];
#pragma unroll
    for (int j = 0; j < V; ++j) u[j] = __shfl_up_sync(kFull, v[j], d);
    if (lane - d >= start) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = __fadd_rn(u[j], v[j]);
    }
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

// The table gradient of one (point, level): w_k g added to entry idx_k, first summed
// over each run of lanes that add to the same entries. The two x-corners of (iy, iz)
// go together: one float4 atomic when they are one aligned 16-byte pair, else two
// float2 atomics.
__device__ __forceinline__ void scatter(const Corners& c, float2 g, bool valid, bool paired,
                                        int lane, float2* __restrict__ dtable) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned a = c.idx[k], b = c.idx[k + 4];
    const unsigned long long key =
        valid ? (static_cast<unsigned long long>(b) << 32 | a) : kNoEntry;
    float v[4] = {__fmul_rn(c.w[k], g.x), __fmul_rn(c.w[k], g.y), __fmul_rn(c.w[k + 4], g.x),
                  __fmul_rn(c.w[k + 4], g.y)};
    if (!run_sum<4>(key, v, lane) || !valid) continue;
    if (paired && one_pair(a, b)) {
      const float4 q = (a & 1u) ? make_float4(v[2], v[3], v[0], v[1])
                                : make_float4(v[0], v[1], v[2], v[3]);
      atomicAdd(reinterpret_cast<float4*>(dtable) + (a >> 1), q);  // one 16-byte reduction
    } else {
      atomic_add2(dtable + a, v[0], v[1]);
      atomic_add2(dtable + b, v[2], v[3]);
    }
  }
}

// Level-major as the forward. A warp task adds its 32 points' table gradient for one
// level, each entry once per run of lanes that share it. With kDpos it also re-gathers
// the corners, writes R_l dfrac of each (point, level) to shared memory, and after
// the block's barrier one thread a point sums the levels in order and writes dpos.
template <bool kBf16, bool kDpos>
__global__ void __launch_bounds__(kThreads, 1)
    hash_bwd_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                    const float2* __restrict__ dout, long long n, Levels lv, bool paired,
                    bool vec, float2* __restrict__ dtable, float* __restrict__ dpos) {
  extern __shared__ float4 smem[];
  const int L = lv.n_levels;
  float* s_pos = reinterpret_cast<float*>(smem);               // [kPoints][3], as given
  float2* s_g = reinterpret_cast<float2*>(s_pos + 3 * kPoints);  // [L][kStride]
  float* s_df = reinterpret_cast<float*>(s_g + L * kStride);     // [L][kPoints][3]
  const long long i0 = static_cast<long long>(blockIdx.x) * kPoints;
  const int nb = static_cast<int>(min(static_cast<long long>(kPoints), n - i0));
  for (int t = threadIdx.x; t < 3 * nb; t += kThreads) s_pos[t] = __ldg(pos + 3 * i0 + t);
  stage_in(dout + i0 * L, nb, L, vec, s_g);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = warp; task < kChunks * L; task += kWarps) {
    // Lanes past the last point stay in the warp for its collectives, on point 0's
    // corners with a key no entry has, and add nothing.
    const int l = task / kChunks, p = (task % kChunks) * 32 + lane;
    const bool valid = p < nb;
    const int q = valid ? p : 0;
    const float x[3] = {clip01(s_pos[3 * q]), clip01(s_pos[3 * q + 1]),
                        clip01(s_pos[3 * q + 2])};
    const float2 g = valid ? s_g[l * kStride + p] : make_float2(0.0f, 0.0f);
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
      float* d = s_df + (l * kPoints + p) * 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) d[a] = __fmul_rn(df[a], rf);
    }
    scatter(c, g, valid, paired, lane, dtable);
  }
  if (!kDpos) return;
  __syncthreads();
  for (int p = threadIdx.x; p < nb; p += kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float d = 0.0f;
      for (int l = 0; l < L; ++l) d = __fadd_rn(d, s_df[(l * kPoints + p) * 3 + a]);
      const float xa = s_pos[3 * p + a];
      const float cw = (xa > 0.0f && xa < 1.0f)     ? 1.0f
                       : (xa == 0.0f || xa == 1.0f) ? 0.5f
                                                    : 0.0f;
      dpos[3 * (i0 + p) + a] = __fmul_rn(d, cw);
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

// dtable (T, 2) f32, zeroed by the caller; dpos (n, 3) f32, or null when the position
// gradient is not needed (frozen poses): then the kernel neither re-gathers the
// corners nor forms their dot products.
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
  const bool paired = aligned16(table) && aligned16(dtable);
  const bool vec = n_levels % 2 == 0 && aligned16(dout);
  size_t smem = staged_bytes(n_levels);
  if (dpos == nullptr) {
    return bf16 ? launch(hash_bwd_kernel<true, false>, n, smem, s, pos, t, g, n, lv, paired, vec,
                         dt, dpos)
                : launch(hash_bwd_kernel<false, false>, n, smem, s, pos, t, g, n, lv, paired,
                         vec, dt, dpos);
  }
  smem += static_cast<size_t>(n_levels) * kPoints * 3 * sizeof(float);
  return bf16 ? launch(hash_bwd_kernel<true, true>, n, smem, s, pos, t, g, n, lv, paired, vec,
                       dt, dpos)
              : launch(hash_bwd_kernel<false, true>, n, smem, s, pos, t, g, n, lv, paired, vec,
                       dt, dpos);
}
