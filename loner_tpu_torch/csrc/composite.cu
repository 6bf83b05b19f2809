// Fused alpha compositing over ray samples, forward only, for Hopper (sm_90a).
//
// Replaces loner_tpu/ops/pallas/composite.py::_composite_kernel (reached through
// composite_rays). For each ray of S samples:
//   delta_i = (z_{i+1} - z_i) |d|, the last delta 1e10 |d|
//   alpha_i = 1 - exp(-delta_i act(sigma_i)), act = relu or softplus
//   T_i     = prod_{j<i} (1 - alpha_j + 1e-10),  w_i = alpha_i T_i
//   opacity = sum w,  depth = sum w z + (1 - opacity) far,  var = sum w (depth - z)^2
//
// What bounds it: HBM bytes. It reads z and sigma and writes the weights, 12 bytes a
// sample, and reads far and |d| and writes depth, opacity and variance, 20 bytes a
// ray: 25.2 MB (7.5 us at 3.35 TB/s) for a render chunk of 2048 rays x 1024 samples,
// 403 MB (0.120 ms) at 16384 x 2048. Its arithmetic (an exp, a softplus, a product
// and a few adds a sample) is far below the card's rate.
//
// Design: one block of T threads per ray, each thread holding V consecutive samples
// of the ray's row in registers (T x V >= S at the renders' S: 128 x 8 at 1024,
// 256 x 8 at 2048; the wrapper picks T and V from S).
// * One pass over the bytes. z and sigma are loaded once, as 16-byte vectors when the
//   rows are 16-byte aligned (S % 4 == 0), else by masked scalar loads; z_{i+1} of a
//   thread's last sample comes from the next lane by a shuffle, or from memory at a
//   warp's edge. The weights go out once, as 16-byte streaming stores, and the
//   variance sum w (depth - z)^2 (not the expanded form, which cancels badly) is taken
//   from the w and z the thread still holds.
// * A block-wide scan instead of a serial chain: each thread multiplies its V terms,
//   a warp scans the 32 thread products with 5 shuffles, the <= 8 warp products are
//   scanned through shared memory, and each thread multiplies its prefix back in. The
//   chain is V + 5 + 8 steps deep instead of S / 32 dependent strips. Sums reduce in
//   the same fixed order, so two calls give the same bits.
// * Loads in flight: all of a thread's loads are issued before any of them is used,
//   and one block per ray keeps ~80 KB of rows in flight on each SM (at 44-48
//   registers a thread, 10 blocks of 128 threads at S = 1024, 5 of 256 at 2048). A
//   persistent variant that bulk-copied (cp.async.bulk, mbarrier ring of 2-4 stages)
//   the next rays' rows into shared memory while scanning the present one was 8-22%
//   slower at every shape measured on an H100 (PERF.md), so it is not kept.
// Rows longer than T x V (S > 2048) loop over tiles with the transmittance carried,
// and then re-read their own z and w for the variance.
//
// Plain C interface (no PyTorch headers); built by loner_tpu_torch/ops/build.py and
// bound with ctypes in loner_tpu_torch/ops/composite.py, which also plans the launch
// (T, V and the tile count).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Rays {
  const float* z;
  const float* sigma;
  const float* far;
  const float* dnorm;
  float* depth;
  float* opacity;
  float* var;
  float* weights;
  int s;
};

// Shared scratch of the block scan and reductions.
struct Scratch {
  float prod[kMaxWarps];
  float sw[kMaxWarps];
  float swz[kMaxWarps];
  float var[kMaxWarps];
};

template <bool kSoftplus>
__device__ __forceinline__ float density(float x) {
  // softplus as max(x, 0) + log1p(exp(-|x|)): no overflow for large |x|.
  return kSoftplus ? fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))) : fmaxf(x, 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float transmit(float alpha) { return (1.0f - alpha) + 1e-10f; }

// V values of a row from element i0 on, 0 past its end: 16-byte read-only loads where
// kVec (the row is 16-byte aligned) and all V lie in the row, else masked scalars.
template <int V, bool kVec>
__device__ __forceinline__ void load_global(const float* __restrict__ p, int i0, int s, float* v) {
  if (kVec && i0 + V <= s) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + i0) + q);
      v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = i0 + k < s ? __ldg(p + i0 + k) : 0.0f;
  }
}

// The weights of elements i0.. of a row, as streaming stores (write once, not re-read).
template <int V, bool kVec>
__device__ __forceinline__ void store_weights(float* p, int i0, int s, const float* v) {
  if (kVec && i0 + V <= s) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      __stcs(reinterpret_cast<float4*>(p + i0) + q,
             make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (i0 + k < s) __stcs(p + i0 + k, v[k]);
  }
}

// alpha of samples i0 .. i0 + V - 1 into a (0 past the row's end); znext is z_{i0+V}.
// Returns the product of their transmittances, in sample order.
template <bool kSoftplus, int V>
__device__ __forceinline__ float alphas(const float* zv, const float* sv, float znext, int i0,
                                        int s, float dn, float* a) {
  float prod = 1.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = i0 + k;
    const float zn = k + 1 < V ? zv[k + 1] : znext;
    a[k] = 0.0f;
    if (i < s) {
      const float delta = (i < s - 1 ? zn - zv[k] : 1e10f) * dn;
      a[k] = 1.0f - expf(-delta * density<kSoftplus>(sv[k]));
      prod *= transmit(a[k]);
    }
  }
  return prod;
}

// Turns the alphas in a into weights, given the transmittance t before the first of
// them, and adds them to sw and sw z.
template <int V>
__device__ __forceinline__ void weights(float* a, const float* zv, float t, int i0, int s,
                                        float& sw, float& swz) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float alpha = a[k];
    a[k] = alpha * t;  // 0 past the row's end, where alpha is 0
    if (i0 + k < s) t *= transmit(alpha);
    sw += a[k];
    swz += a[k] * zv[k];
  }
}

// Exclusive product scan of one value per thread, in thread order, over the block.
// Returns the thread's prefix; *total is the product of all (the same in every
// thread). Ends with the scratch read: a caller that scans again syncs first.
__device__ __forceinline__ float block_exclusive_product(float v, Scratch& sh, float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl *= u;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 1.0f;
  if (lane == 31) sh.prod[warp] = incl;
  __syncthreads();
  float before = 1.0f, all = 1.0f;
  for (int w = 0; w < n_warps; ++w) {
    const float p = sh.prod[w];
    if (w < warp) before *= p;
    all *= p;
  }
  *total = all;
  return before * excl;
}

// Sums of sw and swz over the block, in warp order; every thread gets both.
__device__ __forceinline__ void block_sums(float& sw, float& swz, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  sw = warp_sum(sw);
  swz = warp_sum(swz);
  if (lane == 0) sh.sw[warp] = sw, sh.swz[warp] = swz;
  __syncthreads();
  sw = swz = 0.0f;
  for (int w = 0; w < n_warps; ++w) sw += sh.sw[w], swz += sh.swz[w];
}

// The variance's block sum, then the ray's three outputs from thread 0.
__device__ __forceinline__ void write_ray(const Rays& r, int ray, float sv, float sw, float d,
                                          Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  sv = warp_sum(sv);
  if (lane == 0) sh.var[warp] = sv;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += sh.var[w];
    r.depth[ray] = d;
    r.opacity[ray] = sw;
    r.var[ray] = v;
  }
}

template <int V>
__device__ __forceinline__ float variance_part(const float* zv, const float* wv, float d, int i0,
                                               int s) {
  float sv = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float e = d - zv[k];
    if (i0 + k < s) sv += wv[k] * (e * e);
  }
  return sv;
}

// One block per ray (grid = n_rays), rows read straight from global memory into
// registers, in `tiles` tiles of blockDim.x * V samples.
template <bool kSoftplus, int V, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
composite_kernel(Rays r, int tiles) {
  __shared__ Scratch sh;
  const int ray = blockIdx.x;
  const size_t row = static_cast<size_t>(ray) * static_cast<size_t>(r.s);
  const float* __restrict__ zr = r.z + row;
  const float* __restrict__ sr = r.sigma + row;
  float* wr = r.weights + row;
  const int s = r.s, lane = threadIdx.x & 31, tile_len = blockDim.x * V;
  const float dn = __ldg(r.dnorm + ray);
  const float far = __ldg(r.far + ray);

  float zv[V], wv[V];
  float carry = 1.0f, sw = 0.0f, swz = 0.0f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int i0 = tile * tile_len + static_cast<int>(threadIdx.x) * V;
    float sv[V];
    load_global<V, kVec>(zr, i0, s, zv);
    load_global<V, kVec>(sr, i0, s, sv);
    float znext = __shfl_down_sync(kFull, zv[0], 1);
    if (lane == 31 && i0 + V < s) znext = __ldg(zr + i0 + V);
    const float prod = alphas<kSoftplus, V>(zv, sv, znext, i0, s, dn, wv);
    float tile_prod;
    const float t = carry * block_exclusive_product(prod, sh, &tile_prod);
    carry *= tile_prod;
    weights<V>(wv, zv, t, i0, s, sw, swz);
    store_weights<V, kVec>(wr, i0, s, wv);
    if (tile + 1 < tiles) __syncthreads();  // the next scan writes the scratch again
  }
  block_sums(sw, swz, sh);
  const float d = swz + (1.0f - sw) * far;
  float sv = 0.0f;
  if (tiles == 1) {
    sv = variance_part<V>(zv, wv, d, static_cast<int>(threadIdx.x) * V, s);
  } else {
    // Each thread re-reads the z and w of its own samples (its own stores: in order).
    for (int tile = 0; tile < tiles; ++tile) {
      const int i0 = tile * tile_len + static_cast<int>(threadIdx.x) * V;
      for (int k = 0; k < V && i0 + k < s; ++k) {
        const float e = d - __ldg(zr + i0 + k);
        sv += wr[i0 + k] * (e * e);
      }
    }
  }
  write_ray(r, ray, sv, sw, d, sh);
}

template <bool kSoftplus, int V, bool kVec>
const void* kernel() {
  return reinterpret_cast<const void*>(&composite_kernel<kSoftplus, V, kVec>);
}

}  // namespace

// z, sigma, weights: (n_rays, s) row-major f32; far, dnorm, depth, opacity, var:
// (n_rays,) f32. The launch plan (ops/composite.py::composite_plan): threads a block
// (a multiple of 32, at most 256), v samples a thread (4 or 8), tiles per row
// (tiles * threads * v >= s > (tiles - 1) * threads * v), vec (rows 16-byte aligned:
// 16-byte accesses). One block per ray. Launches on ``stream`` and returns the
// launch's CUDA error, or cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int lt_composite(const float* z, const float* sigma, const float* far,
                            const float* dnorm, int n_rays, int s, int softplus, int threads,
                            int v, int tiles, int vec, float* depth, float* opacity, float* var,
                            float* weights, void* stream) {
  const bool ok = n_rays > 0 && s > 0 && threads > 0 && threads % 32 == 0 &&
                  threads <= kMaxThreads && tiles > 0 && (v == 4 || v == 8) &&
                  static_cast<long long>(tiles) * threads * v >= s &&
                  static_cast<long long>(tiles - 1) * threads * v < s && (!vec || s % 4 == 0);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn;
  if (v == 4) {
    fn = softplus ? (vec ? kernel<true, 4, true>() : kernel<true, 4, false>())
                  : (vec ? kernel<false, 4, true>() : kernel<false, 4, false>());
  } else {
    fn = softplus ? (vec ? kernel<true, 8, true>() : kernel<true, 8, false>())
                  : (vec ? kernel<false, 8, true>() : kernel<false, 8, false>());
  }
  Rays r{z, sigma, far, dnorm, depth, opacity, var, weights, s};
  void* args[] = {&r, &tiles};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(n_rays), dim3(threads), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}
