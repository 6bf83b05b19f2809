// Fused alpha compositing over ray samples, forward only, for Hopper (sm_90a).
//
// Replaces loner_tpu/ops/pallas/composite.py::_composite_kernel (reached through
// composite_rays). For each ray of S samples:
//   delta_i = (z_{i+1} - z_i) |d|, the last delta 1e10 |d|
//   alpha_i = 1 - exp(-delta_i act(sigma_i)), act = relu or softplus
//   T_i     = prod_{j<i} (1 - alpha_j + 1e-10),  w_i = alpha_i T_i
//   opacity = sum w,  depth = sum w z + (1 - opacity) far,  var = sum w (depth - z)^2
//
// Design: one warp per ray. The warp walks the samples in 32-wide strips; each
// lane loads z_i, z_{i+1} and sigma_i, the warp takes an inclusive product scan
// of (1 - alpha + 1e-10) with __shfl_up_sync, shifts it one lane to make it
// exclusive and multiplies by the product carried from the earlier strips. The
// TPU kernel's log-space Hillis-Steele scan existed only because Mosaic has no
// cumprod; here the scan is a direct product, in f32. Sums are f32 per lane and
// reduced across the warp once per ray. A second pass re-reads w and z (the
// ray's 8-16 KB, still in L2) for the variance as sum w (depth - z)^2, not the
// expanded sum w z^2 form, which cancels badly.
//
// What bounds it: memory. At 16384 rays x 2048 samples it reads z and sigma
// (2 x 134 MB) and writes 134 MB of weights, about 0.4 GB, ~0.12 ms at the
// published 3.35 TB/s of the H100 SXM. That is a small share of a render: the
// sigma forward kernel spends ~10.8 ms on each 2048-ray x 1024-sample chunk
// (2.1 M points; NVIDIA H100 80GB HBM3, 700 W), far longer than compositing it.
//
// Plain C interface (no PyTorch headers); built by loner_tpu_torch/ops/build.py
// and bound with ctypes in loner_tpu_torch/ops/composite.py.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;  // rays per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

template <bool kSoftplus>
__device__ __forceinline__ float density(float x) {
  // softplus as max(x, 0) + log1p(exp(-|x|)): no overflow for large |x|.
  return kSoftplus ? fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))) : fmaxf(x, 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool kSoftplus>
__global__ void __launch_bounds__(kWarps * 32)
composite_kernel(const float* __restrict__ z, const float* __restrict__ sigma,
                 const float* __restrict__ far, const float* __restrict__ dnorm, int n_rays,
                 int s, float* __restrict__ depth, float* __restrict__ opacity,
                 float* __restrict__ var, float* __restrict__ weights) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // warp-uniform: the whole warp leaves together
  const size_t row = static_cast<size_t>(ray) * static_cast<size_t>(s);
  const float* zr = z + row;
  const float* sr = sigma + row;
  float* wr = weights + row;
  const float dn = dnorm[ray];

  float carry = 1.0f;  // transmittance after the strips already walked
  float sw = 0.0f, swz = 0.0f;
  for (int base = 0; base < s; base += 32) {
    const int j = base + lane;
    const bool live = j < s;
    float zj = 0.0f, alpha = 0.0f;
    if (live) {
      zj = zr[j];
      const float delta = (j < s - 1 ? zr[j + 1] - zj : 1e10f) * dn;
      alpha = 1.0f - expf(-delta * density<kSoftplus>(sr[j]));
    }
    // Inclusive product scan over the strip; lanes past the end hold 1.
    float incl = live ? (1.0f - alpha) + 1e-10f : 1.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl *= v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    if (live) {
      const float w = alpha * (carry * excl);
      wr[j] = w;
      sw += w;
      swz += w * zj;
    }
    carry *= __shfl_sync(kFull, incl, 31);
  }

  const float op = warp_sum(sw);
  const float d = warp_sum(swz) + (1.0f - op) * far[ray];
  // Each lane re-reads the weights it wrote itself: no fence needed.
  float sv = 0.0f;
  for (int j = lane; j < s; j += 32) {
    const float e = d - zr[j];
    sv += wr[j] * (e * e);
  }
  sv = warp_sum(sv);
  if (lane == 0) {
    depth[ray] = d;
    opacity[ray] = op;
    var[ray] = sv;
  }
}

}  // namespace

// z, sigma, weights: (n_rays, s) row-major f32; far, dnorm, depth, opacity, var:
// (n_rays,) f32. Launches on ``stream`` and returns cudaGetLastError().
extern "C" int lt_composite(const float* z, const float* sigma, const float* far,
                            const float* dnorm, int n_rays, int s, int softplus, float* depth,
                            float* opacity, float* var, float* weights, void* stream) {
  if (n_rays <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_rays + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (softplus) {
    composite_kernel<true><<<grid, block, 0, st>>>(z, sigma, far, dnorm, n_rays, s, depth,
                                                   opacity, var, weights);
  } else {
    composite_kernel<false><<<grid, block, 0, st>>>(z, sigma, far, dnorm, n_rays, s, depth,
                                                    opacity, var, weights);
  }
  return static_cast<int>(cudaGetLastError());
}
