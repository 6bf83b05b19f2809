// Fused Fourier-feature + MLP sigma head in float32, forward and backward, for
// Hopper (sm_90a). The f32 mode of loner_tpu/ops/pallas/fourier_mlp.py's kernels
// (compute_dtype float32), which csrc/fourier_mlp.cu's bf16 wgmma kernels do not
// take: f32 products and sums on the CUDA cores.
//
//   forward   x = [sin(pts B), cos(pts B), pts]   (the phase as three rounded
//             products and two rounded sums, the plain version's order)
//             h_i = relu(h_{i-1} W_i + b_i),  sigma = h W_L + b_L
//   backward  recompute the forward; g_L = dout; dW_i = h_{i-1}^T g_i,
//             db_i = sum g_i, g_{i-1} = (h_{i-1} > 0) g_i W_i^T;
//             dx = g_1 W_0^T, dproj = dx_sin cos - dx_cos sin,
//             dpts = dx_pts + dproj B^T.
//
// A block takes a tile of TP points (TP a multiple of 4, chosen by the host so
// that its shared memory fits) and keeps the tile's features, every hidden
// activation and two gradient buffers in shared memory. A product of a tile
// with a weight matrix is computed in 4 x 4 (points x columns) register tiles,
// the weights read from global memory (L1 / L2 resident). The backward's grid is
// persistent: block b takes tiles b, b + grid, ..., adds its tiles' dW and db to
// its own f32 partial (no atomics), and a second kernel sums the partials in
// block order, so every call sums in the same order.
//
// Parameters and gradients are one flat f32 array: W_0 (K0 x H, row-major, rows
// in [sin | cos | pts] order), b_0 (H), W_1 (H x H), b_1, ..., W_{L-1} (H x 1),
// b_{L-1} (1); K0 = 2F + 3.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline long long param_count(int k0, int h, int n_layers) {
  return static_cast<long long>(k0) * h + h +
         static_cast<long long>(n_layers - 2) * (static_cast<long long>(h) * h + h) + h + 1;
}

// Offsets of W_i and b_i in the flat parameter array.
__device__ inline long long w_offset(int i, int k0, int h) {
  if (i == 0) return 0;
  return static_cast<long long>(k0) * h + h + static_cast<long long>(i - 1) * (h * h + h);
}

__device__ inline long long b_offset(int i, int k0, int h, int n_layers) {
  const int rows = i == 0 ? k0 : h;
  const int cols = i == n_layers - 1 ? 1 : h;
  return w_offset(i, k0, h) + static_cast<long long>(rows) * cols;
}

// Features of the tile's points into x (tp x k0, leading dimension k0).
__device__ void features(const float* __restrict__ pts, const float* __restrict__ bmat,
                         long long n, long long p0, int tp, int f, float* x) {
  const int k0 = 2 * f + 3;
  for (int e = threadIdx.x; e < tp * (f + 1); e += blockDim.x) {
    const int p = e / (f + 1), j = e % (f + 1);
    const long long gp = p0 + p;
    const float a = gp < n ? pts[3 * gp] : 0.f, b = gp < n ? pts[3 * gp + 1] : 0.f,
                c = gp < n ? pts[3 * gp + 2] : 0.f;
    if (j < f) {
      const float proj = __fadd_rn(__fadd_rn(__fmul_rn(a, bmat[j]), __fmul_rn(b, bmat[f + j])),
                                   __fmul_rn(c, bmat[2 * f + j]));
      x[p * k0 + j] = sinf(proj);
      x[p * k0 + f + j] = cosf(proj);
    } else {
      x[p * k0 + 2 * f] = a;
      x[p * k0 + 2 * f + 1] = b;
      x[p * k0 + 2 * f + 2] = c;
    }
  }
}

// out (tp x c, ld c) = [relu](in (tp x k, ld k) W (k x c) + b).
__device__ void dense(const float* in, int k, const float* __restrict__ w,
                      const float* __restrict__ b, int c, float* out, int tp, bool relu) {
  const int c4 = (c + 3) / 4;
  for (int t = threadIdx.x; t < (tp / 4) * c4; t += blockDim.x) {
    const int p0 = (t / c4) * 4, j0 = (t % c4) * 4;
    float acc[4][4] = {};
    for (int kk = 0; kk < k; ++kk) {
      float a[4], ww[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = in[(p0 + i) * k + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) ww[j] = j0 + j < c ? w[static_cast<long long>(kk) * c + j0 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], ww[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + j >= c) continue;
        const float v = acc[i][j] + b[j0 + j];
        out[(p0 + i) * c + j0 + j] = relu ? fmaxf(v, 0.f) : v;
      }
  }
}

// out (tp x k, ld k) = g (tp x c, ld c) W^T (W: k x c), masked by (mask > 0)
// where mask (tp x k, ld k) is given.
__device__ void dense_t(const float* g, int c, const float* __restrict__ w, int k, float* out,
                        const float* mask, int tp) {
  const int k4 = (k + 3) / 4;
  for (int t = threadIdx.x; t < (tp / 4) * k4; t += blockDim.x) {
    const int p0 = (t / k4) * 4, r0 = (t % k4) * 4;
    float acc[4][4] = {};
    for (int j = 0; j < c; ++j) {
      float gg[4], ww[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gg[i] = g[(p0 + i) * c + j];
#pragma unroll
      for (int r = 0; r < 4; ++r) ww[r] = r0 + r < k ? w[static_cast<long long>(r0 + r) * c + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] = fmaf(gg[i], ww[r], acc[i][r]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r0 + r >= k) continue;
        const int o = (p0 + i) * k + r0 + r;
        out[o] = (mask == nullptr || mask[o] > 0.f) ? acc[i][r] : 0.f;
      }
  }
}

// dW (k x c) += in^T (k x tp) g (tp x c); db (c) += sum_p g. part points at dW,
// dW's bias row follows at part + k * c.
__device__ void accumulate_dw(const float* in, int k, const float* g, int c, float* part,
                              int tp) {
  const int c4 = (c + 3) / 4;
  for (int t = threadIdx.x; t < ((k + 4) / 4) * c4; t += blockDim.x) {
    const int r0 = (t / c4) * 4, j0 = (t % c4) * 4;
    float acc[4][4] = {};
    for (int p = 0; p < tp; ++p) {
      float a[4], gg[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = r0 + r < k ? in[p * k + r0 + r] : (r0 + r == k ? 1.f : 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) gg[j] = j0 + j < c ? g[p * c + j0 + j] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[r], gg[j], acc[r][j]);
    }
    // Row k (a column of ones) is db.
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r0 + r <= k && j0 + j < c) part[static_cast<long long>(r0 + r) * c + j0 + j] += acc[r][j];
  }
}

__global__ void __launch_bounds__(kThreads)
fwd_f32_kernel(const float* __restrict__ pts, const float* __restrict__ bmat, long long n, int f,
               int h, int n_layers, const float* __restrict__ params, float* __restrict__ out,
               int tp) {
  extern __shared__ float smem[];
  const int k0 = 2 * f + 3;
  const long long p0 = static_cast<long long>(blockIdx.x) * tp;
  float* x = smem;
  float* buf[2] = {smem + tp * k0, smem + tp * k0 + tp * h};
  features(pts, bmat, n, p0, tp, f, x);
  __syncthreads();
  const float* in = x;
  int kin = k0;
  for (int i = 0; i < n_layers - 1; ++i) {
    float* o = buf[i & 1];
    dense(in, kin, params + w_offset(i, k0, h), params + b_offset(i, k0, h, n_layers), h, o, tp,
          true);
    __syncthreads();
    in = o;
    kin = h;
  }
  // The last layer (H -> 1): a thread a point.
  const int last = n_layers - 1;
  const float* wl = params + w_offset(last, k0, h);
  const float bl = params[b_offset(last, k0, h, n_layers)];
  for (int p = threadIdx.x; p < tp; p += blockDim.x) {
    float s = 0.f;
    for (int kk = 0; kk < h; ++kk) s = fmaf(in[p * h + kk], wl[kk], s);
    if (p0 + p < n) out[p0 + p] = s + bl;
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_f32_kernel(const float* __restrict__ pts, const float* __restrict__ bmat, long long n, int f,
               int h, int n_layers, const float* __restrict__ params,
               const float* __restrict__ dout, float* __restrict__ dpts,
               float* __restrict__ partial, int tp) {
  extern __shared__ float smem[];
  const int k0 = 2 * f + 3;
  const int wide = h > k0 ? h : k0;
  float* x = smem;                       // tp x k0
  float* acts = x + tp * k0;             // (L - 1) x tp x h
  float* g0 = acts + (n_layers - 1) * tp * h;  // tp x wide
  float* g1 = g0 + tp * wide;            // tp x wide
  float* part = partial + blockIdx.x * param_count(k0, h, n_layers);
  const long long tiles = (n + tp - 1) / tp;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * tp;
    features(pts, bmat, n, p0, tp, f, x);
    __syncthreads();
    const float* in = x;
    int kin = k0;
    for (int i = 0; i < n_layers - 1; ++i) {
      float* o = acts + i * tp * h;
      dense(in, kin, params + w_offset(i, k0, h), params + b_offset(i, k0, h, n_layers), h, o,
            tp, true);
      __syncthreads();
      in = o;
      kin = h;
    }
    // The last layer: g_L = dout (0 past n).
    const int last = n_layers - 1;
    for (int p = threadIdx.x; p < tp; p += blockDim.x) g0[p] = p0 + p < n ? dout[p0 + p] : 0.f;
    __syncthreads();
    const float* h_last = acts + (n_layers - 2) * tp * h;
    accumulate_dw(h_last, h, g0, 1, part + w_offset(last, k0, h), tp);
    // g_{L-1} = (h_{L-1} > 0) g_L w_L^T.
    const float* wl = params + w_offset(last, k0, h);
    for (int e = threadIdx.x; e < tp * h; e += blockDim.x) {
      const int p = e / h, kk = e % h;
      g1[e] = h_last[e] > 0.f ? g0[p] * wl[kk] : 0.f;
    }
    __syncthreads();
    float* g = g1;
    float* spare = g0;
    for (int i = n_layers - 2; i >= 0; --i) {
      const float* hin = i == 0 ? x : acts + (i - 1) * tp * h;
      const int kk = i == 0 ? k0 : h;
      accumulate_dw(hin, kk, g, h, part + w_offset(i, k0, h), tp);
      // g_i = (h_{i-1} > 0) g_{i+1} W_i^T; for i = 0, dx = g_1 W_0^T (no mask).
      dense_t(g, h, params + w_offset(i, k0, h), kk, spare, i == 0 ? nullptr : hin, tp);
      __syncthreads();
      float* t = g;
      g = spare;
      spare = t;
    }
    // g is dx (tp x k0): dpts = dx_pts + (dx_sin cos - dx_cos sin) B^T.
    for (int e = threadIdx.x; e < tp * 3; e += blockDim.x) {
      const int p = e / 3, c = e % 3;
      if (p0 + p >= n) continue;
      float s = 0.f;
      for (int j = 0; j < f; ++j) {
        const float dproj = g[p * k0 + j] * x[p * k0 + f + j] - g[p * k0 + f + j] * x[p * k0 + j];
        s = fmaf(dproj, bmat[c * f + j], s);
      }
      dpts[3 * (p0 + p) + c] = g[p * k0 + 2 * f + c] + s;
    }
    __syncthreads();
  }
}

__global__ void reduce_f32_kernel(const float* __restrict__ partial, int blocks, long long count,
                                  float* __restrict__ grads) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[b * count + e];
  grads[e] = s;
}

size_t fwd_smem(int tp, int k0, int h) { return sizeof(float) * tp * (k0 + 2 * h); }

size_t bwd_smem(int tp, int k0, int h, int n_layers) {
  const int wide = h > k0 ? h : k0;
  return sizeof(float) * tp * (k0 + (n_layers - 1) * h + 2 * wide);
}

bool shape_ok(long long n, int f, int h, int n_layers, int tp) {
  return n > 0 && f >= 1 && h >= 1 && n_layers >= 2 && n_layers <= 8 && tp >= 4 && tp % 4 == 0;
}

}  // namespace

extern "C" long long lt_fourier_mlp_f32_param_count(int f, int h, int n_layers) {
  return param_count(2 * f + 3, h, n_layers);
}

extern "C" long long lt_fourier_mlp_f32_fwd_smem(int tp, int f, int h) {
  return static_cast<long long>(fwd_smem(tp, 2 * f + 3, h));
}

extern "C" long long lt_fourier_mlp_f32_bwd_smem(int tp, int f, int h, int n_layers) {
  return static_cast<long long>(bwd_smem(tp, 2 * f + 3, h, n_layers));
}

extern "C" int lt_fourier_mlp_f32_fwd(const float* pts, const float* bmat, long long n, int f,
                                      int h, int n_layers, const float* params, float* out,
                                      int tp, void* stream) {
  if (!shape_ok(n, f, h, n_layers, tp)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(tp, 2 * f + 3, h);
  cudaError_t err = cudaFuncSetAttribute(fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + tp - 1) / tp;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fwd_f32_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(pts, bmat, n, f, h, n_layers, params,
                                                        out, tp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lt_fourier_mlp_f32_bwd(const float* pts, const float* bmat, long long n, int f,
                                      int h, int n_layers, const float* params, const float* dout,
                                      float* dpts, float* partial, int grid, float* grads, int tp,
                                      void* stream) {
  if (!shape_ok(n, f, h, n_layers, tp) || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(tp, 2 * f + 3, h, n_layers);
  cudaError_t err = cudaFuncSetAttribute(bwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_f32_kernel<<<grid, kThreads, smem, s>>>(pts, bmat, n, f, h, n_layers, params, dout, dpts,
                                              partial, tp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = param_count(2 * f + 3, h, n_layers);
  reduce_f32_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(partial, grid,
                                                                             count, grads);
  return static_cast<int>(cudaGetLastError());
}
