// Fused Fourier-feature + MLP sigma head in float32, forward and backward, for
// Hopper (sm_90a). The f32 mode (compute_dtype float32) of
// loner_tpu/ops/pallas/fourier_mlp.py::_fwd_kernel (:52, called at :221) and
// ::_bwd_kernel (:80, called at :275), which csrc/fourier_mlp.cu's bf16 wgmma
// kernels do not take.
//
//   forward   x = [sin(pts B), cos(pts B), pts]   (the phase as three rounded
//             products and two rounded sums, the plain version's order)
//             h_i = relu(h_{i-1} W_i + b_i),  sigma = h W_L + b_L
//   backward  recompute the forward; g_L = dout; dW_i = h_{i-1}^T g_i,
//             db_i = sum g_i, g_{i-1} = (h_{i-1} > 0) g_i W_i^T;
//             dx = g_1 W_0^T, dproj = dx_sin cos - dx_cos sin,
//             dpts = dx_pts + dproj B^T.
//
// What bounds it: box_room_camera.yaml's head (F = 32, K0 = 67, 3 x 128, 1) does
// 41,472 multiply-adds a point and moves 16-28 bytes a point, so both kernels are
// bound by operations. f32 accuracy on the tensor cores takes three TF32 products
// (below), so the floor is the lesser of 2 flops / 67 TFLOP/s (CUDA cores) and
// 3 x 2 flops / 495 TFLOP/s (TF32 tensor cores). mma.sync does not reach the
// tensor cores' wgmma rate, and the split's integer and f32 operations run
// beside every product: PERF.md has the measured shares.
//
// The design, against the five faults of the first (CUDA-core) version:
// 1. Every product of the forward and every gradient product of the backward
//    (g W^T, h^T g) runs on the tensor cores as split TF32: x = hi + lo with
//    hi = tf32(x) and lo = tf32(x - hi) (rounded as cvt.rna does), and
//    a b = lo_a hi_b + hi_a lo_b + hi_a hi_b. The tensor cores' f32
//    accumulation truncates, so in the backward each k-step's three products
//    start from zero and are added to the running sum in f32 (round to
//    nearest): a dW sum over all a block's tiles would otherwise drift by
//    ~1e-4. The forward accumulates a layer's K in the tensor cores (~1e-5 of
//    sigma).
//    The route is warp-level mma.sync.m16n8k8 rather than wgmma: its fragments
//    come from registers, so hi and lo are split there, and W, W^T, H^T and
//    G^T are just other fragment indexings of the same shared-memory tiles;
//    wgmma takes 32-bit operands only K-major from shared memory, with no
//    transpose, and would need separate hi and lo copies of every operand. The
//    H -> 1 layer and dpts = dx_pts + dproj B^T stay on the CUDA cores as warp
//    reductions, and so does the backward's recomputed forward (fma_layer):
//    its ReLU masks must be the plain version's bits, which only the same f32
//    FMA chains give.
// 2. The weights are staged into shared memory once a block by cp.async, one
//    commit group a layer, so the first tile's layer i waits only for group i
//    while later layers are still in flight; they stay resident for all the
//    block's tiles (the whole head is 170 KB at 3 x 128), so no product reads a
//    weight from global memory. Each W_i is held in 8 x 8 blocks whose column
//    slots are permuted (slot(c) = c ^ ((c >> 2) & 1)), which makes both the
//    forward's and the transposed product's fragment loads free of bank
//    conflicts.
// 3. The backward keeps every dW_i (i < L - 1) of its tiles in registers as
//    mma accumulators, spread over the block's 8 warps (warp w owns the output
//    columns 16 (w mod HP/16) .. + 16 of every layer, and a share of the input
//    rows: 41 tiles of 16 x 8, 164 floats a thread at 3 x 128), db_i and
//    dW_{L-1} in shared memory and registers. A block takes 32-point tiles b,
//    b + grid, ... and writes its whole partial once, at the end: the partials
//    need no zero fill, and reduce_f32_kernel sums them in block order, so two
//    calls agree to the bit. The head's shape is a template argument
//    (LT_F32_HEADS), so every layer loop and slot index is resolved at compile
//    time and the accumulators stay in registers.
// 4. Warps in flight: the resident weights take 170 KB, so one 256-thread block
//    fits an SM for either kernel, not the two a forward block an SM would
//    need (the forward: 207 KB of shared memory, 231 registers a thread); 16
//    warps sharing one weight image at <= 128 registers each would lift it.
//    The backward holds three 32-point activation buffers, dout and db beside
//    the weights (219 KB), and every warp takes a share of every product of a
//    tile. The forward needs no block-wide buffers: each warp takes its own
//    16-point tiles and keeps their activations in registers as mma fragments
//    (a layer's C fragment is the next layer's A fragment with k permuted), so
//    no barrier follows the first tile and the 8 warps run independently.
// 5. The forward's H -> 1 layer: each lane over its fragment's columns, then two
//    xor shuffles across the four lanes of a row.
//
// Every other head of 2-8 layers (H = 256, another K0P, HP or depth) takes the
// streamed kernels below: the same arithmetic, with the weights staged a chunk
// at a time for every tile of 64, 32 or 16 points and dW added into the block's
// partial in global memory at every tile, so faults 2-4 stand there. Only the
// resident builds are on a configuration's path today (box_room_camera.yaml).
//
// Parameters and gradients are one flat f32 array: W_0 (K0 x H, row-major, rows
// in [sin | cos | pts] order), b_0 (H), W_1 (H x H), b_1, ..., W_{L-1} (H x 1),
// b_{L-1} (1); K0 = 2F + 3. Inside a block K0 is padded to K0P (a multiple of 8)
// and H to HP (a multiple of 16) with zero weights, zero biases and zero
// features, which leaves every real output unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // points a block tile
constexpr int kNMax = 2;  // n-tiles of 8 a warp takes per round of a block product
constexpr int kAccMax = 41;  // dW^T tiles (16 x 8) a warp holds in registers
constexpr int kMaxLayers = 8;
constexpr int kSTiles[] = {64, 32, 16};  // the streamed kernels' tiles, largest first
constexpr int kBatch = 4;  // dW tiles whose partial entries a warp loads together
constexpr int kChunk = 64;   // weight columns (or rows) a staged chunk of the streamed kernels
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

__host__ __device__ inline long long param_count(int k0, int h, int n_layers) {
  return static_cast<long long>(k0) * h + h +
         static_cast<long long>(n_layers - 2) * (static_cast<long long>(h) * h + h) + h + 1;
}

// Offsets of W_i and b_i in the flat parameter array.
__host__ __device__ inline long long w_offset(int i, int k0, int h) {
  if (i == 0) return 0;
  return static_cast<long long>(k0) * h + h + static_cast<long long>(i - 1) * (h * h + h);
}

__host__ __device__ inline long long b_offset(int i, int k0, int h, int n_layers) {
  const int rows = i == 0 ? k0 : h;
  const int cols = i == n_layers - 1 ? 1 : h;
  return w_offset(i, k0, h) + static_cast<long long>(rows) * cols;
}

// Row stride of an activation buffer: 8 or 24 modulo 32 floats, which keeps the
// float2 A-fragment loads (lanes g at g S + 2t) and the point-major loads of the
// weight-gradient products (lanes t at t S + g) free of bank conflicts.
__host__ __device__ inline int act_stride(int width) {
  return (width % 32 == 8 || width % 32 == 24) ? width : width + 8;
}

// Shape and shared-memory layout (offsets in floats), the same on host and card.
struct Geo {
  int f, k0, k0p, h, hp, n_layers, stride, nbuf;
  int tile;               // points a block tile (the resident forward: 16 rows a warp)
  bool streamed;
  int w_off[kMaxLayers];  // resident: block image of W_i, i < L - 1: rows_p x HP
  int b_off[kMaxLayers];  // b_i (HP, zero padded), i < L - 1
  int wl_off;             // W_{L-1} (HP), then b_{L-1}
  int bm_off;             // B (3 x F)
  int chunk_off;          // streamed: one staged chunk of a W_i, max(K0P, HP) x kChunk
  int act_off;            // nbuf buffers of tile x stride
  int dout_off;           // tile (backward)
  int db_off;             // db_i, i < L - 1: (L - 1) x HP (backward); streamed: then
                          // dW_{L-1} (HP) and db_{L-1}
  int floats;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ inline int rows_p(const Geo& g, int i) { return i == 0 ? g.k0p : g.hp; }

// Fills g for the resident kernels (every weight in shared memory) or the
// streamed ones (a chunk of one W_i at a time, tiles of `tile` points); returns
// false for a head whose layout does not fit a block.
__host__ inline bool make_geo(int f, int h, int n_layers, bool backward, bool streamed, int tile,
                              Geo* g) {
  if (f < 1 || h < 1 || n_layers < 2 || n_layers > kMaxLayers) return false;
  if (!streamed && h > 128) return false;
  g->f = f;
  g->k0 = 2 * f + 3;
  g->k0p = round_up(g->k0, 8);
  g->h = h;
  g->hp = round_up(h, 16);
  g->n_layers = n_layers;
  const int wide = g->k0p > g->hp ? g->k0p : g->hp;
  g->streamed = streamed;
  g->tile = streamed ? tile : backward ? kTile : 16;
  g->stride = act_stride(backward || streamed ? wide : g->k0p);
  g->nbuf = backward ? (n_layers - 1 > 3 ? n_layers - 1 : 3) : streamed ? 2 : kWarps;
  int at = 0;
  for (int i = 0; i < n_layers - 1 && !streamed; ++i) {
    g->w_off[i] = at;
    at += rows_p(*g, i) * g->hp;
  }
  for (int i = 0; i < n_layers - 1; ++i) {
    g->b_off[i] = at;
    at += g->hp;
  }
  g->wl_off = at;
  at += g->hp + 4;
  g->bm_off = at;
  at += round_up(3 * f, 4);
  g->chunk_off = at;
  at += streamed ? wide * kChunk : 0;
  g->act_off = at;
  at += g->nbuf * g->tile * g->stride;
  g->dout_off = at;
  at += backward ? g->tile : 0;
  g->db_off = at;
  at += backward ? (n_layers - 1) * g->hp + (streamed ? g->hp + 4 : 0) : 0;
  g->floats = at;
  return 4LL * at <= kMaxSmem;
}

// Position of W_i's element (row, col) in its block image: block (row / 8,
// col / 8), inside it column slot c ^ ((c >> 2) & 1), then the row.
__host__ __device__ inline int col_slot(int c) { return c ^ ((c >> 2) & 1); }

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `pending` of this thread's newest commit groups are in flight.
__device__ inline void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// One block image (rows x cols real, rows_pad x cols_pad held) of a row-major
// matrix with rows ld floats apart: real elements by cp.async, padding as zeros.
__device__ __forceinline__ void stage_image(const float* __restrict__ src, int rows, int cols, int rows_pad,
                            int cols_pad, int ld, float* dst) {
  const int nb = cols_pad / 8;
  for (int e = threadIdx.x; e < rows_pad * cols_pad; e += blockDim.x) {
    const int blk = e >> 6, slot = (e >> 3) & 7, r = e & 7;
    const int row = (blk / nb) * 8 + r, col = (blk % nb) * 8 + col_slot(slot);
    if (row < rows && col < cols) {
      cp_async4(dst + e, src + static_cast<long long>(row) * ld + col);
    } else {
      dst[e] = 0.f;
    }
  }
}

__device__ __forceinline__ void stage_vector(const float* __restrict__ src, int n, int n_pad, float* dst) {
  for (int e = threadIdx.x; e < n_pad; e += blockDim.x) {
    if (e < n) {
      cp_async4(dst + e, src + e);
    } else {
      dst[e] = 0.f;
    }
  }
}

// The head's weights, biases and B into shared memory, one commit group a layer
// (B with layer 0, W_{L-1} and b_{L-1} in the last).
__device__ __forceinline__ void stage_weights(const Geo& g, const float* __restrict__ params,
                              const float* __restrict__ bmat, float* sm) {
  for (int i = 0; i < g.n_layers; ++i) {
    if (i < g.n_layers - 1) {
      stage_image(params + w_offset(i, g.k0, g.h), i == 0 ? g.k0 : g.h, g.h, rows_p(g, i), g.hp,
                  g.h, sm + g.w_off[i]);
      stage_vector(params + b_offset(i, g.k0, g.h, g.n_layers), g.h, g.hp, sm + g.b_off[i]);
      if (i == 0) stage_vector(bmat, 3 * g.f, 3 * g.f, sm + g.bm_off);
    } else {
      stage_vector(params + w_offset(i, g.k0, g.h), g.h, g.hp, sm + g.wl_off);
      stage_vector(params + b_offset(i, g.k0, g.h, g.n_layers), 1, 4, sm + g.wl_off + g.hp);
    }
    cp_async_commit();
  }
}

// Features of `rows` points from p0 into x (row stride g.stride) by `count`
// threads from `first`; zero past the last point and in the padding columns.
__device__ __forceinline__ void features(const Geo& g, const float* __restrict__ pts, long long n,
                                         long long p0, const float* bm, float* x, int rows = kTile,
                                         int first = 0, int count = kThreads) {
  const int f = g.f;
  for (int e = threadIdx.x - first; e < rows * (f + 1); e += count) {
    const int p = e / (f + 1), j = e % (f + 1);
    const long long gp = p0 + p;
    const float a = gp < n ? pts[3 * gp] : 0.f, b = gp < n ? pts[3 * gp + 1] : 0.f,
                c = gp < n ? pts[3 * gp + 2] : 0.f;
    float* row = x + p * g.stride;
    if (j < f) {
      const float proj = __fadd_rn(__fadd_rn(__fmul_rn(a, bm[j]), __fmul_rn(b, bm[f + j])),
                                   __fmul_rn(c, bm[2 * f + j]));
      row[j] = sinf(proj);
      row[f + j] = cosf(proj);
    } else {
      row[2 * f] = a;
      row[2 * f + 1] = b;
      row[2 * f + 2] = c;
      for (int k = g.k0; k < g.k0p; ++k) row[k] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Split-TF32 warp products (mma.sync.m16n8k8, f32 accumulators)
// ---------------------------------------------------------------------------

struct Split {
  uint32_t hi, lo;
};

// Round f32 bits to TF32 (10 mantissa bits) to nearest, ties away from zero:
// what cvt.rna.tf32.f32 computes for a finite value, in two integer operations
// (the conversion instruction is slower: 6.45 against 4.65 ms for the forward at
// 2,097,152 points, H100).
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = tf32_rna(__float_as_uint(x));
  return {hi, tf32_rna(__float_as_uint(x - __uint_as_float(hi)))};
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b in three TF32 products, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4], const Split (&b)[2]) {
  mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// Fragment loads. m16n8k8 (tf32): lane = 4 g + t; A (16 x 8) a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (t, g), b1 (t + 4,
// g); C (16 x 8) c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t + 1). Products
// of an activation with a weight matrix take the k index permuted in each 8
// (k = t is column 2t, k = t + 4 column 2t + 1), the same for A and B, so both
// are float2 loads where the layout allows.

// A = act rows r0 .. r0 + 15, columns k0 .. k0 + 7 (row-major, stride s).
__device__ __forceinline__ void load_a_rows(const float* act, int s, int r0, int k0,
                                            Split (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 u = *reinterpret_cast<const float2*>(act + (r0 + g) * s + k0 + 2 * t);
  const float2 v = *reinterpret_cast<const float2*>(act + (r0 + g + 8) * s + k0 + 2 * t);
  a[0] = split(u.x);
  a[1] = split(v.x);
  a[2] = split(u.y);
  a[3] = split(v.y);
}

// B = the 8 x 8 block of W (rows k, columns n) at blk.
__device__ __forceinline__ void load_b_w(const float* blk, Split (&b)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 q = *reinterpret_cast<const float2*>(blk + col_slot(g) * 8 + 2 * t);
  b[0] = split(q.x);
  b[1] = split(q.y);
}

// B = the transpose of the 8 x 8 block of W at blk (k over W's columns, n over
// its rows).
__device__ __forceinline__ void load_b_wt(const float* blk, Split (&b)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  b[0] = split(blk[col_slot(2 * t) * 8 + g]);
  b[1] = split(blk[col_slot(2 * t + 1) * 8 + g]);
}

// A = G^T for points p0 .. p0 + 7 (k) and columns c0 .. c0 + 15 (m) of G (row-major,
// stride s); raw values, for db.
__device__ __forceinline__ void load_gt(const float* gm, int s, int p0, int c0, float (&v)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* q = gm + (p0 + t) * s + c0 + g;
  v[0] = q[0];
  v[1] = q[8];
  v[2] = q[4 * s];
  v[3] = q[4 * s + 8];
}

// B = H for points p0 .. p0 + 7 (k) and columns c0 .. c0 + 7 (n) of H.
__device__ __forceinline__ void load_h(const float* hm, int s, int p0, int c0, Split (&b)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* q = hm + (p0 + t) * s + c0 + g;
  b[0] = split(q[0]);
  b[1] = split(q[4 * s]);
}

enum Epilogue { kMask, kPlain, kBiasRelu };

// out (TP x N) = relu(in (TP x K) W + b) as f32 FMA chains over k in order,
// then + b: the arithmetic of an f32 matrix product on the card, so the
// backward's recomputed activations, and the ReLU masks it applies, are the
// plain version's bits. A mask decided by split-TF32 products differs from the
// plain version's wherever a pre-activation lies within an f32 rounding of zero
// (~20 points in a million here; float64 disagrees with f32 there as well),
// which moves dW by ~5e-4 relative L2 at 2,097,152 points. W is a block image
// of K x 8 WB. Thread t takes points t % 8 + 8 i (i < TP / 8) and columns
// 4 (t / 8) .. + 3, strided by 128 columns; it reads four k at a time (float4
// along a row, and along a column of W's block image), in k order.
template <int TP>
__device__ __forceinline__ void fma_layer(const float* in, int s, const float* w, float* out,
                                          const float* bias, int K, int N, int WB) {
  constexpr int kRows = TP / 8;
  const int pg = threadIdx.x % 8;
  for (int c0 = (threadIdx.x / 8) * 4; c0 < N; c0 += (kThreads / 8) * 4) {
    const float* wc = w + (c0 / 8) * 64;
    float acc[kRows][4] = {};
    for (int k = 0; k < K; k += 4) {
      float4 a[kRows], ww[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(in + (pg + 8 * i) * s + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ww[j] = *reinterpret_cast<const float4*>(
            wc + (k / 8) * WB * 64 + col_slot(c0 % 8 + j) * 8 + k % 8);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, ww[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, ww[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, ww[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, ww[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(pg + 8 * i) * s + c0 + j] = fmaxf(acc[i][j] + bias[c0 + j], 0.f);
  }
}

// A head the kernels are built for: K0 padded to K0P, H to HP, L layers. Warp w
// holds the dW^T tiles of output m-tile w mod (HP / 16) and, as rank
// r = w / (HP / 16) of the kReps warps that share it, input n-tiles r, r + kReps,
// ... of every layer i < L - 1: count(i) slots from start(i).
template <int K0P, int HP, int L>
struct Head {
  static constexpr int kK0P = K0P, kHP = HP, kL = L;
  static constexpr int kMTilesOut = HP / 16;
  static constexpr int kReps = kWarps / kMTilesOut;
  __host__ __device__ static constexpr int rows(int i) { return i == 0 ? K0P : HP; }
  __host__ __device__ static constexpr int count(int i) {
    return (rows(i) / 8 + kReps - 1) / kReps;
  }
  __host__ __device__ static constexpr int start(int i) {
    int at = 0;
    for (int j = 0; j < i; ++j) at += count(j);
    return at;
  }
  static constexpr int kSlots = start(L - 1);
  static_assert(kWarps % kMTilesOut == 0 && kSlots <= kAccMax, "head too wide");
};

// out (TP x N) = in (TP x K) W^T, W a block image of N x 8 WB (kTrans), or
// in W, W a block image of K x 8 WB. Epilogue per element: mask[p][n] > 0 ?
// acc : 0 with the mask read from out itself (in place); acc; or relu(acc +
// bias[n]). The warp takes n-tiles w, w + 8, ....
// Each k-step's three products start from zero and are added to the sum in f32
// (round to nearest): the tensor cores' own accumulation truncates, and over a
// whole K its bias reaches ~1e-5 of the sum, enough to flip ReLU masks.
template <int kEpi, bool kTrans, int TP>
__device__ __forceinline__ void block_product(const float* in, int s, const float* w, float* out,
                                              int K, int N, int WB, const float* bias = nullptr) {
  constexpr int kMTiles = TP / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kNT = N / 8;
#pragma unroll
  for (int base0 = 0; base0 < kNT; base0 += kWarps * kNMax) {
    const int base = base0 + warp;
    if (base >= kNT) break;
    float acc[kMTiles][kNMax][4] = {};
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      Split a[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) load_a_rows(in, s, m * 16, ks * 8, a[m]);
#pragma unroll
      for (int j = 0; j < kNMax; ++j) {
        const int nt = base + j * kWarps;
        if (nt < kNT) {
          Split b[2];
          if (kTrans) {
            load_b_wt(w + (nt * WB + ks) * 64, b);
          } else {
            load_b_w(w + (ks * WB + nt) * 64, b);
          }
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) {
            float part[4] = {};
            mma3(part, a[m], b);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] += part[e];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNMax; ++j) {
      const int nt = base + j * kWarps;
      if (nt >= kNT) continue;
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* o = reinterpret_cast<float2*>(out + (m * 16 + g + 8 * half) * s + col);
          float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
          if (kEpi == kMask) {
            const float2 mk = *o;
            v0 = mk.x > 0.f ? v0 : 0.f;
            v1 = mk.y > 0.f ? v1 : 0.f;
          } else if (kEpi == kBiasRelu) {
            v0 = fmaxf(v0 + bias[col], 0.f);
            v1 = fmaxf(v1 + bias[col + 1], 0.f);
          }
          *o = make_float2(v0, v1);
        }
      }
    }
  }
}

// Activation buffer i of the block.
__device__ __forceinline__ float* act_buf(const Geo& g, float* sm, int i) {
  return sm + g.act_off + i * g.tile * g.stride;
}

// The backward's recomputed forward, layers I .. L-2 of a tile: h_{i+1} into
// buffer i, x in buffer 1. In the block's first tile, layer i waits for its
// weights (commit group i).
template <class H, int I>
__device__ __forceinline__ void forward_layers(const Geo& g, float* sm, bool first) {
  const float* in = act_buf(g, sm, I == 0 ? 1 : I - 1);
  if (first) cp_async_wait(H::kL - 1 - I);
  __syncthreads();
  fma_layer<kTile>(in, g.stride, sm + g.w_off[I], act_buf(g, sm, I), sm + g.b_off[I],
                   H::rows(I), H::kHP, H::kHP / 8);
  if constexpr (I + 2 < H::kL) forward_layers<H, I + 1>(g, sm, first);
}

// h (16 points x HP, as C fragments) = relu(in W + b) for one warp: in is x in
// shared memory (I = 0) or the previous layer's C fragments, which are this
// layer's A fragments with k permuted (C holds columns 2t, 2t + 1 of each 8).
template <class H, int I>
__device__ __forceinline__ void warp_layer(const float* x, int s, const float (&in)[H::kHP / 8][4],
                                           const float* w, const float* bias,
                                           float (&h)[H::kHP / 8][4]) {
  constexpr int kNT = H::kHP / 8;
  float acc[kNT][4] = {};
#pragma unroll
  for (int ks = 0; ks < H::rows(I) / 8; ++ks) {
    Split a[4];
    if (I == 0) {
      load_a_rows(x, s, 0, ks * 8, a);
    } else {
      a[0] = split(in[ks][0]);
      a[1] = split(in[ks][2]);
      a[2] = split(in[ks][1]);
      a[3] = split(in[ks][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      Split b[2];
      load_b_w(w + (ks * kNT + nt) * 64, b);
      mma3(acc[nt], a, b);
    }
  }
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float b0 = bias[nt * 8 + 2 * t], b1 = bias[nt * 8 + 2 * t + 1];
    h[nt][0] = fmaxf(acc[nt][0] + b0, 0.f);
    h[nt][1] = fmaxf(acc[nt][1] + b1, 0.f);
    h[nt][2] = fmaxf(acc[nt][2] + b0, 0.f);
    h[nt][3] = fmaxf(acc[nt][3] + b1, 0.f);
  }
}

// Layers I .. L-2 of a warp's points, h_I in registers; returns h_{L-1} in h. In
// the block's first tile every warp runs (empty tiles included) and layer i
// waits for its weights (commit group i) at a block barrier.
template <class H, int I>
__device__ __forceinline__ void warp_layers(const Geo& g, const float* sm, const float* x,
                                            float (&h)[H::kHP / 8][4], bool first) {
  if (first) {
    cp_async_wait(H::kL - 1 - I);
    __syncthreads();
  }
  float o[H::kHP / 8][4];
  warp_layer<H, I>(x, g.stride, h, sm + g.w_off[I], sm + g.b_off[I], o);
#pragma unroll
  for (int nt = 0; nt < H::kHP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[nt][e] = o[nt][e];
  if constexpr (I + 2 < H::kL) warp_layers<H, I + 1>(g, sm, x, h, first);
}

// The forward: each warp takes 16-point tiles (warp w of block b: tiles
// 8 b + w, + 8 grid, ...) and keeps its activations in registers, so no block
// barrier follows the first tile; the weights stay resident.
template <class H>
__global__ void __launch_bounds__(kThreads, 1)
fwd_f32_kernel(const float* __restrict__ pts, const float* __restrict__ bmat, long long n,
               const float* __restrict__ params, float* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) float sm[];
  stage_weights(g, params, bmat, sm);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float* x = sm + g.act_off + warp * 16 * g.stride;
  const float* wl = sm + g.wl_off;
  const long long tiles = (n + 15) / 16, step = static_cast<long long>(gridDim.x) * kWarps;
  bool first = true;
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp; first || tile < tiles;
       tile += step) {
    const long long p0 = tile * 16;
    if (first) {
      cp_async_wait(H::kL - 1);  // B
      __syncthreads();
    }
    features(g, pts, n, p0, sm + g.bm_off, x, 16, warp * 32, 32);
    __syncwarp();
    float h[H::kHP / 8][4] = {};
    warp_layers<H, 0>(g, sm, x, h, first);
    if (first) {
      cp_async_wait(0);
      __syncthreads();
    }
    // sigma = h W_{L-1} + b: each lane over its columns, then the 4 lanes of a row.
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < H::kHP / 8; ++nt) {
      const float w0 = wl[nt * 8 + 2 * tq], w1 = wl[nt * 8 + 2 * tq + 1];
      s0 = fmaf(h[nt][0], w0, fmaf(h[nt][1], w1, s0));
      s1 = fmaf(h[nt][2], w0, fmaf(h[nt][3], w1, s1));
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (tq == 0 && p0 + gq < n) out[p0 + gq] = s0 + wl[H::kHP];
    if (tq == 0 && p0 + gq + 8 < n) out[p0 + gq + 8] = s1 + wl[H::kHP];
    __syncwarp();
    first = false;
  }
  cp_async_wait(0);
}

// dW_I^T += G^T H over the tile (G: kTile x HP at gm, H: kTile x rows(I) at hm)
// into this warp's slots of layer I; with do_db, db_I += sum_p G into db
// (shared memory, the warp's 16 columns). Each slot's tile sum starts from zero
// and is added to the slot in f32: the slots carry sums over all the block's
// tiles, where the tensor cores' truncating accumulation would drift.
template <class H, int I>
__device__ __forceinline__ void accumulate_dw(float (&acc)[H::kSlots][4], const float* gm,
                                              const float* hm, int s, int c0, int r, bool do_db,
                                              float* db) {
  float d0 = 0.f, d1 = 0.f;
  Split a[kTile / 8][4];
#pragma unroll
  for (int ks = 0; ks < kTile / 8; ++ks) {
    float v[4];
    load_gt(gm, s, ks * 8, c0, v);
    d0 += v[0] + v[2];
    d1 += v[1] + v[3];
#pragma unroll
    for (int e = 0; e < 4; ++e) a[ks][e] = split(v[e]);
  }
#pragma unroll
  for (int k = 0; k < H::count(I); ++k) {
    const int nt = r + k * H::kReps;
    if (H::kReps == 1 || nt < H::rows(I) / 8) {
      float part[4] = {};
#pragma unroll
      for (int ks = 0; ks < kTile / 8; ++ks) {
        Split b[2];
        load_h(hm, s, ks * 8, nt * 8, b);
        mma3(part, a[ks], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[H::start(I) + k][e] += part[e];
    }
  }
  if (do_db) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
    const int lane = threadIdx.x & 31;
    if ((lane & 3) == 0) {
      db[c0 + (lane >> 2)] += d0;
      db[c0 + (lane >> 2) + 8] += d1;
    }
  }
}

// The backward's layers I .. 0 of a tile, g_I in buffer I: dW_I and db_I, then
// g_{I-1} = (h_I > 0) g_I W_I^T in place of h_I, or, for I = 0, dx = g_0 W_0^T
// into buffer 2. x (buffer 1) was overwritten by h_2 when L > 2: recomputed
// before dW_0.
template <class H, int I>
__device__ __forceinline__ void backward_layers(const Geo& g, float* sm, float (&acc)[H::kSlots][4],
                                                const float* __restrict__ pts, long long n,
                                                long long p0, int mt, int r, float* db) {
  __syncthreads();
  if (I == 0 && H::kL > 2) {
    features(g, pts, n, p0, sm + g.bm_off, act_buf(g, sm, 1));
    __syncthreads();
  }
  float* gi = act_buf(g, sm, I);
  float* below = act_buf(g, sm, I == 0 ? 1 : I - 1);
  accumulate_dw<H, I>(acc, gi, below, g.stride, mt * 16, r, r == 0, db + I * H::kHP);
  if constexpr (I > 0) {
    __syncthreads();  // every warp has read h_I before g_{I-1} overwrites it
    block_product<kMask, true, kTile>(gi, g.stride, sm + g.w_off[I], below, H::kHP, H::kHP,
                                      H::kHP / 8);
    backward_layers<H, I - 1>(g, sm, acc, pts, n, p0, mt, r, db);
  } else {
    block_product<kPlain, true, kTile>(gi, g.stride, sm + g.w_off[0], act_buf(g, sm, 2), H::kHP,
                                       H::kK0P, H::kHP / 8);
  }
}

// The warp's slots of dW_I .. dW_{L-2} into the block's partial (flat layout).
template <class H, int I>
__device__ __forceinline__ void write_dw(const Geo& g, const float (&acc)[H::kSlots][4],
                                         float* part, int mt, int r) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int rows = I == 0 ? g.k0 : g.h;
  float* dw = part + w_offset(I, g.k0, g.h);
#pragma unroll
  for (int k = 0; k < H::count(I); ++k) {
    const int row = (r + k * H::kReps) * 8 + 2 * tq, col = mt * 16 + gq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row + (e & 1), cc = col + 8 * (e >> 1);
      if (rr < rows && cc < g.h) dw[static_cast<long long>(rr) * g.h + cc] = acc[H::start(I) + k][e];
    }
  }
  if constexpr (I + 2 < H::kL) write_dw<H, I + 1>(g, acc, part, mt, r);
}

template <class H>
__global__ void __launch_bounds__(kThreads, 1)
bwd_f32_kernel(const float* __restrict__ pts, const float* __restrict__ bmat, long long n,
               const float* __restrict__ params, const float* __restrict__ dout,
               float* __restrict__ dpts, float* __restrict__ partial, Geo g) {
  constexpr int hp = H::kHP, n_layers = H::kL;
  extern __shared__ __align__(16) float sm[];
  stage_weights(g, params, bmat, sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = g.stride, f = g.f;
  // Buffers: h_{i+1} in buffer i; x in buffer 1 (dead after layer 0, recomputed
  // for dW_0); dx in buffer 2. g_i overwrites h_{i+1} in place.
  float* x = act_buf(g, sm, 1);
  float* dx = act_buf(g, sm, 2);
  float* top = act_buf(g, sm, n_layers - 2);
  float* dsm = sm + g.dout_off;
  float* db = sm + g.db_off;
  for (int e = tid; e < (n_layers - 1) * hp; e += kThreads) db[e] = 0.f;
  const int mt = warp % H::kMTilesOut, r = warp / H::kMTilesOut;
  float acc[H::kSlots][4];
#pragma unroll
  for (int i = 0; i < H::kSlots; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // W_{L-1} and b_{L-1}: thread (column tid % HP, part tid / HP) over its points.
  constexpr int wl_parts = kThreads / hp;
  const int wl_col = tid % hp, wl_part = tid / hp;
  float dwl = 0.f, dbl = 0.f;
  const float* wl = sm + g.wl_off;
  const long long tiles = (n + kTile - 1) / kTile;
  bool first = true;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * kTile;
    if (first) cp_async_wait(n_layers - 1);  // B
    __syncthreads();
    features(g, pts, n, p0, sm + g.bm_off, x);
    for (int p = tid; p < kTile; p += kThreads) dsm[p] = p0 + p < n ? dout[p0 + p] : 0.f;
    forward_layers<H, 0>(g, sm, first);
    if (first) cp_async_wait(0);
    __syncthreads();
    // The last layer: dW_{L-1} += h^T dout, db_{L-1} += sum dout, then
    // g_{L-2} = (h > 0) dout W_{L-1}^T in place.
    for (int p = wl_part; p < kTile; p += wl_parts) dwl = fmaf(top[p * s + wl_col], dsm[p], dwl);
    if (tid == 0)
      for (int p = 0; p < kTile; ++p) dbl += dsm[p];
    __syncthreads();
    for (int e = tid; e < kTile * hp; e += kThreads) {
      const int p = e / hp, c = e % hp;
      top[p * s + c] = top[p * s + c] > 0.f ? dsm[p] * wl[c] : 0.f;
    }
    backward_layers<H, n_layers - 2>(g, sm, acc, pts, n, p0, mt, r, db);
    __syncthreads();
    // dpts = dx_pts + (dx_sin cos - dx_cos sin) B^T: 8 lanes a point.
    {
      const int p = warp * 4 + (lane >> 3), q = lane & 7;
      const float* bm = sm + g.bm_off;
      const float* xr = x + p * s;
      const float* dr = dx + p * s;
      float t0 = 0.f, t1 = 0.f, t2 = 0.f;
      for (int j = q; j < f; j += 8) {
        const float dproj = dr[j] * xr[f + j] - dr[f + j] * xr[j];
        t0 = fmaf(dproj, bm[j], t0);
        t1 = fmaf(dproj, bm[f + j], t1);
        t2 = fmaf(dproj, bm[2 * f + j], t2);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        t0 += __shfl_xor_sync(0xffffffffu, t0, o);
        t1 += __shfl_xor_sync(0xffffffffu, t1, o);
        t2 += __shfl_xor_sync(0xffffffffu, t2, o);
      }
      if (q == 0 && p0 + p < n) {
        dpts[3 * (p0 + p)] = dr[2 * f] + t0;
        dpts[3 * (p0 + p) + 1] = dr[2 * f + 1] + t1;
        dpts[3 * (p0 + p) + 2] = dr[2 * f + 2] + t2;
      }
    }
    first = false;
  }
  cp_async_wait(0);
  __syncthreads();
  // The block's partial, every entry written once: dW_i from the slots, db_i,
  // then W_{L-1} and b_{L-1}.
  float* part = partial + blockIdx.x * param_count(g.k0, g.h, n_layers);
  write_dw<H, 0>(g, acc, part, mt, r);
  for (int e = tid; e < (n_layers - 1) * g.h; e += kThreads) {
    const int i = e / g.h, c = e % g.h;
    part[b_offset(i, g.k0, g.h, n_layers) + c] = db[i * hp + c];
  }
  float* scratch = act_buf(g, sm, 0);
  scratch[tid] = dwl;
  __syncthreads();
  if (tid < g.h) {
    float v = 0.f;
    for (int q = 0; q < wl_parts; ++q) v += scratch[q * hp + tid];
    part[w_offset(n_layers - 1, g.k0, g.h) + tid] = v;
  }
  if (tid == 0) part[b_offset(n_layers - 1, g.k0, g.h, n_layers)] = dbl;
}

// ---------------------------------------------------------------------------
// The streamed kernels: every head that no resident build takes (H = 256, or a
// K0P, HP or depth of no build). Each W_i goes through shared memory one chunk
// at a time (kChunk columns for a forward product, kChunk rows for a transposed
// one), staged by cp.async for every tile; a block takes tiles of TP points, the
// largest of kSTiles whose layout fits, and the backward adds each tile's dW_i
// into its own partial in global memory (written, not added, at its first
// tile). Same arithmetic as the resident kernels: split
// TF32 products, the backward's recomputed forward as FMA chains.
// ---------------------------------------------------------------------------

// Biases, W_{L-1}, b_{L-1} and B into shared memory, one commit group.
__device__ __forceinline__ void stage_small(const Geo& g, const float* __restrict__ params,
                                            const float* __restrict__ bmat, float* sm) {
  const int last = g.n_layers - 1;
  for (int i = 0; i < last; ++i)
    stage_vector(params + b_offset(i, g.k0, g.h, g.n_layers), g.h, g.hp, sm + g.b_off[i]);
  stage_vector(params + w_offset(last, g.k0, g.h), g.h, g.hp, sm + g.wl_off);
  stage_vector(params + b_offset(last, g.k0, g.h, g.n_layers), 1, 4, sm + g.wl_off + g.hp);
  stage_vector(bmat, 3 * g.f, 3 * g.f, sm + g.bm_off);
  cp_async_commit();
}

// Rows r0 .. r0 + nr and columns c0 .. c0 + nc of W_i (nr, nc multiples of 8;
// zero past the real rows and columns) into the chunk's block image, once every
// thread is done with the previous chunk; returns when it has landed.
__device__ __forceinline__ void stage_chunk(const Geo& g, const float* __restrict__ params, int i,
                                            int r0, int nr, int c0, int nc, float* chunk) {
  const int rows = i == 0 ? g.k0 : g.h;
  __syncthreads();
  stage_image(params + w_offset(i, g.k0, g.h) + static_cast<long long>(r0) * g.h + c0,
              min(nr, rows - r0), min(nc, g.h - c0), nr, nc, g.h, chunk);
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
}

template <int TP>
__global__ void __launch_bounds__(kThreads, 1)
fwd_f32_streamed_kernel(const float* __restrict__ pts, const float* __restrict__ bmat, long long n,
                        const float* __restrict__ params, float* __restrict__ out, Geo g) {
  constexpr int kLanes = kThreads / TP;  // lanes a point in the H -> 1 layer
  extern __shared__ __align__(16) float sm[];
  stage_small(g, params, bmat, sm);
  float* chunk = sm + g.chunk_off;
  const float* wl = sm + g.wl_off;
  const long long tiles = (n + TP - 1) / TP;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * TP;
    cp_async_wait(0);
    __syncthreads();
    features(g, pts, n, p0, sm + g.bm_off, act_buf(g, sm, 0), TP);
    int cur = 0;
    for (int i = 0; i < g.n_layers - 1; ++i, cur ^= 1) {
      for (int c0 = 0; c0 < g.hp; c0 += kChunk) {
        const int nc = min(kChunk, g.hp - c0);
        stage_chunk(g, params, i, 0, rows_p(g, i), c0, nc, chunk);
        block_product<kBiasRelu, false, TP>(act_buf(g, sm, cur), g.stride, chunk,
                                                act_buf(g, sm, cur ^ 1) + c0, rows_p(g, i), nc,
                                                nc / 8, sm + g.b_off[i] + c0);
      }
    }
    __syncthreads();
    // sigma = h W_{L-1} + b: kLanes lanes a point, then shuffles.
    const int p = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
    const float* hr = act_buf(g, sm, cur) + p * g.stride;
    float v = 0.f;
    for (int c = q; c < g.hp; c += kLanes) v = fmaf(hr[c], wl[c], v);
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (q == 0 && p0 + p < n) out[p0 + p] = v + wl[g.hp];
  }
  cp_async_wait(0);
}

// dW_i += H^T G over a TP-point tile (G at gm, H at hm), into the block's
// partial dw (W_i's flat layout): warps take the (16-column, 8-row) tiles of
// dW_i^T in turn, kBatch at a time (their partial entries loaded together
// first), each tile's sum split TF32 and then added in f32 (stored at the
// block's first tile). The same lane owns an entry at every tile.
template <int TP>
__device__ __forceinline__ void streamed_dw(const Geo& g, const float* gm, const float* hm, int i,
                                            float* dw, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int rows = i == 0 ? g.k0 : g.h, mts = g.hp / 16, total = mts * (rows_p(g, i) / 8);
  for (int q0 = warp; q0 < total; q0 += kWarps * kBatch) {
    float old[kBatch][4];
    int at[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * kWarps, mt = q % mts, nt = q / mts;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = nt * 8 + 2 * tq + (e & 1), cc = mt * 16 + gq + 8 * (e >> 1);
        at[b][e] = q < total && rr < rows && cc < g.h ? rr * g.h + cc : -1;
        old[b][e] = at[b][e] >= 0 && !first ? dw[at[b][e]] : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * kWarps, mt = q % mts, nt = q / mts;
      if (q >= total) break;
      float part[4] = {};
#pragma unroll
      for (int ks = 0; ks < TP / 8; ++ks) {
        float v[4];
        load_gt(gm, g.stride, ks * 8, mt * 16, v);
        const Split a[4] = {split(v[0]), split(v[1]), split(v[2]), split(v[3])};
        Split fb[2];
        load_h(hm, g.stride, ks * 8, nt * 8, fb);
        mma3(part, a, fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (at[b][e] >= 0) dw[at[b][e]] = old[b][e] + part[e];
    }
  }
}

template <int TP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_f32_streamed_kernel(const float* __restrict__ pts, const float* __restrict__ bmat, long long n,
                        const float* __restrict__ params, const float* __restrict__ dout,
                        float* __restrict__ dpts, float* __restrict__ partial, Geo g) {
  constexpr int kLanes = kThreads / TP;  // lanes a point in dpts
  extern __shared__ __align__(16) float sm[];
  stage_small(g, params, bmat, sm);
  const int tid = threadIdx.x;
  const int s = g.stride, f = g.f, hp = g.hp, n_layers = g.n_layers;
  // Buffers as in bwd_f32_kernel: h_{i+1} in buffer i, x in buffer 1, dx in 2.
  float* x = act_buf(g, sm, 1);
  float* dx = act_buf(g, sm, 2);
  float* top = act_buf(g, sm, n_layers - 2);
  float* dsm = sm + g.dout_off;
  float* db = sm + g.db_off;                   // db_i, i < L - 1
  float* dwl = db + (n_layers - 1) * hp;       // dW_{L-1}, then db_{L-1}
  float* chunk = sm + g.chunk_off;
  const float* wl = sm + g.wl_off;
  for (int e = tid; e < n_layers * hp + 4; e += kThreads) db[e] = 0.f;
  float* part = partial + blockIdx.x * param_count(g.k0, g.h, n_layers);
  const long long tiles = (n + TP - 1) / TP;
  bool first = true;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * TP;
    cp_async_wait(0);
    __syncthreads();
    features(g, pts, n, p0, sm + g.bm_off, x, TP);
    for (int p = tid; p < TP; p += kThreads) dsm[p] = p0 + p < n ? dout[p0 + p] : 0.f;
    for (int i = 0; i < n_layers - 1; ++i) {
      for (int c0 = 0; c0 < hp; c0 += kChunk) {
        const int nc = min(kChunk, hp - c0);
        stage_chunk(g, params, i, 0, rows_p(g, i), c0, nc, chunk);
        fma_layer<TP>(act_buf(g, sm, i == 0 ? 1 : i - 1), s, chunk, act_buf(g, sm, i) + c0,
                      sm + g.b_off[i] + c0, rows_p(g, i), nc, nc / 8);
      }
    }
    __syncthreads();
    // The last layer: dW_{L-1} += h^T dout (a thread a column, points in order),
    // db_{L-1} += sum dout, then g_{L-2} = (h > 0) dout W_{L-1}^T in place.
    for (int c = tid; c < hp; c += kThreads) {
      float v = dwl[c];
      for (int p = 0; p < TP; ++p) v = fmaf(top[p * s + c], dsm[p], v);
      dwl[c] = v;
    }
    if (tid == 0) {
      float v = dwl[hp];
      for (int p = 0; p < TP; ++p) v += dsm[p];
      dwl[hp] = v;
    }
    __syncthreads();
    for (int e = tid; e < TP * hp; e += kThreads) {
      const int p = e / hp, c = e % hp;
      top[p * s + c] = top[p * s + c] > 0.f ? dsm[p] * wl[c] : 0.f;
    }
    for (int i = n_layers - 2; i >= 0; --i) {
      __syncthreads();
      if (i == 0 && n_layers > 2) {  // x was overwritten by h_2
        features(g, pts, n, p0, sm + g.bm_off, x, TP);
        __syncthreads();
      }
      float* gi = act_buf(g, sm, i);
      float* below = act_buf(g, sm, i == 0 ? 1 : i - 1);
      streamed_dw<TP>(g, gi, below, i, part + w_offset(i, g.k0, g.h), first);
      for (int c = tid; c < hp; c += kThreads) {
        float v = db[i * hp + c];
        for (int p = 0; p < TP; ++p) v += gi[p * s + c];
        db[i * hp + c] = v;
      }
      // g_{i-1} = (h_i > 0) g_i W_i^T in place of h_i, or dx = g_0 W_0^T, by
      // chunks of W_i's rows.
      for (int r0 = 0; r0 < rows_p(g, i); r0 += kChunk) {
        const int nr = min(kChunk, rows_p(g, i) - r0);
        stage_chunk(g, params, i, r0, nr, 0, hp, chunk);
        if (i > 0) {
          block_product<kMask, true, TP>(gi, s, chunk, below + r0, hp, nr, hp / 8);
        } else {
          block_product<kPlain, true, TP>(gi, s, chunk, dx + r0, hp, nr, hp / 8);
        }
      }
    }
    __syncthreads();
    // dpts = dx_pts + (dx_sin cos - dx_cos sin) B^T: kLanes lanes a point.
    {
      const int p = tid / kLanes, q = tid % kLanes;
      const float* bm = sm + g.bm_off;
      const float* xr = x + p * s;
      const float* dr = dx + p * s;
      float t0 = 0.f, t1 = 0.f, t2 = 0.f;
      for (int j = q; j < f; j += kLanes) {
        const float dproj = dr[j] * xr[f + j] - dr[f + j] * xr[j];
        t0 = fmaf(dproj, bm[j], t0);
        t1 = fmaf(dproj, bm[f + j], t1);
        t2 = fmaf(dproj, bm[2 * f + j], t2);
      }
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) {
        t0 += __shfl_xor_sync(0xffffffffu, t0, o);
        t1 += __shfl_xor_sync(0xffffffffu, t1, o);
        t2 += __shfl_xor_sync(0xffffffffu, t2, o);
      }
      if (q == 0 && p0 + p < n) {
        dpts[3 * (p0 + p)] = dr[2 * f] + t0;
        dpts[3 * (p0 + p) + 1] = dr[2 * f + 1] + t1;
        dpts[3 * (p0 + p) + 2] = dr[2 * f + 2] + t2;
      }
    }
    first = false;
  }
  cp_async_wait(0);
  __syncthreads();
  // The rest of the block's partial: db_i, dW_{L-1}, b_{L-1}.
  for (int e = tid; e < (n_layers - 1) * g.h; e += kThreads) {
    const int i = e / g.h, c = e % g.h;
    part[b_offset(i, g.k0, g.h, n_layers) + c] = db[i * hp + c];
  }
  for (int c = tid; c < g.h; c += kThreads) part[w_offset(n_layers - 1, g.k0, g.h) + c] = dwl[c];
  if (tid == 0) part[b_offset(n_layers - 1, g.k0, g.h, n_layers)] = dwl[hp];
}

__global__ void reduce_f32_kernel(const float* __restrict__ partial, int blocks, long long count,
                                  float* __restrict__ grads) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[b * count + e];
  grads[e] = s;
}

// One split-TF32 m16n8k8 product in each of the three operand forms, through
// the fragment loads and the weight image of the kernels: A W, A W^T (A 16 x 8,
// W 8 x 8) and G^T H (G 8 x 16, H 8 x 8). One warp.
__global__ void selftest_kernel(const float* a, const float* w, const float* gm, const float* hm,
                                float* out_f, float* out_b, float* out_w) {
  __shared__ __align__(16) float sa[16 * 8], sw[64], sg[8 * 24], sh[8 * 8];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int e = lane; e < 128; e += 32) sa[e] = a[e];
  stage_image(w, 8, 8, 8, 8, 8, sw);
  for (int e = lane; e < 128; e += 32) sg[(e / 16) * 24 + e % 16] = gm[e];
  for (int e = lane; e < 64; e += 32) sh[e] = hm[e];
  cp_async_commit();
  cp_async_wait(0);
  __syncwarp();
  Split fa[4], fb[2];
  float d[3][4] = {};
  load_a_rows(sa, 8, 0, 0, fa);
  load_b_w(sw, fb);
  mma3(d[0], fa, fb);
  load_b_wt(sw, fb);
  mma3(d[1], fa, fb);
  float v[4];
  load_gt(sg, 24, 0, 0, v);
  const Split ga[4] = {split(v[0]), split(v[1]), split(v[2]), split(v[3])};
  load_h(sh, 8, 0, 0, fb);
  mma3(d[2], ga, fb);
  float* outs[3] = {out_f, out_b, out_w};
  for (int k = 0; k < 3; ++k)
    for (int e = 0; e < 4; ++e) outs[k][(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = d[k][e];
}

bool shape_ok(long long n, int grid) { return n > 0 && grid >= 1; }

using FwdKernel = void (*)(const float*, const float*, long long, const float*, float*, Geo);
using BwdKernel = void (*)(const float*, const float*, long long, const float*, const float*,
                           float*, float*, Geo);

// The heads with a resident build, as (K0P, HP, L): the f32 heads of cfg/,
// box_room_camera.yaml's and box_room_tiny_tpu.yaml's (F 31-34, 3 x 128) and
// courtyard_tiny.yaml's (F 31-34, 2 x 64). Every other head takes the streamed
// kernels.
#define LT_F32_HEADS(X) X(72, 128, 4) X(72, 64, 3)

bool find_kernels(const Geo& g, FwdKernel* fwd, BwdKernel* bwd) {
#define LT_F32_MATCH(K0P, HP, L)                                  \
  if (g.k0p == K0P && g.hp == HP && g.n_layers == L) {            \
    *fwd = fwd_f32_kernel<Head<K0P, HP, L>>;                      \
    *bwd = bwd_f32_kernel<Head<K0P, HP, L>>;                      \
    return true;                                                  \
  }
  LT_F32_HEADS(LT_F32_MATCH)
#undef LT_F32_MATCH
  return false;
}

// The streamed kernels for g.tile.
void streamed_kernels(const Geo& g, FwdKernel* fwd, BwdKernel* bwd) {
  if (g.tile == 64) {
    *fwd = fwd_f32_streamed_kernel<64>;
    *bwd = bwd_f32_streamed_kernel<64>;
  } else if (g.tile == 32) {
    *fwd = fwd_f32_streamed_kernel<32>;
    *bwd = bwd_f32_streamed_kernel<32>;
  } else {
    *fwd = fwd_f32_streamed_kernel<16>;
    *bwd = bwd_f32_streamed_kernel<16>;
  }
}

// The head's layout and kernel: the resident build for its padded shape, else the
// streamed kernels at the largest tile whose layout fits; false for a head that
// fits neither.
bool choose(int f, int h, int n_layers, bool backward, Geo* g, const void** kernel) {
  FwdKernel fwd;
  BwdKernel bwd;
  bool found = make_geo(f, h, n_layers, backward, false, 0, g) && find_kernels(*g, &fwd, &bwd);
  for (int t = 0; !found && t < static_cast<int>(sizeof(kSTiles) / sizeof(int)); ++t) {
    found = make_geo(f, h, n_layers, backward, true, kSTiles[t], g);
    if (found) streamed_kernels(*g, &fwd, &bwd);
  }
  if (found)
    *kernel = backward ? reinterpret_cast<const void*>(bwd) : reinterpret_cast<const void*>(fwd);
  return found;
}

// choose(), with the kernel's shared memory granted.
bool plan(int f, int h, int n_layers, bool backward, Geo* g, const void** kernel) {
  return choose(f, h, n_layers, backward, g, kernel) &&
         cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(4 * g->floats)) == cudaSuccess;
}

}  // namespace

// Points a block takes per round of its loop (the resident forward: 16 a warp),
// or -1 for a head that no kernel takes. Needs no device.
extern "C" int lt_fourier_mlp_f32_tile(int f, int h, int n_layers, int backward) {
  Geo g;
  const void* kernel;
  if (!choose(f, h, n_layers, backward != 0, &g, &kernel)) return -1;
  return g.streamed || backward ? g.tile : g.tile * kWarps;
}

// Resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a
// negative CUDA error.
extern "C" int lt_fourier_mlp_f32_occupancy(int f, int h, int n_layers, int backward) {
  Geo g;
  const void* kernel;
  if (!plan(f, h, n_layers, backward != 0, &g, &kernel))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 4 * g.floats);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

extern "C" int lt_fourier_mlp_f32_fwd(const float* pts, const float* bmat, long long n, int f,
                                      int h, int n_layers, const float* params, float* out,
                                      int grid, void* stream) {
  Geo g;
  const void* kernel;
  if (!shape_ok(n, grid) || !plan(f, h, n_layers, false, &g, &kernel))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&pts, &bmat, &n, &params, &out, &g};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, 4 * g.floats,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int lt_fourier_mlp_f32_bwd(const float* pts, const float* bmat, long long n, int f,
                                      int h, int n_layers, const float* params, const float* dout,
                                      float* dpts, float* partial, int grid, float* grads,
                                      void* stream) {
  Geo g;
  const void* kernel;
  if (!shape_ok(n, grid) || !plan(f, h, n_layers, true, &g, &kernel))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&pts, &bmat, &n, &params, &dout, &dpts, &partial, &g};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, 4 * g.floats, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = param_count(2 * f + 3, h, n_layers);
  reduce_f32_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(partial, grid,
                                                                             count, grads);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lt_mma_tf32_selftest(const float* a, const float* w, const float* gm,
                                    const float* hm, float* out_f, float* out_b, float* out_w,
                                    void* stream) {
  selftest_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, w, gm, hm, out_f, out_b,
                                                                   out_w);
  return static_cast<int>(cudaGetLastError());
}
