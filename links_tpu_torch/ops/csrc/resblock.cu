// The side lifters' residual block (K1), forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces links_tpu/experimental/pallas_resblock.py:_fwd_kernel (forward) and :_bwd_kernel
// (backward), the Pallas TPU kernels of the fused residual block. For one side, x (B, H) and
// weights W1, W2 (H, H) in torch's (out, in) layout:
//   a1 = x W1^T + b1,  h = lrelu(a1),  a2 = h W2^T + b2,  y = lrelu(a2) + x   (no outer lrelu)
// and for an upstream gradient dy, with lrelu'(v) = 1 for v >= 0 and 0.01 below:
//   g2 = dy * lrelu'(a2),  dh = g2 W2,  g1 = dh * lrelu'(a1),  dx = dy + g1 W1,
//   dW1 = g1^T x,  dW2 = g2^T h,  db1 = sum over rows of g1,  db2 = sum over rows of g2.
//
// Numerics follow the training step's dtype policy (links_tpu_torch/core/nn.py), which is what
// jax.grad of the JAX package's res_block_apply computes:
//   bf16: the forward's matmul inputs x, h, W1 and W2 are rounded to bf16, products accumulate
//     in f32, and bias, lrelu and the residual (with the f32 x) are f32. In the backward the
//     gradients g1 and g2 stay f32 as matmul operands while W1, W2, x and h enter rounded to
//     bf16, and the four products (dh, g1 W1, dW1, dW2) are rounded to bf16, as the transposes
//     of JAX's bf16 dots are; db1 and db2 are f32 sums.
//   f32: every product at f32 precision (never TF32).
// Tensor cores multiply bf16, so each operand is staged from its f32 master in device memory
// into shared memory as a sum of bf16 terms, split as it is staged (no separate cast launch):
// one term for an operand the policy rounds to bf16, two (hi + lo, 16 significant bits) for an
// f32 gradient under the bf16 policy, three (24 bits, f32's own precision) under the f32
// policy. A tile product sums the term products i + j < max(terms) with wmma bf16 16x16x16
// fragments into f32 accumulators.
//
// Launches: forward 2 (a1 and h; then a2 and y); backward 5 (dh -> g1; dW2; dx; dW1; db1 and
// db2). Every output tile belongs to one block, which loops over the whole reduction (K = H,
// or K = B for dW), so there are no float atomics and repeated runs agree bitwise. The forward
// saves a1, h and a2 (3 B H f32, 6 MB at B = 512) for the backward instead of recomputing them
// as the TPU kernel does: the recompute would add two products to the backward's four, and the
// saved activations cost one write and one read.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16) at the training step's shape
// B = 512, H = 1024, counting the block's own inputs and outputs once (f32 masters):
//   forward: 2 products, 2.15 GFLOP -> 2.2 us; W1, W2, b1, b2, x in and y out, 12.6 MB -> 3.8 us.
//   backward: from (x, W, b, dy) to (dx, dW, db) a block needs 6 products (a1 and a2 recomputed),
//     6.4 GFLOP -> 6.5 us; 23.1 MB -> 6.9 us.
// Both are bound by bytes. chip_smoke.py recomputes these for the shapes it times.
// This first version is a plain tiled GEMM: 64 x 64 output tiles, a 32-deep K step staged
// through registers (the next step's global loads are in flight during this step's products),
// one shared-memory buffer. Not yet: TMA, wgmma, a deeper pipeline, both sides in one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns) of 16 x 32 outputs
constexpr int BM = 64;         // output tile rows (and the rows of a staged operand tile)
constexpr int BN = 64;         // output tile columns
constexpr int BK = 32;         // reduction step
constexpr int kPad = 8;        // bf16 elements of row padding (keeps fragment rows 32 B aligned)
constexpr int kPadC = 4;       // f32 elements of row padding of the accumulator tile
// one bf16 term of a staged 64 x 32 operand tile, in either layout: [64][BK + kPad] when the
// operand is contiguous along k, [BK][64 + kPad] when it is contiguous along its rows
constexpr int kTermElems = BM * (BK + kPad);
constexpr float kSlope = 0.01f;

enum Epi { kFwd1, kFwd2, kDh, kDx, kDw };

// C (M x N) = A (M x K) B^T, with B given as N x K. Element (r, k) of an operand lies at
// p[r * ld + k] when it is contiguous along k, else at p[k * ld + r]. Outputs and `aux` are
// row-major (M, N).
struct Gemm {
  const float* a;
  const float* a_mask;  // if set: A's element is multiplied by lrelu'(a_mask) at its index
  const float* b;
  long long lda, ldb;
  int M, N, K;
  float* out0;
  float* out1;
  const float* bias;  // (N)
  const float* aux;   // the epilogue's elementwise input
  int round_out;      // round the product to bf16 (the bf16 policy's backward)
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }
__device__ __forceinline__ float dlrelu(float v) { return v >= 0.f ? 1.f : kSlope; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Loads this thread's two float4s of the 64 x 32 operand tile at (r0, k0), along the operand's
// contiguous dimension; zero outside (rows, K).
template <bool KCONT>
__device__ __forceinline__ void load_tile(float4 (&v)[2], const float* p, const float* mask,
                                          long long ld, int rows, int K, int r0, int k0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = KCONT ? i / (BK / 4) : (i % (BM / 4)) * 4;
    const int k = KCONT ? (i % (BK / 4)) * 4 : i / (BM / 4);
    const int gr = r0 + r, gk = k0 + k;
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < rows && gk < K) {
      const long long off = KCONT ? gr * ld + gk : gk * ld + gr;
      v[j] = __ldg(reinterpret_cast<const float4*>(p + off));
      if (mask) {
        const float4 m = __ldg(reinterpret_cast<const float4*>(mask + off));
        v[j].x *= dlrelu(m.x);
        v[j].y *= dlrelu(m.y);
        v[j].z *= dlrelu(m.z);
        v[j].w *= dlrelu(m.w);
      }
    }
  }
}

// Stores the loaded float4s into shared memory as NT bf16 terms (term t at s + t * kTermElems):
// term 0 is the value rounded to bf16, each later term the rounded remainder.
template <bool KCONT, int NT>
__device__ __forceinline__ void store_tile(__nv_bfloat16* s, const float4 (&v)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = KCONT ? i / (BK / 4) : (i % (BM / 4)) * 4;
    const int k = KCONT ? (i % (BK / 4)) * 4 : i / (BM / 4);
    __nv_bfloat16* dst = s + (KCONT ? r * (BK + kPad) + k : k * (BM + kPad) + r);
    float e[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
      // the remainders are exact: a value less its rounding to 8 significant bits
      e[0] -= __low2float(lo);
      e[1] -= __high2float(lo);
      e[2] -= __low2float(hi);
      e[3] -= __high2float(hi);
      *reinterpret_cast<uint2*>(dst + t * kTermElems) = make_uint2(
          *reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
    }
  }
}

template <int EPI>
__device__ __forceinline__ void epilogue(const Gemm& g, const float4 acc, long long o, int n) {
  float v[4] = {acc.x, acc.y, acc.z, acc.w};
  float r0[4], r1[4];
  if (EPI == kFwd1 || EPI == kFwd2) {
    const float4 b = *reinterpret_cast<const float4*>(g.bias + n);
    v[0] += b.x;
    v[1] += b.y;
    v[2] += b.z;
    v[3] += b.w;
  }
  float aux[4] = {0.f, 0.f, 0.f, 0.f};
  if (EPI == kFwd2 || EPI == kDh || EPI == kDx) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(g.aux + o));
    aux[0] = a.x;
    aux[1] = a.y;
    aux[2] = a.z;
    aux[3] = a.w;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float p = g.round_out ? round_bf16(v[c]) : v[c];
    if (EPI == kFwd1) {  // a1, h
      r0[c] = v[c];
      r1[c] = lrelu(v[c]);
    } else if (EPI == kFwd2) {  // a2, y
      r0[c] = v[c];
      r1[c] = lrelu(v[c]) + aux[c];
    } else if (EPI == kDh) {  // g1 = dh * lrelu'(a1)
      r0[c] = p * dlrelu(aux[c]);
    } else if (EPI == kDx) {  // dx = dy + g1 W1
      r0[c] = aux[c] + p;
    } else {  // dW
      r0[c] = p;
    }
  }
  *reinterpret_cast<float4*>(g.out0 + o) = make_float4(r0[0], r0[1], r0[2], r0[3]);
  if (EPI == kFwd1 || EPI == kFwd2)
    *reinterpret_cast<float4*>(g.out1 + o) = make_float4(r1[0], r1[1], r1[2], r1[3]);
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <bool A_KCONT, bool B_KCONT, int NA, int NB, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Gemm g) {
  constexpr int kTerms = cmax(NA, NB);  // term products i + j < kTerms are summed
  constexpr int kStageBytes = (NA + NB) * kTermElems * 2;
  constexpr int kAccBytes = BM * (BN + kPadC) * 4;
  __shared__ __align__(128) unsigned char smem[cmax(kStageBytes, kAccBytes)];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + NA * kTermElems;
  float(*sc)[BN + kPadC] = reinterpret_cast<float(*)[BN + kPadC]>(smem);

  using LA = std::conditional_t<A_KCONT, wmma::row_major, wmma::col_major>;
  using LB = std::conditional_t<B_KCONT, wmma::col_major, wmma::row_major>;
  constexpr int lda_s = A_KCONT ? BK + kPad : BM + kPad;
  constexpr int ldb_s = B_KCONT ? BK + kPad : BN + kPad;

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  float4 ra[2], rb[2];
  const int nk = (g.K + BK - 1) / BK;
  load_tile<A_KCONT>(ra, g.a, g.a_mask, g.lda, g.M, g.K, row0, 0);
  load_tile<B_KCONT>(rb, g.b, nullptr, g.ldb, g.N, g.K, col0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    store_tile<A_KCONT, NA>(sa, ra);
    store_tile<B_KCONT, NB>(sb, rb);
    __syncthreads();
    if (kt + 1 < nk) {  // the next step's loads are in flight during this step's products
      load_tile<A_KCONT>(ra, g.a, g.a_mask, g.lda, g.M, g.K, row0, (kt + 1) * BK);
      load_tile<B_KCONT>(rb, g.b, nullptr, g.ldb, g.N, g.K, col0, (kt + 1) * BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa[NA];
      const int a_off = A_KCONT ? wm * 16 * lda_s + kk : kk * lda_s + wm * 16;
#pragma unroll
      for (int i = 0; i < NA; ++i) wmma::load_matrix_sync(fa[i], sa + i * kTermElems + a_off, lda_s);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n0 = wn * 32 + j * 16;
        const int b_off = B_KCONT ? n0 * ldb_s + kk : kk * ldb_s + n0;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb[NB];
#pragma unroll
        for (int t = 0; t < NB; ++t)
          wmma::load_matrix_sync(fb[t], sb + t * kTermElems + b_off, ldb_s);
#pragma unroll
        for (int i = 0; i < NA; ++i)
#pragma unroll
          for (int t = 0; t < NB; ++t)
            if (i + t < kTerms) wmma::mma_sync(acc[j], fa[i], fb[t], acc[j]);
      }
    }
    __syncthreads();  // every warp is done with the staged tile before it is overwritten
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&sc[wm * 16][wn * 32 + j * 16], acc[j], BN + kPadC,
                            wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < BM * BN / 4 / kThreads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int m = row0 + r, n = col0 + c;
    if (m < g.M)
      epilogue<EPI>(g, *reinterpret_cast<const float4*>(&sc[r][c]), (long long)m * g.N + n, n);
  }
}

// db1 = sum over rows of g1 and db2 = sum over rows of dy * lrelu'(a2), both (H). A block owns
// 32 columns of one of them; its 8 warps sum interleaved rows, combined in warp order.
__global__ void __launch_bounds__(kThreads)
    bias_grads_kernel(const float* g1, const float* dy, const float* a2, float* db1, float* db2,
                      int B, int H) {
  __shared__ float part[kThreads / 32][33];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;  // in [0, 2H)
  const bool second = c >= H;
  const int col = second ? c - H : c;
  float acc = 0.f;
  for (int r = grp; r < B; r += kThreads / 32) {
    const long long o = (long long)r * H + col;
    acc += second ? __ldg(dy + o) * dlrelu(__ldg(a2 + o)) : __ldg(g1 + o);
  }
  part[grp][lane] = acc;
  __syncthreads();
  if (grp == 0) {
    float s = part[0][lane];
#pragma unroll
    for (int k = 1; k < kThreads / 32; ++k) s += part[k][lane];
    (second ? db2 : db1)[col] = s;
  }
}

template <bool A_KCONT, bool B_KCONT, int NA, int NB, int EPI>
cudaError_t launch(const Gemm& g, cudaStream_t stream) {
  const dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  gemm_kernel<A_KCONT, B_KCONT, NA, NB, EPI><<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

// Runs fn() with `device` current, and restores the calling thread's device.
template <typename F>
int on_device(int device, F fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = fn();
  cudaSetDevice(prev);
  return (int)err;
}

bool bad_shape(int B, int H) { return B < 1 || H < BN || H % BN; }

}  // namespace

extern "C" {

// Forward of the residual block for x (B, H): writes a1, h, a2 (saved for the backward) and y,
// all f32 (B, H). `f32` selects the f32 policy, else bf16. Launches on `stream` and returns the
// cudaError_t of the launches (0 = ok); does not synchronise.
int res_block_forward_launch(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* a1, void* h, void* a2, void* y, int B, int H,
                             int f32, int device, void* stream) {
  if (bad_shape(B, H)) return (int)cudaErrorInvalidValue;
  Gemm l1 = {};
  l1.a = static_cast<const float*>(x);
  l1.b = static_cast<const float*>(w1);  // B(n, k) = W1[n, k]
  l1.lda = l1.ldb = H;
  l1.M = B;
  l1.N = l1.K = H;
  l1.out0 = static_cast<float*>(a1);
  l1.out1 = static_cast<float*>(h);
  l1.bias = static_cast<const float*>(b1);
  Gemm l2 = l1;
  l2.a = static_cast<const float*>(h);
  l2.b = static_cast<const float*>(w2);
  l2.out0 = static_cast<float*>(a2);
  l2.out1 = static_cast<float*>(y);
  l2.bias = static_cast<const float*>(b2);
  l2.aux = static_cast<const float*>(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    cudaError_t e;
    if (f32) {
      e = launch<true, true, 3, 3, kFwd1>(l1, s);
      if (e == cudaSuccess) e = launch<true, true, 3, 3, kFwd2>(l2, s);
    } else {
      e = launch<true, true, 1, 1, kFwd1>(l1, s);
      if (e == cudaSuccess) e = launch<true, true, 1, 1, kFwd2>(l2, s);
    }
    return e;
  });
}

// Backward of the residual block: from dy and the saved x, W1, W2, a1, h, a2 (all f32) writes
// dx (B, H), dW1, dW2 (H, H, torch layout), db1, db2 (H), using g1 (B, H) as scratch. Launches
// on `stream` and returns the cudaError_t of the launches (0 = ok); does not synchronise.
int res_block_backward_launch(const void* dy, const void* x, const void* w1, const void* w2,
                              const void* a1, const void* h, const void* a2, void* g1, void* dx,
                              void* dw1, void* db1, void* dw2, void* db2, int B, int H, int f32,
                              int device, void* stream) {
  if (bad_shape(B, H)) return (int)cudaErrorInvalidValue;
  const float* fdy = static_cast<const float*>(dy);
  const float* fa2 = static_cast<const float*>(a2);
  float* fg1 = static_cast<float*>(g1);
  // g1 = round(g2 W2) * lrelu'(a1): A = g2 = dy * lrelu'(a2) (B x H), B(n, k) = W2[k, n]
  Gemm gdh = {};
  gdh.a = fdy;
  gdh.a_mask = fa2;
  gdh.b = static_cast<const float*>(w2);
  gdh.lda = gdh.ldb = H;
  gdh.M = B;
  gdh.N = gdh.K = H;
  gdh.out0 = fg1;
  gdh.aux = static_cast<const float*>(a1);
  gdh.round_out = f32 ? 0 : 1;
  // dx = dy + round(g1 W1): A = g1, B(n, k) = W1[k, n]
  Gemm gdx = gdh;
  gdx.a = fg1;
  gdx.a_mask = nullptr;
  gdx.b = static_cast<const float*>(w1);
  gdx.out0 = static_cast<float*>(dx);
  gdx.aux = fdy;
  // dW2[o, i] = round(sum_b g2[b, o] h[b, i]): A(o, b) = g2[b, o], B(i, b) = h[b, i], K = B
  Gemm gdw2 = {};
  gdw2.a = fdy;
  gdw2.a_mask = fa2;
  gdw2.b = static_cast<const float*>(h);
  gdw2.lda = gdw2.ldb = H;
  gdw2.M = gdw2.N = H;
  gdw2.K = B;
  gdw2.out0 = static_cast<float*>(dw2);
  gdw2.round_out = gdh.round_out;
  // dW1[o, i] = round(sum_b g1[b, o] x[b, i])
  Gemm gdw1 = gdw2;
  gdw1.a = fg1;
  gdw1.a_mask = nullptr;
  gdw1.b = static_cast<const float*>(x);
  gdw1.out0 = static_cast<float*>(dw1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    cudaError_t e;
    if (f32) {
      e = launch<true, false, 3, 3, kDh>(gdh, s);
      if (e == cudaSuccess) e = launch<false, false, 3, 3, kDw>(gdw2, s);
      if (e == cudaSuccess) e = launch<true, false, 3, 3, kDx>(gdx, s);
      if (e == cudaSuccess) e = launch<false, false, 3, 3, kDw>(gdw1, s);
    } else {
      e = launch<true, false, 2, 1, kDh>(gdh, s);
      if (e == cudaSuccess) e = launch<false, false, 2, 1, kDw>(gdw2, s);
      if (e == cudaSuccess) e = launch<true, false, 2, 1, kDx>(gdx, s);
      if (e == cudaSuccess) e = launch<false, false, 2, 1, kDw>(gdw1, s);
    }
    if (e == cudaSuccess) {
      bias_grads_kernel<<<2 * H / 32, kThreads, 0, s>>>(fg1, fdy, fa2, static_cast<float*>(db1),
                                                        static_cast<float*>(db2), B, H);
      e = cudaGetLastError();
    }
    return e;
  });
}

const char* res_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
