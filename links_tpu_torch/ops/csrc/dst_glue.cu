// The glue of MotionBERT's DSTformer (links_tpu_torch/models/dstformer.py) between its library
// GEMMs (core/nn.py:mm_bf16, an f32 product) and attention (scaled_dot_product_attention),
// hand-written for Hopper (sm_90a). Wrapper and plain versions: ops/dst_glue.py.
//
// No TPU kernel counterpart: the JAX package has no DSTformer. Added because PyTorch's
// elementwise passes between those library kernels took 66% of the card's busy time in the
// `dst-lift-sat` cell: a sub-step read and wrote whole (M, C) activations several times (bias
// add, residual add, LayerNorm, a bf16 cast, the qkv bias add through a permuted view), where
// each chain between two library kernels needs one pass. Every kernel here is that one pass: it
// reads each operand once and writes the next kernel's operand, in the type it takes.
//   residual_layernorm (residual_layernorm_kernel): s = x + (u + bias) in f32, written over u
//     (x, the level's z for a stream's first residual, is left as it is), then h = LN(s) * gamma
//     + beta in f32 (mean, then the biased variance of the deviations, 1 / sqrt by rsqrtf),
//     written in the out type; either half may be left out (u null: s = x; gamma null: no h).
//     A row of C values is held in one warp's registers: lane l owns the 8-value chunks l,
//     l + 32 (kChunks, 1 or 2: rows of at most 512, MotionBERT's width), so the warp's loads
//     and stores are 1 KB contiguous runs, and the two reductions are warp shuffles. One row
//     per warp, eight per block.
//   qkv_bias_split (qkv_planes_kernel): y (M, 3C) f32 + bias (3C) -> planes q, k, v (3, M, C) in
//     the out type: the layout attention's views read. 16-byte loads and stores, each thread 4
//     chunks of 8.
//   bias_gelu_cast (bias_gelu_kernel): v = y + bias for y (M, N) f32, bias (N) -> 0.5 v (1 +
//     erf(v / sqrt 2)) in the out type (torch's GELU formula and order, erff), in place where the
//     out type is f32.
// The arithmetic is f32 throughout, in the plain versions' order; rounding to bf16 is
// round-to-nearest-even, as torch's casts. So the elementwise results equal the plain versions'
// bit for bit; LayerNorm's sums run in another order than torch's (Welford) kernel.
//
// Bound on an H100 SXM (3.35 TB/s), every operand read once and every output written once
// (bf16 out), at the cell's M = 1,111,239 tokens, C = 512:
//   residual and LayerNorm  x, u in, s f32 and h bf16 out   14 B/value  7.97 GB  2.38 ms
//   residual only           x, u in, s out                  12 B/value  6.83 GB  2.04 ms
//   LayerNorm only          x in, h out                      6 B/value  3.41 GB  1.02 ms
//   qkv_bias_split          y in (3C), q, k, v out           6 B/value 10.24 GB  3.06 ms
//   bias_gelu               y in (2C), out                   6 B/value  6.83 GB  2.04 ms
// The biases, gamma and beta (a few KB) stay in L1 and L2. All five are bound by bytes; their
// arithmetic (erff, a few dozen FLOP per value) is far below the card's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;  // chunks of 8 values per thread in the elementwise kernels
constexpr int kMaxLnCols = 512;  // a LayerNorm row: 2 chunks of 8 values a lane

// Eight consecutive f32 values, the unit every kernel here moves: two 16-byte accesses.
struct F8 {
  float v[8];
};

__device__ __forceinline__ F8 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store8(float* p, const F8& x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const F8& x) {
  uint4 packed;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x.v[2 * j], x.v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = packed;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One row of `cols` values per warp. u null: no residual (s = x); gamma null: no LayerNorm.
template <int kChunks, typename OutT>
__global__ void __launch_bounds__(kThreads)
    residual_layernorm_kernel(const float* __restrict__ x, float* u,
                              const float* __restrict__ bias, const float* __restrict__ gamma,
                              const float* __restrict__ beta, OutT* __restrict__ h,
                              long long rows, int cols, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int chunks = cols / 8;
  const long long base = row * cols;
  F8 s[kChunks];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      s[i] = load8(x + base + 8 * c);
      if (u != nullptr) {
        const F8 a = load8(u + base + 8 * c);
        const F8 b = load8(bias + 8 * c);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i].v[j] = s[i].v[j] + (a.v[j] + b.v[j]);
        store8(u + base + 8 * c, s[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += s[i].v[j];
    }
  }
  if (gamma == nullptr) return;
  const float mean = warp_sum(sum) / cols;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = s[i].v[j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / cols + eps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      const F8 g = load8(gamma + 8 * c);
      const F8 b = load8(beta + 8 * c);
      F8 o;
#pragma unroll
      for (int j = 0; j < 8; ++j) o.v[j] = (s[i].v[j] - mean) * rstd * g.v[j] + b.v[j];
      store8(h + base + 8 * c, o);
    }
  }
}

// y (rows, 3 cols) + bias (3 cols) -> out (3, rows, cols): chunk k of y is row k / (3 cols / 8).
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    qkv_planes_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                      OutT* __restrict__ out, long long rows, int cols) {
  const long long row_chunks = 3ll * cols / 8, n = rows * row_chunks;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kPerThread + threadIdx.x;
  F8 v[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long k = first + static_cast<long long>(i) * kThreads;
    if (k < n) v[i] = load8(y + 8 * k);
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long k = first + static_cast<long long>(i) * kThreads;
    if (k < n) {
      const long long row = k / row_chunks;
      const int col = static_cast<int>(k - row * row_chunks) * 8;  // in [0, 3 cols)
      const int plane = col / cols;
      const F8 b = load8(bias + col);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i].v[j] = v[i].v[j] + b.v[j];
      store8(out + (plane * rows + row) * cols + (col - plane * cols), v[i]);
    }
  }
}

// y (rows, cols) + bias (cols) -> GELU -> out (rows, cols); out may be y.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    bias_gelu_kernel(const float* y, const float* __restrict__ bias, OutT* out, long long rows,
                     int cols) {
  const int row_chunks = cols / 8;
  const long long n = rows * row_chunks;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kPerThread + threadIdx.x;
  F8 v[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long k = first + static_cast<long long>(i) * kThreads;
    if (k < n) v[i] = load8(y + 8 * k);
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long k = first + static_cast<long long>(i) * kThreads;
    if (k < n) {
      const F8 b = load8(bias + static_cast<int>(k % row_chunks) * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = v[i].v[j] + b.v[j];
        // torch's GeluCUDA: x * 0.5 * (1 + erf(x * M_SQRT1_2)), in this order
        v[i].v[j] = a * 0.5f * (1.0f + erff(a * static_cast<float>(0.70710678118654752440)));
      }
      store8(out + 8 * k, v[i]);
    }
  }
}

unsigned elementwise_grid(long long chunks) {
  return static_cast<unsigned>((chunks + kThreads * kPerThread - 1) / (kThreads * kPerThread));
}

template <typename OutT>
cudaError_t launch_residual_layernorm(const float* x, float* u, const float* bias,
                                      const float* gamma, const float* beta, void* h,
                                      long long rows, int cols, float eps, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  OutT* out = static_cast<OutT*>(h);
  if (cols <= 256)
    residual_layernorm_kernel<1, OutT><<<grid, kThreads, 0, s>>>(x, u, bias, gamma, beta, out,
                                                                 rows, cols, eps);
  else
    residual_layernorm_kernel<2, OutT><<<grid, kThreads, 0, s>>>(x, u, bias, gamma, beta, out,
                                                                 rows, cols, eps);
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

bool bad_rows(long long rows, int cols) { return rows < 1 || cols < 8 || cols % 8; }

}  // namespace

extern "C" {

// s = x + (u + bias), written over u, and/or h = LN(s) * gamma + beta (eps) in bf16 (h_bf16)
// or f32: u and bias null leave out the residual (s = x), gamma and beta null the LayerNorm.
// x, u, h (rows, cols); bias, gamma, beta (cols); cols a multiple of 8, at most 512. One
// launch on `stream`; returns the cudaError_t of the launch (0 = ok); does not synchronise.
int dst_residual_layernorm(const void* x, void* u, const void* bias, const void* gamma,
                           const void* beta, void* h, int h_bf16, long long rows, int cols,
                           float eps, int device, void* stream) {
  if (bad_rows(rows, cols) || cols > kMaxLnCols || (u == nullptr && gamma == nullptr) ||
      (u != nullptr && bias == nullptr) || (gamma != nullptr && (beta == nullptr || h == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* uf = static_cast<float*>(u);
  const float* bf = static_cast<const float*>(bias);
  const float* gf = static_cast<const float*>(gamma);
  const float* tf = static_cast<const float*>(beta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return h_bf16 ? launch_residual_layernorm<__nv_bfloat16>(xf, uf, bf, gf, tf, h, rows, cols,
                                                             eps, s)
                  : launch_residual_layernorm<float>(xf, uf, bf, gf, tf, h, rows, cols, eps, s);
  });
}

// y (rows, 3 cols) f32 + bias (3 cols) -> out (3, rows, cols) in bf16 (out_bf16) or f32; cols a
// multiple of 8. One launch on `stream`.
int dst_qkv_bias_split(const void* y, const void* bias, void* out, int out_bf16, long long rows,
                       int cols, int device, void* stream) {
  if (bad_rows(rows, cols)) return (int)cudaErrorInvalidValue;
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(bias);
  const unsigned grid = elementwise_grid(rows * 3ll * cols / 8);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (out_bf16)
      qkv_planes_kernel<<<grid, kThreads, 0, s>>>(yf, bf, static_cast<__nv_bfloat16*>(out),
                                                  rows, cols);
    else
      qkv_planes_kernel<<<grid, kThreads, 0, s>>>(yf, bf, static_cast<float*>(out), rows, cols);
    return cudaGetLastError();
  });
}

// GELU(y + bias) for y (rows, cols) f32, bias (cols) -> out (rows, cols) in bf16 (out_bf16) or
// f32 (out may be y); cols a multiple of 8. One launch on `stream`.
int dst_bias_gelu(const void* y, const void* bias, void* out, int out_bf16, long long rows,
                  int cols, int device, void* stream) {
  if (bad_rows(rows, cols)) return (int)cudaErrorInvalidValue;
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(bias);
  const unsigned grid = elementwise_grid(rows * cols / 8);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (out_bf16)
      bias_gelu_kernel<<<grid, kThreads, 0, s>>>(yf, bf, static_cast<__nv_bfloat16*>(out), rows,
                                                 cols);
    else
      bias_gelu_kernel<<<grid, kThreads, 0, s>>>(yf, bf, static_cast<float*>(out), rows, cols);
    return cudaGetLastError();
  });
}

const char* dst_glue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
