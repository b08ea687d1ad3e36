// Fused two-side lifter forward for serving (K2), hand-written for Hopper (sm_90a).
//
// Replaces links_tpu/ops/fused_infer.py:_kernel, the Pallas TPU kernel behind
// `links-lift --fused`. One launch runs BOTH 11-joint side lifters end to end:
//   upscale (2J -> H, no activation)
//   7 residual blocks in chain order res_common, res_pose1..3, res_angle1..3,
//     each cur = lrelu(lrelu(lrelu(cur@W1+b1)@W2+b2) + cur)
//   the trunk (output of res_common) feeds res_pose1 and res_angle1
//   depth head (H -> J) after res_pose3, angle head (H -> 1) after res_angle3.
// Numerics are the bf16 policy of the JAX package: every matmul input is
// rounded to bf16, products are accumulated in f32, and bias, LeakyReLU (slope
// 0.01) and the residual are f32.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the chain weights
// are 2 sides * 7 blocks * 2 * H^2 * 2 B = 58.7 MB at H = 1024, more than the
// 50 MB L2, so every call streams them from HBM: 17.5 us. The work is
// 2 * B * H^2 * 28 FLOP, 30.1 GFLOP at B = 512, i.e. 30.4 us. The kernel is
// memory-bound below B ~ 290 and compute-bound above.
//
// Design. The 14 chain layers of a side depend on each other in series, and
// blocks of a grid run in parallel and in no order, so one launch needs a
// grid-wide barrier between layers: this is a persistent cooperative kernel
// (cudaLaunchCooperativeKernel, grid = SMs * resident blocks per SM) that walks
// the work items of one layer, then cooperative_groups::this_grid().sync(),
// then the next layer. A work item is a 64x64 output tile of one side, or a
// K-slice of one: to keep every block streaming weights at small batch, the
// launcher splits K over up to `splits` blocks (a power of two, chosen so
// tiles * splits fills the grid); each split writes its f32 partial tile to a
// workspace, and the block that finishes a tile last sums the partials in
// split order and runs the epilogue. Operand tiles (bf16 activation BM x BK,
// bf16 weight BK x BN) stream through a 4-stage cp.async ring in shared memory,
// and products are nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators.
// The epilogue (bias, LeakyReLU, residual, outer LeakyReLU) writes the f32
// activation the next residual needs and its bf16 copy, the next matmul's
// input. Activations and partials live in caller-allocated scratch (a few MB,
// L2-resident) and are read with L2-only loads (cp.async.cg, __ldcg), never
// from a stale L1 line. The narrow heads are warp dot products. What the
// design does about the bound: one launch, weights streamed by every block
// with loads in flight, activations never leave L2. Not yet: TMA, wgmma,
// warp-specialized producers.
//
// Scratch:  up -> cur;  block 0: cur -> hid -> trunk;
//   blocks 1 and 4 read trunk and write cur; blocks 2, 3, 5, 6 update cur in
//   place (the second layer of a block reads cur only at its own output
//   element, as the residual, before writing it). The depth head reads cur
//   during block 4's first layer, which writes only hid.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns) of 16x32
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int kStages = 4;
constexpr int kPadAB = 8;  // bf16 elements of row padding (keeps 32 B alignment)
constexpr int kPadC = 4;   // f32 elements of row padding
constexpr int kChainBlocks = 7;
constexpr int kMaxSplits = 8;  // K split over at most this many blocks
constexpr int kMaxIn = 32;     // upscale input width 2J (22 for a side lifter)
constexpr int kVecs = BM * BN / 4 / kThreads;  // float4s of a tile per thread
constexpr float kSlope = 0.01f;

struct Params {
  const float* x;                // (2, B, IN)
  const __nv_bfloat16* w_up;     // (2, IN, H)
  const float* b_up;             // (2, H)
  const __nv_bfloat16* w_chain;  // (2, 7, 2, H, H), (in, out) layout
  const float* b_chain;          // (2, 7, 2, H)
  const __nv_bfloat16* w_down;   // (2, J, H), (out, in) layout
  const float* b_down;           // (2, J)
  const __nv_bfloat16* w_ang;    // (2, 1, H), (out, in) layout
  const float* b_ang;            // (2, 1)
  float* depth;                  // (2, B, J)
  float* angle;                  // (2, B, 1)
  float* cur;                    // (2, B, H) f32 scratch
  float* trunk;                  // (2, B, H) f32 scratch
  __nv_bfloat16* cur_bf;         // (2, B, H) bf16 copies: the matmul inputs
  __nv_bfloat16* trunk_bf;
  __nv_bfloat16* hid_bf;
  float* work;                   // (tiles * splits, BM * BN) split-K partials
  int* count;                    // (14, tiles) zeroed: finished splits per tile
  int B, in_dim, H, J, splits;
};

struct Stage {
  __nv_bfloat16 a[BM][BK + kPadAB];
  __nv_bfloat16 b[BK][BN + kPadAB];
};

union __align__(128) Smem {
  Stage st[kStages];
  float c[BM][BN + kPadC];  // the accumulator tile, once the ring is drained
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16-byte global -> shared copy through L2 only; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Upscale: cur[s, r, c] = sum_k bf16(x[s, r, k]) * w_up[s, k, c] + b_up[s, c].
// K = 2J is tiny, so plain f32 FMAs (bf16 x bf16 products are exact in f32).
// A thread keeps one (side, column) of w_up in registers and walks rows.
__device__ void upscale(const Params& p) {
  const int pairs = 2 * p.H;
  const int n_threads = gridDim.x * blockDim.x;
  const int groups = max(1, n_threads / pairs);
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < pairs * groups; u += n_threads) {
    const int s = (u % pairs) / p.H, c = u % p.H;
    float w[kMaxIn];
#pragma unroll
    for (int k = 0; k < kMaxIn; ++k)
      w[k] = k < p.in_dim ? __bfloat162float(p.w_up[((size_t)s * p.in_dim + k) * p.H + c]) : 0.f;
    const float bias = p.b_up[(size_t)s * p.H + c];
    for (int r = u / pairs; r < p.B; r += groups) {
      const float* xr = p.x + ((size_t)s * p.B + r) * p.in_dim;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxIn; ++k)
        if (k < p.in_dim) acc += bf16_round(xr[k]) * w[k];
      acc += bias;
      const size_t i = ((size_t)s * p.B + r) * p.H + c;
      p.cur[i] = acc;
      p.cur_bf[i] = __float2bfloat16_rn(acc);
    }
  }
}

// Stage K-step kt of a tile: A rows row0.. (bf16, B x H, one side), W rows kt*BK..
__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* A,
                                           const __nv_bfloat16* W, int B, int H, int row0,
                                           int col0, int kt) {
#pragma unroll
  for (int i = threadIdx.x; i < BM * BK / 8; i += kThreads) {  // A: 16 B chunks
    const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
    const bool valid = row0 + r < B;
    const __nv_bfloat16* src = A + (size_t)(valid ? row0 + r : 0) * H + kt * BK + c8;
    cp_async16(&st.a[r][c8], src, valid);
  }
#pragma unroll
  for (int i = threadIdx.x; i < BK * BN / 8; i += kThreads) {  // W: 16 B chunks
    const int r = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
    cp_async16(&st.b[r][c8], W + (size_t)(kt * BK + r) * H + col0 + c8, true);
  }
}

// K-steps [kt0, kt1) of one 64x64 output tile of A @ W into sm.c.
__device__ void gemm_tile(const __nv_bfloat16* A, const __nv_bfloat16* W, int B, int H,
                          int row0, int col0, int kt0, int kt1, Smem& sm) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int n = kt1 - kt0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load_stage(sm.st[s], A, W, B, H, row0, col0, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step i has landed; every warp is done with step i - 1
    const int next = i + kStages - 1;
    if (next < n) load_stage(sm.st[next % kStages], A, W, B, H, row0, col0, kt0 + next);
    cp_async_commit();
    const Stage& st = sm.st[i % kStages];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &st.a[wm * 16][kk], BK + kPadAB);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &st.b[kk][wn * 32 + t * 16], BN + kPadAB);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: sm.c may reuse it
#pragma unroll
  for (int t = 0; t < 2; ++t)
    wmma::store_matrix_sync(&sm.c[wm * 16][wn * 32 + t * 16], acc[t], BN + kPadC,
                            wmma::mem_row_major);
  __syncthreads();
}

// Layer l (0 or 1) of chain block blk for both sides.
//   l == 0: hid = lrelu(in @ W1 + b1)                       (bf16 out)
//   l == 1: out = lrelu(lrelu(hid @ W2 + b2) + resid)       (f32 + bf16 out)
__device__ void chain_layer(const Params& p, int blk, int l, const __nv_bfloat16* in,
                            const float* resid, float* out, __nv_bfloat16* out_bf, Smem& sm) {
  __shared__ int last;
  const int mt = (p.B + BM - 1) / BM;
  const int nt = p.H / BN;
  const int tiles = 2 * nt * mt;
  const int kt_per = p.H / BK / p.splits;
  const size_t side_stride = (size_t)p.B * p.H;
  int* count = p.count + (blk * 2 + l) * tiles;
  for (int w = blockIdx.x; w < tiles * p.splits; w += gridDim.x) {
    // row tiles fastest: neighbouring blocks share a weight tile through L2
    const int tm = w % mt;
    int rest = w / mt;
    const int split = rest % p.splits;
    rest /= p.splits;
    const int tn = rest % nt;
    const int s = rest / nt;
    const int tile = (s * nt + tn) * mt + tm;
    const size_t layer = ((size_t)s * kChainBlocks + blk) * 2 + l;
    const __nv_bfloat16* W = p.w_chain + layer * p.H * p.H;
    const float* bias = p.b_chain + layer * p.H;
    const int row0 = tm * BM, col0 = tn * BN;
    gemm_tile(in + s * side_stride, W, p.B, p.H, row0, col0, split * kt_per,
              (split + 1) * kt_per, sm);
    // thread -> float4 j of the tile: row r, columns c..c+3 (rows past B idle)
    const int rows = min(BM, p.B - row0);

    if (p.splits > 1) {
      float4* part = reinterpret_cast<float4*>(p.work) + (size_t)tile * p.splits * (BM * BN / 4);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int i = threadIdx.x + j * kThreads, r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        if (r < rows)
          __stcg(part + (size_t)split * (BM * BN / 4) + i,
                 *reinterpret_cast<const float4*>(&sm.c[r][c]));
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) last = atomicAdd(count + tile, 1) == p.splits - 1;
      __syncthreads();
      if (!last) continue;  // another block finishes this tile
      __threadfence();
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int i = threadIdx.x + j * kThreads, r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        if (r >= rows) continue;
        float4 v[kMaxSplits];
#pragma unroll
        for (int k = 0; k < kMaxSplits; ++k)  // all loads first, then the sum in split order
          if (k < p.splits) v[k] = __ldcg(part + (size_t)k * (BM * BN / 4) + i);
#pragma unroll
        for (int k = 1; k < kMaxSplits; ++k)
          if (k < p.splits) {
            v[0].x += v[k].x;
            v[0].y += v[k].y;
            v[0].z += v[k].z;
            v[0].w += v[k].w;
          }
        *reinterpret_cast<float4*>(&sm.c[r][c]) = v[0];
      }
      __syncthreads();
    }

    // epilogue; the residual loads are issued before any store (out may be resid)
    float4 res[kVecs];
    if (l == 1) {
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int i = threadIdx.x + j * kThreads, r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        if (r < rows)
          res[j] = __ldcg(reinterpret_cast<const float4*>(
              resid + s * side_stride + (size_t)(row0 + r) * p.H + col0 + c));
      }
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      if (r >= rows) continue;
      const size_t g = s * side_stride + (size_t)(row0 + r) * p.H + col0 + c;
      const float4 a = *reinterpret_cast<const float4*>(&sm.c[r][c]);
      const float4 b = *reinterpret_cast<const float4*>(bias + col0 + c);
      float4 v = make_float4(lrelu(a.x + b.x), lrelu(a.y + b.y), lrelu(a.z + b.z),
                             lrelu(a.w + b.w));
      if (l == 1) {
        v = make_float4(lrelu(v.x + res[j].x), lrelu(v.y + res[j].y), lrelu(v.z + res[j].z),
                        lrelu(v.w + res[j].w));
        *reinterpret_cast<float4*>(out + g) = v;
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(out_bf + g) = make_uint2(
          *reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
    }
    __syncthreads();
  }
}

// Narrow head: out[s, r, j] = sum_k bf16(src[s, r, k]) * w[s, j, k] + b[s, j],
// one warp per output element.
__device__ void head(const Params& p, const float* src, const __nv_bfloat16* w,
                     const float* b, float* out, int n_out) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  const int items = 2 * p.B * n_out;
  for (int it = warp; it < items; it += n_warps) {
    const int j = it % n_out;
    const int sr = it / n_out;  // side * B + row
    const int s = sr / p.B;
    const float* xr = src + (size_t)sr * p.H;
    const __nv_bfloat16* wr = w + ((size_t)s * n_out + j) * p.H;
    float acc = 0.f;
    for (int k = lane; k < p.H; k += 32)
      acc += bf16_round(__ldcg(xr + k)) * __bfloat162float(wr[k]);
#pragma unroll
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[(size_t)sr * n_out + j] = acc + b[s * n_out + j];
  }
}

__global__ void __launch_bounds__(kThreads, 2) fused_sides_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];  // sizeof(Smem) bytes
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::grid_group grid = cg::this_grid();

  upscale(p);
  grid.sync();
  for (int blk = 0; blk < kChainBlocks; ++blk) {
    const bool from_trunk = blk == 1 || blk == 4;
    const float* in = from_trunk ? p.trunk : p.cur;
    chain_layer(p, blk, 0, from_trunk ? p.trunk_bf : p.cur_bf, nullptr, nullptr, p.hid_bf, sm);
    if (blk == 4) head(p, p.cur, p.w_down, p.b_down, p.depth, p.J);  // pose chain done
    grid.sync();
    chain_layer(p, blk, 1, p.hid_bf, in, blk == 0 ? p.trunk : p.cur,
                blk == 0 ? p.trunk_bf : p.cur_bf, sm);
    grid.sync();
  }
  head(p, p.cur, p.w_ang, p.b_ang, p.angle, 1);  // angle chain done
}

// The cooperative grid on `device`: every block resident at once. Also sets
// the kernel's shared-memory attribute that the launch needs. Leaves the
// calling thread's current device as it found it.
int grid_blocks(int device, int* grid) {
  int per_sm = 0, sms = 0, coop = 0, prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_sides_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_sides_kernel, kThreads,
                                                        sizeof(Smem));
  cudaSetDevice(prev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = per_sm * sms;
  return 0;
}

}  // namespace

extern "C" {

// The cooperative grid, the K split, and the scratch the caller allocates for
// batch B at width H: `work_floats` f32 partials and `count_ints` zeroed ints.
// Call it on a device before the first launch there; the plan may be reused.
int fused_sides_plan(int device, int B, int H, int* grid, int* splits, long long* work_floats,
                     long long* count_ints) {
  const int e = grid_blocks(device, grid);
  if (e) return e;
  const int tiles = 2 * ((B + BM - 1) / BM) * (H / BN);
  const int k_steps = H / BK;
  int s = 1;
  while (s * 2 <= kMaxSplits && s * 2 <= k_steps && tiles * s * 2 <= *grid) s *= 2;
  *splits = s;
  *work_floats = s > 1 ? (long long)tiles * s * BM * BN : 1;
  *count_ints = (long long)2 * kChainBlocks * tiles;
  return 0;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch (0 = ok).
// Does not synchronise. `grid` and `splits` come from fused_sides_plan.
int fused_sides_forward_launch(const void* x, const void* w_up, const void* b_up,
                               const void* w_chain, const void* b_chain, const void* w_down,
                               const void* b_down, const void* w_ang, const void* b_ang,
                               void* depth, void* angle, void* cur, void* trunk, void* cur_bf,
                               void* trunk_bf, void* hid_bf, void* work, void* count, int B,
                               int in_dim, int H, int J, int grid, int splits, int device,
                               void* stream) {
  if (grid < 1 || splits < 1 || splits > kMaxSplits || (H / BK) % splits || in_dim > kMaxIn)
    return (int)cudaErrorInvalidValue;

  Params p;
  p.x = static_cast<const float*>(x);
  p.w_up = static_cast<const __nv_bfloat16*>(w_up);
  p.b_up = static_cast<const float*>(b_up);
  p.w_chain = static_cast<const __nv_bfloat16*>(w_chain);
  p.b_chain = static_cast<const float*>(b_chain);
  p.w_down = static_cast<const __nv_bfloat16*>(w_down);
  p.b_down = static_cast<const float*>(b_down);
  p.w_ang = static_cast<const __nv_bfloat16*>(w_ang);
  p.b_ang = static_cast<const float*>(b_ang);
  p.depth = static_cast<float*>(depth);
  p.angle = static_cast<float*>(angle);
  p.cur = static_cast<float*>(cur);
  p.trunk = static_cast<float*>(trunk);
  p.cur_bf = static_cast<__nv_bfloat16*>(cur_bf);
  p.trunk_bf = static_cast<__nv_bfloat16*>(trunk_bf);
  p.hid_bf = static_cast<__nv_bfloat16*>(hid_bf);
  p.work = static_cast<float*>(work);
  p.count = static_cast<int*>(count);
  p.B = B;
  p.in_dim = in_dim;
  p.H = H;
  p.J = J;
  p.splits = splits;

  void* args[] = {&p};
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_sides_kernel),
                                    dim3(grid), dim3(kThreads), args, sizeof(Smem),
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  cudaSetDevice(prev);
  return (int)err;
}

const char* fused_sides_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
