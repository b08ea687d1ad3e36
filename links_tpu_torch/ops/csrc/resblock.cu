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
//   f32: the forward's products in three TF32 passes (~22 significant bits per product, never
//     one pass); the backward's at f32 precision through bf16 terms (never TF32).
// Tensor cores multiply bf16 or tf32. Under bf16 every operand is a sum of bf16 terms: one term
// for an operand the policy rounds to bf16, two (hi = bf16(v), lo = bf16(v - hi): 16
// significant bits) for an f32 gradient. The f32 backward splits each operand into three bf16
// terms, t0 = bf16(v), t1 = bf16(v - t0), t2 = bf16(v - t0 - t1) (24 significant bits, f32's
// own: t0 + t1 + t2 == v for |v| >= 2^-110), and sums the six term products i + j < 3 (the
// dropped ones are ~2^-24 of the product). The f32 forward
// splits each operand v into big + small, big = v with its low 13 mantissa bits cleared (a tf32
// value: 11 significant bits) and small = v - big (exact), and sums big.big + small.big +
// big.small on tf32 wgmma (small.small, ~2^-22 of the product, is dropped; small enters the
// tensor core truncated to 11 bits, ~2^-22 again).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16) at the training step's shape
// B = 512, H = 1024, counting the block's own inputs and outputs once (f32 masters):
//   forward: 2 products, 2.15 GFLOP -> 2.2 us; W1, W2, b1, b2, x in and y out, 12.6 MB -> 3.8 us.
//   backward: from (x, W, b, dy) to (dx, dW, db) a block needs 6 products (a1 and a2 recomputed),
//     6.4 GFLOP -> 6.5 us; 23.1 MB -> 6.9 us.
//   f32 forward at its own method (three TF32 passes, 494.7 TFLOP/s dense): 13.0 us; at B =
//     4096, 104 us. f32 backward at its own (six bf16 term products per product, 4 products,
//     164.9 TFLOP/s): 26.0 us; at B = 4096, 208 us.
// Both are bound by bytes at B = 512 and by operations at B = 4096. chip_smoke.py recomputes
// these for the shapes it times.
//
// bf16 policy (the trainer's default): TMA + wgmma. Every operand is a bf16 array in device
// memory (a "plane") that TMA copies as it is:
//   - W1, W2: one plane each, cast once per weight version by the wrapper (ops/resblock.py);
//   - x: one plane, written by split_kernel and saved by the forward for dW1;
//   - h: one plane, written by the first forward product's epilogue (the f32 h is not kept);
//   - g2 = dy * lrelu'(a2): hi and lo planes, written by split_kernel;
//   - g1: hi and lo planes, written by the dh product's epilogue.
// Every product is then one GEMM mainloop, C (M x N) = sum over A's terms t of A_t B^T, over a
// list of term pairs (t, 0): (0, 0) in the forward, (0, 0) and (1, 0) in the backward, so a
// two-term product is a GEMM whose K is twice as long. One producer warp issues
// cp.async.bulk.tensor (TMA, 128-byte swizzle, 64-deep K tiles) into a ring of shared memory with
// a full and an empty mbarrier per stage; consumer warpgroups issue wgmma.mma_async m64nNk16
// (bf16 x bf16 -> f32) on the arrived tiles, keeping one group in flight. Operands contiguous
// along M or N (W in dh and dx, g and x / h in dW) are read through wgmma's transpose bits from
// the tiles TMA copied unchanged; rows outside a plane (a ragged batch) arrive as zeros. The
// epilogue (bias, lrelu, residual, bf16 rounding of the backward's products, plane writes, the
// row mask) goes through shared memory, so that it writes whole rows. The plan comes from the
// host (ops/resblock.py:bf16_plan), per product shape:
//   - where the product's work fills the card, the persistent kernel (wgmma_gemm_persistent):
//     one block per SM walks 64 x 256 output tiles, two consumer warpgroups taking them in
//     turn, so that one tile's epilogue runs under the next tile's loads and products (at B =
//     49,152 the forward's second product's epilogue moves ~0.7 GB, more time than its
//     products take at peak). At H = 1024 dW's output is 64 such tiles: its K (the batch) is
//     split into 2 slices, each a unit of work, and the tile's last slice adds the slices' f32
//     sums in slice order, so that the bf16 rounding follows the whole sum and runs agree
//     bitwise;
//   - else one 64 x 64 tile per block with one consumer warpgroup (wgmma_gemm), which parks its
//     accumulators in the drained ring (at H = 1024: B <= 1,792, and dW to B = 1,984; widths
//     that are no multiple of 256).
// db1 and db2 are sums of per-16-row column sums, made where g1 and g2 are made (the dh
// epilogue, split_kernel), in a fixed order. Tensor maps are encoded on the host and kept by
// address and shape. Launches: forward 3 (split x; a1 and the h plane; a2 and y); backward 6
// (split g2; dh -> g1; dW2; dx; dW1; db1 and db2).
//
// f32 forward: the same ring on f32 masters and tf32 wgmma (tf32_gemm). wgmma takes tf32
// operands only K-major, and both forward products are: x and h by rows, W in torch's (out,
// in) layout. The tensor core reads a tf32 operand's top 19 bits, so TMA copies the f32 x, h,
// W1 and W2 as they lie and the tensor core sees their big terms (chip_smoke.py checks that
// bitwise). The small terms are f32 planes beside them: W's cached per weight version by the
// wrapper (small_kernel), x's written by small_kernel at each call, h's by the first product's
// epilogue beside the f32 a1 and h that the backward reads; at one row tile (B <= 64 at H =
// 1024) A's small tiles are instead made in shared memory from its master as each stage
// arrives, and neither x's nor h's plane is written. A stage holds 1 to 8 K tiles (32 f32, 128
// bytes, deep) of A's and B's master and small planes, one 3D TMA box per operand. Per k8
// slice a consumer warpgroup issues big.big, small.big and big.small; each K tile's products go
// to an accumulator of their own, added (round to nearest) into a register sum while the next
// tile's run: the tensor core's own adds truncate, with an error that grows with what they add
// to (one accumulator over all of K came within 1.6x of chip_smoke.py's f32 bound; per-tile
// sums within 1/5 of it). The tile plan comes from the host (ops/resblock.py:f32_plan): 128 x
// 128 with two row warpgroups (whose registers come from the producer's warpgroup through
// setmaxnreg), or 64 rows by 64, 32, 16 or 8 columns, the largest whose grid leaves at most 1/8
// of the SMs idle (at B <= 64 one row tile by 8 columns: at H = 1024, 128 blocks stream W in
// parallel). A narrow tile's K is split over 2 or 4 warpgroups, whose sums are added in order:
// a warpgroup's wgmmas run in order and a narrow one's are short, so at B <= 256 one warpgroup's
// chain of issues, not the bytes, set the time. The ring is as deep as shared memory allows, at
// two blocks per SM where the grid is larger than the card. At one row tile A's TMA box has
// only the rows below B, rounded to 8: the m64 wgmma reads the rest of its rows from what
// follows in shared memory, which reaches only output rows the epilogue drops. Launches:
// forward 3 (x's small plane; a1, h and h's small plane; a2 and y), 2 at one row tile.
//
// f32 backward (terms3_gemm): the bf16 policy's TMA ring and warp specialisation on three term
// planes per operand. Planes, each written once and copied by TMA: W1's and W2's (3 x H x H),
// cached per weight version by the wrapper (split_kernel); g2 = dy * lrelu'(a2)'s, x's and h's,
// written by one split_kernel launch at the call's start (g2's per-16-row column sums beside them);
// g1's, written by the dh product's epilogue with its column sums (g1 is not rounded: that
// rounding is the bf16 policy's). A stage holds a K tile of A's three planes and B's three; a
// consumer warpgroup issues the six term products, smallest first, each over the tile's k16
// slices; operands contiguous along M or N (W in dh and dx, g and x / h in dW) go through wgmma's
// transpose bits. Each K tile's products go to an accumulator of their own, added round to nearest
// into a register sum while the next tile's run, as the f32 forward's. The tile plan comes from
// the host (ops/resblock.py:f32_bwd_plan), per product: 128 x 128 with two row warpgroups and
// 32-deep K tiles (a K-contiguous A in the 64-byte swizzle), so that its ring holds 4 stages of 48
// KB (2 stages of 64-deep tiles ran it 1.4x slower at B = 4096), its 192 registers of accumulators
// and sum given by the producer warpgroup (setmaxnreg); or 64 x 64 with one warpgroup and 64-deep
// K tiles, 4 stages of 48 KB (2 at two blocks per SM, where the grid is larger than the card).
// Where the output tiles are too few to fill the card (at H = 1024: dh and dx to B = 448 and from
// 641 to 1,024, dW from B = 97), the K tiles are split over the 2 blocks of a cluster, and each
// tile's 16-row slabs are finished by the cluster's blocks in turn, adding the blocks' parked sums
// in rank order through distributed shared memory: no float atomics, no scratch, no extra launch
// (the kernel takes clusters of up to 8, which ran slower: the card holds fewer of them at once).
// Launches: backward 6 (split g2, x and h; dh -> g1; dW2; dx; dW1; db1 and db2).
//
// Under both policies every output tile belongs to one block, or to one cluster of blocks that
// add their shares of the reduction (K = H, or K = B for dW) in a fixed order, so there are no
// float atomics and repeated runs agree bitwise. The forward saves a1, h and a2 (h, and x, as
// bf16 planes under bf16) for the backward instead of recomputing them as the TPU kernel does:
// the recompute would add two products to the backward's four.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kSlope = 0.01f;

enum Epi { kFwd1, kFwd2, kDh, kDx, kDw, kProduct };

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }
__device__ __forceinline__ float dlrelu(float v) { return v >= 0.f ? 1.f : kSlope; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// db1 and db2 (H): the sums over `rows` rows of p1 and p2 (rows x H), the per-16-row partial
// column sums of g1 and g2. A block owns kSumCols columns of one of them; each of its kSumGroups
// thread groups sums every kSumGroups-th row into kSumUnroll independent partial sums (loads in
// flight), and the partials are combined in a fixed order: no atomics, so repeated runs agree
// bitwise.
constexpr int kSumThreads = 512;
constexpr int kSumCols = 16;  // a half warp reads 64 contiguous bytes of a row
constexpr int kSumGroups = kSumThreads / kSumCols;
constexpr int kSumUnroll = 8;

__global__ void __launch_bounds__(kSumThreads)
    bias_grads_kernel(const float* p1, const float* p2, float* db1, float* db2, int rows, int H) {
  __shared__ float part[kSumGroups][kSumCols + 1];
  const int lane = threadIdx.x % kSumCols, grp = threadIdx.x / kSumCols;
  const int c = blockIdx.x * kSumCols + lane;  // in [0, 2H)
  const bool second = c >= H;
  const int col = second ? c - H : c;
  const float* p = second ? p2 : p1;
  float acc[kSumUnroll];
#pragma unroll
  for (int u = 0; u < kSumUnroll; ++u) acc[u] = 0.f;
  int r = grp;
  for (; r + (kSumUnroll - 1) * kSumGroups < rows; r += kSumUnroll * kSumGroups) {
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u)
      acc[u] += __ldg(p + static_cast<long long>(r + u * kSumGroups) * H + col);
  }
  for (; r < rows; r += kSumGroups) acc[0] += __ldg(p + static_cast<long long>(r) * H + col);
  float s = acc[0];
#pragma unroll
  for (int u = 1; u < kSumUnroll; ++u) s += acc[u];
  part[grp][lane] = s;
  __syncthreads();
  if (grp == 0) {
    s = part[0][lane];
    for (int k = 1; k < kSumGroups; ++k) s += part[k][lane];
    (second ? db2 : db1)[col] = s;
  }
}

cudaError_t bias_grads(const void* p1, const void* p2, void* db1, void* db2, int rows, int H,
                       cudaStream_t stream) {
  bias_grads_kernel<<<2 * H / kSumCols, kSumThreads, 0, stream>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2), static_cast<float*>(db1),
      static_cast<float*>(db2), rows, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------
// The bf16 policy: bf16 planes, a TMA ring and wgmma.

constexpr int kTK = 64;                // K tile: 64 bf16 = one 128-byte swizzled row
constexpr int kRingBytes = 96 * 1024;  // a ring two blocks of an SM can hold side by side
constexpr int kMaxSmem = 232448;       // the dynamic shared memory a block can have
constexpr int kAtomBytes = 64 * 128;   // 64 rows of 128 bytes: one TMA box of 64 x 64
constexpr int kSplitThreads = 64;  // 256 columns: 128 blocks at B = 512, H = 1024

// The ring's depth for stages of `stage_bytes`: within kRingBytes (two blocks per SM, so one
// block's epilogue overlaps the other's mainloop) where that leaves at least 3 stages, else 4
// stages and one block per SM. On an H100 at B = 4096, 3 stages ran the forward's 128 x 128
// products faster than 4, and 2 ran the two-term ones slower than 4.
__host__ __device__ constexpr int ring_stages(int stage_bytes) {
  return kRingBytes / stage_bytes == 3 ? 3 : 4;
}

// Stores four values as bf16 (8 bytes).
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

constexpr int kSumRows = 16;  // rows of one partial column sum (the split's and the dh tiles')

// The split of f32 values into bf16 terms: t0 = bf16(v), t1 = bf16(v - t0), t2 = bf16(v - t0 -
// t1). Each remainder is exact (a value less its rounding to 8 significant bits), and so is t2
// wherever v's last bit is not below bf16's least subnormal (|v| >= 2^-110 for any v, or v a
// multiple of 2^-133): then t0 + t1 + t2 == v. Values above bf16's largest (3.39e38) overflow t0.
// hi = t0 and lo = t1 hold v to 16 significant bits, t0 alone to 8.
__device__ __forceinline__ void split_terms(const float (&v)[4], float (&t)[3][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float r = v[c];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      t[i][c] = round_bf16(r);
      r -= t[i][c];
    }
  }
}

// One operand's split: v (rows x cols f32), times lrelu'(mask) if mask is set, into the term
// planes t that are set (t0; t0 and t1; or all three); with colsum, the column sums of each 16
// rows of the masked v (ceil(rows / 16) x cols).
struct SplitSrc {
  const float* v;
  const float* mask;
  __nv_bfloat16* t[3];
  float* colsum;
};
// Up to three operands of one shape, one per blockIdx.z; with zero set, the first block also
// zeroes n_zero ints there (the slice counters of the call's persistent products that split K).
struct Split {
  SplitSrc src[3];
  int rows, cols;
  int* zero;
  int n_zero;
};

// A thread owns 4 columns of 16 rows (blockIdx.y) of operand blockIdx.z.
__global__ void __launch_bounds__(kSplitThreads) split_kernel(__grid_constant__ const Split p) {
  if (p.zero && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = threadIdx.x; i < p.n_zero; i += kSplitThreads) p.zero[i] = 0;
  const SplitSrc& q = p.src[blockIdx.z];
  const int c = 4 * (blockIdx.x * kSplitThreads + threadIdx.x);
  if (c >= p.cols) return;
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  constexpr int kBatch = 8;  // rows whose loads are in flight together
  for (int r0 = blockIdx.y * kSumRows; r0 < (blockIdx.y + 1) * kSumRows; r0 += kBatch) {
    float4 a[kBatch], m[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const long long o = static_cast<long long>(r0 + i) * p.cols + c;
      a[i] = r0 + i < p.rows ? ldg4(q.v + o) : make_float4(0.f, 0.f, 0.f, 0.f);
      m[i] = q.mask && r0 + i < p.rows ? ldg4(q.mask + o) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (r0 + i >= p.rows) break;
      const long long o = static_cast<long long>(r0 + i) * p.cols + c;
      float e[4] = {a[i].x, a[i].y, a[i].z, a[i].w}, t[3][4];
      if (q.mask) {
        e[0] *= dlrelu(m[i].x);
        e[1] *= dlrelu(m[i].y);
        e[2] *= dlrelu(m[i].z);
        e[3] *= dlrelu(m[i].w);
      }
      split_terms(e, t);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (q.t[k]) store_bf16x4(q.t[k] + o, t[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[k] += e[k];
    }
  }
  if (q.colsum) st4(q.colsum + static_cast<long long>(blockIdx.y) * p.cols + c, sum);
}

cudaError_t split(const Split& p, int operands, cudaStream_t stream) {
  const dim3 grid((p.cols / 4 + kSplitThreads - 1) / kSplitThreads,
                  (p.rows + kSumRows - 1) / kSumRows, operands);
  split_kernel<<<grid, kSplitThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The split of one operand v (rows x cols) into the planes t0, t1, t2 that are not null.
Split one_split(const void* v, const void* mask, void* t0, void* t1, void* t2, void* colsum,
                int rows, int cols) {
  Split p = {};
  p.src[0] = {static_cast<const float*>(v), static_cast<const float*>(mask),
              {static_cast<__nv_bfloat16*>(t0), static_cast<__nv_bfloat16*>(t1),
               static_cast<__nv_bfloat16*>(t2)},
              static_cast<float*>(colsum)};
  p.rows = rows;
  p.cols = cols;
  return p;
}

// The tensor maps of one product: A's term planes and B's plane.
struct Maps {
  CUtensorMap a[2];
  CUtensorMap b;
};

// The epilogue's operands; outputs and `aux` are row-major (M, N).
struct Epi16 {
  float* out0;              // a1, a2, g1, dx or dW
  float* out1;              // y
  __nv_bfloat16* plane0;    // the h plane, or g1's hi plane
  __nv_bfloat16* plane1;    // g1's lo plane
  const float* bias;        // (N)
  const float* aux;         // x (y's residual), a1 (g1's mask) or dy (dx's residual)
  float* colsum;            // g1's column sums of each 16 rows (ceil(M / 16) x N)
  int M, N, K;
};

// Whether a product's epilogue reads `aux` (x, a1 or dy).
__host__ __device__ constexpr bool reads_aux(int epi) {
  return epi == kFwd2 || epi == kDh || epi == kDx;
}

// The epilogue of the four accumulators at row m, columns n .. n + 3, given the four values of
// the bias at n (the forward) and of `aux` at (m, n) (reads_aux).
template <int EPI>
__device__ __forceinline__ float4 epilogue4(const Epi16& e, int m, int n, const float4 acc,
                                            const float4 b, const float4 aux) {
  if (m >= e.M) return make_float4(0.f, 0.f, 0.f, 0.f);
  const long long o = static_cast<long long>(m) * e.N + n;
  float v[4] = {acc.x, acc.y, acc.z, acc.w}, r[4];
  if constexpr (EPI == kFwd1 || EPI == kFwd2) {
    v[0] += b.x;
    v[1] += b.y;
    v[2] += b.z;
    v[3] += b.w;
    st4(e.out0 + o, v);  // a1 or a2
    if constexpr (EPI == kFwd1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) r[c] = lrelu(v[c]);
      store_bf16x4(e.plane0 + o, r);  // the h plane
    } else {  // aux: x
      r[0] = lrelu(v[0]) + aux.x;
      r[1] = lrelu(v[1]) + aux.y;
      r[2] = lrelu(v[2]) + aux.z;
      r[3] = lrelu(v[3]) + aux.w;
      st4(e.out1 + o, r);  // y
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = round_bf16(v[c]);  // the backward's products are rounded
    if constexpr (EPI == kDh) {  // g1 = dh * lrelu'(a1): hi and lo planes, and its sums
      v[0] *= dlrelu(aux.x);
      v[1] *= dlrelu(aux.y);
      v[2] *= dlrelu(aux.z);
      v[3] *= dlrelu(aux.w);
      store_bf16x4(e.plane0 + o, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) r[c] = v[c] - round_bf16(v[c]);
      store_bf16x4(e.plane1 + o, r);
      return make_float4(v[0], v[1], v[2], v[3]);  // summed into db1
    } else if constexpr (EPI == kDx) {  // dx = dy + g1 W1
      r[0] = aux.x + v[0];
      r[1] = aux.y + v[1];
      r[2] = aux.z + v[2];
      r[3] = aux.w + v[3];
      st4(e.out0 + o, r);
    } else {  // dW
      st4(e.out0 + o, v);
    }
  }
  return acc;
}

// The same, reading the bias and `aux` itself.
template <int EPI>
__device__ __forceinline__ float4 epilogue4(const Epi16& e, int m, int n, const float4 acc) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m >= e.M) return zero;
  const float4 b = EPI == kFwd1 || EPI == kFwd2 ? *reinterpret_cast<const float4*>(e.bias + n)
                                                 : zero;
  return epilogue4<EPI>(e, m, n, acc, b,
                        reads_aux(EPI) ? ldg4(e.aux + static_cast<long long>(m) * e.N + n) : zero);
}

// C (M x N) = sum over A's NA term planes t of A_t B^T, K deep. A's tile is WG x 64 rows; each
// consumer warpgroup owns 64 of them and all BN columns. A_MN / B_MN: the operand's plane is
// contiguous along M / N (a tile is then WG or BN / 64 boxes of 64 k-rows x 64), else along K
// (one box of 64 k x rows).
template <int WG, int TBN, int NA, bool A_MN, bool B_MN, int EPI>
__global__ void __launch_bounds__(128 * WG + 32)
    wgmma_gemm(__grid_constant__ const Maps maps, const Epi16 e) {
  constexpr int kABytes = WG * kAtomBytes;  // one term of A's tile
  constexpr int kBBytes = TBN * 128;
  constexpr int kStageBytes = NA * kABytes + kBBytes;
  constexpr int kStages = ring_stages(kStageBytes);
  constexpr int kAcc = TBN / 2;  // accumulators per thread of m64 x TBN
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle's alignment
  const uint32_t full0 = base + kStages * kStageBytes;           // kStages full barriers,
  const uint32_t empty0 = full0 + kStages * 8;                   // then kStages empty ones
  const int m0 = blockIdx.y * 64 * WG, n0 = blockIdx.x * TBN;
  const int nk = (e.K + kTK - 1) / kTK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);            // the producer's arrival, plus the bytes
      mbar_init(empty0 + 8 * s, 4 * WG);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {  // the producer warp: one thread keeps the ring full
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
        const uint32_t st = base + s * kStageBytes, bar = full0 + 8 * s;
        const int k0 = it * kTK;
        mbar_arrive_expect_tx(bar, kStageBytes);
#pragma unroll
        for (int t = 0; t < NA; ++t) {
          if (A_MN) {
#pragma unroll
            for (int w = 0; w < WG; ++w)
              tma_load(st + t * kABytes + w * kAtomBytes, &maps.a[t], bar, m0 + 64 * w, k0);
          } else {
            tma_load(st + t * kABytes, &maps.a[t], bar, k0, m0);
          }
        }
        const uint32_t sb = st + NA * kABytes;
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < TBN / 64; ++j)
            tma_load(sb + j * kAtomBytes, &maps.b, bar, n0 + 64 * j, k0);
        } else {
          tma_load(sb, &maps.b, bar, k0, n0);
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  const int wg = warp / 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  // Descriptors (128-byte swizzle): along K a k16 slice is 32 bytes into each 128-byte row of a
  // K-contiguous tile, or 16 rows (2048 bytes) down an M- or N-contiguous one; 8-row groups lie
  // 1024 bytes apart; the 64-wide boxes of an N-contiguous B tile lie kAtomBytes apart.
  constexpr uint32_t kStepA = A_MN ? 2048 : 32, kStepB = B_MN ? 2048 : 32;
  constexpr uint32_t kLboA = A_MN ? 1024 : 16;
  constexpr uint32_t kLboB = B_MN ? (TBN > 64 ? kAtomBytes : 1024) : 16;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t st = base + s * kStageBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NA; ++t) {
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint32_t a = st + t * kABytes + wg * kAtomBytes + kk * kStepA;
        const uint32_t b = st + NA * kABytes + kk * kStepB;
        wgmma<TBN, A_MN, B_MN>(acc, smem_desc(a, kLboA, 1024), smem_desc(b, kLboB, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: release its stage
    fence_regs(acc);
    if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // The epilogue, through shared memory: once every consumer warp is done with the ring, each
  // warp parks its 16 x TBN accumulators there (accumulator j of a thread lies at row
  // lane / 4 (+ 8 for j % 4 >= 2), column 8 (j / 4) + 2 (lane % 4) + j % 2 of its warp's rows)
  // and reads them back as whole rows of float4s, so that every store to device memory is 16
  // (f32) or 8 (bf16) bytes and a warp writes full 128-byte lines.
  constexpr int kLd = TBN + 8;  // floats per staged row: conflict-free 8-byte writes
  static_assert(4 * WG * 16 * kLd * 4 <= kStages * kStageBytes, "the staging tile fits the ring");
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG) : "memory");
  float* tile = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw))) +
                warp * 16 * kLd;
#pragma unroll
  for (int j = 0; j < TBN / 8; ++j) {
    float* p = tile + (lane / 4) * kLd + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(p + 8 * kLd) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncwarp();
  constexpr int kRowsPerStep = 128 / TBN;  // a warp's 32 float4s cover this many rows
  const int row0 = m0 + 64 * wg + 16 * (warp % 4);
  const int c = 4 * (lane % (TBN / 4));
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < 16; r += kRowsPerStep) {
    const int rr = r + lane / (TBN / 4);
    const float4 g =
        epilogue4<EPI>(e, row0 + rr, n0 + c, *reinterpret_cast<const float4*>(tile + rr * kLd + c));
    sum.x += g.x;
    sum.y += g.y;
    sum.z += g.z;
    sum.w += g.w;
  }
  if constexpr (EPI == kDh) {  // the column sums of the warp's 16 rows of g1, for db1
    if constexpr (kRowsPerStep == 2) {  // the two half warps summed alternate rows
      sum.x += __shfl_xor_sync(0xffffffffu, sum.x, 16);
      sum.y += __shfl_xor_sync(0xffffffffu, sum.y, 16);
      sum.z += __shfl_xor_sync(0xffffffffu, sum.z, 16);
      sum.w += __shfl_xor_sync(0xffffffffu, sum.w, 16);
    }
    if (row0 < e.M && lane < TBN / 4)
      *reinterpret_cast<float4*>(e.colsum + static_cast<long long>(row0 / kSumRows) * e.N + n0 +
                                 c) = sum;
  }
}

int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (!counts[device]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    counts[device] = n > 0 ? n : 132;
  }
  return counts[device];
}

// A product's planes: A's NA term planes and B's plane, each row-major (rows x cols). A K-
// contiguous operand's plane is (M or N) x K, an M- or N-contiguous one's K x (M or N).
struct Planes {
  const void* a[2];
  int a_rows, a_cols;
  const void* b;
  int b_rows, b_cols;
};

template <int WG, int TBN, int NA, bool A_MN, bool B_MN, int EPI>
cudaError_t launch_wgmma(const Planes& p, const Epi16& e, int device, cudaStream_t stream) {
  constexpr int kStageBytes = NA * WG * kAtomBytes + TBN * 128;
  constexpr int kSmem = ring_stages(kStageBytes) * (kStageBytes + 16) + 1024;
  auto kernel = wgmma_gemm<WG, TBN, NA, A_MN, B_MN, EPI>;
  static bool sized[64] = {};
  cudaError_t err = cudaSuccess;
  if (device < 0 || device >= 64 || !sized[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) sized[device] = true;
  }
  Maps maps = {};
  for (int t = 0; t < NA && err == cudaSuccess; ++t)
    err = plane_map(&maps.a[t], p.a[t], p.a_rows, p.a_cols, A_MN ? 64 : 64 * WG);
  if (err == cudaSuccess) err = plane_map(&maps.b, p.b, p.b_rows, p.b_cols, B_MN ? 64 : TBN);
  if (err != cudaSuccess) return err;
  const dim3 grid(e.N / TBN, (e.M + 64 * WG - 1) / (64 * WG));
  kernel<<<grid, 128 * WG + 32, kSmem, stream>>>(maps, e);
  return cudaGetLastError();
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The persistent kernel's work: `units` units, unit u = K slice u / tiles of the output tile
// u % tiles (row tile (u % tiles) / col_tiles, column tile u % col_tiles). Slice s of nk K tiles
// takes [s nk / split, (s + 1) nk / split).
struct Sched {
  int tiles, col_tiles, split, units;
  float* partial;  // split > 1: each slice's f32 sums, split x M x N
  int* count;      // split > 1: the slices done of each output tile, zero at launch
};

struct Unit {
  int m0, n0, tile, slice, k_first, k_tiles;
};

template <int ROWS, int TBN>
__device__ __forceinline__ Unit unit_at(const Sched& sc, int nk, int u) {
  Unit w;
  w.slice = u / sc.tiles;
  w.tile = u - w.slice * sc.tiles;
  w.m0 = (w.tile / sc.col_tiles) * ROWS;
  w.n0 = (w.tile % sc.col_tiles) * TBN;
  w.k_first = w.slice * nk / sc.split;
  w.k_tiles = (w.slice + 1) * nk / sc.split - w.k_first;
  return w;
}

constexpr int kPersistentThreads = 384;  // two consumer warpgroups and the producer's
constexpr int kChunk = 64;                // columns of a warp's staging tile
constexpr int kChunkLd = kChunk + 8;      // floats per staged row: conflict-free 8-byte writes

// The persistent kernel's shared memory past the ring: each consumer warp's 16 x kChunk staging
// tile, where the product's epilogue goes through one (every product but dW), then a full and
// an empty barrier per stage and the two consumer warpgroups' flags.
__host__ __device__ constexpr int persistent_extra(bool staged) {
  return (staged ? 8 * 16 * kChunkLd * 4 : 0) + 16;
}
// The persistent ring: as many stages as a block's shared memory holds, up to 8.
__host__ __device__ constexpr int persistent_stages(int stage_bytes, bool staged) {
  return (kMaxSmem - 1024 - persistent_extra(staged)) / (stage_bytes + 16) < 8
             ? (kMaxSmem - 1024 - persistent_extra(staged)) / (stage_bytes + 16)
             : 8;
}
// The swizzle's alignment slack, the ring and what lies past it.
__host__ __device__ constexpr int persistent_smem(int stage_bytes, bool staged) {
  return 1024 + persistent_stages(stage_bytes, staged) * (stage_bytes + 16) +
         persistent_extra(staged);
}

// C (M x N) = sum over A's NA term planes t of A_t B^T, K deep, as wgmma_gemm computes it, by
// gridDim.x persistent blocks (one per SM) that walk the work units u = blockIdx.x, blockIdx.x
// + gridDim.x, ... A unit is a (64 RM) x TBN output tile, or one K slice of it. The producer
// warp's TMA ring runs on across units. The block's two consumer warpgroups take its units in
// turn (the "ping-pong" schedule): one runs a unit's mainloop while the other runs the previous
// unit's epilogue, so that an epilogue's loads and stores lie under the next unit's loads and
// products. The ring is not drained then, so each consumer warp has a staging tile of its own;
// the epilogue issues its loads ahead of its stores, since a warpgroup alone has to keep enough
// of them in flight (one load per row, waited on in turn, ran the forward's second product at
// B = 49,152 slower than one tile per block); dW's 4 MB go straight from the registers. A named
// barrier passes the mainloop from one warpgroup to the other, so that the two never wait on one
// ring stage a lap apart (a parity wait cannot tell the laps apart). Split K: each slice parks
// its f32 sums in `partial`, and the last slice of a tile to finish (an integer count per tile:
// no float atomics) adds the split's sums in slice order and runs the epilogue, so the sum and
// the bf16 rounding after it do not depend on which slice came last: repeated runs agree
// bitwise. The producer's registers go to the consumers (setmaxnreg), whose RM x TBN / 2
// accumulators each hold a whole tile.
template <int RM, int TBN, int NA, bool A_MN, bool B_MN, int EPI>
__global__ void __launch_bounds__(kPersistentThreads, 1)
    wgmma_gemm_persistent(__grid_constant__ const Maps maps, const Epi16 e, const Sched sc) {
  constexpr int kRows = 64 * RM;
  constexpr int kABytes = RM * kAtomBytes;  // one term of A's tile
  constexpr int kStageBytes = NA * kABytes + TBN * 128;
  constexpr bool kStaged = EPI != kDw;  // dW's 4 MB go straight from the registers
  constexpr int kStages = persistent_stages(kStageBytes, kStaged);
  constexpr int kAcc = TBN / 2;  // accumulators per thread of m64 x TBN
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle's alignment
  const uint32_t staging = base + kStages * kStageBytes;         // the warps' staging tiles,
  const uint32_t full0 = staging + persistent_extra(kStaged) - 16;  // kStages full barriers,
  const uint32_t empty0 = full0 + kStages * 8;                   // then kStages empty ones,
  volatile int* const last =                                     // then the two flags
      reinterpret_cast<volatile int*>(smem_raw + (empty0 + kStages * 8 - smem_addr(smem_raw)));
  const int nk = (e.K + kTK - 1) / kTK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrival, plus the bytes
      mbar_init(empty0 + 8 * s, 4);  // one arrival per warp of the warpgroup that read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0;  // the ring's step, across units
#pragma unroll 1
      for (int u = blockIdx.x; u < sc.units; u += gridDim.x) {
        const Unit w = unit_at<kRows, TBN>(sc, nk, u);
#pragma unroll 1
        for (int l = 0; l < w.k_tiles; ++l, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
          const uint32_t st = base + s * kStageBytes, bar = full0 + 8 * s;
          const int k0 = (w.k_first + l) * kTK;
          mbar_arrive_expect_tx(bar, kStageBytes);
#pragma unroll
          for (int t = 0; t < NA; ++t) {
            if (A_MN) {
#pragma unroll
              for (int r = 0; r < RM; ++r)
                tma_load(st + t * kABytes + r * kAtomBytes, &maps.a[t], bar, w.m0 + 64 * r, k0);
            } else {
              tma_load(st + t * kABytes, &maps.a[t], bar, k0, w.m0);
            }
          }
          const uint32_t sb = st + NA * kABytes;
          if (B_MN) {
#pragma unroll
            for (int j = 0; j < TBN / 64; ++j)
              tma_load(sb + j * kAtomBytes, &maps.b, bar, w.n0 + 64 * j, k0);
          } else {
            tma_load(sb, &maps.b, bar, k0, w.n0);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // the consumer warpgroups: wg takes the block's units of even (0) or odd (1) place
  const int wg = warp / 4;
  // Descriptors as wgmma_gemm's; each 64-row block r of A's tile lies kAtomBytes apart.
  constexpr uint32_t kStepA = A_MN ? 2048 : 32, kStepB = B_MN ? 2048 : 32;
  constexpr uint32_t kLboA = A_MN ? 1024 : 16;
  constexpr uint32_t kLboB = B_MN ? (TBN > 64 ? kAtomBytes : 1024) : 16;
  float acc[RM][kAcc];
  int it = 0, place = 0;
#pragma unroll 1
  for (int u = blockIdx.x; u < sc.units; u += gridDim.x, ++place) {
    const Unit w = unit_at<kRows, TBN>(sc, nk, u);
    if (place % 2 != wg) {  // the other warpgroup's unit
      it += w.k_tiles;
      continue;
    }
    // the other warpgroup has waited on every stage of its unit before this one
    if (place > 0) asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[r][i] = 0.f;
#pragma unroll 1
    for (int l = 0; l < w.k_tiles; ++l, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const uint32_t st = base + s * kStageBytes;
#pragma unroll
      for (int r = 0; r < RM; ++r) fence_regs(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < NA; ++t) {
#pragma unroll
        for (int kk = 0; kk < kTK / 16; ++kk) {
          const uint32_t b = st + NA * kABytes + kk * kStepB;
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const uint32_t a = st + t * kABytes + r * kAtomBytes + kk * kStepA;
            wgmma<TBN, A_MN, B_MN>(acc[r], smem_desc(a, kLboA, 1024), smem_desc(b, kLboB, 1024));
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: release its stage
#pragma unroll
      for (int r = 0; r < RM; ++r) fence_regs(acc[r]);
      if (l > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
    // hand the mainloop to the other warpgroup, if the block has a next unit
    if (u + gridDim.x < sc.units) asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory");
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < RM; ++r) fence_regs(acc[r]);
    if (w.k_tiles > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));

    // Accumulator j of a thread lies at row lane / 4 (+ 8 for j % 4 >= 2), column 8 (j / 4) +
    // 2 (lane % 4) + j % 2 of its warp's 16 rows of each 64-row block r.
    const int row = w.m0 + 16 * (warp % 4) + lane / 4, col = w.n0 + 2 * (lane % 4);
    if (sc.split > 1) {  // park this slice's sums; the tile's last slice adds them in order
      const long long plane = static_cast<long long>(e.M) * e.N;
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int i = 0; i < kAcc / 2; ++i) {  // pair i: row + 8 (i % 2), column col + 8 (i / 2)
          const int m = row + 64 * r + 8 * (i % 2);
          if (m < e.M)
            st2(sc.partial + w.slice * plane + static_cast<long long>(m) * e.N + col + 8 * (i / 2),
                acc[r][2 * i], acc[r][2 * i + 1]);
        }
      __threadfence();
      asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");
      if (threadIdx.x % 128 == 0) last[wg] = atomicAdd(sc.count + w.tile, 1) == sc.split - 1;
      asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");
      if (!last[wg]) continue;
      __threadfence();
#pragma unroll 1
      for (int q = 0; q < sc.split; ++q) {  // slice 0's sums, then each next slice's added
        const float* const part = sc.partial + q * plane;
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int i = 0; i < kAcc / 2; ++i) {
            const int m = row + 64 * r + 8 * (i % 2);
            if (m >= e.M) continue;
            const float2 v = __ldcg(reinterpret_cast<const float2*>(
                part + static_cast<long long>(m) * e.N + col + 8 * (i / 2)));
            acc[r][2 * i] = q ? acc[r][2 * i] + v.x : v.x;
            acc[r][2 * i + 1] = q ? acc[r][2 * i + 1] + v.y : v.y;
          }
      }
    }
    if constexpr (!kStaged) {  // dW: rounded to bf16, straight from the registers
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int i = 0; i < kAcc / 2; ++i) {
          const int m = row + 64 * r + 8 * (i % 2);
          if (m < e.M)
            st2(e.out0 + static_cast<long long>(m) * e.N + col + 8 * (i / 2),
                round_bf16(acc[r][2 * i]), round_bf16(acc[r][2 * i + 1]));
        }
      continue;
    }
    // The other products through the warp's staging tile, as wgmma_gemm's epilogue: kChunk
    // columns of the warp's 16 rows at a time, parked and read back as whole rows of float4s,
    // so that every load and store of device memory is 16 bytes and a warp's reach whole
    // 128-byte lines.
    float* const tile = reinterpret_cast<float*>(smem_raw + (staging - smem_addr(smem_raw))) +
                        warp * 16 * kChunkLd;
    constexpr int kRowsPerStep = 128 / kChunk;  // a warp's 32 float4s cover this many rows
    const int c4 = 4 * (lane % (kChunk / 4));
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row0 = w.m0 + 64 * r + 16 * (warp % 4);
#pragma unroll
      for (int c = 0; c < TBN / kChunk; ++c) {
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
          const int a = 4 * (c * kChunk / 8 + j);
          float* p = tile + (lane / 4) * kChunkLd + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<float2*>(p) = make_float2(acc[r][a], acc[r][a + 1]);
          *reinterpret_cast<float2*>(p + 8 * kChunkLd) = make_float2(acc[r][a + 2], acc[r][a + 3]);
        }
        // the chunk's bias and aux values first: loads issued together, ahead of the stores
        // (which the compiler may not move them past)
        const int n = w.n0 + c * kChunk + c4;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 b = EPI == kFwd1 || EPI == kFwd2 ? ldg4(e.bias + n) : zero;
        float4 aux[16 / kRowsPerStep];
#pragma unroll
        for (int i = 0; i < 16 / kRowsPerStep; ++i) {
          const int m = row0 + i * kRowsPerStep + lane / (kChunk / 4);
          aux[i] = reads_aux(EPI) && m < e.M ? ldg4(e.aux + static_cast<long long>(m) * e.N + n)
                                             : zero;
        }
        __syncwarp();
        float4 sum = zero;
#pragma unroll
        for (int i = 0; i < 16 / kRowsPerStep; ++i) {
          const int rr = i * kRowsPerStep + lane / (kChunk / 4);
          const float4 v = *reinterpret_cast<const float4*>(tile + rr * kChunkLd + c4);
          const float4 g = epilogue4<EPI>(e, row0 + rr, n, v, b, aux[i]);
          sum = make_float4(sum.x + g.x, sum.y + g.y, sum.z + g.z, sum.w + g.w);
        }
        if constexpr (EPI == kDh) {  // the column sums of the warp's 16 rows of g1, for db1
          sum.x += __shfl_xor_sync(0xffffffffu, sum.x, 16);  // the two half warps' rows
          sum.y += __shfl_xor_sync(0xffffffffu, sum.y, 16);
          sum.z += __shfl_xor_sync(0xffffffffu, sum.z, 16);
          sum.w += __shfl_xor_sync(0xffffffffu, sum.w, 16);
          if (row0 < e.M && lane < kChunk / 4)
            *reinterpret_cast<float4*>(e.colsum + static_cast<long long>(row0 / kSumRows) * e.N +
                                       w.n0 + c * kChunk + c4) = sum;
        }
        __syncwarp();
      }
    }
  }
}

// A product's plan (ops/resblock.py:bf16_plan): one tile per block (wgmma_gemm), or the
// persistent kernel's tile, K split and grid.
struct Bf16Plan {
  int persistent, rows, cols, split, grid;
};

// The output tiles of a product on `plan`'s tile.
int plan_tiles(const Bf16Plan& plan, int M, int N) {
  return (M + plan.rows - 1) / plan.rows * (N / plan.cols);
}

template <int RM, int TBN, int NA, bool A_MN, bool B_MN, int EPI>
cudaError_t launch_persistent(const Planes& p, const Epi16& e, const Bf16Plan& plan,
                              float* partial, int* count, int device, cudaStream_t stream) {
  constexpr int kSmem = persistent_smem(NA * RM * kAtomBytes + TBN * 128, EPI != kDw);
  static_assert(kSmem <= kMaxSmem, "the ring fits a block");
  Sched sc = {};
  sc.col_tiles = e.N / TBN;
  sc.tiles = plan_tiles(plan, e.M, e.N);
  sc.split = plan.split;
  sc.units = sc.tiles * plan.split;
  sc.partial = partial;
  sc.count = count;
  if (e.N % TBN || plan.split < 1 || plan.split > (e.K + kTK - 1) / kTK || plan.grid < 1 ||
      plan.grid > sc.units || (plan.split > 1 && (!partial || !count)))
    return cudaErrorInvalidValue;
  auto kernel = wgmma_gemm_persistent<RM, TBN, NA, A_MN, B_MN, EPI>;
  static bool sized[64] = {};
  cudaError_t err = cudaSuccess;
  if (device < 0 || device >= 64 || !sized[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) sized[device] = true;
  }
  Maps maps = {};
  for (int t = 0; t < NA && err == cudaSuccess; ++t)
    err = plane_map(&maps.a[t], p.a[t], p.a_rows, p.a_cols, A_MN ? 64 : 64 * RM);
  if (err == cudaSuccess) err = plane_map(&maps.b, p.b, p.b_rows, p.b_cols, B_MN ? 64 : TBN);
  if (err != cudaSuccess) return err;
  kernel<<<plan.grid, kPersistentThreads, kSmem, stream>>>(maps, e, sc);
  return cudaGetLastError();
}

// One product on its plan's tile (ops/resblock.py:BF16_KERNELS lists the tiles built here:
// (persistent, rows, cols)). `partial` and `count` serve a persistent plan that splits K.
template <int NA, bool A_MN, bool B_MN, int EPI>
cudaError_t run_wgmma(const Planes& p, const Epi16& e, const Bf16Plan& plan, float* partial,
                      int* count, int device, cudaStream_t stream) {
#define K1_BF16_TILE(ROWS, COLS)                                                        \
  if (!plan.persistent && plan.rows == ROWS && plan.cols == COLS && plan.split == 1) \
    return launch_wgmma<ROWS / 64, COLS, NA, A_MN, B_MN, EPI>(p, e, device, stream);
#define K1_BF16_PERSISTENT(ROWS, COLS)                                                     \
  if (plan.persistent && plan.rows == ROWS && plan.cols == COLS)                        \
    return launch_persistent<ROWS / 64, COLS, NA, A_MN, B_MN, EPI>(p, e, plan, partial, count, \
                                                                    device, stream);
  K1_BF16_TILE(64, 64)
  K1_BF16_PERSISTENT(64, 256)
#undef K1_BF16_TILE
#undef K1_BF16_PERSISTENT
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------------------------
// The f32 policy's forward: f32 masters by TMA, three tf32 passes per product on wgmma.

constexpr uint32_t kTf32Big = 0xFFFFE000u;  // sign, exponent and the 10 mantissa bits of tf32
constexpr int kF32Threads = 256;            // the small-plane kernel

// v = big + small exactly: big is v with its low 13 mantissa bits cleared (what the tensor core
// reads of v as a tf32 operand), small = v - big (exact: the cleared bits), signed as v so that
// big + small gives v back bit for bit, -0 included.
__device__ __forceinline__ float tf32_small(float v) {
  return copysignf(v - __uint_as_float(__float_as_uint(v) & kTf32Big), v);
}

__global__ void __launch_bounds__(kF32Threads)
    small_kernel(const float4* __restrict__ v, float4* __restrict__ s, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kF32Threads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kF32Threads) {
    const float4 a = v[i];
    s[i] = make_float4(tf32_small(a.x), tf32_small(a.y), tf32_small(a.z), tf32_small(a.w));
  }
}

cudaError_t small_plane(const void* v, void* s, long long n, int device, cudaStream_t stream) {
  const long long n4 = n / 4;
  const long long blocks = (n4 + kF32Threads - 1) / kF32Threads, most = 8ll * sm_count(device);
  const int grid = static_cast<int>(blocks < most ? blocks : most);
  small_kernel<<<grid, kF32Threads, 0, stream>>>(static_cast<const float4*>(v),
                                                   static_cast<float4*>(s), n4);
  return cudaGetLastError();
}

// The tensor maps of one tf32 product: A's master and small plane (M x K), B's (N x K).
struct MapsF32 {
  CUtensorMap a, a_small, b, b_small;
};

// The epilogue's operands and the tile plan's runtime parts; outputs and `aux` are row-major
// (M, N).
struct EpiF32 {
  float* out0;         // a1, a2 or the bare product
  float* out1;         // h or y
  float* small;        // h's small plane
  const float* bias;   // (N)
  const float* aux;    // x, y's residual
  int M, N, K;
  int a_rows;          // rows of A's TMA box: the tile's rows, or its rows below M rounded to 8
  int chunk;           // K tiles (32 deep) per stage of the ring, and per TMA box
  int stages;          // the ring's depth
};

// A stage of the ring: `chunk` K tiles each of A's master (a_rows rows of 128 bytes: 32 f32
// along K), of A's small plane, of B's master (TBN rows), of B's small plane; one pass reads
// only the masters.
__host__ __device__ constexpr int f32_stage_bytes(int a_rows, int tbn, int chunk, bool three) {
  return (three ? 2 : 1) * chunk * (a_rows + tbn) * 128;
}
// A block's dynamic shared memory: the swizzle's alignment slack, the ring, what a 64 x WG-row
// wgmma reads past the ring's last A tile when A's box has fewer rows (rows below M only reach
// the outputs that the epilogue drops), and the ring's full and empty barriers.
__host__ __device__ constexpr int f32_smem_bytes(int wg, int tbn, int a_rows, int chunk,
                                                 int stages, bool three) {
  return 1024 + stages * f32_stage_bytes(a_rows, tbn, chunk, three) + (64 * wg - a_rows) * 128 +
         16 * stages;
}

// TMA: the 3D box of `map` at (c0, c1, c2) into shared memory at dst; its bytes count towards
// bar's transaction count.
__device__ __forceinline__ void tma_load_chunk(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int EPI>
__device__ __forceinline__ void epilogue_f32(const EpiF32& e, int m, int n, const float4 acc) {
  if (m >= e.M) return;
  const long long o = static_cast<long long>(m) * e.N + n;
  float v[4] = {acc.x, acc.y, acc.z, acc.w}, r[4];
  if constexpr (EPI != kProduct) {
    const float4 b = *reinterpret_cast<const float4*>(e.bias + n);
    v[0] += b.x;
    v[1] += b.y;
    v[2] += b.z;
    v[3] += b.w;
  }
  st4(e.out0 + o, v);  // a1, a2 or the bare product
  if constexpr (EPI == kFwd1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = lrelu(v[c]);
    st4(e.out1 + o, r);  // h
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = tf32_small(r[c]);
    if (e.small) st4(e.small + o, r);  // h's small plane, the next product's A
  } else if constexpr (EPI == kFwd2) {
    const float4 x = ldg4(e.aux + o);
    r[0] = lrelu(v[0]) + x.x;
    r[1] = lrelu(v[1]) + x.y;
    r[2] = lrelu(v[2]) + x.z;
    r[3] = lrelu(v[3]) + x.w;
    st4(e.out1 + o, r);  // y
  }
}

// C (M x N) = A (M x K) B^T (N x K), both f32 and K-major, on a WG x 64 by TBN output tile, in
// three tf32 passes (THREE: big.big, small.big and big.small) or one (big.big: the start-up
// check of the truncation). The producer keeps e.stages stages of e.chunk K tiles in flight, one
// TMA box per operand and stage. Consumer warpgroup g owns the tile's 64 rows g % WG of the
// stages j = g / WG (mod KW): KW > 1 splits a narrow tile's K over warpgroups, whose wgmmas then
// run side by side (a warpgroup's run in order, and a narrow one's are short). A warpgroup adds
// each K tile's products in an accumulator of their own and then, round to nearest, into a
// register sum: the tensor core's own adds truncate, with an error that grows with what they
// add to. Two accumulators take turns, so the sum is made while the next K tile's wgmmas run. At
// one row warpgroup (WG = 1) the small terms have a third accumulator over the whole K; with
// two, the 128 x 128 tile's accumulators would not fit beside it. The K groups' sums are added
// in order at the end. ASPLIT (one row tile: A is a few rows): TMA copies A's master only, and
// the K group writes A's small tiles beside it as each stage arrives (elementwise, so in the
// same swizzled layout), so that A needs no small plane in device memory.
template <int WG, int KW, int TBN, int EPI, bool THREE, bool ASPLIT>
__global__ void __launch_bounds__(128 * WG * KW + (WG > 1 ? 128 : 32), 1)
    tf32_gemm(__grid_constant__ const MapsF32 maps, const EpiF32 e) {
  constexpr int kAcc = TBN / 2;  // accumulators per thread of m64 x TBN
  constexpr int kGroups = WG * KW;  // consumer warpgroups
  constexpr bool kApart = THREE && WG == 1;  // the small terms' own accumulator
  const int stages = e.stages, chunk = e.chunk;
  const int a_tile = e.a_rows * 128;   // one K tile of A's box
  const int a_bytes = chunk * a_tile;  // A's master in a stage
  const int stage_bytes = f32_stage_bytes(e.a_rows, TBN, chunk, THREE);
  const int tx_bytes = stage_bytes - (ASPLIT ? a_bytes : 0);  // what TMA copies into a stage
  const uint32_t b_off = (THREE ? 2 : 1) * a_bytes;  // B's master within a stage
  const int b_bytes = chunk * TBN * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle's alignment
  const uint32_t full0 = base + stages * stage_bytes + (64 * WG - e.a_rows) * 128;
  const uint32_t empty0 = full0 + stages * 8;
  const int m0 = blockIdx.y * 64 * WG, n0 = blockIdx.x * TBN;
  const int nk = (e.K + 31) / 32, ns = (nk + chunk - 1) / chunk;  // K tiles, stages in all
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);        // the producer's arrival, plus the bytes
      mbar_init(empty0 + 8 * s, 4 * WG);  // one arrival per warp of the K group reading it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  } else if (threadIdx.x == 128 * kGroups) {  // the producer's maps, fetched meanwhile
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.a) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.b) : "memory");
  }
  __syncthreads();

  if (warp >= 4 * kGroups) {  // the producer: one thread keeps the ring full
    // two row warpgroups: the producer is a whole warpgroup, which gives its registers to them
    if constexpr (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * kGroups && lane == 0) {
      for (int j = 0; j < ns; ++j) {
        const int s = j % stages;
        if (j >= stages) mbar_wait(empty0 + 8 * s, ((j / stages) - 1) & 1);
        const uint32_t st = base + s * stage_bytes, bar = full0 + 8 * s;
        mbar_arrive_expect_tx(bar, tx_bytes);
        tma_load_chunk(st, &maps.a, bar, 0, m0, j * chunk);
        tma_load_chunk(st + b_off, &maps.b, bar, 0, n0, j * chunk);
        if constexpr (THREE && !ASPLIT)
          tma_load_chunk(st + a_bytes, &maps.a_small, bar, 0, m0, j * chunk);
        if constexpr (THREE)
          tma_load_chunk(st + b_off + b_bytes, &maps.b_small, bar, 0, n0, j * chunk);
      }
    }
    return;
  }
  if constexpr (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // the consumer warpgroups
  const int g = warp / 4, row_wg = g % WG, kgroup = g / WG;
  float acc[2][kAcc], acc_s[kApart ? kAcc : 1], sum[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[0][i] = acc[1][i] = sum[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kApart ? kAcc : 1); ++i) acc_s[i] = 0.f;
  // This warpgroup's K tiles l = 0, 1, ...: tile l % chunk of its stage l / chunk, which is the
  // ring's stage kgroup + (l / chunk) KW.
  const int mine = ns > kgroup ? (ns - kgroup + KW - 1) / KW : 0;  // its stages
  const int last = kgroup + (mine - 1) * KW;                        // the last of them
  const int n_local = mine > 0 ? (mine - 1) * chunk + (nk - last * chunk < chunk ?
                                                       nk - last * chunk : chunk) : 0;
  // One K tile into x (its first wgmma overwrites x), then prev (the warpgroup's K tile before
  // it) into the sum. Descriptors (128-byte swizzle, K-major): a k8 slice is 32 bytes into each
  // 128-byte row; 8-row groups lie 1024 bytes apart.
  auto step = [&](float (&x)[kAcc], float (&prev)[kAcc], int l) {
    const int j = kgroup + (l / chunk) * KW, c = l % chunk, s = j % stages;
    const uint32_t st = base + s * stage_bytes;
    if (c == 0) {
      mbar_wait(full0 + 8 * s, (j / stages) & 1);
      if constexpr (ASPLIT) {  // A's small tiles of the stage, from its masters
        unsigned char* const ga = smem_raw + (st - smem_addr(smem_raw));
        for (int i = threadIdx.x % 128; i < chunk * e.a_rows * 8; i += 128) {
          const float4 v = *reinterpret_cast<const float4*>(ga + 16 * i);
          *reinterpret_cast<float4*>(ga + a_bytes + 16 * i) =
              make_float4(tf32_small(v.x), tf32_small(v.y), tf32_small(v.z), tf32_small(v.w));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        asm volatile("bar.sync %0, 128;\n" ::"r"(3 + g) : "memory");  // the K group's warps
      }
    }
    const uint32_t a = st + c * a_tile + row_wg * 64 * 128, b = st + b_off + c * TBN * 128;
    fence_regs(x);
    fence_regs(acc_s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = smem_desc(a + kk * 32, 16, 1024), db = smem_desc(b + kk * 32, 16, 1024);
      if constexpr (THREE) {
        const uint64_t das = smem_desc(a + a_bytes + kk * 32, 16, 1024);
        const uint64_t dbs = smem_desc(b + b_bytes + kk * 32, 16, 1024);
        if constexpr (kApart) {
          wgmma_tf32<TBN>(acc_s, das, db);
          wgmma_tf32<TBN>(acc_s, da, dbs);
        } else {
          wgmma_tf32<TBN>(x, das, db, kk > 0);
          wgmma_tf32<TBN>(x, da, dbs);
        }
      }
      wgmma_tf32<TBN>(x, da, db, kk > 0 || (THREE && !kApart));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the warpgroup's previous K tile is done
    fence_regs(x);
    fence_regs(prev);
    fence_regs(acc_s);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) sum[i] += prev[i];
    if (c == 0 && l > 0 && lane == 0)  // the previous K tile ended a stage: release it
      mbar_arrive(empty0 + 8 * ((j - KW) % stages));
  };
  for (int l = 0; l < n_local; l += 2) {
    step(acc[0], acc[1], l);
    if (l + 1 < n_local) step(acc[1], acc[0], l + 1);
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  fence_regs(acc_s);
  const bool odd = n_local % 2;  // the last K tile went to acc[0]
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    if (n_local > 0) sum[i] += odd ? acc[0][i] : acc[1][i];
    if constexpr (kApart) sum[i] += acc_s[i];
  }

  // The epilogue, through shared memory as wgmma_gemm's: each warp parks its 16 x TBN sums in
  // the drained ring; the first K group's warps read them back as whole rows of float4s, with
  // the other K groups' sums for the same rows added in order.
  constexpr int kLd = TBN + 8;  // floats per staged row: conflict-free 8-byte writes
  constexpr int kPart = 4 * WG * 16 * kLd;  // floats of one K group's sums
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kGroups) : "memory");
  float* const staged = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)));
  float* tile = staged + kgroup * kPart + (warp % (4 * WG)) * 16 * kLd;
#pragma unroll
  for (int j = 0; j < TBN / 8; ++j) {
    float* p = tile + (lane / 4) * kLd + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(p) = make_float2(sum[4 * j], sum[4 * j + 1]);
    *reinterpret_cast<float2*>(p + 8 * kLd) = make_float2(sum[4 * j + 2], sum[4 * j + 3]);
  }
  if constexpr (KW > 1) {
    asm volatile("bar.sync 2, %0;\n" ::"n"(128 * kGroups) : "memory");
    if (kgroup > 0) return;
  } else {
    __syncwarp();
  }
  constexpr int kRowsPerStep = 128 / TBN;  // a warp's 32 float4s cover this many rows
  const int row0 = m0 + 64 * row_wg + 16 * (warp % 4);
  const int c = 4 * (lane % (TBN / 4));
#pragma unroll
  for (int r = 0; r < 16; r += kRowsPerStep) {
    const int rr = r + lane / (TBN / 4);
    float4 v = *reinterpret_cast<const float4*>(tile + rr * kLd + c);
#pragma unroll
    for (int q = 1; q < KW; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(tile + q * kPart + rr * kLd + c);
      v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
    }
    epilogue_f32<EPI>(e, row0 + rr, n0 + c, v);
  }
}

// The staged sums of every consumer warp fit in the ring, which holds 2 stages per K group, or
// all `ns` stages of the product.
__host__ __device__ constexpr bool f32_ring_fits(int wg, int kw, int tbn, int a_rows, int chunk,
                                                 int stages, int ns, bool three) {
  return stages >= (2 * kw < ns ? 2 * kw : ns) &&
         kw * 4 * wg * 16 * (tbn + 8) * 4 <= stages * f32_stage_bytes(a_rows, tbn, chunk, three);
}

template <int WG, int KW, int TBN, int EPI, bool THREE, bool ASPLIT>
cudaError_t launch_tf32(const void* a, const void* a_small, const void* b, const void* b_small,
                        const EpiF32& e, int device, cudaStream_t stream) {
  const int smem = f32_smem_bytes(WG, TBN, e.a_rows, e.chunk, e.stages, THREE);
  if (e.a_rows < 8 || e.a_rows > 64 * WG || e.a_rows % 8 || e.N % TBN || e.K % 32 ||
      e.chunk < 1 || e.chunk > 8 || smem > kMaxSmem ||
      !f32_ring_fits(WG, KW, TBN, e.a_rows, e.chunk, e.stages,
                     (e.K / 32 + e.chunk - 1) / e.chunk, THREE))
    return cudaErrorInvalidValue;
  auto kernel = tf32_gemm<WG, KW, TBN, EPI, THREE, ASPLIT>;
  static bool sized[64] = {};
  cudaError_t err = cudaSuccess;
  if (device < 0 || device >= 64 || !sized[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) sized[device] = true;
  }
  MapsF32 maps = {};
  err = plane_map(&maps.a, a, e.M, e.K, e.a_rows, e.chunk);
  if (err == cudaSuccess) err = plane_map(&maps.b, b, e.N, e.K, TBN, e.chunk);
  if (THREE && !ASPLIT && err == cudaSuccess)
    err = plane_map(&maps.a_small, a_small, e.M, e.K, e.a_rows, e.chunk);
  if (THREE && err == cudaSuccess) err = plane_map(&maps.b_small, b_small, e.N, e.K, TBN, e.chunk);
  if (err != cudaSuccess) return err;
  const dim3 grid(e.N / TBN, (e.M + 64 * WG - 1) / (64 * WG));
  kernel<<<grid, 128 * WG * KW + (WG > 1 ? 128 : 32), smem, stream>>>(maps, e);
  return cudaGetLastError();
}

// One three-pass product on the plan's tile (ops/resblock.py:f32_plan; F32_KERNELS there lists
// these): A's small tiles from its master in shared memory (a_split: one row tile, K split), or
// from a_small.
template <int EPI>
cudaError_t run_tf32(int wg, int kw, int tbn, bool a_split, const void* a, const void* a_small,
                     const void* b, const void* b_small, const EpiF32& e, int device,
                     cudaStream_t stream) {
#define K1_TF32_TILE(WG, KW, TBN, ASPLIT)                                                      \
  if (wg == WG && kw == KW && tbn == TBN && a_split == ASPLIT)                                  \
    return launch_tf32<WG, KW, TBN, EPI, true, ASPLIT>(a, a_small, b, b_small, e, device, stream);
  K1_TF32_TILE(2, 1, 128, false)
  K1_TF32_TILE(1, 2, 64, false)
  K1_TF32_TILE(1, 1, 64, false)
  K1_TF32_TILE(1, 2, 32, false)
  K1_TF32_TILE(1, 2, 32, true)
  K1_TF32_TILE(1, 4, 16, false)
  K1_TF32_TILE(1, 1, 16, false)
  K1_TF32_TILE(1, 4, 16, true)
  K1_TF32_TILE(1, 4, 8, false)
  K1_TF32_TILE(1, 1, 8, false)
  K1_TF32_TILE(1, 4, 8, true)
#undef K1_TF32_TILE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------------------------
// The f32 policy's backward: three bf16 terms per operand on the TMA ring, six term products per
// product on wgmma.

// The tensor maps of one product: A's and B's three term planes.
struct Maps3 {
  CUtensorMap a[3], b[3];
};

// The epilogue's operands and the tile plan's runtime parts; outputs and `aux` are row-major
// (M, N).
struct Epi3 {
  float* out;               // dx or dW
  __nv_bfloat16* plane[3];  // g1's term planes
  const float* aux;         // a1 (g1's mask) or dy (dx's residual)
  float* colsum;            // g1's column sums of each 16 rows (ceil(M / 16) x N)
  int M, N, K;
  int stages;               // the ring's depth
  int split;                // blocks of a cluster that share the tile's K tiles (gridDim.z)
};

// The term pairs (i, j), i + j < 3, of a product, smallest first.
__host__ __device__ constexpr int pair_a(int p) { return p == 0 ? 2 : (p == 1 || p == 3) ? 1 : 0; }
__host__ __device__ constexpr int pair_b(int p) { return p == 2 ? 2 : (p == 1 || p == 4) ? 1 : 0; }

// One stage of the ring: a TK-deep K tile of A's three term planes (64 WG rows each) and of
// B's (TBN columns each). A block's dynamic shared memory: the swizzle's alignment slack, the
// ring, and a full and an empty barrier per stage. The epilogue parks 16 x (TBN + 8) floats per
// consumer warp in the drained ring.
__host__ __device__ constexpr int terms3_stage_bytes(int wg, int tbn, int tk) {
  return 3 * (64 * wg + tbn) * tk * 2;
}
__host__ __device__ constexpr int terms3_smem_bytes(int wg, int tbn, int tk, int stages) {
  return 1024 + stages * (terms3_stage_bytes(wg, tbn, tk) + 16);
}
__host__ __device__ constexpr int terms3_parked_bytes(int wg, int tbn) {
  return 4 * wg * 16 * (tbn + 8) * 4;
}

// The epilogue of the four sums at row m, columns n .. n + 3: g1 = dh * lrelu'(a1), unrounded,
// into its three term planes (returned, for db1's column sums); dx = dy + g1 W1; dW.
template <int EPI>
__device__ __forceinline__ float4 epilogue3(const Epi3& e, int m, int n, const float4 acc) {
  if (m >= e.M) return make_float4(0.f, 0.f, 0.f, 0.f);
  const long long o = static_cast<long long>(m) * e.N + n;
  float v[4] = {acc.x, acc.y, acc.z, acc.w};
  if constexpr (EPI == kDh) {
    const float4 a = ldg4(e.aux + o);
    v[0] *= dlrelu(a.x);
    v[1] *= dlrelu(a.y);
    v[2] *= dlrelu(a.z);
    v[3] *= dlrelu(a.w);
    float t[3][4];
    split_terms(v, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) store_bf16x4(e.plane[k] + o, t[k]);
  } else if constexpr (EPI == kDx) {
    const float4 dy = ldg4(e.aux + o);
    v[0] += dy.x;
    v[1] += dy.y;
    v[2] += dy.z;
    v[3] += dy.w;
    st4(e.out + o, v);
  } else {
    st4(e.out + o, v);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// p's generic address in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ const float* peer(const float* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// C (M x N) = sum over the term pairs (i, j), i + j < 3, of A_i B_j^T, K deep, at f32 precision
// from bf16 terms, in K tiles TK deep (64: one 128-byte swizzled row of a K-contiguous tile; 32:
// half of one, in the 64-byte swizzle, so that a 128 x 128 tile's ring holds 4 stages). A's tile
// is WG x 64 rows; each consumer warpgroup owns 64 of them and all TBN columns. B is read
// N-contiguous (W in dh and dx, x / h in dW), A K-contiguous (g2 in dh, g1 in dx) or, A_MN,
// M-contiguous (g2, g1 in dW): both through wgmma's transpose bits, from tiles TMA copied as
// they lie (rows outside a plane arrive as zeros). Block `rank` of a cluster of
// e.split along z takes the rank-th share of the K tiles. A warpgroup's K tile goes to an
// accumulator of its own (its first wgmma overwrites it), added round to nearest into a register
// sum while the next tile's wgmmas run: the tensor core's own adds truncate, with an error that
// grows with what they add to. At two row warpgroups (192 registers of accumulators and sums)
// the producer is a whole warpgroup that gives its registers to them.
template <int WG, int TBN, int TK, bool A_MN, int EPI>
__global__ void __launch_bounds__(128 * WG + (WG > 1 ? 128 : 32), 1)
    terms3_gemm(__grid_constant__ const Maps3 maps, const Epi3 e) {
  constexpr int kBox = 64 * TK * 2;          // 64 rows of a K tile: an M- or N-contiguous box
  constexpr int kABytes = WG * kBox;         // one term of A's tile
  constexpr int kBBytes = TBN * TK * 2;      // one term of B's tile
  constexpr int kStageBytes = terms3_stage_bytes(WG, TBN, TK);
  constexpr int kAcc = TBN / 2;              // accumulators per thread of m64 x TBN
  constexpr int kLd = TBN + 8;               // floats per staged row: conflict-free 8-byte writes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle's alignment
  const int stages = e.stages;
  const uint32_t full0 = base + stages * kStageBytes, empty0 = full0 + stages * 8;
  const int m0 = blockIdx.y * 64 * WG, n0 = blockIdx.x * TBN;
  const int nk = (e.K + TK - 1) / TK, rank = blockIdx.z;  // the block's rank in its cluster
  const int k_first = rank * nk / e.split, n_local = (rank + 1) * nk / e.split - k_first;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* const staged = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)));

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);        // the producer's arrival, plus the bytes
      mbar_init(empty0 + 8 * s, 4 * WG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WG) {  // the producer: one thread keeps the ring full
    if constexpr (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * WG && lane == 0) {
      for (int l = 0; l < n_local; ++l) {
        const int s = l % stages;
        if (l >= stages) mbar_wait(empty0 + 8 * s, ((l / stages) - 1) & 1);
        const uint32_t st = base + s * kStageBytes, bar = full0 + 8 * s;
        const int k0 = (k_first + l) * TK;
        mbar_arrive_expect_tx(bar, kStageBytes);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          if (A_MN) {
#pragma unroll
            for (int w = 0; w < WG; ++w)
              tma_load(st + t * kABytes + w * kBox, &maps.a[t], bar, m0 + 64 * w, k0);
          } else {
            tma_load(st + t * kABytes, &maps.a[t], bar, k0, m0);
          }
#pragma unroll
          for (int j = 0; j < TBN / 64; ++j)
            tma_load(st + 3 * kABytes + t * kBBytes + j * kBox, &maps.b[t], bar, n0 + 64 * j,
                     k0);
        }
      }
    }
    __syncwarp();
    if (e.split > 1) {  // the epilogue's two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;  // no code after this point runs on the producer's 40 registers
  }
  if constexpr (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  {  // the consumer warpgroups' mainloop
    const int wg = warp / 4;
    float acc[2][kAcc], sum[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[0][i] = acc[1][i] = sum[i] = 0.f;
    // Descriptors: along K a k16 slice is 32 bytes into each row of a K-contiguous tile (rows of
    // TK bf16 in the 128- or 64-byte swizzle, 8-row groups 8 rows apart), or 16 rows (2048
    // bytes) down an M- or N-contiguous one (rows of 64 in the 128-byte swizzle, 8-row groups
    // 1024 bytes apart); the 64-wide boxes of a 128-wide B tile lie kBox apart. A warpgroup's 64
    // rows of A lie kBox into the tile in either layout.
    constexpr uint32_t kStepA = A_MN ? 2048 : 32, kLboA = A_MN ? 1024 : 16;
    constexpr uint32_t kSboA = A_MN ? 1024 : 8 * TK * 2, kSwizzleA = A_MN || TK == 64 ? 1 : 2;
    constexpr uint32_t kLboB = TBN > 64 ? kBox : 1024;
    // K tile l into x (its first wgmma overwrites x), then prev (tile l - 1) into the sum
    auto step = [&](float (&x)[kAcc], float (&prev)[kAcc], int l) {
      const int s = l % stages;
      mbar_wait(full0 + 8 * s, (l / stages) & 1);
      const uint32_t st = base + s * kStageBytes;
      fence_regs(x);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 6; ++p) {
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          const uint32_t a = st + pair_a(p) * kABytes + wg * kBox + kk * kStepA;
          const uint32_t b = st + 3 * kABytes + pair_b(p) * kBBytes + kk * 2048;
          wgmma<TBN, A_MN, 1>(x, smem_desc(a, kLboA, kSboA, kSwizzleA),
                              smem_desc(b, kLboB, 1024), p > 0 || kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // tile l - 1 is done: add it, and release its stage
      fence_regs(x);
      fence_regs(prev);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) sum[i] += prev[i];
      if (l > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((l - 1) % stages));
    };
    for (int l = 0; l < n_local; l += 2) {
      step(acc[0], acc[1], l);
      if (l + 1 < n_local) step(acc[1], acc[0], l + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    const bool odd = n_local % 2;  // the last K tile went to acc[0]
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (n_local > 0) sum[i] += odd ? acc[0][i] : acc[1][i];

    // Park the sums in the drained ring, as wgmma_gemm's epilogue: accumulator j of a thread
    // lies at row lane / 4 (+ 8 for j % 4 >= 2), column 8 (j / 4) + 2 (lane % 4) + j % 2 of the
    // warp's 16-row slab.
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG) : "memory");
    float* tile = staged + warp * 16 * kLd;
#pragma unroll
    for (int j = 0; j < TBN / 8; ++j) {
      float* q = tile + (lane / 4) * kLd + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(q) = make_float2(sum[4 * j], sum[4 * j + 1]);
      *reinterpret_cast<float2*>(q + 8 * kLd) = make_float2(sum[4 * j + 2], sum[4 * j + 3]);
    }
    __syncwarp();
  }

  // Each 16-row slab w of the tile is finished by warp w of the cluster's block w % split, which
  // adds the split's parked sums of the slab in rank order (through distributed shared memory)
  // and writes whole rows of float4s. A cluster barrier before (every sum parked) and after
  // (no block leaves while another still reads its shared memory).
  if (e.split > 1) cluster_sync();
  if (warp % e.split == rank) {
    const float* slab = staged + warp * 16 * kLd;
    const float* part[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) part[q] = e.split > 1 && q < e.split ? peer(slab, q) : slab;
    constexpr int kRowsPerStep = 128 / TBN;  // a warp's 32 float4s cover this many rows
    const int row0 = m0 + 16 * warp;
    const int c = 4 * (lane % (TBN / 4));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 16; r += kRowsPerStep) {
      const int rr = r + lane / (TBN / 4);
      float4 w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < e.split) w[q] = *reinterpret_cast<const float4*>(part[q] + rr * kLd + c);
      float4 v = w[0];
#pragma unroll
      for (int q = 1; q < 8; ++q)
        if (q < e.split) v = make_float4(v.x + w[q].x, v.y + w[q].y, v.z + w[q].z, v.w + w[q].w);
      const float4 g = epilogue3<EPI>(e, row0 + rr, n0 + c, v);
      sum = make_float4(sum.x + g.x, sum.y + g.y, sum.z + g.z, sum.w + g.w);
    }
    if constexpr (EPI == kDh) {  // the column sums of the slab's 16 rows of g1, for db1
      if constexpr (kRowsPerStep == 2) {  // the two half warps summed alternate rows
        sum.x += __shfl_xor_sync(0xffffffffu, sum.x, 16);
        sum.y += __shfl_xor_sync(0xffffffffu, sum.y, 16);
        sum.z += __shfl_xor_sync(0xffffffffu, sum.z, 16);
        sum.w += __shfl_xor_sync(0xffffffffu, sum.w, 16);
      }
      if (row0 < e.M && lane < TBN / 4)
        *reinterpret_cast<float4*>(e.colsum + static_cast<long long>(row0 / kSumRows) * e.N + n0 +
                                   c) = sum;
    }
  }
  if (e.split > 1) cluster_sync();
}

template <int WG, int TBN, int TK, bool A_MN, int EPI>
cudaError_t launch_terms3(const void* const (&a)[3], int a_rows, int a_cols,
                          const void* const (&b)[3], int b_rows, int b_cols, const Epi3& e,
                          int device, cudaStream_t stream) {
  const int smem = terms3_smem_bytes(WG, TBN, TK, e.stages);
  const int nk = (e.K + TK - 1) / TK;
  if (e.stages < 1 || smem > kMaxSmem || e.N % TBN || e.split < 1 || e.split > 8 ||
      e.split > nk ||
      terms3_parked_bytes(WG, TBN) > e.stages * terms3_stage_bytes(WG, TBN, TK))
    return cudaErrorInvalidValue;
  auto kernel = terms3_gemm<WG, TBN, TK, A_MN, EPI>;
  static bool sized[64] = {};
  cudaError_t err = cudaSuccess;
  if (device < 0 || device >= 64 || !sized[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) sized[device] = true;
  }
  Maps3 maps = {};
  for (int t = 0; t < 3 && err == cudaSuccess; ++t) {
    err = A_MN ? plane_map(&maps.a[t], a[t], a_rows, a_cols, TK)
               : plane_map(&maps.a[t], a[t], a_rows, a_cols, 64 * WG, 0, TK);
    if (err == cudaSuccess) err = plane_map(&maps.b[t], b[t], b_rows, b_cols, TK);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(e.N / TBN, (e.M + 64 * WG - 1) / (64 * WG), e.split);
  cfg.blockDim = dim3(128 * WG + (WG > 1 ? 128 : 32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = e.split;
  cfg.attrs = cluster;
  cfg.numAttrs = e.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, e);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// One product on the plan's tile (ops/resblock.py:f32_bwd_plan; F32_BWD_TILES there lists the
// tiles built here: (wg, cols, K tile)).
template <bool A_MN, int EPI>
cudaError_t run_terms3(int wg, int tbn, int tk, const void* const (&a)[3], int a_rows,
                       int a_cols, const void* const (&b)[3], int b_rows, int b_cols,
                       const Epi3& e, int device, cudaStream_t stream) {
#define K1_TERMS3_TILE(WG, TBN, TK)                                                         \
  if (wg == WG && tbn == TBN && tk == TK)                                                   \
    return launch_terms3<WG, TBN, TK, A_MN, EPI>(a, a_rows, a_cols, b, b_rows, b_cols, e, \
                                                 device, stream);
  K1_TERMS3_TILE(2, 128, 32)
  K1_TERMS3_TILE(1, 64, 64)
#undef K1_TERMS3_TILE
  return cudaErrorInvalidValue;
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

bool bad_shape(int B, int H) { return B < 1 || H < 64 || H % 64; }

}  // namespace

extern "C" {

// The f32 policy's forward for x (B, H), given the small planes of W1 and W2 (W - big(W), f32):
// writes x's small plane (xs), a1, h, h's small plane (hs) and a2 (a1, h and a2 saved for the
// backward), and y, all f32 (B, H), on the tile plan (wg, tbn, a_rows, stages) of
// ops/resblock.py:f32_plan. Three launches on `stream`; returns the cudaError_t of the launches
// (0 = ok); does not synchronise.
int res_block_forward_f32(const void* x, const void* w1, const void* w1s, const void* b1,
                          const void* w2, const void* w2s, const void* b2, void* xs, void* hs,
                          void* a1, void* h, void* a2, void* y, int B, int H, int wg, int kw,
                          int tbn, int a_rows, int chunk, int stages, int a_split, int device,
                          void* stream) {
  if (bad_shape(B, H)) return (int)cudaErrorInvalidValue;
  EpiF32 l1 = {};
  l1.out0 = static_cast<float*>(a1);
  l1.out1 = static_cast<float*>(h);
  l1.small = static_cast<float*>(hs);
  l1.bias = static_cast<const float*>(b1);
  l1.M = B;
  l1.N = l1.K = H;
  l1.a_rows = a_rows;
  l1.chunk = chunk;
  l1.stages = stages;
  EpiF32 l2 = l1;
  l2.out0 = static_cast<float*>(a2);
  l2.out1 = static_cast<float*>(y);
  l2.small = nullptr;
  l2.bias = static_cast<const float*>(b2);
  l2.aux = static_cast<const float*>(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    // A = x (B x H) and B(n, k) = W1[n, k]; then A = h, B = W2: both K-major. Under a_split
    // neither x's nor h's small plane is made in device memory.
    cudaError_t e = cudaSuccess;
    if (a_split) l1.small = nullptr;
    else e = small_plane(x, xs, static_cast<long long>(B) * H, device, s);
    if (e == cudaSuccess) e = run_tf32<kFwd1>(wg, kw, tbn, a_split, x, xs, w1, w1s, l1, device, s);
    if (e == cudaSuccess) e = run_tf32<kFwd2>(wg, kw, tbn, a_split, h, hs, w2, w2s, l2, device, s);
    return e;
  });
}

// The small plane of v (rows x cols f32): v - big(v), big(v) being v with its low 13 mantissa
// bits cleared. One launch on `stream`.
int res_block_small(const void* v, void* small, int rows, int cols, int device, void* stream) {
  if (rows < 1 || cols < 4 || cols % 4) return (int)cudaErrorInvalidValue;
  return on_device(device, [&]() {
    return small_plane(v, small, static_cast<long long>(rows) * cols, device,
                       static_cast<cudaStream_t>(stream));
  });
}

// out (M x N) = a (M x K) b^T (N x K), f32 handed to wgmma as tf32 in one pass (no small
// terms), on 64 x 64 tiles: what the tensor core makes of raw f32 operands. One launch.
int res_block_tf32_product(const void* a, const void* b, void* out, int M, int N, int K,
                           int device, void* stream) {
  if (M < 1 || N < 64 || N % 64 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  EpiF32 e = {};
  e.out0 = static_cast<float*>(out);
  e.M = M;
  e.N = N;
  e.K = K;
  e.a_rows = M >= 64 ? 64 : (M + 7) / 8 * 8;
  e.chunk = 1;
  e.stages = 4;
  return on_device(device, [&]() {
    return launch_tf32<1, 1, 64, kProduct, false, false>(a, nullptr, b, nullptr, e, device,
                                               static_cast<cudaStream_t>(stream));
  });
}

// A block's dynamic shared memory on the tile plan (wg, tbn, a_rows, chunk, stages) of the
// three-pass product: what ops/resblock.py:f32_smem_bytes computes.
int res_block_f32_smem_bytes(int wg, int tbn, int a_rows, int chunk, int stages) {
  return f32_smem_bytes(wg, tbn, a_rows, chunk, stages, true);
}

// The f32 policy's backward: from dy and the saved x, h, a1, a2 (f32, B x H) and the three term
// planes of W1 and W2 (bf16, 3 x H x H each, made by res_block_split), writes dx (B, H), dW1,
// dW2 (H, H, torch layout), db1, db2 (H), using as scratch twelve bf16 (B, H) planes (the terms
// of g2, g1, x, h) followed by the column sums of each 16 rows of g1 and of g2 (two f32 ceil(B /
// 16) x H). (act_wg, act_cols, act_tk, act_split, act_stages) is ops/resblock.py:f32_bwd_plan's
// tile of dh and dx, (w_*) of dW1 and dW2. Six launches on `stream`; returns the cudaError_t of
// the launches (0 = ok); does not synchronise.
int res_block_backward_f32(const void* dy, const void* x, const void* w1t, const void* w2t,
                           const void* a1, const void* h, const void* a2, void* scratch,
                           void* dx, void* dw1, void* db1, void* dw2, void* db2, int B, int H,
                           int act_wg, int act_cols, int act_tk, int act_split, int act_stages,
                           int w_wg, int w_cols, int w_tk, int w_split, int w_stages, int device,
                           void* stream) {
  if (bad_shape(B, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(B) * H;
  __nv_bfloat16* planes = static_cast<__nv_bfloat16*>(scratch);
  auto terms = [&](int k) {  // operand k's three planes: g2, g1, x, h
    __nv_bfloat16* p = planes + 3 * k * plane;
    return SplitSrc{nullptr, nullptr, {p, p + plane, p + 2 * plane}, nullptr};
  };
  const SplitSrc g2 = terms(0), g1 = terms(1), xt = terms(2), ht = terms(3);
  float* sums1 = reinterpret_cast<float*>(planes + 12 * plane);
  float* sums2 = sums1 + static_cast<long long>((B + kSumRows - 1) / kSumRows) * H;
  // one launch: g2 = dy * lrelu'(a2) with its column sums, x and h
  Split sp = {};
  sp.src[0] = {static_cast<const float*>(dy), static_cast<const float*>(a2),
               {g2.t[0], g2.t[1], g2.t[2]}, sums2};
  sp.src[1] = {static_cast<const float*>(x), nullptr, {xt.t[0], xt.t[1], xt.t[2]}, nullptr};
  sp.src[2] = {static_cast<const float*>(h), nullptr, {ht.t[0], ht.t[1], ht.t[2]}, nullptr};
  sp.rows = B;
  sp.cols = H;
  const __nv_bfloat16* w1p = static_cast<const __nv_bfloat16*>(w1t);
  const __nv_bfloat16* w2p = static_cast<const __nv_bfloat16*>(w2t);
  const long long wplane = static_cast<long long>(H) * H;
  const void* const w1_terms[3] = {w1p, w1p + wplane, w1p + 2 * wplane};
  const void* const w2_terms[3] = {w2p, w2p + wplane, w2p + 2 * wplane};
  const void* const g2_terms[3] = {g2.t[0], g2.t[1], g2.t[2]};
  const void* const g1_terms[3] = {g1.t[0], g1.t[1], g1.t[2]};
  const void* const x_terms[3] = {xt.t[0], xt.t[1], xt.t[2]};
  const void* const h_terms[3] = {ht.t[0], ht.t[1], ht.t[2]};
  // g1 = (g2 W2) * lrelu'(a1): A = g2 (B x H), B(n, k) = W2[k, n] (N-contiguous); its planes,
  // and its column sums for db1
  Epi3 edh = {};
  edh.plane[0] = g1.t[0];
  edh.plane[1] = g1.t[1];
  edh.plane[2] = g1.t[2];
  edh.aux = static_cast<const float*>(a1);
  edh.colsum = sums1;
  edh.M = B;
  edh.N = edh.K = H;
  edh.stages = act_stages;
  edh.split = act_split;
  // dx = dy + g1 W1: B(n, k) = W1[k, n]
  Epi3 edx = edh;
  edx.out = static_cast<float*>(dx);
  edx.aux = static_cast<const float*>(dy);
  edx.colsum = nullptr;
  // dW2[o, i] = sum_b g2[b, o] h[b, i]: A(o, b) = g2[b, o] (M-contiguous), B(i, b) = h[b, i]
  // (N-contiguous), K = B
  Epi3 edw2 = {};
  edw2.out = static_cast<float*>(dw2);
  edw2.M = edw2.N = H;
  edw2.K = B;
  edw2.stages = w_stages;
  edw2.split = w_split;
  // dW1[o, i] = sum_b g1[b, o] x[b, i]
  Epi3 edw1 = edw2;
  edw1.out = static_cast<float*>(dw1);
  return on_device(device, [&]() {
    cudaError_t e = split(sp, 3, s);
    if (e == cudaSuccess)
      e = run_terms3<false, kDh>(act_wg, act_cols, act_tk, g2_terms, B, H, w2_terms, H, H, edh,
                                 device, s);
    if (e == cudaSuccess)
      e = run_terms3<true, kDw>(w_wg, w_cols, w_tk, g2_terms, B, H, h_terms, B, H, edw2, device,
                                s);
    if (e == cudaSuccess)
      e = run_terms3<false, kDx>(act_wg, act_cols, act_tk, g1_terms, B, H, w1_terms, H, H, edx,
                                 device, s);
    if (e == cudaSuccess)
      e = run_terms3<true, kDw>(w_wg, w_cols, w_tk, g1_terms, B, H, x_terms, B, H, edw1, device,
                                s);
    if (e == cudaSuccess)
      e = bias_grads(sums1, sums2, db1, db2, (B + kSumRows - 1) / kSumRows, H, s);
    return e;
  });
}

// A block's dynamic shared memory on the f32 backward's tile (wg, cols, K tile tk) with `stages`
// stages: what ops/resblock.py:f32_bwd_smem_bytes computes.
int res_block_f32_bwd_smem_bytes(int wg, int cols, int tk, int stages) {
  return terms3_smem_bytes(wg, cols, tk, stages);
}

// Splits v (rows x cols f32), times lrelu'(mask) if mask is not null, into its bf16 term planes
// t0, t1 and t2 (rows x cols each), each written if not null. One launch on `stream`.
int res_block_split(const void* v, const void* mask, void* t0, void* t1, void* t2, int rows,
                    int cols, int device, void* stream) {
  if (rows < 1 || cols < 4 || cols % 4) return (int)cudaErrorInvalidValue;
  const Split p = one_split(v, mask, t0, t1, t2, nullptr, rows, cols);
  return on_device(device,
                   [&]() { return split(p, 1, static_cast<cudaStream_t>(stream)); });
}

// The bf16 policy's forward for x (B, H), given the bf16 planes of W1 and W2: writes the x
// plane, a1, the h plane, a2 (saved for the backward) and y, both products on the plan
// (persistent, rows, cols, k_split, grid) of ops/resblock.py:bf16_plan. Where the plan splits K,
// `partial` holds k_split x B x H f32 and `count` 2 x its tiles ints (zeroed by the x split).
// Three launches on `stream`.
int res_block_forward_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* xp, void* a1, void* hp, void* a2, void* y,
                           void* partial, void* count, int B, int H, int persistent, int rows,
                           int cols, int k_split, int grid, int device, void* stream) {
  if (bad_shape(B, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bf16Plan plan = {persistent, rows, cols, k_split, grid};
  Epi16 l1 = {};
  l1.out0 = static_cast<float*>(a1);
  l1.plane0 = static_cast<__nv_bfloat16*>(hp);
  l1.bias = static_cast<const float*>(b1);
  l1.M = B;
  l1.N = l1.K = H;
  Epi16 l2 = l1;
  l2.out0 = static_cast<float*>(a2);
  l2.out1 = static_cast<float*>(y);
  l2.plane0 = nullptr;
  l2.bias = static_cast<const float*>(b2);
  l2.aux = static_cast<const float*>(x);
  const Planes p1 = {{xp, nullptr}, B, H, w1, H, H};  // A = x (B x H), B(n, k) = W1[n, k]
  const Planes p2 = {{hp, nullptr}, B, H, w2, H, H};
  float* part = static_cast<float*>(partial);
  int* c1 = k_split > 1 ? static_cast<int*>(count) : nullptr;
  int* c2 = c1 ? c1 + plan_tiles(plan, B, H) : nullptr;
  Split sx = one_split(x, nullptr, xp, nullptr, nullptr, nullptr, B, H);
  sx.zero = c1;
  sx.n_zero = c1 ? 2 * plan_tiles(plan, B, H) : 0;
  return on_device(device, [&]() {
    cudaError_t e = split(sx, 1, s);
    if (e == cudaSuccess) e = run_wgmma<1, false, false, kFwd1>(p1, l1, plan, part, c1, device, s);
    if (e == cudaSuccess) e = run_wgmma<1, false, false, kFwd2>(p2, l2, plan, part, c2, device, s);
    return e;
  });
}

// The bf16 policy's backward: from dy (f32), the saved x and h planes, a1 and a2 (f32) and the
// planes of W1 and W2, writes dx (B, H), dW1, dW2 (H, H, torch layout), db1, db2 (H), using as
// scratch four (B, H) bf16 planes (g2's hi and lo, g1's hi and lo) and the column sums of each
// 16 rows of g1 and of g2 (two f32 ceil(B / 16) x H). dh and dx run on the plan (act_*) of
// ops/resblock.py:bf16_plan, dW1 and dW2 on (w_*). Where a plan splits K, `partial` holds split
// x (its product's M x N) f32 and `count` the slice counters of dh, dx, dW2 and dW1 in turn (the
// tiles of each product; zeroed by the g2 split). Six launches on `stream`.
int res_block_backward_bf16(const void* dy, const void* xp, const void* w1, const void* w2,
                            const void* a1, const void* hp, const void* a2, void* g2hi,
                            void* g2lo, void* g1hi, void* g1lo, void* sums1, void* sums2,
                            void* partial, void* count, void* dx, void* dw1, void* db1,
                            void* dw2, void* db2, int B, int H, int act_persistent, int act_rows,
                            int act_cols, int act_split, int act_grid, int w_persistent,
                            int w_rows, int w_cols, int w_split, int w_grid, int device,
                            void* stream) {
  if (bad_shape(B, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bf16Plan act = {act_persistent, act_rows, act_cols, act_split, act_grid};
  const Bf16Plan wgt = {w_persistent, w_rows, w_cols, w_split, w_grid};
  // g1 = round(g2 W2) * lrelu'(a1): A = g2 (B x H), B(n, k) = W2[k, n] (N-contiguous); its
  // planes, and its column sums for db1
  Epi16 edh = {};
  edh.colsum = static_cast<float*>(sums1);
  edh.plane0 = static_cast<__nv_bfloat16*>(g1hi);
  edh.plane1 = static_cast<__nv_bfloat16*>(g1lo);
  edh.aux = static_cast<const float*>(a1);
  edh.M = B;
  edh.N = edh.K = H;
  const Planes pdh = {{g2hi, g2lo}, B, H, w2, H, H};
  // dx = dy + round(g1 W1): B(n, k) = W1[k, n]
  Epi16 edx = {};
  edx.out0 = static_cast<float*>(dx);
  edx.aux = static_cast<const float*>(dy);
  edx.M = B;
  edx.N = edx.K = H;
  const Planes pdx = {{g1hi, g1lo}, B, H, w1, H, H};
  // dW2[o, i] = round(sum_b g2[b, o] h[b, i]): A(o, b) = g2[b, o] (M-contiguous), B(i, b) =
  // h[b, i] (N-contiguous), K = B
  Epi16 edw2 = {};
  edw2.out0 = static_cast<float*>(dw2);
  edw2.M = edw2.N = H;
  edw2.K = B;
  const Planes pdw2 = {{g2hi, g2lo}, B, H, hp, B, H};
  // dW1[o, i] = round(sum_b g1[b, o] x[b, i])
  Epi16 edw1 = edw2;
  edw1.out0 = static_cast<float*>(dw1);
  const Planes pdw1 = {{g1hi, g1lo}, B, H, xp, B, H};
  float* part = static_cast<float*>(partial);
  const int act_tiles = plan_tiles(act, B, H), w_tiles = plan_tiles(wgt, H, H);
  int* const c = static_cast<int*>(count);
  int* const cdh = c && act_split > 1 ? c : nullptr;
  int* const cdx = cdh ? c + act_tiles : nullptr;
  int* const cdw2 = c && w_split > 1 ? c + 2 * act_tiles : nullptr;
  int* const cdw1 = cdw2 ? cdw2 + w_tiles : nullptr;
  Split sg = one_split(dy, a2, g2hi, g2lo, nullptr, sums2, B, H);
  sg.zero = c;
  sg.n_zero = c ? 2 * (act_tiles + w_tiles) : 0;
  return on_device(device, [&]() {
    cudaError_t e = split(sg, 1, s);
    if (e == cudaSuccess) e = run_wgmma<2, false, true, kDh>(pdh, edh, act, part, cdh, device, s);
    if (e == cudaSuccess) e = run_wgmma<2, true, true, kDw>(pdw2, edw2, wgt, part, cdw2, device, s);
    if (e == cudaSuccess) e = run_wgmma<2, false, true, kDx>(pdx, edx, act, part, cdx, device, s);
    if (e == cudaSuccess) e = run_wgmma<2, true, true, kDw>(pdw1, edw1, wgt, part, cdw1, device, s);
    if (e == cudaSuccess)
      e = bias_grads(sums1, sums2, db1, db2, (B + kSumRows - 1) / kSumRows, H, s);
    return e;
  });
}

// A block's dynamic shared memory on the bf16 plan's tile (persistent, rows, cols) for a
// product of `terms` A planes (1: the forward's, 2: the backward's): what
// ops/resblock.py:bf16_smem_bytes computes.
int res_block_bf16_smem_bytes(int persistent, int rows, int cols, int terms, int staged) {
  const int stage = terms * rows * 128 + cols * 128;
  if (persistent) return persistent_smem(stage, staged);
  return ring_stages(stage) * (stage + 16) + 1024;
}

const char* res_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
