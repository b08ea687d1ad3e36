// Fused two-side lifter forward for serving (K2), hand-written for Hopper (sm_90a).
//
// Replaces links_tpu/ops/fused_infer.py:_kernel, the Pallas TPU kernel behind
// `links-lift --fused` (launched by fused_sides_forward there). One launch runs BOTH 11-joint
// side lifters end to end:
//   upscale (2J -> H, no activation)
//   7 residual blocks in chain order res_common, res_pose1..3, res_angle1..3,
//     each cur = lrelu(lrelu(lrelu(cur@W1+b1)@W2+b2) + cur)
//   the trunk (output of res_common) feeds res_pose1 and res_angle1
//   depth head (H -> J) after res_pose3, angle head (H -> 1) after res_angle3.
// Numerics are the bf16 policy of the JAX package: every matmul input is rounded to bf16,
// products are accumulated in f32, and bias, LeakyReLU (slope 0.01) and the residual are f32.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the chain weights are
// 2 sides * 7 blocks * 2 * H^2 * 2 B = 58.7 MB at H = 1024, more than the 50 MB L2, so every
// call streams them from HBM: 17.5 us. The work is 2 * B * H^2 * 28 FLOP, 30.1 GFLOP at
// B = 512, i.e. 30.4 us. Memory-bound below B ~ 290, compute-bound above. What costs more than
// either is the chain's 15 dependent phases (the upscale, then 14 layers): every phase waits
// for the one before it, across the whole card, so a phase's fixed costs (a barrier, the first
// load of its input, the epilogue's stores) set the time at small batch, and the traffic
// between L2 and the SMs (each block reads its full-K input rows and weight columns) at large.
//
// Design: a persistent kernel, one block per SM, cooperative launch (every block resident).
//   - A fixed tile plan (ops/fused_infer.py:plan, handed to the launch): block b owns one output
//     tile (side, row tile tm = b % row_tiles, column tile) with the full K = H, in every phase,
//     of one of three shapes: 64 x 16 (B <= 64), 64 x 64 (B <= 256), 128 x 64 with two consumer
//     warpgroups (B <= 512); ~128 tiles fill the card. No split-K.
//   - Both operands arrive by TMA (3D views of the bf16 arrays, 128-byte swizzle) in ring slots
//     of C K tiles (C = 4, 2, 1 by shape), one box and one full and one empty mbarrier per slot:
//     a barrier wait or a TMA issue costs ~100 cycles however little it moves.
//   - Weights stream ahead across the phases. One producer warp loads the block's weight columns
//     (w_chain kept in torch's (out, in) layout: K-major, wgmma reads it without a transpose),
//     layer after layer, into a ring of one to two layers. It never waits for a phase, only for
//     free slots, so a layer's weights arrive while the card waits at the barrier before it.
//   - The layer barrier is narrow and written by hand: a layer-l+1 tile needs only the layer-l
//     output rows of its own side and row tile, so each (side, row tile) has a counter in
//     device memory. A tile's epilogue stores its bf16 outputs, fences them for the async proxy
//     (fence.proxy.async), and adds one with release semantics; a second warp (the A loader)
//     spins with ld.acquire until the counter reaches the phase's count, then TMA-loads the
//     activation's K tiles (a plane of bf16 rows; box rows = the tile's rows below B, rounded up
//     to 8). The spins trap after ~10 s, so a wrong count fails and does not hang. The last
//     block to finish resets the counters: the caller zeroes nothing.
//   - Products: wgmma.mma_async m64nBNk16 bf16 x bf16 -> f32, A and B from shared memory, one
//     slot's products in flight, alternating between independent accumulator sets; rows past B
//     hold whatever the plane held there and are never stored.
//   - The epilogue works on the accumulators in registers: bias, lrelu, and on a block's second
//     layer the residual, which is the block's own f32 tile from the phase before, kept in
//     registers (so is the trunk tile saved after block 0), then the outer lrelu. It writes the
//     bf16 plane the next phase reads; no f32 activation leaves the SM.
//   - The upscale (K = 2J) is CUDA-core code in the register layout of the tile it feeds. The
//     narrow heads are summed from the registers too: each tile adds its columns' share of
//     bf16(cur) (bit for bit the plane, the heads' input under the policy) times the head's
//     weights into a partial per (row, output, column tile); at the end the column tiles'
//     partials are added in order.
// Planes (bf16, 2B x H each): P0, P1 alternate as phase outputs; T holds the trunk from phase 2
// to phase 9, which reads it. Every output element is summed in a fixed order: repeated runs
// agree bitwise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kChainBlocks = 7;
constexpr int kLayers = 2 * kChainBlocks;
constexpr int kPhases = 1 + kLayers;  // the upscale, then the chain layers
constexpr int kMaxIn = 32;            // upscale input width 2J (22 for a side lifter)
constexpr int kMaxRowTiles = 8;       // B <= 512 in row tiles of >= 64
constexpr int kDone = 2 * kMaxRowTiles;  // counters[kDone]: blocks finished
constexpr int kTK = 64;               // K tile: 64 bf16, one 128-byte swizzled row
constexpr int kMaxOut = 16;           // widest depth head (J = 11 for a side lifter)
constexpr int kConstRows = kPhases + kMaxOut + 1;  // per tile column: biases, head weights
constexpr float kSlope = 0.01f;

struct alignas(64) Params {
  // 3D views (64 columns, rows, H / 64 K tiles) in boxes of `chunk` K tiles
  CUtensorMap w_map;         // w_chain as (2 * 14 * H) x H, boxes of 64 x BN x chunk
  CUtensorMap plane_map[3];  // P0, P1, T as 2B x H, boxes of 64 x a_rows x chunk
  const float* x0;        // left input (B, in_dim), rows x0_stride floats apart
  const float* x1;        // right input
  const __nv_bfloat16* w_up;    // (2, in_dim, H)
  const float* b_up;            // (2, H)
  const float* b_chain;         // (2, 7, 2, H)
  const __nv_bfloat16* w_down;  // (2, J, H)
  const float* b_down;          // (2, J)
  const __nv_bfloat16* w_ang;   // (2, 1, H)
  const float* b_ang;           // (2, 1)
  __nv_bfloat16* planes;        // (3, 2, B, H)
  float* depth;                 // (2, B, J)
  float* angle;                 // (2, B, 1)
  float* part;                  // (2, B, J + 1, column tiles): the heads' partial sums
  int* counters;                // kDone + 1 ints, zero between calls
  int x0_stride, x1_stride;
  int B, in_dim, H, J;
  int row_tiles, a_rows, a_chunks, w_chunks;  // a_rows: of a TMA box, <= the tile's
};

// The plane a phase writes (0: P0, 1: P1, 2: T) and the plane it reads.
__device__ __forceinline__ int out_plane(int phase) {
  return phase == 2 ? 2 : phase < 2 ? phase : (phase & 1) ? 0 : 1;
}
__device__ __forceinline__ int in_plane(int phase) {
  return phase == 9 ? 2 : out_plane(phase - 1);  // block 4 starts from the trunk
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Spins until *c >= target. A wait that lasts ~10 s (a wrong count) traps.
__device__ __forceinline__ void wait_count(const int* c, int target) {
  long long t0 = 0;
  while (ld_acquire(c) < target) {
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// TMA: the 3D box of `map` at (c0, c1, c2) into shared memory at dst; its bytes count towards
// bar's transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Orders this thread's generic-proxy accesses before later async-proxy ones (TMA): of global and
// shared memory, or (cheaper: ~0.4-1 us less per phase on an H100) of global memory only.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// dst[i] = *src(i) for i < n (32-bit words; 0 where src(i) is null), by the kThreads threads
// of the consumer warpgroups, 24 loads in flight per thread from one load instruction each (a
// loop of single loads, or a load per source array, would wait for each: these are the kernel's
// first, cold reads).
template <int kThreads, typename F>
__device__ __forceinline__ void gather(uint32_t* dst, int n, F src) {
  constexpr int kLoads = 24;
  for (int i0 = threadIdx.x; i0 < n; i0 += kLoads * kThreads) {
    uint32_t v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const uint32_t* q = i0 + u * kThreads < n ? src(i0 + u * kThreads) : nullptr;
      v[u] = q ? __ldg(q) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (i0 + u * kThreads < n) dst[i0 + u * kThreads] = v[u];
  }
}

template <typename T>
__device__ __forceinline__ const uint32_t* word(const T* p) {
  return reinterpret_cast<const uint32_t*>(p);
}

template <int kThreads>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The end of a phase for this block's tile: its plane stores are made visible to the async
// proxy and to the other blocks, then its (side, row tile) counter goes up by one. Phase 0 also
// read the activation ring through the generic proxy (the upscale's inputs), which TMA writes
// next: its fence covers shared memory too.
template <int kThreads>
__device__ __forceinline__ void finish_phase(int* counter, bool shared_too = false) {
  if (shared_too)
    fence_proxy_async();
  else
    fence_proxy_async_global();
  consumer_sync<kThreads>();
  if (threadIdx.x == 0)
    asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(counter)
                 : "memory");
}

// A thread's accumulators of an m64 x BN wgmma tile: j = 4q + e lies at row r0 (e < 2) or
// r0 + 8, column c0 + 8q + (e & 1). Rows past B are not stored.
template <int BN>
__device__ __forceinline__ void store_plane(const Params& p, __nv_bfloat16* plane, int side,
                                            int r0, int c0, const float (&v)[BN / 2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r < p.B) {
      __nv_bfloat16* row = plane + (static_cast<size_t>(side) * p.B + r) * p.H + c0;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * q) =
            __floats2bfloat162_rn(v[4 * q + 2 * h], v[4 * q + 2 * h + 1]);
    }
  }
}

// Upscale into this thread's accumulator positions:
// cur[r, c] = sum_k bf16(x[r, k]) * w_up[side, k, c] + b_up[side, c]. K = 2J is tiny, so f32
// FMAs (bf16 x bf16 products are exact in f32), from the tile's inputs that stage_upscale put in
// shared memory (`scratch`, words): w_up's columns as bf16 pairs (in_dim x BN / 2), x's rows
// (BM x in_dim f32, zero past B), b_up's columns (BN f32).
template <int kThreads, int BM, int BN>
__device__ __forceinline__ void stage_upscale(const Params& p, uint32_t* scratch, int side, int m0,
                                              int n0) {
  const int nw = p.in_dim * BN / 2, nx = BM * p.in_dim;
  const float* x = side ? p.x1 : p.x0;
  const int stride = side ? p.x1_stride : p.x0_stride;
  const __nv_bfloat16* w = p.w_up + static_cast<size_t>(side) * p.in_dim * p.H + n0;
  gather<kThreads>(scratch, nw + nx + BN, [&](int i) -> const uint32_t* {
    if (i < nw) return word(w + static_cast<size_t>(i / (BN / 2)) * p.H + 2 * (i % (BN / 2)));
    i -= nw;
    if (i >= nx) return word(p.b_up + side * p.H + n0 + i - nx);
    const int r = m0 + i / p.in_dim;
    return r < p.B ? word(x + static_cast<size_t>(r) * stride + i % p.in_dim) : nullptr;
  });
}

template <int BM, int BN>
__device__ __forceinline__ void upscale(const Params& p, const uint32_t* scratch, int m0, int n0,
                                        int r0, int c0, float (&cur)[BN / 2]) {
  const __nv_bfloat162* ws = reinterpret_cast<const __nv_bfloat162*>(scratch);
  const float* xs = reinterpret_cast<const float*>(scratch + p.in_dim * BN / 2);
  const float* bias = xs + BM * p.in_dim;
  const float* xa = xs + (r0 - m0) * p.in_dim;
  const float* xb = xa + 8 * p.in_dim;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) cur[i] = 0.f;
#pragma unroll 4
  for (int k = 0; k < p.in_dim; ++k) {
    const float a0 = round_bf16(xa[k]), a1 = round_bf16(xb[k]);
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const float2 wv = __bfloat1622float2(ws[k * (BN / 2) + (c0 - n0) / 2 + 4 * q]);
      cur[4 * q] += a0 * wv.x;
      cur[4 * q + 1] += a0 * wv.y;
      cur[4 * q + 2] += a1 * wv.x;
      cur[4 * q + 3] += a1 * wv.y;
    }
  }
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + c0 - n0 + 8 * q);
    cur[4 * q] += bv.x;
    cur[4 * q + 1] += bv.y;
    cur[4 * q + 2] += bv.x;
    cur[4 * q + 3] += bv.y;
  }
}

// The heads' partial sums over this tile's columns, from the block's f32 output in registers
// rounded to bf16 (bit for bit the plane the next phase reads, the heads' input under the
// policy): for outputs j0 .. j0 + n_out - 1 with weight rows `w` (n_out x BN / 2 bf16 pairs in
// shared memory), part[side, r, j, tn] = sum over the tile's columns c of bf16(cur[r, c]) w[j, c].
template <int BN>
__device__ __forceinline__ void head_partials(const Params& p, const __nv_bfloat162* w, int j0,
                                              int n_out, int side, int r0, int c0, int n0,
                                              int tn, int nt, const float (&cur)[BN / 2]) {
  float xb[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) xb[i] = round_bf16(cur[i]);
  const int outs = p.J + 1;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    if (j >= n_out) break;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const float2 wv = __bfloat1622float2(w[j * (BN / 2) + (c0 - n0) / 2 + 4 * q]);
      s0 += xb[4 * q] * wv.x;
      s0 += xb[4 * q + 1] * wv.y;
      s1 += xb[4 * q + 2] * wv.x;
      s1 += xb[4 * q + 3] * wv.y;
    }
    // the quad's lanes hold the row's other columns
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (threadIdx.x % 4 == 0) {
      float* part = p.part + ((static_cast<size_t>(side) * p.B + r0) * outs + j0 + j) * nt + tn;
      if (r0 < p.B) part[0] = s0;
      if (r0 + 8 < p.B) part[static_cast<size_t>(8) * outs * nt] = s1;
    }
  }
}

__host__ __device__ constexpr int block_threads(int wg) { return 128 * wg + 64; }

// Threads: WG consumer warpgroups (rows 64 wg .. 64 wg + 63 of the tile each), then the weight
// producer warp, then the A loader warp. Both rings move in chunks of C K tiles: one TMA box and
// one full and one empty mbarrier per chunk, since a barrier wait or a TMA issue costs ~100
// cycles however little it moves. C is a template parameter so that the chunk's products are
// one unrolled sequence (a loop with a runtime bound makes ptxas add warpgroup fences).
template <int WG, int BN, int C>
__global__ void __launch_bounds__(block_threads(WG), 1)
    fused_sides_kernel(const __grid_constant__ Params p) {
  constexpr int BM = 64 * WG;
  constexpr int kThreads = 128 * WG;  // consumer threads
  constexpr int kAcc = BN / 2;        // accumulators per consumer thread
  // independent accumulator sets that a chunk's k16 products alternate between, so that they
  // need not wait for each other; summed in a fixed order after the K loop
  constexpr int kSets = BN == 16 ? 4 : 2;
  constexpr int kWBytes = BN * 128;   // one K tile of the weight tile
  constexpr int kConsumerWarps = 4 * WG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle's alignment
  const int a_box = p.a_rows * 128;          // one K tile of the tile's rows: 1024-byte multiple
  const int a_chunk = C * a_box;             // one chunk of the activation tile
  const int w_chunk = C * kWBytes;           // one chunk of the weight tile
  const uint32_t a_ring = base;
  const uint32_t w_ring = a_ring + p.a_chunks * a_chunk;
  const uint32_t a_full = w_ring + p.w_chunks * w_chunk;
  const uint32_t a_empty = a_full + 8 * p.a_chunks;
  const uint32_t w_full = a_empty + 8 * p.a_chunks;
  const uint32_t w_empty = w_full + 8 * p.w_chunks;
  unsigned char* const gbase = smem_raw + (base - smem_addr(smem_raw));  // generic pointers
  // per tile column: a bias row for each chain layer (phases 1 ..), then the rows of w_down
  // and w_ang as bf16 pairs
  float* const sconst = reinterpret_cast<float*>(gbase + (w_empty + 8 * p.w_chunks - base));
  const __nv_bfloat162* const shead =
      reinterpret_cast<const __nv_bfloat162*>(sconst + kPhases * BN);

  const int nt = p.H / BN, mt = p.row_tiles;
  const int tm = blockIdx.x % mt, tn = (blockIdx.x / mt) % nt, side = blockIdx.x / (mt * nt);
  const int m0 = tm * BM, n0 = tn * BN;
  int* counter = p.counters + side * kMaxRowTiles + tm;
  const int kchunks = p.H / kTK / C;  // chunks of a layer's K
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.a_chunks; ++s) {
      mbar_init(a_full + 8 * s, 1);                // the loader's arrival, plus the bytes
      mbar_init(a_empty + 8 * s, kConsumerWarps);  // one arrival per consumer warp
    }
    for (int s = 0; s < p.w_chunks; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the weight producer: every layer's chunks, never waiting
    // for a phase, only for free slots; it starts once the upscale's inputs have arrived
    asm volatile("bar.sync 2, %0;\n" ::"n"(kThreads + 32) : "memory");
    if (lane == 0) {
      int s = 0, g = 0;
      uint32_t ph = 0;
      for (int layer = 0; layer < kLayers; ++layer) {
        const int row = (side * kLayers + layer) * p.H + n0;
        for (int kc = 0; kc < kchunks; ++kc, ++g) {
          if (g >= p.w_chunks) mbar_wait(w_empty + 8 * s, ph ^ 1);
          mbar_arrive_expect_tx(w_full + 8 * s, w_chunk);
          tma_load_3d(w_ring + s * w_chunk, &p.w_map, w_full + 8 * s, 0, row, kc * C);
          if (++s == p.w_chunks) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }
  if (warp == kConsumerWarps + 1) {  // the A loader: a phase's input once it is complete
    if (lane == 0) {
      int s = 0, g = 0;
      uint32_t ph = 0;
      const int row0 = side * p.B + m0;
      for (int phase = 1; phase < kPhases; ++phase) {
        wait_count(counter, nt * phase);  // every tile of phases 0 .. phase - 1
        fence_proxy_async_global();
        const CUtensorMap* map = &p.plane_map[in_plane(phase)];
        for (int kc = 0; kc < kchunks; ++kc, ++g) {
          // a phase starts with every slot released (this block's products of the phase
          // before are done): only a slot reused within the phase needs the wait
          if (kc >= p.a_chunks) mbar_wait(a_empty + 8 * s, ph ^ 1);
          mbar_arrive_expect_tx(a_full + 8 * s, a_chunk);
          tma_load_3d(a_ring + s * a_chunk, map, a_full + 8 * s, 0, row0, kc * C);
          if (++s == p.a_chunks) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  const int wg = warp / 4;
  const int r0 = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // this thread's rows: r0, r0 + 8
  const int c0 = n0 + 2 * (lane % 4);
  const size_t plane_elems = static_cast<size_t>(2) * p.B * p.H;
  float acc[kSets][kAcc], cur[kAcc], trunk[kAcc];

  // phase 0, the upscale, its inputs staged in the activation ring, idle until phase 1
  uint32_t* const scratch = reinterpret_cast<uint32_t*>(gbase);
  stage_upscale<kThreads, BM, BN>(p, scratch, side, m0, n0);
  consumer_sync<kThreads>();
  asm volatile("bar.arrive 2, %0;\n" ::"n"(kThreads + 32) : "memory");  // the producer may start
  upscale<BM, BN>(p, scratch, m0, n0, r0, c0, cur);
  store_plane<BN>(p, p.planes, side, r0, c0, cur);
  finish_phase<kThreads>(counter, true);
  // the chain layers' biases and the heads' weight columns, while phase 0 completes elsewhere
  gather<kThreads>(reinterpret_cast<uint32_t*>(sconst + BN), kLayers * BN + (p.J + 1) * BN / 2,
                   [&](int i) -> const uint32_t* {
    if (i < kLayers * BN)
      return word(p.b_chain + static_cast<size_t>(side * kLayers + i / BN) * p.H + n0 + i % BN);
    i -= kLayers * BN;
    const int j = i / (BN / 2), c = n0 + 2 * (i % (BN / 2));
    return word((j < p.J ? p.w_down + static_cast<size_t>(side * p.J + j) * p.H
                         : p.w_ang + static_cast<size_t>(side) * p.H) + c);
  });
  consumer_sync<kThreads>();

  int as = 0, ws = 0;
  uint32_t aph = 0, wph = 0;
  for (int phase = 1; phase < kPhases; ++phase) {
    const int layer = phase - 1, blk = layer / 2, l = layer % 2;
    if (blk == 4 && l == 0) {  // the angle chain starts from the trunk
#pragma unroll
      for (int i = 0; i < kAcc; ++i) cur[i] = trunk[i];
    }
#pragma unroll
    for (int t = 0; t < kSets; ++t)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[t][i] = 0.f;
    int prev_as = 0, prev_ws = 0;
    for (int kc = 0; kc < kchunks; ++kc) {
      mbar_wait(w_full + 8 * ws, wph);
      mbar_wait(a_full + 8 * as, aph);
      const uint32_t a = a_ring + as * a_chunk + wg * 64 * 128;  // this warpgroup's 64 rows
      const uint32_t b = w_ring + ws * w_chunk;
#pragma unroll
      for (int t = 0; t < kSets; ++t) fence_regs(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int kk = 0; kk < kTK / 16; ++kk)
          wgmma<BN, 0, 0>(acc[kk % kSets], smem_desc(a + c * a_box + kk * 32, 16, 1024),
                          smem_desc(b + c * kWBytes + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: release its slots
#pragma unroll
      for (int t = 0; t < kSets; ++t) fence_regs(acc[t]);
      if (kc > 0 && lane == 0) {
        mbar_arrive(a_empty + 8 * prev_as);
        mbar_arrive(w_empty + 8 * prev_ws);
      }
      prev_as = as;
      prev_ws = ws;
      if (++as == p.a_chunks) {
        as = 0;
        aph ^= 1;
      }
      if (++ws == p.w_chunks) {
        ws = 0;
        wph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kSets; ++t) fence_regs(acc[t]);
#pragma unroll
    for (int t = 1; t < kSets; ++t)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[0][i] += acc[t][i];
    if (lane == 0) {
      mbar_arrive(a_empty + 8 * prev_as);
      mbar_arrive(w_empty + 8 * prev_ws);
    }

    const float* bias = sconst + phase * BN + c0 - n0;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        float v = lrelu(acc[0][j] + ((e & 1) ? bv.y : bv.x));
        if (l == 1) {
          v = lrelu(v + cur[j]);
          cur[j] = v;
          if (blk == 0) trunk[j] = v;
        }
        acc[0][j] = v;
      }
    }
    store_plane<BN>(p, p.planes + out_plane(phase) * plane_elems, side, r0, c0, acc[0]);
    if (phase == kPhases - 1)  // the angle chain's output (block 6): the angle head's partials
      head_partials<BN>(p, shead + p.J * BN / 2, p.J, 1, side, r0, c0, n0, tn, nt, cur);
    finish_phase<kThreads>(counter);
    // The pose chain's output (block 3): the depth head's partials, off the critical path while
    // the next phase's input completes; a later phase's counter release publishes them.
    if (phase == 8) head_partials<BN>(p, shead, 0, p.J, side, r0, c0, n0, tn, nt, cur);
  }

  // Both heads, once every tile of the (side, row tile) has written its partials: each output
  // sums the column tiles' partials in order, the outputs shared by the (side, row tile)'s
  // blocks.
  if (threadIdx.x == 0) wait_count(counter, nt * kPhases);
  consumer_sync<kThreads>();
  const int outs = p.J + 1, rows = min(BM, p.B - m0);
  for (int it = tn * kThreads + threadIdx.x; it < rows * outs; it += nt * kThreads) {
    const int r = m0 + it / outs, j = it % outs;
    const float* src = p.part + ((static_cast<size_t>(side) * p.B + r) * outs + j) * nt;
    float v = 0.f;
#pragma unroll 16
    for (int t = 0; t < nt; ++t) v += __ldcg(src + t);  // written this launch: through L2
    if (j < p.J)
      p.depth[(static_cast<size_t>(side) * p.B + r) * p.J + j] = v + p.b_down[side * p.J + j];
    else
      p.angle[static_cast<size_t>(side) * p.B + r] = v + p.b_ang[side];
  }

  // The last block to get here resets the counters: every other block has passed its last wait.
  consumer_sync<kThreads>();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(p.counters + kDone, 1) == static_cast<int>(gridDim.x) - 1) {
      for (int i = 0; i <= kDone; ++i) atomicExch(p.counters + i, 0);
      __threadfence();
    }
  }
}

// The 3D view (64 columns, rows, cols / 64 K tiles) of a row-major bf16 array (rows x cols) in
// boxes of 64 x box_rows x chunk, 128-byte swizzle: a box lands in shared memory as `chunk`
// consecutive K tiles of box_rows rows of 128 bytes, the layout wgmma reads. Kept by address and
// shape, as plane_map keeps its maps.
cudaError_t chunk_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                      int chunk) {
  struct Key {
    const void* ptr;
    int rows, cols, box_rows, chunk;
  };
  static std::mutex mutex;
  static Key keys[64];
  static CUtensorMap maps[64];
  static int used = 0, next = 0;
  const Key key = {ptr, rows, cols, box_rows, chunk};
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < used; ++i) {
    const Key& k = keys[i];
    if (k.ptr == ptr && k.rows == rows && k.cols == cols && k.box_rows == box_rows &&
        k.chunk == chunk) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const EncodeTiled fn = encoder();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(cols / 64)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2, 128};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), static_cast<cuuint32_t>(chunk)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % 64;  // a ring: the oldest map goes first
  if (used < 64) ++used;
  return cudaSuccess;
}

template <int WG, int BN, int C>
cudaError_t launch(const Params& p, int grid, int smem, int device, cudaStream_t stream) {
  auto kernel = fused_sides_kernel<WG, BN, C>;
  static int sized[64] = {};  // the shared memory the kernel is allowed, per device
  if (sized[device] < smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized[device] = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // every block resident: the spins need it
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block_threads(WG));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<Params*>(&p)};
  cudaError_t err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

// The bytes the activation ring must hold before phase 1: the upscale's inputs, w_up's columns
// as bf16 pairs, x's rows and b_up's columns.
int scratch_bytes(int rows, int cols, int in_dim) {
  return (in_dim * (cols / 2 + rows) + cols) * 4;
}

}  // namespace

extern "C" {

// The dynamic shared memory the kernel needs for a plan: the alignment slack, the two rings
// and their barriers.
int fused_sides_smem_bytes(int rows, int cols, int a_rows, int chunk, int a_chunks,
                           int w_chunks) {
  return 1024 + a_chunks * chunk * a_rows * 128 + w_chunks * chunk * cols * 128 +
         16 * (a_chunks + w_chunks) + kConstRows * cols * 4;
}

// Launches the kernel on `stream` for a plan of ops/fused_infer.py (tile rows x cols, the A
// box's rows, K tiles per ring slot, the two rings' slots, shared memory bytes, grid); returns
// the cudaError_t of the launch (0 = ok). Does not synchronise. `planes` is scratch of
// 3 * 2 * B * H bf16 and `part` of 2 * B * (J + 1) * H / cols f32; `counters` holds kDone + 1
// ints that are zero before the first call on a stream and that every call leaves zero. Calls
// that share `counters` must not overlap.
int fused_sides_forward_launch(const void* x_left, const void* x_right, int left_stride,
                               int right_stride, const void* w_up, const void* b_up,
                               const void* w_chain, const void* b_chain, const void* w_down,
                               const void* b_down, const void* w_ang, const void* b_ang,
                               void* planes, void* depth, void* angle, void* part,
                               void* counters, int B, int in_dim, int H, int J, int rows,
                               int cols, int a_rows, int chunk, int a_chunks, int w_chunks,
                               int smem, int grid, int device, void* stream) {
  // the instantiated (rows, cols, chunk): the plans of ops/fused_infer.py
  const bool shape_ok = (rows == 64 && cols == 16 && (chunk == 4 || chunk == 2)) ||
                        (rows == 64 && cols == 64 && chunk == 2) ||
                        (rows == 128 && cols == 64 && chunk == 1);
  const int row_tiles = (B + rows - 1) / rows;
  if (!shape_ok || B < 1 || in_dim < 1 || in_dim > kMaxIn || J < 1 || J > kMaxOut ||
      H < kTK || H % kTK || H % cols || (H / kTK) % chunk || row_tiles > kMaxRowTiles ||
      grid != 2 * row_tiles * (H / cols) || a_rows % 8 || a_rows > rows ||
      a_rows < (B < rows ? B : rows) || a_chunks < 2 || w_chunks < 2 ||
      a_chunks * chunk * a_rows * 128 < scratch_bytes(rows, cols, in_dim) ||
      smem < fused_sides_smem_bytes(rows, cols, a_rows, chunk, a_chunks, w_chunks) ||
      device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;

  Params p = {};
  p.x0 = static_cast<const float*>(x_left);
  p.x1 = static_cast<const float*>(x_right);
  p.x0_stride = left_stride;
  p.x1_stride = right_stride;
  p.w_up = static_cast<const __nv_bfloat16*>(w_up);
  p.b_up = static_cast<const float*>(b_up);
  p.b_chain = static_cast<const float*>(b_chain);
  p.w_down = static_cast<const __nv_bfloat16*>(w_down);
  p.b_down = static_cast<const float*>(b_down);
  p.w_ang = static_cast<const __nv_bfloat16*>(w_ang);
  p.b_ang = static_cast<const float*>(b_ang);
  p.planes = static_cast<__nv_bfloat16*>(planes);
  p.depth = static_cast<float*>(depth);
  p.angle = static_cast<float*>(angle);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.in_dim = in_dim;
  p.H = H;
  p.J = J;
  p.row_tiles = row_tiles;
  p.a_rows = a_rows;
  p.a_chunks = a_chunks;
  p.w_chunks = w_chunks;

  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = chunk_map(&p.w_map, w_chain, 2 * kLayers * H, H, cols, chunk);
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = chunk_map(&p.plane_map[i], p.planes + static_cast<size_t>(i) * 2 * B * H, 2 * B, H,
                    a_rows, chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess) {
    if (rows == 128)
      err = launch<2, 64, 1>(p, grid, smem, device, s);
    else if (cols == 64)
      err = launch<1, 64, 2>(p, grid, smem, device, s);
    else if (chunk == 4)
      err = launch<1, 16, 4>(p, grid, smem, device, s);
    else
      err = launch<1, 16, 2>(p, grid, smem, device, s);
  }
  cudaSetDevice(prev);
  return (int)err;
}

const char* fused_sides_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
