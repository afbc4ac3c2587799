// wgmma grouped-GEMM engine for Hopper (sm_90a) behind the bf16 MoE SwiGLU
// input gradient (moe_gmm_bwd.cu): the two passes of the dx kernel, each a
// grouped GEMM over expert-sorted 128-row tiles whose weight operand is the
// bank of the tile's own expert.
//
// Replaces, for bf16, ai_toolkit_tpu/ops/pallas/moe_gmm.py `_dx_kernel` (and
// the first half of what `_dw_kernel` recomputes): with g = tile_group[tile],
//   pass 1, hidden (DX_HIDDEN, DW_HIDDEN): h1 = x W1[g], h3 = x W3[g] and
//     dp = dy W2[g]^T over a 128 x 64 tile of the hidden axis, then in
//     registers dh1 = dp h3 silu'(h1), dh3 = dp silu(h1) (and, DW_HIDDEN,
//     act = silu(h1) h3; ait_moe::epilogue), written bf16 to dh [N, 2h] (and
//     act [N, h]);
//   pass 2, out (DX_OUT): dx = [dh1 | dh3] [W1[g] | W3[g]]^T over a 128 x BN
//     tile of dx, one reduction over K = 2h.
// All sums are f32. The Pallas kernel's [block_m, d] f32 accumulator does not
// fit 227 KB, so dh goes through device memory in bf16 between the passes.
// The forward is pass 1 without dp (GATE_UP), and its second GEMM is pass 2
// with K = h (DOWN): the engine is meant to carry both.
//
// What bounds it: pass 1 does 6 N d h operations, pass 2 4 N d h (10 N d h
// in all: 1.45 TFLOP, 1.47 ms at 989 TFLOP/s at the hidream double-block shape
// N = 8192 routed rows, d = 2560, h = 6912, E = 4), against the banks (3 E d
// h), x, dy, dx (3 N d) and dh written and read (2 x 2 N h), about 1.0 GB of
// bf16 or 0.30 ms at 3.35 TB/s: compute-bound, if each operand comes from
// device memory about once.
//
// Design:
//   - one block per output tile; 384 threads: consumer warpgroups 0 and 1
//     own 64 rows each, one thread of producer warpgroup 2 reads its tile's
//     expert from tile_group and issues every TMA load at that expert's
//     coordinate (setmaxnreg 24 / 240);
//   - 64-deep k steps through a ring of mbarrier-guarded stages (pass 1, 64
//     hidden columns: x, dy 16 KB each, W1, W3, W2 8 KB each, 4 stages of 56
//     KB, which timed faster than 3 on the card; a 128-wide tile fits only 2
//     stages of 80 KB and timed no faster; pass 2, BN = 128: dh and W 16 KB
//     each, 4 stages of 32 KB); each consumer keeps one wgmma group in flight
//     (wait<1>) and frees a stage as soon as the group that read it is done;
//   - pass 1: h1 += x W1 and h3 += x W3 by SS wgmma with W1, W3 as MN-major B
//     (h is their contiguous dim), dp += dy W2^T with W2 as a K-major B: 3 x
//     32 f32 accumulators a thread; pass 2: dx += dh W^T with W1 for k < h,
//     W3 for k >= h (the producer picks the map per k step; h % 64 == 0, so
//     no step straddles the two), both K-major B;
//   - the epilogues run on the accumulators in registers and store bf16 pairs;
//     each output tile has one owner, no atomics: dx, dh and act are the same
//     bits from run to run;
//   - block order: a 1-D grid walks a table of tile indices that the wrapper
//     builds (ops/kernels/moe_gmm.py `block_order`): patches of P row tiles,
//     each swept column tile by column tile, so the blocks in flight share
//     both row tiles and weight-column tiles. P = sqrt(SMs x column-tile bytes
//     / row-tile bytes), the P that makes a wave's bytes least. At the
//     double-block shape (132 SMs): pass 1, P = 10, a wave touches 10 row
//     tiles of x and dy (13 MB) and ~13 column tiles of W1, W3, W2 (13 MB),
//     ~26 MB against the ~84 MB (all 64 row tiles of x and dy) of the
//     row-fast order it replaces, which read x and dy again for every column
//     tile, ~9 GB in all; now ~1.4 GB. Pass 2, P = 11: a wave touches 11 row
//     tiles of dh and 12 column tiles of [W1 | W3], ~0.8 GB over the pass
//     against ~2.3 GB (all of dh once per pair of column tiles).
// Traps met:
//   - the 128-byte swizzle caps a box at 64 bf16 columns: a 64-deep k step is
//     one box of A, and pass 1's 64 hidden columns one box of MN-major B;
//   - the banks are 3-D maps over (columns, rows, expert), so a box never
//     reads into the next expert's matrix.

#pragma once

#include "hopper.cuh"
#include "moe_gmm_tile.cuh"

namespace ait_moe {
namespace sm90 {

constexpr int BK = 64;  // reduction depth of one stage: one 128-byte box of bf16
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;
constexpr int A_TILE = BM * BK * 2;  // one 128 x 64 bf16 A tile (x, dy or dh)
constexpr int BN_HIDDEN = 64;        // hidden columns of one pass-1 tile: one box

struct HiddenParams {
  CUtensorMap x, dy;      // [N, d]: dims (d, N), boxes 64 x BM
  CUtensorMap w1, w3;     // [E, d, h]: dims (h, d, E), boxes 64 x BK x 1
  CUtensorMap w2;         // [E, h, d]: dims (d, h, E), boxes 64 x BN_HIDDEN x 1
  const int* tile_group;  // expert of each row tile
  const int* order;       // tile index m * col_tiles + n of each block
  int col_tiles, k_steps, h;
  bf16* dh;   // [N, 2h]: dh1 | dh3
  bf16* act;  // [N, h], DW_HIDDEN only
};

struct OutParams {
  CUtensorMap dh;      // [N, 2h]: dims (2h, N), boxes 64 x BM
  CUtensorMap w1, w3;  // [E, d, h]: dims (h, d, E), boxes 64 x BN x 1
  const int* tile_group;
  const int* order;
  int col_tiles, k_steps, k_split;  // k steps < k_split read W1, the rest W3
  int d;
  bf16* dx;  // [N, d]
};

struct HiddenSmem {
  static constexpr int STAGES = 4;  // of 56 KB
  static constexpr int W_TILE = BK * BN_HIDDEN * 2;  // W1, W3 or W2: one box
  static constexpr int x = 0, dy = A_TILE, w1 = 2 * A_TILE, w3 = w1 + W_TILE, w2 = w3 + W_TILE;
  static constexpr int stage = w2 + W_TILE;
  static constexpr int bar = STAGES * stage;  // full[STAGES], empty[STAGES]
  static constexpr int bytes = bar + 16 * STAGES + 1024;  // + slack to align the base to 1024
  static_assert(bytes <= 232448, "shared memory of one block");
};

template <int BN>
struct OutSmem {
  static constexpr int STAGES = 4;
  static constexpr int a = 0, b = A_TILE;
  static constexpr int stage = A_TILE + BN * BK * 2;
  static constexpr int bar = STAGES * stage;
  static constexpr int bytes = bar + 16 * STAGES + 1024;
  static_assert(bytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// Pass 1. Grid: one block per 128 x BN_HIDDEN tile of the hidden axis, in
// the order of p.order; THREADS threads; HiddenSmem::bytes dynamic shared
// memory.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) moe_dx_hidden_sm90(__grid_constant__ const HiddenParams p) {
  static_assert(MODE == DX_HIDDEN || MODE == DW_HIDDEN, "the hidden pass of dx or dw");
  constexpr int BN = BN_HIDDEN;
  using L = HiddenSmem;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + STAGES;
  const int t = p.order[blockIdx.x];
  const int m = t / p.col_tiles, n0 = (t % p.col_tiles) * BN;
  init_ring(full, empty, STAGES);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const int g = p.tile_group[m];
      for (int ks = 0; ks < p.k_steps; ++ks) {
        const int s = ks % STAGES;
        unsigned char* st = smem + s * L::stage;
        hopper::mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], L::stage);
        hopper::tma_load_2d(st + L::x, &p.x, &full[s], ks * BK, m * BM);
        hopper::tma_load_2d(st + L::dy, &p.dy, &full[s], ks * BK, m * BM);
        hopper::tma_load_3d(st + L::w1, &p.w1, &full[s], n0, ks * BK, g);
        hopper::tma_load_3d(st + L::w3, &p.w3, &full[s], n0, ks * BK, g);
        hopper::tma_load_3d(st + L::w2, &p.w2, &full[s], ks * BK, n0, g);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = 16 * (tid / 32) + lane / 4;  // and row + 8, within the warpgroup's 64
    const int col = 2 * (lane % 4);              // + 8j + {0, 1}
    float h1[BN / 2], h3[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) h1[i] = h3[i] = dp[i] = 0.f;
    hopper::fence_regs(h1);
    hopper::fence_regs(h3);
    hopper::fence_regs(dp);

    for (int ks = 0; ks < p.k_steps; ++ks) {
      const int s = ks % STAGES;
      const unsigned char* st = smem + s * L::stage;
      hopper::mbar_wait(&full[s], (ks / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t ax = hopper::desc_sw128(st + L::x + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t ady = hopper::desc_sw128(st + L::dy + wg * 64 * 128 + kk * 32, 16, 1024);
        hopper::Wgmma<BN, 1>::ss(h1, ax, hopper::desc_sw128(st + L::w1 + kk * 16 * 128, BK * 128, 1024), 1);
        hopper::Wgmma<BN, 1>::ss(h3, ax, hopper::desc_sw128(st + L::w3 + kk * 16 * 128, BK * 128, 1024), 1);
        hopper::Wgmma<BN, 0>::ss(dp, ady, hopper::desc_sw128(st + L::w2 + kk * 32, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the group of step ks - 1 is done with its stage
      if (ks > 0) hopper::mbar_arrive(&empty[(ks - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(h1);
    hopper::fence_regs(h3);
    hopper::fence_regs(dp);

    // epilogue in registers: (h1, h3, dp) -> (dh1, dh3, act), bf16 pairs
    const long long r0 = (long long)m * BM + wg * 64 + row;
    const long long ldh = 2LL * p.h;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        epilogue<MODE>(h1[i], h3[i], dp[i]);
        epilogue<MODE>(h1[i + 1], h3[i + 1], dp[i + 1]);
        const long long r = r0 + 8 * half;
        const int c = n0 + 8 * j + col;
        *reinterpret_cast<uint32_t*>(p.dh + r * ldh + c) = hopper::pack_bf16(h1[i], h1[i + 1]);
        *reinterpret_cast<uint32_t*>(p.dh + r * ldh + p.h + c) = hopper::pack_bf16(h3[i], h3[i + 1]);
        if constexpr (MODE == DW_HIDDEN)
          *reinterpret_cast<uint32_t*>(p.act + r * p.h + c) = hopper::pack_bf16(dp[i], dp[i + 1]);
      }
  }
}

// Pass 2. Grid: one block per 128 x BN tile of dx, in the order of p.order.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) moe_dx_out_sm90(__grid_constant__ const OutParams p) {
  using L = OutSmem<BN>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + STAGES;
  const int t = p.order[blockIdx.x];
  const int m = t / p.col_tiles, n0 = (t % p.col_tiles) * BN;
  init_ring(full, empty, STAGES);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const int g = p.tile_group[m];
      for (int ks = 0; ks < p.k_steps; ++ks) {
        const int s = ks % STAGES;
        unsigned char* st = smem + s * L::stage;
        hopper::mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], L::stage);
        hopper::tma_load_2d(st + L::a, &p.dh, &full[s], ks * BK, m * BM);
        // [dh1 | dh3] meets [W1 | W3]: the step's k columns of W1 or of W3
        const bool w3 = ks >= p.k_split;
        hopper::tma_load_3d(st + L::b, w3 ? &p.w3 : &p.w1, &full[s], (ks - (w3 ? p.k_split : 0)) * BK, n0, g);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = 16 * (tid / 32) + lane / 4;
    const int col = 2 * (lane % 4);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    hopper::fence_regs(acc);

    for (int ks = 0; ks < p.k_steps; ++ks) {
      const int s = ks % STAGES;
      const unsigned char* st = smem + s * L::stage;
      hopper::mbar_wait(&full[s], (ks / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::Wgmma<BN, 0>::ss(acc, hopper::desc_sw128(st + L::a + wg * 64 * 128 + kk * 32, 16, 1024),
                                 hopper::desc_sw128(st + L::b + kk * 32, 16, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (ks > 0) hopper::mbar_arrive(&empty[(ks - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    const long long r0 = (long long)m * BM + wg * 64 + row;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + col;
      *reinterpret_cast<uint32_t*>(p.dx + r0 * p.d + c) = hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(p.dx + (r0 + 8) * p.d + c) = hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <int MODE>
cudaError_t launch_hidden(const void* x, const void* dy, const void* w1, const void* w3, const void* w2,
                          const int* tile_group, const int* order, void* dh, void* act, int N, int d, int h, int E,
                          cudaStream_t stream) {
  HiddenParams p{};
  cudaError_t err = hopper::make_map_rows(&p.x, x, N, d, BM);
  if (err == cudaSuccess) err = hopper::make_map_rows(&p.dy, dy, N, d, BM);
  if (err == cudaSuccess) err = hopper::make_map_bank(&p.w1, w1, E, d, h, BK);
  if (err == cudaSuccess) err = hopper::make_map_bank(&p.w3, w3, E, d, h, BK);
  if (err == cudaSuccess) err = hopper::make_map_bank(&p.w2, w2, E, h, d, BN_HIDDEN);
  if (err != cudaSuccess) return err;
  p.tile_group = tile_group;
  p.order = order;
  p.col_tiles = h / BN_HIDDEN;
  p.k_steps = d / BK;
  p.h = h;
  p.dh = static_cast<bf16*>(dh);
  p.act = static_cast<bf16*>(act);
  auto kern = moe_dx_hidden_sm90<MODE>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, HiddenSmem::bytes);
  if (err != cudaSuccess) return err;
  kern<<<(N / BM) * (h / BN_HIDDEN), THREADS, HiddenSmem::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_out(const void* dh, const void* w1, const void* w3, const int* tile_group, const int* order,
                       void* dx, int N, int d, int h, int E, cudaStream_t stream) {
  OutParams p{};
  cudaError_t err = hopper::make_map_rows(&p.dh, dh, N, 2LL * h, BM);
  if (err == cudaSuccess) err = hopper::make_map_bank(&p.w1, w1, E, d, h, BN);
  if (err == cudaSuccess) err = hopper::make_map_bank(&p.w3, w3, E, d, h, BN);
  if (err != cudaSuccess) return err;
  p.tile_group = tile_group;
  p.order = order;
  p.col_tiles = d / BN;
  p.k_steps = 2 * h / BK;
  p.k_split = h / BK;
  p.d = d;
  p.dx = static_cast<bf16*>(dx);
  auto kern = moe_dx_out_sm90<BN>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, OutSmem<BN>::bytes);
  if (err != cudaSuccess) return err;
  kern<<<(N / BM) * (d / BN), THREADS, OutSmem<BN>::bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace ait_moe
