// wgmma grouped-GEMM engine for Hopper (sm_90a) behind every bf16 MoE SwiGLU
// kernel: the forward (moe_gmm_fwd.cu), the input gradient (moe_gmm_bwd.cu)
// and the bank-gradient products (moe_gmm_dw.cu). Each pass is a grouped GEMM
// over expert-sorted 128-row tiles whose weight operand is the bank of the
// tile's own expert, or (dw) a GEMM per expert reduced over its run of tiles.
//
// Replaces, for bf16, ai_toolkit_tpu/ops/pallas/moe_gmm.py `_fwd_kernel`,
// `_dx_kernel` and `_dw_kernel`: with g = tile_group[tile],
//   hidden pass (moe_hidden_sm90) over a 128 x BN tile of the hidden axis:
//     GATE_UP (forward): h1 = x W1[g], h3 = x W3[g], then in registers
//       act = silu(h1) h3, written bf16 to act [N, h]; BN = 128 (64 where
//       h % 128 != 0);
//     DX_HIDDEN, DW_HIDDEN (dx, dw): also dp = dy W2[g]^T, then dh1 = dp h3
//       silu'(h1), dh3 = dp silu(h1) (and, DW_HIDDEN, act; ait_moe::epilogue)
//       to dh [N, 2h] (and act); BN = 64;
//   out pass (moe_out_sm90) over a 128 x BN tile of [N, d]:
//     DOWN (forward): y = act W2[g], K = h, W2 an MN-major B;
//     DX_OUT (dx): dx = [dh1 | dh3] [W1[g] | W3[g]]^T, K = 2h, K-major B;
//   dw products (moe_dw_sm90) over a 128 x BN tile of one expert's gradient:
//     [dW1 | dW3][g] = x_g^T [dh1 | dh3]_g and dW2[g] = act_g^T dy_g, the
//     reduction over the expert's rows, so both operands are MN-major.
// All sums are f32. The Pallas kernels' [block_m, d] f32 accumulator does not
// fit 227 KB, so act and dh go through device memory in bf16 between passes.
//
// What bounds them, at the hidream double-block shape (N = 8192 routed rows,
// d = 2560, h = 6912, E = 4): the forward does 6 N d h operations (0.87
// TFLOP, 0.88 ms at 989 TFLOP/s), dx 10 N d h, the dw products 6 N d h,
// against well under a GB of banks and activations each (0.3 ms at 3.35
// TB/s): compute-bound, if each operand comes from device memory about once.
//
// Design:
//   - one block per output tile; 384 threads: consumer warpgroups 0 and 1
//     own 64 rows each, one thread of producer warpgroup 2 reads its tile's
//     expert (or, dw, finds its expert's run) and issues every TMA load
//     (setmaxnreg 24 / 240);
//   - 64-deep k steps through a ring of 4 mbarrier-guarded stages; each
//     consumer keeps one wgmma group in flight (wait<1>) and frees a stage as
//     soon as the group that read it is done. Stages: GATE_UP at BN = 128, x
//     16 KB and W1, W3 two 64-column boxes each, 48 KB; DX_HIDDEN, x and dy
//     16 KB each and W1, W3, W2 8 KB each, 56 KB (a 128-wide dx tile fits
//     only 2 stages and timed no faster); the out pass and dw, 32 KB;
//   - SS wgmma throughout: x, dy, dh and act are K-major A (columns are the
//     reduction) in the row passes; W1, W3 (h contiguous) and W2 in DOWN (d
//     contiguous) are MN-major B, W2 in DX_HIDDEN and W1, W3 in DX_OUT
//     K-major B; dw reads x, act (A) and dh, dy (B) MN-major: rows are its
//     reduction, so A takes the transpose bit (hopper::Wgmma TA = 1);
//   - epilogues run on the accumulators in registers and store bf16 pairs;
//     each output tile has one owner, no atomics: every result is the same
//     bits from run to run;
//   - block order: a 1-D grid walks a table of tile indices that the wrapper
//     builds (ops/kernels/moe_gmm.py `block_order`, `fwd_plan`, `dx_plan`,
//     `dw_plan`): patches of P row tiles, each swept column tile by column
//     tile, so the blocks in flight share both row tiles and weight-column
//     tiles. P = sqrt(SMs x column-tile bytes / row-tile bytes), the P that
//     makes a wave's bytes least (dx pass 1 at the double-block shape: P =
//     10, ~26 MB a wave against ~84 MB for the row-fast order);
//   - dw: block (problem, expert, tile) scans tile_group on the device for
//     its expert's run (N / 128 ids, no host sync) and walks it in 64-row k
//     steps; an expert that owns no tile has zero steps, and its block writes
//     zeros without touching a barrier. Where the output rows end inside a
//     128-row tile (d or h % 128 == 64), the second warpgroup has no rows:
//     the ring counts only the first's arrivals and the producer loads half
//     the A tile.
// Traps met:
//   - the 128-byte swizzle caps a box at 64 bf16 columns: a 64-deep k step is
//     one box of a K-major A, a 128-wide MN-major operand two boxes (LBO = the
//     box stride), and a 128-wide M side of dw's A two boxes, one per
//     consumer warpgroup;
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
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK * 2;  // one 128 x 64 bf16 tile (K-major A: x, dy, dh, act)
constexpr int BOX = BK * 64 * 2;     // one 64 x 64 bf16 box
constexpr int BN_DX_HIDDEN = 64;     // hidden columns of one dx / dw hidden tile

struct HiddenParams {
  CUtensorMap x, dy;      // [N, d]: dims (d, N), boxes 64 x BM
  CUtensorMap w1, w3;     // [E, d, h]: dims (h, d, E), boxes 64 x BK x 1
  CUtensorMap w2;         // [E, h, d]: dims (d, h, E), boxes 64 x BN_DX_HIDDEN x 1 (not GATE_UP)
  const int* tile_group;  // expert of each row tile
  const int* order;       // tile index m * col_tiles + n of each block
  int col_tiles, k_steps, h;
  bf16* dh;   // [N, 2h]: dh1 | dh3 (not GATE_UP)
  bf16* act;  // [N, h]: GATE_UP, DW_HIDDEN
};

struct OutParams {
  CUtensorMap a;          // [N, K]: dims (K, N), boxes 64 x BM
  CUtensorMap b, b_hi;    // DOWN: W2 [E, h, d], dims (d, h, E), boxes 64 x BK x 1;
                          // DX_OUT: W1, W3 [E, d, h], dims (h, d, E), boxes 64 x BN x 1
  const int* tile_group;
  const int* order;
  int col_tiles, k_steps, k_split;  // DX_OUT: k steps < k_split read W1 (b), the rest W3 (b_hi)
  int d;
  bf16* out;  // [N, d]: y or dx
};

struct DwParams {
  CUtensorMap x, dh, act, dy;  // [N, cols]: dims (cols, N), boxes 64 x BK
  const int* tile_group;
  const int* order;  // tile index of each block (below)
  int row_tiles;     // ids in tile_group
  int d, h;
  // tile t < tiles13 is [dW1 | dW3]: expert t / (m13 n13), then (m, n) row-major
  // over m13 = ceil(d / 128) x n13 = 2h / BN; the rest is dW2, m2 x n2 over (h, d)
  int tiles13, m13, n13, m2, n2;
  bf16 *dw1, *dw3, *dw2;
};

template <int MODE, int BN>
struct HiddenSmem {
  static constexpr bool DP = MODE != GATE_UP;  // dy and W2, for dp = dy W2^T
  static constexpr int W_TILE = BK * BN * 2;   // W1, W3 (BN / 64 boxes) or W2
  static constexpr int x = 0, dy = A_TILE, w1 = (DP ? 2 : 1) * A_TILE, w3 = w1 + W_TILE, w2 = w3 + W_TILE;
  static constexpr int stage = DP ? w2 + W_TILE : w2;
  static constexpr int bar = STAGES * stage;  // full[STAGES], empty[STAGES]
  static constexpr int bytes = bar + 16 * STAGES + 1024;  // + slack to align the base to 1024
  static_assert(bytes <= 232448, "shared memory of one block");
};

// The out pass and the dw products: A (BM x BK: one K-major box, or dw's two
// MN-major boxes) and B (BN / 64 boxes).
template <int BN>
struct PairSmem {
  static constexpr int a = 0, b = A_TILE;
  static constexpr int stage = A_TILE + BN * BK * 2;
  static constexpr int bar = STAGES * stage;
  static constexpr int bytes = bar + 16 * STAGES + 1024;
  static_assert(bytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// `consumers`: the threads that free each stage
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int consumers = CONSUMERS) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], consumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// Thread (warp, lane) of a consumer warpgroup: accumulator rows row and row +
// 8 of the warpgroup's 64, columns 8j + col + {0, 1}.
struct Frag {
  int row, col;
  __device__ Frag() {
    const int lane = threadIdx.x % 32;
    row = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
    col = 2 * (lane % 4);
  }
};

// Hidden pass. Grid: one block per 128 x BN tile of the hidden axis, in the
// order of p.order; THREADS threads; HiddenSmem<MODE, BN>::bytes of dynamic
// shared memory.
template <int MODE, int BN>
__global__ void __launch_bounds__(THREADS, 1) moe_hidden_sm90(__grid_constant__ const HiddenParams p) {
  static_assert(MODE == GATE_UP || MODE == DX_HIDDEN || MODE == DW_HIDDEN, "a hidden pass");
  static_assert(BN == 64 || (BN == 128 && MODE == GATE_UP), "GATE_UP 64 or 128 wide, dx 64");
  using L = HiddenSmem<MODE, BN>;
  constexpr bool DP = L::DP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + STAGES;
  const int t = p.order[blockIdx.x];
  const int m = t / p.col_tiles, n0 = (t % p.col_tiles) * BN;
  init_ring(full, empty);

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
        if constexpr (DP) hopper::tma_load_2d(st + L::dy, &p.dy, &full[s], ks * BK, m * BM);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          hopper::tma_load_3d(st + L::w1 + j * BOX, &p.w1, &full[s], n0 + 64 * j, ks * BK, g);
          hopper::tma_load_3d(st + L::w3 + j * BOX, &p.w3, &full[s], n0 + 64 * j, ks * BK, g);
        }
        if constexpr (DP) hopper::tma_load_3d(st + L::w2, &p.w2, &full[s], ks * BK, n0, g);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const Frag f;
    float h1[BN / 2], h3[BN / 2], dp[DP ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) h1[i] = h3[i] = 0.f;
    hopper::fence_regs(h1);
    hopper::fence_regs(h3);
    if constexpr (DP) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dp[i] = 0.f;
      hopper::fence_regs(dp);
    }

    for (int ks = 0; ks < p.k_steps; ++ks) {
      const int s = ks % STAGES;
      const unsigned char* st = smem + s * L::stage;
      hopper::mbar_wait(&full[s], (ks / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t ax = hopper::desc_sw128(st + L::x + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t ady = hopper::desc_sw128(st + L::dy + wg * 64 * 128 + kk * 32, 16, 1024);  // DP only
        hopper::Wgmma<BN, 1>::ss(h1, ax, hopper::desc_sw128(st + L::w1 + kk * 16 * 128, BOX, 1024), 1);
        hopper::Wgmma<BN, 1>::ss(h3, ax, hopper::desc_sw128(st + L::w3 + kk * 16 * 128, BOX, 1024), 1);
        if constexpr (DP) hopper::Wgmma<BN, 0>::ss(dp, ady, hopper::desc_sw128(st + L::w2 + kk * 32, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the group of step ks - 1 is done with its stage
      if (ks > 0) hopper::mbar_arrive(&empty[(ks - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(h1);
    hopper::fence_regs(h3);
    if constexpr (DP) hopper::fence_regs(dp);

    // epilogue in registers, bf16 pairs: GATE_UP (h1, h3) -> act; dx, dw
    // (h1, h3, dp) -> (dh1, dh3, act)
    const long long r0 = (long long)m * BM + wg * 64 + f.row;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        const long long r = r0 + 8 * half;
        const int c = n0 + 8 * j + f.col;
        if constexpr (MODE == GATE_UP) {
          float unused = 0.f;
          epilogue<GATE_UP>(h1[i], h3[i], unused);
          epilogue<GATE_UP>(h1[i + 1], h3[i + 1], unused);
          *reinterpret_cast<uint32_t*>(p.act + r * p.h + c) = hopper::pack_bf16(h1[i], h1[i + 1]);
        } else {
          const long long ldh = 2LL * p.h;
          epilogue<MODE>(h1[i], h3[i], dp[i]);
          epilogue<MODE>(h1[i + 1], h3[i + 1], dp[i + 1]);
          *reinterpret_cast<uint32_t*>(p.dh + r * ldh + c) = hopper::pack_bf16(h1[i], h1[i + 1]);
          *reinterpret_cast<uint32_t*>(p.dh + r * ldh + p.h + c) = hopper::pack_bf16(h3[i], h3[i + 1]);
          if constexpr (MODE == DW_HIDDEN)
            *reinterpret_cast<uint32_t*>(p.act + r * p.h + c) = hopper::pack_bf16(dp[i], dp[i + 1]);
        }
      }
  }
}

// Out pass. Grid: one block per 128 x BN tile of [N, d], in the order of p.order.
template <int MODE, int BN>
__global__ void __launch_bounds__(THREADS, 1) moe_out_sm90(__grid_constant__ const OutParams p) {
  static_assert(MODE == DOWN || MODE == DX_OUT, "an out pass");
  using L = PairSmem<BN>;
  constexpr int TB = MODE == DOWN;  // W2 is MN-major (d contiguous), W1 and W3 K-major (h contiguous)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + STAGES;
  const int t = p.order[blockIdx.x];
  const int m = t / p.col_tiles, n0 = (t % p.col_tiles) * BN;
  init_ring(full, empty);

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
        hopper::tma_load_2d(st + L::a, &p.a, &full[s], ks * BK, m * BM);
        if constexpr (MODE == DOWN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_3d(st + L::b + j * BOX, &p.b, &full[s], n0 + 64 * j, ks * BK, g);
        } else {
          // [dh1 | dh3] meets [W1 | W3]: the step's k columns of W1 or of W3
          const bool hi = ks >= p.k_split;
          hopper::tma_load_3d(st + L::b, hi ? &p.b_hi : &p.b, &full[s], (ks - (hi ? p.k_split : 0)) * BK, n0, g);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const Frag f;
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
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t b = TB ? hopper::desc_sw128(st + L::b + kk * 16 * 128, BOX, 1024)
                              : hopper::desc_sw128(st + L::b + kk * 32, 16, 1024);
        hopper::Wgmma<BN, TB>::ss(acc, hopper::desc_sw128(st + L::a + wg * 64 * 128 + kk * 32, 16, 1024), b, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (ks > 0) hopper::mbar_arrive(&empty[(ks - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    const long long r0 = (long long)m * BM + wg * 64 + f.row;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + f.col;
      *reinterpret_cast<uint32_t*>(p.out + r0 * p.d + c) = hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(p.out + (r0 + 8) * p.d + c) = hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// dw products. Grid: one block per 128 x BN tile of one expert's gradient,
// [dW1 | dW3] tiles then dW2 tiles, in the order of p.order.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) moe_dw_sm90(__grid_constant__ const DwParams p) {
  using L = PairSmem<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + STAGES;

  // which gradient, expert and tile: [dW1 | dW3] = x^T dh over (d, 2h), dW2 = act^T dy over (h, d)
  const int t = p.order[blockIdx.x];
  const bool w13 = t < p.tiles13;
  const int u = w13 ? t : t - p.tiles13;
  const int mt = w13 ? p.m13 : p.m2, nt = w13 ? p.n13 : p.n2;
  const int g = u / (mt * nt), mi = u % (mt * nt) / nt;
  const int m0 = mi * BM, n0 = u % nt * BN;
  const int M = w13 ? p.d : p.h;  // output rows: columns of A
  const CUtensorMap* amap = w13 ? &p.x : &p.act;
  const CUtensorMap* bmap = w13 ? &p.dh : &p.dy;

  // the expert's run of row tiles: tiles before it hold smaller ids (expert-sorted)
  int lo = 0, cnt = 0;
  for (int base = 0; base < p.row_tiles; base += THREADS) {
    const int i = base + threadIdx.x;
    const int id = i < p.row_tiles ? p.tile_group[i] : -1;
    lo += __syncthreads_count(i < p.row_tiles && id < g);
    cnt += __syncthreads_count(id == g);
  }
  const int k_steps = cnt * (BM / BK), row0 = lo * BM;  // 0 steps: zeros
  const bool upper = m0 + 64 < M;  // the second warpgroup's 64 output rows exist
  init_ring(full, empty, upper ? CONSUMERS : CONSUMERS / 2);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const uint32_t bytes = (upper ? 2 : 1) * BOX + BN / 64 * BOX;
      for (int ks = 0; ks < k_steps; ++ks) {
        const int s = ks % STAGES;
        unsigned char* st = smem + s * L::stage;
        const int r = row0 + ks * BK;
        hopper::mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        hopper::tma_load_2d(st + L::a, amap, &full[s], m0, r);
        if (upper) hopper::tma_load_2d(st + L::a + BOX, amap, &full[s], m0 + 64, r);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) hopper::tma_load_2d(st + L::b + j * BOX, bmap, &full[s], n0 + 64 * j, r);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    if (wg == 1 && !upper) return;
    const Frag f;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    hopper::fence_regs(acc);

    for (int ks = 0; ks < k_steps; ++ks) {
      const int s = ks % STAGES;
      const unsigned char* st = smem + s * L::stage;
      hopper::mbar_wait(&full[s], (ks / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // A^T: warpgroup wg's 64 output rows are box wg of A
        hopper::Wgmma<BN, 1, 1>::ss(acc, hopper::desc_sw128(st + L::a + wg * BOX + kk * 16 * 128, BOX, 1024),
                                    hopper::desc_sw128(st + L::b + kk * 16 * 128, BOX, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (ks > 0) hopper::mbar_arrive(&empty[(ks - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // columns n0.. of [dW1 | dW3] fall in one bank (h % BN == 0); dW2 has d columns
    const bool hi = w13 && n0 >= p.h;
    const long long ld = w13 ? p.h : p.d;
    bf16* out = (w13 ? (hi ? p.dw3 : p.dw1) : p.dw2) + (long long)g * M * ld + (hi ? n0 - p.h : n0);
    const long long r0 = m0 + wg * 64 + f.row;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + f.col;
      *reinterpret_cast<uint32_t*>(out + r0 * ld + c) = hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(out + (r0 + 8) * ld + c) = hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <typename P>
cudaError_t launch_1d(void (*kern)(P), int blocks, int smem_bytes, cudaStream_t stream, const P& p) {
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kern<<<blocks, THREADS, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

// GATE_UP (x, w1, w3 -> act; dy, w2, dh null) or DX_HIDDEN / DW_HIDDEN.
template <int MODE, int BN>
cudaError_t launch_hidden(const void* x, const void* dy, const void* w1, const void* w3, const void* w2,
                          const int* tile_group, const int* order, void* dh, void* act, int N, int d, int h, int E,
                          cudaStream_t stream) {
  HiddenParams p{};
  cudaError_t err = hopper::make_map_rows(&p.x, x, N, d, BM);
  if (err == cudaSuccess) err = hopper::make_map_bank(&p.w1, w1, E, d, h, BK);
  if (err == cudaSuccess) err = hopper::make_map_bank(&p.w3, w3, E, d, h, BK);
  if (MODE != GATE_UP) {
    if (err == cudaSuccess) err = hopper::make_map_rows(&p.dy, dy, N, d, BM);
    if (err == cudaSuccess) err = hopper::make_map_bank(&p.w2, w2, E, h, d, BN);
  }
  if (err != cudaSuccess) return err;
  p.tile_group = tile_group;
  p.order = order;
  p.col_tiles = h / BN;
  p.k_steps = d / BK;
  p.h = h;
  p.dh = static_cast<bf16*>(dh);
  p.act = static_cast<bf16*>(act);
  return launch_1d(moe_hidden_sm90<MODE, BN>, (N / BM) * (h / BN), HiddenSmem<MODE, BN>::bytes, stream, p);
}

// DOWN: y = act W2 (a = act [N, h], b = w2); DX_OUT: dx = dh [W1 | W3]^T (a =
// dh [N, 2h], b = w1, b_hi = w3).
template <int MODE, int BN>
cudaError_t launch_out(const void* a, const void* b, const void* b_hi, const int* tile_group, const int* order,
                       void* out, int N, int d, int h, int E, cudaStream_t stream) {
  const int K = MODE == DOWN ? h : 2 * h;
  OutParams p{};
  cudaError_t err = hopper::make_map_rows(&p.a, a, N, K, BM);
  if (MODE == DOWN) {
    if (err == cudaSuccess) err = hopper::make_map_bank(&p.b, b, E, h, d, BK);
  } else {
    if (err == cudaSuccess) err = hopper::make_map_bank(&p.b, b, E, d, h, BN);
    if (err == cudaSuccess) err = hopper::make_map_bank(&p.b_hi, b_hi, E, d, h, BN);
  }
  if (err != cudaSuccess) return err;
  p.tile_group = tile_group;
  p.order = order;
  p.col_tiles = d / BN;
  p.k_steps = K / BK;
  p.k_split = h / BK;
  p.d = d;
  p.out = static_cast<bf16*>(out);
  return launch_1d(moe_out_sm90<MODE, BN>, (N / BM) * (d / BN), PairSmem<BN>::bytes, stream, p);
}

// [dW1 | dW3] = x^T dh and dW2 = act^T dy per expert, one launch.
template <int BN>
cudaError_t launch_dw(const void* x, const void* dy, const void* dh, const void* act, const int* tile_group,
                      const int* order, void* dw1, void* dw3, void* dw2, int N, int d, int h, int E,
                      cudaStream_t stream) {
  DwParams p{};
  cudaError_t err = hopper::make_map_rows(&p.x, x, N, d, BK);
  if (err == cudaSuccess) err = hopper::make_map_rows(&p.dh, dh, N, 2LL * h, BK);
  if (err == cudaSuccess) err = hopper::make_map_rows(&p.act, act, N, h, BK);
  if (err == cudaSuccess) err = hopper::make_map_rows(&p.dy, dy, N, d, BK);
  if (err != cudaSuccess) return err;
  p.tile_group = tile_group;
  p.order = order;
  p.row_tiles = N / BM;
  p.d = d;
  p.h = h;
  p.m13 = (d + BM - 1) / BM;
  p.n13 = 2 * h / BN;
  p.m2 = (h + BM - 1) / BM;
  p.n2 = d / BN;
  p.tiles13 = E * p.m13 * p.n13;
  p.dw1 = static_cast<bf16*>(dw1);
  p.dw3 = static_cast<bf16*>(dw3);
  p.dw2 = static_cast<bf16*>(dw2);
  return launch_1d(moe_dw_sm90<BN>, p.tiles13 + E * p.m2 * p.n2, PairSmem<BN>::bytes, stream, p);
}

}  // namespace sm90
}  // namespace ait_moe
