// Grouped (per-expert) f32 tile GEMMs for the MoE SwiGLU kernels, shared by
// moe_gmm_fwd.cu, moe_gmm_bwd.cu and moe_gmm_dw.cu; and what the bf16 engine
// (moe_gmm_sm90.cuh) takes from here: BM, the modes and their epilogues.
//
// The rows of every operand A are expert-sorted and grouped in tiles of BM
// rows: tile t belongs to expert tile_group[t] (ai_toolkit_tpu/ops/pallas/
// moe_gmm.py `moe_dispatch_swiglu` builds that layout; padding rows are zero).
// One block computes one BM x BN output tile: it reads its tile's expert id
// itself (the counterpart of the Pallas scalar prefetch), points every weight
// operand at that expert's bank and runs the whole reduction in a loop of BK
// chunks, double-buffered with cp.async. The block owns its output tile: no
// atomics, so the results are the same bits from run to run.
//
// Six modes, each a pass of the kernels:
//   GATE_UP   a  = silu(x W1[g]) * (x W3[g])              (forward, pass 1)
//   DOWN      y  = a W2[g]                                 (forward, pass 2)
//   DX_HIDDEN [dh1 | dh3] from h1 = x W1[g], h3 = x W3[g], dp = dy W2[g]^T
//             (dh1 = dp h3 silu'(h1), dh3 = dp silu(h1))   (dx, pass 1)
//   DW_HIDDEN DX_HIDDEN that also writes act = silu(h1) h3 (for dW2)
//   DX_OUT    dx = dh1 W1[g]^T + dh3 W3[g]^T               (dx, pass 2)
//   DW        dW[g] = A_g^T B_g over expert g's run of row tiles: the bank
//             gradients [dW1 | dW3] = x^T [dh1 | dh3] and dW2 = act^T dy
// DW is the one mode whose reduction runs over rows: its grid is (output row
// tiles, output column tiles, experts), each block finds its expert's run of
// tiles in tile_group itself (tiles are expert-sorted, so the run is
// contiguous) and reads its A operand transposed (a [BK][BM] shared tile). An
// expert with no tile writes zeros.
// This is the f32 path: CUDA-core FMAs over the same tiles in every mode, for
// the exact checks. Every bf16 mode runs on the wgmma/TMA engine of
// moe_gmm_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ait_moe {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // rows per tile: the dispatch's block_m
constexpr int BK = 32;   // reduction depth of one pipeline stage
constexpr int THREADS = 256;

enum Mode { GATE_UP = 0, DOWN = 1, DX_HIDDEN = 2, DX_OUT = 3, DW_HIDDEN = 4, DW = 5 };

// NA distinct A operands, NB weight operands (products), NOUT outputs.
// colmajor(i): weight i is read transposed (B[k][n] = W[n][k]); a_of(i): its A.
template <int MODE>
struct Cfg;
template <>
struct Cfg<GATE_UP> {
  static constexpr int NA = 1, NB = 2, NOUT = 1;
  __host__ __device__ static constexpr bool colmajor(int) { return false; }
  __host__ __device__ static constexpr int a_of(int) { return 0; }
};
template <>
struct Cfg<DOWN> {
  static constexpr int NA = 1, NB = 1, NOUT = 1;
  __host__ __device__ static constexpr bool colmajor(int) { return false; }
  __host__ __device__ static constexpr int a_of(int) { return 0; }
};
template <>
struct Cfg<DX_HIDDEN> {
  static constexpr int NA = 2, NB = 3, NOUT = 2;
  __host__ __device__ static constexpr bool colmajor(int i) { return i == 2; }
  __host__ __device__ static constexpr int a_of(int i) { return i == 2 ? 1 : 0; }
};
template <>
struct Cfg<DW_HIDDEN> : Cfg<DX_HIDDEN> {
  static constexpr int NOUT = 3;  // dh1, dh3 and act
};
template <>
struct Cfg<DW> {
  static constexpr int NA = 1, NB = 1, NOUT = 1;
  __host__ __device__ static constexpr bool colmajor(int) { return false; }
  __host__ __device__ static constexpr int a_of(int) { return 0; }
};
template <>
struct Cfg<DX_OUT> {
  static constexpr int NA = 1, NB = 1, NOUT = 1;
  __host__ __device__ static constexpr bool colmajor(int) { return true; }
  __host__ __device__ static constexpr int a_of(int) { return 0; }
};

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory of one block: two pipeline stages of A and weight tiles; after
// the reduction the same bytes hold the f32 output tiles for the epilogue.
// Rows are padded so that neighbouring rows fall in other banks; every
// cp.async destination stays 16-byte aligned.
template <int BN>
struct Dims {
  static constexpr int PAD = 4;
  static constexpr int LDA = BK + PAD;   // A tile [BM][LDA]
  static constexpr int LDAT = BM + PAD;  // transposed A tile [BK][LDAT] (DW)
  static constexpr int LDBR = BN + PAD;  // row-major weight tile [BK][LDBR]
  static constexpr int LDBC = BK + PAD;  // transposed weight tile [BN][LDBC]
  static constexpr int LDO = BN + 4;     // output tile [BM][LDO]
  static constexpr size_t a_bytes = round128(sizeof(float) * BM * LDA);
  static constexpr size_t at_bytes = round128(sizeof(float) * BK * LDAT);
  static constexpr size_t out_bytes = round128(sizeof(float) * BM * LDO);
};

// Bytes of one A tile of the mode within a stage.
template <int MODE, int BN>
__host__ __device__ constexpr size_t a_tile_bytes() {
  return MODE == DW ? Dims<BN>::at_bytes : Dims<BN>::a_bytes;
}

// Offset of weight tile i within a stage (the NA A tiles come first).
template <int MODE, int BN>
__host__ __device__ constexpr size_t b_off(int i) {
  using D = Dims<BN>;
  size_t off = Cfg<MODE>::NA * a_tile_bytes<MODE, BN>();
  for (int j = 0; j < i; ++j)
    off += round128(sizeof(float) * (Cfg<MODE>::colmajor(j) ? BN * D::LDBC : BK * D::LDBR));
  return off;
}

template <int MODE, int BN>
struct Layout : Dims<BN> {
  using C = Cfg<MODE>;
  using D = Dims<BN>;
  static constexpr size_t a_tile = a_tile_bytes<MODE, BN>();
  static constexpr size_t stage_bytes = b_off<MODE, BN>(C::NB);
  static constexpr size_t bytes =
      2 * stage_bytes > C::NOUT * D::out_bytes ? 2 * stage_bytes : C::NOUT * D::out_bytes;
};

struct Args {
  const void* a[2];           // A operands, row-major, BM-row tiles
  long long lda[2];           // their row strides (elements)
  const void* b[3];           // weight banks, expert 0 (DW: the B rows, row-major)
  long long b_expert[3];      // elements between experts of a bank
  long long ldb[3];           // row stride (row-major) or column stride (transposed)
  const void* b_alt;          // DX_OUT: the W3 bank, read for k >= k_split
  long long k_split;          // DX_OUT: h
  void* out;                  // output rows, row-major
  long long ldo;              // its row stride
  long long out2_col;         // DX_HIDDEN: column of the second output (dh3)
  void* act;                  // DW_HIDDEN: act [N, h], row stride ld_act
  long long ld_act;
  void* out_hi;               // DW: output of the columns >= col_split (dW3)
  long long col_split;        // DW: h for [dW1 | dW3]; the width (no split) for dW2
  long long out_expert;       // DW: elements between experts of the outputs
  const int* tile_group;      // expert id of each row tile
  int ntiles;                 // DW: row tiles in tile_group
  int M;                      // DW: output rows (A's columns), a multiple of 64
  int K;                      // reduction length, a multiple of BK (DW: from the run)
};

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage NROWS x NCOLS floats (global row stride ld) into shared rows of LD,
// 16 bytes per copy; columns from `cols` on are zero-filled, not read (the
// ragged output-row edge of DW).
template <int NROWS, int NCOLS, int LD>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long ld, int cols = NCOLS) {
  constexpr int VEC = 4;
  constexpr int CPR = NCOLS / VEC;
  static_assert(NCOLS % VEC == 0, "tile rows are whole 16-byte chunks");
  for (int i = threadIdx.x; i < NROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    if (c < cols)
      cp_async16(dst + r * LD + c, src + r * ld + c);
    else
      *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// The mode's elementwise epilogue over the accumulators of one output element.
template <int MODE>
__device__ __forceinline__ void epilogue(float& o0, float& o1, float& o2) {
  if constexpr (MODE == GATE_UP) {
    const float h1 = o0, h3 = o1;
    o0 = h1 * sigmoidf_(h1) * h3;
  } else if constexpr (MODE == DX_HIDDEN || MODE == DW_HIDDEN) {
    const float h1 = o0, h3 = o1, dp = o2;
    const float sg = sigmoidf_(h1);
    o0 = dp * h3 * (sg * (1.f + h1 * (1.f - sg)));  // dh1 = dp h3 silu'(h1)
    o1 = dp * (h1 * sg);                            // dh3 = dp silu(h1)
    if constexpr (MODE == DW_HIDDEN) o2 = h1 * sg * h3;  // act = silu(h1) h3
  }
}

// Accumulators and products of one block tile: thread (ty, tx) of a 16 x 16
// grid owns rows ty + 16 r and columns tx + 16 c of the tile.
template <int MODE, int BN>
struct Acc {
  using C = Cfg<MODE>;
  using L = Layout<MODE, BN>;
  static constexpr int TR = BM / 16, TC = BN / 16;
  float f[C::NB][TR][TC];
  int ty, tx;

  __device__ void init() {
    ty = threadIdx.x / 16;
    tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < C::NB; ++i)
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) f[i][r][c] = 0.f;
  }

  __device__ void step(const unsigned char* base) {
    for (int k = 0; k < BK; ++k) {
      float a[C::NA][TR];
#pragma unroll
      for (int j = 0; j < C::NA; ++j)
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const float* as = reinterpret_cast<const float*>(base + j * L::a_tile);
          a[j][r] = MODE == DW ? as[k * L::LDAT + ty + 16 * r] : as[(ty + 16 * r) * L::LDA + k];
        }
#pragma unroll
      for (int i = 0; i < C::NB; ++i) {
        const float* bs = reinterpret_cast<const float*>(base + b_off<MODE, BN>(i));
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const int n = tx + 16 * c;
          const float b = C::colmajor(i) ? bs[n * L::LDBC + k] : bs[k * L::LDBR + n];
#pragma unroll
          for (int r = 0; r < TR; ++r) f[i][r][c] = fmaf(a[C::a_of(i)][r], b, f[i][r][c]);
        }
      }
    }
  }

  __device__ void finish(float* out) {
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        epilogue<MODE>(f[0][r][c], f[C::NB > 1 ? 1 : 0][r][c], f[C::NB - 1][r][c]);
#pragma unroll
        for (int o = 0; o < C::NOUT; ++o)
          out[o * (L::out_bytes / sizeof(float)) + (ty + 16 * r) * L::LDO + tx + 16 * c] = f[o][r][c];
      }
  }
};

// Grid (rows / BM, columns / BN): the row tile is the fast index, so the blocks
// in flight share the same columns of the weights and each weight tile is
// read from device memory about once. DW: (output rows / BM, columns / BN,
// experts), the reduction over the expert's run of row tiles.
template <int MODE, int BN>
__global__ void __launch_bounds__(THREADS) moe_tile_kernel(const Args p) {
  using C = Cfg<MODE>;
  using L = Layout<MODE, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.y * BN;
  long long row0, g;  // first row of the reduction's rows (DW) or of the tile; the expert
  int K, m0 = 0;      // reduction length; DW: first output row (a column of A)
  if constexpr (MODE == DW) {
    // the expert's run: tiles before it hold smaller ids (expert-sorted), no host sync
    g = blockIdx.z;
    int lo = 0, cnt = 0;
    for (int base = 0; base < p.ntiles; base += THREADS) {
      const int t = base + threadIdx.x;
      const int id = t < p.ntiles ? p.tile_group[t] : -1;
      lo += __syncthreads_count(t < p.ntiles && id < g);
      cnt += __syncthreads_count(id == g);
    }
    row0 = (long long)lo * BM;
    K = cnt * BM;
    m0 = blockIdx.x * BM;
  } else {
    row0 = (long long)blockIdx.x * BM;
    g = p.tile_group[blockIdx.x];
    K = p.K;
  }

  const float* A[C::NA];
#pragma unroll
  for (int j = 0; j < C::NA; ++j) A[j] = static_cast<const float*>(p.a[j]) + row0 * p.lda[j] + m0;
  const float* B[C::NB];
#pragma unroll
  for (int i = 0; i < C::NB; ++i)
    B[i] = MODE == DW ? static_cast<const float*>(p.b[i]) + row0 * p.ldb[i] + n0
                      : static_cast<const float*>(p.b[i]) + g * p.b_expert[i] + (C::colmajor(i) ? n0 * p.ldb[i] : n0);
  const float* Balt = MODE == DX_OUT ? static_cast<const float*>(p.b_alt) + g * p.b_expert[0] + n0 * p.ldb[0]
                                 : nullptr;

  auto load_stage = [&](int s, int k0) {
    unsigned char* base = smem + s * L::stage_bytes;
#pragma unroll
    for (int j = 0; j < C::NA; ++j) {
      float* dst = reinterpret_cast<float*>(base + j * L::a_tile);
      if constexpr (MODE == DW)  // rows k0.. of A, columns m0..m0+BM: the transposed tile
        stage_tile<BK, BM, L::LDAT>(dst, A[j] + k0 * p.lda[j], p.lda[j], p.M - m0);
      else
        stage_tile<BM, BK, L::LDA>(dst, A[j] + k0, p.lda[j]);
    }
#pragma unroll
    for (int i = 0; i < C::NB; ++i) {
      float* dst = reinterpret_cast<float*>(base + b_off<MODE, BN>(i));
      if (C::colmajor(i)) {
        const float* src = B[i] + k0;
        if (MODE == DX_OUT && k0 >= p.k_split) src = Balt + (k0 - p.k_split);
        stage_tile<BN, BK, L::LDBC>(dst, src, p.ldb[i]);
      } else {
        stage_tile<BK, BN, L::LDBR>(dst, B[i] + (long long)k0 * p.ldb[i], p.ldb[i]);
      }
    }
  };

  Acc<MODE, BN> acc;
  acc.init();
  const int KT = K / BK;  // 0 for an expert with no tile: its gradient is zero
  if (KT > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // stage kt has landed
    __syncthreads();
    acc.step(smem + (kt & 1) * L::stage_bytes);
    __syncthreads();  // every warp is done with stage kt before it is refilled
  }

  float* Os = reinterpret_cast<float*>(smem);
  acc.finish(Os);
  __syncthreads();
  constexpr int VEC = 4;
#pragma unroll
  for (int o = 0; o < C::NOUT; ++o) {
    float* dst;
    long long ld = p.ldo;
    int rows = BM;
    if constexpr (MODE == DW) {
      const bool hi = n0 >= p.col_split;
      dst = static_cast<float*>(hi ? p.out_hi : p.out) + g * p.out_expert + m0 * p.ldo +
            (hi ? n0 - p.col_split : n0);
      rows = min(BM, p.M - m0);
    } else if (o == 2) {
      dst = static_cast<float*>(p.act) + row0 * p.ld_act + n0;
      ld = p.ld_act;
    } else {
      dst = static_cast<float*>(p.out) + row0 * p.ldo + (o == 1 ? p.out2_col : 0) + n0;
    }
    const float* src = Os + o * (L::out_bytes / sizeof(float));
    for (int i = threadIdx.x; i < rows * BN / VEC; i += THREADS) {
      const int r = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
      *reinterpret_cast<float4*>(dst + r * ld + c) = *reinterpret_cast<const float4*>(src + r * L::LDO + c);
    }
  }
}

// rows: the output rows (ragged last tile only in DW); experts: DW's grid depth.
template <int MODE, int BN>
cudaError_t launch(const Args& p, int rows, int cols, cudaStream_t stream, int experts = 1) {
  using L = Layout<MODE, BN>;
  static_assert(L::bytes <= 227 * 1024, "shared memory of one block");
  auto kern = moe_tile_kernel<MODE, BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + BM - 1) / BM, cols / BN, experts);
  kern<<<grid, THREADS, L::bytes, stream>>>(p);
  return cudaGetLastError();
}

// The output width of DOWN / DX_OUT is d: 128-column tiles when d allows.
template <int MODE>
cudaError_t launch_wide(const Args& p, int rows, int cols, cudaStream_t stream) {
  if (cols % 128 == 0) return launch<MODE, 128>(p, rows, cols, stream);
  return launch<MODE, 64>(p, rows, cols, stream);
}

// Shapes the kernels take: rows a multiple of BM, d and h multiples of 64.
inline bool shapes_ok(int N, int d, int h) {
  return N > 0 && N % BM == 0 && d > 0 && d % 64 == 0 && h > 0 && h % 64 == 0;
}

}  // namespace ait_moe
