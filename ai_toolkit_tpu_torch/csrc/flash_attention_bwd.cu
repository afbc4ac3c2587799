// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// exported through plain C entry points and loaded with ctypes
// (ai_toolkit_tpu_torch/ops/kernels/flash_attention.py).
//
// Replaces the TPU kernels of ai_toolkit_tpu/ops/pallas/flash_attention.py:
//   `_bwd_dq_kernel`           -> flash_bwd_dq_sm90 (bf16), f32::flash_bwd_dq_kernel (f32)
//   `_bwd_dkv_kernel`          -> flash_bwd_dkv_sm90 (bf16), f32::flash_bwd_dkv_kernel (f32)
//   `_bwd_dq_kernel_streamed`  -> the dq kernels (masked K/V tail)
//   `_bwd_dkv_kernel_streamed` -> the dk/dv kernels (masked Q tail)
// Both kernels stream the other operand through shared memory tile by tile and
// mask ragged tails themselves, so the resident and streamed TPU forms are one
// kernel each and no padded copies are made.
//
// Computes, with p = exp(scale q k^T - lse) recomputed from the forward's lse
// and delta = rowsum(dO o) (f32, computed by the wrapper):
//   ds = p (dO v^T - delta),  dq = scale ds k,  dk = scale ds^T q,  dv = p^T dO.
// q, dO [B,S,H,D] and k, v [B,T,H,D] are read through their strides (last
// stride 1); lse and delta are f32 [B,H,S]; dq, dk, dv are written contiguous
// [B,S,H,D] / [B,T,H,D] in the input type.
//
// Ownership: every output tile has one owner block (a 128-row Q tile for dq, a
// K/V tile for dk/dv), so there are no atomics and the gradients are the same
// from run to run.
//
// What bounds it: the five products of the function are 10*S*T*D*H FLOPs
// against about 2*(2S+2T)*H*D bytes read and (S+2T)*H*D written; at the
// flux-dev shape (S=T=4608, H=24, D=128, bf16) that is 6.52e11 FLOP against ~0.2 GB,
// far above the card's ~295 FLOP/byte ridge: compute-bound. The two-kernel
// design recomputes q k^T and dO v^T in both passes (seven products in all) to
// keep one owner per tile. dq alone: 6*S*T*D*H operations (0.39 TFLOP, 0.396
// ms at 989 TFLOP/s) against 5*S*H*D*2 bytes (q, k, v, dO in, dq out: 142 MB,
// 0.042 ms at 3.35 TB/s); dk/dv: 8*S*T*D*H against 6 such tensors.
//
// dk/dv, bf16 (flash_bwd_dkv_sm90): wgmma on TMA-fed shared memory.
//   - one block per 128 K/V rows and (b, h); 384 threads: consumer
//     warpgroups 0 and 1 own 64 K/V rows each; in producer warpgroup 2 one
//     thread issues the TMA loads and one warp stages lse and delta
//     (setmaxnreg: 24 registers for the producer, 240 for the consumers;
//     ptxas spills 28 bytes in the producer's lse/delta loop, off the
//     products' path; a 32/232 split moves a 4-byte spill into the D = 128
//     consumers instead);
//   - the block's K and V tiles arrive once by TMA; Q and dO go through a
//     2-stage ring of 64-row tiles, each stage with a full mbarrier (the TMA
//     bytes and the 32 arrivals of the lse/delta warp) and an empty one;
//   - per Q tile, everything is computed transposed, so the block's own rows
//     are the M dimension and the elementwise results are A operands in
//     registers: S^T = K Q^T and dP^T = V dO^T (SS wgmma m64n64k16, K-major
//     B); P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - delta);
//     dV += P^T dO and dK += dS^T Q (RS wgmma m64nDk16, P^T and dS^T packed to
//     bf16 in registers, dO and Q as MN-major B);
//   - dK and dV stay in registers for the whole sweep (D/2 + D/2 f32 a
//     thread); the epilogue writes dK * scale and dV in bf16, rows past T not
//     stored.
//
// dq, bf16 (flash_bwd_dq_sm90): the same building blocks, untransposed.
//   - one block per 128 Q rows and (b, h); 384 threads: consumer warpgroups 0
//     and 1 own 64 Q rows each, one thread of producer warpgroup 2 issues the
//     TMA loads (setmaxnreg 24 / 240);
//   - the block's Q and dO tiles arrive once by TMA; K and V go through a
//     3-stage ring of 64-row tiles (a K-full, a V-full and an empty mbarrier
//     per stage);
//   - per K/V tile: S = Q K^T and dP = dO V^T by SS wgmma m64n64k16 (K and V
//     as K-major B); P = exp2(S scale log2e - lse log2e), dS = P (dP - delta)
//     in f32 registers; dS packed pair by pair to bf16 A fragments; dQ += dS K
//     by RS wgmma m64nDk16 with K as an MN-major B;
//   - lse and delta belong to the block's own rows: each consumer thread reads
//     those of its two rows once into registers (+inf / 0 past S), so no
//     bulk copy and no producer staging;
//   - dQ stays in registers for the whole sweep (D/2 f32 a thread, beside 32 +
//     32 for S and dP); the epilogue writes dQ * scale in bf16, rows past S
//     not stored.
//
// Traps met and what the code does about them:
//   - lse and delta cannot arrive by a 1-D bulk copy: that needs a 16-byte
//     aligned source, and the rows of one (b, h) start at bh*S floats, which
//     is not a multiple of 4 for S = 4481. dk/dv needs the streamed rows' values: a
//     producer warp loads the 64 values of a stage with plain loads (+inf / 0
//     past S, so those columns get p = 0) and arrives on the stage's full
//     barrier; dq needs only its own rows' values (above);
//   - ragged tails: the tensor maps are 4-D over (d, h, s, b), so Q/dO rows
//     past S and K/V rows past T read as zeros, never another head's rows;
//   - zero fill is not a mask: in dq a zero K row past T gives S = 0 and
//     p = exp(-lse), which overflows to inf when the logits are strongly
//     negative (lse < -88), and inf * 0 = NaN; columns past T are set to
//     p = 0 explicitly;
//   - the 128-byte swizzle caps a box at 64 bf16 columns: a D = 128 tile is
//     two boxes (descriptors as in hopper.cuh);
//   - the accumulator-to-A reuse holds only for k16 slices (hopper.cuh);
//   - tail wave: 36 x 24 = 864 blocks (flux) or 34 x 20 = 680 (hidream) over
//     132 SMs, one block per SM; a persistent scheduler is later work.
//
// f32 (namespace f32) keeps the first design for the exact checks:
// CUDA-core FMAs with f32 accumulators in shared memory, 64-row owned tiles,
// 32-row stream tiles, loads not overlapped with compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- f32, CUDA cores

namespace f32 {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 16;          // rows of the owned tile per warp
constexpr int BM = WARPS * RPW;  // rows of the owned tile per block
constexpr int BN = 32;           // rows of a stream tile

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory layout of one block. "own" tiles hold the BM rows the block
// owns (dq: q, dO; dk/dv: k, v), "stream" tiles the BN rows of the current
// step of the loop (dq: k, v; dk/dv: q, dO). Rows are padded so neighbouring
// rows fall in other banks.
template <int D>
struct Smem {
  static constexpr int LD = D + 1;
  static constexpr int LDS = BN + 4;  // scores, p, ds
  static constexpr int LDO = D + 4;   // accumulators
  static constexpr size_t own0 = 0;
  static constexpr size_t own1 = own0 + round128(sizeof(float) * BM * LD);
  static constexpr size_t str0 = own1 + round128(sizeof(float) * BM * LD);
  static constexpr size_t str1 = str0 + round128(sizeof(float) * BN * LD);
  static constexpr size_t s = str1 + round128(sizeof(float) * BN * LD);
  static constexpr size_t dp = s + round128(sizeof(float) * BM * LDS);
  static constexpr size_t p = dp + round128(sizeof(float) * BM * LDS);
  static constexpr size_t ds = p + round128(sizeof(float) * BM * LDS);
  static constexpr size_t acc0 = ds + round128(sizeof(float) * BM * LDS);
  static constexpr size_t acc1 = acc0 + round128(sizeof(float) * BM * LDO);
  static constexpr size_t lse = acc1 + round128(sizeof(float) * BM * LDO);
  static constexpr size_t delta = lse + round128(sizeof(float) * BM);
  static constexpr size_t bytes = delta + round128(sizeof(float) * BM);
};

// Copy `nrows` rows of D elements (global row stride `stride`) into shared
// rows of LD elements. Rows at or past `valid` are zero-filled, so masked rows
// never multiply stale shared memory (0 * NaN would poison a sum).
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          long long stride, int nrows, int valid) {
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

// The two product shapes of one warp over its 16 rows, all operands in
// shared memory, row-major; lane owns output columns lane + 32 j of every row:
//   nt:     C[16 x N]  = A[16 x K] B[N x K]^T   (scores: q k^T, dO v^T, ...)
//   nn_acc: C[16 x N] += A[16 x K] B[K x N]     (dq += ds k, dv += p^T dO, ...)
template <int N, int K>
__device__ void nt(const float* A, int lda, const float* B, int ldb, float* C, int ldc, int lane) {
  constexpr int CPL = N / 32;
  float acc[RPW][CPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float bv[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) bv[j] = B[(lane + 32 * j) * ldb + k];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float av = A[r * lda + k];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) C[r * ldc + lane + 32 * j] = acc[r][j];
}

template <int N, int K>
__device__ void nn_acc(const float* A, int lda, const float* B, int ldb, float* C, int ldc, int lane) {
  constexpr int CPL = N / 32;
  float acc[RPW][CPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float bv[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) bv[j] = B[k * ldb + lane + 32 * j];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float av = A[r * lda + k];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) C[r * ldc + lane + 32 * j] += acc[r][j];
}

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, gb, gs, gh;
};

// Stage per-row lse (in log2 units) and delta for `n` rows starting at row
// `r0` of (b, h); rows at or past `valid` get 0.
__device__ __forceinline__ void load_row_stats(float* Ls, float* Dl, const float* lse,
                                               const float* delta, long long base, int n,
                                               int valid) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    Ls[i] = i < valid ? lse[base + i] * LOG2E : 0.f;
    Dl[i] = i < valid ? delta[base + i] : 0.f;
  }
}

// Grid (ceil(S/BM), B*H). One block owns the dq rows [q0, q0 + BM) of one
// (b, h) and loops over all K/V tiles.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int S, int kv_len, int H,
                    Strides st, float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::own0);
  float* Gs = reinterpret_cast<float*>(smem + L::own1);
  float* Ks = reinterpret_cast<float*>(smem + L::str0);
  float* Vs = reinterpret_cast<float*>(smem + L::str1);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* DPs = reinterpret_cast<float*>(smem + L::dp);
  float* DSs = reinterpret_cast<float*>(smem + L::ds);
  float* Acc = reinterpret_cast<float*>(smem + L::acc0);
  float* Ls = reinterpret_cast<float*>(smem + L::lse);
  float* Dl = reinterpret_cast<float*>(smem + L::delta);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * RPW;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q_valid = min(BM, S - q0);
  const float scale_log2 = scale * LOG2E;

  load_tile<D, L::LD>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM, q_valid);
  load_tile<D, L::LD>(Gs, dout + b * st.gb + h * st.gh + q0 * st.gs, st.gs, BM, q_valid);
  load_row_stats(Ls, Dl, lse, delta, (long long)bh * S + q0, BM, q_valid);
  for (int i = threadIdx.x; i < BM * L::LDO; i += THREADS) Acc[i] = 0.f;

  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  for (int kv0 = 0; kv0 < kv_len; kv0 += BN) {
    const int kv_valid = min(BN, kv_len - kv0);
    load_tile<D, L::LD>(Ks, kg + kv0 * st.ks, st.ks, BN, kv_valid);
    load_tile<D, L::LD>(Vs, vg + kv0 * st.vs, st.vs, BN, kv_valid);
    __syncthreads();

    nt<BN, D>(Qs + row0 * L::LD, L::LD, Ks, L::LD, Ss + row0 * L::LDS, L::LDS, lane);
    nt<BN, D>(Gs + row0 * L::LD, L::LD, Vs, L::LD, DPs + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

#pragma unroll 4
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      const float l2 = Ls[row], dl = Dl[row];
      for (int c = lane; c < BN; c += 32) {
        const float p = c < kv_valid ? exp2f(Ss[row * L::LDS + c] * scale_log2 - l2) : 0.f;
        DSs[row * L::LDS + c] = p * (DPs[row * L::LDS + c] - dl);
      }
    }
    __syncwarp();

    nn_acc<D, BN>(DSs + row0 * L::LDS, L::LDS, Ks, L::LD, Acc + row0 * L::LDO, L::LDO, lane);
    __syncthreads();  // all warps are done with this K/V tile
  }

  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= S) break;
    float* out = dq + ((long long)b * S + qi) * H * D + (long long)h * D;
    for (int c = lane; c < D; c += 32) out[c] = Acc[(row0 + r) * L::LDO + c] * scale;
  }
}

// Grid (ceil(T/BM), B*H). One block owns the dk/dv rows [k0, k0 + BM) of one
// (b, h) and loops over all Q/dO tiles; scores are kept transposed
// ([kv row][q column]).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                     int S, int kv_len, int H, Strides st, float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + L::own0);
  float* Vs = reinterpret_cast<float*>(smem + L::own1);
  float* Qs = reinterpret_cast<float*>(smem + L::str0);
  float* Gs = reinterpret_cast<float*>(smem + L::str1);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* DPs = reinterpret_cast<float*>(smem + L::dp);
  float* Ps = reinterpret_cast<float*>(smem + L::p);
  float* DSs = reinterpret_cast<float*>(smem + L::ds);
  float* dK = reinterpret_cast<float*>(smem + L::acc0);
  float* dV = reinterpret_cast<float*>(smem + L::acc1);
  float* Ls = reinterpret_cast<float*>(smem + L::lse);
  float* Dl = reinterpret_cast<float*>(smem + L::delta);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * RPW;
  const int k0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float scale_log2 = scale * LOG2E;

  const int own_valid = min(BM, kv_len - k0);
  load_tile<D, L::LD>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, BM, own_valid);
  load_tile<D, L::LD>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, BM, own_valid);
  for (int i = threadIdx.x; i < BM * L::LDO; i += THREADS) dK[i] = dV[i] = 0.f;

  const float* qg = q + b * st.qb + h * st.qh;
  const float* gg = dout + b * st.gb + h * st.gh;
  for (int q0 = 0; q0 < S; q0 += BN) {
    const int q_valid = min(BN, S - q0);
    load_tile<D, L::LD>(Qs, qg + q0 * st.qs, st.qs, BN, q_valid);
    load_tile<D, L::LD>(Gs, gg + q0 * st.gs, st.gs, BN, q_valid);
    load_row_stats(Ls, Dl, lse, delta, (long long)bh * S + q0, BN, q_valid);
    __syncthreads();

    nt<BN, D>(Ks + row0 * L::LD, L::LD, Qs, L::LD, Ss + row0 * L::LDS, L::LDS, lane);
    nt<BN, D>(Vs + row0 * L::LD, L::LD, Gs, L::LD, DPs + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

#pragma unroll 4
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      for (int c = lane; c < BN; c += 32) {
        const float p = c < q_valid ? exp2f(Ss[row * L::LDS + c] * scale_log2 - Ls[c]) : 0.f;
        Ps[row * L::LDS + c] = p;
        DSs[row * L::LDS + c] = p * (DPs[row * L::LDS + c] - Dl[c]);
      }
    }
    __syncwarp();

    nn_acc<D, BN>(Ps + row0 * L::LDS, L::LDS, Gs, L::LD, dV + row0 * L::LDO, L::LDO, lane);
    nn_acc<D, BN>(DSs + row0 * L::LDS, L::LDS, Qs, L::LD, dK + row0 * L::LDO, L::LDO, lane);
    __syncthreads();  // all warps are done with this Q/dO tile
  }

  for (int r = 0; r < RPW; ++r) {
    const int ki = k0 + row0 + r;
    if (ki >= kv_len) break;
    const long long off = ((long long)b * kv_len + ki) * H * D + (long long)h * D;
    for (int c = lane; c < D; c += 32) {
      dk[off + c] = dK[(row0 + r) * L::LDO + c] * scale;
      dv[off + c] = dV[(row0 + r) * L::LDO + c];
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int S, int T_, int H, const Strides& st, float scale,
                      cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, Smem<D>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), S, T_, H, st, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int S, int T_, int H, const Strides& st,
                       float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_ + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, Smem<D>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, T_, H,
      st, scale);
  return cudaGetLastError();
}

}  // namespace f32

using f32::Strides;

// ---------------------------------------------------------------- dk/dv, bf16, sm90

namespace sm90 {

constexpr int BM = 128;  // rows a block owns: K/V rows (dk/dv), Q rows (dq); 64 per consumer warpgroup
constexpr int BN = 64;   // rows of a streamed tile: Q/dO (dk/dv), K/V (dq)
constexpr int STAGES = 2;     // dk/dv's ring
constexpr int DQ_STAGES = 3;  // dq's ring
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;
constexpr int STAT_ARRIVALS = 32;  // the lse/delta warp

template <int D>
struct SmemDkv {
  static constexpr int own_tile = BM * D * 2;  // bytes: D/64 boxes of rows x 128 bytes
  static constexpr int q_tile = BN * D * 2;
  static constexpr int k = 0;
  static constexpr int v = k + own_tile;
  static constexpr int q = v + own_tile;
  static constexpr int g = q + STAGES * q_tile;
  static constexpr int lse = g + STAGES * q_tile;  // f32 [STAGES][BN], log2 units
  static constexpr int delta = lse + STAGES * BN * 4;
  static constexpr int bar = delta + STAGES * BN * 4;  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int bytes = bar + 64 + 1024;         // + slack to align the base to 1024
  static_assert(bytes <= 232448, "shared memory of one block");
};

// Grid (ceil(T/BM), B*H); THREADS threads; SmemDkv<D>::bytes dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tg,
                   const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int S, int T, int H, float scale) {
  using L = SmemDkv<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int k0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n_tiles = (S + BN - 1) / BN;
  const float scale_log2 = scale * LOG2E;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + STAT_ARRIVALS);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: thread 0 of the warpgroup loads tiles, warp 1 stages lse and delta ----
    hopper::setmaxnreg_dec<24>();
    const int ptid = threadIdx.x - 256;
    if (ptid == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * L::own_tile);
      for (int x = 0; x < BOXES; ++x) {
        hopper::tma_load_4d(smem + L::k + x * BM * 128, &tk, kv_full, x * 64, h, k0, b);
        hopper::tma_load_4d(smem + L::v + x * BM * 128, &tv, kv_full, x * 64, h, k0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::q_tile);
        for (int x = 0; x < BOXES; ++x) {
          hopper::tma_load_4d(smem + L::q + s * L::q_tile + x * BN * 128, &tq, &full[s], x * 64, h, i * BN, b);
          hopper::tma_load_4d(smem + L::g + s * L::q_tile + x * BN * 128, &tg, &full[s], x * 64, h, i * BN, b);
        }
      }
    } else if (ptid >= 32 && ptid < 64) {
      const int lane = ptid - 32;
      const float* lrow = lse + (long long)bh * S;
      const float* drow = delta + (long long)bh * S;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
#pragma unroll
        for (int c = lane; c < BN; c += 32) {
          const int qi = i * BN + c;
          lse_s[s * BN + c] = qi < S ? lrow[qi] * LOG2E : INFINITY;  // p = 0 past S
          delta_s[s * BN + c] = qi < S ? drow[qi] : 0.f;
        }
        hopper::mbar_arrive(&full[s]);  // release: the stores above are seen after the wait
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns K/V rows [64 wg, 64 wg + 64) of the block ----
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = 16 * (tid / 32) + lane / 4;  // and row + 8, within the warpgroup's 64
    const int col = 2 * (lane % 4);              // + 8j + {0, 1}
    const unsigned char* ks = smem + L::k + wg * 64 * 128;
    const unsigned char* vs = smem + L::v + wg * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const unsigned char* qs = smem + L::q + s * L::q_tile;
      const unsigned char* gs = smem + L::g + s * L::q_tile;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 x 64 f32 each, D/16 k16 slices
      float st[BN / 2], dpt[BN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk / 4, k16 = (kk % 4) * 32;
        hopper::Wgmma<BN, 0>::ss(st, hopper::desc_sw128(ks + x * BM * 128 + k16, 16, 1024),
                                 hopper::desc_sw128(qs + x * BN * 128 + k16, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk / 4, k16 = (kk % 4) * 32;
        hopper::Wgmma<BN, 0>::ss(dpt, hopper::desc_sw128(vs + x * BM * 128 + k16, 16, 1024),
                                 hopper::desc_sw128(gs + x * BN * 128 + k16, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      // P^T and dS^T in f32 over the columns (query rows) this thread holds
      const float* ls = lse_s + s * BN;
      const float* dl = delta_s + s * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lq = ls[8 * j + col + e], dlq = dl[8 * j + col + e];
          const float p0 = exp2f(fmaf(st[4 * j + e], scale_log2, -lq));
          const float p1 = exp2f(fmaf(st[4 * j + 2 + e], scale_log2, -lq));
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dlq);
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dlq);
        }
      uint32_t pa[BN / 16][4], dsa[BN / 16][4];
      hopper::acc_to_a(st, pa);
      hopper::acc_to_a(dpt, dsa);

      // dV += P^T dO, dK += dS^T Q: A from registers, dO and Q [q][d] as MN-major B
      hopper::fence_regs(pa);
      hopper::fence_regs(dsa);
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::Wgmma<D, 1>::rs(dv_acc, pa[kk], hopper::desc_sw128(gs + kk * 16 * 128, BN * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::Wgmma<D, 1>::rs(dk_acc, dsa[kk], hopper::desc_sw128(qs + kk * 16 * 128, BN * 128, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      hopper::mbar_arrive(&empty[s]);
    }

    // epilogue: dK * scale and dV in bf16, rows past T not stored
    const int r0 = k0 + wg * 64 + row, r1 = r0 + 8;
    const long long o0 = ((long long)(b * T + r0) * H + h) * D + col;
    const long long o1 = ((long long)(b * T + r1) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r0 < T) {
        *reinterpret_cast<uint32_t*>(dk + o0 + 8 * j) =
            hopper::pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o0 + 8 * j) = hopper::pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
      if (r1 < T) {
        *reinterpret_cast<uint32_t*>(dk + o1 + 8 * j) =
            hopper::pack_bf16(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + o1 + 8 * j) = hopper::pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int S, int T_, int H, const Strides& st,
                       float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = hopper::make_map_bshd(&tq, q, B, S, H, D, st.qb, st.qs, st.qh, BN);
  if (err == cudaSuccess) err = hopper::make_map_bshd(&tg, dout, B, S, H, D, st.gb, st.gs, st.gh, BN);
  if (err == cudaSuccess) err = hopper::make_map_bshd(&tk, k, B, T_, H, D, st.kb, st.ks, st.kh, BM);
  if (err == cudaSuccess) err = hopper::make_map_bshd(&tv, v, B, T_, H, D, st.vb, st.vs, st.vh, BM);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dkv_sm90<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SmemDkv<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_ + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, SmemDkv<D>::bytes, stream>>>(tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dk),
                                                      static_cast<bf16*>(dv), S, T_, H, scale);
  return cudaGetLastError();
}

template <int D>
struct SmemDq {
  static constexpr int own_tile = BM * D * 2;  // Q, dO: D/64 boxes of BM rows x 128 bytes
  static constexpr int kv_tile = BN * D * 2;   // K, V: D/64 boxes of BN rows x 128 bytes
  static constexpr int q = 0;
  static constexpr int g = q + own_tile;
  static constexpr int k = g + own_tile;
  static constexpr int v = k + DQ_STAGES * kv_tile;
  static constexpr int bar = v + DQ_STAGES * kv_tile;  // own_full, k_full[], v_full[], empty[]
  static constexpr int bytes = bar + 8 * (1 + 3 * DQ_STAGES) + 1024;  // + slack to align the base to 1024
  static_assert(bytes <= 232448, "shared memory of one block");
};

// Grid (ceil(S/BM), B*H); THREADS threads; SmemDq<D>::bytes dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                  __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tg,
                  const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, int S,
                  int T, int H, float scale) {
  using L = SmemDq<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* own_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + DQ_STAGES;
  uint64_t* empty = bars + 1 + 2 * DQ_STAGES;

  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n_tiles = (T + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(own_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread loads the block's Q and dO once, then the K/V ring ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(own_full, 2 * L::own_tile);
      for (int x = 0; x < BOXES; ++x) {
        hopper::tma_load_4d(smem + L::q + x * BM * 128, &tq, own_full, x * 64, h, q0, b);
        hopper::tma_load_4d(smem + L::g + x * BM * 128, &tg, own_full, x * 64, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % DQ_STAGES;
        hopper::mbar_wait(&empty[s], ((i / DQ_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&k_full[s], L::kv_tile);
        for (int x = 0; x < BOXES; ++x)
          hopper::tma_load_4d(smem + L::k + s * L::kv_tile + x * BN * 128, &tk, &k_full[s], x * 64, h, i * BN, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], L::kv_tile);
        for (int x = 0; x < BOXES; ++x)
          hopper::tma_load_4d(smem + L::v + s * L::kv_tile + x * BN * 128, &tv, &v_full[s], x * 64, h, i * BN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns Q rows [64 wg, 64 wg + 64) of the block ----
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = 16 * (tid / 32) + lane / 4;  // and row + 8, within the warpgroup's 64
    const int col = 2 * (lane % 4);              // + 8j + {0, 1}
    const unsigned char* qs = smem + L::q + wg * 64 * 128;
    const unsigned char* gs = smem + L::g + wg * 64 * 128;
    const float scale_log2 = scale * LOG2E;

    // lse (log2 units) and delta of this thread's two rows, read once; rows
    // past S get lse = +inf, so their p is 0
    const int r0 = q0 + wg * 64 + row, r1 = r0 + 8;
    const float* lrow = lse + (long long)bh * S;
    const float* drow = delta + (long long)bh * S;
    const float l0 = r0 < S ? lrow[r0] * LOG2E : INFINITY, l1 = r1 < S ? lrow[r1] * LOG2E : INFINITY;
    const float dl0 = r0 < S ? drow[r0] : 0.f, dl1 = r1 < S ? drow[r1] : 0.f;

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    hopper::mbar_wait(own_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % DQ_STAGES;
      const uint32_t parity = (i / DQ_STAGES) & 1;
      const unsigned char* ks = smem + L::k + s * L::kv_tile;
      const unsigned char* vs = smem + L::v + s * L::kv_tile;

      // S = Q K^T and dP = dO V^T: 64 x 64 f32 each, D/16 k16 slices
      float sc[BN / 2], dp[BN / 2];
      hopper::mbar_wait(&k_full[s], parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk / 4, k16 = (kk % 4) * 32;
        hopper::Wgmma<BN, 0>::ss(sc, hopper::desc_sw128(qs + x * BM * 128 + k16, 16, 1024),
                                 hopper::desc_sw128(ks + x * BN * 128 + k16, 16, 1024), kk > 0);
      }
      hopper::mbar_wait(&v_full[s], parity);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk / 4, k16 = (kk % 4) * 32;
        hopper::Wgmma<BN, 0>::ss(dp, hopper::desc_sw128(gs + x * BM * 128 + k16, 16, 1024),
                                 hopper::desc_sw128(vs + x * BN * 128 + k16, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // P and dS in f32. Columns past T are zero K rows (S = 0), whose
      // exp2(-lse) can overflow to inf and give inf * 0 = NaN: set to 0.
      const int kv0 = i * BN;
      const bool tail = kv0 + BN > T;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2f(fmaf(sc[4 * j + e], scale_log2, -l0));
          float p1 = exp2f(fmaf(sc[4 * j + 2 + e], scale_log2, -l1));
          if (tail && kv0 + 8 * j + col + e >= T) p0 = p1 = 0.f;
          dp[4 * j + e] = p0 * (dp[4 * j + e] - dl0);
          dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1);
        }
      uint32_t dsa[BN / 16][4];
      hopper::acc_to_a(dp, dsa);

      // dQ += dS K: dS from registers, K [kv][d] as an MN-major B
      hopper::fence_regs(dsa);
      hopper::fence_regs(dq_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::Wgmma<D, 1>::rs(dq_acc, dsa[kk], hopper::desc_sw128(ks + kk * 16 * 128, BN * 128, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq_acc);
      hopper::mbar_arrive(&empty[s]);
    }

    // epilogue: dQ * scale in bf16, contiguous [B,S,H,D], rows past S not stored
    const long long o0 = ((long long)(b * S + r0) * H + h) * D + col;
    const long long o1 = ((long long)(b * S + r1) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(dq + o0 + 8 * j) =
            hopper::pack_bf16(dq_acc[4 * j] * scale, dq_acc[4 * j + 1] * scale);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(dq + o1 + 8 * j) =
            hopper::pack_bf16(dq_acc[4 * j + 2] * scale, dq_acc[4 * j + 3] * scale);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int S, int T_, int H, const Strides& st, float scale,
                      cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = hopper::make_map_bshd(&tq, q, B, S, H, D, st.qb, st.qs, st.qh, BM);
  if (err == cudaSuccess) err = hopper::make_map_bshd(&tg, dout, B, S, H, D, st.gb, st.gs, st.gh, BM);
  if (err == cudaSuccess) err = hopper::make_map_bshd(&tk, k, B, T_, H, D, st.kb, st.ks, st.kh, BN);
  if (err == cudaSuccess) err = hopper::make_map_bshd(&tv, v, B, T_, H, D, st.vb, st.vs, st.vh, BN);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dq_sm90<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SmemDq<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, SmemDq<D>::bytes, stream>>>(tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dq), S, T_, H,
                                                     scale);
  return cudaGetLastError();
}

}  // namespace sm90

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides (q, k, v, dO; batch, seq, head)
// are in elements; the last stride of every input is 1. bf16 reads q, k, v,
// dO by TMA: 16-byte aligned bases and batch, sequence and head strides that
// are multiples of 8 elements (the wrapper copies a tensor that breaks that).
// lse, delta: f32 [B,H,S] contiguous. Each returns the cudaError_t of its
// launch (0 on success).
int ait_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int S, int T,
                               int H, int D, int dtype, const long long* strides, float scale, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define AIT_DQ_CASE(NS, DIM) \
  return static_cast<int>(NS::launch_dq<DIM>(q, k, v, dout, l, dl, dq, B, S, T, H, st, scale, cs))
  if (dtype == 1 && D == 128) AIT_DQ_CASE(sm90, 128);
  if (dtype == 1 && D == 64) AIT_DQ_CASE(sm90, 64);
  if (dtype == 0 && D == 128) AIT_DQ_CASE(f32, 128);
  if (dtype == 0 && D == 64) AIT_DQ_CASE(f32, 64);
#undef AIT_DQ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int ait_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int S, int T, int H, int D, int dtype, const long long* strides,
                                float scale, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define AIT_DKV_CASE(NS, DIM) \
  return static_cast<int>(NS::launch_dkv<DIM>(q, k, v, dout, l, dl, dk, dv, B, S, T, H, st, scale, cs))
  if (dtype == 1 && D == 128) AIT_DKV_CASE(sm90, 128);
  if (dtype == 1 && D == 64) AIT_DKV_CASE(sm90, 64);
  if (dtype == 0 && D == 128) AIT_DKV_CASE(f32, 128);
  if (dtype == 0 && D == 64) AIT_DKV_CASE(f32, 64);
#undef AIT_DKV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ait_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
