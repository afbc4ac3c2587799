// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// exported through plain C entry points and loaded with ctypes
// (ai_toolkit_tpu_torch/ops/kernels/flash_attention.py).
//
// Replaces the TPU kernels of ai_toolkit_tpu/ops/pallas/flash_attention.py:
//   `_bwd_dq_kernel`           -> flash_bwd_dq_kernel
//   `_bwd_dkv_kernel`          -> flash_bwd_dkv_kernel
//   `_bwd_dq_kernel_streamed`  -> flash_bwd_dq_kernel (masked K/V tail)
//   `_bwd_dkv_kernel_streamed` -> flash_bwd_dkv_kernel (masked K/V tail)
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
// Ownership: every output tile has one owner block (a 64-row Q tile for dq, a
// 64-row K/V tile for dk/dv), so there are no atomics and the gradients are the
// same from run to run.
//
// What bounds it: the five products of the function are 10*S*T*D*H FLOPs
// against about 2*(2S+2T)*H*D bytes read and (S+2T)*H*D written; at the flux-dev
// shape (S=T=4608, H=24, D=128, bf16) that is 6.52e11 FLOP against ~0.2 GB,
// far above the card's ~295 FLOP/byte ridge: compute-bound. The two-kernel
// design recomputes q k^T and dO v^T in both passes (seven products in all) to
// keep one owner per tile. All products run on the tensor cores as WMMA bf16
// 16x16x16 tiles with f32 accumulation; the f32 accumulators of dq / dk / dv
// live in shared memory. Where the second product takes a bf16 operand, ds
// (dq kernel) and p and ds (dk/dv kernel) are rounded to bf16 after the f32
// elementwise step. Loads are not overlapped with compute (no cp.async, TMA or
// wgmma yet). f32 inputs take a CUDA-core FMA path with the same layout and a
// 32-row inner tile, so that the f32 tiles fit in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 16;          // rows of the owned tile per warp (one WMMA row tile)
constexpr int BM = WARPS * RPW;  // rows of the owned tile per block
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T>
constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

// Shared-memory layout of one block. "own" tiles hold the BM rows the block
// owns (dq: q, dO; dk/dv: k, v), "stream" tiles the BN rows of the current
// step of the loop (dq: k, v; dk/dv: q, dO). Rows are padded so neighbouring
// rows fall in other banks; every WMMA pointer stays 32-byte aligned.
template <typename T, int D>
struct Smem {
  static constexpr int BN = is_bf16<T>() ? 64 : 32;  // rows of a stream tile
  static constexpr int LD = D + (is_bf16<T>() ? 8 : 1);
  static constexpr int LDS = BN + 4;                       // f32 scores
  static constexpr int LDP = BN + (is_bf16<T>() ? 8 : 4);  // p / ds in T
  static constexpr int LDO = D + 4;                        // f32 accumulators
  static constexpr size_t own0 = 0;
  static constexpr size_t own1 = own0 + round128(sizeof(T) * BM * LD);
  static constexpr size_t str0 = own1 + round128(sizeof(T) * BM * LD);
  static constexpr size_t str1 = str0 + round128(sizeof(T) * BN * LD);
  static constexpr size_t s = str1 + round128(sizeof(T) * BN * LD);
  static constexpr size_t dp = s + round128(sizeof(float) * BM * LDS);
  static constexpr size_t p = dp + round128(sizeof(float) * BM * LDS);
  static constexpr size_t ds = p + round128(sizeof(T) * BM * LDP);
  static constexpr size_t acc0 = ds + round128(sizeof(T) * BM * LDP);
  static constexpr size_t acc1 = acc0 + round128(sizeof(float) * BM * LDO);
  static constexpr size_t lse = acc1 + round128(sizeof(float) * BM * LDO);
  static constexpr size_t delta = lse + round128(sizeof(float) * BM);
  static constexpr size_t bytes = delta + round128(sizeof(float) * BM);
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// Copy `nrows` rows of D elements (global row stride `stride`) into shared
// rows of LD elements. Rows at or past `valid` are zero-filled, so masked rows
// never multiply stale shared memory (0 * NaN would poison a sum).
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          long long stride, int nrows, int valid, bool vec) {
  if constexpr ((LD * sizeof(T)) % 16 == 0) {
    if (vec) {
      constexpr int VEC = 16 / sizeof(T);
      constexpr int CPR = D / VEC;  // 16-byte chunks per row
      for (int i = threadIdx.x; i < nrows * CPR; i += THREADS) {
        const int r = i / CPR, c = (i % CPR) * VEC;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r < valid ? src[r * stride + c] : from_float<T>(0.f);
  }
}

// The two product shapes of one warp over its 16 rows, all operands in
// shared memory, row-major:
//   nt:     C[16 x N]  = A[16 x K] B[N x K]^T   (scores: q k^T, dO v^T, ...)
//   nn_acc: C[16 x N] += A[16 x K] B[K x N]     (dq += ds k, dv += p^T dO, ...)
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  template <int N, int K>
  __device__ static void nt(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc, int) {
    FragA a[K / 16];
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) wmma::load_matrix_sync(a[kk], A + kk * 16, lda);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        // B stored [n][k] row-major is B^T in column-major order
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, B + n * 16 * ldb + kk * 16, ldb);
        wmma::mma_sync(acc, a[kk], bf, acc);
      }
      wmma::store_matrix_sync(C + n * 16, acc, ldc, wmma::mem_row_major);
    }
  }

  template <int N, int K>
  __device__ static void nn_acc(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc,
                                int) {
    FragA a[K / 16];
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) wmma::load_matrix_sync(a[kk], A + kk * 16, lda);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      FragAcc acc;
      wmma::load_matrix_sync(acc, C + n * 16, ldc, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, B + kk * 16 * ldb + n * 16, ldb);
        wmma::mma_sync(acc, a[kk], bf, acc);
      }
      wmma::store_matrix_sync(C + n * 16, acc, ldc, wmma::mem_row_major);
    }
  }
};

template <>
struct Mma<float> {
  // lane owns output columns lane + 32 j of every row of the warp
  template <int N, int K>
  __device__ static void nt(const float* A, int lda, const float* B, int ldb, float* C, int ldc,
                            int lane) {
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
  __device__ static void nn_acc(const float* A, int lda, const float* B, int ldb, float* C,
                                int ldc, int lane) {
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
};

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
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int kv_len, int H,
                    Strides st, float scale, int vec) {
  using L = Smem<T, D>;
  using M = Mma<T>;
  constexpr int BN = L::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::own0);
  T* Gs = reinterpret_cast<T*>(smem + L::own1);
  T* Ks = reinterpret_cast<T*>(smem + L::str0);
  T* Vs = reinterpret_cast<T*>(smem + L::str1);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* DPs = reinterpret_cast<float*>(smem + L::dp);
  T* DSs = reinterpret_cast<T*>(smem + L::ds);
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

  load_tile<T, D, L::LD>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM, q_valid, vec);
  load_tile<T, D, L::LD>(Gs, dout + b * st.gb + h * st.gh + q0 * st.gs, st.gs, BM, q_valid, vec);
  load_row_stats(Ls, Dl, lse, delta, (long long)bh * S + q0, BM, q_valid);
  for (int i = threadIdx.x; i < BM * L::LDO; i += THREADS) Acc[i] = 0.f;

  const T* kg = k + b * st.kb + h * st.kh;
  const T* vg = v + b * st.vb + h * st.vh;
  for (int kv0 = 0; kv0 < kv_len; kv0 += BN) {
    const int kv_valid = min(BN, kv_len - kv0);
    load_tile<T, D, L::LD>(Ks, kg + kv0 * st.ks, st.ks, BN, kv_valid, vec);
    load_tile<T, D, L::LD>(Vs, vg + kv0 * st.vs, st.vs, BN, kv_valid, vec);
    __syncthreads();

    M::template nt<BN, D>(Qs + row0 * L::LD, L::LD, Ks, L::LD, Ss + row0 * L::LDS, L::LDS, lane);
    M::template nt<BN, D>(Gs + row0 * L::LD, L::LD, Vs, L::LD, DPs + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

#pragma unroll 4
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      const float l2 = Ls[row], dl = Dl[row];
#pragma unroll
      for (int c = lane; c < BN; c += 32) {
        const float p = c < kv_valid ? exp2f(Ss[row * L::LDS + c] * scale_log2 - l2) : 0.f;
        DSs[row * L::LDP + c] = from_float<T>(p * (DPs[row * L::LDS + c] - dl));
      }
    }
    __syncwarp();

    M::template nn_acc<D, BN>(DSs + row0 * L::LDP, L::LDP, Ks, L::LD, Acc + row0 * L::LDO, L::LDO,
                              lane);
    __syncthreads();  // all warps are done with this K/V tile
  }

  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= S) break;
    T* out = dq + ((long long)b * S + qi) * H * D + (long long)h * D;
    for (int c = lane; c < D; c += 32) out[c] = from_float<T>(Acc[(row0 + r) * L::LDO + c] * scale);
  }
}

// Grid (ceil(T/BM), B*H). One block owns the dk/dv rows [k0, k0 + BM) of one
// (b, h) and loops over all Q/dO tiles; scores are kept transposed
// ([kv row][q column]).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int kv_len, int H, Strides st, float scale, int vec) {
  using L = Smem<T, D>;
  using M = Mma<T>;
  constexpr int BN = L::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::own0);
  T* Vs = reinterpret_cast<T*>(smem + L::own1);
  T* Qs = reinterpret_cast<T*>(smem + L::str0);
  T* Gs = reinterpret_cast<T*>(smem + L::str1);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* DPs = reinterpret_cast<float*>(smem + L::dp);
  T* Ps = reinterpret_cast<T*>(smem + L::p);
  T* DSs = reinterpret_cast<T*>(smem + L::ds);
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
  load_tile<T, D, L::LD>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, BM, own_valid, vec);
  load_tile<T, D, L::LD>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, BM, own_valid, vec);
  for (int i = threadIdx.x; i < BM * L::LDO; i += THREADS) dK[i] = dV[i] = 0.f;

  const T* qg = q + b * st.qb + h * st.qh;
  const T* gg = dout + b * st.gb + h * st.gh;
  for (int q0 = 0; q0 < S; q0 += BN) {
    const int q_valid = min(BN, S - q0);
    load_tile<T, D, L::LD>(Qs, qg + q0 * st.qs, st.qs, BN, q_valid, vec);
    load_tile<T, D, L::LD>(Gs, gg + q0 * st.gs, st.gs, BN, q_valid, vec);
    load_row_stats(Ls, Dl, lse, delta, (long long)bh * S + q0, BN, q_valid);
    __syncthreads();

    M::template nt<BN, D>(Ks + row0 * L::LD, L::LD, Qs, L::LD, Ss + row0 * L::LDS, L::LDS, lane);
    M::template nt<BN, D>(Vs + row0 * L::LD, L::LD, Gs, L::LD, DPs + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

#pragma unroll 4
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int c = lane; c < BN; c += 32) {
        const float p = c < q_valid ? exp2f(Ss[row * L::LDS + c] * scale_log2 - Ls[c]) : 0.f;
        Ps[row * L::LDP + c] = from_float<T>(p);
        DSs[row * L::LDP + c] = from_float<T>(p * (DPs[row * L::LDS + c] - Dl[c]));
      }
    }
    __syncwarp();

    M::template nn_acc<D, BN>(Ps + row0 * L::LDP, L::LDP, Gs, L::LD, dV + row0 * L::LDO, L::LDO,
                              lane);
    M::template nn_acc<D, BN>(DSs + row0 * L::LDP, L::LDP, Qs, L::LD, dK + row0 * L::LDO, L::LDO,
                              lane);
    __syncthreads();  // all warps are done with this Q/dO tile
  }

  for (int r = 0; r < RPW; ++r) {
    const int ki = k0 + row0 + r;
    if (ki >= kv_len) break;
    const long long off = ((long long)b * kv_len + ki) * H * D + (long long)h * D;
    for (int c = lane; c < D; c += 32) {
      dk[off + c] = from_float<T>(dK[(row0 + r) * L::LDO + c] * scale);
      dv[off + c] = from_float<T>(dV[(row0 + r) * L::LDO + c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int S, int T_,
                      int H, const Strides& st, float scale, int vec, cudaStream_t stream) {
  using L = Smem<T, D>;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, T_, H, st, scale, vec);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B, int S,
                       int T_, int H, const Strides& st, float scale, int vec,
                       cudaStream_t stream) {
  using L = Smem<T, D>;
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_ + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, T_,
      H, st, scale, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides (q, k, v, dO; batch, seq, head)
// are in elements; the last stride of every input is 1. `vec` = 1 when every
// row start is 16-byte aligned. lse, delta: f32 [B,H,S] contiguous. Each
// returns the cudaError_t of its launch (0 on success).
int ait_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int S, int T,
                               int H, int D, int dtype, const long long* strides, float scale,
                               int vec, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define AIT_DQ_CASE(TYPE, DIM) \
  return static_cast<int>(launch_dq<TYPE, DIM>(q, k, v, dout, l, dl, dq, B, S, T, H, st, scale, vec, cs))
  if (dtype == 1 && D == 128) AIT_DQ_CASE(bf16, 128);
  if (dtype == 1 && D == 64) AIT_DQ_CASE(bf16, 64);
  if (dtype == 0 && D == 128) AIT_DQ_CASE(float, 128);
  if (dtype == 0 && D == 64) AIT_DQ_CASE(float, 64);
#undef AIT_DQ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int ait_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int S, int T, int H, int D, int dtype, const long long* strides,
                                float scale, int vec, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define AIT_DKV_CASE(TYPE, DIM)                                                             \
  return static_cast<int>(                                                                  \
      launch_dkv<TYPE, DIM>(q, k, v, dout, l, dl, dk, dv, B, S, T, H, st, scale, vec, cs))
  if (dtype == 1 && D == 128) AIT_DKV_CASE(bf16, 128);
  if (dtype == 1 && D == 64) AIT_DKV_CASE(bf16, 64);
  if (dtype == 0 && D == 128) AIT_DKV_CASE(float, 128);
  if (dtype == 0 && D == 64) AIT_DKV_CASE(float, 64);
#undef AIT_DKV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ait_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
