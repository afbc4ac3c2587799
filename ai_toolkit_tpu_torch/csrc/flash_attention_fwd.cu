// Flash-attention forward for Hopper (sm_90a), exported through a plain C
// entry point and loaded with ctypes (ai_toolkit_tpu_torch/ops/kernels/).
//
// Replaces the TPU kernels ai_toolkit_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (resident K/V) and `_fwd_kernel_streamed` (streamed K/V with a
// padded-column mask, reached through `flash_attention_any`). One kernel covers
// both: K/V always stream through shared memory tile by tile, and the ragged
// Q-row and KV-column tails are masked in the kernel, so no padded copies are
// made and any S, T is taken.
//
// Computes, for every (b, h) and query row:
//   out = softmax(scale * q k^T) v,   lse = m + log(l)   (natural log, in
//   units of the scaled logits), with f32 online-softmax state (m, l, acc).
// q [B,S,H,D], k/v [B,T,H,D] are read through their strides (last stride 1);
// out is written contiguous [B,S,H,D] in the input type, lse f32 [B,H,S].
//
// What bounds it: about 4*S*T*D*H FLOPs against 2*(S+2T)*H*D bytes; at the
// flux-dev shape (S=T=4608, H=24, D=128, bf16) that is ~261 GFLOP per call
// against ~85 MB, far above the card's ~295 FLOP/byte ridge, so the kernel is
// compute-bound. The simple design answers that only partly: both products
// (q k^T and p v) run on the tensor cores through WMMA bf16 16x16x16 tiles
// with f32 accumulation, and the 64-row Q tile stays in registers for the
// whole K/V sweep. The softmax and the output rescale go through shared
// memory in f32, and loads are not overlapped with compute (no cp.async, TMA
// or wgmma yet). f32 inputs take a CUDA-core FMA path with the same layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key/value rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;  // query rows owned by one warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(RPW == 16, "each warp owns one 16-row WMMA tile");
static_assert(BK == 64, "the softmax gives each lane two columns of a tile");

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory layout for one block. Rows are padded so that neighbouring
// rows fall in other banks; every WMMA leading dimension stays a multiple of
// 16 bytes and every array starts 128-byte aligned.
template <typename T, int D>
struct Smem {
  static constexpr int pad = std::is_same<T, bf16>::value ? 8 : 1;
  static constexpr int LD = D + pad;                                            // q/k/v rows
  static constexpr int LDS = BK + 4;                                            // f32 scores
  static constexpr int LDP = BK + (std::is_same<T, bf16>::value ? 8 : 4);       // probabilities
  static constexpr int LDO = D + 4;                                             // f32 output
  static constexpr size_t q = 0;
  static constexpr size_t k = q + round128(sizeof(T) * BQ * LD);
  static constexpr size_t v = k + round128(sizeof(T) * BK * LD);
  static constexpr size_t s = v + round128(sizeof(T) * BK * LD);
  static constexpr size_t p = s + round128(sizeof(float) * BQ * LDS);
  static constexpr size_t o = p + round128(sizeof(T) * BQ * LDP);
  static constexpr size_t bytes = o + round128(sizeof(float) * BQ * LDO);
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy `nrows` rows of D elements (global row stride `stride`) into shared
// rows of LD elements. Rows at or past `valid` are zero-filled, so masked
// columns never multiply garbage (0 * NaN would poison the output).
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

// The two products of one tile, for the 16 query rows [row0, row0+16) of a warp:
//   qk: S = q k^T (unscaled, f32) into shared scores
//   pv: O += p v into the shared f32 output accumulator
template <typename T, int D>
struct Mma;

template <int D>
struct Mma<bf16, D> {
  using L = Smem<bf16, D>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  struct QFrags {
    FragA f[D / 16];
  };

  __device__ static void load_q(QFrags& qf, const bf16* Qs, int row0) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qf.f[kk], Qs + row0 * L::LD + kk * 16, L::LD);
  }

  __device__ static void qk(const QFrags& qf, const bf16*, const bf16* Ks, float* Ss, int row0, int) {
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k stored [kv][d] row-major is k^T in column-major order
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + n * 16 * L::LD + kk * 16, L::LD);
        wmma::mma_sync(acc, qf.f[kk], kb, acc);
      }
      wmma::store_matrix_sync(Ss + row0 * L::LDS + n * 16, acc, L::LDS, wmma::mem_row_major);
    }
  }

  __device__ static void pv(const bf16* Ps, const bf16* Vs, float* Os, int row0, int) {
    FragA pf[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wmma::load_matrix_sync(pf[kk], Ps + row0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragAcc acc;
      wmma::load_matrix_sync(acc, Os + row0 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * 16 * L::LD + n * 16, L::LD);
        wmma::mma_sync(acc, pf[kk], vb, acc);
      }
      wmma::store_matrix_sync(Os + row0 * L::LDO + n * 16, acc, L::LDO, wmma::mem_row_major);
    }
  }
};

template <int D>
struct Mma<float, D> {
  using L = Smem<float, D>;
  struct QFrags {};

  __device__ static void load_q(QFrags&, const float*, int) {}

  // lane owns score columns lane and lane+32 of every row of the warp
  __device__ static void qk(const QFrags&, const float* Qs, const float* Ks, float* Ss, int row0, int lane) {
    float acc[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0 = Ks[lane * L::LD + d];
      const float k1 = Ks[(lane + 32) * L::LD + d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float qv = Qs[(row0 + r) * L::LD + d];
        acc[r][0] = fmaf(qv, k0, acc[r][0]);
        acc[r][1] = fmaf(qv, k1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      Ss[(row0 + r) * L::LDS + lane] = acc[r][0];
      Ss[(row0 + r) * L::LDS + lane + 32] = acc[r][1];
    }
  }

  // lane owns output columns lane + 32*j of every row of the warp
  __device__ static void pv(const float* Ps, const float* Vs, float* Os, int row0, int lane) {
    constexpr int CPL = D / 32;
    float acc[RPW][CPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[r][j] = 0.f;
    for (int c = 0; c < BK; ++c) {
      float vv[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) vv[j] = Vs[c * L::LD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = Ps[(row0 + r) * L::LDP + c];
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int j = 0; j < CPL; ++j) Os[(row0 + r) * L::LDO + lane + 32 * j] += acc[r][j];
  }
};

// Grid (ceil(S/BQ), B*H); THREADS threads; Smem<T,D>::bytes dynamic shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int kv_len, int H,
                 long long sqb, long long sqs, long long sqh, long long skb, long long sks,
                 long long skh, long long svb, long long svs, long long svh, float scale_log2,
                 int vec) {
  using L = Smem<T, D>;
  using M = Mma<T, D>;
  constexpr int CPL = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  T* Ps = reinterpret_cast<T*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * RPW;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* kg = k + b * skb + h * skh;
  const T* vg = v + b * svb + h * svh;

  load_tile<T, D, L::LD>(Qs, q + b * sqb + h * sqh + q0 * sqs, sqs, BQ, min(BQ, S - q0), vec);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) Os[i] = 0.f;
  __syncthreads();

  typename M::QFrags qf;
  M::load_q(qf, Qs, row0);

  // online-softmax state of the warp's rows, in log2 units of the scaled
  // logits; every lane holds the same values
  float m_i[RPW], l_i[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_len; kv0 += BK) {
    const int kv_valid = min(BK, kv_len - kv0);
    load_tile<T, D, L::LD>(Ks, kg + kv0 * sks, sks, BK, kv_valid, vec);
    load_tile<T, D, L::LD>(Vs, vg + kv0 * svs, svs, BK, kv_valid, vec);
    __syncthreads();

    M::qk(qf, Qs, Ks, Ss, row0, lane);
    __syncwarp();

    // column `lane` is always valid (kv_valid >= 1), so every row max is finite
    const bool ok0 = lane < kv_valid, ok1 = lane + 32 < kv_valid;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      const float s0 = ok0 ? Ss[row * L::LDS + lane] * scale_log2 : -INFINITY;
      const float s1 = ok1 ? Ss[row * L::LDS + lane + 32] * scale_log2 : -INFINITY;
      const float m_new = fmaxf(m_i[r], warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      const float alpha = exp2f(m_i[r] - m_new);
      l_i[r] = l_i[r] * alpha + warp_sum(p0 + p1);
      m_i[r] = m_new;
      Ps[row * L::LDP + lane] = from_float<T>(p0);
      Ps[row * L::LDP + lane + 32] = from_float<T>(p1);
#pragma unroll
      for (int j = 0; j < CPL; ++j) Os[row * L::LDO + lane + 32 * j] *= alpha;
    }
    __syncwarp();

    M::pv(Ps, Vs, Os, row0, lane);
    __syncthreads();  // all warps are done with this K/V tile
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + row0 + r;
    if (qi < S) {
      const float inv = 1.f / l_i[r];
      T* og = out + ((long long)b * S + qi) * H * D + (long long)h * D;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        og[lane + 32 * j] = from_float<T>(Os[(row0 + r) * L::LDO + lane + 32 * j] * inv);
      if (lane == 0) lse[(long long)bh * S + qi] = (m_i[r] + log2f(l_i[r])) * LN2;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int S, int kv_len, int H, long long sqb, long long sqs, long long sqh,
                   long long skb, long long sks, long long skh, long long svb, long long svs,
                   long long svh, float scale, int vec, cudaStream_t stream) {
  using L = Smem<T, D>;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, kv_len, H, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
      scale * LOG2E, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last stride
// of q/k/v is 1. `vec` = 1 when every row start is 16-byte aligned. Returns
// the cudaError_t of the launch (0 on success).
int ait_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                            int B, int S, int T, int H, int D, int dtype, long long sqb,
                            long long sqs, long long sqh, long long skb, long long sks,
                            long long skh, long long svb, long long svs, long long svh,
                            float scale, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define AIT_FLASH_CASE(TYPE, DIM)                                                            \
  return static_cast<int>(launch<TYPE, DIM>(q, k, v, out, l, B, S, T, H, sqb, sqs, sqh, skb, \
                                            sks, skh, svb, svs, svh, scale, vec, st))
  if (dtype == 1 && D == 128) AIT_FLASH_CASE(bf16, 128);
  if (dtype == 1 && D == 64) AIT_FLASH_CASE(bf16, 64);
  if (dtype == 0 && D == 128) AIT_FLASH_CASE(float, 128);
  if (dtype == 0 && D == 64) AIT_FLASH_CASE(float, 64);
#undef AIT_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ait_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
