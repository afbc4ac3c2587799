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
// against ~85 MB, far above the card's ~295 FLOP/byte ridge: compute-bound,
// so the design is about keeping the tensor cores fed.
//
// bf16 (flash_fwd_sm90), FA3-like without pingpong scheduling:
//   - one block per 128 query rows and (b, h); 384 threads: consumer
//     warpgroups 0 and 1 own 64 query rows each, warpgroup 2 is the producer,
//     one thread of which issues every TMA load (setmaxnreg: 24 registers for
//     the producer, 240 for the consumers);
//   - the Q tile arrives once by TMA; K and V go through a 2-stage ring of
//     128-row tiles, each stage with a K-full, a V-full and an empty mbarrier,
//     so the next tile loads while this one is computed;
//   - S = Q K^T by SS wgmma m64n128k16 (K-major B) into registers; the online
//     softmax runs on the accumulator in registers (row max and sum over the
//     4 lanes of a quad by __shfl_xor), O is rescaled in registers;
//   - P is packed to bf16 in the accumulator's own layout, which is the A
//     fragment layout of the next product, and O += P V runs as RS wgmma
//     m64nDk16 with V as an MN-major B (transpose bit set);
//   - epilogue: O / l in bf16 (rows past S not stored) and lse.
// Traps met and what the code does about them:
//   - a ragged tail needs the sequence to be a tensor-map dimension of its own:
//     the maps are 4-D over (d, h, s, b), so rows past S or T read as zeros
//     (a 2-D map over B*S*H rows would read the next head's rows); columns
//     past T are still set to -inf before the row max;
//   - the 128-byte swizzle caps a box at 64 bf16 columns: a D = 128 tile is
//     two boxes, and the descriptors step from one to the other (K-major:
//     the k16 slices 4..7 start in the second box; MN-major V: LBO = the box
//     stride);
//   - the accumulator-to-A reuse holds only for k16 slices of a 16-bit A
//     (hopper.cuh);
//   - tail wave: 36 x 24 = 864 blocks (flux) or 34 x 20 = 680 (hidream), one
//     block per SM at this shared-memory size, over 132 SMs: the last wave
//     runs 72 / 20 blocks on an otherwise idle card. A persistent tile
//     scheduler is later work.
//
// f32 (flash_fwd_f32) keeps the CUDA-core path: 4 warps on a 64-row tile,
// K/V through shared memory, the softmax through shared memory. It serves the
// f32 checks of the whole model, not a main path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16, sm90

namespace sm90 {

constexpr int BM = 128;  // query rows per block
constexpr int BN = 128;  // key/value rows per stage
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;

template <int D>
struct Smem {
  static constexpr int q_tile = BM * D * 2;  // bytes: D/64 boxes of BM x 128 bytes
  static constexpr int kv_tile = BN * D * 2;
  static constexpr int q = 0;
  static constexpr int k = q + q_tile;
  static constexpr int v = k + STAGES * kv_tile;
  static constexpr int bar = v + STAGES * kv_tile;  // q_full, k_full[2], v_full[2], empty[2]
  static constexpr int bytes = bar + 64 + 1024;     // + slack to align the base to 1024
  static_assert(bytes <= 232448, "shared memory of one block");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
               __grid_constant__ const CUtensorMap tv, bf16* __restrict__ out, float* __restrict__ lse, int S,
               int T, int H, float scale_log2) {
  using L = Smem<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n_tiles = (T + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(q_full, L::q_tile);
      for (int x = 0; x < BOXES; ++x)
        hopper::tma_load_4d(smem + L::q + x * BM * 128, &tq, q_full, x * 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&k_full[s], L::kv_tile);
        for (int x = 0; x < BOXES; ++x)
          hopper::tma_load_4d(smem + L::k + s * L::kv_tile + x * BN * 128, &tk, &k_full[s], x * 64, h, i * BN, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], L::kv_tile);
        for (int x = 0; x < BOXES; ++x)
          hopper::tma_load_4d(smem + L::v + s * L::kv_tile + x * BN * 128, &tv, &v_full[s], x * 64, h, i * BN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the tile ----
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = 16 * (tid / 32) + lane / 4;  // and row + 8, within the warpgroup's 64
    const int col = 2 * (lane % 4);              // + 8j + {0, 1}

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows row, row + 8; l per thread

    hopper::mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const unsigned char* ks = smem + L::k + s * L::kv_tile;
      const unsigned char* vs = smem + L::v + s * L::kv_tile;

      // S = Q K^T: 64 x 128 f32, D/16 k16 slices
      float sc[BN / 2];
      hopper::mbar_wait(&k_full[s], parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk / 4, k16 = (kk % 4) * 32;
        const uint64_t da = hopper::desc_sw128(smem + L::q + x * BM * 128 + wg * 64 * 128 + k16, 16, 1024);
        const uint64_t db = hopper::desc_sw128(ks + x * BN * 128 + k16, 16, 1024);
        hopper::Wgmma<BN, 0>::ss(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // online softmax in registers, log2 units of the scaled logits
      const int kv0 = i * BN;
      if (kv0 + BN > T) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kv0 + 8 * j + col + e >= T) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // column kv0 < T is in every row, so both maxima are finite
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], scale_log2, -mn0));
          sc[4 * j + 2 + e] = exp2f(fmaf(sc[4 * j + 2 + e], scale_log2, -mn1));
          sum0 += sc[4 * j + e];
          sum1 += sc[4 * j + 2 + e];
        }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      uint32_t pa[BN / 16][4];
      hopper::acc_to_a(sc, pa);

      // O += P V: P from registers, V [kv][d] as an MN-major B
      hopper::mbar_wait(&v_full[s], parity);
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::Wgmma<D, 1>::rs(o, pa[kk], hopper::desc_sw128(vs + kk * 16 * 128, BN * 128, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&empty[s]);
    }

    // epilogue: l summed over the quad, O / l in bf16, lse
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r0 = q0 + wg * 64 + row, r1 = r0 + 8;
    bf16* og0 = out + ((long long)(b * S + r0) * H + h) * D + col;
    bf16* og1 = out + ((long long)(b * S + r1) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(og0 + 8 * j) = hopper::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(og1 + 8 * j) = hopper::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (lane % 4 == 0) {
      if (r0 < S) lse[(long long)bh * S + r0] = (m0 + log2f(l0)) * LN2;
      if (r1 < S) lse[(long long)bh * S + r1] = (m1 + log2f(l1)) * LN2;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int T, int H,
                   long long sqb, long long sqs, long long sqh, long long skb, long long sks, long long skh,
                   long long svb, long long svs, long long svh, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::make_map_bshd(&tq, q, B, S, H, D, sqb, sqs, sqh, BM);
  if (err == cudaSuccess) err = hopper::make_map_bshd(&tk, k, B, T, H, D, skb, sks, skh, BN);
  if (err == cudaSuccess) err = hopper::make_map_bshd(&tv, v, B, T, H, D, svb, svs, svh, BN);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_sm90<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, Smem<D>::bytes, stream>>>(tq, tk, tv, static_cast<bf16*>(out), lse, S, T, H,
                                                   scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------- f32, CUDA cores

namespace f32 {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key/value rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;  // query rows owned by one warp

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory layout for one block; rows padded so that neighbouring rows
// fall in other banks.
template <int D>
struct Smem {
  static constexpr int LD = D + 1;   // q/k/v rows
  static constexpr int LDS = BK + 4;  // scores
  static constexpr int LDP = BK + 4;  // probabilities
  static constexpr int LDO = D + 4;   // output
  static constexpr size_t q = 0;
  static constexpr size_t k = q + round128(sizeof(float) * BQ * LD);
  static constexpr size_t v = k + round128(sizeof(float) * BK * LD);
  static constexpr size_t s = v + round128(sizeof(float) * BK * LD);
  static constexpr size_t p = s + round128(sizeof(float) * BQ * LDS);
  static constexpr size_t o = p + round128(sizeof(float) * BQ * LDP);
  static constexpr size_t bytes = o + round128(sizeof(float) * BQ * LDO);
};

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
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src, long long stride,
                                          int nrows, int valid) {
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

// Grid (ceil(S/BQ), B*H); THREADS threads; Smem<D>::bytes dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ out, float* __restrict__ lse, int S, int kv_len, int H, long long sqb,
              long long sqs, long long sqh, long long skb, long long sks, long long skh, long long svb,
              long long svs, long long svh, float scale_log2) {
  using L = Smem<D>;
  constexpr int CPL = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* Ks = reinterpret_cast<float*>(smem + L::k);
  float* Vs = reinterpret_cast<float*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* Ps = reinterpret_cast<float*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * RPW;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float* kg = k + b * skb + h * skh;
  const float* vg = v + b * svb + h * svh;

  load_tile<D, L::LD>(Qs, q + b * sqb + h * sqh + q0 * sqs, sqs, BQ, min(BQ, S - q0));
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) Os[i] = 0.f;
  __syncthreads();

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
    load_tile<D, L::LD>(Ks, kg + kv0 * sks, sks, BK, kv_valid);
    load_tile<D, L::LD>(Vs, vg + kv0 * svs, svs, BK, kv_valid);
    __syncthreads();

    // S = q k^T: lane owns score columns lane and lane+32 of every row of the warp
    {
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
      Ps[row * L::LDP + lane] = p0;
      Ps[row * L::LDP + lane + 32] = p1;
#pragma unroll
      for (int j = 0; j < CPL; ++j) Os[row * L::LDO + lane + 32 * j] *= alpha;
    }
    __syncwarp();

    // O += p v: lane owns output columns lane + 32*j of every row of the warp
    {
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
    __syncthreads();  // all warps are done with this K/V tile
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + row0 + r;
    if (qi < S) {
      const float inv = 1.f / l_i[r];
      float* og = out + ((long long)b * S + qi) * H * D + (long long)h * D;
#pragma unroll
      for (int j = 0; j < CPL; ++j) og[lane + 32 * j] = Os[(row0 + r) * L::LDO + lane + 32 * j] * inv;
      if (lane == 0) lse[(long long)bh * S + qi] = (m_i[r] + log2f(l_i[r])) * LN2;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int kv_len,
                   int H, long long sqb, long long sqs, long long sqh, long long skb, long long sks, long long skh,
                   long long svb, long long svs, long long svh, float scale, cudaStream_t stream) {
  using L = Smem<D>;
  auto kern = flash_fwd_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, L::bytes, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                            static_cast<const float*>(v), static_cast<float*>(out), lse, S,
                                            kv_len, H, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
                                            scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last stride
// of q/k/v is 1. bf16 tensors are read by TMA: a 16-byte aligned base and
// batch, sequence and head strides that are multiples of 8 elements (the
// wrapper copies a tensor that breaks that). Returns the cudaError_t of the
// launch (0 on success).
int ait_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
                            int T, int H, int D, int dtype, long long sqb, long long sqs, long long sqh,
                            long long skb, long long sks, long long skh, long long svb, long long svs,
                            long long svh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define AIT_FLASH_CASE(NS, DIM)                                                                               \
  return static_cast<int>(NS::launch<DIM>(q, k, v, out, l, B, S, T, H, sqb, sqs, sqh, skb, sks, skh, svb, svs, \
                                          svh, scale, st))
  if (dtype == 1 && D == 128) AIT_FLASH_CASE(sm90, 128);
  if (dtype == 1 && D == 64) AIT_FLASH_CASE(sm90, 64);
  if (dtype == 0 && D == 128) AIT_FLASH_CASE(f32, 128);
  if (dtype == 0 && D == 64) AIT_FLASH_CASE(f32, 64);
#undef AIT_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ait_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
