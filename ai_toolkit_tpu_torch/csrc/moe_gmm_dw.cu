// Grouped SwiGLU expert-bank gradients (dW1, dW3, dW2) of the MoE FFN for
// Hopper (sm_90a), exported through a plain C entry point and loaded with
// ctypes (ai_toolkit_tpu_torch/ops/kernels/moe_gmm.py).
//
// Replaces the TPU kernel ai_toolkit_tpu/ops/pallas/moe_gmm.py `_dw_kernel`
// (second pallas_call in `_gs_bwd`): for every expert g, over its run of
// expert-sorted BM-row tiles,
//   dW1[g] = x^T dh1,  dW3[g] = x^T dh3,  dW2[g] = act^T dy,
// with f32 accumulation, written in the banks' type; an expert that owns no
// tile gets zeros. dh = [dh1 | dh3] [N, 2h] and act = silu(h1) h3 [N, h] come
// from the first pass of the dx kernel (moe_gmm_bwd.cu, mode DW_HIDDEN), run
// once for both gradients, so this file is two GEMMs per expert:
//   1. [dW1 | dW3][g] = x_g^T [dh1 | dh3]_g   (d x 2h per expert)
//   2. dW2[g]         = act_g^T dy_g          (h x d per expert)
//
// The Pallas kernel walks a (hidden tiles, row tiles) grid with the row axis
// innermost and revisits each expert's output block in VMEM across the run,
// zeroing it at the run's first tile. Blocks on Hopper run in parallel in no
// order, so here every BM x BN output tile of one expert has one owner: the
// block finds its expert's run in tile_group on the device (one scan of
// N / 128 ids, no host sync), loops over the run's rows with an f32
// accumulator and writes once. No atomics: the same bits from run to run.
// What bounds it: 6 N d h operations against the bytes of x, dy, dh, act and
// the three gradients; at the hidream shape (N = 8192 routed rows, d = 2560,
// h = 6912, E = 4, bf16) 0.87 TFLOP against ~0.6 GB, so compute-bound. bf16
// runs both GEMMs in one launch of moe_gmm_sm90.cuh's moe_dw_sm90: 128 x 128
// output tiles, both operands read MN-major (the reduction runs over rows),
// A through the transpose bit of wgmma; f32 keeps moe_gmm_tile.cuh's
// CUDA-core path (mode DW) for the exact checks.

#include "moe_gmm_sm90.cuh"

using namespace ait_moe;

namespace {

cudaError_t dw_f32(const void* x, const void* dy, const void* dh, const void* act, const int* tg, void* dw1,
                   void* dw3, void* dw2, int N, int d, int h, int E, cudaStream_t st) {
  Args p13{};
  p13.a[0] = x;  // A^T: the columns of x are the output rows
  p13.lda[0] = d;
  p13.b[0] = dh;
  p13.ldb[0] = 2LL * h;
  p13.out = dw1;
  p13.out_hi = dw3;  // columns h.. of [dh1 | dh3]
  p13.col_split = h;
  p13.ldo = h;
  p13.out_expert = (long long)d * h;
  p13.tile_group = tg;
  p13.ntiles = N / BM;
  p13.M = d;

  Args p2 = p13;
  p2.a[0] = act;
  p2.lda[0] = h;
  p2.b[0] = dy;
  p2.ldb[0] = d;
  p2.out = p2.out_hi = dw2;
  p2.col_split = d;  // no split
  p2.ldo = d;
  p2.out_expert = (long long)h * d;
  p2.M = h;

  // a BN-wide column tile of [dW1 | dW3] must not straddle the two banks
  cudaError_t err = h % 128 == 0 ? launch<DW, 128>(p13, d, 2 * h, st, E) : launch<DW, 64>(p13, d, 2 * h, st, E);
  if (err != cudaSuccess) return err;
  return d % 128 == 0 ? launch<DW, 128>(p2, h, d, st, E) : launch<DW, 64>(p2, h, d, st, E);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every tensor is contiguous; x, dy [N, d],
// dh [N, 2h], act [N, h]; dw1, dw3 [E, d, h], dw2 [E, h, d]; tile_group
// [N / 128] int32, expert-sorted; N % 128 == 0, d % 64 == 0, h % 64 == 0.
// bf16 reads x, dy, dh and act by TMA (16-byte aligned bases; the wrapper
// checks) and takes the output tile width bn (64 or 128, dividing d and h, so
// that no column tile of [dW1 | dW3] straddles the banks) and the block order
// [E (ceil(d/128) (2h/bn) + ceil(h/128) (d/bn))]: a permutation of the tile
// indices (moe_gmm_sm90.cuh DwParams). f32 ignores the order and bn.
// Returns the cudaError_t of the launches.
int ait_moe_gmm_dw(const void* x, const void* dy, const void* dh, const void* act, const void* tile_group,
                   const void* order, void* dw1, void* dw3, void* dw2, int N, int d, int h, int E, int bn, int dtype,
                   void* stream) {
  if (!shapes_ok(N, d, h) || E <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(tile_group);
  if (dtype == 0) return (int)dw_f32(x, dy, dh, act, tg, dw1, dw3, dw2, N, d, h, E, st);
  if ((bn != 64 && bn != 128) || d % bn || h % bn) return (int)cudaErrorInvalidValue;
  const int* ord = static_cast<const int*>(order);
  return (int)(bn == 128 ? sm90::launch_dw<128>(x, dy, dh, act, tg, ord, dw1, dw3, dw2, N, d, h, E, st)
                         : sm90::launch_dw<64>(x, dy, dh, act, tg, ord, dw1, dw3, dw2, N, d, h, E, st));
}

const char* ait_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
