// Grouped SwiGLU forward of the MoE FFN for Hopper (sm_90a), exported through
// a plain C entry point and loaded with ctypes (ai_toolkit_tpu_torch/ops/kernels/moe_gmm.py).
//
// Replaces the TPU kernel ai_toolkit_tpu/ops/pallas/moe_gmm.py `_fwd_kernel`
// (pallas_call in `_gs_fwd`): for every BM-row tile of the expert-sorted rows,
//   y = (silu(x W1[g]) * (x W3[g])) W2[g],   g = tile_group[tile],
// with f32 accumulation. x [N, d] and y [N, d] row-major; W1/W3 [E, d, h],
// W2 [E, h, d]; a [N, h] is scratch the caller allocates.
//
// The Pallas kernel keeps a [block_m, d] f32 accumulator in VMEM across a
// sequential hidden-axis grid. A Hopper block has 227 KB of shared memory and
// blocks run in no order, so the work is split in two grouped GEMMs instead,
// each block owning one output tile (moe_gmm_tile.cuh):
//   1. GATE_UP: a = silu(x W1[g]) * (x W3[g]), both products in one block,
//      the SwiGLU in the epilogue; a is written in the input type;
//   2. DOWN:    y = a W2[g].
// What bounds it: 6 N d h operations against the bytes of the three banks
// (E d h each), x, a and y; at the hidream shape (N = 8192 top-2 rows of a
// 4096-token image, d = 2560, h = 6912, E = 4, bf16) that is 0.87 TFLOP
// against ~0.5 GB, so it is compute-bound. The simple design answers that
// only in part: WMMA bf16 tiles with a two-stage cp.async pipeline, and the
// round trip of a through device memory (2 N h bytes each way).

#include "moe_gmm_tile.cuh"

using namespace ait_moe;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every tensor is contiguous; N % 128 == 0,
// d % 64 == 0, h % 64 == 0. Returns the cudaError_t of the launches.
int ait_moe_gmm_fwd(const void* x, const void* w1, const void* w3, const void* w2,
                    const void* tile_group, void* a_buf, void* y, int N, int d, int h,
                    int dtype, void* stream) {
  if (!shapes_ok(N, d, h) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(tile_group);

  Args up{};
  up.a[0] = x;
  up.lda[0] = d;
  up.b[0] = w1;
  up.b[1] = w3;
  up.b_expert[0] = up.b_expert[1] = (long long)d * h;
  up.ldb[0] = up.ldb[1] = h;
  up.out = a_buf;
  up.ldo = h;
  up.tile_group = tg;
  up.K = d;

  Args down{};
  down.a[0] = a_buf;
  down.lda[0] = h;
  down.b[0] = w2;
  down.b_expert[0] = (long long)h * d;
  down.ldb[0] = d;
  down.out = y;
  down.ldo = d;
  down.tile_group = tg;
  down.K = h;

  cudaError_t err;
  if (dtype == 1) {
    err = launch<bf16, GATE_UP, 64>(up, N, h, st);
    if (err == cudaSuccess) err = launch_wide<bf16, DOWN>(down, N, d, st);
  } else {
    err = launch<float, GATE_UP, 64>(up, N, h, st);
    if (err == cudaSuccess) err = launch_wide<float, DOWN>(down, N, d, st);
  }
  return (int)err;
}

const char* ait_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
