// Grouped SwiGLU forward of the MoE FFN for Hopper (sm_90a), exported through
// a plain C entry point and loaded with ctypes (ai_toolkit_tpu_torch/ops/kernels/moe_gmm.py).
//
// Replaces the TPU kernel ai_toolkit_tpu/ops/pallas/moe_gmm.py `_fwd_kernel`
// (pallas_call in `_gs_fwd`): for every BM-row tile of the expert-sorted rows,
//   y = (silu(x W1[g]) * (x W3[g])) W2[g],   g = tile_group[tile],
// with f32 accumulation. x [N, d] and y [N, d] row-major; W1/W3 [E, d, h],
// W2 [E, h, d]; act [N, h] is scratch the caller allocates.
//
// The Pallas kernel keeps a [block_m, d] f32 accumulator in VMEM across a
// sequential hidden-axis grid. A Hopper block has 227 KB of shared memory and
// blocks run in no order, so the work is split in two grouped GEMMs instead,
// each block owning one output tile:
//   1. GATE_UP: act = silu(x W1[g]) * (x W3[g]), both products in one block,
//      the SwiGLU in the epilogue; act is written in the input type;
//   2. DOWN:    y = act W2[g].
// What bounds it: 6 N d h operations against the bytes of the three banks
// (E d h each), x, act and y; at the hidream shape (N = 8192 top-2 rows of a
// 4096-token image, d = 2560, h = 6912, E = 4, bf16) that is 0.87 TFLOP
// against ~0.5 GB, so it is compute-bound. bf16 runs both passes on the
// wgmma/TMA engine of moe_gmm_sm90.cuh (moe_hidden_sm90<GATE_UP>: 128 x 128
// tiles of act, two f32 accumulators a thread, a 4-stage ring of 48 KB;
// moe_out_sm90<DOWN>: 128 x 128 tiles of y, W2 an MN-major B); f32 keeps
// moe_gmm_tile.cuh's CUDA-core path for the exact checks.

#include "moe_gmm_sm90.cuh"

using namespace ait_moe;

namespace {

cudaError_t fwd_bf16(const void* x, const void* w1, const void* w3, const void* w2, const int* tg,
                     const int* order_gate_up, const int* order_down, void* act, void* y, int N, int d, int h, int E,
                     int bn_hidden, int bn_out, cudaStream_t st) {
  if (h % bn_hidden || d % bn_out || (bn_hidden != 64 && bn_hidden != 128) || (bn_out != 64 && bn_out != 128))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (x)
    err = bn_hidden == 128
              ? sm90::launch_hidden<GATE_UP, 128>(x, nullptr, w1, w3, nullptr, tg, order_gate_up, nullptr, act, N, d,
                                                  h, E, st)
              : sm90::launch_hidden<GATE_UP, 64>(x, nullptr, w1, w3, nullptr, tg, order_gate_up, nullptr, act, N, d,
                                                 h, E, st);
  if (err != cudaSuccess || !y) return err;
  return bn_out == 128 ? sm90::launch_out<DOWN, 128>(act, w2, nullptr, tg, order_down, y, N, d, h, E, st)
                       : sm90::launch_out<DOWN, 64>(act, w2, nullptr, tg, order_down, y, N, d, h, E, st);
}

cudaError_t fwd_f32(const void* x, const void* w1, const void* w3, const void* w2, const int* tg, void* act, void* y,
                    int N, int d, int h, cudaStream_t st) {
  Args up{};
  up.a[0] = x;
  up.lda[0] = d;
  up.b[0] = w1;
  up.b[1] = w3;
  up.b_expert[0] = up.b_expert[1] = (long long)d * h;
  up.ldb[0] = up.ldb[1] = h;
  up.out = act;
  up.ldo = h;
  up.tile_group = tg;
  up.K = d;

  Args down{};
  down.a[0] = act;
  down.lda[0] = h;
  down.b[0] = w2;
  down.b_expert[0] = (long long)h * d;
  down.ldb[0] = d;
  down.out = y;
  down.ldo = d;
  down.tile_group = tg;
  down.K = h;

  cudaError_t err = x ? launch<GATE_UP, 64>(up, N, h, st) : cudaSuccess;
  if (err == cudaSuccess && y) err = launch_wide<DOWN>(down, N, d, st);
  return err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every tensor is contiguous; N % 128 == 0,
// d % 64 == 0, h % 64 == 0. With x null only DOWN runs, on the act given;
// with y null only GATE_UP runs, into act. bf16 reads x, act and the banks by
// TMA (16-byte aligned bases; the wrapper checks) and takes the tile widths
// of both passes (bn_hidden divides h, bn_out divides d; 64 or 128) and their
// block orders: order_gate_up [(N/128) (h/bn_hidden)] and order_down
// [(N/128) (d/bn_out)], the tile index (row tile * column tiles + column
// tile) of each block. f32 ignores E, the orders and the widths.
// Returns the cudaError_t of the launches.
int ait_moe_gmm_fwd(const void* x, const void* w1, const void* w3, const void* w2, const void* tile_group,
                    const void* order_gate_up, const void* order_down, void* act, void* y, int N, int d, int h,
                    int E, int bn_hidden, int bn_out, int dtype, void* stream) {
  if (!shapes_ok(N, d, h) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(tile_group);
  if (dtype == 1)
    return (int)fwd_bf16(x, w1, w3, w2, tg, static_cast<const int*>(order_gate_up),
                         static_cast<const int*>(order_down), act, y, N, d, h, E, bn_hidden, bn_out, st);
  return (int)fwd_f32(x, w1, w3, w2, tg, act, y, N, d, h, st);
}

const char* ait_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
