// Grouped SwiGLU input gradient (dx) of the MoE FFN for Hopper (sm_90a),
// exported through a plain C entry point and loaded with ctypes
// (ai_toolkit_tpu_torch/ops/kernels/moe_gmm.py).
//
// Replaces the TPU kernel ai_toolkit_tpu/ops/pallas/moe_gmm.py `_dx_kernel`
// (first pallas_call in `_gs_bwd`): for every BM-row tile, with
// g = tile_group[tile], h1 = x W1[g], h3 = x W3[g] recomputed (the forward
// saves only its inputs) and dp = dy W2[g]^T,
//   dh1 = dp * h3 * silu'(h1),  dh3 = dp * silu(h1),
//   dx  = dh1 W1[g]^T + dh3 W3[g]^T,
// with f32 accumulation. x, dy, dx [N, d]; W1/W3 [E, d, h], W2 [E, h, d];
// dh [N, 2h] is scratch the caller allocates ([dh1 | dh3] per row).
// When a bank needs its gradient the caller also passes act [N, h], which
// the first pass fills with silu(h1) h3 (mode DW_HIDDEN), and moe_gmm_dw.cu
// reads dh and act; when x needs no gradient it passes no dx, and only the
// first pass runs.
//
// As in the forward, the Pallas kernel's [block_m, d] f32 accumulator over a
// sequential hidden-axis grid does not carry over; two grouped GEMMs, each
// block the one owner of its output tile, no atomics (so dx is the same bits
// from run to run):
//   1. hidden (DX_HIDDEN / DW_HIDDEN): h1, h3 and dp for a 128 x 64 tile of
//      the hidden axis in one block, dh1 and dh3 (and act) in the epilogue;
//   2. out (DX_OUT): dx = [dh1 | dh3] [W1[g] | W3[g]]^T, one reduction over 2h.
// What bounds it: 10 N d h operations against the three banks, x, dy, dh and
// dx; compute-bound at the hidream shape (1.45 TFLOP at N = 8192, d = 2560,
// h = 6912). bf16 runs both passes on the wgmma/TMA engine of
// moe_gmm_sm90.cuh (its note has the design, the block order and the traps);
// f32 keeps moe_gmm_tile.cuh's CUDA-core path for the exact checks.

#include "moe_gmm_sm90.cuh"

using namespace ait_moe;

namespace {

cudaError_t dx_bf16(const void* x, const void* dy, const void* w1, const void* w3, const void* w2, const int* tg,
                    const int* order_hidden, const int* order_out, void* dh_buf, void* act, void* dx, int N, int d,
                    int h, int E, int bn_out, cudaStream_t st) {
  if (d % bn_out || (bn_out != 64 && bn_out != 128)) return cudaErrorInvalidValue;
  cudaError_t err = act ? sm90::launch_hidden<DW_HIDDEN>(x, dy, w1, w3, w2, tg, order_hidden, dh_buf, act, N, d, h,
                                                          E, st)
                        : sm90::launch_hidden<DX_HIDDEN>(x, dy, w1, w3, w2, tg, order_hidden, dh_buf, nullptr, N,
                                                          d, h, E, st);
  if (err != cudaSuccess || !dx) return err;
  return bn_out == 128 ? sm90::launch_out<128>(dh_buf, w1, w3, tg, order_out, dx, N, d, h, E, st)
                       : sm90::launch_out<64>(dh_buf, w1, w3, tg, order_out, dx, N, d, h, E, st);
}

cudaError_t dx_f32(const void* x, const void* dy, const void* w1, const void* w3, const void* w2, const int* tg,
                   void* dh_buf, void* act, void* dx, int N, int d, int h, cudaStream_t st) {
  Args hid{};
  hid.a[0] = x;
  hid.a[1] = dy;
  hid.lda[0] = hid.lda[1] = d;
  hid.b[0] = w1;  // h1 = x W1[g]
  hid.b[1] = w3;  // h3 = x W3[g]
  hid.b[2] = w2;  // dp = dy W2[g]^T: element (k, n) = W2[g][n][k]
  hid.b_expert[0] = hid.b_expert[1] = hid.b_expert[2] = (long long)d * h;
  hid.ldb[0] = hid.ldb[1] = h;
  hid.ldb[2] = d;
  hid.out = dh_buf;
  hid.ldo = 2LL * h;
  hid.out2_col = h;
  hid.act = act;
  hid.ld_act = h;
  hid.tile_group = tg;
  hid.K = d;

  Args out{};
  out.a[0] = dh_buf;
  out.lda[0] = 2LL * h;
  out.b[0] = w1;  // dh1 W1[g]^T: element (k, n) = W1[g][n][k], k < h
  out.b_alt = w3;  // dh3 W3[g]^T for k >= h
  out.b_expert[0] = (long long)d * h;
  out.ldb[0] = h;
  out.k_split = h;
  out.out = dx;
  out.ldo = d;
  out.tile_group = tg;
  out.K = 2 * h;

  cudaError_t err = act ? launch<float, DW_HIDDEN, 64>(hid, N, h, st) : launch<float, DX_HIDDEN, 64>(hid, N, h, st);
  if (err == cudaSuccess && dx) err = launch_wide<float, DX_OUT>(out, N, d, st);
  return err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every tensor is contiguous; N % 128 == 0,
// d % 64 == 0, h % 64 == 0; act and dx may be null. bf16 reads x, dy, dh and
// the banks by TMA (16-byte aligned bases; the wrapper checks) and takes the
// width of the dx tiles of its second pass (bn_out divides d; 64 or 128; the
// first pass takes 64 hidden columns) and the block orders of both passes:
// order_hidden [(N/128) (h/64)] and order_out [(N/128) (d/bn_out)], the tile
// index (row tile * column tiles + column tile) of each block. f32 ignores E,
// the orders and bn_out.
// Returns the cudaError_t of the launches.
int ait_moe_gmm_dx(const void* x, const void* dy, const void* w1, const void* w3, const void* w2,
                   const void* tile_group, const void* order_hidden, const void* order_out, void* dh_buf, void* act,
                   void* dx, int N, int d, int h, int E, int bn_out, int dtype, void* stream) {
  if (!shapes_ok(N, d, h) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(tile_group);
  if (dtype == 1)
    return (int)dx_bf16(x, dy, w1, w3, w2, tg, static_cast<const int*>(order_hidden),
                        static_cast<const int*>(order_out), dh_buf, act, dx, N, d, h, E, bn_out, st);
  return (int)dx_f32(x, dy, w1, w3, w2, tg, dh_buf, act, dx, N, d, h, st);
}

const char* ait_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
