// K3: sparse-conv weight gradient, for sm_90a.
//
//   dW[k] = sum_v feats[nbr[v, k]]^T g[v]        [K, Cin, Cout], f32
//
// Replaces the TPU kernel instancerefer_tpu/ops/pallas_conv.py:_dw_kernel
// (called through windowed_conv_dw).  That kernel walks the row chunks in
// order on one core, gathers feats by one-hot matmuls over per-offset bands
// and carries dW across the grid in VMEM.  Here the gather is exact, and
// the sum over rows, which on the card spans blocks that run in no order,
// is a deterministic split reduction: each block keeps its product in
// registers and writes its own partial; irsc::sum_partials_kernel adds the
// partials in a fixed order.  No float atomics, so two launches on the
// same inputs give bit-identical dW.
//
// Call sites: the 2^3 stride-2 down convs' dW (over down, K = 8, 32 -> 64,
// 64 -> 128, 128 -> 128) and the stems' dW-only backward (over nbr3,
// K = 27, 7 -> 32).  Three routes, chosen by the wrapper (ops/conv_bwd.py)
// from the input type and Cin alone, as K1's:
//
//   ir_conv_dw_tc    bf16 with Cin >= 16 (the downs):
//     irsc::tc::dw_tc_kernel<GATHER_X> (sparse_conv_tc.cuh), K2's dW
//     template with the gather moved to the x side.  Block (k, split) walks
//     its 64-row tiles, gathers the x rows named by nbr[r, k] and stages
//     the g rows as a contiguous tile, both with 16-byte cp.async in a ring
//     of 2, and accumulates x^T g with mma.sync.m16n8k16 from ldmatrix.trans;
//     tiles with no valid index at k are skipped.
//   ir_conv_dw_stem  bf16 with Cin <= 8 (the two stems):
//     irsc::stem::stem_dw_kernel (sparse_conv_stem.cuh), one pass over g
//     for all 27 offsets: dW as one product cols^T g, where cols is the
//     im2col of a 64-row tile (27 x 7 = 189 columns, padded to 192) and
//     the [192, 32] product stays in registers (56 floats a thread).
//   ir_conv_dw       f32, and bf16 with 8 < Cin < 16 (the stems' 10
//     channels with use_normal): the FMA template irsc::dw_partial_kernel
//     (sparse_conv.cuh) over a (K, split) grid.
//
// What bounds it on the card.  The downs: the rows staged.  A down map
// names each input row at most once, so the x side is read about once in
// all whatever the grid; g is read once per offset (8 passes, from L2).
// One pass over g for all 8 offsets would need 8 x Cin x Cout accumulators
// a block (64 a thread at 32 -> 64 with 8 warps, more at the wider stages),
// a second kernel design for one shape; the (k, split) grid keeps K2's
// tested template and spreads the small stages over more blocks.  The
// stems: the gather.  The FMA kernel this replaces read its split's g rows
// once per offset (27 passes) and gathered x with scalar loads into f32
// tiles; here g is read once, each x row (14 bytes, 2-byte aligned) is read
// 27 times with 2-byte loads, eight lanes a row (from L2: 8 MB of x at the
// scene stem), and the MMAs, 12 k-steps of 16 a tile at Cin = 7, finish
// long before the loads.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for an unsupported shape.

#include "sparse_conv.cuh"
#include "sparse_conv_stem.cuh"
#include "sparse_conv_tc.cuh"

namespace {

bool bad_shape(long long v_out, int k_offsets, int cin, int splits) {
  return v_out <= 0 || k_offsets <= 0 || cin <= 0 || splits <= 0 || splits > 65535;
}

}  // namespace

// The FMA route.  dtype: 0 = float32, 1 = bfloat16 (feats and g share it).
// partial is f32 scratch of splits * K * cin * cout; dw is f32 [K, cin,
// cout].
extern "C" int ir_conv_dw(const void* feats, const void* nbr, const void* g, void* partial,
                          void* dw, long long v_out, int k_offsets, int cin, int cout,
                          int splits, int dtype, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return irsc::dispatch_dw<float, true>(feats, g, nbr, partial, dw, v_out, k_offsets, cin,
                                          cout, splits, s);
  if (dtype == 1)
    return irsc::dispatch_dw<__nv_bfloat16, true>(feats, g, nbr, partial, dw, v_out, k_offsets,
                                                  cin, cout, splits, s);
  return cudaErrorInvalidValue;
}

// The tensor-core route: bfloat16 feats and g (16-byte aligned), cin and
// cout each one of 32, 64, 128; the other arguments as above.
extern "C" int ir_conv_dw_tc(const void* feats, const void* nbr, const void* g, void* partial,
                             void* dw, long long v_out, int k_offsets, int cin, int cout,
                             int splits, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits)) return cudaErrorInvalidValue;
  return irsc::tc::dispatch_dw_tc<true>(feats, g, nbr, partial, dw, v_out, k_offsets, cin, cout,
                                        splits, static_cast<cudaStream_t>(stream));
}

// The stem route: bfloat16 feats [V_in, cin] with cin <= 8, nbr [v_out, 27],
// g [v_out, cout] (16-byte aligned) with cout a multiple of 32; partial is
// f32 scratch of splits * 27 * cin * cout.
extern "C" int ir_conv_dw_stem(const void* feats, const void* nbr, const void* g, void* partial,
                               void* dw, long long v_out, int k_offsets, int cin, int cout,
                               int splits, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits) || k_offsets != irsc::stem::K ||
      cin > irsc::stem::MAX_CIN)
    return cudaErrorInvalidValue;
  return irsc::stem::launch_dw(feats, g, nbr, partial, dw, v_out, cin, cout, splits,
                               static_cast<cudaStream_t>(stream));
}
