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
// K = 27, Cin -> 32 with Cin 7, 10 or 135).  Three routes, chosen by the
// wrapper (ops/conv_bwd.py) from the input type and Cin alone, as K1's:
//
//   ir_conv_dw_tc    bf16 with Cin in {32, 64, 128} (the downs):
//     irsc::tc::dw_tc_kernel (sparse_conv_tc.cuh).  Block (k, split) walks
//     its 64-row tiles, gathers the x rows named by nbr[r, k] and stages
//     the g rows as a contiguous tile, both with 16-byte cp.async in a ring
//     of 2, and accumulates x^T g with mma.sync.m16n8k16 from ldmatrix.trans;
//     tiles with no valid index at k are skipped.
//   ir_conv_dw_stem_wide  bf16 at any other Cin (the stems: 7, 10, 135):
//     irsc::stem::stem_wide_dw_kernel (sparse_conv_stem.cuh), one product
//     cols^T g over the rows' im2col, each neighbour's row zero-padded to
//     16 bytes, the depth in blocks of 768 columns on the grid (48
//     accumulators a thread, 16 warps), so g and the map are read once per
//     block; 64-row tiles gathered by 16-byte cp.async in a ring of 2.
//   ir_conv_dw       f32: the FMA template irsc::dw_partial_kernel
//     (sparse_conv.cuh) over a (K, split, Cin tile of 128) grid.

// What bounds it on the card.  The downs: the rows staged.  A down map
// names each input row at most once, so the x side is read about once in
// all whatever the grid; g is read once per offset (8 passes, from L2).
// One pass over g for all 8 offsets would need 8 x Cin x Cout accumulators
// a block (64 a thread at 32 -> 64 with 8 warps, more at the wider stages),
// a second kernel design for one shape; the (k, split) grid keeps one
// template at every down and spreads the small stages over more blocks.  The
// stems: the gather.  The FMA kernel this replaced read its split's g rows
// once per offset (27 passes) and gathered x with scalar loads into f32
// tiles.  Here g and the map are read once per 768 depth columns (5 times
// at Cin 135, once at 7 and 10), and the 16-byte gathers of x, 27 x 272
// bytes a row at Cin 135 (4.3 GB from L2 at the scene stem), bound it.
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

// K3's dW on tensor cores: cin and cout each one of 32, 64, 128
// (instantiated here only, the one library that launches it).
cudaError_t dispatch_dw_tc(const void* x, const void* g, const void* nbr, void* partial, void* dw,
                           long long rows, int k_offsets, int cin, int cout, int splits,
                           cudaStream_t stream) {
#define IRSC_DW_TC(CI, CO) \
  return irsc::tc::launch_dw_tc<CI, CO>(x, g, nbr, partial, dw, rows, k_offsets, splits, stream)
#define IRSC_DW_TC_COUT(CI)                \
  switch (cout) {                          \
    case 32: IRSC_DW_TC(CI, 32);           \
    case 64: IRSC_DW_TC(CI, 64);           \
    case 128: IRSC_DW_TC(CI, 128);         \
    default: return cudaErrorInvalidValue; \
  }
  switch (cin) {
    case 32: IRSC_DW_TC_COUT(32)
    case 64: IRSC_DW_TC_COUT(64)
    case 128: IRSC_DW_TC_COUT(128)
    default: return cudaErrorInvalidValue;
  }
#undef IRSC_DW_TC_COUT
#undef IRSC_DW_TC
}

}  // namespace

// The FMA route: float32 feats and g (dtype code 0; bf16 always takes one
// of the tensor-core routes below).  partial is f32 scratch of splits * K *
// cin * cout; dw is f32 [K, cin, cout].
extern "C" int ir_conv_dw(const void* feats, const void* nbr, const void* g, void* partial,
                          void* dw, long long v_out, int k_offsets, int cin, int cout,
                          int splits, int dtype, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits) || dtype != 0) return cudaErrorInvalidValue;
  return irsc::dispatch_dw<float, true>(feats, g, nbr, partial, dw, v_out, k_offsets, cin, cout,
                                        splits, static_cast<cudaStream_t>(stream));
}

// The tensor-core route: bfloat16 feats and g (16-byte aligned), cin and
// cout each one of 32, 64, 128; the other arguments as above.
extern "C" int ir_conv_dw_tc(const void* feats, const void* nbr, const void* g, void* partial,
                             void* dw, long long v_out, int k_offsets, int cin, int cout,
                             int splits, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits)) return cudaErrorInvalidValue;
  return dispatch_dw_tc(feats, g, nbr, partial, dw, v_out, k_offsets, cin, cout, splits,
                        static_cast<cudaStream_t>(stream));
}

// The stem route: bfloat16 feats [V_in, channels(cin)] (cin up to
// MAX_CIN, rows zero-padded to a multiple of 8 channels) and g as above,
// both 16-byte aligned; dw is [27, cin, cout], with no padding rows.
extern "C" int ir_conv_dw_stem_wide(const void* feats, const void* nbr, const void* g,
                                    void* partial, void* dw, long long v_out, int k_offsets,
                                    int cin, int cout, int splits, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits) || k_offsets != irsc::stem::K ||
      cin > irsc::stem::MAX_CIN)
    return cudaErrorInvalidValue;
  return irsc::stem::launch_dw(feats, g, nbr, partial, dw, v_out, cin, cout, splits,
                               static_cast<cudaStream_t>(stream));
}
