// K1: sparse-conv gather-GEMM with a fused per-channel epilogue, for sm_90a.
//
//   out[v, :] = epilogue( sum_k feats[nbr[v, k], :] @ W[k] )
//   epilogue(acc) = relu?(acc * scale + bias)     (scale/bias optional)
//
// Replaces the TPU kernel instancerefer_tpu/ops/pallas_conv.py:_conv_kernel
// (called through windowed_gather_conv).  That kernel DMAs a window of
// raster-sorted input rows into VMEM and gathers by one-hot matmuls over
// per-offset bands, because Mosaic cannot gather rows by index; rows outside
// a band are dropped.  Here the gather is exact: every block reads the rows
// its own nbr indices name, so there are no bands, windows or drops.
//
// Call sites: every sparse conv's forward (3^3 subm over nbr3, 2^3 stride-2
// over down), and in training the down conv's dX, which is this kernel over
// the inverse map up8 with W^T and an f32 output.
//
// Three routes, chosen by the wrapper (ops/gather_conv.py) from the input
// type and Cin alone:
//
//   ir_gather_conv_tc  bf16 with Cin in {32, 64, 128} (every down, residual
//     and up8 call): irsc::tc::gather_gemm_tc_kernel (sparse_conv_tc.cuh).
//     Tiles of 64 output rows x Cout, 4 warps issuing mma.sync.m16n8k16
//     (bf16 in, f32 accumulate) from ldmatrix; per offset, the 64 rows are
//     gathered by index with 16-byte cp.async (a -1 index zero-fills its
//     row) and W[k] is staged the same way, in a ring of 2 so the next
//     offset's gather overlaps this one's MMAs.  Offsets with no valid index
//     in the tile are skipped, and a tile of padding rows only stores its
//     epilogue.
//   ir_gather_conv_stem_wide  bf16 at any other Cin (the stems, K = 27: 7,
//     10 with normals, 135 with multiview features -> 32): irsc::stem::
//     stem_wide_conv_kernel (sparse_conv_stem.cuh).  The tile's depth comes
//     from its im2col, not from Cin: the rows' 27 neighbours side by side,
//     each zero-padded to 16 bytes (cp = Cin rounded up to 8 channels),
//     times W [27, Cin, Cout] read as stored, gathered by 16-byte cp.async
//     in a ring of 4 stages of 64 columns, 128-row tiles; the same epilogue.
//   ir_gather_conv     f32 inputs: the FMA template irsc::gather_gemm_kernel
//     (sparse_conv.cuh), f32 products and sums in registers (a tensor-core
//     f32 path would be TF32).

// What bounds the tensor-core route on the card: the bytes it stages, not
// the MMAs.  Per block and offset it moves 64 gathered rows (Cin x 2 B
// each) and the whole W[k] slice (Cin x Cout x 2 B, up to 32 KB) from L2
// into shared memory for 2 x 64 x Cin x Cout flops: 32 KB of weights per
// 2.1 MFLOP at 128 -> 128, which the L2 serves more slowly than the tensor
// cores consume it.  Taller tiles would share W[k] across more rows at the
// cost of blocks on the small stages; that is the next lever.
//
// What bounds the stem route: the bytes from L2 into shared memory, 27 x
// 272 bytes per output row at Cin 135 (4.3 GB at the scene stem, ~27 x
// the x it reads) and W_flat once per 128 rows; the ring keeps three
// stages of it in flight per block, two blocks an SM (the header's note
// has the details).
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported shape.

#include "sparse_conv.cuh"
#include "sparse_conv_stem.cuh"
#include "sparse_conv_tc.cuh"

namespace {

using irsc::launch_gather_gemm;

// BK: input channels per shared tile (8 for Cin <= 8, as the stems have,
// 32 otherwise); a ragged Cin is padded with zeros inside the tile.
cudaError_t dispatch(const void* feats, const void* nbr, const void* w, const void* scale,
                     const void* bias, void* out, long long v_out, int k_offsets, int cin,
                     int cout, int relu, cudaStream_t stream) {
  const bool narrow = cin <= 8;
#define IR_K1(CO)                                                                              \
  return narrow ? launch_gather_gemm<float, float, CO, 8, false>(                              \
                      feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, relu, stream)    \
                : launch_gather_gemm<float, float, CO, 32, false>(                             \
                      feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, relu, stream)
  switch (cout) {
    case 32: IR_K1(32);
    case 64: IR_K1(64);
    case 128: IR_K1(128);
    default: return cudaErrorInvalidValue;
  }
#undef IR_K1
}

bool bad_rows(long long v_out, int k_offsets, int cin, int bm) {
  return v_out <= 0 || k_offsets <= 0 || cin <= 0 || (v_out + bm - 1) / bm > 0x7fffffffLL;
}

}  // namespace

// The FMA route: float32 feats, w and out (dtype and out_dtype codes 0 =
// float32; bf16 always takes one of the tensor-core routes below).  scale
// and bias are float32 [cout], both null for no affine epilogue.
extern "C" int ir_gather_conv(const void* feats, const void* nbr, const void* w,
                              const void* scale, const void* bias, void* out,
                              long long v_out, int k_offsets, int cin, int cout, int relu,
                              int dtype, int out_dtype, void* stream) {
  if (bad_rows(v_out, k_offsets, cin, irsc::GEMM_BM) || dtype != 0 || out_dtype != 0)
    return cudaErrorInvalidValue;
  return dispatch(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, cout, relu,
                  static_cast<cudaStream_t>(stream));
}

// The tensor-core route: bfloat16 feats and w [K, cin, cout] (16-byte
// aligned), cin and cout each one of 32, 64, 128; out_dtype 0 = float32,
// 1 = bfloat16.
extern "C" int ir_gather_conv_tc(const void* feats, const void* nbr, const void* w,
                                 const void* scale, const void* bias, void* out,
                                 long long v_out, int k_offsets, int cin, int cout, int relu,
                                 int out_dtype, void* stream) {
  if (bad_rows(v_out, k_offsets, cin, irsc::tc::BM)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return irsc::tc::dispatch_gather_gemm_tc<__nv_bfloat16, false>(
        feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, cout, relu, s);
  if (out_dtype == 0)
    return irsc::tc::dispatch_gather_gemm_tc<float, false>(feats, nbr, w, scale, bias, out,
                                                           v_out, k_offsets, cin, cout, relu, s);
  return cudaErrorInvalidValue;
}

// The stem route: bfloat16 feats [V_in, channels(cin)] (cin up to
// MAX_CIN, rows zero-padded to a multiple of 8 channels), nbr [v_out, 27],
// w [27, cin, cout] as stored, both 16-byte aligned, cout a multiple of
// 32; out_dtype 0 = float32, 1 = bfloat16.
extern "C" int ir_gather_conv_stem_wide(const void* feats, const void* nbr, const void* w,
                                        const void* scale, const void* bias, void* out,
                                        long long v_out, int k_offsets, int cin, int cout,
                                        int relu, int out_dtype, void* stream) {
  namespace stem = irsc::stem;
  if (bad_rows(v_out, k_offsets, cin, stem::BM) || k_offsets != stem::K ||
      cin > stem::MAX_CIN)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return stem::launch_conv<__nv_bfloat16>(feats, nbr, w, scale, bias, out, v_out, cin, cout,
                                             relu, s);
  if (out_dtype == 0)
    return stem::launch_conv<float>(feats, nbr, w, scale, bias, out, v_out, cin, cout, relu, s);
  return cudaErrorInvalidValue;
}
