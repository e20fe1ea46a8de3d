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
//   ir_gather_conv_tc  bf16 with Cin >= 16 (every down, residual and up8
//     call): irsc::tc::gather_gemm_tc_kernel (sparse_conv_tc.cuh).  Tiles of
//     64 output rows x Cout, 4 warps issuing mma.sync.m16n8k16 (bf16 in, f32
//     accumulate) from ldmatrix; per offset, the 64 rows are gathered by
//     index with 16-byte cp.async (a -1 index zero-fills its row) and W[k]
//     is staged the same way, in a ring of 2 so the next offset's gather
//     overlaps this one's MMAs.  Offsets with no valid index in the tile are
//     skipped, and a tile of padding rows only stores its epilogue.
//   ir_gather_conv_stem  bf16 with Cin <= 8 (the two stems, 7 -> 32):
//     irsc::stem::stem_conv_kernel (sparse_conv_stem.cuh).  The tile's depth
//     comes from its im2col, not from Cin: the 64 rows' 27 neighbours side
//     by side, 27 x 7 = 189 columns padded to 192 (12 k-steps of 16), times
//     W [27, 7, Cout] read as stored, [189, Cout], staged once per block;
//     one MMA loop over the whole depth, the same epilogue.
//   ir_gather_conv     f32 inputs, and bf16 with 8 < Cin < 16 (the stems'
//     10 channels with use_normal): the FMA template
//     irsc::gather_gemm_kernel (sparse_conv.cuh), f32 products and sums in
//     registers (a tensor-core f32 path would be TF32).
//
// What bounds the tensor-core route on the card: the bytes it stages, not
// the MMAs.  Per block and offset it moves 64 gathered rows (Cin x 2 B
// each) and the whole W[k] slice (Cin x Cout x 2 B, up to 32 KB) from L2
// into shared memory for 2 x 64 x Cin x Cout flops: 32 KB of weights per
// 2.1 MFLOP at 128 -> 128, which the L2 serves more slowly than the tensor
// cores consume it.  Taller tiles would share W[k] across more rows at the
// cost of blocks on the small stages; that is the next lever.
//
// What bounds the stem route: the staging of gathered rows.  Each 64-row
// block gathers 64 x 27 rows of 14 bytes with 2-byte loads (1728 L2 reads
// of a row for 64 output rows, 24 KB of tile) and stages the 12 KB of W
// once, for 2 x 64 x 192 x 32 flops, which the tensor cores finish long
// before the loads.  Each thread keeps 27 of its loads in flight (they go
// to registers first and to shared memory after), and four blocks an SM
// hide the rest of their latency behind each other.  The FMA kernel it
// replaces staged W[k] per offset and issued f32 FMAs at ~20 TFLOP/s
// (PERF.md).
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported shape.

#include "sparse_conv.cuh"
#include "sparse_conv_stem.cuh"
#include "sparse_conv_tc.cuh"

namespace {

using irsc::launch_gather_gemm;

// BK: input channels per shared tile (8 for Cin <= 8, as f32 stems have,
// 32 otherwise); a ragged Cin is padded with zeros inside the tile.
template <typename T, typename O>
cudaError_t dispatch(const void* feats, const void* nbr, const void* w, const void* scale,
                     const void* bias, void* out, long long v_out, int k_offsets, int cin,
                     int cout, int relu, cudaStream_t stream) {
  const bool narrow = cin <= 8;
#define IR_K1(CO)                                                                              \
  return narrow ? launch_gather_gemm<T, O, CO, 8, false>(feats, nbr, w, scale, bias, out,     \
                                                          v_out, k_offsets, cin, relu, stream) \
                : launch_gather_gemm<T, O, CO, 32, false>(feats, nbr, w, scale, bias, out,    \
                                                           v_out, k_offsets, cin, relu, stream)
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

// The FMA route.  dtype: 0 = float32, 1 = bfloat16 (feats and w share it).
// out_dtype: the same codes; float32 input takes float32 output, bfloat16
// input either.  scale and bias are float32 [cout], both null for no affine
// epilogue.
extern "C" int ir_gather_conv(const void* feats, const void* nbr, const void* w,
                              const void* scale, const void* bias, void* out,
                              long long v_out, int k_offsets, int cin, int cout, int relu,
                              int dtype, int out_dtype, void* stream) {
  if (bad_rows(v_out, k_offsets, cin, irsc::GEMM_BM)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    return dispatch<float, float>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, cout,
                                  relu, s);
  if (dtype == 1 && out_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(feats, nbr, w, scale, bias, out, v_out,
                                                  k_offsets, cin, cout, relu, s);
  if (dtype == 1 && out_dtype == 0)
    return dispatch<__nv_bfloat16, float>(feats, nbr, w, scale, bias, out, v_out, k_offsets,
                                          cin, cout, relu, s);
  return cudaErrorInvalidValue;
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

// The stem route: bfloat16 feats [V_in, cin] with cin <= 8, nbr [v_out, 27],
// w [27, cin, cout] as stored (16-byte aligned), cout one of 32, 64, 128;
// out_dtype 0 = float32, 1 = bfloat16.
extern "C" int ir_gather_conv_stem(const void* feats, const void* nbr, const void* w,
                                   const void* scale, const void* bias, void* out,
                                   long long v_out, int k_offsets, int cin, int cout, int relu,
                                   int out_dtype, void* stream) {
  if (bad_rows(v_out, k_offsets, cin, irsc::stem::BM) || k_offsets != irsc::stem::K ||
      cin > irsc::stem::MAX_CIN)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return irsc::stem::dispatch_conv<__nv_bfloat16>(feats, nbr, w, scale, bias, out, v_out, cin,
                                                    cout, relu, s);
  if (out_dtype == 0)
    return irsc::stem::dispatch_conv<float>(feats, nbr, w, scale, bias, out, v_out, cin, cout,
                                            relu, s);
  return cudaErrorInvalidValue;
}
