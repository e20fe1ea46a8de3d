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
// What bounds it on the card: the gathered bytes.  Each output row reads K
// input rows of Cin values (27 x 128 x 2 B = 6.9 KB per row of a bf16
// 128-channel residual conv) to do 2*K*Cin*Cout flops, so the work is a
// gather feeding a small GEMM.  The largest input stage at the bench's
// batch (32 scenes: 139264 rows x 64 channels, 18 MB in bf16) fits the
// 50 MB L2, so most gathered rows come from L2, not HBM.  Design
// (irsc::gather_gemm_kernel in sparse_conv.cuh): output-stationary tiles of
// 64 rows x Cout channels, rows and weights staged in shared memory as f32,
// FMA into registers; no atomics.  Accumulation is f32 for both input
// types; the epilogue runs on the f32 accumulator and the store rounds to
// the output type.  Tensor cores (mma/wgmma), TMA and skipping all-padding
// tiles are later work.
//
// C interface (bound with ctypes): ir_gather_conv returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported shape.

#include "sparse_conv.cuh"

namespace {

using irsc::launch_gather_gemm;

// BK: input channels per shared tile (8 for the 7-channel stems, 32
// otherwise); a ragged Cin is padded with zeros inside the tile.
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feats and w share it).  out_dtype: the
// same codes; float32 input takes float32 output, bfloat16 input either.
// scale and bias are float32 [cout], both null for no affine epilogue.
extern "C" int ir_gather_conv(const void* feats, const void* nbr, const void* w,
                              const void* scale, const void* bias, void* out,
                              long long v_out, int k_offsets, int cin, int cout, int relu,
                              int dtype, int out_dtype, void* stream) {
  if (v_out <= 0 || k_offsets <= 0 || cin <= 0 ||
      (v_out + irsc::GEMM_BM - 1) / irsc::GEMM_BM > 0x7fffffffLL)
    return cudaErrorInvalidValue;
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
