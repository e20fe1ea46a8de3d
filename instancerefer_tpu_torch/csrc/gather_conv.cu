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
// over down), and in f32 training on the FMA route the down conv's dX,
// which is this kernel over the inverse map up8 with W^T and an f32
// output.  In bf16 the down conv's dX is ir_down_dx_tc below:
// irsc::tc::dx_list_tc_kernel (sparse_conv_tc.cuh) over the per-offset
// lists of the down map that K3 reads too, each dX row stored once.
//
// Three routes, chosen by the wrapper (ops/gather_conv.py) from the input
// type and Cin alone:
//
//   ir_gather_conv_tc  bf16 with Cin in {32, 64, 128} (every down and
//     residual): irsc::tc::gather_gemm_tc_kernel (sparse_conv_tc.cuh)
//     under the plan the wrapper passes (ops/gather_conv.tc_plan: tiles of
//     64 output rows x Cout, 4 warps issuing mma.sync.m16n8k16 from
//     ldmatrix, bf16 in, f32 accumulate; a cluster of 2 or 4 blocks a tile
//     at 8192-16384 rows, each taking every 2nd or 4th listed offset, their
//     sums added in distributed shared memory in rank order).  Per listed
//     offset (one with a valid index in the tile) the tile's rows are
//     gathered with 16-byte cp.async (a -1 index zero-fills its row) and
//     W[k] is staged the same way, in a ring
//     of 2 steps so the next step's gather overlaps this one's MMAs; a tile
//     of padding rows only stores its epilogue.
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

// What bounds the tensor-core route on the card: the gathers' latency,
// which the blocks on an SM hide in proportion to the steps they keep in
// flight.  Bytes staged from L2 into shared memory at B = 64
// (scripts/conv_bytes.py): the scene's 278528-row 64 -> 64 residual 636 MB
// of gathered rows and 636 MB of W[k] a launch; its stage-1 down (32 -> 64,
// 8 offsets) 104 MB and 104 MB; K1 over a train step 10.38 GB.  The cluster
// split keeps the SMs filled at the 8192-16384-row stages; taller tiles,
// which stage W[k] less often, measured no faster (PERF.md).  The list
// route of the downs' dX stages only the valid entries' g rows, and W[k]
// once a block (scripts/conv_bytes.py's list lines).
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
// aligned), cin and cout each one of 32, 64, 128; (bm, cs) the plan of
// ops/gather_conv.tc_plan (tile height, cluster size), refused unless the
// template is built for it; out_dtype 0 = float32, 1 = bfloat16.
extern "C" int ir_gather_conv_tc(const void* feats, const void* nbr, const void* w,
                                 const void* scale, const void* bias, void* out,
                                 long long v_out, int k_offsets, int cin, int cout, int relu,
                                 int bm, int cs, int out_dtype, void* stream) {
  if (!irsc::tc::tile_plan_ok(bm, cs) || bad_rows(v_out, k_offsets, cin, bm) ||
      (v_out + bm - 1) / bm * cs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return irsc::tc::dispatch_gather_gemm_tc<__nv_bfloat16, false>(
        feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, cout, relu, bm, cs, s);
  if (out_dtype == 0)
    return irsc::tc::dispatch_gather_gemm_tc<float, false>(
        feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, cout, relu, bm, cs, s);
  return cudaErrorInvalidValue;
}

// Shared memory a block of the tensor-core gather-GEMM takes (widths red ->
// nout, mirror 1 for K2's dX layout, k_offsets): ops/gather_conv.
// tc_smem_bytes computes the same on the host.
extern "C" long long ir_tc_smem_bytes(int red, int nout, int mirror, int k_offsets) {
  return static_cast<long long>(irsc::tc::tile_smem_bytes(red, nout, mirror != 0, k_offsets));
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

// The down convs' dX over the per-offset lists of their map (ops/conv_bwd.
// down_dx): bfloat16 g [v_out, cout] and w [K, cin, cout] as stored, the
// int32 down map [v_out, 8] and its inverse up8 [v_in, 8], all 16-byte
// aligned; work the list pass's workspace of down (lists [8, v_out], then
// counts [8]); dx float32 [v_in, cin]; cin and cout each one of 32, 64,
// 128; splits the blocks a list (ops/conv_bwd.dx_list_splits).
extern "C" int ir_down_dx_tc(const void* g, const void* down, const void* up8, const void* w,
                             const void* work, void* dx, long long v_out, long long v_in,
                             int k_offsets, int cin, int cout, int splits, void* stream) {
  if (v_out < 0 || v_out > 0x7fffffffLL || v_in <= 0 || k_offsets != 8 || splits <= 0)
    return cudaErrorInvalidValue;
  const int* lists = static_cast<const int*>(work);
  const int* counts = lists + k_offsets * v_out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IRSC_DX(CI, CO)                                                                     \
  return irsc::tc::launch_dx_list_tc<CI, CO>(g, down, up8, w, lists, counts, dx, v_out, v_in, \
                                             k_offsets, splits, s)
#define IRSC_DX_COUT(CI)                   \
  switch (cout) {                          \
    case 32: IRSC_DX(CI, 32);              \
    case 64: IRSC_DX(CI, 64);              \
    case 128: IRSC_DX(CI, 128);            \
    default: return cudaErrorInvalidValue; \
  }
  switch (cin) {
    case 32: IRSC_DX_COUT(32)
    case 64: IRSC_DX_COUT(64)
    case 128: IRSC_DX_COUT(128)
    default: return cudaErrorInvalidValue;
  }
#undef IRSC_DX_COUT
#undef IRSC_DX
}

// Shared memory a block of the list-driven dX takes: ops/conv_bwd.
// dx_list_smem_bytes computes the same on the host.
extern "C" long long ir_dx_list_smem_bytes(int cin, int cout) {
  return static_cast<long long>(irsc::tc::dx_list_smem_bytes(cin, cout));
}
