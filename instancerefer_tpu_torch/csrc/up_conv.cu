// The inverse sparse convs of PointGroup's U-Net (spconv's
// SparseInverseConv3d over the map of the down conv it mirrors), for
// sm_90a:
//
//   forward  out[down[v, k]] = x[v] @ W[k]      fine rows no entry names: 0
//   dX       dx[v] = sum_k g[down[v, k]] @ W[k]^T
//   dW       dW[k] = sum_v x[v]^T g[down[v, k]]
//
// x [V_coarse, Cin] the coarse rows, W [8, Cin, Cout] as stored, out and g
// [V_fine, Cout].  A stride-2 down map names each fine row at most once, so
// the forward has the shape of the down conv's dX and runs its kernel over
// the same per-offset lists (dx_list_tc_kernel's body, here
// up_fwd_tc_kernel with a bf16 output, the weight passed transposed); the
// dX is K1's gather over the down map (gather_gemm_tc_body, here
// up_dgrad_tc_kernel reading W as stored); the dW is K3 over the lists
// (dw_list_tc_body, here up_wgrad_tc_kernel writing [Cout][Cin] a slice).
// Every row has one writer, and the dW splits add in a fixed order, so two
// launches give bit-identical results.  The kernels carry names of their
// own so that a trace tells the inverse convs apart from the downs whose
// pairs they share.
//
// There is no TPU kernel to replace: the JAX package has no PointGroup.
// What bounds them is what bounds the downs' list kernels (the gathers'
// latency, sparse_conv_tc.cuh's note): the forward stages only the listed
// coarse rows and W[k] once a block, and writes every fine row once.
//
// C interface (bound with ctypes by ops/sparse_conv.py): each entry returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue for an
// unsupported shape.  (cout, cin) of the inverse conv is one of the down
// pairs IRSC_PG_DOWN_PAIRS (the inverse of a c -> c + 16 down is c + 16 ->
// c); all pointers 16-byte aligned; work is the list pass's workspace of
// down (lists [8, v_coarse], then counts [8]).

#include "sparse_conv_tc.cuh"

namespace {

bool bad_map(long long v_coarse, long long v_fine, int k_offsets, int splits) {
  return v_coarse < 0 || v_coarse > 0x7fffffffLL || v_fine <= 0 || k_offsets != 8 ||
         splits <= 0 || splits > 65535;
}

}  // namespace

// The forward: x bf16 [v_coarse, cin], wt bf16 [8, cout, cin] (W^T a
// slice), down int32 [v_coarse, 8], up8 int32 [v_fine, 8]; out bf16
// [v_fine, cout]; splits the blocks a list (ops/conv_bwd.dx_list_splits).
extern "C" int ir_up_conv_tc(const void* x, const void* down, const void* up8, const void* wt,
                             const void* work, void* out, long long v_coarse, long long v_fine,
                             int k_offsets, int cin, int cout, int splits, void* stream) {
  if (bad_map(v_coarse, v_fine, k_offsets, splits)) return cudaErrorInvalidValue;
  const int* lists = static_cast<const int*>(work);
  const int* counts = lists + k_offsets * v_coarse;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IRSC_UP(CI, CO)                                                                        \
  if (cout == CI && cin == CO)                                                                 \
    return irsc::tc::launch_dx_list_tc<CI, CO, true>(x, down, up8, wt, lists, counts, out,     \
                                                     v_coarse, v_fine, k_offsets, splits,      \
                                                     false, s);
  IRSC_PG_DOWN_PAIRS(IRSC_UP)
#undef IRSC_UP
  return cudaErrorInvalidValue;
}

// The dX: g bf16 [v_fine, cout], w bf16 [8, cin, cout] as stored, down
// int32 [v_coarse, 8]; dx bf16 [v_coarse, cin]; (bm, cs) the plan of
// ops/gather_conv.tc_plan.
extern "C" int ir_up_dx_tc(const void* g, const void* down, const void* w, void* dx,
                           long long v_coarse, int k_offsets, int cin, int cout, int bm, int cs,
                           void* stream) {
  if (!irsc::tc::tile_plan_ok(bm, cs) || v_coarse <= 0 || k_offsets != 8 ||
      (v_coarse + bm - 1) / bm * cs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IRSC_UPDX(CI, CO)                                                                      \
  if (cout == CI && cin == CO)                                                                 \
    return irsc::tc::launch_up_dx_tc<CI, CO>(g, down, w, dx, v_coarse, k_offsets, cs, s);
  IRSC_PG_DOWN_PAIRS(IRSC_UPDX)
#undef IRSC_UPDX
  return cudaErrorInvalidValue;
}

// The dW: g bf16 [v_fine, cout] (read through down), x bf16 [v_coarse,
// cin]; partial f32 scratch of splits * 8 * cin * cout; dw f32 [8, cin,
// cout] as the weight is stored; splits of each list
// (ops/conv_bwd.dw_list_splits at (cout, cin)).
extern "C" int ir_up_dw_tc(const void* g, const void* down, const void* x, const void* work,
                           void* partial, void* dw, long long v_coarse, int k_offsets, int cin,
                           int cout, int splits, void* stream) {
  if (bad_map(v_coarse, 1, k_offsets, splits) || v_coarse == 0) return cudaErrorInvalidValue;
  const int* lists = static_cast<const int*>(work);
  const int* counts = lists + k_offsets * v_coarse;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IRSC_UPDW(CI, CO)                                                                   \
  if (cout == CI && cin == CO)                                                              \
    return irsc::tc::launch_dw_list_tc<CI, CO, true>(g, x, down, lists, counts, partial, dw, \
                                                     v_coarse, k_offsets, splits, s);
  IRSC_PG_DOWN_PAIRS(IRSC_UPDW)
#undef IRSC_UPDW
  return cudaErrorInvalidValue;
}
