// K3: sparse-conv weight gradient, for sm_90a.
//
//   dW[k] = sum_v feats[nbr[v, k]]^T g[v]        [K, Cin, Cout], f32
//
// Replaces the TPU kernel instancerefer_tpu/ops/pallas_conv.py:_dw_kernel
// (called through windowed_conv_dw).  That kernel walks the row chunks in
// order on one core, gathers feats by one-hot matmuls over per-offset bands
// and carries dW across the grid in VMEM.  Here the gather is exact, and
// the sum over rows, which on the card spans blocks that run in no order,
// is a deterministic split reduction (irsc::dw_partial_kernel and
// irsc::sum_partials_kernel in sparse_conv.cuh): block (k, s) keeps its
// [Cin, Cout] product in registers and writes partial[s, k]; a second
// kernel adds the S partials in a fixed order.  No float atomics, so two
// launches on the same inputs give bit-identical dW.
//
// Call sites: the 2^3 stride-2 down convs' dW (over down, K = 8) and the
// stems' dW-only backward (over nbr3, K = 27, Cin = 7, taken as it is and
// zero-padded to 8 in shared memory).
//
// What bounds it on the card: the rows it reads.  Every (k, s) block reads
// its split's g rows and gathers as many feats rows, K passes over g in
// all (at the scene stem of a 32-scene batch: 581632 rows x 32 channels x
// 27 offsets); the FMA work is 2*K*V*Cin*Cout.  Later work: one pass over g
// for all K offsets where K*Cin*Cout fits the registers, tensor cores
// (mma/wgmma), TMA, and skipping rows whose index is -1.
//
// C interface (bound with ctypes): ir_conv_dw returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for an unsupported shape.

#include "sparse_conv.cuh"

// dtype: 0 = float32, 1 = bfloat16 (feats and g share it).  partial is f32
// scratch of splits * K * cin * cout; dw is f32 [K, cin, cout].
extern "C" int ir_conv_dw(const void* feats, const void* nbr, const void* g, void* partial,
                          void* dw, long long v_out, int k_offsets, int cin, int cout,
                          int splits, int dtype, void* stream) {
  if (v_out <= 0 || k_offsets <= 0 || cin <= 0 || splits <= 0 || splits > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return irsc::dispatch_dw<float, true>(feats, g, nbr, partial, dw, v_out, k_offsets, cin,
                                          cout, splits, s);
  if (dtype == 1)
    return irsc::dispatch_dw<__nv_bfloat16, true>(feats, g, nbr, partial, dw, v_out, k_offsets,
                                                  cin, cout, splits, s);
  return cudaErrorInvalidValue;
}
