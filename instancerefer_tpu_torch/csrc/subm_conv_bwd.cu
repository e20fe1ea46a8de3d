// K2: backward of the 3^3 submanifold sparse conv, for sm_90a.
//
//   dX[u]        = sum_k g[nbr(u, k)] @ W[K-1-k]^T      [V, Cin],       f32
//   dW[K-1-k]    = sum_u x[u]^T g[nbr(u, k)]            [K, Cin, Cout], f32
//
// Both follow from the mirror identity of the symmetric map
// (nbr(v, k) = u  <=>  nbr(u, K-1-k) = v; KERNEL_OFFSETS_3[26-k] ==
// -KERNEL_OFFSETS_3[k] in the host maps' offset order, which is the order
// the port stores its kernels in), so the backward is two gathers over the
// forward's own map and never a scatter.
//
// Replaces the TPU kernel instancerefer_tpu/ops/pallas_conv.py:
// _bwd_fused_kernel (called through windowed_conv_bwd_fused).  That kernel
// gathers g once per offset by one-hot matmuls over per-offset bands and
// feeds the same gathered rows to both dX and dW, carrying dW across its
// sequential grid in VMEM.  This entry point launches two kernels:
//
//   dX: irsc::gather_gemm_kernel with MIRROR_T — output-stationary like K1,
//       W[K-1-k]^T read in place, no atomics, f32 store.
//   dW: irsc::dw_partial_kernel (x rows plain, g rows gathered, written to
//       slot K-1-k) + irsc::sum_partials_kernel — the deterministic split
//       reduction of K3 (conv_dw.cu), no float atomics.
//
// What bounds each part on the card: both are gathers feeding small GEMMs
// (2*K*V*Cin*Cout FMA each).  dX reads K gathered g rows per output row,
// mostly from L2, and the whole weight tensor per 64-row block; dW reads K
// passes over x and K gathered passes over g.  Later work: fuse the two so
// one gather of g feeds both (the TPU kernel's design, halving the gather
// traffic, bounded then by the dW partials' registers), tensor cores
// (mma/wgmma), TMA, and skipping rows whose index is -1.
//
// C interface (bound with ctypes): ir_subm_conv_bwd returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for an
// unsupported shape.

#include "sparse_conv.cuh"

namespace {

using irsc::launch_gather_gemm;

// dX: the reduction runs over g's cout channels (BK = 32), the output has
// the conv's cin channels.
template <typename T>
cudaError_t launch_dx(const void* g, const void* nbr, const void* w, void* dx, long long v,
                      int k_offsets, int cin, int cout, cudaStream_t stream) {
  switch (cin) {
    case 32:
      return launch_gather_gemm<T, float, 32, 32, true>(g, nbr, w, nullptr, nullptr, dx, v,
                                                        k_offsets, cout, 0, stream);
    case 64:
      return launch_gather_gemm<T, float, 64, 32, true>(g, nbr, w, nullptr, nullptr, dx, v,
                                                        k_offsets, cout, 0, stream);
    case 128:
      return launch_gather_gemm<T, float, 128, 32, true>(g, nbr, w, nullptr, nullptr, dx, v,
                                                         k_offsets, cout, 0, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const void* x, const void* nbr, const void* g, const void* w, void* dx,
                void* partial, void* dw, long long v, int k_offsets, int cin, int cout,
                int splits, cudaStream_t stream) {
  const cudaError_t err = launch_dx<T>(g, nbr, w, dx, v, k_offsets, cin, cout, stream);
  if (err != cudaSuccess) return err;
  return irsc::dispatch_dw<T, false>(x, g, nbr, partial, dw, v, k_offsets, cin, cout, splits,
                                     stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g and w share it).  x [v, cin],
// g [v, cout], nbr [v, K] with K odd and symmetric, w [K, cin, cout];
// dx f32 [v, cin]; partial f32 scratch of splits * K * cin * cout; dw f32
// [K, cin, cout].
extern "C" int ir_subm_conv_bwd(const void* x, const void* nbr, const void* g, const void* w,
                                void* dx, void* partial, void* dw, long long v, int k_offsets,
                                int cin, int cout, int splits, int dtype, void* stream) {
  if (v <= 0 || k_offsets <= 0 || k_offsets % 2 == 0 || cout < 32 || splits <= 0 ||
      splits > 65535 || (v + irsc::GEMM_BM - 1) / irsc::GEMM_BM > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, nbr, g, w, dx, partial, dw, v, k_offsets, cin, cout, splits, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, nbr, g, w, dx, partial, dw, v, k_offsets, cin, cout, splits,
                              s);
  return cudaErrorInvalidValue;
}
