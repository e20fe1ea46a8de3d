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
// sequential grid in VMEM.  Each entry point here launches two kernels
// (dX, then the dW split reduction and its fixed-order sum), with the same
// two routes as K1, chosen by the wrapper (ops/conv_bwd.py) from the type:
//
//   ir_subm_conv_bwd_tc  bf16 (sparse_conv_tc.cuh):
//     dX: irsc::tc::gather_gemm_tc_kernel with MIRROR_T — the K1 tile on
//         tensor cores, W[K-1-k] staged as it lies ([Cin][Cout]) and read
//         by plain ldmatrix as the transposed B operand; f32 store.
//     dW: irsc::tc::dw_tc_kernel — block (k, split) accumulates [Cin, Cout]
//         in registers from x tiles read transposed (ldmatrix.trans) times
//         the gathered g rows, skipping row tiles with no valid index at k;
//         then irsc::sum_partials_kernel adds the splits in a fixed order,
//         so dW is bit-identical across launches.
//   ir_subm_conv_bwd     f32 only: the FMA templates irsc::gather_gemm_kernel
//     (MIRROR_T) and irsc::dw_partial_kernel, f32 products (no TF32).
//
// What bounds the tensor-core route on the card: the bytes staged into
// shared memory.  dX moves, per 64-row block and offset, 64 gathered g rows
// and the whole W[K-1-k] slice, as K1 does.  dW makes K passes over x (one
// per offset block column) and gathers g once per offset, so it reads x K
// times from L2; its MMAs need far less time than those reads.  g is still
// gathered twice, once for dX and once for dW; fusing the two (the TPU
// kernel's design) would save one gather pass at the price of dW partials
// held beside the dX tile, and is left for when the card shows it pays.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for an unsupported shape.

#include "sparse_conv.cuh"
#include "sparse_conv_tc.cuh"

namespace {

using irsc::launch_gather_gemm;

// FMA dX: the reduction runs over g's cout channels (BK = 32), the output
// has the conv's cin channels.
cudaError_t launch_dx(const void* g, const void* nbr, const void* w, void* dx, long long v,
                      int k_offsets, int cin, int cout, cudaStream_t stream) {
  switch (cin) {
    case 32:
      return launch_gather_gemm<float, float, 32, 32, true>(g, nbr, w, nullptr, nullptr, dx,
                                                            v, k_offsets, cout, 0, stream);
    case 64:
      return launch_gather_gemm<float, float, 64, 32, true>(g, nbr, w, nullptr, nullptr, dx,
                                                            v, k_offsets, cout, 0, stream);
    case 128:
      return launch_gather_gemm<float, float, 128, 32, true>(g, nbr, w, nullptr, nullptr, dx,
                                                             v, k_offsets, cout, 0, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(long long v, int k_offsets, int cout, int splits) {
  return v <= 0 || k_offsets <= 0 || k_offsets % 2 == 0 || cout < 32 || splits <= 0 ||
         splits > 65535 || (v + irsc::GEMM_BM - 1) / irsc::GEMM_BM > 0x7fffffffLL;
}

}  // namespace

// The FMA route, float32: x [v, cin], g [v, cout], nbr [v, K] with K odd
// and symmetric, w [K, cin, cout]; dx f32 [v, cin]; partial f32 scratch of
// splits * K * cin * cout; dw f32 [K, cin, cout].
extern "C" int ir_subm_conv_bwd(const void* x, const void* nbr, const void* g, const void* w,
                                void* dx, void* partial, void* dw, long long v, int k_offsets,
                                int cin, int cout, int splits, void* stream) {
  if (bad_shape(v, k_offsets, cout, splits)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_dx(g, nbr, w, dx, v, k_offsets, cin, cout, s);
  if (err != cudaSuccess) return err;
  return irsc::dispatch_dw<float, false>(x, g, nbr, partial, dw, v, k_offsets, cin, cout, splits,
                                         s);
}

// The tensor-core route: bfloat16 x, g and w (16-byte aligned), cin and
// cout each one of 32, 64, 128; the other arguments as above.
extern "C" int ir_subm_conv_bwd_tc(const void* x, const void* nbr, const void* g, const void* w,
                                   void* dx, void* partial, void* dw, long long v,
                                   int k_offsets, int cin, int cout, int splits, void* stream) {
  if (bad_shape(v, k_offsets, cout, splits)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = irsc::tc::dispatch_gather_gemm_tc<float, true>(
      g, nbr, w, nullptr, nullptr, dx, v, k_offsets, cout, cin, 0, s);
  if (err != cudaSuccess) return err;
  return irsc::tc::dispatch_dw_tc<false>(x, g, nbr, partial, dw, v, k_offsets, cin, cout,
                                         splits, s);
}
