// K2: backward of the 3^3 submanifold sparse conv, for sm_90a.
//
//   dX[u]        = sum_k g[nbr(u, k)] @ W[K-1-k]^T      [V, Cin],       x's type
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
//   ir_subm_conv_bwd_tc  bf16 (sparse_conv_tc.cuh), two plans from the
//   wrapper:
//     dX: irsc::tc::gather_gemm_tc_kernel with MIRROR_T under K1's plan
//         (ops/gather_conv.tc_plan) — W[K-1-k] staged as it lies ([Cin][Cout])
//         and read by plain ldmatrix as the transposed B operand; bf16 store,
//         the one rounding of the f32 sums (after the cluster's sum where a
//         cluster splits a tile), as K1 stores.
//     dW: irsc::tc::dw_group_tc_kernel under ops/conv_bwd.dw_plan — block
//         (offset group, split) of 8 warps keeps the [Cin, Cout] products of
//         its G offsets in registers (dw_group_split: WM x WN warps over a
//         product, WG groups of them over the offsets), reads the G map
//         columns of each 64-row tile once, stages the x tile once for all
//         and the G gathered g tiles in a ring of 3-4 tiles, as many blocks
//         as fill the card's slots; then irsc::sum_partials_kernel adds the
//         splits in a fixed order, so dW is bit-identical across launches.
//   ir_subm_conv_bwd     f32 only: the FMA templates irsc::gather_gemm_kernel
//     (MIRROR_T) and irsc::dw_partial_kernel, f32 products (no TF32).
//
// What bounds the tensor-core route on the card: the gathers' latency, as
// in K1 (sparse_conv_tc.cuh).  dX is K1's kernel: at B = 64 the 278528-row
// 64 -> 64 residual stages 636 MB of gathered g rows and 636 MB of W a
// launch.  The dW it replaced read each x tile once per offset (27 passes),
// read the map as one 4-byte entry a row and offset (a 32-byte sector
// each) and wrote 19 splits of partials; dW now stages, at that shape,
// 336 MB of x tiles (14 passes), 636 MB of gathered g rows and 139 MB of
// map sectors, and writes and reads 16 MB of partials (18 splits); over a
// train step's 16 launches 6.83 GB (scripts/conv_bytes.py).  g is gathered
// twice, once for dX and once for dW.  The TPU kernel's fused gather would
// save dW's 636 MB at that shape, zero-filled rows included; but its dW
// would then be summed by the 4352 dX blocks, whose [27, 64, 64] f32
// partials are 1.9 GB to write and as much to read.  Not taken.
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

// K2's dW on tensor cores: (cin, cout) one of the pairs of IRSC_IR_PAIRS
// and IRSC_PG_SUBM_PAIRS (sparse_conv_tc.cuh), instantiated here only, the
// one library that launches them.
cudaError_t dispatch_dw_group(const void* x, const void* g, const void* nbr, void* partial,
                              void* dw, long long rows, int k_offsets, int cin, int cout,
                              int splits, cudaStream_t stream) {
#define IRSC_DWG(CI, CO)                                                                  \
  if (cin == CI && cout == CO)                                                            \
    return irsc::tc::launch_dw_group_tc<CI, CO>(x, g, nbr, partial, dw, rows, k_offsets, \
                                                splits, stream);
  IRSC_IR_PAIRS(IRSC_DWG)
  IRSC_PG_SUBM_PAIRS(IRSC_DWG)
#undef IRSC_DWG
  return cudaErrorInvalidValue;
}

bool bad_shape(long long v, int k_offsets, int cout, int splits) {
  return v <= 0 || k_offsets <= 0 || k_offsets % 2 == 0 || cout < 16 || splits <= 0 ||
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

// The tensor-core route: bfloat16 x, g, w and dx (16-byte aligned), (cin,
// cout) one of the pairs of dispatch_dw_group, the other arguments as
// above; (bm, cs) dX's plan (ops/gather_conv.tc_plan) and dW's G
// (ops/conv_bwd.dw_plan: dw_group_g's), each refused unless the templates
// are built for it.
extern "C" int ir_subm_conv_bwd_tc(const void* x, const void* nbr, const void* g, const void* w,
                                   void* dx, void* partial, void* dw, long long v,
                                   int k_offsets, int cin, int cout, int splits, int bm, int cs,
                                   int group, void* stream) {
  if (bad_shape(v, k_offsets, cout, splits) || !irsc::tc::tile_plan_ok(bm, cs) ||
      group != irsc::tc::dw_group_g(cin, cout) ||
      (v + bm - 1) / bm * cs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = irsc::tc::dispatch_gather_gemm_tc<irsc::tc::bf16, true>(
      g, nbr, w, nullptr, nullptr, dx, v, k_offsets, cout, cin, 0, bm, cs, s);
  if (err != cudaSuccess) return err;
  return dispatch_dw_group(x, g, nbr, partial, dw, v, k_offsets, cin, cout, splits, s);
}

// Shared memory a block of K2's dW takes at cin -> cout: ops/conv_bwd.
// dw_group_smem_bytes computes the same on the host.
extern "C" long long ir_dw_group_smem_bytes(int cin, int cout) {
  return static_cast<long long>(irsc::tc::dw_group_smem_bytes(cin, cout));
}

// K2's dW block at cin -> cout (irsc::tc::dw_group_split): WM, WN, WG and G
// into out[0..3]; ops/conv_bwd.dw_group_split computes the same on the host.
extern "C" void ir_dw_group_split(int cin, int cout, int* out) {
  const irsc::tc::DwGroupSplit s = irsc::tc::dw_group_split(cin, cout);
  out[0] = s.wm;
  out[1] = s.wn;
  out[2] = s.wg;
  out[3] = s.g;
}

// What the card holds of K2's dW kernel at cin -> cout: its registers a
// thread and its launch bounds' blocks an SM into regs and bound, and the
// blocks an SM runs (ops/conv_bwd.dw_group_blocks, by which dw_plan fills
// the card, is held equal to it on the card); -1 for a pair it is not
// built for or an error.
extern "C" int ir_dw_group_occupancy(int cin, int cout, int* regs, int* bound) {
#define IRSC_DWG_OCC(CI, CO) \
  if (cin == CI && cout == CO) return irsc::tc::dw_group_occupancy<CI, CO>(regs, bound);
  IRSC_IR_PAIRS(IRSC_DWG_OCC)
  IRSC_PG_SUBM_PAIRS(IRSC_DWG_OCC)
#undef IRSC_DWG_OCC
  return -1;
}
