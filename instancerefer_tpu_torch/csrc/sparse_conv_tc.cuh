// Tensor-core templates of the sparse-conv kernels (sm_90a), bf16 in, f32
// accumulation:
//
//   gather_gemm_tc_kernel  out[v] = epilogue(sum_k A[nbr[v, k]] @ Wk)     K1, K2's dX
//   dw_group_tc_kernel     partial[s, K-1-k] = sum_{rows r of split s}
//                              x_r^T g[nbr[r, k]], G offsets a block     K2's dW
//   dw_list_tc_kernel      partial[s, k] = sum_{v in range s of list k}
//                              x[nbr[v, k]]^T g_v                       K3's dW
//   dx_list_tc_kernel      dX[nbr[v, k]] = g_v @ W[k]^T over the same   the downs' dX
//                              lists, the rows no entry names 0         (K1 over up8)
//
// They replace the TPU kernels of instancerefer_tpu/ops/pallas_conv.py:
// _conv_kernel (K1, through windowed_gather_conv; the downs' dX was K1 over
// the inverse map up8 with W^T), _bwd_fused_kernel (K2, through
// windowed_conv_bwd_fused) and _dw_kernel (K3, through windowed_conv_dw).
// All four feed warp-level mma.sync.m16n8k16 (bf16 x
// bf16 -> f32) from shared memory through ldmatrix and stage their operands
// with 16-byte cp.async: gathered rows cannot come by TMA (it has no row
// gather on Hopper; one bulk copy a row measured 6.6x slower than cp.async
// at the 278528-row 64->64 residual), and wgmma would need 64-row
// warpgroup tiles in swizzled layouts, at a reduction depth of 32-128
// channels an offset.
//
// What bounds them on the card (scripts/conv_bytes.py counts the bytes,
// the plan sweep of scripts/step_ab.py times the plans; PERF.md has the
// numbers): the gathers' latency.  A block waits for each step's gathered
// rows from L2, so the rate is the steps in flight on an SM over that
// latency, not the bytes or the MMAs: at B = 64 the scene's 278528-row
// 64 -> 64 residual stages 636 MB of gathered rows and 636 MB of weights a
// launch into shared memory for 0.0303 ms of bound.  Taller tiles (128 and
// 256 rows, W staged a half or a quarter as often), deeper rings of smaller
// steps and a warp-specialized producer on mbarriers were all built and
// measured, and were no faster or slower: they put fewer independent
// blocks on an SM.  So K1 keeps 64-row tiles of 4 warps, several blocks an
// SM, stages only the offsets with a valid index in a tile, and at
// 8192-16384 rows splits a tile's offsets over a cluster of 2 or 4 blocks
// summed in distributed shared memory (ops/gather_conv.tc_plan picks the
// plan).
// K2's dW stages each x tile once for its G offsets (2 at 64 channels and
// above, 2-5 at PointGroup's narrow pairs) and reads the map's G columns
// once a tile: 6.83 GB over a train step's 16 launches at B = 64.
// K3 at the downs walks per-offset lists of the map's valid entries (the
// list pass of conv_dw.cu), so it stages only rows that are multiplied:
// 367 MB over a train step's 8 down launches at B = 64, where walking every
// row of the map once per offset staged 914 MB.  The downs' dX walks the
// same lists (one list pass a down's backward serves both): 233.5 MB of g
// rows and 42.3 MB of W over the 8 downs at B = 64, where K1's 64-row
// tiles over up8 staged 2396.8 MB of gathered rows and weight slices; the
// dX it writes either way bounds it (381.7 MB in f32, half that in the bf16
// the main path stores).
//
// Shared-memory rows are padded by 8 bf16 (16 bytes), so the 8 rows one
// ldmatrix phase reads start in 8 distinct 4-bank groups.  A gathered row
// whose index is -1 is zero-filled by cp.async itself (src-size 0); its
// source address is the (valid) base pointer.
//
// The FMA templates of sparse_conv.cuh stay for f32 inputs (no TF32 here:
// the f32 parity runs need f32 products); the stems have their
// own tensor-core kernels at any other Cin in sparse_conv_stem.cuh, built
// from these parts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <atomic>

#include "sparse_conv.cuh"  // sum_partials_kernel

namespace irsc {
namespace tc {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int THREADS = 128;  // 4 warps
constexpr int PAD = 8;        // bf16 padding per shared row
constexpr int STAGES = 2;

// Raise a kernel's dynamic shared-memory limit to `bytes`, calling the
// runtime only when `bytes` exceeds what this instantiation already set
// (`set`, a static of its launcher): the train step is bound by host time,
// and an attribute call on every launch adds to it.  One device per process.
// A launcher's static is one per process, not one per library (the dynamic
// linker unifies an inline function's statics across the libraries it
// loads), so each launcher instantiation is called from one library only;
// a second library's copy of the kernel would launch without its limit.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, std::atomic<int>& set, size_t bytes) {
  const int want = static_cast<int>(bytes);
  if (want <= set.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
  if (err == cudaSuccess) set.store(want, std::memory_order_relaxed);
  return err;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major fragment) * b (16x8, column fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane l of a warp reads, through ldmatrix.x4(.trans), the 16-byte row of a
// 16 x 16 operand block at (row, col) = (ROW(l), COL(l)):
//   A, row-major [m][k], no trans:  (l % 16, (l / 16) * 8)      -> a0..a3
//   A stored [k][m], trans:         (l % 8 + (l / 16) * 8, ((l / 8) % 2) * 8)
//   B stored [k][n], trans:         (l % 8 + ((l / 8) % 2) * 8, (l / 16) * 8)
//                                    -> b0, b1 of n-tile 0, then of n-tile 1
//   B stored [n][k], no trans:      (l % 8 + (l / 16) * 8, ((l / 8) % 2) * 8)
// (PTX ISA, "Matrix fragments for mma.m16n8k16" and "ldmatrix").

template <typename O>
__device__ __forceinline__ void store2(O* dst, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// ---------------------------------------------------------------------------
// K1 and K2's dX: output-stationary gather-GEMM on tensor cores.  A block of
// 4 warps owns a tile of BM = 64 output rows x NOUT channels, each warp 16
// rows as f32 accumulators in registers, rounded once by the store into the
// output's type O (bf16 for K1, K2's dX and the inverse convs' dX: the
// compute dtype their inputs come in).  It reads its [BM, K] map tile
// once, coalesced, and flags the offsets that hold a valid index in the
// tile; those are listed, staged and multiplied.  A tile with none goes
// straight to the epilogue of a zero sum.  (Checking 16-row slices as well,
// at the downs' 8-offset maps, measured no faster: PERF.md §6.)
//
// A step is one listed offset: it stages the tile's gathered rows
// [BM][RED] (16-byte cp.async, a -1 index zero-fills its row) and the
// weight slice, in a ring of STAGES steps; step s + 1 is loaded while
// step s is multiplied (mma.sync m16n8k16 from ldmatrix), one barrier a
// step.  The gathers' latency is hidden by the ring and by the other blocks
// on the SM.
//
// In a cluster of CS = 2 or 4 blocks (one tile), rank q takes the listed
// offsets q, q + CS, q + 2 CS, ...; then each rank writes its f32 sums into
// its own shared memory, and rank q adds rows [q BM / CS, (q + 1) BM / CS)
// of the CS partials, read through distributed shared memory in rank
// order, applies the epilogue and stores them.  No atomics: a plan sums in
// one order.  Without a cluster (CS = 1) the block stores its own sums.
//
// Weight layouts (RED: the reduction width, NOUT: the output width), WL:
//   W_KRN (MIRROR_T = false): w[K, RED, NOUT], slice k, staged [RED][NOUT]
//     and read with ldmatrix.trans (K1).
//   W_MIRROR (MIRROR_T = true): w[K, NOUT, RED], slice K-1-k, staged
//     [NOUT][RED] and read with plain ldmatrix: the transpose comes from
//     the fragment layout (K2's dX over the mirrored offsets).
//   W_KNR: w[K, NOUT, RED], slice k, staged as W_MIRROR's (the inverse
//     convs' dX over the down map, up_dgrad_tc_kernel: W^T of the weight as
//     stored).
// gather_gemm_tc_kernel (K1, K2's dX) and up_dgrad_tc_kernel run one body,
// gather_gemm_tc_body; the kernels' names tell the launches apart in a
// trace.
//
// The plans it is built for: 64-row tiles, alone or in clusters of 2 or 4
// blocks (ops/gather_conv.tc_plan picks one from the shape and the card's
// SM count; the C entries refuse the rest).
// ---------------------------------------------------------------------------
constexpr int TC_BM = 64;  // rows a tile
constexpr int W_KRN = 0, W_MIRROR = 1, W_KNR = 2;  // the staged weight's layouts (above)

inline bool tile_plan_ok(int bm, int cs) {
  return bm == TC_BM && (cs == 1 || cs == 2 || cs == 4);
}

// The ring of steps, or the cluster's f32 partials [BM][NOUT + 4] where
// larger (they reuse its memory).
constexpr int tile_body_bytes(int red, int nout, bool mirror) {
  const int stage = TC_BM * (red + PAD) + (mirror ? nout * (red + PAD) : red * (nout + PAD));
  const int ring = STAGES * stage * 2;
  const int sums = TC_BM * (nout + 4) * 4;
  return ring > sums ? ring : sums;
}

// Shared memory of a block: the body, then the [BM, K] map tile, the
// offsets' flags and their list (ops/gather_conv.tc_smem_bytes is
// held equal to it on the card through ir_tc_smem_bytes).
constexpr size_t tile_smem_bytes(int red, int nout, bool mirror, int k_offsets) {
  return static_cast<size_t>(tile_body_bytes(red, nout, mirror)) +
         static_cast<size_t>(TC_BM + 2) * k_offsets * sizeof(int);
}

// NR: the weight staged [NOUT][RED] (W_MIRROR, W_KNR), else [RED][NOUT].
template <int RED, int NOUT, bool NR>
struct TileShape {
  static constexpr int NT = NOUT / 8;  // 8-column tiles a warp
  static constexpr int A_STRIDE = RED + PAD;
  static constexpr int A_ELEMS = TC_BM * A_STRIDE;
  static constexpr int W_STRIDE = (NR ? RED : NOUT) + PAD;
  static constexpr int STAGE_ELEMS = A_ELEMS + (NR ? NOUT : RED) * W_STRIDE;
  static constexpr int SUM_STRIDE = NOUT + 4;  // floats in a row of the cluster's partials
  static constexpr int BODY_BYTES = tile_body_bytes(RED, NOUT, NR);
  static_assert(RED % 16 == 0 && NT >= 2 && NT % 2 == 0, "warp tile");
};

template <typename O, int RED, int NOUT, int WL>
__device__ __forceinline__ void gather_gemm_tc_body(
    const bf16* __restrict__ feats, const int* __restrict__ nbr, const bf16* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias, O* __restrict__ out,
    long long v_out, int k_offsets, int relu, int cs) {
  constexpr bool NR = WL != W_KRN;
  using S = TileShape<RED, NOUT, NR>;
  constexpr int BM = TC_BM;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + S::BODY_BYTES);
  int* mask_s = idx_s + BM * k_offsets;  // [K]: the offset has a valid index in the tile
  int* list_s = mask_s + k_offsets;      // [K]: the offsets with any, ascending
  __shared__ int n_list;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;  // owns rows [16 warp, 16 warp + 16) of the tile
  const int rank = static_cast<int>(blockIdx.x % cs);  // in the cluster (0 without one)
  const long long row0 = static_cast<long long>(blockIdx.x / cs) * BM;
  const int rows = static_cast<int>(min(static_cast<long long>(BM), v_out - row0));

  for (int e = tid; e < BM * k_offsets; e += THREADS)
    idx_s[e] = e < rows * k_offsets ? nbr[row0 * k_offsets + e] : -1;
  __syncthreads();
  // warp w flags the offsets w, w + 4, ...: lane l reads rows l and l + 32
  for (int k = warp; k < k_offsets; k += THREADS / 32) {
    unsigned any = 0;
#pragma unroll
    for (int h = 0; h < BM / 32; ++h)
      any |= __ballot_sync(0xffffffffu, idx_s[(h * 32 + lane) * k_offsets + k] >= 0);
    if (lane == 0) mask_s[k] = any != 0;
  }
  __syncthreads();
  if (warp == 0) {  // the listed offsets, ascending: a lane's place counts those below it
    int n = 0;
    for (int k0 = 0; k0 < k_offsets; k0 += 32) {
      const bool on = k0 + lane < k_offsets && mask_s[k0 + lane] != 0;
      const unsigned bits = __ballot_sync(0xffffffffu, on);
      if (on) list_s[n + __popc(bits & ((1u << lane) - 1))] = k0 + lane;
      n += __popc(bits);
    }
    if (lane == 0) n_list = n;
  }
  __syncthreads();
  // this rank's steps: list entries rank, rank + cs, ...
  const int n_steps = n_list > rank ? (n_list - rank + cs - 1) / cs : 0;

  auto load = [&](int buf, int step) {
    const int k = list_s[rank + step * cs];
    bf16* a_s = stages + buf * S::STAGE_ELEMS;
    bf16* w_s = a_s + S::A_ELEMS;
    constexpr int CPR = RED / 8;  // 16-byte chunks of a row
    for (int e = tid; e < BM * CPR; e += THREADS) {
      const int r = e / CPR;
      const int c = e % CPR;
      const int src = idx_s[r * k_offsets + k];
      cp_async16(a_s + r * S::A_STRIDE + c * 8,
                 src >= 0 ? feats + static_cast<long long>(src) * RED + c * 8 : feats,
                 src >= 0 ? 16 : 0);
    }
    const bf16* wk = w + static_cast<long long>(WL == W_MIRROR ? k_offsets - 1 - k : k) * RED * NOUT;
    if constexpr (NR) {  // [NOUT][RED]
      for (int e = tid; e < NOUT * CPR; e += THREADS) {
        const int n = e / CPR;
        const int c = e % CPR;
        cp_async16(w_s + n * S::W_STRIDE + c * 8, wk + n * RED + c * 8, 16);
      }
    } else {  // [RED][NOUT]
      constexpr int CPW = NOUT / 8;
      for (int e = tid; e < RED * CPW; e += THREADS) {
        const int r = e / CPW;
        const int c = e % CPW;
        cp_async16(w_s + r * S::W_STRIDE + c * 8, wk + r * NOUT + c * 8, 16);
      }
    }
  };

  float acc[S::NT][4];
#pragma unroll
  for (int j = 0; j < S::NT; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[j][t] = 0.f;

  // multiply step `buf`
  auto compute = [&](int buf) {
    const bf16* a_s = stages + buf * S::STAGE_ELEMS;
    const bf16* w_s = a_s + S::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < RED; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, a_s + (warp * 16 + lane % 16) * S::A_STRIDE + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        const int n = j * 8;
        unsigned b[4];
        if constexpr (NR)
          ldsm_x4(b, w_s + (n + lane % 8 + (lane / 16) * 8) * S::W_STRIDE + kk +
                         ((lane / 8) % 2) * 8);
        else
          ldsm_x4_trans(b, w_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * S::W_STRIDE + n +
                               (lane / 16) * 8);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  };

  // the ring: step s + STAGES - 1 is loaded while step s is multiplied;
  // an empty group past the last step keeps the count
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed for all; step s - 1's buffer is free
    const int next = s + STAGES - 1;
    if (next < n_steps) load(next % STAGES, next);
    cp_async_commit();
    compute(s % STAGES);
  }

  auto finish = [&](int r, int n, float v0, float v1) {
    if (scale != nullptr) {
      v0 = v0 * scale[n] + bias[n];
      v1 = v1 * scale[n + 1] + bias[n + 1];
    }
    if (relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
    store2<O>(out + (row0 + r) * NOUT + n, v0, v1);
  };

  // accumulator fragment: rows lane/4 and lane/4 + 8 of the warp's 16-row
  // slice, columns 8j + 2(lane%4) + {0, 1}
  if (cs == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + lane / 4 + h * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < S::NT; ++j)
        finish(r, j * 8 + (lane % 4) * 2, acc[j][2 * h], acc[j][2 * h + 1]);
    }
    return;
  }

  // the cluster's sum: the ring's memory holds this rank's partials
  cp_async_wait<0>();
  __syncthreads();
  float* sum_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + h * 8;
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
      *reinterpret_cast<float2*>(sum_s + r * S::SUM_STRIDE + j * 8 + (lane % 4) * 2) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partials are written
  const int part = BM / cs;
  for (int e = tid; e < part * (NOUT / 2); e += THREADS) {
    const int r = rank * part + e / (NOUT / 2);
    const int n = (e % (NOUT / 2)) * 2;
    float v0 = 0.f, v1 = 0.f;
    for (int q = 0; q < cs; ++q) {  // rank order: a plan sums in one order
      const float2 v = *reinterpret_cast<const float2*>(cluster.map_shared_rank(sum_s, q) +
                                                        r * S::SUM_STRIDE + n);
      v0 += v.x;
      v1 += v.y;
    }
    if (r < rows) finish(r, n, v0, v1);
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

// The blocks an SM keeps at least (the kernels' launch bounds): 4 at
// {16, 32, 64, 128} output columns, whose gathers fill each other's waits;
// 3 at PointGroup's 48-112, and 2 past 128, whose accumulators and
// addresses would spill under the registers of 4.
__host__ __device__ constexpr int tile_min_blocks(int nout) {
  return nout > 128 ? 2 : (nout & (nout - 1)) != 0 ? 3 : 4;
}

template <typename O, int RED, int NOUT, bool MIRROR_T>
__global__ void __launch_bounds__(THREADS, tile_min_blocks(NOUT))
gather_gemm_tc_kernel(const bf16* __restrict__ feats, const int* __restrict__ nbr,
                      const bf16* __restrict__ w, const float* __restrict__ scale,
                      const float* __restrict__ bias, O* __restrict__ out, long long v_out,
                      int k_offsets, int relu, int cs) {
  gather_gemm_tc_body<O, RED, NOUT, MIRROR_T ? W_MIRROR : W_KRN>(feats, nbr, w, scale, bias, out,
                                                                 v_out, k_offsets, relu, cs);
}

// The inverse convs' dX over the down map: dX[v] = sum_k g[down[v, k]] @
// W[k]^T, w [K, NOUT, RED] as the inverse conv stores it, a bf16 output.
template <int RED, int NOUT>
__global__ void __launch_bounds__(THREADS, tile_min_blocks(NOUT))
up_dgrad_tc_kernel(const bf16* __restrict__ feats, const int* __restrict__ nbr,
                const bf16* __restrict__ w, const float* __restrict__ scale,
                const float* __restrict__ bias, bf16* __restrict__ out, long long v_out,
                int k_offsets, int relu, int cs) {
  gather_gemm_tc_body<bf16, RED, NOUT, W_KNR>(feats, nbr, w, scale, bias, out, v_out, k_offsets,
                                              relu, cs);
}

template <typename O>
using TileKernel = void (*)(const bf16*, const int*, const bf16*, const float*, const float*, O*,
                            long long, int, int, int);

// A tile kernel over ceil(v_out / 64) tiles of cs blocks; smem_set is the
// kernel's own (reserve_smem).
template <typename O>
cudaError_t launch_tiles(TileKernel<O> kernel, std::atomic<int>& smem_set, size_t smem,
                         const void* feats, const void* nbr, const void* w, const void* scale,
                         const void* bias, void* out, long long v_out, int k_offsets, int relu,
                         int cs, cudaStream_t stream) {
  cudaError_t err = reserve_smem(kernel, smem_set, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((v_out + TC_BM - 1) / TC_BM * cs));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(cs);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(feats),
                           static_cast<const int*>(nbr), static_cast<const bf16*>(w),
                           static_cast<const float*>(scale), static_cast<const float*>(bias),
                           static_cast<O*>(out), v_out, k_offsets, relu, cs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename O, int RED, int NOUT, bool MIRROR_T>
cudaError_t launch_gather_gemm_tc(const void* feats, const void* nbr, const void* w,
                                  const void* scale, const void* bias, void* out,
                                  long long v_out, int k_offsets, int relu, int cs,
                                  cudaStream_t stream) {
  static std::atomic<int> smem_set{0};
  return launch_tiles<O>(gather_gemm_tc_kernel<O, RED, NOUT, MIRROR_T>, smem_set,
                         tile_smem_bytes(RED, NOUT, MIRROR_T, k_offsets), feats, nbr, w, scale,
                         bias, out, v_out, k_offsets, relu, cs, stream);
}

template <int RED, int NOUT>
cudaError_t launch_up_dx_tc(const void* g, const void* nbr, const void* w, void* dx,
                            long long v_out, int k_offsets, int cs, cudaStream_t stream) {
  static std::atomic<int> smem_set{0};
  return launch_tiles<bf16>(up_dgrad_tc_kernel<RED, NOUT>, smem_set,
                            tile_smem_bytes(RED, NOUT, true, k_offsets), g, nbr, w, nullptr,
                            nullptr, dx, v_out, k_offsets, 0, cs, stream);
}

// The (Cin, Cout) pairs the tensor-core templates are instantiated for, the
// convs of the port's configurations (ops/gather_conv.py keeps the same
// lists): InstanceRefer's encoders, {32, 64, 128} x {32, 64, 128}; and
// PointGroup's U-Net at m = 16 (widths c = 16, 32, ..., 112): its
// submanifold convs c -> c and the tails' 2c -> c (those not among the
// first), and its downs c -> c + 16, whose pairs the inverse convs' kernels
// take too.
#define IRSC_IR_PAIRS(X) \
  X(32, 32) X(32, 64) X(32, 128) X(64, 32) X(64, 64) X(64, 128) X(128, 32) X(128, 64) X(128, 128)
#define IRSC_PG_SUBM_PAIRS(X) \
  X(16, 16) X(48, 48) X(80, 80) X(96, 96) X(112, 112) X(32, 16) X(96, 48) X(160, 80) X(192, 96)
#define IRSC_PG_DOWN_PAIRS(X) X(16, 32) X(32, 48) X(48, 64) X(64, 80) X(80, 96) X(96, 112)

// (red, nout): K1's (Cin, Cout) of the pairs above; K2's dX (MIRROR_T)
// (Cout, Cin) of its submanifold pairs.  (bm, cs) a plan of tile_plan_ok.
template <typename O, bool MIRROR_T>
cudaError_t dispatch_gather_gemm_tc(const void* feats, const void* nbr, const void* w,
                                    const void* scale, const void* bias, void* out,
                                    long long v_out, int k_offsets, int red, int nout, int relu,
                                    int bm, int cs, cudaStream_t stream) {
  if (!tile_plan_ok(bm, cs)) return cudaErrorInvalidValue;
#define IRSC_TC(R, N)                                                                     \
  if (red == R && nout == N)                                                              \
    return launch_gather_gemm_tc<O, R, N, MIRROR_T>(feats, nbr, w, scale, bias, out, v_out, \
                                                    k_offsets, relu, cs, stream);
#define IRSC_TC_MIRROR(CI, CO) IRSC_TC(CO, CI)
  if constexpr (MIRROR_T) {
    IRSC_IR_PAIRS(IRSC_TC_MIRROR)
    IRSC_PG_SUBM_PAIRS(IRSC_TC_MIRROR)
  } else {
    IRSC_IR_PAIRS(IRSC_TC)
    IRSC_PG_SUBM_PAIRS(IRSC_TC)
    IRSC_PG_DOWN_PAIRS(IRSC_TC)
  }
  return cudaErrorInvalidValue;
#undef IRSC_TC_MIRROR
#undef IRSC_TC
}

// ---------------------------------------------------------------------------
// K2's weight gradient on tensor cores, G offsets a block:
//
//   partial[s, K-1-k] = sum over rows r of split s of  x_r^T g[nbr[r, k]],
//   k = G b .. G b + G - 1 for block (b, s)
//
// Block (b, s) walks the DWG_BR-row tiles of split s in order.  Per tile it
// reads the G map columns of its rows once into shared memory (the G
// entries of a row side by side, neighbouring threads on neighbouring
// entries), stages the x tile once [BR][CIN] and the G gathered g tiles
// [BR][COUT] (16-byte cp.async, a -1 index zero-fills its row) in a ring of
// 3-4 tiles, and adds x^T g_j into the [CIN, COUT] f32 products it keeps in
// registers (x read transposed by ldmatrix.trans as the A operand).
// Each thread loads its map entries of the tile STAGES ahead into registers
// one tile before the gathers need them.  A tile whose G columns are all -1
// is neither loaded nor multiplied, and an offset whose column is all -1 in
// a tile is neither gathered nor multiplied.  No float atomics:
// sum_partials_kernel adds the splits in a fixed order.
//
// The warps (dw_group_split): WM x WN of them split [CIN, COUT] as
// warp_split picks at DWG_G offsets a warp, and the WG = 8 / (WM x WN)
// groups of those split the block's offsets, group q taking q, q + WG, ...
// Where WM x WN > 4 (every pair of 64 channels and above) WG = 1 and G is
// warp_split's: 2, or 1 at 160 -> 80 and 192 -> 96.  At the 278528-row
// 64 -> 64 residual K2 took 0.63 ms a launch with G = 2 against 0.68 with
// G = 4 (one block an SM) and 0.75 with G = 1, and 128 -> 128 holds no more
// (128 accumulators a thread; the plan sweep of scripts/step_ab.py on an
// earlier build that had all three, PERF.md).
//
// At the narrow pairs the warps that would idle take offsets of their own:
// WG = 8 at 16 -> 16, 4 at 32 -> 16, 2 at 32 -> 32 and 48 -> 48.  There the
// kernel waits on memory, not on its multiplies (a tile costs 1-2 us a
// block whatever G), so the blocks an SM count first: G starts at one
// offset a group (at most DWG_WIDE_G) and grows while as many blocks share
// an SM, giving G = 5, 4, 2 and 3 with 3, 3, 3 and 2 blocks an SM.  On
// PointGroup's cell (one batch, level 0's 1000192 rows at 16 channels,
// level 1's 728832 at 32, level 2's 228864 at 48; step_ab --dw-groups) dW
// took 0.274, 0.300-0.328, 0.432 and 0.234 ms a launch, where one offset a
// warp group (G = 8, 4, 2, 2) took 0.323, the same, the same and 0.258,
// and G = 2 took 0.483, 0.511, 0.432 and 0.258; loading the map entries 2
// or 3 tiles ahead was no faster (PERF.md).
// ---------------------------------------------------------------------------
constexpr int DWG_THREADS = 256;  // 8 warps
constexpr int DWG_BR = 64;        // rows a tile
constexpr int DWG_G = 2;          // offsets a warp where WG = 1 and the accumulators allow
constexpr int DWG_WIDE_G = 4;     // the fewest offsets a block where WG >= 4
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may take on an H100
constexpr int SM_SMEM_BYTES = 233472;  // shared memory of an H100 SM, 1 KB of it reserved a block

// How the 8 warps of a dW block split its [cin, cout] products, and the
// offsets g a block takes (at most max_g): WM warps along cin (at most 4)
// and WN along cout, each a divisor of the width's 16-column tiles, the
// most warps whose accumulators (g x cin / WM x cout / WN / 32 a thread)
// stay within 128, the larger WM on a tie; the largest g that has one.
// At {32, 64, 128} this is WM = min(cin / 16, 4), WN = min(cout / 16, 8 /
// WM) and g = max_g; at PointGroup's widths the split follows the
// divisors (80 -> 80: 1 x 5 warps; 160 -> 80 and 192 -> 96: g = 1).
struct WarpSplit {
  int wm, wn, g;
};
constexpr WarpSplit warp_split(int cin, int cout, int max_g) {
  for (int g = max_g; g >= 1; --g) {
    WarpSplit best{0, 0, g};
    for (int wm = 1; wm <= 4; ++wm) {
      if ((cin / 16) % wm != 0) continue;
      for (int wn = 1; wm * wn <= 8; ++wn) {
        if ((cout / 16) % wn != 0) continue;
        if (g * (cin / 16 / wm) * (cout / 8 / wn) * 4 > 128) continue;
        if (wm * wn > best.wm * best.wn || (wm * wn == best.wm * best.wn && wm > best.wm))
          best = WarpSplit{wm, wn, g};
      }
    }
    if (best.wm > 0) return best;
  }
  return WarpSplit{0, 0, 0};
}

// A stage of the ring: the x tile and the g gathered g tiles, bf16 rows
// padded by PAD.
constexpr int dw_group_stage_bytes(int cin, int cout, int g) {
  return (DWG_BR * (cin + PAD) + g * DWG_BR * (cout + PAD)) * 2;
}
// Stages in the ring: as many as fit, at most 4.
constexpr int dw_group_stages(int cin, int cout, int g) {
  return (SMEM_LIMIT - 4096) / dw_group_stage_bytes(cin, cout, g) < 4
             ? (SMEM_LIMIT - 4096) / dw_group_stage_bytes(cin, cout, g)
             : 4;
}
// Shared memory of a block of g offsets: the ring, the tile's map columns
// [BR][g] and each warp's vote a stage (ops/conv_bwd.dw_group_smem_bytes is
// held equal to it on the card through ir_dw_group_smem_bytes).
constexpr size_t dw_group_smem_bytes(int cin, int cout, int g) {
  return static_cast<size_t>(dw_group_stages(cin, cout, g)) * dw_group_stage_bytes(cin, cout, g) +
         (DWG_BR * g + dw_group_stages(cin, cout, g) * 8) * sizeof(int);
}
// Blocks that share an SM (the kernel's launch bounds; ops/conv_bwd.dw_plan
// fills the card's slots with them): as many as its shared memory holds, at
// most 3, which leaves each thread 80 registers.
constexpr int dw_group_blocks(int cin, int cout, int g) {
  return SM_SMEM_BYTES / (static_cast<int>(dw_group_smem_bytes(cin, cout, g)) + 1024) < 3
             ? SM_SMEM_BYTES / (static_cast<int>(dw_group_smem_bytes(cin, cout, g)) + 1024)
             : 3;
}

// K2's dW block at cin -> cout: WM x WN warps over the product, WG groups
// of them over the offsets, g offsets a block (ops/conv_bwd.dw_group_split
// mirrors it).  Where WG > 1, g starts at one offset a group (at most
// DWG_WIDE_G) and grows while a block still fits its accumulators, a ring
// of 3 stages and as many blocks an SM.
struct DwGroupSplit {
  int wm, wn, wg, g;
};
constexpr DwGroupSplit dw_group_split(int cin, int cout) {
  const WarpSplit s = warp_split(cin, cout, DWG_G);
  const int wg = 8 / (s.wm * s.wn);
  if (wg == 1) return DwGroupSplit{s.wm, s.wn, 1, s.g};
  const int acc = (cin / 16 / s.wm) * (cout / 8 / s.wn) * 4;  // a thread's, an offset
  int g = wg < DWG_WIDE_G ? wg : DWG_WIDE_G;
  while (g < 32 && (g + wg) / wg * acc <= 128 && dw_group_stages(cin, cout, g + 1) >= 3 &&
         dw_group_blocks(cin, cout, g + 1) == dw_group_blocks(cin, cout, g))
    ++g;
  return DwGroupSplit{s.wm, s.wn, wg, g};
}
// K2's dW: offsets a block at cin -> cout (ops/conv_bwd.dw_group passes it).
constexpr int dw_group_g(int cin, int cout) { return dw_group_split(cin, cout).g; }
constexpr size_t dw_group_smem_bytes(int cin, int cout) {
  return dw_group_smem_bytes(cin, cout, dw_group_g(cin, cout));
}

template <int CIN, int COUT, int G>
struct DwGroupShape {
  static constexpr DwGroupSplit SPLIT = dw_group_split(CIN, COUT);
  static constexpr int WM = SPLIT.wm;  // warps along CIN
  static constexpr int WN = SPLIT.wn;  // along COUT
  static constexpr int WG = SPLIT.wg;  // along the offsets
  static constexpr int GW = (G + WG - 1) / WG;  // offsets a warp
  static constexpr int MT = CIN / WM / 16;
  static constexpr int NT = COUT / WN / 8;
  static constexpr int X_STRIDE = CIN + PAD;
  static constexpr int G_STRIDE = COUT + PAD;
  static constexpr int X_ELEMS = DWG_BR * X_STRIDE;
  static constexpr int G_ELEMS = DWG_BR * G_STRIDE;
  static constexpr int STAGE_ELEMS = X_ELEMS + G * G_ELEMS;
  static constexpr int STAGES = dw_group_stages(CIN, COUT, G);
  static constexpr size_t SMEM_BYTES = dw_group_smem_bytes(CIN, COUT, G);
  static constexpr int BLOCKS = dw_group_blocks(CIN, COUT, G);  // an SM
  static constexpr int ENTRIES = (DWG_BR * G + DWG_THREADS - 1) / DWG_THREADS;  // a thread's
  static_assert(STAGE_ELEMS * 2 == dw_group_stage_bytes(CIN, COUT, G), "stage");
  static_assert(G >= 1 && G <= 32 && MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  static_assert(WM * MT * 16 == CIN && WN * NT * 8 == COUT, "warps cover the product");
  static_assert(WG * WM * WN <= DWG_THREADS / 32, "warps");
  static_assert(GW * MT * NT * 4 <= 128, "at most 128 accumulators a thread");
  static_assert(STAGES >= 3 && SMEM_BYTES <= SMEM_LIMIT && BLOCKS >= 1, "block");
};

template <int CIN, int COUT, int G>
__global__ void __launch_bounds__(DWG_THREADS, DwGroupShape<CIN, COUT, G>::BLOCKS)
dw_group_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const int* __restrict__ nbr, float* __restrict__ partial, long long rows,
                   int k_offsets, long long rows_per_split) {
  using S = DwGroupShape<CIN, COUT, G>;
  constexpr int E = S::ENTRIES;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + S::STAGES * S::STAGE_ELEMS * sizeof(bf16));
  int* vote_s = idx_s + DWG_BR * G;  // [stage][warp]: offsets j with a valid entry

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const bool active = warp < S::WG * S::WM * S::WN;
  const int m0 = (warp % S::WM) * (CIN / S::WM);
  const int n0 = (warp / S::WM % S::WN) * (COUT / S::WN);
  const int jw = S::WG == 1 ? 0 : warp / (S::WM * S::WN);  // this warp's offsets: jw, jw + WG, ...
  const int k0 = blockIdx.x * G;
  const int ng = min(G, k_offsets - k0);
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);
  const int n_tiles =
      r_end > r_begin ? static_cast<int>((r_end - r_begin + DWG_BR - 1) / DWG_BR) : 0;

  // this thread's map entries of tile t: entry e = tid + THREADS q is row
  // e / G, offset k0 + e % G
  int entry[E];
  auto fetch = [&](int t) {
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int e = tid + q * DWG_THREADS;
      const long long r = r_begin + static_cast<long long>(t) * DWG_BR + e / G;
      const int j = e % G;
      entry[q] = e < DWG_BR * G && t < n_tiles && r < r_end && j < ng
                     ? nbr[r * k_offsets + k0 + j]
                     : -1;
    }
  };
  auto mask_of = [&](int slot) {
    int m = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v) m |= vote_s[slot * 8 + v];
    return m;
  };
  // tile t's entries into idx_s and the votes, then its copies into slot
  // t % S::STAGES; the first barrier frees idx_s and that slot
  auto stage = [&](int t) {
    __syncthreads();
    if (t >= n_tiles) return;
    const int slot = t % S::STAGES;
#pragma unroll
    for (int q = 0; q < E; ++q)
      if (tid + q * DWG_THREADS < DWG_BR * G) idx_s[tid + q * DWG_THREADS] = entry[q];
    int bits = 0;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      bool valid = false;
#pragma unroll
      for (int q = 0; q < E; ++q) valid |= entry[q] >= 0 && (tid + q * DWG_THREADS) % G == j;
      bits |= (__ballot_sync(0xffffffffu, valid) != 0) << j;
    }
    if (lane == 0) vote_s[slot * 8 + warp] = bits;
    __syncthreads();
    const int mask = mask_of(slot);
    if (mask == 0) return;
    bf16* x_s = ring + slot * S::STAGE_ELEMS;
    const long long r0 = r_begin + static_cast<long long>(t) * DWG_BR;
    constexpr int CPX = CIN / 8;
    for (int e = tid; e < DWG_BR * CPX; e += DWG_THREADS) {
      const int r = e / CPX;
      const int c = e % CPX;
      const bool ok = r0 + r < r_end;
      cp_async16(x_s + r * S::X_STRIDE + c * 8, ok ? x + (r0 + r) * CIN + c * 8 : x,
                 ok ? 16 : 0);
    }
    // the g tiles offset by offset where WG = 1, as the wide pairs always
    // ran; where the warps split the offsets, all G offsets' copies spread
    // over all threads (dW 8% and 9% faster at 16 and 32 channels, PERF.md)
    constexpr int CPG = COUT / 8;
    if constexpr (S::WG == 1) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (!((mask >> j) & 1)) continue;
        bf16* g_s = x_s + S::X_ELEMS + j * S::G_ELEMS;
        for (int e = tid; e < DWG_BR * CPG; e += DWG_THREADS) {
          const int r = e / CPG;
          const int c = e % CPG;
          const int src = idx_s[r * G + j];
          cp_async16(g_s + r * S::G_STRIDE + c * 8,
                     src >= 0 ? g + static_cast<long long>(src) * COUT + c * 8 : g,
                     src >= 0 ? 16 : 0);
        }
      }
    } else {
      for (int e = tid; e < G * DWG_BR * CPG; e += DWG_THREADS) {
        const int j = e / (DWG_BR * CPG);
        if (!((mask >> j) & 1)) continue;
        const int r = e / CPG % DWG_BR;
        const int c = e % CPG;
        const int src = idx_s[r * G + j];
        cp_async16(x_s + S::X_ELEMS + j * S::G_ELEMS + r * S::G_STRIDE + c * 8,
                   src >= 0 ? g + static_cast<long long>(src) * COUT + c * 8 : g,
                   src >= 0 ? 16 : 0);
      }
    }
  };

  float acc[S::GW][S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::GW; ++i)
#pragma unroll
    for (int m = 0; m < S::MT; ++m)
#pragma unroll
      for (int n = 0; n < S::NT; ++n)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][m][n][t] = 0.f;

  auto compute = [&](int slot, int mask) {
    const bf16* x_s = ring + slot * S::STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < DWG_BR; kk += 16) {
      unsigned a[S::MT][4];
#pragma unroll
      for (int m = 0; m < S::MT; ++m)
        ldsm_x4_trans(a[m], x_s + (kk + lane % 8 + (lane / 16) * 8) * S::X_STRIDE + m0 + m * 16 +
                                ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < S::GW; ++i) {
        const int j = jw + i * S::WG;
        if (j < G && ((mask >> j) & 1)) {
          const bf16* g_s = x_s + S::X_ELEMS + j * S::G_ELEMS;
#pragma unroll
          for (int n = 0; n < S::NT; n += 2) {
            unsigned b[4];
            ldsm_x4_trans(b, g_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * S::G_STRIDE + n0 +
                                 n * 8 + (lane / 16) * 8);
#pragma unroll
            for (int m = 0; m < S::MT; ++m) {
              mma_bf16(acc[i][m][n], a[m], b[0], b[1]);
              mma_bf16(acc[i][m][n + 1], a[m], b[2], b[3]);
            }
          }
        }
      }
    }
  };

  // the ring: tile t + STAGES - 1 is loaded while tile t is multiplied;
  // an empty group past the last tile keeps the count
  fetch(0);
#pragma unroll
  for (int t = 0; t < S::STAGES - 1; ++t) {
    stage(t);
    cp_async_commit();
    fetch(t + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<S::STAGES - 2>();
    stage(t + S::STAGES - 1);  // its first barrier publishes tile t's copies
    cp_async_commit();
    fetch(t + S::STAGES);
    const int slot = t % S::STAGES;
    const int mask = mask_of(slot);
    if (active && mask != 0) compute(slot, mask);
  }
  cp_async_wait<0>();
  if (!active) return;

  // accumulator fragment: CIN rows lane/4 and lane/4 + 8 of each 16-row
  // tile, COUT columns 8n + 2(lane%4) + {0, 1}
#pragma unroll
  for (int i = 0; i < S::GW; ++i) {
    const int j = jw + i * S::WG;
    if (j >= ng) break;
    float* dst = partial + (static_cast<long long>(blockIdx.y) * k_offsets + k_offsets - 1 -
                            (k0 + j)) * CIN * COUT;
#pragma unroll
    for (int m = 0; m < S::MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = m0 + m * 16 + lane / 4 + h * 8;
#pragma unroll
        for (int n = 0; n < S::NT; ++n)
          store2<float>(dst + c * COUT + n0 + n * 8 + (lane % 4) * 2, acc[i][m][n][2 * h],
                        acc[i][m][n][2 * h + 1]);
      }
  }
}

// dw_group_tc_kernel<CIN, COUT, G> over a (ceil(K / G), splits) grid, then
// the fixed-order sum into dw; the kernel's shared-memory limit already
// raised (launch_dw_group_tc, dw_group_occupancy).
template <int CIN, int COUT, int G>
cudaError_t launch_dw_group_grid(const void* x, const void* g, const void* nbr, void* partial,
                                 void* dw, long long rows, int k_offsets, int splits,
                                 cudaStream_t stream) {
  const long long tiles = (rows + DWG_BR - 1) / DWG_BR;
  const long long rows_per_split = (tiles + splits - 1) / splits * DWG_BR;
  const dim3 grid(static_cast<unsigned>((k_offsets + G - 1) / G), static_cast<unsigned>(splits));
  dw_group_tc_kernel<CIN, COUT, G><<<grid, DWG_THREADS, DwGroupShape<CIN, COUT, G>::SMEM_BYTES,
                                     stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const int*>(nbr),
      static_cast<float*>(partial), rows, k_offsets, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, dw, static_cast<long long>(k_offsets) * CIN * COUT, splits,
                             stream);
}

// K2's dW at dw_group_g's G.
template <int CIN, int COUT>
cudaError_t launch_dw_group_tc(const void* x, const void* g, const void* nbr, void* partial,
                               void* dw, long long rows, int k_offsets, int splits,
                               cudaStream_t stream) {
  constexpr int G = dw_group_g(CIN, COUT);
  static std::atomic<int> smem_set{0};
  const cudaError_t err = reserve_smem(dw_group_tc_kernel<CIN, COUT, G>, smem_set,
                                       DwGroupShape<CIN, COUT, G>::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return launch_dw_group_grid<CIN, COUT, G>(x, g, nbr, partial, dw, rows, k_offsets, splits,
                                            stream);
}

// What the card holds of dw_group_tc_kernel<CIN, COUT, G>: its registers a
// thread (regs), its launch bounds' blocks an SM (bound), and the blocks an
// SM runs at its shared memory (returned; -1 on an error).  Raises the
// kernel's shared-memory limit on the way.
template <int CIN, int COUT, int G = dw_group_g(CIN, COUT)>
int dw_group_occupancy(int* regs, int* bound) {
  using S = DwGroupShape<CIN, COUT, G>;
  auto kernel = dw_group_tc_kernel<CIN, COUT, G>;
  cudaFuncAttributes attr;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::SMEM_BYTES)) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, DWG_THREADS,
                                                    S::SMEM_BYTES) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *bound = S::BLOCKS;
  return blocks;
}

// ---------------------------------------------------------------------------
// K3's weight gradient at the down convs on tensor cores, over per-offset
// lists of the map's valid entries:
//
//   partial[s, k] = sum over the entries p of range s of list k of
//                   x[nbr[v, k]]^T g[v],  v = lists[k, p]
//
// The list pass of conv_dw.cu writes, for each offset k, the rows v with
// nbr[v, k] >= 0 in ascending order (lists[k, :counts[k]]).  Block (k, s)
// takes the contiguous range s of list k: ranges of ceil(counts[k] /
// splits) entries rounded up to whole tiles of DWL_BR entries, so only the
// last tile of a list carries zero rows.  The block reads counts[k] on the
// device: the grid (K, splits) comes from the shapes alone, as a CUDA graph
// needs, and a block whose range is empty writes a zero partial.
//
// Per tile the block gathers the entries' x rows (the map's indices) and g
// rows (the list's) with 16-byte cp.async into padded tiles [BR][CIN] and
// [BR][COUT], in a ring of stages, and adds x_tile^T g_tile into its [CIN,
// COUT] product in registers (x read transposed by ldmatrix.trans as the A
// operand, mma.sync.m16n8k16).  Threads 0..BR-1 keep the indices of the
// tiles ahead in register queues: a tile's list entries are read
// ST + LX + LG tiles ahead, the map entries they name ST + LX tiles ahead,
// and both are written to the tile's index slot in shared memory the
// iteration before its copies are issued, so no iteration waits on an
// index load issued by the one before it.  The warps split [CIN, COUT]
// WM x WN ways (4 of the 8 warps at 32 x 32); the ring is sized so that two
// or three blocks share an SM (dw_list_blocks), whose gathers fill each
// other's waits.  No float atomics: sum_partials_kernel adds the splits in
// a fixed order.
// ---------------------------------------------------------------------------
constexpr int DWL_THREADS = 256;                 // 8 warps
constexpr int DWL_BR = 64;                       // list entries a tile
constexpr int DWL_SMEM_BUDGET = 113 * 1024;      // shared memory a block: two blocks an SM
// Iterations of the ring between a map entry's load and the write of its
// tile's indices to shared memory (LX), and between a list entry's load and
// the load of the map entry it names (LG): each load has that many tiles'
// time to return before anything waits on it.
constexpr int DWL_LEAD_X = 3;
constexpr int DWL_LEAD_G = 2;

// A slot of the ring: the x and g tiles, bf16 rows padded by PAD, and the
// tile's x and g row indices.
constexpr int dw_list_slot_bytes(int cin, int cout) {
  return DWL_BR * (cin + PAD + cout + PAD) * 2 + 2 * DWL_BR * 4;
}
// Slots in the ring: as many as the budget holds, at most 4.
constexpr int dw_list_stages(int cin, int cout) {
  return DWL_SMEM_BUDGET / dw_list_slot_bytes(cin, cout) < 4
             ? DWL_SMEM_BUDGET / dw_list_slot_bytes(cin, cout)
             : 4;
}
// Shared memory of a block (ops/conv_bwd.dw_list_smem_bytes is held equal
// to it on the card through ir_dw_list_smem_bytes).
constexpr size_t dw_list_smem_bytes(int cin, int cout) {
  return static_cast<size_t>(dw_list_stages(cin, cout)) * dw_list_slot_bytes(cin, cout);
}
// Blocks that share an SM: as many as its shared memory holds, at most 3
// (the launch bounds then leave each thread 85 registers).
constexpr int dw_list_blocks(int cin, int cout) {
  return SM_SMEM_BYTES / (static_cast<int>(dw_list_smem_bytes(cin, cout)) + 1024) < 3
             ? SM_SMEM_BYTES / (static_cast<int>(dw_list_smem_bytes(cin, cout)) + 1024)
             : 3;
}

template <int CIN, int COUT>
struct DwListShape {
  static constexpr int WM = warp_split(CIN, COUT, 1).wm;  // warps along CIN
  static constexpr int WN = warp_split(CIN, COUT, 1).wn;  // along COUT
  static constexpr int MT = CIN / WM / 16;
  static constexpr int NT = COUT / WN / 8;
  static constexpr int X_STRIDE = CIN + PAD;
  static constexpr int G_STRIDE = COUT + PAD;
  static constexpr int X_ELEMS = DWL_BR * X_STRIDE;
  static constexpr int STAGE_ELEMS = X_ELEMS + DWL_BR * G_STRIDE;
  static constexpr int STAGES = dw_list_stages(CIN, COUT);
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr size_t SMEM_BYTES = dw_list_smem_bytes(CIN, COUT);
  static constexpr int BLOCKS = dw_list_blocks(CIN, COUT);  // an SM
  static_assert(RING_BYTES + STAGES * 2 * DWL_BR * 4 == SMEM_BYTES, "slot");
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  static_assert(WM * MT * 16 == CIN && WN * NT * 8 == COUT, "warps cover the product");
  static_assert(STAGES >= 3 && BLOCKS >= 2 && DWL_BR <= DWL_THREADS, "block");
};

// TRANS: partial[s, k] written [COUT][CIN] (the inverse convs' dW, whose
// weight is the transpose of the product), else [CIN][COUT].
template <int CIN, int COUT, bool TRANS>
__device__ __forceinline__ void dw_list_tc_body(const bf16* __restrict__ x,
                                                const bf16* __restrict__ g,
                                                const int* __restrict__ nbr,
                                                const int* __restrict__ lists,
                                                const int* __restrict__ counts,
                                                float* __restrict__ partial, long long v_out,
                                                int k_offsets) {
  using S = DwListShape<CIN, COUT>;
  constexpr int BR = DWL_BR;
  constexpr int ST = S::STAGES;
  constexpr int LX = DWL_LEAD_X;
  constexpr int LG = DWL_LEAD_G;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int* xrow_s = reinterpret_cast<int*>(smem + S::RING_BYTES);  // [ST][BR]: the x rows of a slot
  int* grow_s = xrow_s + ST * BR;                               // [ST][BR]: its g rows

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const bool active = warp < S::WM * S::WN;
  const int m0 = (warp % S::WM) * (CIN / S::WM);
  const int n0 = (warp / S::WM % S::WN) * (COUT / S::WN);
  const int k = blockIdx.x;
  // this block's range of list k: a function of the count and the grid
  const long long n = counts[k];
  const long long splits = gridDim.y;
  const long long per = ((n + splits - 1) / splits + BR - 1) / BR * BR;
  const long long p0 = min(n, static_cast<long long>(blockIdx.y) * per);
  const long long p1 = min(n, p0 + per);
  const int n_tiles = static_cast<int>((p1 - p0 + BR - 1) / BR);
  const int* list = lists + static_cast<long long>(k) * v_out;

  // thread tid < BR's g row of tile t (its list entry), -1 past the range,
  // and the x row a g row names at offset k (its map entry)
  auto g_row = [&](int t) -> int {
    const long long p = p0 + static_cast<long long>(t) * BR + tid;
    return tid < BR && p < p1 ? __ldg(list + p) : -1;
  };
  auto x_row = [&](int v) -> int {
    return v >= 0 ? __ldg(nbr + static_cast<long long>(v) * k_offsets + k) : -1;
  };

  // tile t's copies into slot t % ST, from the slot's indices (a -1 index
  // zero-fills its row)
  auto stage = [&](int t) {
    const int slot = t % ST;
    bf16* x_s = ring + slot * S::STAGE_ELEMS;
    bf16* g_s = x_s + S::X_ELEMS;
    const int* xr = xrow_s + slot * BR;
    const int* gr = grow_s + slot * BR;
    constexpr int CPX = CIN / 8;
    for (int e = tid; e < BR * CPX; e += DWL_THREADS) {
      const int r = e / CPX;
      const int c = e % CPX;
      const int src = xr[r];
      cp_async16(x_s + r * S::X_STRIDE + c * 8,
                 src >= 0 ? x + static_cast<long long>(src) * CIN + c * 8 : x, src >= 0 ? 16 : 0);
    }
    constexpr int CPG = COUT / 8;
    for (int e = tid; e < BR * CPG; e += DWL_THREADS) {
      const int r = e / CPG;
      const int c = e % CPG;
      const int src = gr[r];
      cp_async16(g_s + r * S::G_STRIDE + c * 8,
                 src >= 0 ? g + static_cast<long long>(src) * COUT + c * 8 : g, src >= 0 ? 16 : 0);
    }
  };

  float acc[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  auto compute = [&](int slot) {
    const bf16* x_s = ring + slot * S::STAGE_ELEMS;
    const bf16* g_s = x_s + S::X_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      unsigned a[S::MT][4];
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
        ldsm_x4_trans(a[i], x_s + (kk + lane % 8 + (lane / 16) * 8) * S::X_STRIDE + m0 + i * 16 +
                                ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        unsigned b[4];
        ldsm_x4_trans(b, g_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * S::G_STRIDE + n0 + j * 8 +
                             (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < S::MT; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  };

  // the indices of tiles 0 .. ST - 1 into their slots, and the registers'
  // queues filled: the list entries first (all in flight together), then
  // the map entries they name.  At the top of iteration t, xq[i] holds the
  // x row of tile t + ST + i (i < LX) and gq[i] its g row (i < LX + LG).
  int g0[ST], x0[ST], gq[LX + LG], xq[LX];
#pragma unroll
  for (int j = 0; j < ST; ++j) g0[j] = g_row(j);
#pragma unroll
  for (int i = 0; i < LX + LG; ++i) gq[i] = g_row(ST + i);
#pragma unroll
  for (int j = 0; j < ST; ++j) x0[j] = x_row(g0[j]);
#pragma unroll
  for (int i = 0; i < LX; ++i) xq[i] = x_row(gq[i]);
  if (tid < BR) {
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      xrow_s[j * BR + tid] = x0[j];
      grow_s[j * BR + tid] = g0[j];
    }
  }
  __syncthreads();

  // the ring: tile t + ST - 1 is loaded while tile t is multiplied; an
  // empty group past the last tile keeps the count
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile t landed for all; slot (t - 1) % ST is free
    if (t + ST - 1 < n_tiles) stage(t + ST - 1);
    cp_async_commit();
    if (tid < BR) {  // tile t + ST's indices into index slot t % ST, read by stage(t + ST)
      xrow_s[(t % ST) * BR + tid] = xq[0];
      grow_s[(t % ST) * BR + tid] = gq[0];
      // the map entry of tile t + ST + LX, whose list entry came LG
      // iterations ago, and the list entry of tile t + ST + LX + LG
#pragma unroll
      for (int i = 0; i < LX - 1; ++i) xq[i] = xq[i + 1];
      xq[LX - 1] = x_row(gq[LX]);
#pragma unroll
      for (int i = 0; i < LX + LG - 1; ++i) gq[i] = gq[i + 1];
      gq[LX + LG - 1] = g_row(t + ST + LX + LG);
    }
    if (active) compute(t % ST);
  }
  cp_async_wait<0>();
  if (!active) return;

  // accumulator fragment: CIN rows lane/4 and lane/4 + 8 of each 16-row
  // tile, COUT columns 8j + 2(lane%4) + {0, 1}
  float* dst = partial + (static_cast<long long>(blockIdx.y) * k_offsets + k) * CIN * COUT;
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = m0 + i * 16 + lane / 4 + h * 8;
#pragma unroll
      for (int j = 0; j < S::NT; ++j) {
        const int n = n0 + j * 8 + (lane % 4) * 2;
        if constexpr (TRANS) {
          dst[n * CIN + c] = acc[i][j][2 * h];
          dst[(n + 1) * CIN + c] = acc[i][j][2 * h + 1];
        } else {
          store2<float>(dst + c * COUT + n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(DWL_THREADS, DwListShape<CIN, COUT>::BLOCKS)
dw_list_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const int* __restrict__ nbr, const int* __restrict__ lists,
                  const int* __restrict__ counts, float* __restrict__ partial, long long v_out,
                  int k_offsets) {
  dw_list_tc_body<CIN, COUT, false>(x, g, nbr, lists, counts, partial, v_out, k_offsets);
}

// The inverse convs' dW over the down map's lists: dW[k] = sum_v
// x[v]^T g[down[v, k]] [COUT][CIN], with x the fine cotangent (CIN) read
// through the map and g the coarse input (COUT).
template <int CIN, int COUT>
__global__ void __launch_bounds__(DWL_THREADS, DwListShape<CIN, COUT>::BLOCKS)
up_wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const int* __restrict__ nbr, const int* __restrict__ lists,
                     const int* __restrict__ counts, float* __restrict__ partial,
                     long long v_out, int k_offsets) {
  dw_list_tc_body<CIN, COUT, true>(x, g, nbr, lists, counts, partial, v_out, k_offsets);
}

// dw_list_tc_kernel (or, TRANS, up_wgrad_tc_kernel) over a (K, splits)
// grid, then the fixed-order sum into dw.  lists [K, v_out] and counts [K]
// come from the list pass.
template <int CIN, int COUT, bool TRANS = false>
cudaError_t launch_dw_list_tc(const void* x, const void* g, const void* nbr, const int* lists,
                              const int* counts, void* partial, void* dw, long long v_out,
                              int k_offsets, int splits, cudaStream_t stream) {
  using S = DwListShape<CIN, COUT>;
  auto kernel = [] {
    if constexpr (TRANS)
      return up_wgrad_tc_kernel<CIN, COUT>;
    else
      return dw_list_tc_kernel<CIN, COUT>;
  }();
  static std::atomic<int> smem_set{0};
  cudaError_t err = reserve_smem(kernel, smem_set, S::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(k_offsets), static_cast<unsigned>(splits));
  kernel<<<grid, DWL_THREADS, S::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const int*>(nbr),
      lists, counts, static_cast<float*>(partial), v_out, k_offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, dw, static_cast<long long>(k_offsets) * CIN * COUT, splits,
                             stream);
}

// ---------------------------------------------------------------------------
// The down convs' dX on tensor cores, over the per-offset lists of the down
// map that K3 reads too (one list pass serves both gradients):
//
//   dX[down[v, k]] = g[v] @ W[k]^T   for every entry v of list k
//   dX[u] = 0                        for every row u whose up8 row is all -1
//
// A stride-2 down map names each input row at most once (its inverse up8
// holds at most one valid entry a row), so every row of dX has one writer:
// no atomics and no split sums, and two launches give bit-identical dX.
//
// Blocks 0 .. K splits - 1: block b takes range b / K of list b % K (the
// ranges of dw_list_tc_kernel: ceil(counts[k] / splits) entries rounded up
// to whole tiles), stages W[k] once as stored, [CIN][COUT], and per tile of
// DXL_BR entries gathers their g rows [BR][COUT] with 16-byte cp.async in a
// ring of DXL_STAGES, multiplies g_tile W[k]^T with mma.sync.m16n8k16 (W^T
// is the B operand that plain ldmatrix reads from W as stored: 4 warps, 16
// entries each) and stores each entry's row once, to dX[down[v, k]]: in the
// type of the conv's input, bf16 on the main path (one rounding of the f32
// accumulators), f32 where a caller gave the down conv f32 rows.
// The list entries and the map entries they name come through register
// queues as in dw_list_tc_kernel, so no iteration waits on an index load
// issued by the one before it; the map entries of a tile are kept until its
// store, in a ring of DXL_STAGES + 1 index slots.
//
// Blocks K splits ..: the zero pass over the rows no entry names (padding
// rows, and rows whose parent a cap dropped), DXL_ZERO_ROWS rows of up8 a
// block: a warp reads 8 rows a lane, each in two 16-byte loads, all in
// flight together, ballots the rows without a valid entry and writes their
// dX rows to 0.  It reads 32 bytes a row of up8, where zeroing all of dX
// first would write CIN x 4 bytes a row again.
// ---------------------------------------------------------------------------
constexpr int DXL_THREADS = 128;  // 4 warps
constexpr int DXL_BR = 64;        // list entries a tile
constexpr int DXL_STAGES = 3;
constexpr int DXL_ZERO_ROWS = 1024;                          // up8 rows a zero-pass block
constexpr int DXL_ZERO_STEPS = DXL_ZERO_ROWS / DXL_THREADS;  // ballots a warp

// Shared memory of a block (ops/conv_bwd.dx_list_smem_bytes is held equal
// to it on the card through ir_dx_list_smem_bytes): W[k] and the ring of g
// tiles, bf16 rows padded by PAD; the ring's g row indices [STAGES][BR] and
// the map entries of the tiles in flight [STAGES + 1][BR].
constexpr int dx_list_smem_bytes(int cin, int cout) {
  return (cin + DXL_STAGES * DXL_BR) * (cout + PAD) * 2 + (2 * DXL_STAGES + 1) * DXL_BR * 4;
}
// Blocks that share an SM: as many as its shared memory holds, at most 4
// (4 at 32 -> 64, 3 at 64 -> 128, 2 at 128 -> 128).
constexpr int dx_list_blocks(int cin, int cout) {
  return SM_SMEM_BYTES / (dx_list_smem_bytes(cin, cout) + 1024) < 4
             ? SM_SMEM_BYTES / (dx_list_smem_bytes(cin, cout) + 1024)
             : 4;
}

template <int CIN, int COUT>
struct DxListShape {
  static constexpr int NT = CIN / 8;           // 8-column tiles of a warp's 16 entries
  static constexpr int STRIDE = COUT + PAD;    // a staged g row, and a staged row of W[k]
  static constexpr int W_ELEMS = CIN * STRIDE;
  static constexpr int G_ELEMS = DXL_BR * STRIDE;
  static constexpr int RING_BYTES = (W_ELEMS + DXL_STAGES * G_ELEMS) * 2;
  static constexpr int SMEM_BYTES = dx_list_smem_bytes(CIN, COUT);
  static constexpr int BLOCKS = dx_list_blocks(CIN, COUT);  // an SM
  static_assert(RING_BYTES + (2 * DXL_STAGES + 1) * DXL_BR * 4 == SMEM_BYTES, "layout");
  static_assert(COUT % 16 == 0 && NT >= 2 && NT % 2 == 0, "warp tile");
  static_assert(DXL_STAGES >= 2 && BLOCKS >= 2 && DXL_BR == 16 * (DXL_THREADS / 32), "block");
};

// The zero pass of one block: rows [r_begin, r_begin + DXL_ZERO_ROWS) of
// up8, each warp DXL_ZERO_STEPS ballots of 32 consecutive rows; dx rows of
// CIN elements of `elem` bytes (4: f32, 2: bf16).
template <int CIN>
__device__ __forceinline__ void dx_zero_rows(const int* __restrict__ up8, void* __restrict__ dx,
                                             int elem, long long v_in, long long r_begin,
                                             int warp, int lane) {
  constexpr int STEPS = DXL_ZERO_STEPS;
  const long long r0 = r_begin + static_cast<long long>(warp) * STEPS * 32;
  int4 lo[STEPS], hi[STEPS];
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const long long r = r0 + i * 32 + lane;
    lo[i] = hi[i] = make_int4(0, 0, 0, 0);  // rows past v_in: not written
    if (r < v_in) {
      const int4* row = reinterpret_cast<const int4*>(up8 + r * 8);
      lo[i] = __ldg(row);
      hi[i] = __ldg(row + 1);
    }
  }
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const bool empty = (lo[i].x & lo[i].y & lo[i].z & lo[i].w & hi[i].x & hi[i].y & hi[i].z &
                        hi[i].w) < 0;
    unsigned bits = __ballot_sync(0xffffffffu, empty);
    while (bits) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1;
      uint4* dst = reinterpret_cast<uint4*>(static_cast<unsigned char*>(dx) +
                                            (r0 + i * 32 + j) * CIN * elem);
      const int row16 = CIN * elem / 16;  // 16-byte pieces a row
      for (int c = lane; c < row16; c += 32) dst[c] = make_uint4(0, 0, 0, 0);
    }
  }
}

// dx in f32 where f32_out, else bf16: the one rounding of each row's f32
// accumulators is its store.
template <int CIN, int COUT>
__device__ __forceinline__ void dx_list_tc_body(const bf16* __restrict__ g,
                                                const int* __restrict__ nbr,
                                                const int* __restrict__ up8,
                                                const bf16* __restrict__ w,
                                                const int* __restrict__ lists,
                                                const int* __restrict__ counts,
                                                void* __restrict__ dx, long long v_out,
                                                long long v_in, int k_offsets, int splits,
                                                bool f32_out) {
  using S = DxListShape<CIN, COUT>;
  constexpr int BR = DXL_BR;
  constexpr int ST = DXL_STAGES;
  constexpr int US = ST + 1;  // index slots of the map entries kept until the store
  constexpr int LX = DWL_LEAD_X;
  constexpr int LG = DWL_LEAD_G;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;  // owns entries [16 warp, 16 warp + 16) of a tile
  const long long list_blocks = static_cast<long long>(k_offsets) * splits;
  if (blockIdx.x >= list_blocks) {
    dx_zero_rows<CIN>(up8, dx, f32_out ? 4 : 2, v_in, (blockIdx.x - list_blocks) * DXL_ZERO_ROWS,
                      warp, lane);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* ring = w_s + S::W_ELEMS;
  int* grow_s = reinterpret_cast<int*>(smem + S::RING_BYTES);  // [ST][BR]: a slot's g rows
  int* urow_s = grow_s + ST * BR;                               // [US][BR]: a tile's dX rows

  const int k = static_cast<int>(blockIdx.x % k_offsets);
  // this block's range of list k: a function of the count and the grid
  const long long n = counts[k];
  const long long per = ((n + splits - 1) / splits + BR - 1) / BR * BR;
  const long long p0 = min(n, static_cast<long long>(blockIdx.x / k_offsets) * per);
  const long long p1 = min(n, p0 + per);
  const int n_tiles = static_cast<int>((p1 - p0 + BR - 1) / BR);
  if (n_tiles == 0) return;
  const int* list = lists + static_cast<long long>(k) * v_out;

  // thread tid < BR's g row of tile t (its list entry), -1 past the range,
  // and the dX row a g row names at offset k (its map entry)
  auto g_row = [&](int t) -> int {
    const long long p = p0 + static_cast<long long>(t) * BR + tid;
    return tid < BR && p < p1 ? __ldg(list + p) : -1;
  };
  auto u_row = [&](int v) -> int {
    return v >= 0 ? __ldg(nbr + static_cast<long long>(v) * k_offsets + k) : -1;
  };

  // tile t's g rows into ring slot t % ST, from the slot's indices (a -1
  // index zero-fills its row)
  constexpr int CPG = COUT / 8;  // 16-byte chunks of a row
  auto stage = [&](int t) {
    bf16* g_s = ring + (t % ST) * S::G_ELEMS;
    const int* gr = grow_s + (t % ST) * BR;
    for (int e = tid; e < BR * CPG; e += DXL_THREADS) {
      const int r = e / CPG;
      const int c = e % CPG;
      const int src = gr[r];
      cp_async16(g_s + r * S::STRIDE + c * 8,
                 src >= 0 ? g + static_cast<long long>(src) * COUT + c * 8 : g, src >= 0 ? 16 : 0);
    }
  };

  // W[k] as stored, in the first group with tile 0
  const bf16* wk = w + static_cast<long long>(k) * CIN * COUT;
  for (int e = tid; e < CIN * CPG; e += DXL_THREADS) {
    const int r = e / CPG;
    const int c = e % CPG;
    cp_async16(w_s + r * S::STRIDE + c * 8, wk + r * COUT + c * 8, 16);
  }

  // the indices of tiles 0 .. ST - 1 into their slots, and the registers'
  // queues filled: the list entries first (all in flight together), then
  // the map entries they name.  At the top of iteration t, uq[i] holds the
  // dX row of tile t + ST + i (i < LX) and gq[i] its g row (i < LX + LG).
  int g0[ST], u0[ST], gq[LX + LG], uq[LX];
#pragma unroll
  for (int j = 0; j < ST; ++j) g0[j] = g_row(j);
#pragma unroll
  for (int i = 0; i < LX + LG; ++i) gq[i] = g_row(ST + i);
#pragma unroll
  for (int j = 0; j < ST; ++j) u0[j] = u_row(g0[j]);
#pragma unroll
  for (int i = 0; i < LX; ++i) uq[i] = u_row(gq[i]);
  if (tid < BR) {
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      grow_s[j * BR + tid] = g0[j];
      urow_s[j * BR + tid] = u0[j];
    }
  }
  __syncthreads();

  // tile t: g_tile W[k]^T into registers, then each entry's row stored once
  auto compute_store = [&](int t) {
    float acc[S::NT][4];
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    const bf16* g_s = ring + (t % ST) * S::G_ELEMS;
#pragma unroll
    for (int kk = 0; kk < COUT; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, g_s + (warp * 16 + lane % 16) * S::STRIDE + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        unsigned b[4];
        ldsm_x4(b, w_s + (j * 8 + lane % 8 + (lane / 16) * 8) * S::STRIDE + kk +
                       ((lane / 8) % 2) * 8);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    // accumulator fragment: entries lane/4 and lane/4 + 8 of the warp's 16,
    // columns 8j + 2(lane%4) + {0, 1}
    const int* ur = urow_s + (t % US) * BR;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = ur[warp * 16 + lane / 4 + h * 8];
      if (u < 0) continue;
      const long long at = static_cast<long long>(u) * CIN + (lane % 4) * 2;
      if (f32_out) {
        float* dst = static_cast<float*>(dx) + at;
#pragma unroll
        for (int j = 0; j < S::NT; ++j)
          store2<float>(dst + j * 8, acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        bf16* dst = static_cast<bf16*>(dx) + at;
#pragma unroll
        for (int j = 0; j < S::NT; ++j) store2<bf16>(dst + j * 8, acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  };

  // the ring: tile t + ST - 1 is loaded while tile t is multiplied; an
  // empty group past the last tile keeps the count
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile t landed for all; slot (t - 1) % ST and tile t - 1's rows are free
    if (t + ST - 1 < n_tiles) stage(t + ST - 1);
    cp_async_commit();
    if (tid < BR) {  // tile t + ST's indices: its g rows into slot t % ST, read by
                     // stage(t + ST), its dX rows into slot (t + ST) % US
      grow_s[(t % ST) * BR + tid] = gq[0];
      urow_s[((t + ST) % US) * BR + tid] = uq[0];
#pragma unroll
      for (int i = 0; i < LX - 1; ++i) uq[i] = uq[i + 1];
      uq[LX - 1] = u_row(gq[LX]);
#pragma unroll
      for (int i = 0; i < LX + LG - 1; ++i) gq[i] = gq[i + 1];
      gq[LX + LG - 1] = g_row(t + ST + LX + LG);
    }
    compute_store(t);
  }
  cp_async_wait<0>();
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(DXL_THREADS, DxListShape<CIN, COUT>::BLOCKS)
dx_list_tc_kernel(const bf16* __restrict__ g, const int* __restrict__ nbr,
                  const int* __restrict__ up8, const bf16* __restrict__ w,
                  const int* __restrict__ lists, const int* __restrict__ counts,
                  void* __restrict__ dx, long long v_out, long long v_in, int k_offsets,
                  int splits, int f32_out) {
  dx_list_tc_body<CIN, COUT>(g, nbr, up8, w, lists, counts, dx, v_out, v_in, k_offsets, splits,
                             f32_out != 0);
}

// The inverse convs' forward over the down map's lists, the same product
// with a bf16 output: out[down[v, k]] = x[v] @ W[k] for the coarse rows x
// (COUT channels) and w [K, CIN, COUT] the transpose of the inverse conv's
// weight as stored; the fine rows no entry names 0.
template <int CIN, int COUT>
__global__ void __launch_bounds__(DXL_THREADS, DxListShape<CIN, COUT>::BLOCKS)
up_fwd_tc_kernel(const bf16* __restrict__ g, const int* __restrict__ nbr,
                  const int* __restrict__ up8, const bf16* __restrict__ w,
                  const int* __restrict__ lists, const int* __restrict__ counts,
                  bf16* __restrict__ dx, long long v_out, long long v_in, int k_offsets,
                  int splits) {
  dx_list_tc_body<CIN, COUT>(g, nbr, up8, w, lists, counts, dx, v_out, v_in, k_offsets, splits,
                             false);
}

// dx_list_tc_kernel (UP false: dx f32 where f32_out, else bf16) or
// up_fwd_tc_kernel (UP: bf16) over K x splits list blocks and
// ceil(v_in / DXL_ZERO_ROWS) zero-pass blocks.  lists [K, v_out] and
// counts [K] come from the list pass.
template <int CIN, int COUT, bool UP = false>
cudaError_t launch_dx_list_tc(const void* g, const void* nbr, const void* up8, const void* w,
                              const int* lists, const int* counts, void* dx, long long v_out,
                              long long v_in, int k_offsets, int splits, bool f32_out,
                              cudaStream_t stream) {
  using S = DxListShape<CIN, COUT>;
  const long long blocks = static_cast<long long>(k_offsets) * splits +
                           (v_in + DXL_ZERO_ROWS - 1) / DXL_ZERO_ROWS;
  if (blocks > 0x7fffffffLL || (UP && f32_out)) return cudaErrorInvalidValue;
  static std::atomic<int> smem_set{0};
  const auto* gb = static_cast<const bf16*>(g);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* map = static_cast<const int*>(nbr);
  const auto* inv = static_cast<const int*>(up8);
  cudaError_t err;
  if constexpr (UP) {
    err = reserve_smem(up_fwd_tc_kernel<CIN, COUT>, smem_set, S::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    up_fwd_tc_kernel<CIN, COUT><<<static_cast<unsigned>(blocks), DXL_THREADS, S::SMEM_BYTES,
                                  stream>>>(gb, map, inv, wb, lists, counts,
                                            static_cast<bf16*>(dx), v_out, v_in, k_offsets,
                                            splits);
  } else {
    err = reserve_smem(dx_list_tc_kernel<CIN, COUT>, smem_set, S::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    dx_list_tc_kernel<CIN, COUT><<<static_cast<unsigned>(blocks), DXL_THREADS, S::SMEM_BYTES,
                                   stream>>>(gb, map, inv, wb, lists, counts, dx, v_out, v_in,
                                             k_offsets, splits, f32_out ? 1 : 0);
  }
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace irsc
