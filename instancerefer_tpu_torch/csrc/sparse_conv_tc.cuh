// Tensor-core templates of the sparse-conv kernels (sm_90a), bf16 in, f32
// accumulation:
//
//   gather_gemm_tc_kernel  out[v] = epilogue(sum_k A[nbr[v, k]] @ Wk)     K1, K2's dX
//   dw_group_tc_kernel     partial[s, K-1-k] = sum_{rows r of split s}
//                              x_r^T g[nbr[r, k]], G offsets a block     K2's dW
//   dw_list_tc_kernel      partial[s, k] = sum_{v in range s of list k}
//                              x[nbr[v, k]]^T g_v                       K3's dW
//
// They replace the TPU kernels of instancerefer_tpu/ops/pallas_conv.py:
// _conv_kernel (K1, through windowed_gather_conv), _bwd_fused_kernel (K2,
// through windowed_conv_bwd_fused) and _dw_kernel (K3, through
// windowed_conv_dw).  All three feed warp-level mma.sync.m16n8k16 (bf16 x
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
// SM, and moves fewer bytes and waits less: at the 8-offset maps (the
// downs, their dX over up8) 16-row slices with no valid index at an offset
// are neither copied nor multiplied (K1 over a train step at B = 64 stages
// 12.75 GB), and at 8192-16384 rows a tile's offsets split over a cluster
// of 2 or 4 blocks summed in distributed shared memory
// (ops/gather_conv.tc_plan picks the plan).
// K2's dW stages each x tile once for G = 2 offsets and reads the map's G
// columns once a tile: 6.83 GB over a train step's 16 launches at B = 64.
// K3 at the downs walks per-offset lists of the map's valid entries (the
// list pass of conv_dw.cu), so it stages only rows that are multiplied:
// 367 MB over a train step's 8 down launches at B = 64, where walking every
// row of the map once per offset staged 914 MB.
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
// rows as f32 accumulators in registers.  It reads its [BM, K] map tile
// once, coalesced, and marks per offset the 16-row slices of the tile that
// hold a valid index (a bit each); the offsets with any are listed.  Only
// listed offsets are staged and multiplied; with SKIP (the maps of at most
// 8 offsets: the downs and their dX over up8, where one valid entry a row
// leaves most slices empty) only the marked slices too: a slice with no
// valid index at an offset is neither copied nor multiplied.  At 27
// offsets few slices are empty and the checks cost more than they save.
// A tile with none goes straight to the epilogue of a zero sum.
//
// A step is one listed offset: it stages the marked slices' gathered rows
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
// Weight layouts (RED: the reduction width, NOUT: the output width):
//   MIRROR_T = false: w[K, RED, NOUT], slice k, staged [RED][NOUT] and read
//     with ldmatrix.trans (K1, and the down conv's dX over up8 with W^T).
//   MIRROR_T = true:  w[K, NOUT, RED], slice K-1-k, staged [NOUT][RED] and
//     read with plain ldmatrix: the transpose comes from the fragment
//     layout (K2's dX over the mirrored offsets).
//
// The plans it is built for: 64-row tiles, alone or in clusters of 2 or 4
// blocks (ops/gather_conv.tc_plan picks one from the shape and the card's
// SM count; the C entries refuse the rest).
// ---------------------------------------------------------------------------
constexpr int TC_BM = 64;  // rows a tile

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
// offsets' slice masks and their list (ops/gather_conv.tc_smem_bytes is
// held equal to it on the card through ir_tc_smem_bytes).
constexpr size_t tile_smem_bytes(int red, int nout, bool mirror, int k_offsets) {
  return static_cast<size_t>(tile_body_bytes(red, nout, mirror)) +
         static_cast<size_t>(TC_BM + 2) * k_offsets * sizeof(int);
}

template <int RED, int NOUT, bool MIRROR_T>
struct TileShape {
  static constexpr int NT = NOUT / 8;  // 8-column tiles a warp
  static constexpr int A_STRIDE = RED + PAD;
  static constexpr int A_ELEMS = TC_BM * A_STRIDE;
  static constexpr int W_STRIDE = (MIRROR_T ? RED : NOUT) + PAD;
  static constexpr int STAGE_ELEMS = A_ELEMS + (MIRROR_T ? NOUT : RED) * W_STRIDE;
  static constexpr int SUM_STRIDE = NOUT + 4;  // floats in a row of the cluster's partials
  static constexpr int BODY_BYTES = tile_body_bytes(RED, NOUT, MIRROR_T);
  static_assert(RED % 16 == 0 && NT >= 2 && NT % 2 == 0, "warp tile");
};

// (a minimum of 4 blocks an SM: their gathers fill each other's waits)
template <typename O, int RED, int NOUT, int SKIP, bool MIRROR_T>
__global__ void __launch_bounds__(THREADS, 4)
gather_gemm_tc_kernel(const bf16* __restrict__ feats, const int* __restrict__ nbr,
                      const bf16* __restrict__ w, const float* __restrict__ scale,
                      const float* __restrict__ bias, O* __restrict__ out, long long v_out,
                      int k_offsets, int relu, int cs) {
  using S = TileShape<RED, NOUT, MIRROR_T>;
  constexpr int BM = TC_BM;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + S::BODY_BYTES);
  int* mask_s = idx_s + BM * k_offsets;  // [K]: bit i, slice i has a valid index
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
  // warp w marks the slices of offsets w, w + 4, ...: lane l reads rows
  // l and l + 32; a ballot covers two 16-row slices
  for (int k = warp; k < k_offsets; k += THREADS / 32) {
    int m = 0;
#pragma unroll
    for (int h = 0; h < BM / 32; ++h) {
      const unsigned bits =
          __ballot_sync(0xffffffffu, idx_s[(h * 32 + lane) * k_offsets + k] >= 0);
      m |= ((bits & 0xffffu) ? 1 : 0) << (2 * h) | ((bits >> 16) ? 2 : 0) << (2 * h);
    }
    if (lane == 0) mask_s[k] = SKIP || m == 0 ? m : (1 << (BM / 16)) - 1;
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
    const int m = mask_s[k];
    bf16* a_s = stages + buf * S::STAGE_ELEMS;
    bf16* w_s = a_s + S::A_ELEMS;
    constexpr int CPR = RED / 8;  // 16-byte chunks of a row
    for (int e = tid; e < BM * CPR; e += THREADS) {
      const int r = e / CPR;
      if (SKIP && !((m >> (r / 16)) & 1)) continue;  // a slice nobody multiplies
      const int c = e % CPR;
      const int src = idx_s[r * k_offsets + k];
      cp_async16(a_s + r * S::A_STRIDE + c * 8,
                 src >= 0 ? feats + static_cast<long long>(src) * RED + c * 8 : feats,
                 src >= 0 ? 16 : 0);
    }
    const bf16* wk = w + static_cast<long long>(MIRROR_T ? k_offsets - 1 - k : k) * RED * NOUT;
    if constexpr (MIRROR_T) {  // [NOUT][RED]
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

  // multiply step `buf` where this warp's slice is marked (`mine`)
  auto compute = [&](int buf, bool mine) {
    if (!mine) return;
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
        if constexpr (MIRROR_T)
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
    // whether this warp's slice of step s is marked, read before the wait
    const bool mine = (mask_s[list_s[rank + s * cs]] >> warp) & 1;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed for all; step s - 1's buffer is free
    const int next = s + STAGES - 1;
    if (next < n_steps) load(next % STAGES, next);
    cp_async_commit();
    compute(s % STAGES, mine);
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

template <typename O, int RED, int NOUT, int SKIP, bool MIRROR_T>
cudaError_t launch_gather_gemm_tc(const void* feats, const void* nbr, const void* w,
                                  const void* scale, const void* bias, void* out,
                                  long long v_out, int k_offsets, int relu, int cs,
                                  cudaStream_t stream) {
  auto kernel = gather_gemm_tc_kernel<O, RED, NOUT, SKIP, MIRROR_T>;
  const size_t smem = tile_smem_bytes(RED, NOUT, MIRROR_T, k_offsets);
  static std::atomic<int> smem_set{0};
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

// The slice checks (SKIP) pay only at the maps of at most 8 offsets: the
// downs and their dX over up8.  K2's dX is always over 27 and has none.
template <typename O, int RED, int NOUT, bool MIRROR_T>
cudaError_t launch_gather_gemm_tc_map(const void* feats, const void* nbr, const void* w,
                                  const void* scale, const void* bias, void* out,
                                  long long v_out, int k_offsets, int relu, int cs,
                                  cudaStream_t stream) {
  if constexpr (!MIRROR_T)
    if (k_offsets <= 8)
      return launch_gather_gemm_tc<O, RED, NOUT, 1, false>(feats, nbr, w, scale, bias, out,
                                                           v_out, k_offsets, relu, cs, stream);
  return launch_gather_gemm_tc<O, RED, NOUT, 0, MIRROR_T>(feats, nbr, w, scale, bias, out, v_out,
                                                          k_offsets, relu, cs, stream);
}

// RED and NOUT each one of 32, 64, 128; (bm, cs) a plan of tile_plan_ok.
template <typename O, bool MIRROR_T>
cudaError_t dispatch_gather_gemm_tc(const void* feats, const void* nbr, const void* w,
                                    const void* scale, const void* bias, void* out,
                                    long long v_out, int k_offsets, int red, int nout, int relu,
                                    int bm, int cs, cudaStream_t stream) {
  if (!tile_plan_ok(bm, cs)) return cudaErrorInvalidValue;
#define IRSC_TC(R, N)                                                                     \
  return launch_gather_gemm_tc_map<O, R, N, MIRROR_T>(feats, nbr, w, scale, bias, out, v_out, \
                                                      k_offsets, relu, cs, stream)
#define IRSC_TC_NOUT(R)                    \
  switch (nout) {                          \
    case 32: IRSC_TC(R, 32);               \
    case 64: IRSC_TC(R, 64);               \
    case 128: IRSC_TC(R, 128);             \
    default: return cudaErrorInvalidValue; \
  }
  switch (red) {
    case 32: IRSC_TC_NOUT(32)
    case 64: IRSC_TC_NOUT(64)
    case 128: IRSC_TC_NOUT(128)
    default: return cudaErrorInvalidValue;
  }
#undef IRSC_TC_NOUT
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
// 4 tiles, and adds x^T g_j into the G [CIN, COUT] f32 products it keeps in
// registers (x read transposed by ldmatrix.trans as the A operand).
// Each thread loads its map entry of the tile STAGES ahead into a
// register one tile before the gathers need it.  A tile whose G columns are
// all -1 is neither loaded nor multiplied, and an offset whose column is
// all -1 in a tile is neither gathered nor multiplied.  The warps split
// [CIN, COUT] WM x WN ways (4 of the 8 warps at 32 x 32).  No float
// atomics: sum_partials_kernel adds the splits in a fixed order.
//
// G = 2 at every width: at the 278528-row 64 -> 64 residual K2 took 0.63 ms
// a launch with it against 0.68 with G = 4 (one block an SM) and 0.75 with
// G = 1, and 128 -> 128 holds no more (128 accumulators a thread; the plan
// sweep of scripts/step_ab.py on an earlier build that had all three,
// PERF.md).
// ---------------------------------------------------------------------------
constexpr int DWG_THREADS = 256;  // 8 warps
constexpr int DWG_BR = 64;        // rows a tile
constexpr int DWG_G = 2;          // offsets a block
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may take on an H100

// A stage of the ring: the x tile and the G gathered g tiles, bf16 rows
// padded by PAD.
constexpr int dw_group_stage_bytes(int cin, int cout) {
  return (DWG_BR * (cin + PAD) + DWG_G * DWG_BR * (cout + PAD)) * 2;
}
// Stages in the ring: as many as fit, at most 4.
constexpr int dw_group_stages(int cin, int cout) {
  return (SMEM_LIMIT - 4096) / dw_group_stage_bytes(cin, cout) < 4
             ? (SMEM_LIMIT - 4096) / dw_group_stage_bytes(cin, cout)
             : 4;
}
// Shared memory of a block: the ring, the tile's map columns [BR][G] and
// each warp's vote a stage (ops/conv_bwd.dw_group_smem_bytes is held equal
// to it on the card through ir_dw_group_smem_bytes).
constexpr size_t dw_group_smem_bytes(int cin, int cout) {
  return static_cast<size_t>(dw_group_stages(cin, cout)) * dw_group_stage_bytes(cin, cout) +
         (DWG_BR * DWG_G + dw_group_stages(cin, cout) * 8) * sizeof(int);
}

template <int CIN, int COUT>
struct DwGroupShape {
  static constexpr int G = DWG_G;
  static constexpr int WM = CIN / 16 < 4 ? CIN / 16 : 4;                // warps along CIN
  static constexpr int WN = COUT / 16 < 8 / WM ? COUT / 16 : 8 / WM;    // along COUT
  static constexpr int MT = CIN / WM / 16;
  static constexpr int NT = COUT / WN / 8;
  static constexpr int X_STRIDE = CIN + PAD;
  static constexpr int G_STRIDE = COUT + PAD;
  static constexpr int X_ELEMS = DWG_BR * X_STRIDE;
  static constexpr int G_ELEMS = DWG_BR * G_STRIDE;
  static constexpr int STAGE_ELEMS = X_ELEMS + G * G_ELEMS;
  static constexpr int STAGES = dw_group_stages(CIN, COUT);
  static constexpr size_t SMEM_BYTES = dw_group_smem_bytes(CIN, COUT);
  static_assert(STAGE_ELEMS * 2 == dw_group_stage_bytes(CIN, COUT), "stage");
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  static_assert(G * MT * NT * 4 <= 128, "at most 128 accumulators a thread");
  static_assert(DWG_BR * G <= DWG_THREADS && STAGES >= 3 && SMEM_BYTES <= SMEM_LIMIT, "block");
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(DWG_THREADS, 1)
dw_group_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const int* __restrict__ nbr, float* __restrict__ partial, long long rows,
                   int k_offsets, long long rows_per_split) {
  using S = DwGroupShape<CIN, COUT>;
  constexpr int G = DWG_G;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + S::STAGES * S::STAGE_ELEMS * sizeof(bf16));
  int* vote_s = idx_s + DWG_BR * G;  // [stage][warp]: offsets j with a valid entry

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const bool active = warp < S::WM * S::WN;
  const int m0 = (warp % S::WM) * (CIN / S::WM);
  const int n0 = (warp / S::WM % S::WN) * (COUT / S::WN);
  const int k0 = blockIdx.x * G;
  const int ng = min(G, k_offsets - k0);
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);
  const int n_tiles =
      r_end > r_begin ? static_cast<int>((r_end - r_begin + DWG_BR - 1) / DWG_BR) : 0;

  // this thread's map entry of tile t: row tid / G, offset k0 + tid % G
  auto fetch = [&](int t) -> int {
    if (tid >= DWG_BR * G || t >= n_tiles) return -1;
    const long long r = r_begin + static_cast<long long>(t) * DWG_BR + tid / G;
    const int j = tid % G;
    return r < r_end && j < ng ? nbr[r * k_offsets + k0 + j] : -1;
  };
  auto mask_of = [&](int slot) {
    int m = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v) m |= vote_s[slot * 8 + v];
    return m;
  };
  // tile t's entries into idx_s and the votes, then its copies into slot
  // t % S::STAGES; the first barrier frees idx_s and that slot
  auto stage = [&](int t, int entry) {
    __syncthreads();
    if (t >= n_tiles) return;
    const int slot = t % S::STAGES;
    if (tid < DWG_BR * G) idx_s[tid] = entry;
    int bits = 0;
#pragma unroll
    for (int j = 0; j < G; ++j)
      bits |= (__ballot_sync(0xffffffffu, entry >= 0 && tid % G == j) != 0) << j;
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
    constexpr int CPG = COUT / 8;
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
  };

  float acc[G][S::MT][S::NT][4];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int n = 0; n < S::NT; ++n)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[j][i][n][t] = 0.f;

  auto compute = [&](int slot, int mask) {
    const bf16* x_s = ring + slot * S::STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < DWG_BR; kk += 16) {
      unsigned a[S::MT][4];
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
        ldsm_x4_trans(a[i], x_s + (kk + lane % 8 + (lane / 16) * 8) * S::X_STRIDE + m0 + i * 16 +
                                ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if ((mask >> j) & 1) {
          const bf16* g_s = x_s + S::X_ELEMS + j * S::G_ELEMS;
#pragma unroll
          for (int n = 0; n < S::NT; n += 2) {
            unsigned b[4];
            ldsm_x4_trans(b, g_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * S::G_STRIDE + n0 +
                                 n * 8 + (lane / 16) * 8);
#pragma unroll
            for (int i = 0; i < S::MT; ++i) {
              mma_bf16(acc[j][i][n], a[i], b[0], b[1]);
              mma_bf16(acc[j][i][n + 1], a[i], b[2], b[3]);
            }
          }
        }
      }
    }
  };

  // the ring: tile t + STAGES - 1 is loaded while tile t is multiplied;
  // an empty group past the last tile keeps the count
  int entry = fetch(0);
#pragma unroll
  for (int t = 0; t < S::STAGES - 1; ++t) {
    stage(t, entry);
    cp_async_commit();
    entry = fetch(t + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<S::STAGES - 2>();
    stage(t + S::STAGES - 1, entry);  // its first barrier publishes tile t's copies
    cp_async_commit();
    entry = fetch(t + S::STAGES);
    const int slot = t % S::STAGES;
    const int mask = mask_of(slot);
    if (active && mask != 0) compute(slot, mask);
  }
  cp_async_wait<0>();
  if (!active) return;

  // accumulator fragment: CIN rows lane/4 and lane/4 + 8 of each 16-row
  // tile, COUT columns 8n + 2(lane%4) + {0, 1}
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= ng) break;
    float* dst = partial + (static_cast<long long>(blockIdx.y) * k_offsets + k_offsets - 1 -
                            (k0 + j)) * CIN * COUT;
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = m0 + i * 16 + lane / 4 + h * 8;
#pragma unroll
        for (int n = 0; n < S::NT; ++n)
          store2<float>(dst + c * COUT + n0 + n * 8 + (lane % 4) * 2, acc[j][i][n][2 * h],
                        acc[j][i][n][2 * h + 1]);
      }
  }
}

// dw_group_tc_kernel over a (ceil(K / G), splits) grid, then the
// fixed-order sum into dw.
template <int CIN, int COUT>
cudaError_t launch_dw_group_tc(const void* x, const void* g, const void* nbr, void* partial,
                               void* dw, long long rows, int k_offsets, int splits,
                               cudaStream_t stream) {
  using S = DwGroupShape<CIN, COUT>;
  auto kernel = dw_group_tc_kernel<CIN, COUT>;
  static std::atomic<int> smem_set{0};
  cudaError_t err = reserve_smem(kernel, smem_set, S::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + DWG_BR - 1) / DWG_BR;
  const long long rows_per_split = (tiles + splits - 1) / splits * DWG_BR;
  const dim3 grid(static_cast<unsigned>((k_offsets + DWG_G - 1) / DWG_G),
                  static_cast<unsigned>(splits));
  kernel<<<grid, DWG_THREADS, S::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const int*>(nbr),
      static_cast<float*>(partial), rows, k_offsets, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, dw, static_cast<long long>(k_offsets) * CIN * COUT, splits,
                             stream);
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
constexpr int SM_SMEM_BYTES = 233472;  // shared memory of an H100 SM, 1 KB of it reserved a block
// Blocks that share an SM: as many as its shared memory holds, at most 3
// (the launch bounds then leave each thread 85 registers).
constexpr int dw_list_blocks(int cin, int cout) {
  return SM_SMEM_BYTES / (static_cast<int>(dw_list_smem_bytes(cin, cout)) + 1024) < 3
             ? SM_SMEM_BYTES / (static_cast<int>(dw_list_smem_bytes(cin, cout)) + 1024)
             : 3;
}

template <int CIN, int COUT>
struct DwListShape {
  static constexpr int WM = CIN / 16 < 4 ? CIN / 16 : 4;              // warps along CIN
  static constexpr int WN = COUT / 16 < 8 / WM ? COUT / 16 : 8 / WM;  // along COUT
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

template <int CIN, int COUT>
__global__ void __launch_bounds__(DWL_THREADS, DwListShape<CIN, COUT>::BLOCKS)
dw_list_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const int* __restrict__ nbr, const int* __restrict__ lists,
                  const int* __restrict__ counts, float* __restrict__ partial, long long v_out,
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
      for (int j = 0; j < S::NT; ++j)
        store2<float>(dst + c * COUT + n0 + j * 8 + (lane % 4) * 2, acc[i][j][2 * h],
                      acc[i][j][2 * h + 1]);
    }
}

// dw_list_tc_kernel over a (K, splits) grid, then the fixed-order sum into
// dw.  lists [K, v_out] and counts [K] come from the list pass.
template <int CIN, int COUT>
cudaError_t launch_dw_list_tc(const void* x, const void* g, const void* nbr, const int* lists,
                              const int* counts, void* partial, void* dw, long long v_out,
                              int k_offsets, int splits, cudaStream_t stream) {
  using S = DwListShape<CIN, COUT>;
  auto kernel = dw_list_tc_kernel<CIN, COUT>;
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

}  // namespace tc
}  // namespace irsc
