// Tensor-core templates of the sparse-conv kernels (sm_90a), bf16 in, f32
// accumulation:
//
//   gather_gemm_tc_kernel  out[v] = epilogue(sum_k A[nbr[v, k]] @ Wk)     K1, K2's dX
//   dw_tc_kernel           partial[s, K-1-k] = sum_{rows r of split s}
//                              x_r^T g[nbr[r, k]]                         K2's dW
//                          partial[s, k] = sum_{rows r of split s}
//                              x[nbr[r, k]]^T g_r     (GATHER_X)          K3's dW
//
// Both feed warp-level mma.sync.m16n8k16 (bf16 x bf16 -> f32) from shared
// memory through ldmatrix, and stage their operands with 16-byte cp.async
// in a ring of STAGES buffers, so the gather of the next offset (or row
// tile) is in flight while the warps multiply the current one.  mma.sync
// and not wgmma: the operands are gathered rows, 64 of them a block, and
// the reduction depth per offset is only 32-128 channels; wgmma's 64-row
// warpgroup tiles and swizzled shared-memory descriptors would buy issue
// rate that the gather does not let the kernel use (what bounds each
// kernel is in its source note, gather_conv.cu and subm_conv_bwd.cu).
//
// Shared-memory rows are padded by 8 bf16 (16 bytes), so the 8 rows one
// ldmatrix phase reads start in 8 distinct 4-bank groups.  A gathered row
// whose index is -1 is zero-filled by cp.async itself (src-size 0); its
// source address is the (valid) base pointer.
//
// The FMA templates of sparse_conv.cuh stay for f32 inputs (no TF32 here:
// the f32 parity runs need f32 products); the 7-channel stems have their
// own tensor-core kernels in sparse_conv_stem.cuh, built from these parts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "sparse_conv.cuh"  // sum_partials_kernel

namespace irsc {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 4 warps
constexpr int BM = 64;        // gather_gemm_tc: output rows per block, 16 per warp
constexpr int BR = 64;        // dw_tc: rows per staged tile
constexpr int PAD = 8;        // bf16 padding per shared row
constexpr int STAGES = 2;

// Raise a kernel's dynamic shared-memory limit to `bytes`, calling the
// runtime only when `bytes` exceeds what this instantiation already set
// (`set`, a static of its launcher): the train step is bound by host time,
// and an attribute call on every launch adds to it.  One device per process.
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
// Output-stationary gather-GEMM on tensor cores.  Block = BM output rows x
// NOUT channels, warp w owns rows 16w..16w+15 and every channel.  The block
// first reads its [BM, K] indices and lists the offsets that have at least
// one valid index in the tile; only those are staged and multiplied, and a
// tile with none (all padding) goes straight to the epilogue of a zero sum.
// Per listed offset one ring buffer holds the BM gathered rows [BM][RED] and
// the weight slice; the epilogue (scale, bias, ReLU) acts on the f32
// accumulators before the store in O.  No atomics.
//
// Weight layouts (RED: reduction width, NOUT: output width):
//   MIRROR_T = false: w[K, RED, NOUT], slice k, staged [RED][NOUT] and read
//     with ldmatrix.trans (K1, and the down conv's dX over up8 with W^T).
//   MIRROR_T = true:  w[K, NOUT, RED], slice K-1-k, staged [NOUT][RED] and
//     read with plain ldmatrix: the transpose comes from the fragment
//     layout (K2's dX over the mirrored offsets).
// ---------------------------------------------------------------------------
template <int RED, int NOUT, bool MIRROR_T>
struct GatherShape {
  static constexpr int A_STRIDE = RED + PAD;
  static constexpr int W_ROWS = MIRROR_T ? NOUT : RED;
  static constexpr int W_STRIDE = (MIRROR_T ? RED : NOUT) + PAD;
  static constexpr int A_ELEMS = BM * A_STRIDE;
  static constexpr int STAGE_ELEMS = A_ELEMS + W_ROWS * W_STRIDE;
  static size_t smem_bytes(int k_offsets) {
    return STAGES * STAGE_ELEMS * sizeof(bf16) + (BM + 2) * k_offsets * sizeof(int);
  }
};

template <typename O, int RED, int NOUT, bool MIRROR_T>
__global__ void __launch_bounds__(THREADS)
gather_gemm_tc_kernel(const bf16* __restrict__ feats, const int* __restrict__ nbr,
                      const bf16* __restrict__ w, const float* __restrict__ scale,
                      const float* __restrict__ bias, O* __restrict__ out, long long v_out,
                      int k_offsets, int relu) {
  using S = GatherShape<RED, NOUT, MIRROR_T>;
  static_assert(RED % 16 == 0 && NOUT % 16 == 0, "mma tile");
  constexpr int NT = NOUT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + STAGES * S::STAGE_ELEMS * sizeof(bf16));
  int* flag_s = idx_s + BM * k_offsets;  // [K]: offset has a valid index in the tile
  int* list_s = flag_s + k_offsets;      // [K]: those offsets, ascending
  __shared__ int n_list;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int rows = static_cast<int>(min(static_cast<long long>(BM), v_out - row0));

  for (int e = tid; e < BM * k_offsets; e += THREADS)
    idx_s[e] = e < rows * k_offsets ? nbr[row0 * k_offsets + e] : -1;
  for (int k = tid; k < k_offsets; k += THREADS) flag_s[k] = 0;
  __syncthreads();
  for (int e = tid; e < rows * k_offsets; e += THREADS)
    if (idx_s[e] >= 0) flag_s[e % k_offsets] = 1;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < k_offsets; ++k)
      if (flag_s[k]) list_s[n++] = k;
    n_list = n;
  }
  __syncthreads();
  const int n_act = n_list;

  auto load = [&](int buf, int k) {
    bf16* a_s = stages + buf * S::STAGE_ELEMS;
    bf16* w_s = a_s + S::A_ELEMS;
    constexpr int CPR = RED / 8;  // 16-byte chunks in a gathered row
    for (int e = tid; e < BM * CPR; e += THREADS) {
      const int r = e / CPR;
      const int c = e % CPR;
      const int src = idx_s[r * k_offsets + k];
      cp_async16(a_s + r * S::A_STRIDE + c * 8,
                 src >= 0 ? feats + static_cast<long long>(src) * RED + c * 8 : feats,
                 src >= 0 ? 16 : 0);
    }
    constexpr int W_COLS = MIRROR_T ? RED : NOUT;
    constexpr int CPW = W_COLS / 8;
    const bf16* wk = w + static_cast<long long>(MIRROR_T ? k_offsets - 1 - k : k) * RED * NOUT;
    for (int e = tid; e < S::W_ROWS * CPW; e += THREADS) {
      const int r = e / CPW;
      const int c = e % CPW;
      cp_async16(w_s + r * S::W_STRIDE + c * 8, wk + r * W_COLS + c * 8, 16);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  auto compute = [&](int buf) {
    const bf16* a_s = stages + buf * S::STAGE_ELEMS;
    const bf16* w_s = a_s + S::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < RED; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, a_s + (warp * 16 + lane % 16) * S::A_STRIDE + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned b[4];
        if (MIRROR_T)
          ldsm_x4(b, w_s + (j * 8 + lane % 8 + (lane / 16) * 8) * S::W_STRIDE + kk +
                         ((lane / 8) % 2) * 8);
        else
          ldsm_x4_trans(b, w_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * S::W_STRIDE + j * 8 +
                               (lane / 16) * 8);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  };

  if (n_act > 0) {
    load(0, list_s[0]);
    cp_async_commit();
    for (int i = 0; i < n_act; ++i) {
      if (i + 1 < n_act) load((i + 1) % STAGES, list_s[i + 1]);
      cp_async_commit();  // an empty group on the last offset keeps the count
      cp_async_wait<1>();
      __syncthreads();
      compute(i % STAGES);
      __syncthreads();  // the next iteration refills this buffer
    }
  }

  // accumulator fragment: rows lane/4 and lane/4 + 8 of the warp's 16,
  // columns 8j + 2(lane%4) + {0, 1}
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + h * 8;
    if (r >= rows) continue;
    O* dst = out + (row0 + r) * NOUT;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = j * 8 + (lane % 4) * 2;
      float v0 = acc[j][2 * h];
      float v1 = acc[j][2 * h + 1];
      if (scale != nullptr) {
        v0 = v0 * scale[n] + bias[n];
        v1 = v1 * scale[n + 1] + bias[n + 1];
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      store2<O>(dst + n, v0, v1);
    }
  }
}

template <typename O, int RED, int NOUT, bool MIRROR_T>
cudaError_t launch_gather_gemm_tc(const void* feats, const void* nbr, const void* w,
                                  const void* scale, const void* bias, void* out,
                                  long long v_out, int k_offsets, int relu,
                                  cudaStream_t stream) {
  using S = GatherShape<RED, NOUT, MIRROR_T>;
  auto kernel = gather_gemm_tc_kernel<O, RED, NOUT, MIRROR_T>;
  const size_t smem = S::smem_bytes(k_offsets);
  static std::atomic<int> smem_set{0};
  const cudaError_t err = reserve_smem(kernel, smem_set, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (v_out + BM - 1) / BM;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const bf16*>(feats), static_cast<const int*>(nbr), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<O*>(out),
      v_out, k_offsets, relu);
  return cudaGetLastError();
}

// RED and NOUT each one of 32, 64, 128.
template <typename O, bool MIRROR_T>
cudaError_t dispatch_gather_gemm_tc(const void* feats, const void* nbr, const void* w,
                                    const void* scale, const void* bias, void* out,
                                    long long v_out, int k_offsets, int red, int nout, int relu,
                                    cudaStream_t stream) {
#define IRSC_TC(R, N)                                                                       \
  return launch_gather_gemm_tc<O, R, N, MIRROR_T>(feats, nbr, w, scale, bias, out, v_out, \
                                                  k_offsets, relu, stream)
#define IRSC_TC_NOUT(R)              \
  switch (nout) {                    \
    case 32: IRSC_TC(R, 32);         \
    case 64: IRSC_TC(R, 64);         \
    case 128: IRSC_TC(R, 128);       \
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
// The weight gradient of K2 and K3 (down convs) on tensor cores, as the same
// deterministic split reduction as dw_partial_kernel: block (k, s) walks the
// row tiles of split s in order and keeps its [CIN, COUT] product in
// registers,
//
//   K2:             partial[s, K-1-k] = sum over rows r of split s of  x_r^T g[nbr[r, k]]
//   K3 (GATHER_X):  partial[s, k]     = sum over rows r of split s of  x[nbr[r, k]]^T g_r
//
// The x rows are staged [BR][CIN] and read transposed by ldmatrix.trans as
// the A operand, the g rows staged [BR][COUT] as B; whichever side the map
// names is gathered by index with 16-byte cp.async (a -1 index zero-fills
// its row), the other is a contiguous row tile.  A tile whose BR indices at
// offset k are all -1 (padding, or rows with no neighbour there)
// contributes zero and is neither loaded nor multiplied.  Warps split the
// [CIN, COUT] tile WM x WN ways.  No float atomics: sum_partials_kernel
// adds the splits in a fixed order.
// ---------------------------------------------------------------------------
template <int CIN, int COUT>
struct DwShape {
  static constexpr int X_STRIDE = CIN + PAD;
  static constexpr int G_STRIDE = COUT + PAD;
  static constexpr int X_ELEMS = BR * X_STRIDE;
  static constexpr int STAGE_ELEMS = X_ELEMS + BR * G_STRIDE;
  static constexpr size_t SMEM_BYTES = STAGES * STAGE_ELEMS * sizeof(bf16);
};

// (a minimum of one block per SM: without it ptxas spills 8 bytes of the
// narrow instantiations to keep them under 64 registers)
template <int CIN, int COUT, bool GATHER_X>
__global__ void __launch_bounds__(THREADS, 1)
dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, const int* __restrict__ nbr,
             float* __restrict__ partial, long long rows, int k_offsets,
             long long rows_per_split) {
  using S = DwShape<CIN, COUT>;
  constexpr int WM = CIN >= 64 ? 4 : 2;  // warps along CIN
  constexpr int WN = 4 / WM;             // warps along COUT
  constexpr int MT = CIN / WM / 16;      // 16-row tiles per warp
  constexpr int NT = COUT / WN / 8;      // 8-column tiles per warp
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int m0 = (warp % WM) * (CIN / WM);
  const int n0 = (warp / WM) * (COUT / WN);
  const int k = blockIdx.x;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);

  // the source row of tile row r0 + r on the gathered side (the map's
  // index) or on the contiguous side (the row itself); -1 past the split
  auto gathered = [&](long long r) -> long long {
    return r < r_end ? nbr[r * k_offsets + k] : -1;
  };
  auto contiguous = [&](long long r) -> long long { return r < r_end ? r : -1; };

  auto load = [&](int buf, long long r0) {
    bf16* x_s = stages + buf * S::STAGE_ELEMS;
    bf16* g_s = x_s + S::X_ELEMS;
    constexpr int CPX = CIN / 8;
    for (int e = tid; e < BR * CPX; e += THREADS) {
      const int r = e / CPX;
      const int c = e % CPX;
      const long long src = GATHER_X ? gathered(r0 + r) : contiguous(r0 + r);
      cp_async16(x_s + r * S::X_STRIDE + c * 8, src >= 0 ? x + src * CIN + c * 8 : x,
                 src >= 0 ? 16 : 0);
    }
    constexpr int CPG = COUT / 8;
    for (int e = tid; e < BR * CPG; e += THREADS) {
      const int r = e / CPG;
      const int c = e % CPG;
      const long long src = GATHER_X ? contiguous(r0 + r) : gathered(r0 + r);
      cp_async16(g_s + r * S::G_STRIDE + c * 8, src >= 0 ? g + src * COUT + c * 8 : g,
                 src >= 0 ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  auto compute = [&](int buf) {
    const bf16* x_s = stages + buf * S::STAGE_ELEMS;
    const bf16* g_s = x_s + S::X_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4_trans(a[i], x_s + (kk + lane % 8 + (lane / 16) * 8) * S::X_STRIDE + m0 + i * 16 +
                                ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned b[4];
        ldsm_x4_trans(b, g_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * S::G_STRIDE + n0 +
                             j * 8 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  };

  // ring of 2: the loads of a valid tile are in flight while the previous
  // valid tile is multiplied
  int buf = 0;
  int pending = -1;
  for (long long r0 = r_begin; r0 < r_end; r0 += BR) {
    const long long r = r0 + tid;
    if (!__syncthreads_or(tid < BR && r < r_end && nbr[r * k_offsets + k] >= 0)) continue;
    load(buf, r0);
    cp_async_commit();
    if (pending >= 0) {
      cp_async_wait<1>();
      __syncthreads();
      compute(pending);
      __syncthreads();
    }
    pending = buf;
    buf ^= 1;
  }
  if (pending >= 0) {
    cp_async_wait<0>();
    __syncthreads();
    compute(pending);
  }

  const int k_out = GATHER_X ? k : k_offsets - 1 - k;
  float* dst = partial + (static_cast<long long>(blockIdx.y) * k_offsets + k_out) * CIN * COUT;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = m0 + i * 16 + lane / 4 + h * 8;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        store2<float>(dst + c * COUT + n0 + j * 8 + (lane % 4) * 2, acc[i][j][2 * h],
                      acc[i][j][2 * h + 1]);
    }
}

// dw_tc_kernel over a (K, splits) grid, then the fixed-order sum into dw.
template <int CIN, int COUT, bool GATHER_X>
cudaError_t launch_dw_tc(const void* x, const void* g, const void* nbr, void* partial, void* dw,
                         long long rows, int k_offsets, int splits, cudaStream_t stream) {
  auto kernel = dw_tc_kernel<CIN, COUT, GATHER_X>;
  constexpr size_t smem = DwShape<CIN, COUT>::SMEM_BYTES;
  static std::atomic<int> smem_set{0};
  cudaError_t err = reserve_smem(kernel, smem_set, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + BR - 1) / BR;
  const long long rows_per_split = (tiles + splits - 1) / splits * BR;
  const dim3 grid(static_cast<unsigned>(k_offsets), static_cast<unsigned>(splits));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const bf16*>(x),
                                          static_cast<const bf16*>(g),
                                          static_cast<const int*>(nbr),
                                          static_cast<float*>(partial), rows, k_offsets,
                                          rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, dw, static_cast<long long>(k_offsets) * CIN * COUT, splits,
                             stream);
}

// CIN and COUT each one of 32, 64, 128.
template <bool GATHER_X>
cudaError_t dispatch_dw_tc(const void* x, const void* g, const void* nbr, void* partial, void* dw,
                           long long rows, int k_offsets, int cin, int cout, int splits,
                           cudaStream_t stream) {
#define IRSC_DW_TC(CI, CO)                                                                   \
  return launch_dw_tc<CI, CO, GATHER_X>(x, g, nbr, partial, dw, rows, k_offsets, splits, \
                                        stream)
#define IRSC_DW_TC_COUT(CI)                \
  switch (cout) {                          \
    case 32: IRSC_DW_TC(CI, 32);           \
    case 64: IRSC_DW_TC(CI, 64);           \
    case 128: IRSC_DW_TC(CI, 128);         \
    default: return cudaErrorInvalidValue; \
  }
  switch (cin) {
    case 32: IRSC_DW_TC_COUT(32)
    case 64: IRSC_DW_TC_COUT(64)
    case 128: IRSC_DW_TC_COUT(128)
    default: return cudaErrorInvalidValue;
  }
#undef IRSC_DW_TC_COUT
#undef IRSC_DW_TC
}

}  // namespace tc
}  // namespace irsc
