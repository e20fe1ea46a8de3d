// Device templates shared by the sparse-conv kernels (sm_90a):
//
//   gather_gemm_kernel   out[v] = epilogue(sum_k A[nbr[v, k]] @ Wk)      K1, K2's dX
//   dw_partial_kernel    partial[s, k'] = sum_{rows r of split s} a_r^T b_r  K2's/K3's dW
//   sum_partials_kernel  dW = sum_s partial[s]        (fixed order; every dW route)
//
// The two FMA templates (f32 products) serve f32 inputs; bf16 takes
// sparse_conv_tc.cuh (Cin and Cout in {32, 64, 128}) or, at the stems,
// sparse_conv_stem.cuh (any other Cin).
//
// Every source under csrc/ is compiled on its own into its own library, so
// each includes this header and instantiates what it launches.
//
// Conventions (the TPU kernels' contract, instancerefer_tpu/ops/pallas_conv.py):
// nbr[V_out, K] holds int32 rows, -1 = empty neighbour (a zero row); inputs
// are f32 or bf16; every product and sum is f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace irsc {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int THREADS = 256;  // every kernel here runs 256 threads a block
constexpr int GEMM_BM = 64;   // gather_gemm: output rows per block

// ---------------------------------------------------------------------------
// Output-stationary gather-GEMM.  Block = GEMM_BM output rows x COUT
// channels; thread (ty, tx) of 16 x 16 owns rows ty + 16 i and channels
// tx + 16 j.  For each offset k the block loads its GEMM_BM indices, gathers
// the rows (zero for -1) and the weight slice into shared memory as f32 in
// tiles of BK reduction channels (a ragged width is zero-padded), and
// accumulates with FMA in registers.  No atomics: each output row belongs to
// one block.
//
// Weight layouts (reduction width cin, output width COUT):
//   MIRROR_T = false: w[K, cin, COUT], slice k used as it is (K1).
//   MIRROR_T = true:  w[K, COUT, cin], slice K-1-k used transposed — the
//     subm conv's dX over the mirrored offsets (K2), read in place.
// ---------------------------------------------------------------------------
template <typename T, typename O, int COUT, int BK, bool MIRROR_T>
__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const T* __restrict__ feats, const int* __restrict__ nbr,
                   const T* __restrict__ w, const float* __restrict__ scale,
                   const float* __restrict__ bias, O* __restrict__ out,
                   long long v_out, int k_offsets, int cin, int relu) {
  constexpr int TM = GEMM_BM / 16;
  constexpr int TN = COUT / 16;
  constexpr int WPAD = MIRROR_T ? 1 : 0;  // transposed stores hit distinct banks
  __shared__ float a_s[BK][GEMM_BM + 1];  // gathered rows, channel-major
  __shared__ float w_s[BK][COUT + WPAD];
  __shared__ int idx_s[GEMM_BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * GEMM_BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < k_offsets; ++k) {
    if (tid < GEMM_BM) {
      const long long r = row0 + tid;
      idx_s[tid] = r < v_out ? nbr[r * k_offsets + k] : -1;
    }
    __syncthreads();
    for (int c0 = 0; c0 < cin; c0 += BK) {
      for (int e = tid; e < GEMM_BM * BK; e += THREADS) {
        const int r = e / BK;
        const int c = e % BK;
        const int src = idx_s[r];
        float v = 0.f;
        if (src >= 0 && c0 + c < cin) v = to_f32(feats[static_cast<long long>(src) * cin + c0 + c]);
        a_s[c][r] = v;
      }
      if (MIRROR_T) {
        const long long base = static_cast<long long>(k_offsets - 1 - k) * COUT;
        for (int e = tid; e < BK * COUT; e += THREADS) {
          const int c = e % BK;  // consecutive threads read consecutive channels
          const int n = e / BK;
          w_s[c][n] = c0 + c < cin ? to_f32(w[(base + n) * cin + c0 + c]) : 0.f;
        }
      } else {
        for (int e = tid; e < BK * COUT; e += THREADS) {
          const int c = e / COUT;
          const int n = e % COUT;
          w_s[c][n] = c0 + c < cin
                          ? to_f32(w[(static_cast<long long>(k) * cin + c0 + c) * COUT + n])
                          : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM];
        float b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = w_s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      // the next tile (or the next offset's indices) overwrites shared memory
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= v_out) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 16 * j;
      float v = acc[i][j];
      if (scale != nullptr) v = v * scale[n] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      out[r * COUT + n] = from_f32<O>(v);
    }
  }
}

template <typename T, typename O, int COUT, int BK, bool MIRROR_T>
cudaError_t launch_gather_gemm(const void* feats, const void* nbr, const void* w,
                               const void* scale, const void* bias, void* out, long long v_out,
                               int k_offsets, int cin, int relu, cudaStream_t stream) {
  const long long blocks = (v_out + GEMM_BM - 1) / GEMM_BM;
  gather_gemm_kernel<T, O, COUT, BK, MIRROR_T>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
          static_cast<const T*>(feats), static_cast<const int*>(nbr), static_cast<const T*>(w),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<O*>(out), v_out, k_offsets, cin, relu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight gradient as a deterministic split reduction.
//
//   partial[s, k'] = sum over rows r in split s of  a_r^T b_r    [cin, COUT]
//
//   GATHER_A (K3):  a_r = A[nbr[r, k]], b_r = B[r],          k' = k
//   !GATHER_A (K2): a_r = A[r],         b_r = B[nbr[r, k]],  k' = K-1-k
//
// Grid (K, S, C): block (k, s, q) walks the rows of split s in tiles of
// DW_BR, stages both operands in shared memory as f32 (zero rows for -1 and
// past the end; channels CIN_P q .. CIN_P q + CIN_P - 1 of a, a ragged tail
// zero-padded) and keeps its [CIN_P, COUT] product in registers: thread
// (ty, tx) owns channels CIN_P q + ty + TY i and tx + TX j.  C = 1 unless
// cin > 128 (a stem with multiview features: 135).  No float atomics: each block writes its own partial, and
// sum_partials_kernel adds the S partials in a fixed order, so repeated
// launches on the same inputs give bit-identical dW.
// ---------------------------------------------------------------------------
constexpr int DW_BR = 32;  // rows per shared tile

template <typename T, int CIN_P, int COUT, bool GATHER_A>
__global__ void __launch_bounds__(THREADS)
dw_partial_kernel(const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ nbr,
                  float* __restrict__ partial, long long rows, int k_offsets, int cin,
                  long long rows_per_split) {
  constexpr int TX = CIN_P >= 16 ? 16 : 32;
  constexpr int TY = THREADS / TX;
  constexpr int TM = CIN_P / TY;
  constexpr int TN = COUT / TX;
  static_assert(TM >= 1 && TM * TY == CIN_P && TN * TX == COUT, "tile shape");
  __shared__ float a_s[DW_BR][CIN_P];
  __shared__ float b_s[DW_BR][COUT];
  __shared__ int idx_s[DW_BR];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int k = blockIdx.x;
  const int c_base = blockIdx.z * CIN_P;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += DW_BR) {
    if (tid < DW_BR) {
      const long long r = r0 + tid;
      idx_s[tid] = r < r_end ? nbr[r * k_offsets + k] : -1;
    }
    __syncthreads();
    for (int e = tid; e < DW_BR * CIN_P; e += THREADS) {
      const int r = e / CIN_P;
      const int c = e % CIN_P;
      const long long src = GATHER_A ? idx_s[r] : (r0 + r < r_end ? r0 + r : -1);
      a_s[r][c] = src >= 0 && c_base + c < cin ? to_f32(a[src * cin + c_base + c]) : 0.f;
    }
    for (int e = tid; e < DW_BR * COUT; e += THREADS) {
      const int r = e / COUT;
      const int c = e % COUT;
      const long long src = GATHER_A ? (r0 + r < r_end ? r0 + r : -1) : idx_s[r];
      b_s[r][c] = src >= 0 ? to_f32(b[src * COUT + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < DW_BR; ++r) {
      float av[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[r][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[r][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int k_out = GATHER_A ? k : k_offsets - 1 - k;
  float* dst = partial + (static_cast<long long>(blockIdx.y) * k_offsets + k_out) * cin * COUT;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c_base + ty + TY * i;
    if (c >= cin) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) dst[c * COUT + tx + TX * j] = acc[i][j];
  }
}

// dw[i] = sum_{s < splits} partial[s * n + i] in an order fixed by n and
// splits alone: the splits fall into SUM_RUNS runs of consecutive splits,
// each run is summed in ascending order by its own warp, and the run sums
// are added in ascending order.  A block covers 32 elements (a coalesced
// row of each partial), so a small dW with many splits (the stems': 6048
// elements, ~500 splits) still spreads over ~200 blocks.
constexpr int SUM_RUNS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ dw, long long n,
                    int splits) {
  __shared__ float run_s[SUM_RUNS][32];
  const int e = threadIdx.x % 32;
  const int q = threadIdx.x / 32;
  const long long i = static_cast<long long>(blockIdx.x) * 32 + e;
  const int per = (splits + SUM_RUNS - 1) / SUM_RUNS;
  const int p_end = min(splits, (q + 1) * per);
  float s = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int p = q * per; p < p_end; ++p) s += partial[p * n + i];
  }
  run_s[q][e] = s;
  __syncthreads();
  if (q == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < SUM_RUNS; ++j) t += run_s[j][e];
    dw[i] = t;
  }
}

inline cudaError_t launch_sum_partials(const void* partial, void* dw, long long n, int splits,
                                       cudaStream_t stream) {
  sum_partials_kernel<<<static_cast<unsigned>((n + 31) / 32), THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, splits);
  return cudaGetLastError();
}

template <typename T, int CIN_P, int COUT, bool GATHER_A>
cudaError_t launch_dw(const void* a, const void* b, const void* nbr, void* partial, void* dw,
                      long long rows, int k_offsets, int cin, int splits, cudaStream_t stream) {
  const long long tiles = (rows + DW_BR - 1) / DW_BR;
  const long long rows_per_split = (tiles + splits - 1) / splits * DW_BR;
  const dim3 grid(static_cast<unsigned>(k_offsets), static_cast<unsigned>(splits),
                  static_cast<unsigned>((cin + CIN_P - 1) / CIN_P));
  dw_partial_kernel<T, CIN_P, COUT, GATHER_A><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const int*>(nbr),
      static_cast<float*>(partial), rows, k_offsets, cin, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, dw, static_cast<long long>(k_offsets) * cin * COUT, splits,
                             stream);
}

// CIN_P: the smallest of 8, 32, 64, 128 that holds cin; 128 with
// ceil(cin / 128) channel tiles on the grid beyond that.
template <typename T, bool GATHER_A>
cudaError_t dispatch_dw(const void* a, const void* b, const void* nbr, void* partial, void* dw,
                        long long rows, int k_offsets, int cin, int cout, int splits,
                        cudaStream_t stream) {
#define IRSC_DW(CP, CO) \
  return launch_dw<T, CP, CO, GATHER_A>(a, b, nbr, partial, dw, rows, k_offsets, cin, splits, stream)
#define IRSC_DW_COUT(CP)          \
  switch (cout) {                 \
    case 32: IRSC_DW(CP, 32);     \
    case 64: IRSC_DW(CP, 64);     \
    case 128: IRSC_DW(CP, 128);   \
    default: return cudaErrorInvalidValue; \
  }
  if (cin <= 8) { IRSC_DW_COUT(8) }
  if (cin <= 32) { IRSC_DW_COUT(32) }
  if (cin <= 64) { IRSC_DW_COUT(64) }
  IRSC_DW_COUT(128)
#undef IRSC_DW_COUT
#undef IRSC_DW
}

}  // namespace irsc
