// Sparse-conv gather-GEMM with a fused per-channel epilogue, for sm_90a.
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
// What bounds it on the card: the gathered bytes.  Each output row reads K
// input rows of Cin values (27 x 128 x 2 B = 6.9 KB per row of a bf16
// 128-channel residual conv) to do 2*K*Cin*Cout flops, so the work is a
// gather feeding a small GEMM.  The largest input stage at the bench's
// batch (32 scenes: 139264 rows x 64 channels, 18 MB in bf16) fits the
// 50 MB L2, so most gathered rows come from L2, not HBM.  Design: output-stationary tiles of BM rows x Cout channels; for
// each offset k the block loads its BM indices, gathers the rows (a zero row
// for -1) and the W[k] slice into shared memory as f32, and accumulates
// with FMA in registers.  No atomics: each output row belongs to one block.
// Accumulation is f32 for both input types; the epilogue runs on the f32
// accumulator and the store rounds to the input type.  Tensor cores
// (mma/wgmma), TMA and skipping all-padding tiles are later work.
//
// C interface (bound with ctypes): ir_gather_conv returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int THREADS = 256;  // 16 x 16 threads; thread (ty, tx)

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

// COUT: output channels (32, 64 or 128).  BK: input channels per shared
// tile (8 for the 7-channel stems, 32 otherwise); a ragged Cin is padded
// with zeros inside the tile.  Thread (ty, tx) owns rows ty + 16 i and
// channels tx + 16 j, so shared reads are broadcasts or consecutive words.
template <typename T, int COUT, int BK>
__global__ void __launch_bounds__(THREADS)
gather_conv_kernel(const T* __restrict__ feats, const int* __restrict__ nbr,
                   const T* __restrict__ w, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   long long v_out, int k_offsets, int cin, int relu) {
  constexpr int TM = BM / 16;
  constexpr int TN = COUT / 16;
  __shared__ float a_s[BK][BM + 1];  // gathered rows, channel-major; +1 avoids bank conflicts
  __shared__ float w_s[BK][COUT];
  __shared__ int idx_s[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < k_offsets; ++k) {
    if (tid < BM) {
      const long long r = row0 + tid;
      idx_s[tid] = r < v_out ? nbr[r * k_offsets + k] : -1;
    }
    __syncthreads();
    for (int c0 = 0; c0 < cin; c0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK;
        const int c = e % BK;
        const int src = idx_s[r];
        float v = 0.f;
        if (src >= 0 && c0 + c < cin) v = to_f32(feats[static_cast<long long>(src) * cin + c0 + c]);
        a_s[c][r] = v;
      }
      for (int e = tid; e < BK * COUT; e += THREADS) {
        const int c = e / COUT;
        const int n = e % COUT;
        w_s[c][n] = c0 + c < cin
                        ? to_f32(w[(static_cast<long long>(k) * cin + c0 + c) * COUT + n])
                        : 0.f;
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
      out[r * COUT + n] = from_f32<T>(v);
    }
  }
}

template <typename T, int COUT, int BK>
cudaError_t launch(const void* feats, const void* nbr, const void* w, const void* scale,
                   const void* bias, void* out, long long v_out, int k_offsets, int cin,
                   int relu, cudaStream_t stream) {
  const long long blocks = (v_out + BM - 1) / BM;
  gather_conv_kernel<T, COUT, BK><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(nbr), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<T*>(out),
      v_out, k_offsets, cin, relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* feats, const void* nbr, const void* w, const void* scale,
                     const void* bias, void* out, long long v_out, int k_offsets, int cin,
                     int cout, int relu, cudaStream_t stream) {
  const bool narrow = cin <= 8;
  switch (cout) {
    case 32:
      return narrow ? launch<T, 32, 8>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, relu, stream)
                    : launch<T, 32, 32>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, relu, stream);
    case 64:
      return narrow ? launch<T, 64, 8>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, relu, stream)
                    : launch<T, 64, 32>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, relu, stream);
    case 128:
      return narrow ? launch<T, 128, 8>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, relu, stream)
                    : launch<T, 128, 32>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, relu, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feats, w and out share it).
// scale and bias are float32 [cout], both null for no affine epilogue.
extern "C" int ir_gather_conv(const void* feats, const void* nbr, const void* w,
                              const void* scale, const void* bias, void* out,
                              long long v_out, int k_offsets, int cin, int cout, int relu,
                              int dtype, void* stream) {
  if (v_out <= 0 || k_offsets <= 0 || cin <= 0 || (v_out + BM - 1) / BM > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, cout, relu, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(feats, nbr, w, scale, bias, out, v_out, k_offsets, cin, cout,
                                   relu, s);
  return cudaErrorInvalidValue;
}
