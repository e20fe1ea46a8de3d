// Tensor-core kernels of the two stems (sm_90a): the 3^3 submanifold convs
// whose input is the raw point features, bf16 in, f32 accumulation, at any
// Cin that the tensor-core kernels of sparse_conv_tc.cuh do not take (the
// repo's configs give 7: xyz, rgb and height; 10 with normals; 135 with the
// 128 multiview channels):
//
//   stem_conv_kernel  out[v] = epilogue(cols(v) @ W_flat)              K1 at a stem
//   stem_dw_kernel    partial[s] = sum_{rows r of split s} cols(r)^T g_r   K3 at a stem
//
// Per offset, 7 or 10 channels would fill less than an mma's k-depth of 16,
// and 135 is no multiple of it, so both kernels take their depth from the
// im2col of a row instead: cols(v) holds the row's 27 neighbours side by
// side,
//
//   cols(v)[k * cin + c] = x[nbr[v, k], c]      (zero for -1),
//
// and W_flat is W [27, cin, Cout] as it is stored, read as [27 * cin,
// Cout].  The depth 27 * cin is padded to a k-step of 16 (189 -> 192 at
// Cin = 7, 270 -> 272 at 10, 3645 -> 3648 at 135; padding Cin to 8 would
// take 224 at 7).  The dense packing also makes dW[k, c] row k * cin + c of
// cols^T g, which is the [27, cin, Cout] layout as stored.
// ops/gather_conv.stem_im2col and stem_weight write the same layout in
// PyTorch, for the tests.
//
// The depth is cut into chunks of CHUNK = 192 columns, the tile a block
// stages at once (one chunk at Cin = 7, two at 10, 19 at 135).  K1 walks
// the chunks of its 64-row tile in order and keeps its [64, Cout]
// accumulator in registers across them; K3 puts the chunks on its grid, and
// each block keeps its [192, 32] product in registers.
//
// A bf16 row of 7, 10 or 135 channels (14, 20, 270 bytes) starts 2-byte
// aligned, so the 16-byte cp.async of the other kernels cannot gather it.
// The gather reads it with 2-byte loads, consecutive lanes on consecutive
// columns of the chunk, so a warp instruction reads 32 adjacent columns: a
// run of one neighbour's channels, or ~4.6 neighbours' at Cin = 7.  A
// per-chunk table (map_columns) turns a column into its (offset, channel),
// so no thread divides by Cin in the gather.  The rows stay in L2 across
// their 27 uses.  W_flat's rows (Cout x 2 bytes) and g's rows are 64-byte
// aligned and go by 16-byte cp.async.  Both kernels stage 64-row tiles
// [64][CHUNK + 8] and feed mma.sync.m16n8k16 through ldmatrix as the
// tensor-core templates of sparse_conv_tc.cuh do.

#pragma once

#include "sparse_conv_tc.cuh"

namespace irsc {
namespace stem {

using tc::bf16;

constexpr int K = 27;                      // the stems' 3^3 map
constexpr int CHUNK = 192;                 // im2col columns a block stages at once
constexpr int MAX_CIN = 0xffff;            // a channel fits the 16 bits map_columns gives it
constexpr int THREADS = 128;               // 4 warps
constexpr int BM = 64;                     // rows of a tile
constexpr int X_STRIDE = CHUNK + tc::PAD;  // 400 bytes: ldmatrix rows hit distinct banks

// The im2col depth of a row: K * cin rounded up to a k-step of 16.
__host__ __device__ constexpr int depth(int cin) { return (K * cin + 15) / 16 * 16; }
// The chunks of that depth.
__host__ __device__ constexpr int chunks(int cin) { return (depth(cin) + CHUNK - 1) / CHUNK; }

// The loops below read global memory in batches of U elements a thread into
// registers and only then store them to shared memory: a shared store may
// alias the next shared index read (x_s and idx_s share one buffer in K1),
// so a loop that stores as it loads keeps one global load in flight a
// thread.

// idx_s[r * K + k] = nbr[(row0 + r) * K + k] for the tile's first `rows`
// rows, -1 after them (a coalesced read of the tile's map).  Returns to
// every thread whether any index is valid; its barrier publishes idx_s.
__device__ __forceinline__ bool load_indices(int* idx_s, const int* __restrict__ nbr,
                                             long long row0, int rows) {
  constexpr int U = (BM * K + THREADS - 1) / THREADS;  // 14: all of a thread's indices
  int v[U];
  bool any = false;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = threadIdx.x + u * THREADS;
    v[u] = e < rows * K ? nbr[row0 * K + e] : -1;
    any |= v[u] >= 0;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = threadIdx.x + u * THREADS;
    if (e < BM * K) idx_s[e] = v[u];
  }
  return __syncthreads_or(any);
}

// col_s[jj] = (k << 16) | c for column j = j0 + jj = k * cin + c of the
// im2col, -1 for a column past 27 * cin (zero padding).  The caller's next
// barrier publishes it.
__device__ __forceinline__ void map_columns(int* col_s, int j0, int cin) {
  const int width = K * cin;
  for (int jj = threadIdx.x; jj < CHUNK; jj += THREADS) {
    const int j = j0 + jj;
    col_s[jj] = j < width ? ((j / cin) << 16) | (j % cin) : -1;
  }
}

// x_s[r][jj] = x[idx_s[r * K + k], c] for column jj = (k, c) of col_s, zero
// for an index of -1 or a padding column: the tile's cols over one chunk.
// Element e = r * CHUNK + jj goes to thread e % THREADS, so consecutive
// lanes read consecutive columns.
template <int U>
__device__ __forceinline__ void gather(bf16* x_s, const bf16* __restrict__ x, const int* idx_s,
                                       const int* col_s, int cin) {
  constexpr int N = BM * CHUNK;  // elements of a tile
  static_assert(N % (U * THREADS) == 0, "whole batches");
  const bf16 zero = __float2bfloat16(0.f);
  for (int e0 = threadIdx.x; e0 < N; e0 += U * THREADS) {
    bf16 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / CHUNK;
      const int col = col_s[e - r * CHUNK];
      const int src = col >= 0 ? idx_s[r * K + (col >> 16)] : -1;
      v[u] = src >= 0 ? x[static_cast<long long>(src) * cin + (col & 0xffff)] : zero;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / CHUNK;
      x_s[r * X_STRIDE + e - r * CHUNK] = v[u];
    }
  }
}

// The epilogue of a 64-row output tile of NOUT channels whose warp w holds
// rows 16w..16w+15 in acc: relu?(acc * scale + bias) (scale and bias
// optional), stored in O for the tile's first `rows` rows; the same as
// gather_gemm_tc_kernel's.  The accumulator fragment holds rows lane/4 and
// lane/4 + 8 of the warp's 16, columns 8j + 2(lane%4) + {0, 1}.
template <typename O, int NOUT>
__device__ __forceinline__ void store_tile(const float (&acc)[NOUT / 8][4], O* __restrict__ out,
                                           long long row0, int rows,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, int relu) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + h * 8;
    if (r >= rows) continue;
    O* dst = out + (row0 + r) * NOUT;
#pragma unroll
    for (int j = 0; j < NOUT / 8; ++j) {
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
      tc::store2<O>(dst + n, v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------
// K1 at a stem.  Block = 64 output rows x COUT, warp w owns rows 16w..16w+15
// and every channel.  The block reads its [64, 27] indices; a tile of
// padding rows (all -1) goes straight to the epilogue of a zero sum.
// Otherwise, chunk by chunk of the depth, it stages that chunk's rows of
// W_flat (cp.async, in flight during the gather), gathers the chunk's
// columns of its cols and runs the MMAs of the chunk into one accumulator;
// the epilogue (scale, bias, ReLU) acts on the f32 accumulators at the end.
// ---------------------------------------------------------------------------
template <int COUT>
struct ConvShape {
  static constexpr int W_STRIDE = COUT + tc::PAD;
  static constexpr size_t SMEM_BYTES =
      (BM * X_STRIDE + CHUNK * W_STRIDE) * sizeof(bf16) + (BM * K + CHUNK) * sizeof(int);
};

template <typename O, int COUT>
__global__ void __launch_bounds__(THREADS)
stem_conv_kernel(const bf16* __restrict__ x, const int* __restrict__ nbr,
                 const bf16* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, O* __restrict__ out, long long v_out, int cin,
                 int relu) {
  using S = ConvShape<COUT>;
  constexpr int NT = COUT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x_s = reinterpret_cast<bf16*>(smem);                       // [BM][X_STRIDE]
  bf16* w_s = x_s + BM * X_STRIDE;                                 // [CHUNK][W_STRIDE]
  int* idx_s = reinterpret_cast<int*>(w_s + CHUNK * S::W_STRIDE);  // [BM * K]
  int* col_s = idx_s + BM * K;                                     // [CHUNK]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int rows = static_cast<int>(min(static_cast<long long>(BM), v_out - row0));
  const int width = K * cin;  // rows of W_flat, filled columns of cols
  const int d = depth(cin);

  float acc[NT][4] = {};
  if (load_indices(idx_s, nbr, row0, rows)) {
    constexpr int CPW = COUT / 8;  // 16-byte chunks in a row of W_flat
    for (int j0 = 0; j0 < d; j0 += CHUNK) {
      if (j0 > 0) __syncthreads();  // the last chunk's MMAs are done with x_s, w_s, col_s
      const int n = min(CHUNK, d - j0);  // this chunk's depth, a multiple of 16
      for (int e = tid; e < n * CPW; e += THREADS) {
        const int j = j0 + e / CPW;
        const bool ok = j < width;  // rows past 27 * cin are zero
        tc::cp_async16(w_s + (e / CPW) * S::W_STRIDE + (e % CPW) * 8,
                       ok ? w + static_cast<long long>(j) * COUT + (e % CPW) * 8 : w, ok ? 16 : 0);
      }
      tc::cp_async_commit();
      map_columns(col_s, j0, cin);
      __syncthreads();
      gather<32>(x_s, x, idx_s, col_s, cin);
      tc::cp_async_wait<0>();
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < n; kk += 16) {
        unsigned a[4];
        tc::ldsm_x4(a, x_s + (warp * 16 + lane % 16) * X_STRIDE + kk + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned b[4];
          tc::ldsm_x4_trans(b, w_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * S::W_STRIDE +
                                   j * 8 + (lane / 16) * 8);
          tc::mma_bf16(acc[j], a, b[0], b[1]);
          tc::mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  store_tile<O, COUT>(acc, out, row0, rows, scale, bias, relu);
}

template <typename O, int COUT>
cudaError_t launch_conv(const void* x, const void* nbr, const void* w, const void* scale,
                        const void* bias, void* out, long long v_out, int cin, int relu,
                        cudaStream_t stream) {
  auto kernel = stem_conv_kernel<O, COUT>;
  constexpr size_t smem = ConvShape<COUT>::SMEM_BYTES;
  static std::atomic<int> smem_set{0};
  const cudaError_t err = tc::reserve_smem(kernel, smem_set, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (v_out + BM - 1) / BM;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(nbr), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<O*>(out),
      v_out, cin, relu);
  return cudaGetLastError();
}

// COUT one of 32, 64, 128.
template <typename O>
cudaError_t dispatch_conv(const void* x, const void* nbr, const void* w, const void* scale,
                          const void* bias, void* out, long long v_out, int cin, int cout,
                          int relu, cudaStream_t stream) {
  switch (cout) {
    case 32: return launch_conv<O, 32>(x, nbr, w, scale, bias, out, v_out, cin, relu, stream);
    case 64: return launch_conv<O, 64>(x, nbr, w, scale, bias, out, v_out, cin, relu, stream);
    case 128: return launch_conv<O, 128>(x, nbr, w, scale, bias, out, v_out, cin, relu, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K3 at a stem: one pass over g for all 27 offsets.  Block (s, nb, q) walks
// the 64-row tiles of split s in order; per tile it stages g's rows
// (columns N nb .. N nb + N - 1, N = DW_N = 32) with cp.async, in flight
// while it gathers chunk q of the tile's cols, and accumulates cols^T g: a
// [CHUNK, N] product held in registers, warps 2 x 2 over it (6 16-row tiles
// x 16 columns a warp, the tiles past depth(cin) skipped).  A tile whose
// 64 x 27 indices are all -1 is neither loaded nor multiplied.  The block
// writes rows k * cin + c of its product into partial[s] ([27 * cin, Cout],
// i.e. [27, cin, Cout]); sum_partials_kernel adds the splits in a fixed
// order, so dW is bit-identical across launches.
// ---------------------------------------------------------------------------
constexpr int DW_N = 32;  // g columns of a block

template <int N>
__global__ void __launch_bounds__(THREADS)
stem_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               const int* __restrict__ nbr, float* __restrict__ partial, long long rows, int cin,
               int cout, long long rows_per_split) {
  constexpr int WM = 2;                // warps along the depth
  constexpr int WN = 2;                // warps along the 32 columns
  constexpr int MT = CHUNK / WM / 16;  // 16-row tiles of the chunk a warp
  constexpr int NT = N / WN / 8;       // 8-column tiles a warp
  constexpr int G_STRIDE = N + tc::PAD;
  __shared__ __align__(16) bf16 x_s[BM * X_STRIDE];
  __shared__ __align__(16) bf16 g_s[BM * G_STRIDE];
  __shared__ int idx_s[BM * K];
  __shared__ int col_s[CHUNK];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int mt0 = (warp % WM) * MT;
  const int n0 = (warp / WM) * (N / WN);
  const int col0 = blockIdx.y * N;
  const int j0 = blockIdx.z * CHUNK;
  const int width = K * cin;
  const int m_tiles = min(CHUNK, depth(cin) - j0) / 16;
  const long long r_begin = static_cast<long long>(blockIdx.x) * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);

  float acc[MT][NT][4] = {};
  map_columns(col_s, j0, cin);  // published by the first tile's barriers
  for (long long r0 = r_begin; r0 < r_end; r0 += BM) {
    const int n_rows = static_cast<int>(min(static_cast<long long>(BM), r_end - r0));
    if (!load_indices(idx_s, nbr, r0, n_rows)) continue;
    constexpr int CPG = N / 8;
    for (int e = tid; e < BM * CPG; e += THREADS) {
      const int r = e / CPG;
      const int c = e % CPG;
      const bool ok = r < n_rows;
      tc::cp_async16(g_s + r * G_STRIDE + c * 8, ok ? g + (r0 + r) * cout + col0 + c * 8 : g,
                     ok ? 16 : 0);
    }
    tc::cp_async_commit();
    gather<16>(x_s, x, idx_s, col_s, cin);
    tc::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BM; kk += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (mt0 + i < m_tiles)
          tc::ldsm_x4_trans(a[i], x_s + (kk + lane % 8 + (lane / 16) * 8) * X_STRIDE +
                                      (mt0 + i) * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned b[4];
        tc::ldsm_x4_trans(b, g_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * G_STRIDE + n0 +
                                 j * 8 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (mt0 + i < m_tiles) {
            tc::mma_bf16(acc[i][j], a[i], b[0], b[1]);
            tc::mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
          }
      }
    }
    __syncthreads();  // the next tile overwrites idx_s, x_s and g_s
  }

  float* dst = partial + static_cast<long long>(blockIdx.x) * width * cout + col0 + n0 +
               (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = j0 + (mt0 + i) * 16 + lane / 4 + h * 8;
      if (m >= width) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tc::store2<float>(dst + static_cast<long long>(m) * cout + j * 8, acc[i][j][2 * h],
                          acc[i][j][2 * h + 1]);
    }
}

// stem_dw_kernel over a (splits, cout / 32, chunks(cin)) grid, then the
// fixed-order sum into dw [27, cin, cout].
inline cudaError_t launch_dw(const void* x, const void* g, const void* nbr, void* partial, void* dw,
                             long long rows, int cin, int cout, int splits, cudaStream_t stream) {
  if (cout % DW_N != 0) return cudaErrorInvalidValue;
  const long long tiles = (rows + BM - 1) / BM;
  const long long rows_per_split = (tiles + splits - 1) / splits * BM;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(cout / DW_N),
                  static_cast<unsigned>(chunks(cin)));
  stem_dw_kernel<DW_N><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const int*>(nbr),
      static_cast<float*>(partial), rows, cin, cout, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, dw, static_cast<long long>(K) * cin * cout, splits, stream);
}

}  // namespace stem
}  // namespace irsc
