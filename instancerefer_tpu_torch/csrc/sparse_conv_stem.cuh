// Tensor-core kernels of the two stems (sm_90a): the 3^3 submanifold convs
// whose input is the raw point features, bf16 in, f32 accumulation, at any
// Cin that the tensor-core kernels of sparse_conv_tc.cuh do not take (the
// repo's configs give 7: xyz, rgb and height; 10 with normals; 135 with the
// 128 multiview channels):
//
//   K1 at a stem  out[v] = epilogue(cols(v) @ W_flat)
//   K3 at a stem  partial[s] = sum_{rows r of split s} cols(r)^T g_r
//
// Per offset, 7 or 10 channels fill less than an mma's k-depth of 16 and
// 135 is no multiple of it, so both kernels take their depth from the
// im2col of a row instead: cols(v) holds the row's 27 neighbours side by
// side, channel c of neighbour k in column k * cp + c (zero for -1), and
// W_flat holds W [27, cin, Cout] in the same order, zero rows for c >= cin;
// cp is cin rounded up to 8 channels (7 -> 8, 10 -> 16, 135 -> 136), and
// the depth 27 * cp is padded to a k-step of 16 (3672 -> 3680 at 135).
// dW[k, c] is row k * cp + c of cols^T g, and the kernels write it at
// [k, c] of the [27, cin, Cout] layout as stored.  ops/gather_conv.
// stem_im2col and stem_weight write the same layouts in PyTorch, for the
// tests.
//
// x comes zero-padded to cp channels (ops/gather_conv.pad_channels, one
// pass that takes the place of the cast to bf16), so every 16-byte piece
// of an im2col row is 8 channels of one neighbour, and the gather is one
// 16-byte cp.async a piece, zero-filled for -1, from a (k, c) the thread
// computes once per stage.  What bounds the kernels: each row of x is
// gathered 27 times (4.3 GB from L2 into shared memory at the Cin-135
// scene stem, against 158 MB of x, which the L2 mostly serves), and the
// 137 GFLOP of MMAs there, which share the shared memory's bandwidth with
// the gathers' writes.  Neither alone accounts for the time, so the design
// keeps both in flight:
//   K1 (stem_wide_conv_kernel): 128-row tiles (W_flat is staged once per
//   128 rows, half the traffic of 64-row tiles), 8 warps as 4 row groups
//   of 32 x 2 k-groups of each stage's k-steps, and a ring of 4 stages of
//   64 columns (x tile and W rows), so three stages' gathers are in flight
//   while the warps multiply the fourth; two blocks an SM.  The k-groups'
//   sums meet in shared memory at the end (a fixed order), then the BN/ReLU
//   epilogue.
//   K3 (stem_wide_dw_kernel): a block covers DB = 768 columns of the depth
//   (16 warps x 3 16-column tiles, 48 accumulators a thread), so g and the
//   map are read once per 768 columns (5 times at Cin 135, once at 7 and
//   10); one block an SM, 64-row tiles in a ring of 2, the next tile's
//   gather in flight over this one's MMAs and the map of the tile after it
//   fetched into registers meanwhile.  16 warps and not 8: the chain of a
//   gathered piece (its table entry, its index, then the copy) needs the
//   warps to hide its latency.  The splits are summed in a fixed order by
//   sum_partials_kernel, so dW is bit-identical across launches.
// Both feed mma.sync.m16n8k16 through ldmatrix as the tensor-core
// templates of sparse_conv_tc.cuh do; shared rows are padded by 16 bytes
// so the 8 rows of an ldmatrix phase fall in distinct banks.
//
// DB is also the wrapper's (ops/gather_conv.STEM_DW_BLOCK, which sizes the
// split count by the grid): the build passes it as IRSC_STEM_DW_BLOCK, and
// a static_assert holds it to the warps and tiles above.

#pragma once

#include "sparse_conv_tc.cuh"

namespace irsc {
namespace stem {

using tc::bf16;

constexpr int K = 27;       // the stems' 3^3 map
constexpr int MAX_CIN = 0xfff8;  // a channel offset fits the 16 bits of a piece entry

// idx_s[r * K + k] = nbr[(row0 + r) * K + k] for the tile's first `rows`
// rows, -1 after them (a coalesced read of the tile's map).  The global
// loads go to registers first; the barrier between them and the stores
// lets the caller reuse idx_s (and what it staged from it) tile after
// tile.  Returns to every thread whether any index is valid; its barrier
// publishes idx_s.
template <int ROWS, int NT>
__device__ __forceinline__ bool load_indices(int* idx_s, const int* __restrict__ nbr,
                                             long long row0, int rows) {
  constexpr int U = (ROWS * K + NT - 1) / NT;  // all of a thread's indices
  int v[U];
  bool any = false;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = threadIdx.x + u * NT;
    v[u] = e < rows * K ? nbr[row0 * K + e] : -1;
    any |= v[u] >= 0;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = threadIdx.x + u * NT;
    if (e < ROWS * K) idx_s[e] = v[u];
  }
  return __syncthreads_or(any);
}

// relu?(acc * scale + bias) (scale and bias optional) of a warp's 16-row
// accumulator tile of NT 8-column tiles, rows r16.. of the block's tile at
// row0, columns col0.. of an output of `ld` columns; rows from `rows` on
// are not stored.  The fragment holds rows lane/4 and lane/4 + 8, columns
// 8j + 2(lane%4) + {0, 1}; the same epilogue as gather_gemm_tc_kernel's.
template <typename O, int NT>
__device__ __forceinline__ void store_rows(const float (&acc)[NT][4], O* __restrict__ out, int ld,
                                           long long row0, int r16, int rows, int col0,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, int relu) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r16 + lane / 4 + h * 8;
    if (r >= rows) continue;
    O* dst = out + (row0 + r) * ld + col0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = j * 8 + (lane % 4) * 2;
      float v0 = acc[j][2 * h];
      float v1 = acc[j][2 * h + 1];
      if (scale != nullptr) {
        v0 = v0 * scale[col0 + n] + bias[col0 + n];
        v1 = v1 * scale[col0 + n + 1] + bias[col0 + n + 1];
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      tc::store2<O>(dst + n, v0, v1);
    }
  }
}

constexpr int THREADS = 256;              // 8 warps
// Output (K1) or g (K3) columns of a block, N: 32, or 16 where Cout is no
// multiple of 32 (PointGroup's input conv, 6 -> 16).  A block's staged W
// and g rows are N + PAD wide (80 or 48 bytes).
constexpr int N = 32;
constexpr int block_n(int cout) { return cout % 32 == 0 ? 32 : 16; }
// K1
constexpr int BM = 128;                   // rows of a tile
constexpr int CH = 64;                    // depth columns of a stage: 4 k-steps
constexpr int STAGES = 4;
constexpr int WR = 4;                     // warps along the rows (row groups)
constexpr int WK = THREADS / 32 / WR;     // warps along a stage's k-steps
constexpr int MI = BM / WR / 16;          // 16-row tiles a warp
constexpr int KS = CH / 16 / WK;          // k-steps of a stage a warp
constexpr int XS = CH + tc::PAD;          // 144 bytes
template <int NB>
__host__ __device__ constexpr int stage_elems() {  // bf16 elements of a stage
  return BM * XS + CH * (NB + tc::PAD);
}
template <int NB>
constexpr size_t conv_smem() {
  return STAGES * stage_elems<NB>() * sizeof(bf16) + BM * K * sizeof(int);
}
// K3
constexpr int DW_THREADS = 512;           // 16 warps
constexpr int BR = 64;                    // rows of a tile
constexpr int DW_STAGES = 2;
constexpr int MT = 3;                     // 16-column tiles of the depth a warp
#ifndef IRSC_STEM_DW_BLOCK
#error "IRSC_STEM_DW_BLOCK: K3's block depth, passed by ops/gather_conv.build()"
#endif
constexpr int DB = IRSC_STEM_DW_BLOCK;    // 768 depth columns a block
constexpr int DXS = DB + tc::PAD;         // 1552 bytes
template <int NB>
__host__ __device__ constexpr int dw_stage_elems() {  // bf16 elements of a stage
  return BR * DXS + BR * (NB + tc::PAD);
}
constexpr int IDX_U = (BR * K + DW_THREADS - 1) / DW_THREADS;  // a tile's indices a thread
template <int NB>
constexpr size_t dw_smem() {
  return DW_STAGES * (dw_stage_elems<NB>() * sizeof(bf16) + BR * K * sizeof(int)) +
         DB / 8 * sizeof(int);
}

static_assert(THREADS == CH / 8 * 32 && BM % 32 == 0, "K1: a thread's piece of every 32nd row");
static_assert(THREADS == CH * N / 8, "K1: at most one 16-byte piece of W_flat a thread a stage");
static_assert(DW_THREADS >= BR * N / 8, "K3: at most one 16-byte piece of g a thread a tile");
static_assert(WR * WK * 32 == THREADS && MI * WR * 16 == BM && KS * WK * 16 == CH, "K1: warps");
static_assert((WK - 1) * BM * N * sizeof(float) <= STAGES * stage_elems<16>() * sizeof(bf16),
              "K1: the k-groups' sums");
static_assert(DB == DW_THREADS / 32 * MT * 16, "K3: a block's depth is its warps' tiles");
static_assert(DW_STAGES <= 32, "K3: a tile's bit in `live` is its index mod 32");

// The channels of a staged row: cin rounded up to 8, 16 bytes.
__host__ __device__ constexpr int channels(int cin) { return (cin + 7) / 8 * 8; }
// The im2col depth: K * channels(cin) rounded up to a k-step of 16.
__host__ __device__ constexpr int depth(int cin) { return (K * channels(cin) + 15) / 16 * 16; }
// K3's blocks along the depth.
__host__ __device__ constexpr int depth_blocks(int cin) { return (depth(cin) + DB - 1) / DB; }

// ---------------------------------------------------------------------------
// K1.  Block (t, nb) = 128 output rows x 32 channels (32 nb ..).
// Warp w owns rows BM / WR x (w % WR) .. and, of every stage's k-steps,
// those of k-group w / WR.  Stage j holds the tile's cols over depth
// columns 64 j .. 64 j + 63 and the same rows of W_flat; thread t gathers
// piece t % 8 of rows t / 8 + 32 u.  A tile of padding rows goes straight
// to the epilogue of a zero sum.
// ---------------------------------------------------------------------------
template <typename O, int NB = N>
__global__ void __launch_bounds__(THREADS, 2)
stem_wide_conv_kernel(const bf16* __restrict__ x, const int* __restrict__ nbr,
                      const bf16* __restrict__ w, const float* __restrict__ scale,
                      const float* __restrict__ bias, O* __restrict__ out, long long v_out,
                      int cin, int cout, int relu) {
  constexpr int N = NB;
  constexpr int N_STRIDE = N + tc::PAD;
  constexpr int STAGE = stage_elems<N>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);                         // STAGES x STAGE
  int* idx_s = reinterpret_cast<int*>(stages + STAGES * STAGE);         // [BM * K]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rg = warp % WR;  // row group
  const int kg = warp / WR;  // k-group
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int rows = static_cast<int>(min(static_cast<long long>(BM), v_out - row0));
  const int col0 = blockIdx.y * N;
  const int cp = channels(cin);
  const int q = cp / 8;  // pieces a neighbour
  const int d = depth(cin);
  const int n_stages = (d + CH - 1) / CH;

  float acc[MI][N / 8][4] = {};
  if (load_indices<BM, THREADS>(idx_s, nbr, row0, rows)) {
    const int pp = tid % (CH / 8);  // this thread's piece of a staged row
    const int r1 = tid / (CH / 8);  // and its first row
    const int wr = tid / (N / 8);   // its row of the staged W_flat
    const int wc = tid % (N / 8);   // and piece of that row

    auto load = [&](int buf, int j) {
      bf16* xs = stages + buf * STAGE;
      bf16* ws = xs + BM * XS;
      const int p = j * (CH / 8) + pp;  // the piece of an im2col row
      const int k = p / q;
      const int c = (p - k * q) * 8;
#pragma unroll
      for (int u = 0; u < BM / 32; ++u) {
        const int r = r1 + u * 32;
        const int src = k < K ? idx_s[r * K + k] : -1;  // pieces past 27 x cp are zero
        tc::cp_async16(xs + r * XS + pp * 8,
                       src >= 0 ? x + static_cast<long long>(src) * cp + c : x, src >= 0 ? 16 : 0);
      }
      if (tid < CH * N / 8) {  // one piece of W_flat a thread (half the threads at N 16)
        const int jw = j * CH + wr;  // the row of W_flat
        const int kw = jw / cp;
        const int cw = jw - kw * cp;
        const bool ok = kw < K && cw < cin;  // zero rows for padding channels and depth
        tc::cp_async16(ws + wr * N_STRIDE + wc * 8,
                       ok ? w + static_cast<long long>(kw * cin + cw) * cout + col0 + wc * 8 : w,
                       ok ? 16 : 0);
      }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_stages) load(s, s);
      tc::cp_async_commit();
    }
    for (int j = 0; j < n_stages; ++j) {
      tc::cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage j is in; every warp is done with stage j - 1's buffer
      if (j + STAGES - 1 < n_stages) load((j + STAGES - 1) % STAGES, j + STAGES - 1);
      tc::cp_async_commit();  // an empty group near the end keeps the count
      const bf16* xs = stages + (j % STAGES) * STAGE;
      const bf16* ws = xs + BM * XS;
      const int steps = min(CH, d - j * CH) / 16;
#pragma unroll
      for (int s = KS * kg; s < KS * kg + KS; ++s) {
        if (s >= steps) break;
        const int kk = s * 16;
        unsigned a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          tc::ldsm_x4(a[mi], xs + (rg * MI * 16 + mi * 16 + lane % 16) * XS + kk + (lane / 16) * 8);
#pragma unroll
        for (int n = 0; n < N / 8; n += 2) {
          unsigned b[4];
          tc::ldsm_x4_trans(b, ws + (kk + lane % 8 + ((lane / 8) % 2) * 8) * N_STRIDE + n * 8 +
                                   (lane / 16) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            tc::mma_bf16(acc[mi][n], a[mi], b[0], b[1]);
            tc::mma_bf16(acc[mi][n + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    tc::cp_async_wait<0>();
  }

  // the k-groups' sums join the first's through the stages' memory, in
  // the order of the k-groups
  float* red = reinterpret_cast<float*>(smem);  // [WK - 1][WR][PER][32 lanes]
  constexpr int PER = MI * (N / 8) * 4;         // accumulators a thread
  __syncthreads();  // every warp is done with the stages
  if (kg > 0) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      red[(((kg - 1) * WR + rg) * PER + i) * 32 + lane] = (&acc[0][0][0])[i];
  }
  __syncthreads();
  if (kg == 0) {
    for (int h = 0; h < WK - 1; ++h)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        (&acc[0][0][0])[i] += red[((h * WR + rg) * PER + i) * 32 + lane];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      store_rows<O, N / 8>(acc[mi], out, cout, row0, rg * MI * 16 + mi * 16, rows, col0, scale,
                           bias, relu);
  }
}

// K1 over a (tiles, cout / NB) grid.
template <typename O, int NB>
cudaError_t launch_conv_n(const void* x, const void* nbr, const void* w, const void* scale,
                          const void* bias, void* out, long long v_out, int cin, int cout,
                          int relu, cudaStream_t stream) {
  auto kernel = stem_wide_conv_kernel<O, NB>;
  static std::atomic<int> smem_set{0};
  const cudaError_t err = tc::reserve_smem(kernel, smem_set, conv_smem<NB>());
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((v_out + BM - 1) / BM), static_cast<unsigned>(cout / NB));
  kernel<<<grid, THREADS, conv_smem<NB>(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(nbr), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<O*>(out),
      v_out, cin, cout, relu);
  return cudaGetLastError();
}

// K1 at any cout that is a multiple of 16: blocks of block_n(cout) columns.
template <typename O>
cudaError_t launch_conv(const void* x, const void* nbr, const void* w, const void* scale,
                        const void* bias, void* out, long long v_out, int cin, int cout,
                        int relu, cudaStream_t stream) {
  if (cout % 16 != 0) return cudaErrorInvalidValue;
  if (block_n(cout) == 32)
    return launch_conv_n<O, 32>(x, nbr, w, scale, bias, out, v_out, cin, cout, relu, stream);
  return launch_conv_n<O, 16>(x, nbr, w, scale, bias, out, v_out, cin, cout, relu, stream);
}

// ---------------------------------------------------------------------------
// K3.  Block (s, nb, z) walks the 64-row tiles of split s in order
// and accumulates its 768 depth columns (768 z ..) of cols^T g, g's
// columns 32 nb .. 32 nb + 31: warp w owns the MT 16-column tiles MT w ..
// of them, all 32 columns (4 MMAs per tile and k-step of 16 rows).  The
// piece table piece_s maps a staged piece to its (offset k, channel c)
// once per block.  The tiles go through a ring of DW_STAGES stages: while
// the warps multiply tile t, the gathers of the next tiles (x over the
// block's columns, g's rows) are in flight, and the map of the tile after
// them is on its way into registers; a tile with no valid index is
// neither gathered nor multiplied.  The block writes row k * cin + c of dW
// for each of its columns k * cp + c with c < cin into partial[s] ([27,
// cin, Cout]); padding channels and depth are never written.
// ---------------------------------------------------------------------------
template <int NB = N>
__global__ void __launch_bounds__(DW_THREADS, 1)
stem_wide_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                    const int* __restrict__ nbr, float* __restrict__ partial, long long rows,
                    int cin, int cout, long long rows_per_split) {
  constexpr int N = NB;
  constexpr int N_STRIDE = N + tc::PAD;
  constexpr int DW_STAGE = dw_stage_elems<N>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);                        // DW_STAGES x DW_STAGE
  int* idx_s = reinterpret_cast<int*>(stages + DW_STAGES * DW_STAGE);  // DW_STAGES x [BR * K]
  int* piece_s = idx_s + DW_STAGES * BR * K;                           // [DB / 8]: (k << 16) | c

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int mt0 = warp * MT;
  const int col0 = blockIdx.y * N;
  const int j0 = blockIdx.z * DB;
  const int cp = channels(cin);
  const int q = cp / 8;
  const int m_tiles = min(DB, depth(cin) - j0) / 16;
  const int n_pieces = 2 * m_tiles;
  const long long r_begin = static_cast<long long>(blockIdx.x) * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);
  const int n_tiles = static_cast<int>(max(0LL, (r_end - r_begin + BR - 1) / BR));

  for (int i = tid; i < DB / 8; i += DW_THREADS) {
    const int p = j0 / 8 + i;
    const int k = p / q;
    piece_s[i] = k < K ? (k << 16) | ((p - k * q) * 8) : -1;
  }  // published by the prologue's barriers

  // tile t's map: fetch() starts its loads into v (-1 past the split),
  // stash() stores v into the tile's stage once they have landed and
  // returns whether this thread saw a valid index
  int v[IDX_U];
  auto fetch = [&](int t) {
    const long long r0 = r_begin + static_cast<long long>(t) * BR;
    const int n = t < n_tiles ? static_cast<int>(min(static_cast<long long>(BR), r_end - r0)) * K : 0;
#pragma unroll
    for (int u = 0; u < IDX_U; ++u) {
      const int e = tid + u * DW_THREADS;
      v[u] = e < n ? nbr[r0 * K + e] : -1;
    }
  };
  auto stash = [&](int t) {
    int* dst = idx_s + (t % DW_STAGES) * BR * K;
    bool any = false;
#pragma unroll
    for (int u = 0; u < IDX_U; ++u) {
      const int e = tid + u * DW_THREADS;
      if (e < BR * K) dst[e] = v[u];
      any |= v[u] >= 0;
    }
    return any;
  };
  auto issue = [&](int t) {  // tile t's gathers into its stage
    bf16* xs = stages + (t % DW_STAGES) * DW_STAGE;
    bf16* gs = xs + BR * DXS;
    const int* is = idx_s + (t % DW_STAGES) * BR * K;
    const long long r0 = r_begin + static_cast<long long>(t) * BR;
#pragma unroll 4
    for (int e = tid; e < BR * (DB / 8); e += DW_THREADS) {
      const int r = e / (DB / 8);
      const int i = e - r * (DB / 8);
      if (i >= n_pieces) continue;  // past the depth: never multiplied
      const int piece = piece_s[i];
      const int src = piece >= 0 ? is[r * K + (piece >> 16)] : -1;
      tc::cp_async16(xs + r * DXS + i * 8,
                     src >= 0 ? x + static_cast<long long>(src) * cp + (piece & 0xffff) : x,
                     src >= 0 ? 16 : 0);
    }
    if (tid < BR * N / 8) {
      const int r = tid / (N / 8);
      const int c = tid % (N / 8);
      const bool ok = r0 + r < r_end;
      tc::cp_async16(gs + r * N_STRIDE + c * 8, ok ? g + (r0 + r) * cout + col0 + c * 8 : g,
                     ok ? 16 : 0);
    }
  };
  unsigned live = 0;  // bit t % 32: tile t has a valid index, so it is gathered and multiplied
  auto set_live = [&](int t, bool any) {
    live = (live & ~(1u << (t % 32))) | (static_cast<unsigned>(any) << (t % 32));
  };

  // prologue: tiles 0 .. DW_STAGES - 2 in flight, tile DW_STAGES - 1's map
  // stashed (its barrier comes at the top of the loop), the next in v
  for (int t = 0; t < DW_STAGES - 1; ++t) {
    fetch(t);
    set_live(t, __syncthreads_or(stash(t)));  // (publishes piece_s on the first)
    if (live >> (t % 32) & 1) issue(t);
    tc::cp_async_commit();
  }
  fetch(DW_STAGES - 1);
  bool any = stash(DW_STAGES - 1);
  fetch(DW_STAGES);

  float acc[MT][N / 8][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int t_new = t + DW_STAGES - 1;
    tc::cp_async_wait<DW_STAGES - 2>();
    // tile t is in; every warp is done with tile t - 1's stage, which
    // tile t_new takes; t_new's stashed map is published
    set_live(t_new, __syncthreads_or(any));
    if (live >> (t_new % 32) & 1) issue(t_new);
    tc::cp_async_commit();  // an empty group for a skipped tile keeps the count
    if (live >> (t % 32) & 1) {
      const bf16* xs = stages + (t % DW_STAGES) * DW_STAGE;
      const bf16* gs = xs + BR * DXS;
#pragma unroll
      for (int kk = 0; kk < BR; kk += 16) {
        unsigned b[N / 16][4];
#pragma unroll
        for (int n = 0; n < N / 16; ++n)
          tc::ldsm_x4_trans(b[n], gs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * N_STRIDE +
                                      n * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (mt0 + i >= m_tiles) break;
          unsigned a[4];
          tc::ldsm_x4_trans(a, xs + (kk + lane % 8 + (lane / 16) * 8) * DXS + (mt0 + i) * 16 +
                                   ((lane / 8) % 2) * 8);
#pragma unroll
          for (int n = 0; n < N / 16; ++n) {
            tc::mma_bf16(acc[i][2 * n], a, b[n][0], b[n][1]);
            tc::mma_bf16(acc[i][2 * n + 1], a, b[n][2], b[n][3]);
          }
        }
      }
    }
    // tile t + DW_STAGES takes tile t's map slot, read by nobody since
    // tile t was issued; its loads were in flight over this tile's MMAs
    any = stash(t + DW_STAGES);
    fetch(t + DW_STAGES + 1);
  }
  tc::cp_async_wait<0>();

  float* dst = partial + static_cast<long long>(blockIdx.x) * K * cin * cout + col0 +
               (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = j0 + (mt0 + i) * 16 + lane / 4 + h * 8;
      const int k = m / cp;
      const int c = m - k * cp;
      if (k >= K || c >= cin) continue;
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
        tc::store2<float>(dst + static_cast<long long>(k * cin + c) * cout + n * 8,
                          acc[i][n][2 * h], acc[i][n][2 * h + 1]);
    }
}

// stem_wide_dw_kernel over a (splits, cout / NB, depth_blocks(cin)) grid,
// then the fixed-order sum into dw [27, cin, cout].
template <int NB>
cudaError_t launch_dw_n(const void* x, const void* g, const void* nbr, void* partial, void* dw,
                        long long rows, int cin, int cout, int splits, cudaStream_t stream) {
  auto kernel = stem_wide_dw_kernel<NB>;
  static std::atomic<int> smem_set{0};
  cudaError_t err = tc::reserve_smem(kernel, smem_set, dw_smem<NB>());
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + BR - 1) / BR;
  const long long rows_per_split = (tiles + splits - 1) / splits * BR;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(cout / NB),
                  static_cast<unsigned>(depth_blocks(cin)));
  kernel<<<grid, DW_THREADS, dw_smem<NB>(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const int*>(nbr),
      static_cast<float*>(partial), rows, cin, cout, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, dw, static_cast<long long>(K) * cin * cout, splits, stream);
}

// K3 at any cout that is a multiple of 16: blocks of block_n(cout) columns.
inline cudaError_t launch_dw(const void* x, const void* g, const void* nbr, void* partial, void* dw,
                             long long rows, int cin, int cout, int splits, cudaStream_t stream) {
  if (cout % 16 != 0) return cudaErrorInvalidValue;
  if (block_n(cout) == 32)
    return launch_dw_n<32>(x, g, nbr, partial, dw, rows, cin, cout, splits, stream);
  return launch_dw_n<16>(x, g, nbr, partial, dw, rows, cin, cout, splits, stream);
}

}  // namespace stem
}  // namespace irsc
