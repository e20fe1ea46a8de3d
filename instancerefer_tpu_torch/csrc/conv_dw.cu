// K3: sparse-conv weight gradient, for sm_90a.
//
//   dW[k] = sum_v feats[nbr[v, k]]^T g[v]        [K, Cin, Cout], f32
//
// Replaces the TPU kernel instancerefer_tpu/ops/pallas_conv.py:_dw_kernel
// (called through windowed_conv_dw).  That kernel walks the row chunks in
// order on one core, gathers feats by one-hot matmuls over per-offset bands
// and carries dW across the grid in VMEM.  Here the gather is exact, and
// the sum over rows, which on the card spans blocks that run in no order,
// is a deterministic split reduction: each block keeps its product in
// registers and writes its own partial; irsc::sum_partials_kernel adds the
// partials in a fixed order.  No float atomics, so two launches on the
// same inputs give bit-identical dW.
//
// Call sites: the 2^3 stride-2 down convs' dW (over down, K = 8, 32 -> 64,
// 64 -> 128, 128 -> 128) and the stems' dW-only backward (over nbr3,
// K = 27, Cin -> 32 with Cin 7, 10 or 135).  Three routes, chosen by the
// wrapper (ops/conv_bwd.py) from the input type and Cin alone, as K1's:
//
//   ir_conv_dw_tc    bf16 with Cin in {32, 64, 128} (the downs): the list
//     pass below, then irsc::tc::dw_list_tc_kernel (sparse_conv_tc.cuh).
//     The list pass compacts each column k of the map into the rows v with
//     nbr[v, k] >= 0, ascending, and their count; block (k, split) of the
//     dW kernel takes a contiguous range of list k, gathers x[nbr[v, k]]
//     and g[v] with 16-byte cp.async in a ring, and accumulates x^T g with
//     mma.sync.m16n8k16 from ldmatrix.trans.
//   ir_conv_dw_stem_wide  bf16 at any other Cin (the stems: 7, 10, 135):
//     irsc::stem::stem_wide_dw_kernel (sparse_conv_stem.cuh), one product
//     cols^T g over the rows' im2col, each neighbour's row zero-padded to
//     16 bytes, the depth in blocks of 768 columns on the grid (48
//     accumulators a thread, 16 warps), so g and the map are read once per
//     block; 64-row tiles gathered by 16-byte cp.async in a ring of 2.
//   ir_conv_dw       f32: the FMA template irsc::dw_partial_kernel
//     (sparse_conv.cuh) over a (K, split, Cin tile of 128) grid.
//
// What bounds it on the card.  The downs: the rows staged into shared
// memory, and the gathers' latency.  A down map is the inverse of up8: an
// input row has at most one (parent, offset), so 10-43% of the map's
// entries are valid at B = 64.  The kernel this replaced walked every
// output row once per offset, staging g 8 times over and a zero x row for
// every -1 entry (914 MB over a train step's 8 downs at B = 64); over the
// lists only valid pairs are staged (367 MB), every tile is full but a
// list's last, and each split gets the same number of entries whatever
// the map's fill.  The lists cost one read of the map in each of the two
// list kernels and one int32 write a valid entry.  The stems: the gather.
// The FMA kernel this replaced read its split's g rows once per offset (27
// passes) and gathered x with scalar loads into f32 tiles.  Here g and the
// map are read once per 768 depth columns (5 times at Cin 135, once at 7
// and 10), and the 16-byte gathers of x, 27 x 272 bytes a row at Cin 135
// (4.3 GB from L2 at the scene stem), bound it.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for an unsupported shape.

#include <cstdint>

#include "sparse_conv.cuh"
#include "sparse_conv_stem.cuh"
#include "sparse_conv_tc.cuh"

namespace irsc {
namespace lists {

// ---------------------------------------------------------------------------
// The list pass: for each offset k of an 8-offset map (the downs'),
// lists[k, :counts[k]] = the rows v with nbr[v, k] >= 0, ascending.  Two
// kernels over chunks of CHUNK rows:
//
//   dw_list_count_kernel  chunk_counts[c, k] = valid entries of column k in chunk c
//   dw_list_write_kernel  each chunk's entries at their place in each list:
//                         the entries of the chunks before it (a fixed-order
//                         sum of their counts), then of the warps before
//                         this one in the chunk, then of the lanes before
//                         this one in each 32-row ballot
//
// The order is a function of the map alone (no atomics), so the dW sums in
// one order.  Each warp takes CHUNK / WARPS consecutive rows, 32 a ballot:
// lane l holds row r's 8 entries from two 16-byte loads, all of a warp's
// loads in flight together, and the ballot of offset k reads its register.
// The write kernel issues its rows' loads with those of the earlier chunks'
// counts, and the last chunk's block writes counts[k].
//
// Workspace (int32, ops/conv_bwd.dw_list_workspace sizes it; work_ints
// here): lists [K, v_out], counts [K], chunk_counts [n_chunks, K].
// ---------------------------------------------------------------------------
constexpr int K = 8;                       // offsets of a down map
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 1024;                // rows a block
constexpr int WARP_ROWS = CHUNK / WARPS;   // consecutive rows a warp
constexpr int STEPS = WARP_ROWS / 32;      // ballots a warp an offset

inline long long n_chunks(long long v_out) { return (v_out + CHUNK - 1) / CHUNK; }
inline long long work_ints(long long v_out) { return K * (v_out + 1 + n_chunks(v_out)); }

// This warp's rows of chunk c, lane l's row in lo[i], hi[i] (row c CHUNK +
// WARP_ROWS warp + 32 i + l; rows past v_out read as empty).
struct Rows {
  int4 lo[STEPS], hi[STEPS];
};
__device__ __forceinline__ Rows load_rows(const int* __restrict__ nbr, long long v_out,
                                          long long c, int warp, int lane) {
  Rows rows;
  const long long r0 = c * CHUNK + warp * WARP_ROWS + lane;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const long long r = r0 + i * 32;
    rows.lo[i] = rows.hi[i] = make_int4(-1, -1, -1, -1);
    if (r < v_out) {
      const int4* row = reinterpret_cast<const int4*>(nbr + r * K);
      rows.lo[i] = __ldg(row);
      rows.hi[i] = __ldg(row + 1);
    }
  }
  return rows;
}

// their ballots: bit l of bits[k][i] is whether that row's entry at offset
// k is valid
__device__ __forceinline__ void row_ballots(const Rows& rows, unsigned (&bits)[K][STEPS]) {
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int4 lo = rows.lo[i], hi = rows.hi[i];
    const int e[K] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < K; ++k) bits[k][i] = __ballot_sync(0xffffffffu, e[k] >= 0);
  }
}

// warp_n[k][warp] = this warp's valid entries at offset k
__device__ __forceinline__ void warp_counts(const unsigned (&bits)[K][STEPS], int warp, int lane,
                                            int (&warp_n)[K][WARPS]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) n += __popc(bits[k][i]);
    if (lane == 0) warp_n[k][warp] = n;
  }
}

__global__ void __launch_bounds__(THREADS)
dw_list_count_kernel(const int* __restrict__ nbr, int* __restrict__ chunk_counts, long long v_out) {
  __shared__ int warp_n[K][WARPS];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long c = blockIdx.x;
  unsigned bits[K][STEPS];
  row_ballots(load_rows(nbr, v_out, c, warp, lane), bits);
  warp_counts(bits, warp, lane, warp_n);
  __syncthreads();
  if (threadIdx.x < K) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) n += warp_n[threadIdx.x][w];
    chunk_counts[c * K + threadIdx.x] = n;
  }
}

__global__ void __launch_bounds__(THREADS)
dw_list_write_kernel(const int* __restrict__ nbr, const int* __restrict__ chunk_counts,
                     int* __restrict__ lists, int* __restrict__ counts, long long v_out) {
  __shared__ int warp_n[K][WARPS];  // this chunk's entries of each warp, then where they start
  __shared__ int sum_s[WARPS][K];   // the earlier chunks' counts, a warp's partial sums
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long c = blockIdx.x;
  const Rows rows = load_rows(nbr, v_out, c, warp, lane);

  // the counts of the chunks before this one (chunk_counts [c][K]), summed
  // in a fixed order: thread t reads columns (t % 2) * 4 .. + 3 of chunks
  // t / 2, t / 2 + THREADS / 2, ..., 16 bytes a load, in ascending order;
  // the lanes of one parity meet by a fixed shuffle tree, the warps below
  int s[4] = {0, 0, 0, 0};
  const int4* cc = reinterpret_cast<const int4*>(chunk_counts);
#pragma unroll 4
  for (long long j = threadIdx.x; j < 2 * c; j += THREADS) {
    const int4 q = __ldg(cc + j);
    s[0] += q.x;
    s[1] += q.y;
    s[2] += q.z;
    s[3] += q.w;
  }
#pragma unroll
  for (int o = 2; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
  if (lane < 2)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum_s[warp][lane * 4 + j] = s[j];

  unsigned bits[K][STEPS];
  row_ballots(rows, bits);
  warp_counts(bits, warp, lane, warp_n);
  __syncthreads();
  // where each warp's entries of each column start: the chunk's place (the
  // warps' partial sums in order), then the warps before it in order; the
  // last chunk's block writes the counts
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    int pos = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) pos += sum_s[w][k];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int n = warp_n[k][w];
      warp_n[k][w] = pos;
      pos += n;
    }
    if (c == gridDim.x - 1) counts[k] = pos;
  }
  __syncthreads();
  const long long r0 = c * CHUNK + warp * WARP_ROWS;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int pos = warp_n[k][warp];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const unsigned b = bits[k][i];
      if ((b >> lane) & 1u)
        lists[k * v_out + pos + __popc(b & ((1u << lane) - 1u))] =
            static_cast<int>(r0 + i * 32 + lane);
      pos += __popc(b);
    }
  }
}

// The list pass of nbr [v_out, K] into work (see above).
cudaError_t launch_lists(const int* nbr, int* work, long long v_out, cudaStream_t stream) {
  int* lists = work;
  int* counts = lists + K * v_out;
  int* chunk_counts = counts + K;
  const unsigned grid = static_cast<unsigned>(n_chunks(v_out));
  dw_list_count_kernel<<<grid, THREADS, 0, stream>>>(nbr, chunk_counts, v_out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_list_write_kernel<<<grid, THREADS, 0, stream>>>(nbr, chunk_counts, lists, counts, v_out);
  return cudaGetLastError();
}

}  // namespace lists
}  // namespace irsc

namespace {

bool bad_shape(long long v_out, int k_offsets, int cin, int splits) {
  return v_out <= 0 || k_offsets <= 0 || cin <= 0 || splits <= 0 || splits > 65535;
}

bool bad_lists(const void* nbr, long long v_out, int k_offsets) {
  return reinterpret_cast<uintptr_t>(nbr) % 16 != 0 || v_out <= 0 || v_out > 0x7fffffffLL ||
         k_offsets != irsc::lists::K;
}

// K3's dW on tensor cores over the lists in work: cin and cout each one of
// 32, 64, 128 (instantiated here only, the one library that launches it).
cudaError_t dispatch_dw_tc(const void* x, const void* g, const void* nbr, int* work,
                           void* partial, void* dw, long long rows, int k_offsets, int cin,
                           int cout, int splits, cudaStream_t stream) {
  const int* lists = work;
  const int* counts = work + static_cast<long long>(k_offsets) * rows;
#define IRSC_DW_TC(CI, CO)                                                                    \
  return irsc::tc::launch_dw_list_tc<CI, CO>(x, g, nbr, lists, counts, partial, dw, rows,    \
                                             k_offsets, splits, stream)
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

bool tc_width(int c) { return c == 32 || c == 64 || c == 128; }

}  // namespace

// The FMA route: float32 feats and g (dtype code 0; bf16 always takes one
// of the tensor-core routes below).  partial is f32 scratch of splits * K *
// cin * cout; dw is f32 [K, cin, cout].
extern "C" int ir_conv_dw(const void* feats, const void* nbr, const void* g, void* partial,
                          void* dw, long long v_out, int k_offsets, int cin, int cout,
                          int splits, int dtype, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits) || dtype != 0) return cudaErrorInvalidValue;
  return irsc::dispatch_dw<float, true>(feats, g, nbr, partial, dw, v_out, k_offsets, cin, cout,
                                        splits, static_cast<cudaStream_t>(stream));
}

// The tensor-core route (the downs): bfloat16 feats and g and the int32
// map nbr of 8 offsets (all 16-byte aligned), cin and cout each one of 32,
// 64, 128; work is int32 scratch of ir_dw_list_work_ints(v_out); the other
// arguments as above.  The list pass, the dW kernel and the sum of the
// splits, in that order.
extern "C" int ir_conv_dw_tc(const void* feats, const void* nbr, const void* g, void* work,
                             void* partial, void* dw, long long v_out, int k_offsets, int cin,
                             int cout, int splits, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits) || bad_lists(nbr, v_out, k_offsets) ||
      !tc_width(cin) || !tc_width(cout))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      irsc::lists::launch_lists(static_cast<const int*>(nbr), static_cast<int*>(work), v_out, s);
  if (err != cudaSuccess) return err;
  return dispatch_dw_tc(feats, g, nbr, static_cast<int*>(work), partial, dw, v_out, k_offsets, cin,
                        cout, splits, s);
}

// The tensor-core route over lists the caller's list pass already wrote
// into work (ops/conv_bwd.down_lists: the down convs' backward runs one
// pass for its dX and its dW): the dW kernel and the sum of the splits.
extern "C" int ir_conv_dw_tc_lists(const void* feats, const void* nbr, const void* g, void* work,
                                   void* partial, void* dw, long long v_out, int k_offsets,
                                   int cin, int cout, int splits, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits) || bad_lists(nbr, v_out, k_offsets) ||
      !tc_width(cin) || !tc_width(cout))
    return cudaErrorInvalidValue;
  return dispatch_dw_tc(feats, g, nbr, static_cast<int*>(work), partial, dw, v_out, k_offsets, cin,
                        cout, splits, static_cast<cudaStream_t>(stream));
}

// The list pass alone (ops/conv_bwd.dw_lists, held against its plain
// version): nbr int32 [v_out, 8], 16-byte aligned, into work as above.
extern "C" int ir_dw_lists(const void* nbr, void* work, long long v_out, int k_offsets,
                           void* stream) {
  if (bad_lists(nbr, v_out, k_offsets)) return cudaErrorInvalidValue;
  return irsc::lists::launch_lists(static_cast<const int*>(nbr), static_cast<int*>(work), v_out,
                                   static_cast<cudaStream_t>(stream));
}

// The list pass's workspace in int32 and the dW kernel's shared memory a
// block: ops/conv_bwd.dw_list_workspace and dw_list_smem_bytes compute the
// same on the host.
extern "C" long long ir_dw_list_work_ints(long long v_out) {
  return irsc::lists::work_ints(v_out);
}
extern "C" long long ir_dw_list_smem_bytes(int cin, int cout) {
  return static_cast<long long>(irsc::tc::dw_list_smem_bytes(cin, cout));
}

// The stem route: bfloat16 feats [V_in, channels(cin)] (cin up to
// MAX_CIN, rows zero-padded to a multiple of 8 channels) and g as above,
// both 16-byte aligned; dw is [27, cin, cout], with no padding rows.
extern "C" int ir_conv_dw_stem_wide(const void* feats, const void* nbr, const void* g,
                                    void* partial, void* dw, long long v_out, int k_offsets,
                                    int cin, int cout, int splits, void* stream) {
  if (bad_shape(v_out, k_offsets, cin, splits) || k_offsets != irsc::stem::K ||
      cin > irsc::stem::MAX_CIN)
    return cudaErrorInvalidValue;
  return irsc::stem::launch_dw(feats, g, nbr, partial, dw, v_out, cin, cout, splits,
                               static_cast<cudaStream_t>(stream));
}
