// Masked BatchNorm of the sparse encoders' train path, fused with the op
// that follows it (a ReLU, or the residual add and a ReLU), for sm_90a.
//
//   forward    y  = relu((x - mean) * scale + beta [+ r])       every row
//              scale = gamma * rsqrt(var + eps), mean and the biased var
//              over the rows where mask is set (all rows for no mask)
//   backward   g  = dy * [y > 0]
//              dbeta = sum g,  dgamma = sum g * xh,  xh = (x - mean) * rsqrt(var + eps)
//              dx = scale * (g - m * (dbeta / n + xh * dgamma / n)),  m the row mask
//              dr = g                                    (the residual's gradient)
//
// dbeta and dgamma sum over every row: every row's output depends on the
// batch statistics, which is what autograd of the unfused expression
// (models/basic_blocks.MaskedBatchNorm._normalize) computes.  The xh term
// drops where E[x^2] - mean^2 came out negative and was clamped to 0, as
// the clamp's gradient does.
//
// Replaces no TPU kernel: in the JAX package XLA fuses this chain
// (instancerefer_tpu/models/basic_blocks.py MaskedBatchNorm and the ReLU
// and residual add after it).  Unfused on the card it was a dozen PyTorch
// passes a layer each way (casts, a multiply and a column reduce per
// moment, three elementwise passes, the ReLU, the add) and autograd's as
// many again.
//
// What bounds it on the card: bytes.  In bf16 the forward reads x for the
// sums, then reads x and writes y (6 bytes an element); the backward reads
// dy, y and x for the sums, then again for dx, and writes dx (14 bytes);
// the residual sites read r and write dr (4 more).  The design: every
// pass moves 16-byte vectors (8 bf16 or 4 f32 channels a thread); the
// stats pass reads x only at masked rows; the second read of each pass
// comes from L2 where the stage fits its 50 MB; each sum is a fixed-order
// two-level reduction (registers and shared memory in a block, then one
// block of masked_bn_finalize_kernel / masked_bn_total_kernel over the
// blocks' partials in block order), with no float atomics, so a step's
// statistics and gradients repeat bit for bit.  The reduction grids are a
// function of the rows, the width and the card's SM count alone.
//
// Kernels (the ops/masked_bn.py wrapper launches them on its stream):
//   masked_bn_stats_kernel       partials [blocks, 2C + 1]: sum x, sum x^2, n
//   masked_bn_total_kernel       fixed-order sum of partials of any width
//   masked_bn_finalize_kernel    the same sum, then scale, mean, 1 / std, the
//                                clamp flag and n into stat [4C + 1], and the
//                                running statistics (momentum read from the
//                                device, so a captured graph follows it)
//   masked_bn_apply_kernel       y over every row
//   masked_bn_bwd_reduce_kernel  partials [blocks, 2C]: sum g, sum g * xh
//   masked_bn_bwd_apply_kernel   dx (and dr) over every row
// Under data parallelism the wrapper all-reduces the totals between the
// passes, so each rank normalizes and differentiates over the union.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for an unsupported shape.
// dtype codes: 0 float32, 1 bfloat16.  x, r, y, dy, dx and dr are [N, C]
// row-major, 16-byte aligned, C one of WIDTHS (InstanceRefer's encoders:
// 32, 64, 128; PointGroup's U-Net: 16 to 112 and the tails' 2C up to 192);
// mask is one byte a row or null.
//
// A row is C / V threads' 16-byte vectors (V channels a vector).  Where
// that does not divide the block (48, 80, 96, 112, 160, 192 channels), the
// block's last THREADS % (C / V) threads take no rows.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace irbn {

constexpr int THREADS = 256;  // a block
constexpr int FWD_UNROLL = 4;  // 16-byte loads a thread keeps in flight, forward
constexpr int BWD_UNROLL = 2;  // the same, backward (three streams each)

template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&v)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&v)[N]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(void* p, const uint4& u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// The block's per-thread sums of two per-channel quantities (a[V], b[V] of
// channel group `lane` in row slot `slot`), and of one count a row slot
// (count_slot, or none), added over the slots in slot order and written
// to part[0 : 2C (+1)].
template <int C, int V>
__device__ __forceinline__ void block_sums(const float (&a)[V], const float (&b)[V], float count,
                                           bool with_count, float* __restrict__ part) {
  constexpr int TPR = C / V;
  constexpr int SLOTS = THREADS / TPR;
  __shared__ float red[2][SLOTS][C];
  __shared__ float cnt[SLOTS];
  const int lane = threadIdx.x % TPR;
  const int slot = threadIdx.x / TPR;
  if (slot < SLOTS) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[0][slot][lane * V + i] = a[i];
      red[1][slot][lane * V + i] = b[i];
    }
    if (lane == 0) cnt[slot] = count;
  }
  __syncthreads();
  const int width = 2 * C + (with_count ? 1 : 0);
  for (int j = threadIdx.x; j < width; j += THREADS) {
    float s = 0.f;
    if (j < 2 * C) {
      const int which = j / C, ch = j % C;
#pragma unroll 8
      for (int k = 0; k < SLOTS; ++k) s += red[which][k][ch];
    } else {
#pragma unroll 8
      for (int k = 0; k < SLOTS; ++k) s += cnt[k];
    }
    part[j] = s;
  }
}

// Forward, first pass: sum x and sum x^2 a channel, and the row count,
// over the masked rows; one partial row a block.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
masked_bn_stats_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                       long long n_rows, float* __restrict__ part) {
  constexpr int V = Pack<T>::N;
  constexpr int TPR = C / V;
  constexpr int RPI = THREADS / TPR;  // rows a block covers in one sweep
  constexpr int RPB = RPI * FWD_UNROLL;
  const int lane = threadIdx.x % TPR;
  const int slot = threadIdx.x / TPR;
  const bool active = slot < RPI;
  float s[V], q[V], n = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  for (long long base = (long long)blockIdx.x * RPB; base < n_rows;
       base += (long long)gridDim.x * RPB) {
    bool on[FWD_UNROLL];
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      const long long r = base + u * RPI + slot;
      on[u] = active && r < n_rows && (mask == nullptr || mask[r] != 0);
    }
    uint4 raw[FWD_UNROLL];
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      const long long r = base + u * RPI + slot;
      raw[u] = on[u] ? load16(x + r * C + lane * V) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      float v[V];
      Pack<T>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
      n += on[u] ? 1.f : 0.f;
    }
  }
  block_sums<C, V>(s, q, n, true, part + (long long)blockIdx.x * (2 * C + 1));
}

// Column sums of part [nb, width] in block order: four interleaved chains
// joined in a fixed order.
__device__ __forceinline__ float column_total(const float* __restrict__ part, int nb, int width,
                                              int j) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int b = 0;
  for (; b + 4 <= nb; b += 4) {
    a0 += part[(long long)b * width + j];
    a1 += part[(long long)(b + 1) * width + j];
    a2 += part[(long long)(b + 2) * width + j];
    a3 += part[(long long)(b + 3) * width + j];
  }
  for (; b < nb; ++b) a0 += part[(long long)b * width + j];
  return (a0 + a1) + (a2 + a3);
}

// out0[j] for j < split, out1[j - split] for the rest, of part's column sums.
__global__ void __launch_bounds__(THREADS)
masked_bn_total_kernel(const float* __restrict__ part, int nb, int width, int split,
                       float* __restrict__ out0, float* __restrict__ out1) {
  for (int j = threadIdx.x; j < width; j += THREADS) {
    const float t = column_total(part, nb, width, j);
    if (j < split)
      out0[j] = t;
    else
      out1[j - split] = t;
  }
}

// The statistics from the partials [nb, 2C + 1] (nb = 1 for totals already
// summed): stat = [scale C | mean C | 1 / std C | clamp flag C | n], and the
// running statistics, as MaskedBatchNorm._normalize updates them.
template <int C>
__global__ void __launch_bounds__(THREADS)
masked_bn_finalize_kernel(const float* __restrict__ part, int nb,
                          const float* __restrict__ weight, float* __restrict__ running_mean,
                          float* __restrict__ running_var, const float* __restrict__ momentum,
                          float eps, float* __restrict__ stat) {
  constexpr int W = 2 * C + 1;
  __shared__ float tot[W];
  for (int j = threadIdx.x; j < W; j += THREADS) tot[j] = column_total(part, nb, W, j);
  __syncthreads();
  const float n = fmaxf(tot[2 * C], 1.f);
  const float m = *momentum;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float mean = tot[c] / n;
    const float var_raw = tot[C + c] / n - mean * mean;
    const float var = fmaxf(var_raw, 0.f);
    const float inv = rsqrtf(var + eps);
    stat[c] = inv * weight[c];
    stat[C + c] = mean;
    stat[2 * C + c] = inv;
    stat[3 * C + c] = var_raw >= 0.f ? 1.f : 0.f;
    const float unbiased = var * n / fmaxf(n - 1.f, 1.f);
    running_mean[c] = (1.f - m) * running_mean[c] + m * mean;
    running_var[c] = (1.f - m) * running_var[c] + m * unbiased;
  }
  if (threadIdx.x == 0) stat[4 * C] = n;
}

// Forward, second pass: y over every row, the residual added in f32 before
// the one rounding.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
masked_bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const float* __restrict__ stat, const float* __restrict__ bias,
                       long long n_rows, T* __restrict__ y) {
  constexpr int V = Pack<T>::N;
  constexpr int TPR = C / V;
  constexpr int ACTIVE = THREADS / TPR * TPR;  // threads of a block that take vectors
  if (threadIdx.x >= ACTIVE) return;
  const long long nvec = n_rows * TPR;
  const long long stride = (long long)gridDim.x * ACTIVE;
  const long long first = (long long)blockIdx.x * ACTIVE + threadIdx.x;
  const int lane = (int)(first % TPR);  // stride is a multiple of TPR
  float sc[V], mu[V], be[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane * V + i;
    sc[i] = stat[c];
    mu[i] = stat[C + c];
    be[i] = bias[c];
  }
  for (long long base = first; base < nvec; base += stride * FWD_UNROLL) {
    uint4 xr[FWD_UNROLL], rr[FWD_UNROLL];
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      const long long i = base + u * stride;
      xr[u] = i < nvec ? load16(x + i * V) : make_uint4(0, 0, 0, 0);
      rr[u] = (res != nullptr && i < nvec) ? load16(res + i * V) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      const long long i = base + u * stride;
      if (i >= nvec) continue;
      float v[V], r[V];
      Pack<T>::unpack(xr[u], v);
      Pack<T>::unpack(rr[u], r);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float o = (v[k] - mu[k]) * sc[k] + be[k];
        if (res != nullptr) o += r[k];
        v[k] = fmaxf(o, 0.f);
      }
      store16(y + i * V, Pack<T>::pack(v));
    }
  }
}

// Backward, first pass: sum g and sum g * xh a channel over every row.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
masked_bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                            const T* __restrict__ x, const float* __restrict__ stat,
                            long long n_rows, float* __restrict__ part) {
  constexpr int V = Pack<T>::N;
  constexpr int TPR = C / V;
  constexpr int RPI = THREADS / TPR;
  constexpr int RPB = RPI * BWD_UNROLL;
  const int lane = threadIdx.x % TPR;
  const int slot = threadIdx.x / TPR;
  const bool active = slot < RPI;
  float mu[V], is[V], sg[V], sgx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = stat[C + lane * V + i];
    is[i] = stat[2 * C + lane * V + i];
    sg[i] = sgx[i] = 0.f;
  }
  for (long long base = (long long)blockIdx.x * RPB; base < n_rows;
       base += (long long)gridDim.x * RPB) {
    uint4 dr[BWD_UNROLL], yr[BWD_UNROLL], xr[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const long long r = base + u * RPI + slot;
      const long long off = r * C + lane * V;
      const bool in = active && r < n_rows;
      dr[u] = in ? load16(dy + off) : make_uint4(0, 0, 0, 0);
      yr[u] = in ? load16(y + off) : make_uint4(0, 0, 0, 0);
      xr[u] = in ? load16(x + off) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      float d[V], yv[V], xv[V];
      Pack<T>::unpack(dr[u], d);
      Pack<T>::unpack(yr[u], yv);
      Pack<T>::unpack(xr[u], xv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float g = yv[i] > 0.f ? d[i] : 0.f;
        sg[i] += g;
        sgx[i] += g * ((xv[i] - mu[i]) * is[i]);
      }
    }
  }
  block_sums<C, V>(sg, sgx, 0.f, false, part + (long long)blockIdx.x * (2 * C));
}

// Backward, second pass: dx (and the residual's gradient dres = g) over
// every row; sg and sgx are the totals of sum g and sum g * xh.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
masked_bn_bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                           const T* __restrict__ x, const uint8_t* __restrict__ mask,
                           const float* __restrict__ stat, const float* __restrict__ sg,
                           const float* __restrict__ sgx, long long n_rows,
                           T* __restrict__ dx, T* __restrict__ dres) {
  constexpr int V = Pack<T>::N;
  constexpr int TPR = C / V;
  constexpr int ACTIVE = THREADS / TPR * TPR;  // threads of a block that take vectors
  if (threadIdx.x >= ACTIVE) return;
  const long long nvec = n_rows * TPR;
  const long long stride = (long long)gridDim.x * ACTIVE;
  const long long first = (long long)blockIdx.x * ACTIVE + threadIdx.x;
  const int lane = (int)(first % TPR);
  const float n = stat[4 * C];
  float sc[V], mu[V], is[V], a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane * V + i;
    sc[i] = stat[c];
    mu[i] = stat[C + c];
    is[i] = stat[2 * C + c];
    a[i] = sg[c] / n;
    b[i] = sgx[c] / n * stat[3 * C + c];
  }
  for (long long base = first; base < nvec; base += stride * BWD_UNROLL) {
    uint4 dr[BWD_UNROLL], yr[BWD_UNROLL], xr[BWD_UNROLL];
    bool on[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const long long i = base + u * stride;
      const bool in = i < nvec;
      on[u] = in && (mask == nullptr || mask[i / TPR] != 0);
      dr[u] = in ? load16(dy + i * V) : make_uint4(0, 0, 0, 0);
      yr[u] = in ? load16(y + i * V) : make_uint4(0, 0, 0, 0);
      xr[u] = in ? load16(x + i * V) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const long long i = base + u * stride;
      if (i >= nvec) continue;
      float d[V], yv[V], xv[V], o[V];
      Pack<T>::unpack(dr[u], d);
      Pack<T>::unpack(yr[u], yv);
      Pack<T>::unpack(xr[u], xv);
      const float m = on[u] ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float g = yv[k] > 0.f ? d[k] : 0.f;
        const float xh = (xv[k] - mu[k]) * is[k];
        o[k] = sc[k] * (g - m * (a[k] + xh * b[k]));
        d[k] = g;
      }
      store16(dx + i * V, Pack<T>::pack(o));
      if (dres != nullptr) store16(dres + i * V, Pack<T>::pack(d));
    }
  }
}

// The widths the kernels are built for (ops/masked_bn.CHANNELS).
#define IRBN_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(160) X(192)

bool width_ok(int c) {
#define IRBN_IS(W) if (c == W) return true;
  IRBN_WIDTHS(IRBN_IS)
#undef IRBN_IS
  return false;
}

bool bad(long long n_rows, int c, int dtype, int blocks) {
  return n_rows < 0 || !width_ok(c) || (dtype != 0 && dtype != 1) || blocks <= 0;
}

template <typename T, typename F>
void dispatch_width(int c, F&& f) {
#define IRBN_CALL(W) \
  if (c == W) return f(T{}, std::integral_constant<int, W>{});
  IRBN_WIDTHS(IRBN_CALL)
#undef IRBN_CALL
}

// f(T{}, std::integral_constant<int, C>{}) for the element type of dtype
// and the width c (both checked by bad()).
template <typename F>
void dispatch(int dtype, int c, F&& f) {
  if (dtype == 1)
    dispatch_width<__nv_bfloat16>(c, f);
  else
    dispatch_width<float>(c, f);
}

}  // namespace irbn

extern "C" int ir_masked_bn_stats(const void* x, const void* mask, void* part, long long n_rows,
                                  int c, int dtype, int blocks, void* stream) {
  if (irbn::bad(n_rows, c, dtype, blocks)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  irbn::dispatch(dtype, c, [&](auto t, auto width) {
    using T = decltype(t);
    constexpr int C = decltype(width)::value;
    irbn::masked_bn_stats_kernel<T, C><<<blocks, irbn::THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(mask), n_rows,
        static_cast<float*>(part));
  });
  return cudaGetLastError();
}

extern "C" int ir_masked_bn_total(const void* part, void* out0, void* out1, int nb, int width,
                                  int split, void* stream) {
  if (nb <= 0 || width <= 0 || split < 0 || split > width) return cudaErrorInvalidValue;
  irbn::masked_bn_total_kernel<<<1, irbn::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), nb, width, split, static_cast<float*>(out0),
      static_cast<float*>(out1));
  return cudaGetLastError();
}

extern "C" int ir_masked_bn_finalize(const void* part, const void* weight, void* running_mean,
                                     void* running_var, const void* momentum, void* stat, int nb,
                                     int c, float eps, void* stream) {
  if (irbn::bad(0, c, 0, nb)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  irbn::dispatch(0, c, [&](auto, auto width) {
    constexpr int C = decltype(width)::value;
    irbn::masked_bn_finalize_kernel<C><<<1, irbn::THREADS, 0, s>>>(
        static_cast<const float*>(part), nb, static_cast<const float*>(weight),
        static_cast<float*>(running_mean), static_cast<float*>(running_var),
        static_cast<const float*>(momentum), eps, static_cast<float*>(stat));
  });
  return cudaGetLastError();
}

extern "C" int ir_masked_bn_apply(const void* x, const void* res, const void* stat,
                                  const void* bias, void* y, long long n_rows, int c, int dtype,
                                  int blocks, void* stream) {
  if (irbn::bad(n_rows, c, dtype, blocks)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  irbn::dispatch(dtype, c, [&](auto t, auto width) {
    using T = decltype(t);
    constexpr int C = decltype(width)::value;
    irbn::masked_bn_apply_kernel<T, C><<<blocks, irbn::THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(stat),
        static_cast<const float*>(bias), n_rows, static_cast<T*>(y));
  });
  return cudaGetLastError();
}

extern "C" int ir_masked_bn_bwd_reduce(const void* dy, const void* y, const void* x,
                                       const void* stat, void* part, long long n_rows, int c,
                                       int dtype, int blocks, void* stream) {
  if (irbn::bad(n_rows, c, dtype, blocks)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  irbn::dispatch(dtype, c, [&](auto t, auto width) {
    using T = decltype(t);
    constexpr int C = decltype(width)::value;
    irbn::masked_bn_bwd_reduce_kernel<T, C><<<blocks, irbn::THREADS, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(y), static_cast<const T*>(x),
        static_cast<const float*>(stat), n_rows, static_cast<float*>(part));
  });
  return cudaGetLastError();
}

extern "C" int ir_masked_bn_bwd_apply(const void* dy, const void* y, const void* x,
                                      const void* mask, const void* stat, const void* sg,
                                      const void* sgx, void* dx, void* dres, long long n_rows,
                                      int c, int dtype, int blocks, void* stream) {
  if (irbn::bad(n_rows, c, dtype, blocks)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  irbn::dispatch(dtype, c, [&](auto t, auto width) {
    using T = decltype(t);
    constexpr int C = decltype(width)::value;
    irbn::masked_bn_bwd_apply_kernel<T, C><<<blocks, irbn::THREADS, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(y), static_cast<const T*>(x),
        static_cast<const uint8_t*>(mask), static_cast<const float*>(stat),
        static_cast<const float*>(sg), static_cast<const float*>(sgx), n_rows,
        static_cast<T*>(dx), static_cast<T*>(dres));
  });
  return cudaGetLastError();
}
