// Native voxelizer + sparse-conv kernel-map builder of the port's host
// pipeline: a copy of instancerefer_tpu/native/voxelizer.cpp without the TPU
// band metadata (ir_band_starts), the first-occurrence dedup and the ABI
// probe (the port keeps raster row order only, and its loader keys the built
// library by a hash of this file).
//
// Replaces torchsparse's C++ `sparse_quantize` hashing and the CUDA
// kernel-map hash build inside `spnn.Conv3d` (reference
// lib/dataset.py:228-261) with open-addressing hash maps and merge joins on
// the host.  Exposed as a plain C ABI consumed via ctypes
// (instancerefer_tpu_torch/ops/voxelize.py, which builds it with g++ at
// first use); results are bit-identical to the numpy implementation there
// (same first-occurrence semantics, same output ordering).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCoordBits = 14;
constexpr int64_t kCoordOff = 1ll << (kCoordBits - 1);
constexpr int64_t kCoordMask = (1ll << kCoordBits) - 1;
constexpr int64_t kEmpty = -1;

inline int64_t pack(const int32_t* c) {
  int64_t x = c[0] + kCoordOff, y = c[1] + kCoordOff, z = c[2] + kCoordOff;
  x = x < 0 ? 0 : (x > kCoordMask ? kCoordMask : x);
  y = y < 0 ? 0 : (y > kCoordMask ? kCoordMask : y);
  z = z < 0 ? 0 : (z > kCoordMask ? kCoordMask : z);
  return (x << (2 * kCoordBits)) | (y << kCoordBits) | z;
}

inline int64_t pack3(int64_t x, int64_t y, int64_t z) {
  x += kCoordOff; y += kCoordOff; z += kCoordOff;
  x = x < 0 ? 0 : (x > kCoordMask ? kCoordMask : x);
  y = y < 0 ? 0 : (y > kCoordMask ? kCoordMask : y);
  z = z < 0 ? 0 : (z > kCoordMask ? kCoordMask : z);
  return (x << (2 * kCoordBits)) | (y << kCoordBits) | z;
}

// Open-addressing hash map: key int64 -> value int32.
struct HashMap {
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  int64_t mask;

  explicit HashMap(int64_t n) {
    int64_t cap = 16;
    while (cap < n * 2) cap <<= 1;
    keys.assign(cap, kEmpty);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  static inline int64_t hash(int64_t k) {
    uint64_t h = static_cast<uint64_t>(k);
    h ^= h >> 33; h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33; h *= 0xc4ceb9fe1a85ec53ULL;
    h ^= h >> 33;
    return static_cast<int64_t>(h);
  }

  // insert if absent; returns existing or new value
  inline int32_t insert(int64_t k, int32_t v, bool* inserted) {
    int64_t i = hash(k) & mask;
    for (;;) {
      if (keys[i] == kEmpty) {
        keys[i] = k; vals[i] = v; *inserted = true; return v;
      }
      if (keys[i] == k) { *inserted = false; return vals[i]; }
      i = (i + 1) & mask;
    }
  }

  inline int32_t find(int64_t k) const {
    int64_t i = hash(k) & mask;
    for (;;) {
      if (keys[i] == kEmpty) return -1;
      if (keys[i] == k) return vals[i];
      i = (i + 1) & mask;
    }
  }
};

// 3x3x3 kernel offsets, same x-fastest enumeration as
// ops/voxelize.KERNEL_OFFSETS_3 (order decides which weight slice learns
// which offset — must match the Python table).
struct Off3Table {
  int32_t off[27][3];
  Off3Table() {
    int k = 0;
    for (int dz = -1; dz <= 1; ++dz)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx, ++k) {
          off[k][0] = dx; off[k][1] = dy; off[k][2] = dz;
        }
  }
};
const Off3Table kOff3;

// LSD radix sort of (packed key, original row) pairs by the 42-bit key,
// 14 bits per pass.  Stable, so equal keys keep original row order (which
// "first occurrence" relies on); ~3x faster than std::sort at the 40k-row
// scene scale.  Below kRadixMin rows the three 128 KB count-array clears
// dominate (they were most of the instance-pyramid cost: 16 tiny sorts per
// sample each clearing 384 KB), so small inputs take a comparison sort on
// (key, idx) pairs — idx tie-break == stability, keys need not be unique.
constexpr int64_t kRadixMin = 3072;

void radix_sort_by_key(std::vector<int64_t>& keys, std::vector<int32_t>& idx) {
  const int64_t n = static_cast<int64_t>(keys.size());
  if (n < kRadixMin) {
    std::vector<std::pair<int64_t, int32_t>> pairs(n);
    for (int64_t i = 0; i < n; ++i) pairs[i] = {keys[i], idx[i]};
    std::sort(pairs.begin(), pairs.end());
    for (int64_t i = 0; i < n; ++i) {
      keys[i] = pairs[i].first;
      idx[i] = pairs[i].second;
    }
    return;
  }
  std::vector<int64_t> keys2(n);
  std::vector<int32_t> idx2(n);
  std::vector<int64_t> count(1 << kCoordBits);
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass * kCoordBits;
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; ++i)
      ++count[(keys[i] >> shift) & kCoordMask];
    int64_t run = 0;
    for (int64_t b = 0; b <= kCoordMask; ++b) {
      int64_t c = count[b]; count[b] = run; run += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t pos = count[(keys[i] >> shift) & kCoordMask]++;
      keys2[pos] = keys[i]; idx2[pos] = idx[i];
    }
    keys.swap(keys2); idx.swap(idx2);
  }
}

// One stage of a conv pyramid under construction (single group, local rows).
struct PyrStage {
  std::vector<int32_t> coords;  // n x 3
  std::vector<int64_t> keys;    // n packed keys
  std::vector<int32_t> nbr;     // n x 27
  std::vector<int32_t> down;    // n x 8 (empty on stage 0)
  int64_t n = 0;
};

// Every coord at least ``slack`` voxels inside the ±8191 packing boundary —
// packing arithmetic on ±slack-shifted coords cannot clip/alias.
bool coords_in_range(const PyrStage& st, int32_t slack) {
  const int64_t lim = kCoordMask / 2 - slack;
  for (int64_t i = 0; i < st.n; ++i) {
    const int32_t* c = st.coords.data() + 3 * i;
    if (c[0] < -lim || c[0] > lim || c[1] < -lim || c[1] > lim ||
        c[2] < -lim || c[2] > lim)
      return false;
  }
  return true;
}

// True iff keys are strictly ascending AND every coord is far enough from
// the ±8191 packing boundary that a ±stride neighbor query cannot clip —
// the preconditions for the linear merge-join neighbor build.
bool merge_safe(const PyrStage& st, int32_t stride) {
  for (int64_t i = 1; i < st.n; ++i)
    if (st.keys[i] <= st.keys[i - 1]) return false;
  return coords_in_range(st, stride);
}

// Submanifold 3^3 neighbor map.  Raster-sorted coords make each offset's
// query keys "keys + const", so matches come from a linear co-walk of two
// sorted arrays (13 offset pairs, mirrored: c_j = c_i + o  <=>
// c_i = c_j - o), instead of 27n random hash probes — the hash build was
// the single hottest host-pipeline function before this.
void build_nbr_merge(PyrStage& st, int32_t stride) {
  const int64_t n = st.n;
  st.nbr.assign(n * 27, -1);
  for (int64_t i = 0; i < n; ++i) st.nbr[i * 27 + 13] = static_cast<int32_t>(i);
  for (int k = 0; k < 13; ++k) {
    const int64_t delta =
        int64_t(kOff3.off[k][0]) * stride * (1ll << (2 * kCoordBits)) +
        int64_t(kOff3.off[k][1]) * stride * (1ll << kCoordBits) +
        int64_t(kOff3.off[k][2]) * stride;
    int64_t j = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t q = st.keys[i] + delta;
      while (j < n && st.keys[j] < q) ++j;
      if (j >= n) break;
      if (st.keys[j] == q) {
        st.nbr[i * 27 + k] = static_cast<int32_t>(j);
        st.nbr[j * 27 + (26 - k)] = static_cast<int32_t>(i);
      }
    }
  }
}

// Hash fallback (identical semantics to ir_build_nbr) for unsorted or
// boundary-clipped coords.
void build_nbr_hash(PyrStage& st, int32_t stride) {
  const int64_t n = st.n;
  st.nbr.assign(n * 27, -1);
  HashMap map(n);
  bool ins;
  for (int64_t i = 0; i < n; ++i)
    map.insert(st.keys[i], static_cast<int32_t>(i), &ins);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* c = st.coords.data() + 3 * i;
    for (int k = 0; k < 27; ++k) {
      st.nbr[i * 27 + k] = map.find(pack3(
          c[0] + int64_t(kOff3.off[k][0]) * stride,
          c[1] + int64_t(kOff3.off[k][1]) * stride,
          c[2] + int64_t(kOff3.off[k][2]) * stride));
    }
  }
}

void fill_keys(PyrStage& st) {
  st.keys.resize(st.n);
  for (int64_t i = 0; i < st.n; ++i) st.keys[i] = pack(st.coords.data() + 3 * i);
}

// Hash-free stride-2 downsample for the raster path: each input row maps to
// exactly ONE (parent voxel, kernel offset) by pure arithmetic — parent =
// floor(c / (2*stride)) * (2*stride), offset j = (c - parent) / stride per
// axis (x fastest, matching KERNEL_OFFSETS_2) — so one stable sort of the
// parent keys yields the deduped outputs in raster order AND the complete
// down map in a single pass, with zero hash probes (the two hash maps +
// 8 probes/output of the fallback below were the hottest slice of the
// scene-pyramid phase).  Input coords must be unique (stage invariant) and
// in packing range (caller checks coords_in_range).  Identical results to
// downsample_stage with raster=true: same parents, same raster order, same
// down entries.
void downsample_sorted(const PyrStage& prev, int32_t stride, PyrStage& out) {
  const int64_t n = prev.n;
  const int64_t ns = int64_t(stride) * 2;
  std::vector<int64_t> pkeys(n);
  std::vector<int32_t> idx(n);
  std::vector<int32_t> pcoords(3 * n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t* d = pcoords.data() + 3 * i;
    for (int t = 0; t < 3; ++t) {
      int64_t c = prev.coords[3 * i + t];
      int64_t q = (c >= 0) ? (c / ns) : (-(((-c) + ns - 1) / ns));
      d[t] = static_cast<int32_t>(q * ns);
    }
    pkeys[i] = pack(d);
    idx[i] = static_cast<int32_t>(i);
  }
  radix_sort_by_key(pkeys, idx);
  out.coords.clear();
  out.keys.clear();
  out.n = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || pkeys[i] != pkeys[i - 1]) {
      const int32_t* pc = pcoords.data() + 3 * idx[i];
      out.coords.insert(out.coords.end(), pc, pc + 3);
      out.keys.push_back(pkeys[i]);  // ascending == raster order
      ++out.n;
    }
  }
  out.down.assign(out.n * 8, -1);
  int64_t o = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || pkeys[i] != pkeys[i - 1]) ++o;
    const int32_t r = idx[i];
    const int32_t* c = prev.coords.data() + 3 * r;
    const int32_t* pc = out.coords.data() + 3 * o;
    const int32_t j = (c[0] - pc[0]) / stride + 2 * ((c[1] - pc[1]) / stride) +
                      4 * ((c[2] - pc[2]) / stride);
    out.down[o * 8 + j] = r;
  }
}

// Stride-2 downsample of prev into out (ir_downsample semantics: unique
// floor(c / (2*stride)) * (2*stride) in first-occurrence order, then
// raster-sorted when requested; down[o][j] = prev row at out + {0,stride}^3).
void downsample_stage(const PyrStage& prev, int32_t stride, bool raster,
                      PyrStage& out) {
  const int64_t n = prev.n;
  const int64_t ns = int64_t(stride) * 2;
  HashMap in_map(n);
  bool ins;
  for (int64_t i = 0; i < n; ++i)
    in_map.insert(prev.keys[i], static_cast<int32_t>(i), &ins);

  HashMap out_map(n);
  out.coords.clear();
  out.n = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t d[3];
    for (int t = 0; t < 3; ++t) {
      int64_t c = prev.coords[3 * i + t];
      int64_t q = (c >= 0) ? (c / ns) : (-(((-c) + ns - 1) / ns));
      d[t] = static_cast<int32_t>(q * ns);
    }
    out_map.insert(pack(d), static_cast<int32_t>(out.n), &ins);
    if (ins) {
      out.coords.insert(out.coords.end(), d, d + 3);
      ++out.n;
    }
  }
  fill_keys(out);
  if (raster && out.n > 1) {
    // stable sort by packed key (keys are unique post-dedup, so plain
    // pair-sort matches numpy's stable argsort)
    std::vector<int32_t> ord(out.n);
    for (int64_t i = 0; i < out.n; ++i) ord[i] = static_cast<int32_t>(i);
    std::vector<int64_t> k2(out.keys);
    radix_sort_by_key(k2, ord);
    std::vector<int32_t> c2(out.n * 3);
    for (int64_t i = 0; i < out.n; ++i)
      std::memcpy(c2.data() + 3 * i, out.coords.data() + 3 * ord[i],
                  3 * sizeof(int32_t));
    out.coords.swap(c2);
    out.keys.swap(k2);
  }
  out.down.assign(out.n * 8, -1);
  for (int64_t o = 0; o < out.n; ++o) {
    const int32_t* c = out.coords.data() + 3 * o;
    int32_t j = 0;
    for (int dz = 0; dz < 2; ++dz)
      for (int dy = 0; dy < 2; ++dy)
        for (int dx = 0; dx < 2; ++dx, ++j)
          out.down[o * 8 + j] = in_map.find(
              pack3(c[0] + int64_t(dx) * stride, c[1] + int64_t(dy) * stride,
                    c[2] + int64_t(dz) * stride));
  }
}

}  // namespace

extern "C" {

// Unique-by-voxel keeping the first occurrence per voxel, emitted in raster
// (packed-key) order: the fused form of ir_unique_first + the raster argsort
// that ops/voxelize.quantize(raster_order=True) needs.  Radix sort is stable,
// so the first pair of each equal-key run carries the smallest original row.
int64_t ir_unique_raster(const int32_t* coords, int64_t n, int64_t* keep_idx) {
  std::vector<int64_t> keys(n);
  std::vector<int32_t> idx(n);
  for (int64_t i = 0; i < n; ++i) {
    keys[i] = pack(coords + 3 * i);
    idx[i] = static_cast<int32_t>(i);
  }
  radix_sort_by_key(keys, idx);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i)
    if (i == 0 || keys[i] != keys[i - 1]) keep_idx[m++] = idx[i];
  return m;
}

// Fused conv-pyramid build: quantized stage-0 coords for g groups (each
// group's rows contiguous, raster-sorted within the group when raster != 0)
// -> all num_stages stages, groups concatenated per stage, truncated to the
// per-stage caps and padded (coords 0, owner/nbr/down -1) — the single
// native call replacing the per-stage Python round trips of
// ops/voxelize.build_pyramid + concat_stages + pad_stage.  Semantics are
// bit-identical to that numpy chain (tests/test_native_voxelizer.py):
// neighbor/down refs whose MERGED row lands beyond the cap become -1, and
// out_counts[s] reports the pre-truncation merged row count (the caller's
// overflow accounting).  Output stage s occupies rows
// [sum(caps[:s]), sum(caps[:s]) + caps[s]) of every out array.
void ir_pyramid(const int32_t* coords0, const int64_t* group_off,
                const int32_t* owners, int64_t g, int32_t num_stages,
                const int64_t* caps, int32_t raster, int32_t* out_coords,
                int32_t* out_owner, int32_t* out_nbr3, int32_t* out_down,
                int64_t* out_counts) {
  int64_t total_cap = 0;
  std::vector<int64_t> base(num_stages);
  for (int32_t s = 0; s < num_stages; ++s) {
    base[s] = total_cap;
    total_cap += caps[s];
  }
  // padding init: -1 int32 is all-0xFF bytes, so memset covers every array
  std::memset(out_coords, 0, size_t(total_cap) * 3 * sizeof(int32_t));
  std::memset(out_owner, 0xFF, size_t(total_cap) * sizeof(int32_t));
  std::memset(out_nbr3, 0xFF, size_t(total_cap) * 27 * sizeof(int32_t));
  std::memset(out_down, 0xFF, size_t(total_cap) * 8 * sizeof(int32_t));
  // cum[s]: merged rows already emitted at stage s (pre-truncation) — the
  // index offset for this group's local refs
  std::vector<int64_t> cum(num_stages, 0);

  PyrStage cur, next;
  for (int64_t gi = 0; gi < g; ++gi) {
    const int64_t n0 = group_off[gi + 1] - group_off[gi];
    cur.n = n0;
    cur.coords.assign(coords0 + 3 * group_off[gi],
                      coords0 + 3 * group_off[gi + 1]);
    fill_keys(cur);
    int32_t stride = 1;
    for (int32_t s = 0; s < num_stages; ++s) {
      if (s > 0) {
        // hash-free arithmetic downsample whenever packing cannot clip
        // (slack 2*stride covers the floor's outward rounding); identical
        // output to the hash path under raster
        if (raster != 0 && coords_in_range(cur, 2 * stride))
          downsample_sorted(cur, stride, next);
        else
          downsample_stage(cur, stride, raster != 0, next);
        std::swap(cur, next);
        stride *= 2;
      }
      if (raster != 0 && merge_safe(cur, stride))
        build_nbr_merge(cur, stride);
      else
        build_nbr_hash(cur, stride);

      const int64_t off = cum[s];
      const int64_t prev_off = s > 0 ? cum[s - 1] - next.n : 0;  // pre-swap prev
      const int64_t cap = caps[s];
      const int64_t prev_cap = s > 0 ? caps[s - 1] : 0;
      const int64_t n_write =
          std::min(cur.n, cap > off ? cap - off : int64_t(0));
      const int64_t r0 = base[s] + off;
      // fast path — the common single-group (scene) / first-group case:
      // refs are local (off 0) and every row fits its cap, so local refs
      // (always < the stage's row count) can never exceed the cap and the
      // blocks copy verbatim (-1 padding included)
      const bool fit = off == 0 && cur.n <= cap;
      const bool prev_fit = s == 0 || (prev_off == 0 && next.n <= prev_cap);
      if (fit && prev_fit) {
        std::memcpy(out_coords + 3 * r0, cur.coords.data(),
                    size_t(n_write) * 3 * sizeof(int32_t));
        std::memcpy(out_nbr3 + 27 * r0, cur.nbr.data(),
                    size_t(n_write) * 27 * sizeof(int32_t));
        if (s > 0)
          std::memcpy(out_down + 8 * r0, cur.down.data(),
                      size_t(n_write) * 8 * sizeof(int32_t));
        std::fill(out_owner + r0, out_owner + r0 + n_write, owners[gi]);
      } else {
        for (int64_t i = 0; i < n_write; ++i) {
          const int64_t r = r0 + i;
          std::memcpy(out_coords + 3 * r, cur.coords.data() + 3 * i,
                      3 * sizeof(int32_t));
          out_owner[r] = owners[gi];
          for (int k = 0; k < 27; ++k) {
            int32_t v = cur.nbr[i * 27 + k];
            int64_t gv = v < 0 ? -1 : v + off;
            out_nbr3[r * 27 + k] =
                (gv >= 0 && gv < cap) ? static_cast<int32_t>(gv) : -1;
          }
          if (s > 0) {
            for (int k = 0; k < 8; ++k) {
              int32_t v = cur.down[i * 8 + k];
              int64_t gv = v < 0 ? -1 : v + prev_off;
              out_down[r * 8 + k] =
                  (gv >= 0 && gv < prev_cap) ? static_cast<int32_t>(gv) : -1;
            }
          }
        }
      }
      cum[s] += cur.n;
    }
  }
  for (int32_t s = 0; s < num_stages; ++s) out_counts[s] = cum[s];
}

// Columnwise min/max of the first 3 columns of an [n, row_stride] float32
// array (the xyz extent pad_sample needs): one vectorizable pass instead of
// numpy's ~2 ms strided reduction on 40k-point scenes (the single biggest
// unattributed slice of sample_misc, VERDICT r4 #3).
void ir_minmax3(const float* pts, int64_t n, int32_t row_stride,
                float* out_min, float* out_max) {
  float mn0 = pts[0], mn1 = pts[1], mn2 = pts[2];
  float mx0 = pts[0], mx1 = pts[1], mx2 = pts[2];
  for (int64_t i = 1; i < n; ++i) {
    const float* p = pts + i * row_stride;
    mn0 = p[0] < mn0 ? p[0] : mn0; mx0 = p[0] > mx0 ? p[0] : mx0;
    mn1 = p[1] < mn1 ? p[1] : mn1; mx1 = p[1] > mx1 ? p[1] : mx1;
    mn2 = p[2] < mn2 ? p[2] : mn2; mx2 = p[2] > mx2 ? p[2] : mx2;
  }
  out_min[0] = mn0; out_min[1] = mn1; out_min[2] = mn2;
  out_max[0] = mx0; out_max[1] = mx1; out_max[2] = mx2;
}

// Neighbor map: nbr[i*k + j] = row of (coords[i] + offsets[j] * stride), -1 if
// absent.  offsets: k x 3 int32.
void ir_build_nbr(const int32_t* coords, int64_t n, const int32_t* offsets,
                  int32_t k, int32_t stride, int32_t* nbr) {
  HashMap map(n);
  bool inserted;
  for (int64_t i = 0; i < n; ++i)
    map.insert(pack(coords + 3 * i), static_cast<int32_t>(i), &inserted);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = coords[3 * i], cy = coords[3 * i + 1], cz = coords[3 * i + 2];
    for (int32_t j = 0; j < k; ++j) {
      int64_t key = pack3(cx + int64_t(offsets[3 * j]) * stride,
                          cy + int64_t(offsets[3 * j + 1]) * stride,
                          cz + int64_t(offsets[3 * j + 2]) * stride);
      nbr[i * k + j] = map.find(key);
    }
  }
}

// Stride-2 downsample: out_coords = unique floor(c / (2*stride)) * (2*stride)
// in first-occurrence order; down[o*8 + j] = input row at out + {0,stride}^3.
// out_coords sized n*3, down sized n*8 by the caller.  Returns output count.
int64_t ir_downsample(const int32_t* coords, int64_t n, int32_t stride,
                      int32_t* out_coords, int32_t* down) {
  const int64_t ns = int64_t(stride) * 2;
  HashMap in_map(n);
  bool inserted;
  for (int64_t i = 0; i < n; ++i)
    in_map.insert(pack(coords + 3 * i), static_cast<int32_t>(i), &inserted);

  HashMap out_map(n);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t d[3];
    for (int t = 0; t < 3; ++t) {
      int64_t c = coords[3 * i + t];
      // floor division for negative coords
      int64_t q = (c >= 0) ? (c / ns) : (-(((-c) + ns - 1) / ns));
      d[t] = static_cast<int32_t>(q * ns);
    }
    out_map.insert(pack(d), static_cast<int32_t>(m), &inserted);
    if (inserted) {
      std::memcpy(out_coords + 3 * m, d, 3 * sizeof(int32_t));
      ++m;
    }
  }
  for (int64_t o = 0; o < m; ++o) {
    int64_t ox = out_coords[3 * o], oy = out_coords[3 * o + 1],
            oz = out_coords[3 * o + 2];
    int32_t j = 0;
    for (int dz = 0; dz < 2; ++dz)
      for (int dy = 0; dy < 2; ++dy)
        for (int dx = 0; dx < 2; ++dx, ++j) {
          int64_t key = pack3(ox + int64_t(dx) * stride, oy + int64_t(dy) * stride,
                              oz + int64_t(dz) * stride);
          down[o * 8 + j] = in_map.find(key);
        }
  }
  return m;
}

// Invert a stride-2 down map (non-overlapping: each previous-stage row feeds
// at most one (output row, offset)): up_row/up_k sized v_prev, -1 = none.
void ir_invert_down(const int32_t* down, int64_t v_out, int32_t k,
                    int64_t v_prev, int32_t* up_row, int32_t* up_k) {
  for (int64_t u = 0; u < v_prev; ++u) { up_row[u] = -1; up_k[u] = -1; }
  for (int64_t v = 0; v < v_out; ++v) {
    const int32_t* e = down + v * k;
    for (int32_t j = 0; j < k; ++j) {
      int32_t u = e[j];
      if (u >= 0 && u < v_prev) {
        up_row[u] = static_cast<int32_t>(v);
        up_k[u] = j;
      }
    }
  }
}

}  // extern "C"
