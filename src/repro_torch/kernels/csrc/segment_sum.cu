// Fixed-order gather-and-sum for Hopper (sm_90a).
//
// Replaces the sums of src/repro/gnn/layers.py (jax.ops.segment_sum, which
// XLA lowers without a Pallas kernel: _segment_sum's messages, GAT's
// softmax denominators); it is the port's "segment_sum" aggregation and
// GAT's only path
//   -> segment_sum_launch
//
// Computes, for every receiver v and feature f,
//   out[v, f] = +0 (+) w(k0) * x[idx[k0], f] (+) w(k1) * x[idx[k1], f] ...
// over k = offsets[v] .. offsets[v + 1] - 1, left to right: (+) is an f32
// add (__fadd_rn), * an f32 product rounded on its own (__fmul_rn, no FMA
// contraction), and w(k) = w[order[k]] when weights are given (else the
// row itself is added). With idx = senders[order] and order the unmasked
// edges stably sorted by receiver, these are the floats of a serial
// index_add_ of the messages x[senders] (* w) into zeros in edge order,
// the same on every run and for every example of a batch. No message
// tensor exists in device memory: each receiver's rows are gathered
// straight from the source table.
//
// What bounds it on an H100: the function needs the distinct source rows,
// idx (and order and w), the offsets and the output once each, a few MB on
// SIoT, so the bytes bound it (one add, or a product and an add, per
// gathered entry is far below the f32 rate). What sets its pace instead is
// the gather: every entry re-reads its source row, E * F * 4 bytes in all
// (52 MB at SIoT's F = 52), from L2 (the table, 3.4 MB for SIoT and 11 MB
// for the mesh's folded [n*P | n*B] table, stays resident in the 50 MB
// L2), and the longest receiver's sum is one chain of dependent adds
// (SIoT's hub: 2,631 entries, about 4 cycles each).
//
// Design. Short segments (at most long_threshold entries): each receiver
// gets a lane group just wide enough for its row, in vectors where the
// row allows (F % 4 == 0: float4, F % 2 == 0: float2, else float): F = 1
// or 2 -> one thread, F = 52 or 64 -> 16 lanes of float4, up to a warp
// with up to kMaxVals values a lane, wider rows over more column blocks.
// A group walks its segment in batches of kUnroll entries: it issues the
// batch's row loads, prefetches the next batch's indices, then adds the
// batch in order, so a batch costs one gather latency, not one per entry.
// Long segments (more than long_threshold entries, all listed, longest
// first, by the caller: kernels/segment_sum.py's LongSegments, which also
// sets the threshold by the row's width) get a CTA of their own per
// kLongCols columns, at the front of the grid, so the hub's chain overlaps everything else: seven
// producer warps keep kStages stages of rows in flight into a ring in
// shared memory with cp.async, reading each row's source index from an
// index ring that cp.async fills kStages - 1 stages further ahead (so no
// producer waits on a global load for an address), and warp 0 adds the
// rows in order out of the ring, one barrier a stage, its shared-memory
// loads a batch of kAdd rows ahead of its adds and rows past the end
// zero-filled, so its loop has no test per row and the chain runs near
// the add latency.
// One thread, group or consumer warp owns each receiver's whole sum (per
// column), so the order is fixed. No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads a CTA, short and long alike
constexpr int kUnroll = 8;      // entries a short-segment batch
constexpr int kMaxVals = 8;     // values a lane of a short group holds
constexpr int kLongCols = 16;   // columns a long-segment CTA sums
constexpr int kStages = 8;      // ring stages of a long-segment CTA
constexpr int kAdd = 8;         // ring rows a consumer batch adds
constexpr int kProducers = kThreads - 32;

// VEC contiguous floats: loads through the read-only path, vector stores.
template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void ld(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void lds(const float* p, float (&v)[1]) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void st(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void ld(const float* p, float (&v)[2]) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
  static __device__ __forceinline__ void lds(const float* p, float (&v)[2]) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
  static __device__ __forceinline__ void st(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void ld(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void lds(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void st(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The term an entry adds: the row value, or its product with the weight.
template <bool W>
__device__ __forceinline__ float term(float wt, float val) {
  return W ? __fmul_rn(wt, val) : val;
}

struct Args {
  const float* x;
  const int32_t* idx;
  const float* w;
  const int32_t* order;
  const int32_t* offsets;
  const int32_t* long_segs;
  float* out;
  int num_segments, f;
  int long_threshold;   // segments longer than this get a CTA (all are
                        // in long_segs), the rest a lane group
  int long_ctas;        // n_long * long_blocks, first in the grid
  int long_blocks;      // column blocks of a long segment
  int long_stride;      // floats a ring row holds: min(kLongCols, f)
  int long_rows;        // rows a ring stage holds
  int lanes;            // lanes of a short group (1, 2, .., 32)
  int row_blocks;       // CTAs over the receivers, per column block
};

// One short segment, summed by a group of a.lanes lanes; the lane's first
// column is col, its NC vectors step a.lanes * VEC columns apart.
template <int VEC, int NC, bool W>
__device__ __forceinline__ void short_segment(const Args& a, int v, int col) {
  const int lo = a.offsets[v], hi = a.offsets[v + 1];
  if (hi - lo > a.long_threshold) return;   // a long CTA sums it
  const int f = a.f, step = a.lanes * VEC;
  bool live[NC];
  float acc[NC][VEC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    live[c] = col + c * step < f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;
  }
  int j[kUnroll], o[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    j[u] = lo + u < hi ? __ldg(a.idx + lo + u) : 0;
    if (W) o[u] = lo + u < hi ? __ldg(a.order + lo + u) : 0;
  }
  for (int base = lo; base < hi; base += kUnroll) {
    const int n = min(kUnroll, hi - base);
    float val[kUnroll][NC][VEC];
    float wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* row = a.x + (long long)j[u] * f + col;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (u < n && live[c]) {
          Vec<VEC>::ld(row + c * step, val[u][c]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) val[u][c][e] = 0.f;
        }
      }
      wt[u] = W && u < n ? __ldg(a.w + o[u]) : 0.f;
    }
    // The next batch's indices load while this batch's adds run.
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + kUnroll + u;
      j[u] = k < hi ? __ldg(a.idx + k) : 0;
      if (W) o[u] = k < hi ? __ldg(a.order + k) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < n) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[c][e] = __fadd_rn(acc[c][e], term<W>(wt[u], val[u][c][e]));
      }
    }
  }
  float* dst = a.out + (long long)v * f + col;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (live[c]) Vec<VEC>::st(dst + c * step, acc[c]);
}

// A long segment's ring, in shared memory: per stage slot, rs rows of
// `stride` floats (the rows' columns c0 ..), and per row its weight, its
// source index and its order entry (the last two copied ahead of the
// rows, so a producer never waits on a global load for an address).
template <bool W>
struct Ring {
  float* x;       // [kStages][rs][stride]
  float* w;       // [kStages][rs] (weighted)
  int32_t* idx;   // [kStages][rs]
  int32_t* ord;   // [kStages][rs] (weighted)
  __device__ Ring(float* smem, int rs, int stride) {
    x = smem;
    w = x + kStages * rs * stride;
    idx = reinterpret_cast<int32_t*>(w + (W ? kStages * rs : 0));
    ord = idx + kStages * rs;
  }
};

// One long segment's columns c0 .. c0 + cw - 1, by a whole CTA: warps 1-7
// stage rows into the ring, warp 0 adds them in order. ST is the ring
// row's stride in floats when known at compile time (VEC: a row is one
// vector; kLongCols), else 0 (a.long_stride).
//
// Stage t's rows are copied at iteration t - kStages + 1 (with indices
// read from the index ring) and its indices at iteration t - 2 kStages +
// 2, each iteration's copies one cp.async group, so waiting for all but
// the newest kStages - 2 groups lands both the rows of the stage to add
// and the indices of the stage to copy next. Rows past the segment's end
// are zero-filled: adding +0 to a sum that starts at +0 changes no bit
// (the sum is never -0), so the consumer adds whole batches of kAdd rows
// with no test per row.
template <int VEC, bool W, int ST>
__device__ __forceinline__ void long_segment(const Args& a, float* smem,
                                             int v, int c0) {
  const int f = a.f, rs = a.long_rows;
  const int stride = ST > 0 ? ST : a.long_stride;
  const int cw = min(kLongCols, f - c0);
  const int lo = a.offsets[v], hi = a.offsets[v + 1];
  const int stages = (hi - lo + rs - 1) / rs;
  const Ring<W> ring(smem, rs, stride);
  // Producer p copies piece q (VEC columns) of ring row r of each stage;
  // piece 0 (the row's lead) also its weight and indices.
  // Other threads (warp 0, and producers past the stage's rows) take row
  // 0's place in every address they form, and copy nothing.
  const int cpr = stride / VEC, p = (int)threadIdx.x - 32;
  const bool producer = p >= 0 && p / cpr < rs;
  const int r = producer ? p / cpr : 0, q = producer ? p % cpr : 0;
  const bool copy_x = producer && q * VEC < cw;
  const bool lead = producer && q == 0;
  auto copy_indices = [&](int t) {   // stage t's indices into the rings
    const int k = lo + t * rs + r;
    if (lead && k < hi) {
      const int at = (t % kStages) * rs + r;
      cp_async<4>(ring.idx + at, a.idx + k);
      if (W) cp_async<4>(ring.ord + at, a.order + k);
    }
  };
  auto copy_rows = [&](int t, int j, int o) {   // stage t's rows
    if (t >= stages) return;
    const int at = (t % kStages) * rs + r;
    float* dst = ring.x + at * stride + q * VEC;
    if (lo + t * rs + r < hi) {
      if (copy_x)
        cp_async<VEC * 4>(dst, a.x + (long long)j * f + c0 + q * VEC);
      if (W && lead) cp_async<4>(ring.w + at, a.w + o);
    } else if (producer) {
      if (copy_x) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = 0.f;
      }
      if (W && lead) ring.w[at] = 0.f;
    }
  };
  {
    // Prologue: the first kStages - 1 stages' indices load together
    // from global memory; their rows, and the indices of the next
    // kStages - 1 stages, go as the first kStages - 1 groups.
    int j0[kStages - 1], o0[kStages - 1];
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      const int k = lo + t * rs + r;
      const bool in = producer && k < hi;
      j0[t] = in ? __ldg(a.idx + k) : 0;
      o0[t] = W && in ? __ldg(a.order + k) : 0;
    }
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      copy_rows(t, j0[t], o0[t]);
      copy_indices(t + kStages - 1);
      cp_async_commit();
    }
  }
  // Consumer lanes (warp 0): one a column, a float each, so a row costs
  // each lane one shared-memory load and one add; a row that is a single
  // vector (ST == VEC: F = 1, 2 or 4) goes to lane 0 whole, its loads
  // float4s across rows.
  constexpr int CV = ST == VEC ? VEC : 1;
  const int lane = threadIdx.x;
  const bool adder = lane < 32 && lane * CV < cw;
  float acc[CV];
#pragma unroll
  for (int e = 0; e < CV; ++e) acc[e] = 0.f;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();   // stage s's rows, stage s + 7's indices
    __syncthreads();                // everyone's; stage s - 1 consumed
    {
      const int t = s + kStages - 1, at = (t % kStages) * rs + r;
      copy_rows(t, ring.idx[at], W ? ring.ord[at] : 0);
      copy_indices(t + kStages - 1);
      cp_async_commit();
    }
    if (adder) {
      const int slot = s % kStages, n = min(rs, hi - lo - s * rs);
      const float* rows = ring.x + slot * rs * stride + lane * CV;
      const float* wts = ring.w + slot * rs;
      // Batches of kAdd rows (rs is a multiple of kAdd), the next batch's
      // shared-memory loads issued before this batch's adds.
      float cur[kAdd][CV], nxt[kAdd][CV], wc[kAdd], wn[kAdd];
      auto load = [&](int i0, float (&val)[kAdd][CV], float (&wt)[kAdd]) {
        if constexpr (ST == VEC) {   // rows back to back: float4s
          const float4* p4 = reinterpret_cast<const float4*>(rows + i0 * CV);
#pragma unroll
          for (int i = 0; i < kAdd * CV / 4; ++i) {
            const float4 t = p4[i];
            const float u4[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              val[(4 * i + c) / CV][(4 * i + c) % CV] = u4[c];
          }
        } else {
#pragma unroll
          for (int u = 0; u < kAdd; ++u) val[u][0] = rows[(i0 + u) * stride];
        }
        if (W) {
          const float4* w4 = reinterpret_cast<const float4*>(wts + i0);
#pragma unroll
          for (int i = 0; i < kAdd / 4; ++i) {
            const float4 t = w4[i];
            wt[4 * i] = t.x;
            wt[4 * i + 1] = t.y;
            wt[4 * i + 2] = t.z;
            wt[4 * i + 3] = t.w;
          }
        }
      };
      auto add = [&](const float (&val)[kAdd][CV], const float (&wt)[kAdd]) {
#pragma unroll
        for (int u = 0; u < kAdd; ++u)
#pragma unroll
          for (int e = 0; e < CV; ++e)
            acc[e] = __fadd_rn(acc[e], term<W>(wt[u], val[u][e]));
      };
      load(0, cur, wc);
#pragma unroll 1
      for (int i0 = 0; i0 < n; i0 += 2 * kAdd) {
        if (i0 + kAdd < n) load(i0 + kAdd, nxt, wn);
        add(cur, wc);
        if (i0 + kAdd >= n) break;
        if (i0 + 2 * kAdd < n) load(i0 + 2 * kAdd, cur, wc);
        add(nxt, wn);
      }
    }
  }
  if (adder) {
    float* dst = a.out + (long long)v * f + c0 + lane * CV;
    if constexpr (CV == 1)
      *dst = acc[0];
    else
      Vec<VEC>::st(dst, acc);
  }
}

template <int VEC, int NC, bool W>
__global__ void __launch_bounds__(kThreads) segment_kernel(const Args a) {
  extern __shared__ __align__(16) float ring[];
  const int b = blockIdx.x;
  if (b < a.long_ctas) {
    const int v = a.long_segs[b / a.long_blocks];
    const int c0 = (b % a.long_blocks) * kLongCols;
    if (a.long_stride == VEC)
      long_segment<VEC, W, VEC>(a, ring, v, c0);
    else if (a.long_stride == kLongCols)
      long_segment<VEC, W, kLongCols>(a, ring, v, c0);
    else
      long_segment<VEC, W, 0>(a, ring, v, c0);
    return;
  }
  const int sb = b - a.long_ctas;
  const int rb = sb % a.row_blocks, cb = sb / a.row_blocks;
  const int groups = kThreads / a.lanes;
  const int g = threadIdx.x / a.lanes, lane = threadIdx.x % a.lanes;
  const int v = rb * groups + g;
  if (v >= a.num_segments) return;
  short_segment<VEC, NC, W>(a, v, (cb * NC * a.lanes + lane) * VEC);
}

template <int VEC, int NC, bool W>
int launch(const Args& a, int grid, int smem, cudaStream_t s) {
  segment_kernel<VEC, NC, W><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int VEC, bool W>
int launch_nc(const Args& a, int nc, int grid, int smem, cudaStream_t s) {
  switch (nc) {
    case 1:
      return launch<VEC, 1, W>(a, grid, smem, s);
    case 2:
      return launch<VEC, (2 * VEC <= kMaxVals ? 2 : 1), W>(a, grid, smem, s);
    case 3:
      return launch<VEC, (3 * VEC <= kMaxVals ? 3 : 1), W>(a, grid, smem, s);
    default:
      return launch<VEC, (4 * VEC <= kMaxVals ? 4 : 1), W>(a, grid, smem, s);
  }
}

template <bool W>
int launch_vec(const Args& a, int vec, int nc, int grid, int smem,
               cudaStream_t s) {
  switch (vec) {
    case 4:
      return launch_nc<4, W>(a, nc, grid, smem, s);
    case 2:
      return launch_nc<2, W>(a, nc, grid, smem, s);
    default:
      return launch_nc<1, W>(a, nc, grid, smem, s);
  }
}

}  // namespace

extern "C" {

// out [num_segments, features] (contiguous float32): receiver v's sum of
// (w[order[k]] *) x[idx[k], :] over k = offsets[v] .. offsets[v + 1] - 1,
// x [rows, features] contiguous float32, idx / order / offsets int32, w
// float32 or null (unweighted; order is then not read). long_segs lists
// the n_long receivers whose segments are longer than long_threshold,
// longest first, each of which gets CTAs of their own; every such
// receiver must be listed (the lane groups skip them). Returns a
// cudaError_t code.
int segment_sum_launch(const float* x, const int32_t* idx, const float* w,
                       const int32_t* order, const int32_t* offsets,
                       const int32_t* long_segs, int n_long,
                       int long_threshold, float* out, int num_segments,
                       int features, void* stream) {
  if (num_segments <= 0 || features <= 0) return 0;
  if (n_long < 0 || long_threshold < 0) return (int)cudaErrorInvalidValue;
  const int f = features;
  const bool a16 = (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const bool a8 = (uintptr_t)x % 8 == 0 && (uintptr_t)out % 8 == 0;
  const int vec = f % 4 == 0 && a16 ? 4 : (f % 2 == 0 && a8 ? 2 : 1);
  const int vecs = f / vec;   // vectors a row
  int lanes = 1;
  while (lanes < 32 && lanes < vecs) lanes *= 2;
  int nc = (vecs + lanes - 1) / lanes;
  const int nc_max = kMaxVals / vec < 4 ? kMaxVals / vec : 4;
  if (nc > nc_max) nc = nc_max;
  const int col_blocks = (vecs + lanes * nc - 1) / (lanes * nc);
  const int groups = kThreads / lanes;
  Args a;
  a.x = x;
  a.idx = idx;
  a.w = w;
  a.order = order;
  a.offsets = offsets;
  a.long_segs = long_segs;
  a.out = out;
  a.num_segments = num_segments;
  a.f = f;
  a.long_threshold = n_long > 0 ? long_threshold : 0x7fffffff;
  a.long_blocks = (f + kLongCols - 1) / kLongCols;
  a.long_ctas = n_long * a.long_blocks;
  a.long_stride = f < kLongCols ? f : kLongCols;
  // Rows a ring stage holds: one per producer and piece, whole batches,
  // and the ring (rows, indices, and weights and order entries if
  // weighted) within the 48 KB a launch gets without opting in.
  const int ring_words = a.long_stride + (w != nullptr ? 3 : 1);
  const int fit = 48 * 1024 / (4 * kStages * ring_words);
  const int per_producer = kProducers / (a.long_stride / vec);
  a.long_rows = (per_producer < fit ? per_producer : fit) / kAdd * kAdd;
  a.lanes = lanes;
  a.row_blocks = (num_segments + groups - 1) / groups;
  const int grid = a.long_ctas + a.row_blocks * col_blocks;
  const int smem = n_long > 0 ? 4 * kStages * a.long_rows * ring_words : 0;
  cudaStream_t s = (cudaStream_t)stream;
  return w != nullptr ? launch_vec<true>(a, vec, nc, grid, smem, s)
                      : launch_vec<false>(a, vec, nc, grid, smem, s);
}

}  // extern "C"
