// Block-CSR neighbour aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/gather_aggregate.py and
// src/repro/kernels/daq_dequant.py:
//   block_spmm            (_spmm_kernel, :107)           -> block_spmm_launch
//   block_spmm_batched    (_spmm_batched_kernel, :124)   -> block_spmm_batched_launch
//   dequant_spmm          (_dequant_spmm_kernel)         -> dequant_spmm_launch
//   dequant_spmm_batched  (_dequant_spmm_batched_kernel) -> dequant_spmm_batched_launch
//   dequant               (_dequant_kernel)              -> dequant_launch
//
// All four products compute, for every row-block i (and batch element b),
//   out[b, i*128 + r, f] = sum_m mask[i, m] * sum_k blocks[i, m, r, k]
//                                          * h[b, cols[i, m]*128 + k, f]
// over the ELL-over-blocks layout of build_block_csr (M tile slots per
// row-block; padding slots carry mask 0 and an all-zero tile); the dequant
// products take h = codes * scale[row] + min[row].
//
// They read no tiles. They read the row-compacted operand that
// compact_block_csr (gather_aggregate.py) builds once per layout from the
// tiles themselves: per output row its segments, one per real tile slot
// whose row r holds a nonzero, in slot order; per segment the slot's mask
// value and its nonzero entries as (global source row cols*128 + k, value)
// pairs in k order. One walker serves all four; a row loader says where
// an entry's source row comes from:
//   F32Rows             the lane's features of an f32 table row
//                       (block_spmm, block_spmm_batched);
//   DequantRows<Code>   the lane's uint8/16/32 codes of the row, each
//                       built in registers as __fadd_rn(__fmul_rn(code,
//                       scale), min) from the row's (scale, min)
//                       (dequant_spmm, dequant_spmm_batched). Product and
//                       sum are rounded apart, as the plain version rounds
//                       them, so each value is bitwise the plain
//                       dequantized table's and the dense f32 table never
//                       exists in device memory.
//
// What bounds them on an H100: bytes, 8 per nonzero entry (value and
// source index) plus the source table (F * 4 bytes a row, or F code bytes
// and 8 bytes of row parameters) and the output once per example, at
// 3.35 TB/s; the multiply-adds, one per nonzero per feature, are far below
// the f32 CUDA-core peak. In practice the gathers of source rows (from L2:
// SIoT's f32 table is 3.4 MB) set the pace: at B = 8 their traffic runs at
// the rate an L2 gather reaches, and one row's sum is a chain that must
// run in order, so the longest row (SIoT's hub: 2,631 entries) sets the
// floor of a small launch. An SM keeps only so many gathers in flight,
// whatever the occupancy, so a long row must be spread over warps.
//
// Skipping the zeros is exact. The dense tile product builds each output
// element as one chain part = fmaf(a[k], b[k], part) over k = 0..127 per
// real slot, folded in slot order by acc = fmaf(mask, part, acc). For a
// finite b, fmaf(0, b, part) returns part (at most the sign of a zero
// differs), and a slot whose row is all zero folds in fmaf(1, 0, acc) =
// acc. So walking only the nonzeros, in the same (slot, k) order, with the
// same per-slot partial and fold, gives the dense product's floats; a
// dequantized code is finite. Both loaders feed the same chain, so
// dequant_spmm is bitwise block_spmm over the plain dequantized table.
//
// Design. Rows of up to 512 entries: one warp per (output row, feature
// chunk, example), the example index fastest, so the B warps of a row read
// its entries from L1/L2 side by side and each runs the serial code (out[b]
// is bitwise the serial launch); rows of more than 32 entries are launched
// first, longest first. Longer rows: one CTA per (row, chunk, example),
// first in the grid; its 8 warps walk about an eighth of the row's
// segments each, keep the per-segment partials in shared memory, and one
// warp folds them in slot order: the same chain, spread over 8 warps. The
// lanes cover the features, NF = ceil(F / 32) in each lane's registers (F
// above 256 splits into chunks), masked at the ragged edge; a warp's 32
// lanes read 32 neighbouring elements of a row, so a uint8 row is read a
// byte a lane (rows of F code bytes are not 4-byte aligned: no vector
// loads). A warp walks a row in batches of 32 entries, loaded coalesced
// one batch ahead; it stages each batch's (source, value, weight, segment)
// in shared memory, the dequant loader also each entry's (scale, min), and
// reads them back as broadcasts, so the chain has no branch and no warp
// collective, and it issues the source loads of a group of entries before
// the group's FMAs. Each segment resets part, runs part = fmaf(value, h,
// part) in entry order and folds acc = fmaf(mask, part, acc); each output
// element is stored once. No atomics, no TF32. The kernels fit 64
// registers (32 warps an SM), which the batched launches need. Offsets
// into the tables and out are 64-bit. dequant (last section) is the
// standalone row-wise dequantization with the same rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;  // warps per CTA of the row kernels
constexpr unsigned kAll = 0xffffffffu;

// Entries whose source loads one group issues before its FMAs, for an f32
// table: 16 prefetch registers a lane whatever NF, so that the kernels fit
// 64 registers (4 CTAs, 32 warps an SM). Each loader picks its own.
template <int NF>
__host__ __device__ constexpr int group_of() {
  return NF <= 2 ? 8 : (NF <= 4 ? 4 : 2);
}

// ---------------------------------------------------------------------------
// Row loaders. Per entry a loader may fetch a Param (one batch ahead) and
// stage it beside the entry; per group it loads a Raw value for each of
// the lane's features of the entry's source row, and the chain turns it
// into the f32 source value.
// ---------------------------------------------------------------------------

struct NoParam {};

// An f32 table: base points at the lane's first column of the example's
// row 0, row_bytes is F * 4.
struct F32Rows {
  using Param = NoParam;
  using Raw = float;
  struct Stage {
    int4 entry[32];
  };
  const char* base;
  unsigned row_bytes;

  template <int NF>
  __host__ __device__ static constexpr int group() {
    return group_of<NF>();
  }
  __device__ __forceinline__ Param param(int) const { return {}; }
  __device__ __forceinline__ static void put(Stage&, int, Param) {}
  __device__ __forceinline__ static Param staged(const Stage&, int) {
    return {};
  }
  __device__ __forceinline__ Raw load(int src, int j) const {
    return __ldg(reinterpret_cast<const float*>(
                     base + (unsigned long long)(unsigned)src * row_bytes) +
                 32 * j);
  }
  __device__ __forceinline__ static float value(Param, Raw x) { return x; }
};

// A table of uint8/16/32 codes with one f32 (scale, min) per row: base
// points at the lane's first code of the example's row 0, scales / mins
// at the example's row parameters, f is the codes a row. Sources are
// read-only for a launch, so every load takes the read-only data cache.
template <typename Code>
struct DequantRows {
  using Param = float2;  // (scale, min) of the entry's source row
  using Raw = Code;
  struct Stage {
    int4 entry[32];
    float2 param[32];
  };
  const Code* base;
  const float* scales;
  const float* mins;
  unsigned f;

  // Half the f32 group: the loader's pointers and each entry's (scale,
  // min) take the registers of the other half. With the full group the
  // uint8 NF = 2 instantiation (F = 52, 64) spilled about 100 bytes at 64
  // registers and ran 30 % slower at B = 8 on an H100.
  template <int NF>
  __host__ __device__ static constexpr int group() {
    return group_of<NF>() > 1 ? group_of<NF>() / 2 : 1;
  }
  __device__ __forceinline__ Param param(int src) const {
    return make_float2(__ldg(scales + src), __ldg(mins + src));
  }
  __device__ __forceinline__ static void put(Stage& st, int lane, Param p) {
    st.param[lane] = p;
  }
  __device__ __forceinline__ static Param staged(const Stage& st, int i) {
    return st.param[i];
  }
  __device__ __forceinline__ Raw load(int src, int j) const {
    return __ldg(base + (unsigned long long)(unsigned)src * f + 32 * j);
  }
  __device__ __forceinline__ static float value(Param p, Raw code) {
    return __fadd_rn(__fmul_rn((float)code, p.x), p.y);
  }
};

// The source tables of a launch: at(b, col0) is the loader of example b
// for the lane whose first feature is col0.
struct F32Table {
  using Rows = F32Rows;
  const float* h;
  long long stride;  // src_rows * f
  int f;
  __device__ __forceinline__ Rows at(long long b, int col0) const {
    return {reinterpret_cast<const char*>(h + b * stride + col0),
            (unsigned)f * 4u};
  }
};

template <typename Code>
struct CodeTable {
  using Rows = DequantRows<Code>;
  const Code* codes;
  const float* scales;
  const float* mins;
  long long src_rows;
  int f;
  __device__ __forceinline__ Rows at(long long b, int col0) const {
    return {codes + b * src_rows * f + col0, scales + b * src_rows,
            mins + b * src_rows, (unsigned)f};
  }
};

// Dynamic shared memory of a split CTA (partials and weights) stays within
// the 48 KB a launch may take without opting in, beside the static
// staging: `round_segs` + 1 is at most this many slots per NF.
template <class Rows>
constexpr int part_slots() {
  return (48 * 1024 - kRowWarps * (int)sizeof(typename Rows::Stage)) /
         (33 * 4);
}

// ---------------------------------------------------------------------------
// The row walker and the row kernels.
// ---------------------------------------------------------------------------

// Folds a finished segment's partial into the row's sum, in slot order:
// acc = fmaf(weight, part, acc) where the entry ends a segment.
template <int NF>
struct FoldSum {
  float acc[NF];
  __device__ __forceinline__ void at(bool fold, float wt, int /*seg*/,
                                     const float (&part)[NF]) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
      acc[j] = fold ? fmaf(wt, part[j], acc[j]) : acc[j];
  }
};

// Keeps a finished segment's partial (slot seg - base, lane-major:
// conflict-free) and weight in shared memory, for a later fold in slot
// order. Every entry stores, those that end no segment into the spare
// slot `spare`: no branch in the chain.
template <int NF>
struct KeepPart {
  float* parts;
  float* weights;
  int base, spare, lane;
  __device__ __forceinline__ void at(bool fold, float wt, int seg,
                                     const float (&part)[NF]) {
    const int slot = fold ? seg - base : spare;
#pragma unroll
    for (int j = 0; j < NF; ++j) parts[(slot * NF + j) * 32 + lane] = part[j];
    if (lane == 0) weights[slot] = wt;
  }
};

// One warp walks the entries e .. e_end of a row, which start segment s
// and end one (seg_ptr[s] == e), for one table and the lane's features:
// `rows` loads them, for the j with live[j] (the others lie past the
// ragged feature edge and read nothing). In entry order: part =
// fmaf(value, h, part) per entry; where a segment ends, sink.at(true,
// weight, segment, part) and part = 0.
//
// The entries go in batches of 32, lane i holding entry e + i. Per batch
// the warp also holds the window of the next 32 segments (lane j: segment
// s + j; past the row they end past the batch's real entries), enough for
// every segment that can end in the batch; from it a bit mask of the
// entries that end a segment and, per entry, the weight and index of the
// segment it ends. Each lane stages its entry as (source, value, weight,
// segment), and the loader's Param beside it, in the warp's shared memory,
// and the batch's loop reads them back as broadcasts: it is free of
// branches and of warp collectives, so all its source loads issue before
// its first FMA. The next batch's entries and window load before the FMAs
// too; its Params (a load that needs the entries' sources) after them,
// when the sources have arrived. Padding entries (past e_end) read source
// row 0 and end no segment: they come after the walk's last fold and
// reach no output.
template <int NF, class Rows, class Sink>
__device__ __forceinline__ void walk_segments(
    const int* __restrict__ seg_ptr, const float* __restrict__ seg_w,
    const int* __restrict__ src, const float* __restrict__ val, int n_seg,
    const Rows& rows, const bool (&live)[NF], int lane, int s, int e,
    int e_end, typename Rows::Stage& stage, Sink& sink) {
  constexpr int U = Rows::template group<NF>();
  float part[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) part[j] = 0.0f;
  int my_src = e + lane < e_end ? __ldg(src + e + lane) : 0;
  float my_val = e + lane < e_end ? __ldg(val + e + lane) : 0.0f;
  int my_end = s + lane < n_seg ? __ldg(seg_ptr + s + lane + 1) : 0x7fffffff;
  float my_w = s + lane < n_seg ? __ldg(seg_w + s + lane) : 0.0f;
  typename Rows::Param my_p = rows.param(my_src);
  for (; e < e_end; e += 32) {
    const int n = min(32, e_end - e);
    // Bit i: real entry e + i ends a segment, segment s + (number of ends
    // before i), whose weight lane i fetches.
    const int rel = my_end - e - 1;  // >= 0 for every segment from s on
    const unsigned ends =
        __reduce_or_sync(kAll, rel < n ? 1u << rel : 0u);
    const int before = __popc(ends & ((1u << lane) - 1u));
    const float end_w = __shfl_sync(kAll, my_w, before);
    __syncwarp();  // the previous batch's reads are done
    stage.entry[lane] = make_int4(my_src, __float_as_int(my_val),
                                  __float_as_int(end_w), s + before);
    Rows::put(stage, lane, my_p);
    __syncwarp();
    // The next batch's entries and window, ahead of this batch's chain.
    s += __popc(ends);
    const int ahead = e + 32 + lane;
    my_src = ahead < e_end ? __ldg(src + ahead) : 0;
    my_val = ahead < e_end ? __ldg(val + ahead) : 0.0f;
    my_end = s + lane < n_seg ? __ldg(seg_ptr + s + lane + 1) : 0x7fffffff;
    my_w = s + lane < n_seg ? __ldg(seg_w + s + lane) : 0.0f;
#pragma unroll 1
    for (int g = 0; g < n; g += U) {
      // Every source load of the group first ...
      typename Rows::Raw x[U][NF];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int from = stage.entry[g + u].x;
#pragma unroll
        for (int j = 0; j < NF; ++j)
          x[u][j] = live[j] ? rows.load(from, j) : typename Rows::Raw(0);
      }
      // ... then the chain, in entry order.
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int4 en = stage.entry[g + u];
        const typename Rows::Param p = Rows::staged(stage, g + u);
        const bool fold = (ends >> (g + u)) & 1u;
#pragma unroll
        for (int j = 0; j < NF; ++j)
          part[j] = fmaf(__int_as_float(en.y), Rows::value(p, x[u][j]),
                         part[j]);
        sink.at(fold, __int_as_float(en.z), en.w, part);
#pragma unroll
        for (int j = 0; j < NF; ++j) part[j] = fold ? 0.0f : part[j];
      }
    }
    my_p = rows.param(my_src);
  }
}

// Rows in warp_rows[i] = (row, first segment, first entry, end entry),
// in launch order: one warp per (row, feature chunk, example); warp w is
// example w % batch of warp row (w / batch) / chunks, chunk (w / batch) %
// chunks. Rows in split[]: one CTA per (row, chunk, example), in the first
// CTAs of the grid; its 8 warps walk contiguous runs of about an eighth
// of the row's entries each (whole segments, at most `round_segs`
// segments at a time), keep the partials in shared memory, and warp 0
// folds them in slot order, so the row's sum is the same chain as one
// warp's. Row `row` has segments row_ptr[row] .. row_ptr[row + 1]. The
// example's sources come from table.at(b, ...), out[b] is [n_rows, f] at
// b * out_stride.
template <int NF, class Table>
__device__ __forceinline__ void rows_spmm_body(
    const int* __restrict__ row_ptr, const int* __restrict__ seg_ptr,
    const float* __restrict__ seg_w, const int* __restrict__ src,
    const float* __restrict__ val, const int4* __restrict__ warp_rows,
    const int* __restrict__ split, const Table& table,
    float* __restrict__ out, int n_seg, long long n_split_ctas,
    long long n_warps, int round_segs, int batch, int chunks, int f,
    long long out_stride) {
  using Rows = typename Table::Rows;
  // Split CTAs: [round_segs + 1][NF][32] partials, then round_segs + 1
  // weights (the last slot of each is the spare).
  extern __shared__ float parts[];
  __shared__ typename Rows::Stage stage[kRowWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const bool whole_cta = blockIdx.x < n_split_ctas;
  const long long w = whole_cta
      ? (long long)blockIdx.x
      : (blockIdx.x - n_split_ctas) * kRowWarps + warp;
  if (!whole_cta && w >= n_warps) return;  // whole warps
  const long long b = w % batch;
  const long long rc = w / batch;
  const int col0 = (int)(rc % chunks) * 32 * NF + lane;
  const Rows rows = table.at(b, col0);
  bool live[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) live[j] = col0 + 32 * j < f;

  FoldSum<NF> sum;
#pragma unroll
  for (int j = 0; j < NF; ++j) sum.acc[j] = 0.0f;
  int row;
  if (!whole_cta) {
    const int4 info = __ldg(warp_rows + rc / chunks);
    row = info.x;
    walk_segments<NF>(seg_ptr, seg_w, src, val, n_seg, rows, live, lane,
                      info.y, info.z, info.w, stage[warp], sum);
  } else {
    row = __ldg(split + rc / chunks);
    const int s0 = __ldg(row_ptr + row);
    const int s1 = __ldg(row_ptr + row + 1);
    for (int r0 = s0; r0 < s1; r0 += round_segs) {
      const int r1 = min(r0 + round_segs, s1);
      // Warp k takes the segments that start in its eighth of the round's
      // entries: [r0 + (starts below bound k), r0 + (starts below k + 1)).
      const int e0 = __ldg(seg_ptr + r0);
      const long long span = __ldg(seg_ptr + r1) - e0;
      const int lo_bound = e0 + (int)(span * warp / kRowWarps);
      const int hi_bound = e0 + (int)(span * (warp + 1) / kRowWarps);
      int lo = r0, hi = r0;
#pragma unroll 4
      for (int q = r0; q < r1; q += 32) {
        const int start = q + lane < r1 ? __ldg(seg_ptr + q + lane)
                                        : 0x7fffffff;
        lo += __popc(__ballot_sync(kAll, start < lo_bound));
        hi += __popc(__ballot_sync(kAll, start < hi_bound));
      }
      if (lo < hi) {
        KeepPart<NF> keep{parts, parts + (round_segs + 1) * NF * 32, r0,
                          round_segs, lane};
        walk_segments<NF>(seg_ptr, seg_w, src, val, n_seg, rows, live, lane,
                          lo, __ldg(seg_ptr + lo), __ldg(seg_ptr + hi),
                          stage[warp], keep);
      }
      __syncthreads();
      if (warp == 0) {
        const float* weights = parts + (round_segs + 1) * NF * 32;
#pragma unroll 8
        for (int q = 0; q < r1 - r0; ++q) {
          const float* p = parts + q * NF * 32 + lane;
#pragma unroll
          for (int j = 0; j < NF; ++j)
            sum.acc[j] = fmaf(weights[q], p[j * 32], sum.acc[j]);
        }
      }
      __syncthreads();
    }
    if (warp != 0) return;
  }
  float* ob = out + b * out_stride + (long long)row * f;
#pragma unroll
  for (int j = 0; j < NF; ++j)
    if (live[j]) ob[col0 + 32 * j] = sum.acc[j];
}

// block_spmm(_batched): h[b] is [src_rows, f] at b * h_stride.
template <int NF>
__global__ void __launch_bounds__(kRowWarps * 32, 4)
rows_spmm_kernel(const int* __restrict__ row_ptr,
                 const int* __restrict__ seg_ptr,
                 const float* __restrict__ seg_w, const int* __restrict__ src,
                 const float* __restrict__ val,
                 const int4* __restrict__ warp_rows,
                 const int* __restrict__ split, const float* __restrict__ h,
                 float* __restrict__ out, int n_seg, long long n_split_ctas,
                 long long n_warps, int round_segs, int batch, int chunks,
                 int f, long long h_stride, long long out_stride) {
  rows_spmm_body<NF>(row_ptr, seg_ptr, seg_w, src, val, warp_rows, split,
                     F32Table{h, h_stride, f}, out, n_seg, n_split_ctas,
                     n_warps, round_segs, batch, chunks, f, out_stride);
}

// dequant_spmm(_batched): codes[b] is [src_rows, f], scales[b] / mins[b]
// [src_rows].
template <int NF, typename Code>
__global__ void __launch_bounds__(kRowWarps * 32, 4)
dequant_rows_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ seg_ptr,
                    const float* __restrict__ seg_w,
                    const int* __restrict__ src,
                    const float* __restrict__ val,
                    const int4* __restrict__ warp_rows,
                    const int* __restrict__ split,
                    const Code* __restrict__ codes,
                    const float* __restrict__ scales,
                    const float* __restrict__ mins, float* __restrict__ out,
                    int n_seg, long long n_split_ctas, long long n_warps,
                    int round_segs, int batch, int chunks, int f,
                    long long src_rows, long long out_stride) {
  rows_spmm_body<NF>(row_ptr, seg_ptr, seg_w, src, val, warp_rows, split,
                     CodeTable<Code>{codes, scales, mins, src_rows, f}, out,
                     n_seg, n_split_ctas, n_warps, round_segs, batch, chunks,
                     f, out_stride);
}

// The grid of a row-kernel launch.
struct RowGrid {
  int chunks, nf, round_segs;
  long long n_split_ctas, n_warps, ctas;
  size_t smem;
};

template <class Rows>
RowGrid row_grid(int batch, int n_warp_rows, int n_split, int split_segs,
                 int f) {
  RowGrid g;
  // Feature chunks of at most 256 (8 a lane), as even as they go.
  g.chunks = (f + 255) / 256;
  g.nf = ((f + g.chunks - 1) / g.chunks + 31) / 32;
  g.n_split_ctas = (long long)n_split * g.chunks * batch;
  g.n_warps = (long long)n_warp_rows * g.chunks * batch;
  g.ctas = g.n_split_ctas + (g.n_warps + kRowWarps - 1) / kRowWarps;
  g.round_segs =
      n_split ? min(split_segs, part_slots<Rows>() / g.nf - 1) : 1;
  g.smem = n_split
      ? (size_t)(g.round_segs + 1) * (g.nf * 32 + 1) * sizeof(float)
      : 0;
  return g;
}

int rows_spmm(const int* row_ptr, const int* seg_ptr, const float* seg_w,
              const int* src, const float* val, const int* warp_rows,
              const int* split, const float* h, float* out, int batch,
              int n_rows, int n_seg, int n_warp_rows, int n_split,
              int split_segs, int f, int src_rows, void* stream) {
  const RowGrid g =
      row_grid<F32Rows>(batch, n_warp_rows, n_split, split_segs, f);
  if (g.ctas == 0) return (int)cudaSuccess;
  if (g.ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long h_stride = (long long)src_rows * f;
  const long long out_stride = (long long)n_rows * f;
  cudaStream_t s = (cudaStream_t)stream;
  switch (g.nf) {
#define ROWS_SPMM(NF)                                                        \
  case NF:                                                                   \
    rows_spmm_kernel<NF><<<(unsigned)g.ctas, kRowWarps * 32, g.smem, s>>>(   \
        row_ptr, seg_ptr, seg_w, src, val, (const int4*)warp_rows, split, h, \
        out, n_seg, g.n_split_ctas, g.n_warps, g.round_segs, batch,          \
        g.chunks, f, h_stride, out_stride);                                  \
    break;
    ROWS_SPMM(1)
    ROWS_SPMM(2)
    ROWS_SPMM(3)
    ROWS_SPMM(4)
    ROWS_SPMM(5)
    ROWS_SPMM(6)
    ROWS_SPMM(7)
    ROWS_SPMM(8)
#undef ROWS_SPMM
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Code>
int dequant_rows(const int* row_ptr, const int* seg_ptr, const float* seg_w,
                 const int* src, const float* val, const int* warp_rows,
                 const int* split, const Code* codes, const float* scales,
                 const float* mins, float* out, int batch, int n_rows,
                 int n_seg, int n_warp_rows, int n_split, int split_segs,
                 int f, int src_rows, void* stream) {
  const RowGrid g = row_grid<DequantRows<Code>>(batch, n_warp_rows, n_split,
                                                split_segs, f);
  if (g.ctas == 0) return (int)cudaSuccess;
  if (g.ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long out_stride = (long long)n_rows * f;
  cudaStream_t s = (cudaStream_t)stream;
  switch (g.nf) {
#define DEQUANT_ROWS(NF)                                                   \
  case NF:                                                                 \
    dequant_rows_kernel<NF, Code>                                          \
        <<<(unsigned)g.ctas, kRowWarps * 32, g.smem, s>>>(                 \
            row_ptr, seg_ptr, seg_w, src, val, (const int4*)warp_rows,     \
            split, codes, scales, mins, out, n_seg, g.n_split_ctas,        \
            g.n_warps, g.round_segs, batch, g.chunks, f,                   \
            (long long)src_rows, out_stride);                              \
    break;
    DEQUANT_ROWS(1)
    DEQUANT_ROWS(2)
    DEQUANT_ROWS(3)
    DEQUANT_ROWS(4)
    DEQUANT_ROWS(5)
    DEQUANT_ROWS(6)
    DEQUANT_ROWS(7)
    DEQUANT_ROWS(8)
#undef DEQUANT_ROWS
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int dequant_spmm(const int* row_ptr, const int* seg_ptr, const float* seg_w,
                 const int* src, const float* val, const int* warp_rows,
                 const int* split, const void* codes, const float* scales,
                 const float* mins, float* out, int batch, int n_rows,
                 int n_seg, int n_warp_rows, int n_split, int split_segs,
                 int f, int src_rows, int code_bytes, void* stream) {
#define BY_CODE(CODE)                                                       \
  dequant_rows(row_ptr, seg_ptr, seg_w, src, val, warp_rows, split,         \
               (const CODE*)codes, scales, mins, out, batch, n_rows, n_seg, \
               n_warp_rows, n_split, split_segs, f, src_rows, stream)
  switch (code_bytes) {
    case 1:
      return BY_CODE(uint8_t);
    case 2:
      return BY_CODE(uint16_t);
    case 4:
      return BY_CODE(uint32_t);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BY_CODE
}

// ---------------------------------------------------------------------------
// dequant: standalone row-wise dequantization.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// Standalone dequantization, out[e] = codes[e] * scale[row] + min[row]
// over the table viewed flat (row = e / f), rounded twice like the plain
// version (__fmul_rn, then __fadd_rn): bitwise ref.dequant_ref. Bound by
// bytes: it reads each code and row parameter once and writes each f32
// output once, one element per thread in a grid-stride loop, neighbouring
// threads on neighbouring elements (coalesced); nothing is staged in
// shared memory. The dequantize path's tables are small enough that the
// launch itself sets the pace. Indices are 32-bit unsigned (one 32-bit
// division an element; e + the grid's stride stays below 2^32): the
// wrapper sends no table of 2^31 or more elements.
template <typename Code>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const Code* __restrict__ codes,
               const float* __restrict__ scales,
               const float* __restrict__ mins, float* __restrict__ out,
               unsigned n, unsigned f) {
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < n;
       e += gridDim.x * kThreads) {
    const unsigned row = e / f;
    out[e] = __fadd_rn(__fmul_rn((float)__ldg(codes + e),
                                 __ldg(scales + row)),
                       __ldg(mins + row));
  }
}

int dequant(const void* codes, const float* scales, const float* mins,
            float* out, int rows, int f, int code_bytes, void* stream) {
  const long long n = (long long)rows * f;
  if (n == 0) return (int)cudaSuccess;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long want = (n + kThreads - 1) / kThreads;
  const int grid = (int)(want < 132 * 64 ? want : 132 * 64);
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bytes) {
    case 1:
      dequant_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
          (const uint8_t*)codes, scales, mins, out, (unsigned)n, f);
      break;
    case 2:
      dequant_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
          (const uint16_t*)codes, scales, mins, out, (unsigned)n, f);
      break;
    case 4:
      dequant_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
          (const uint32_t*)codes, scales, mins, out, (unsigned)n, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out f32[n_rows, f] = A @ h, h f32[src_rows, f], A the row-compacted
// operand (row_ptr i32[n_rows + 1], seg_ptr i32[n_seg + 1], seg_w
// f32[n_seg], src i32[nnz], val f32[nnz]; warp_rows i32[n_warp_rows, 4]
// the rows a warp walks, 16-byte aligned; split i32[n_split] the rows a
// CTA walks, split_segs the most segments of a split row). Returns
// cudaGetLastError().
int block_spmm_launch(const int* row_ptr, const int* seg_ptr,
                      const float* seg_w, const int* src, const float* val,
                      const int* warp_rows, const int* split, const float* h,
                      float* out, int n_rows, int n_seg, int n_warp_rows,
                      int n_split, int split_segs, int f, int src_rows,
                      void* stream) {
  return rows_spmm(row_ptr, seg_ptr, seg_w, src, val, warp_rows, split, h,
                   out, 1, n_rows, n_seg, n_warp_rows, n_split, split_segs, f,
                   src_rows, stream);
}

// out f32[b, n_rows, f] = A @ h[b], h f32[b, src_rows, f].
int block_spmm_batched_launch(const int* row_ptr, const int* seg_ptr,
                              const float* seg_w, const int* src,
                              const float* val, const int* warp_rows,
                              const int* split, const float* h, float* out,
                              int batch, int n_rows, int n_seg,
                              int n_warp_rows, int n_split, int split_segs,
                              int f, int src_rows, void* stream) {
  return rows_spmm(row_ptr, seg_ptr, seg_w, src, val, warp_rows, split, h,
                   out, batch, n_rows, n_seg, n_warp_rows, n_split,
                   split_segs, f, src_rows, stream);
}

// out f32[n_rows, f] = A @ (codes * scales[:, None] + mins[:, None]), A
// the row-compacted operand as for block_spmm_launch, codes
// uint{8,16,32}[src_rows, f] (code_bytes 1, 2 or 4), scales / mins
// f32[src_rows].
int dequant_spmm_launch(const int* row_ptr, const int* seg_ptr,
                        const float* seg_w, const int* src, const float* val,
                        const int* warp_rows, const int* split,
                        const void* codes, const float* scales,
                        const float* mins, float* out, int n_rows, int n_seg,
                        int n_warp_rows, int n_split, int split_segs, int f,
                        int src_rows, int code_bytes, void* stream) {
  return dequant_spmm(row_ptr, seg_ptr, seg_w, src, val, warp_rows, split,
                      codes, scales, mins, out, 1, n_rows, n_seg,
                      n_warp_rows, n_split, split_segs, f, src_rows,
                      code_bytes, stream);
}

// out f32[b, n_rows, f] = A @ dequant(codes[b]), codes [b, src_rows, f],
// scales / mins f32[b, src_rows].
int dequant_spmm_batched_launch(const int* row_ptr, const int* seg_ptr,
                                const float* seg_w, const int* src,
                                const float* val, const int* warp_rows,
                                const int* split, const void* codes,
                                const float* scales, const float* mins,
                                float* out, int batch, int n_rows, int n_seg,
                                int n_warp_rows, int n_split, int split_segs,
                                int f, int src_rows, int code_bytes,
                                void* stream) {
  return dequant_spmm(row_ptr, seg_ptr, seg_w, src, val, warp_rows, split,
                      codes, scales, mins, out, batch, n_rows, n_seg,
                      n_warp_rows, n_split, split_segs, f, src_rows,
                      code_bytes, stream);
}

// out f32[rows, f] = codes * scales[:, None] + mins[:, None], codes
// uint{8,16,32}[rows, f] (code_bytes 1, 2 or 4), scales / mins f32[rows].
int dequant_launch(const void* codes, const float* scales, const float* mins,
                   float* out, int rows, int f, int code_bytes,
                   void* stream) {
  return dequant(codes, scales, mins, out, rows, f, code_bytes, stream);
}

}  // extern "C"
