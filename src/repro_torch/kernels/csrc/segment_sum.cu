// Fixed-order segment sum for Hopper (sm_90a).
//
// Replaces the sum of src/repro/gnn/layers.py:_segment_sum
// (jax.ops.segment_sum, which XLA lowers without a Pallas kernel); it is
// the port's "segment_sum" aggregation and GAT's only path
//   -> segment_sum_launch
//
// Computes out[v, f] = 0 + x[order[o_v], f] + x[order[o_v + 1], f] + ...
// over o_v = offsets[v] .. offsets[v + 1] - 1, left to right in f32 adds
// (no FMA, no atomics). `order` lists the edges stably sorted by receiver, so each
// receiver's messages are summed in edge order, starting from 0:
// the same floats as a serial index_add_ into zeros (the CPU's), the same
// on every run and for every example of a batch.
//
// What bounds it on an H100: every message is read once and every output
// written once (4 bytes an f32 entry) plus the order and offsets (4 bytes
// each): the bytes bound it. One add per message entry is far below any
// arithmetic rate.
//
// What the design does about it: one warp per receiver, its lanes over the
// features, so a warp reads each message row as contiguous runs of 32
// values and keeps its running sums in registers (one feature: the warp
// gathers 32 entries at once and adds them in order). The entries are
// walked in batches of 32 whose indices are staged in shared memory, so a
// batch's 32 row loads issue together before its adds and the chain of
// dependent loads is one per batch, not one per entry (SIoT's hub has
// 2,631 in-edges). No receiver's
// sum is split, so no partial sums meet and the order is fixed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // receivers per 256-thread CTA

// x [E, F], F >= 2: lanes over features, NF chunks of 32 each (features
// blockIdx.y * 32 NF + lane + 32 c). A receiver's entries go in batches of
// 32: the warp stages the batch's edge indices in shared memory (read back
// as broadcasts), issues all of the batch's row loads, then adds them in
// order, while the next batch's indices are already in flight.
template <int NF>
__global__ void __launch_bounds__(kWarps * 32)
segment_rows_kernel(const float* __restrict__ x,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ offsets,
                    float* __restrict__ out, int num_segments,
                    int features) {
  __shared__ int32_t idx_s[kWarps][32];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v = blockIdx.x * kWarps + w;
  if (v >= num_segments) return;
  const int f0 = blockIdx.y * 32 * NF + lane;
  const int lo = offsets[v], hi = offsets[v + 1];
  float acc[NF];
#pragma unroll
  for (int c = 0; c < NF; ++c) acc[c] = 0.f;
  int next = lo + lane < hi ? order[lo + lane] : 0;
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    __syncwarp();
    idx_s[w][lane] = next;
    __syncwarp();
    next = base + 32 + lane < hi ? order[base + 32 + lane] : 0;
    float val[32][NF];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float* row = x + (long long)idx_s[w][j] * features;
#pragma unroll
      for (int c = 0; c < NF; ++c)
        val[j][c] = j < n && f0 + 32 * c < features ? row[f0 + 32 * c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < n) {
#pragma unroll
        for (int c = 0; c < NF; ++c) acc[c] = __fadd_rn(acc[c], val[j][c]);
      }
  }
#pragma unroll
  for (int c = 0; c < NF; ++c)
    if (f0 + 32 * c < features)
      out[(long long)v * features + f0 + 32 * c] = acc[c];
}

// x [E] (one feature): each lane gathers one entry of a batch of 32 into
// shared memory (the next batch's indices already in flight) and every lane
// adds the batch in order; lane 0 stores.
__global__ void __launch_bounds__(kWarps * 32)
segment_scalar_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ offsets,
                      float* __restrict__ out, int num_segments) {
  __shared__ float val_s[kWarps][32];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v = blockIdx.x * kWarps + w;
  if (v >= num_segments) return;
  const int lo = offsets[v], hi = offsets[v + 1];
  float acc = 0.f;
  int next = lo + lane < hi ? order[lo + lane] : 0;
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    const float val = lane < n ? x[next] : 0.f;
    next = base + 32 + lane < hi ? order[base + 32 + lane] : 0;
    __syncwarp();
    val_s[w][lane] = val;
    __syncwarp();
    for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, val_s[w][j]);
  }
  if (lane == 0) out[v] = acc;
}

template <int NF>
void launch_rows(const float* x, const int32_t* order, const int32_t* offsets,
                 float* out, int num_segments, int features, cudaStream_t s) {
  const dim3 grid((num_segments + kWarps - 1) / kWarps,
                  (features + 32 * NF - 1) / (32 * NF));
  segment_rows_kernel<NF><<<grid, kWarps * 32, 0, s>>>(
      x, order, offsets, out, num_segments, features);
}

}  // namespace

extern "C" {

// out [num_segments, features] = the segment sums of x [E, features]
// (contiguous float32) in the order given by order (row indices of x) and
// offsets [num_segments + 1] (int32). Returns a cudaError_t code.
int segment_sum_launch(const float* x, const int32_t* order,
                       const int32_t* offsets, float* out, int num_segments,
                       int features, void* stream) {
  if (num_segments <= 0 || features <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (features == 1) {
    segment_scalar_kernel<<<(num_segments + kWarps - 1) / kWarps,
                            kWarps * 32, 0, s>>>(x, order, offsets, out,
                                                 num_segments);
    return (int)cudaGetLastError();
  }
  // A batch keeps 32 * NF values a lane in registers: up to 4 chunks
  // (more would spill); wider rows take more column blocks.
  const int nf = (features + 31) / 32;
  if (nf == 1) {
    launch_rows<1>(x, order, offsets, out, num_segments, features, s);
  } else if (nf == 2) {
    launch_rows<2>(x, order, offsets, out, num_segments, features, s);
  } else if (nf == 3) {
    launch_rows<3>(x, order, offsets, out, num_segments, features, s);
  } else {
    launch_rows<4>(x, order, offsets, out, num_segments, features, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
