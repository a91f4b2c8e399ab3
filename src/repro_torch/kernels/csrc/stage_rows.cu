// Row gather that stages a micro-batch on the card (sm_90a).
//
// Builds the folded [B, R, F] feature table of the mesh's batched path
// (runtime/bsp.py's _local_stack) from the caller's [B, S, F] stack as it
// was uploaded: the table the host used to build with a numpy scatter
// (PartitionedGraph.feature_stack) and upload whole
//   -> stage_rows_launch
//
// Computes, for every example b, row r and feature f,
//   out[b, r, f] = x[b, row_src[r], f]   where row_src[r] >= 0,
//   out[b, r, f] = +0.0                  where row_src[r] == -1,
// so a padded slot holds +0.0, as numpy's zero fill gave it. Pure data
// movement: the floats land bit for bit, NaN payloads and -0.0 included.
//
// What bounds it on an H100: the bytes. Every output float is written
// once and every held vertex's row read once an example, B * (S + R) * F
// * 4 bytes plus the map's R * 4 (GAT on RMAT-40k at B = 8: 41 MB read and 43
// MB written, ~0.025 ms at 3.35 TB/s); there is no arithmetic.
//
// Design. The output is walked as one flat run of VEC-float vectors
// (float4 where F % 4 == 0 and both tables are 16-byte aligned, float2
// where F % 2 == 0 and 8-byte aligned, else single floats), over a
// grid-stride loop with 32-bit indices. Consecutive lanes take
// consecutive vectors of a row, so a row's F / VEC lanes form a group
// (GAT's F = 32: 8 lanes, four rows a warp; GCN's F = 52: 13 lanes) that
// reads its source row as one contiguous run and writes its output row
// as one: every store of a warp is coalesced, every lane is busy whatever
// F is, and a padded row costs a store and no load. Each lane reads its
// row's source index through the read-only path (the map is R * 4 bytes
// and stays in L1/L2). Every output vector is written by exactly one
// lane, so the output needs no fill and there are no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// out [batch, rows, vecs] vectors from x [batch, src_rows, vecs] through
// row_src [rows]; total = batch * rows * vecs < 2^31.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    stage_rows_kernel(const typename Vec<VEC>::T* __restrict__ x,
                      const int32_t* __restrict__ row_src,
                      typename Vec<VEC>::T* __restrict__ out, uint32_t rows,
                      uint32_t src_rows, uint32_t vecs, uint32_t total) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const uint32_t row = i / vecs;        // b * rows + r
    const uint32_t c = i - row * vecs;    // vector within the row
    const uint32_t b = row / rows;
    const uint32_t r = row - b * rows;
    const int32_t s = __ldg(row_src + r);
    typename Vec<VEC>::T v = Vec<VEC>::zero();
    if (s >= 0) v = __ldg(x + (b * src_rows + (uint32_t)s) * vecs + c);
    out[i] = v;
  }
}

template <int VEC>
int launch(const float* x, const int32_t* row_src, float* out, int batch,
           int rows, int src_rows, int features, cudaStream_t stream) {
  using T = typename Vec<VEC>::T;
  const uint32_t vecs = (uint32_t)(features / VEC);
  const uint32_t total = (uint32_t)batch * (uint32_t)rows * vecs;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // Full occupancy (2,048 threads an SM) and no more: the grid-stride loop
  // covers the rest, so a lane keeps a few vectors in flight.
  const uint32_t cap = (uint32_t)(sms > 0 ? sms : 132) * (2048 / kThreads);
  uint32_t grid = (total + kThreads - 1) / kThreads;
  if (grid > cap) grid = cap;
  stage_rows_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(x), row_src, reinterpret_cast<T*>(out),
      (uint32_t)rows, (uint32_t)src_rows, vecs, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [batch, rows, features] (contiguous float32): out[b, r, :] =
// x[b, row_src[r], :] where row_src[r] >= 0, +0.0 where it is -1; x
// [batch, src_rows, features] contiguous float32, every row_src entry in
// [-1, src_rows). batch * rows * features and batch * src_rows * features
// must each be below 2^31. Returns a cudaError_t code.
int stage_rows_launch(const float* x, const int32_t* row_src, float* out,
                      int batch, int rows, int src_rows, int features,
                      void* stream) {
  if (batch < 0 || rows < 0 || src_rows < 0 || features < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || rows == 0 || features == 0) return 0;
  const int64_t out_elems = (int64_t)batch * rows * features;
  const int64_t in_elems = (int64_t)batch * src_rows * features;
  if (out_elems >= ((int64_t)1 << 31) || in_elems >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const bool a16 = (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const bool a8 = (uintptr_t)x % 8 == 0 && (uintptr_t)out % 8 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (features % 4 == 0 && a16)
    return launch<4>(x, row_src, out, batch, rows, src_rows, features, s);
  if (features % 2 == 0 && a8)
    return launch<2>(x, row_src, out, batch, rows, src_rows, features, s);
  return launch<1>(x, row_src, out, batch, rows, src_rows, features, s);
}

}  // extern "C"
