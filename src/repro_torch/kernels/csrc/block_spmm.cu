// Block-CSR (ELL-over-blocks) neighbour aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/gather_aggregate.py:
//   block_spmm          (_spmm_kernel)          -> block_spmm_launch
//   block_spmm_batched  (_spmm_batched_kernel)  -> block_spmm_batched_launch
//
// Both compute, for every row-block i (and every batch element b),
//   out[b, i*128 + r, f] = sum_m mask[i, m] * sum_k blocks[i, m, r, k]
//                                          * h[b, cols[i, m]*128 + k, f]
// with the layout contract of build_block_csr: M tile slots per row-block,
// padding slots carry mask 0 and an all-zero tile, so they are skipped here.
//
// What bounds it on an H100: the adjacency tiles. Every real tile is a dense
// 128x128 f32 matrix (64 KB) that must be read once from device memory
// (3.35 TB/s); the source panels and the output are small beside them. The
// function needs only one FMA per nonzero tile entry per feature, and the
// graph fills well under 1% of the tile entries, so its floor is the tile
// bytes. This dense design, though, does 2*128*128*F flops per tile in f32
// FMA (no tensor cores: the product must stay true f32), zeros included,
// which at the 67 TFLOP/s f32 CUDA-core peak takes longer than reading the
// tiles: the kernel is held back by work the function does not need.
//
// What the design does about it: one CTA computes a 64-row x 64-feature
// output slab of one row-block, so each tile byte leaves device memory once
// per feature chunk and the CTA walks the row-block's real tiles in order.
// The tile slab and the source panel are staged through shared memory in
// 64-wide k-chunks (33 KB static), and each thread keeps a 4x4 register
// block of partial sums, so every shared-memory value feeds four FMAs.
// Accumulation is plain f32 FMA in a fixed k-order with no atomics, so a
// result is deterministic. The batched kernel runs the very same CTA body
// per batch element (blockIdx.x), which makes out[b] bitwise equal to the
// serial kernel on h[b]; batch-adjacent CTAs read the same tiles, which then
// come from L2. The ragged feature edge is masked in the kernel, so any F
// works. Skipping the zero entries (a sparse-aware format) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // adjacency tile edge (block-CSR block size)
constexpr int kRows = 64;    // output rows per CTA
constexpr int kFeat = 64;    // features per CTA
constexpr int kChunk = 64;   // k-chunk staged through shared memory
constexpr int kPad = 4;      // row padding of the tile slab (bank spread)
constexpr int kThreads = 256;

__device__ __forceinline__ void spmm_cta(
    const float* __restrict__ blocks, const int* __restrict__ cols,
    const float* __restrict__ mask, const float* __restrict__ h,
    float* __restrict__ out, int m, int f, int row_block, int row0,
    int feat0) {
  __shared__ __align__(16) float a_s[kRows][kChunk + kPad];
  __shared__ __align__(16) float b_s[kChunk][kFeat];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // feature lane: features tx + 16*j
  const int ty = tid / 16;  // row lane: rows ty + 16*i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < m; ++t) {
    const float w = mask[row_block * m + t];
    if (w == 0.0f) continue;  // ELL padding slot: all-zero tile
    const long long src0 = (long long)cols[row_block * m + t] * kBlock;
    const float* tile =
        blocks + ((long long)row_block * m + t) * kBlock * kBlock;

    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;

    for (int k0 = 0; k0 < kBlock; k0 += kChunk) {
      // Tile slab rows row0..row0+63, columns k0..k0+63 (float4 loads).
#pragma unroll
      for (int p = 0; p < (kRows * kChunk / 4) / kThreads; ++p) {
        const int q = tid + p * kThreads;
        const int r = q / (kChunk / 4);
        const int c4 = q % (kChunk / 4);
        const float4 v = *reinterpret_cast<const float4*>(
            tile + (long long)(row0 + r) * kBlock + k0 + 4 * c4);
        *reinterpret_cast<float4*>(&a_s[r][4 * c4]) = v;
      }
      // Source panel rows src0+k0..+63, features feat0..feat0+63.
#pragma unroll
      for (int p = 0; p < (kChunk * kFeat) / kThreads; ++p) {
        const int q = tid + p * kThreads;
        const int kk = q / kFeat;
        const int c = q % kFeat;
        const int col = feat0 + c;
        b_s[kk][c] =
            col < f ? h[(src0 + k0 + kk) * (long long)f + col] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(w, part[i][j], acc[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (long long)row_block * kBlock + row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = feat0 + tx + 16 * j;
      if (col < f) out[row * f + col] = acc[i][j];
    }
  }
}

// grid (1, 2 * ceil(F / 64), VB): y = feature chunk * 2 + row half.
__global__ void __launch_bounds__(kThreads)
block_spmm_kernel(const float* __restrict__ blocks,
                  const int* __restrict__ cols,
                  const float* __restrict__ mask,
                  const float* __restrict__ h, float* __restrict__ out, int m,
                  int f) {
  spmm_cta(blocks, cols, mask, h, out, m, f, blockIdx.z,
           (blockIdx.y % 2) * kRows, (blockIdx.y / 2) * kFeat);
}

// grid (B, 2 * ceil(F / 64), VB): x = batch element, fastest-varying so
// the CTAs that share a row-block's tiles run side by side.
__global__ void __launch_bounds__(kThreads)
block_spmm_batched_kernel(const float* __restrict__ blocks,
                          const int* __restrict__ cols,
                          const float* __restrict__ mask,
                          const float* __restrict__ h,
                          float* __restrict__ out, int m, int f,
                          long long h_stride, long long out_stride) {
  spmm_cta(blocks, cols, mask, h + blockIdx.x * h_stride,
           out + blockIdx.x * out_stride, m, f, blockIdx.z,
           (blockIdx.y % 2) * kRows, (blockIdx.y / 2) * kFeat);
}

}  // namespace

extern "C" {

// out f32[vb*128, f] = A @ h, h f32[src_rows, f]. Returns cudaGetLastError().
int block_spmm_launch(const float* blocks, const int* cols, const float* mask,
                      const float* h, float* out, int vb, int m, int f,
                      void* stream) {
  const dim3 grid(1, 2 * ((f + kFeat - 1) / kFeat), vb);
  block_spmm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      blocks, cols, mask, h, out, m, f);
  return (int)cudaGetLastError();
}

// out f32[b, vb*128, f] = A @ h[b], h f32[b, src_rows, f].
int block_spmm_batched_launch(const float* blocks, const int* cols,
                              const float* mask, const float* h, float* out,
                              int batch, int vb, int m, int f, int src_rows,
                              void* stream) {
  const dim3 grid(batch, 2 * ((f + kFeat - 1) / kFeat), vb);
  block_spmm_batched_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      blocks, cols, mask, h, out, m, f, (long long)src_rows * f,
      (long long)vb * kBlock * f);
  return (int)cudaGetLastError();
}

}  // extern "C"
