// Block-CSR (ELL-over-blocks) neighbour aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/gather_aggregate.py and
// src/repro/kernels/daq_dequant.py:
//   block_spmm            (_spmm_kernel)                 -> block_spmm_launch
//   block_spmm_batched    (_spmm_batched_kernel)         -> block_spmm_batched_launch
//   dequant_spmm          (_dequant_spmm_kernel)         -> dequant_spmm_launch
//   dequant_spmm_batched  (_dequant_spmm_batched_kernel) -> dequant_spmm_batched_launch
//
// All four compute, for every row-block i (and every batch element b),
//   out[b, i*128 + r, f] = sum_m mask[i, m] * sum_k blocks[i, m, r, k]
//                                          * h[b, cols[i, m]*128 + k, f]
// with the layout contract of build_block_csr: M tile slots per row-block,
// padding slots carry mask 0 and an all-zero tile, so they are skipped here.
// The dequant kernels read no f32 table h: they read uint8/16/32 codes and
// one f32 (scale, min) pair per source row, and build each source panel as
//   h[row, f] = codes[row, f] * scale[row] + min[row]
// while staging it into shared memory, so the dense table never exists in
// device memory. The product and the sum are rounded apart (__fmul_rn,
// __fadd_rn: no FMA contraction), as the plain version rounds them, so the
// staged panel is bitwise the plain version's dequantized table and the
// kernels differ from it only in the order of accumulation. A zero-padded
// source row (code 0, scale 0, min 0) stages as exact zeros.
//
// What bounds it on an H100: the adjacency tiles. Every real tile is a dense
// 128x128 f32 matrix (64 KB) that must be read once from device memory
// (3.35 TB/s); the source panels (f32, or 1-4 byte codes) and the output
// are small beside them. The function needs only one FMA per nonzero tile
// entry per feature, and the graph fills well under 1% of the tile
// entries, so its floor is the tile bytes. This dense design, though, does 2*128*128*F flops per tile in f32
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
// result is deterministic. One CTA body serves all four entry points; only
// its panel loader differs (dense f32 or dequantized codes). A batched
// launch runs that body per batch element (blockIdx.x), which makes out[b]
// bitwise equal to the serial kernel on h[b] (the dequant entry points
// launch one kernel, the serial one with B = 1); batch-adjacent CTAs read
// the same tiles, which then come from L2. The mesh executor folds its shard axis into the
// row-block axis (VB = shards x row-blocks per shard): row-blocks are
// independent, so that is bitwise one launch per shard. The ragged feature
// edge is masked in the kernel, so any F works. Skipping the zero entries
// (a sparse-aware format) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // adjacency tile edge (block-CSR block size)
constexpr int kRows = 64;    // output rows per CTA
constexpr int kFeat = 64;    // features per CTA
constexpr int kChunk = 64;   // k-chunk staged through shared memory
constexpr int kPad = 4;      // row padding of the tile slab (bank spread)
constexpr int kThreads = 256;

// Panel loaders: the source value at (row, col) of one batch element's
// table, for col < f. Sources are read-only for a launch, so every load
// takes the read-only data cache (__ldg), whatever the compiler can prove
// about aliasing through the struct.
struct DensePanel {
  const float* h;
  int f;
  __device__ __forceinline__ float operator()(long long row, int col) const {
    return __ldg(h + row * f + col);
  }
};

template <typename Code>
struct DequantPanel {
  const Code* codes;
  const float* scales;
  const float* mins;
  int f;
  __device__ __forceinline__ float operator()(long long row, int col) const {
    return __fadd_rn(__fmul_rn((float)__ldg(codes + row * f + col),
                               __ldg(scales + row)),
                     __ldg(mins + row));
  }
};

template <class Panel>
__device__ __forceinline__ void spmm_cta(
    const float* __restrict__ blocks, const int* __restrict__ cols,
    const float* __restrict__ mask, const Panel panel,
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
        b_s[kk][c] = col < f ? panel(src0 + k0 + kk, col) : 0.0f;
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

// grid (1, 2 * ceil(F / 64), VB): y = feature chunk * 2 + row half,
// z = row-block.
__global__ void __launch_bounds__(kThreads)
block_spmm_kernel(const float* __restrict__ blocks,
                  const int* __restrict__ cols,
                  const float* __restrict__ mask,
                  const float* __restrict__ h, float* __restrict__ out, int m,
                  int f) {
  spmm_cta(blocks, cols, mask, DensePanel{h, f}, out, m, f, blockIdx.z,
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
  const DensePanel panel{h + blockIdx.x * h_stride, f};
  spmm_cta(blocks, cols, mask, panel, out + blockIdx.x * out_stride, m, f,
           blockIdx.z, (blockIdx.y % 2) * kRows, (blockIdx.y / 2) * kFeat);
}

// The batched grid (B = 1 for a serial launch); codes[b] is
// [src_rows, f], scales[b] / mins[b] [src_rows].
template <typename Code>
__global__ void __launch_bounds__(kThreads)
dequant_spmm_kernel(const float* __restrict__ blocks,
                    const int* __restrict__ cols,
                    const float* __restrict__ mask,
                    const Code* __restrict__ codes,
                    const float* __restrict__ scales,
                    const float* __restrict__ mins, float* __restrict__ out,
                    int m, int f, long long src_rows, long long out_stride) {
  const long long b = blockIdx.x;
  const DequantPanel<Code> panel{codes + b * src_rows * f,
                                 scales + b * src_rows, mins + b * src_rows,
                                 f};
  spmm_cta(blocks, cols, mask, panel, out + b * out_stride, m, f, blockIdx.z,
           (blockIdx.y % 2) * kRows, (blockIdx.y / 2) * kFeat);
}

dim3 grid_of(int batch, int vb, int f) {
  return dim3(batch, 2 * ((f + kFeat - 1) / kFeat), vb);
}

int dequant_spmm(const float* blocks, const int* cols, const float* mask,
                 const void* codes, const float* scales, const float* mins,
                 float* out, int batch, int vb, int m, int f, int src_rows,
                 int code_bytes, void* stream) {
  const dim3 grid = grid_of(batch, vb, f);
  const long long out_stride = (long long)vb * kBlock * f;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bytes) {
    case 1:
      dequant_spmm_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
          blocks, cols, mask, (const uint8_t*)codes, scales, mins, out, m, f,
          src_rows, out_stride);
      break;
    case 2:
      dequant_spmm_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
          blocks, cols, mask, (const uint16_t*)codes, scales, mins, out, m,
          f, src_rows, out_stride);
      break;
    case 4:
      dequant_spmm_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
          blocks, cols, mask, (const uint32_t*)codes, scales, mins, out, m,
          f, src_rows, out_stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out f32[vb*128, f] = A @ h, h f32[src_rows, f]. Returns cudaGetLastError().
int block_spmm_launch(const float* blocks, const int* cols, const float* mask,
                      const float* h, float* out, int vb, int m, int f,
                      void* stream) {
  block_spmm_kernel<<<grid_of(1, vb, f), kThreads, 0,
                      (cudaStream_t)stream>>>(blocks, cols, mask, h, out, m,
                                              f);
  return (int)cudaGetLastError();
}

// out f32[b, vb*128, f] = A @ h[b], h f32[b, src_rows, f].
int block_spmm_batched_launch(const float* blocks, const int* cols,
                              const float* mask, const float* h, float* out,
                              int batch, int vb, int m, int f, int src_rows,
                              void* stream) {
  block_spmm_batched_kernel<<<grid_of(batch, vb, f), kThreads, 0,
                              (cudaStream_t)stream>>>(
      blocks, cols, mask, h, out, m, f, (long long)src_rows * f,
      (long long)vb * kBlock * f);
  return (int)cudaGetLastError();
}

// out f32[vb*128, f] = A @ (codes * scales[:, None] + mins[:, None]),
// codes uint{8,16,32}[src_rows, f] (code_bytes 1, 2 or 4).
int dequant_spmm_launch(const float* blocks, const int* cols,
                        const float* mask, const void* codes,
                        const float* scales, const float* mins, float* out,
                        int vb, int m, int f, int src_rows, int code_bytes,
                        void* stream) {
  return dequant_spmm(blocks, cols, mask, codes, scales, mins, out, 1, vb, m,
                      f, src_rows, code_bytes, stream);
}

// out f32[b, vb*128, f] = A @ dequant(codes[b]), codes [b, src_rows, f],
// scales / mins f32[b, src_rows].
int dequant_spmm_batched_launch(const float* blocks, const int* cols,
                                const float* mask, const void* codes,
                                const float* scales, const float* mins,
                                float* out, int batch, int vb, int m, int f,
                                int src_rows, int code_bytes, void* stream) {
  return dequant_spmm(blocks, cols, mask, codes, scales, mins, out, batch,
                      vb, m, f, src_rows, code_bytes, stream);
}

}  // extern "C"
