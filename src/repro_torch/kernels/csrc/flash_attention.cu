// Forward flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention (_flash_kernel), and through it gqa_flash
//   -> flash_attention_launch
//
// Computes, for every (batch b, query head h) and query row i,
//   o[b, i, h, :] = sum_j p_ij v[b, j, h / group, :] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = (q_i . k_j) * scale
// over the keys j that the mask keeps: j < T, and with `causal` j <= q_pos,
// and with `window` j > q_pos - window, where q_pos = q_offset + i. The
// running max, running sum and accumulator are f32 whatever the input type
// (f32 or bf16); the output takes the input type, rounded to nearest even.
// As in the reference, masked scores are -1e30 (not -inf) and their p is
// re-zeroed, so a row that a tile masks completely gives exp(0) = 1 in
// place of exp(-inf + inf) = NaN and then contributes 0; a row with no key
// at all ends as 0 / max(0, 1e-20) = 0.
//
// Layout: every tensor is read through (batch, position, head) element
// strides with a contiguous last (head_dim) axis, so the model layout
// [B, S, H, dh] is read in place (no transposes), and the GQA kv head is
// indexed as h / group (no repeated K/V copy). The [BH, S, dh] layout of
// `flash_attention` is the same with one head.
//
// What bounds it on an H100: the function needs 4 * dh operations per
// unmasked (query, key) pair per head, against reading q, k, v and writing
// o once. At the main path's shapes (B = 2, H = 16, S = T = 4096, dh = 64,
// causal, bf16) that is 0.0695 ms of bf16 tensor-core work (989 TFLOP/s)
// against 0.0100 ms of HBM traffic: the operations bound it. The bf16
// kernel below does 1.5 times that work on the tensor cores (P goes through
// the second product twice, see below) plus the softmax on the CUDA cores.
//
// Two kernels, dispatched by the input type:
//
// * bf16 -> flash_kernel_bf16, on the tensor cores. A CTA owns 64 * WG
//   query rows of one (b, h): WG consumer warpgroups of 64 rows each (three
//   at dh 32 and 64, two at dh 128 and 256, whose 64- and 128-float
//   accumulators need the registers) and one producer warpgroup, which
//   hands its registers to the consumers (setmaxnreg) and from one thread
//   brings Q once and then K and V tiles of 64 keys by TMA into a 3-stage
//   ring of 128B-swizzled shared memory (64B at dh 32; 2 stages at dh 256,
//   where Q is 64 KB and a stage 64 KB), with full / empty mbarriers. The 4-d tensor maps
//   run over (dh, head, position, batch), so the strided layout and the
//   GQA head h / group are read in place.
//   Each consumer warpgroup computes S = Q K^T with wgmma.m64n64k16 (bf16
//   in, f32 accumulators; Q and K K-major from shared memory), the online
//   softmax in f32 registers (a row's max and sum reduced over the 4 lanes
//   that hold it; p = exp2(s * scale * log2(e) - max), one FFMA and one
//   ex2.approx, relative error below 2^-22), and O += P V with P as the
//   register A operand (the f32 accumulator fragment is the bf16 A fragment
//   in place) and V the MN-major B operand (the transpose bit; at dh 256
//   as two products of 128 columns). P is split
//   into bf16 hi + lo (lo the bf16 of p - hi) and both go through the
//   product: P keeps about 16 bits, so the output stays within one bf16
//   rounding of the float64 answer as the reference's f32 products do (P in
//   bf16 alone moves the first rows' outputs by up to 2^-9 |v| and fails
//   that bar). The two products overlap: the group issues S of tile i and
//   P V of tile i - 1 together and runs tile i's softmax while P V runs.
//   Mask arithmetic runs only on tiles that straddle the causal diagonal,
//   the window edge or T; tiles the mask leaves empty for a group's rows
//   are skipped (alpha = 1, p = 0 would change nothing). The q-blocks with
//   the most visible keys are launched first. The epilogue stores
//   O / max(l, 1e-20) as bf16 (RN) from registers; rows >= S are never
//   stored.
// * f32 -> flash_kernel_f32 (f32 must stay IEEE f32: TF32 tensor cores would
//   round the inputs to 10 bits): one CTA of 256 threads (211 KB of shared
//   memory at dh 256) owns 64 query rows
//   of one head and keeps them in shared memory (pre-scaled) for the whole
//   pass; K and V stream through shared memory in 64-key tiles (K stored
//   transposed, so score reads are conflict-free). Each thread holds a 4 x 4
//   block of scores and a 4 x (dh / 16) block of the accumulator (64 floats
//   at dh 256) as f32 FMA
//   on the CUDA cores; the row max and row sum are reduced across the 16
//   threads of a row with warp shuffles; empty tiles are skipped.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;   // the reference's NEG_INF

// Element strides of the batch, position and head axes.
struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kRows = 64;     // query rows per CTA
constexpr int kCols = 64;     // keys per K/V tile
constexpr int kThreads = 256;

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * ((size_t)kRows * (D + 4) + (size_t)D * (kCols + 1) +
                          (size_t)kCols * D + (size_t)kRows * (kCols + 4));
}

// Max / sum over the 16 lanes of one row (lanes 0-15 or 16-31 of a warp).
// The xor butterfly leaves the same value in every lane of the group.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (ceil(S / 64), batch * heads); dynamic shared memory
// smem_bytes_f32<D>().
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os, int heads,
                 int group, int s_len, int t_len, float scale, int causal,
                 int window, int q_offset) {
  constexpr int QP = D + 4;       // q_s row stride (rows 16 apart: banks +4)
  constexpr int KP = kCols + 1;   // k_s[d][key], transposed
  constexpr int PP = kCols + 4;   // p_s row stride
  constexpr int NJ = D / 16;      // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [kRows][QP]
  float* k_s = q_s + kRows * QP;       // [D][KP]
  float* v_s = k_s + D * KP;           // [kCols][D]
  float* p_s = v_s + kCols * D;        // [kRows][PP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // key / feature lane
  const int ty = tid / 16;   // row lane: rows ty + 16 * i
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int row0 = blockIdx.x * kRows;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (long long)(h / group) * ks.h;
  const float* vb = v + b * vs.b + (long long)(h / group) * vs.h;
  float* ob = o + b * os.b + h * os.h;

  // Q block, scaled in f32 as the reference does; rows past S are zeros
  // (computed like any row, never stored).
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    q_s[r * QP + d] = row < s_len ? qb[(long long)row * qs.s + d] * scale
                                  : 0.0f;
  }

  // Keys any of this block's rows can see: [k_lo, k_hi).
  const int q_first = q_offset + row0;
  const int q_last = q_offset + min(row0 + kRows, s_len) - 1;
  const int k_lo = window ? max(0, q_first - window + 1) : 0;
  const int k_hi = causal ? min(t_len, q_last + 1) : t_len;

  float acc[4][NJ];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int t0 = (k_lo / kCols) * kCols; t0 < k_hi; t0 += kCols) {
    __syncthreads();   // previous tile's k_s / v_s / p_s fully read
    for (int e = tid; e < kCols * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int key = t0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (key < t_len) {
        kv = kb[(long long)key * ks.s + d];
        vv = vb[(long long)key * vs.s + d];
      }
      k_s[d * KP + c] = kv;
      v_s[c * D + d] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = k_s[d * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q_offset + row0 + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + tx + 16 * j;
        ok[j] = key < t_len && (!causal || key <= q_pos) &&
                (!window || key > q_pos - window);
        if (!ok[j]) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        p_s[r * PP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + row_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kCols; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = v_s[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l_i[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[(long long)row * os.s + tx + 16 * j] = acc[i][j] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, int batch,
               int heads, int group, int s_len, int t_len, float scale,
               int causal, int window, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_len + kRows - 1) / kRows, batch * heads);
  flash_kernel_f32<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, qs, ks,
      vs, os, heads, group, s_len, t_len, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel fed by TMA
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// Tiling and shared-memory geometry for head dim D. The head dim is cut
// into chunks of at most 64 columns (128 bytes, one swizzle span); a tile
// is stored chunk by chunk, each chunk [rows][CH] in the TMA's swizzled
// order.
template <int D>
struct Geo {
  // Three consumer warpgroups (192 rows share each K / V tile) where 160
  // registers a thread hold a group's state; two of 240 at dh 128 and 256.
  // At dh 256 a K/V stage is 64 KB and Q 64 KB: two stages fit the 227 KB.
  static constexpr int WG = D >= 128 ? 2 : 3;           // consumer warpgroups
  static constexpr int BN = 64;                         // keys per K/V tile
  static constexpr int STAGES = D == 256 ? 2 : 3;       // K/V ring depth
  static constexpr int BM = 64 * WG;                    // query rows per CTA
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 128;       // + producer group
  // Registers a thread, after the producer hands its own to the consumers
  // (every SM sub-partition holds one warp of each warpgroup: 512 a lane).
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = (512 - PRODUCER_REGS) / WG / 8 * 8;
  static constexpr int CH = D < 64 ? D : 64;            // columns per chunk
  static constexpr int NCH = D / CH;                    // chunks
  static constexpr int ROW = CH * 2;                    // bytes per row
  static constexpr int ATOM = 8 * ROW;                  // 8-row swizzle atom
  static constexpr int SWZ = ROW == 128 ? 1 : 2;        // wgmma: 128B / 64B
  static constexpr int Q_CHUNK = BM * ROW;
  static constexpr int KV_CHUNK = BN * ROW;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int STAGE_BYTES = 2 * NCH * KV_CHUNK;   // K then V
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; its bytes count against the barrier's expected transactions.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swz << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running (groups finish
// in commit order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins accumulator registers in place around the asynchronous products:
// no read or write of them moves across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N], A and B K-major in shared
// memory; scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] . B[16 x N], A from registers, B MN-major (the
// transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two bf16 in one register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// One warpgroup's running softmax state for its two rows per thread.
struct RowState {
  float m0, m1;   // running max of rows r0 and r0 + 8, scaled to log2
  float l0, l1;   // this thread's share of the running sums
};

// Online softmax of one score tile in place. The row max is taken over the
// raw scores (scale > 0 keeps the order) and p = 2^(s * scale * log2(e) -
// max) is one FFMA and one ex2. EDGE tiles (those straddling the causal
// diagonal, the window edge or T) first set masked scores to -1e30 and
// re-zero their p. Leaves p in `s`; returns the factors that rescale the
// accumulator rows.
template <int BN, bool EDGE>
__device__ __forceinline__ void online_softmax(float* s, RowState& st,
                                               float& alpha0, float& alpha1,
                                               float scale_log2, int t0,
                                               int cq, int qp0, int t_len,
                                               int causal, int window) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (EDGE) {
        const int key = t0 + 8 * j + cq + (e & 1);
        const int qp = qp0 + (e < 2 ? 0 : 8);
        if (key >= t_len || (causal && key > qp) ||
            (window && key <= qp - window))
          s[4 * j + e] = kNegInf;
      }
      if (e < 2)
        mx0 = fmaxf(mx0, s[4 * j + e]);
      else
        mx1 = fmaxf(mx1, s[4 * j + e]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(st.m0, mx0 * scale_log2);
  const float mn1 = fmaxf(st.m1, mx1 * scale_log2);
  alpha0 = ex2(st.m0 - mn0);
  alpha1 = ex2(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      float p = ex2(fmaf(x, scale_log2, -(e < 2 ? mn0 : mn1)));
      if (EDGE && x == kNegInf) p = 0.0f;
      s[4 * j + e] = p;
      if (e < 2)
        sum0 += p;
      else
        sum1 += p;
    }
  st.l0 = st.l0 * alpha0 + sum0;
  st.l1 = st.l1 * alpha1 + sum1;
}

// p -> bf16 hi + lo A fragments, in place: register i holds entries 2 i and
// 2 i + 1 (row r0 + 8 (i % 2), two adjacent keys); hi is p rounded to
// bf16, lo the bf16 of what hi leaves out.
template <int BN>
__device__ __forceinline__ void split_p(const float* s, uint32_t* hi,
                                        uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(s[2 * i] - hf.x, s[2 * i + 1] - hf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// S = Q K^T for one tile, issued and committed (not waited for): D / 16
// k-steps, each 32 bytes further along the swizzled rows.
template <int D>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_addr,
                                         uint32_t k_addr) {
  using G = Geo<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / G::CH, off = (kk * 16 % G::CH) * 2;
    wgmma_ss<G::BN>(
        s, make_desc(q_addr + c * G::Q_CHUNK + off, 16, G::ATOM, G::SWZ),
        make_desc(k_addr + c * G::KV_CHUNK + off, 16, G::ATOM, G::SWZ),
        kk > 0);
  }
  wgmma_commit();
}

// O = O * alpha (per row), then O += P_hi V + P_lo V issued and committed:
// BN / 16 k-steps of 16 keys, V the MN-major operand. Head dims above 128
// run as products of N = 128 columns (two swizzle chunks each): the
// accumulator fragment of columns 128 h .. 128 h + 127 is entries 64 h ..
// 64 h + 63, as in one N = D fragment.
template <int D>
__device__ __forceinline__ void issue_pv(float* acc, float alpha0,
                                         float alpha1, const uint32_t* hi,
                                         const uint32_t* lo,
                                         uint32_t v_addr) {
  using G = Geo<D>;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j + 0] *= alpha0;
    acc[4 * j + 1] *= alpha0;
    acc[4 * j + 2] *= alpha1;
    acc[4 * j + 3] *= alpha1;
  }
  constexpr int N = D < 128 ? D : 128;   // columns a product
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < G::BN / 16; ++kk)
#pragma unroll
    for (int nh = 0; nh < D / N; ++nh) {
      const uint64_t dv = make_desc(
          v_addr + nh * (N / G::CH) * G::KV_CHUNK + kk * 16 * G::ROW,
          G::KV_CHUNK, G::ATOM, G::SWZ);
      wgmma_rs<N>(acc + nh * N / 2, hi + 4 * kk, dv);
      wgmma_rs<N>(acc + nh * N / 2, lo + 4 * kk, dv);
    }
  wgmma_commit();
}

// What a CTA works on: one 64 * WG-row q-block of one (b, h) and the key
// tiles t_start + i * BN, i < n_tiles, that any of its rows can see.
struct Block {
  int b, h, row0, t_start, n_tiles;
};

// The producer: Q once, then the K / V ring (one thread).
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const Block& blk, int group,
                                        uint8_t* q_s, uint8_t* ring,
                                        uint64_t* q_full, uint64_t* full,
                                        uint64_t* empty) {
  using G = Geo<D>;
  mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
  for (int c = 0; c < G::NCH; ++c)
    tma_load_4d(q_s + c * G::Q_CHUNK, tm_q, q_full, c * G::CH, blk.h,
                blk.row0, blk.b);
  const int hk = blk.h / group;
  for (int i = 0; i < blk.n_tiles; ++i) {
    const int st = i % G::STAGES;
    mbar_wait(&empty[st], ((i / G::STAGES) & 1) ^ 1);
    uint8_t* k_s = ring + st * G::STAGE_BYTES;
    uint8_t* v_s = k_s + G::NCH * G::KV_CHUNK;
    const int t0 = blk.t_start + i * G::BN;
    mbar_expect_tx(&full[st], G::STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < G::NCH; ++c) {
      tma_load_4d(k_s + c * G::KV_CHUNK, tm_k, &full[st], c * G::CH, hk, t0,
                  blk.b);
      tma_load_4d(v_s + c * G::KV_CHUNK, tm_v, &full[st], c * G::CH, hk, t0,
                  blk.b);
    }
  }
}

// A consumer warpgroup: rows r_lo .. r_lo + 63 of the q-block. It sees
// tiles [a, z) of the block's (the causal and window limits of its own
// rows) and waits for and releases the others untouched. It overlaps its
// two products: while the tensor cores run S = Q K^T of tile i and
// O += P V of tile i - 1, it waits for S only, runs the softmax of tile i,
// then waits for P V and releases tile i - 1's stage.
template <int D>
__device__ __forceinline__ void consume(const Block& blk, int wg,
                                        __nv_bfloat16* o, Strides os,
                                        int s_len, int t_len,
                                        float scale_log2, int causal,
                                        int window, int q_offset,
                                        const uint8_t* q_s,
                                        const uint8_t* ring,
                                        uint64_t* q_full, uint64_t* full,
                                        uint64_t* empty) {
  using G = Geo<D>;
  constexpr int BN = G::BN, STAGES = G::STAGES;
  const int lane = threadIdx.x % 32;
  const int r_lo = blk.row0 + wg * 64;
  const int qw_first = q_offset + r_lo;
  const int qw_last = q_offset + min(r_lo + 64, s_len) - 1;
  const int kw_lo = window ? max(0, qw_first - window + 1) : 0;
  const int kw_hi = r_lo >= s_len ? 0 : causal ? min(t_len, qw_last + 1)
                                               : t_len;
  const int n_tiles = blk.n_tiles, t_start = blk.t_start;
  const int a = min(n_tiles, (kw_lo - t_start) / BN);
  const int z = max(a, min(n_tiles, (kw_hi - t_start + BN - 1) / BN));
  const int r0 = (threadIdx.x / 32 % 4) * 16 + lane / 4;
  const int qp0 = qw_first + r0;
  const int cq = 2 * (lane % 4);

  auto wait_full = [&](int i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
  };
  auto k_addr = [&](int i) {
    return smem_u32(ring + (i % STAGES) * G::STAGE_BYTES);
  };
  auto v_addr = [&](int i) { return k_addr(i) + G::NCH * G::KV_CHUNK; };
  RowState rs{kNegInf, kNegInf, 0.0f, 0.0f};
  auto softmax = [&](float* s, float& alpha0, float& alpha1, int i) {
    const int t0 = t_start + i * BN;
    if ((causal && t0 + BN - 1 > qw_first) ||
        (window && t0 <= qw_last - window) || t0 + BN > t_len)
      online_softmax<BN, true>(s, rs, alpha0, alpha1, scale_log2, t0, cq,
                               qp0, t_len, causal, window);
    else
      online_softmax<BN, false>(s, rs, alpha0, alpha1, scale_log2, t0, cq,
                                qp0, t_len, causal, window);
  };

  auto skip = [&](int i) {
    wait_full(i);
    release(i);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * G::ROW;

  mbar_wait(q_full, 0);
  for (int i = 0; i < a; ++i) skip(i);
  if (a < z) {
    float s[BN / 2];
    uint32_t hi[BN / 4], lo[BN / 4];
    float alpha0, alpha1;
    wait_full(a);
    issue_qk<D>(s, q_addr, k_addr(a));
    wgmma_wait<0>();
    fence_regs<BN / 2>(s);
    softmax(s, alpha0, alpha1, a);
    split_p<BN>(s, hi, lo);
    for (int i = a + 1; i < z; ++i) {
      wait_full(i);
      issue_qk<D>(s, q_addr, k_addr(i));
      issue_pv<D>(acc, alpha0, alpha1, hi, lo, v_addr(i - 1));
      wgmma_wait<1>();   // S of tile i is ready; P V may still run
      fence_regs<BN / 2>(s);
      softmax(s, alpha0, alpha1, i);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      release(i - 1);
      split_p<BN>(s, hi, lo);
    }
    issue_pv<D>(acc, alpha0, alpha1, hi, lo, v_addr(z - 1));
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);
    release(z - 1);
  }
  for (int i = z; i < n_tiles; ++i) skip(i);

  // Epilogue: the row sums over the 4 lanes of a row, then O / l in bf16.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs.l0 += __shfl_xor_sync(0xffffffffu, rs.l0, off);
    rs.l1 += __shfl_xor_sync(0xffffffffu, rs.l1, off);
  }
  const float d0 = fmaxf(rs.l0, 1e-20f), d1 = fmaxf(rs.l1, 1e-20f);
  const int g0 = r_lo + r0, g1 = g0 + 8;
  __nv_bfloat16* ob = o + blk.b * os.b + blk.h * os.h + cq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (g0 < s_len)
      *reinterpret_cast<uint32_t*>(ob + (long long)g0 * os.s + 8 * j) =
          pack_bf16(__float2bfloat16_rn(acc[4 * j] / d0),
                    __float2bfloat16_rn(acc[4 * j + 1] / d0));
    if (g1 < s_len)
      *reinterpret_cast<uint32_t*>(ob + (long long)g1 * os.s + 8 * j) =
          pack_bf16(__float2bfloat16_rn(acc[4 * j + 2] / d1),
                    __float2bfloat16_rn(acc[4 * j + 3] / d1));
  }
}

// grid (batch * heads, ceil(S / BM)); Geo<D>::THREADS threads: warpgroups
// 0 .. WG - 1 consume (64 rows each), the last one produces (one thread
// issues the TMA loads; the warpgroup hands its registers to the
// consumers); dynamic shared memory Geo<D>::SMEM.
//
// Register fragments (wgmma's accumulator layout): in a warpgroup, warp w
// and lane l hold rows r0 = 16 w + l / 4 and r0 + 8 of its 64; entry
// 4 j + e sits in row r0 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2. The
// bf16 A fragment of a k-step of 16 keys is four registers holding the
// pairs (r0, 16 kk + ..), (r0 + 8, ..), (r0, 16 kk + 8 + ..),
// (r0 + 8, ..): entries 8 kk .. 8 kk + 7 of the score fragment, in place.
template <int D>
__global__ void __launch_bounds__(Geo<D>::THREADS, 1)
flash_kernel_bf16(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, Strides os, int heads,
                  int group, int s_len, int t_len, float scale_log2,
                  int causal, int window, int q_offset) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[G::STAGES], empty[G::STAGES];
  // TMA's 128B swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = q_s + G::Q_BYTES;

  Block blk;
  blk.b = blockIdx.x / heads;
  blk.h = blockIdx.x % heads;
  blk.row0 = (gridDim.y - 1 - blockIdx.y) * G::BM;   // heaviest first
  const int q_first = q_offset + blk.row0;
  const int q_last = q_offset + min(blk.row0 + G::BM, s_len) - 1;
  const int k_lo = window ? max(0, q_first - window + 1) : 0;
  const int k_hi = causal ? min(t_len, q_last + 1) : t_len;
  blk.t_start = (k_lo / G::BN) * G::BN;
  blk.n_tiles =
      k_hi > blk.t_start ? (k_hi - blk.t_start + G::BN - 1) / G::BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int i = 0; i < G::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], G::CONSUMERS / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == G::WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        G::PRODUCER_REGS));
    if (threadIdx.x == G::CONSUMERS)
      produce<D>(&tm_q, &tm_k, &tm_v, blk, group, q_s, ring, &q_full, full,
                 empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        G::CONSUMER_REGS));
    consume<D>(blk, wg, o, os, s_len, t_len, scale_log2, causal, window,
               q_offset, q_s, ring, &q_full, full, empty);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// so that the library builds without -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map over (dh, head, position, batch) of a bf16 tensor with element
// strides `st`, whose box is `rows` positions of one head, `ch` columns
// wide, swizzled as the wgmma descriptors expect.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d,
              int heads, int len, int batch, Strides st, int rows, int ch) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)ch, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                ch == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                Strides qs, Strides ks, Strides vs, Strides os, int batch,
                int heads, int group, int s_len, int t_len, float scale,
                int causal, int window, int q_offset, cudaStream_t stream) {
  using G = Geo<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  const int kv_heads = heads / group;
  if (!make_map(encode, &mq, q, D, heads, s_len, batch, qs, G::BM, G::CH) ||
      !make_map(encode, &mk, k, D, kv_heads, t_len, batch, ks, G::BN,
                G::CH) ||
      !make_map(encode, &mv, v, D, kv_heads, t_len, batch, vs, G::BN, G::CH))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (s_len + G::BM - 1) / G::BM);
  flash_kernel_bf16<D><<<grid, G::THREADS, G::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, os, heads, group, s_len, t_len,
      scale * kLog2e, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype_code, const void* q, const void* k, const void* v,
           void* o, Strides qs, Strides ks, Strides vs, Strides os,
           int batch, int heads, int group, int s_len, int t_len, float scale,
           int causal, int window, int q_offset, cudaStream_t stream) {
  if (dtype_code == 0)
    return launch_f32<D>(q, k, v, o, qs, ks, vs, os, batch, heads, group,
                         s_len, t_len, scale, causal, window, q_offset,
                         stream);
  if (dtype_code == 1)
    return launch_bf16<D>(q, k, v, o, qs, ks, vs, os, batch, heads, group,
                          s_len, t_len, scale, causal, window, q_offset,
                          stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o[b, i, h, :] = attention of q[b, i, h, :] over k/v[b, :, h / group, :].
// Pointers address element (0, 0, 0, 0); st holds the element strides
// (batch, position, head) of q, k, v and o in that order (12 values); the
// head_dim axis is contiguous. dtype_code: 0 = float32, 1 = bfloat16 (all
// four tensors; bf16 pointers 16-byte aligned and strides multiples of 8
// elements, as TMA needs). head_dim 32, 64, 128 or 256. Returns a
// cudaError_t code.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* st, int dtype_code,
                           int head_dim, int batch, int heads, int group,
                           int s_len, int t_len, float scale, int causal,
                           int window, int q_offset, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 32:
      return launch<32>(dtype_code, q, k, v, o, qs, ks, vs, os, batch, heads,
                        group, s_len, t_len, scale, causal, window, q_offset,
                        s);
    case 64:
      return launch<64>(dtype_code, q, k, v, o, qs, ks, vs, os, batch, heads,
                        group, s_len, t_len, scale, causal, window, q_offset,
                        s);
    case 128:
      return launch<128>(dtype_code, q, k, v, o, qs, ks, vs, os, batch,
                         heads, group, s_len, t_len, scale, causal, window,
                         q_offset, s);
    case 256:
      return launch<256>(dtype_code, q, k, v, o, qs, ks, vs, os, batch,
                         heads, group, s_len, t_len, scale, causal, window,
                         q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
