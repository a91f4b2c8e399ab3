// Forward flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention (_flash_kernel), and through it gqa_flash
//   -> flash_attention_launch
//
// Computes, for every (batch b, query head h) and query row i,
//   o[b, i, h, :] = sum_j p_ij v[b, j, h / group, :] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = (q_i * scale) . k_j
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
// o once. At the main path's shapes (S = T = 4096, dh = 64, causal) that is
// about 128 operations per byte read, so a tensor-core kernel would be held
// by its operations; this first kernel does the arithmetic as f32 FMA on
// the CUDA cores (67 TFLOP/s peak), far below the bf16 tensor-core rate.
//
// What the design does about it: one CTA of 256 threads owns 64 query rows
// of one head and keeps them in shared memory (pre-scaled, f32) for the
// whole pass; K and V stream through shared memory in 64-key tiles (K
// stored transposed, so score reads are conflict-free). Each thread holds a
// 4 x 4 block of scores and a 4 x (dh / 16) block of the accumulator in
// registers; the row max and row sum are reduced across the 16 threads of
// a row with warp shuffles. Tiles that the causal or window mask leaves
// empty for all 64 rows are skipped (the skipped tiles would change
// nothing: alpha = 1, p = 0). Tensor cores (wgmma), TMA and a K/V ring are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows per CTA
constexpr int kCols = 64;     // keys per K/V tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1.0e30f;   // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element strides of the batch, position and head axes.
struct Strides {
  long long b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {
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

// grid (ceil(S / 64), batch * heads); dynamic shared memory smem_bytes<D>().
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides qs,
             Strides ks, Strides vs, Strides os, int heads, int group,
             int s_len, int t_len, float scale, int causal, int window,
             int q_offset) {
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (long long)(h / group) * ks.h;
  const T* vb = v + b * vs.b + (long long)(h / group) * vs.h;
  T* ob = o + b * os.b + h * os.h;

  // Q block, scaled in f32 as the reference does; rows past S are zeros
  // (computed like any row, never stored).
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    q_s[r * QP + d] =
        row < s_len ? to_f32(qb[(long long)row * qs.s + d]) * scale : 0.0f;
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
        kv = to_f32(kb[(long long)key * ks.s + d]);
        vv = to_f32(vb[(long long)key * vs.s + d]);
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
      ob[(long long)row * os.s + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int batch, int heads,
           int group, int s_len, int t_len, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_len + kRows - 1) / kRows, batch * heads);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, qs, ks, vs, os, heads,
      group, s_len, t_len, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                 void* o, Strides qs, Strides ks, Strides vs, Strides os,
                 int batch, int heads, int group, int s_len, int t_len,
                 float scale, int causal, int window, int q_offset,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, qs, ks, vs, os, batch, heads, group,
                           s_len, t_len, scale, causal, window, q_offset,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, qs, ks, vs, os, batch, heads, group,
                           s_len, t_len, scale, causal, window, q_offset,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, qs, ks, vs, os, batch, heads, group,
                            s_len, t_len, scale, causal, window, q_offset,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o[b, i, h, :] = attention of q[b, i, h, :] over k/v[b, :, h / group, :].
// Pointers address element (0, 0, 0, 0); st holds the element strides
// (batch, position, head) of q, k, v and o in that order (12 values); the
// head_dim axis is contiguous. dtype_code: 0 = float32, 1 = bfloat16 (all
// four tensors). head_dim 32, 64 or 128. Returns a cudaError_t code.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* st, int dtype_code,
                           int head_dim, int batch, int heads, int group,
                           int s_len, int t_len, float scale, int causal,
                           int window, int q_offset, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0)
    return dispatch_dim<float>(head_dim, q, k, v, o, qs, ks, vs, os, batch,
                               heads, group, s_len, t_len, scale, causal,
                               window, q_offset, s);
  if (dtype_code == 1)
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, o, qs, ks, vs, os,
                                       batch, heads, group, s_len, t_len,
                                       scale, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
