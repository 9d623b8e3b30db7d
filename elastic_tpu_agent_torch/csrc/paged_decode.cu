// Paged-attention decode for Hopper (sm_90a), split over blocks.
//
// Replaces: elastic_tpu_agent/workloads/paged_attention.py `_paged_kernel`
// (launched by `paged_decode_attention`), the Pallas TPU kernel.
//
// What it computes: one decode query per slot against one layer's paged KV
// pool [n_blocks, bs, g, h]. The r = n / g query heads of a group share
// their kv head. A slot's logical block j lives at physical block
// table[slot, j]; positions p < len (and, with a window, len - 1 - p <
// window) are attended. The softmax runs online in f32, with no rounding
// of p: q, k and v are widened to f32 and every product and sum stays f32,
// as in the TPU kernel. The output is acc / max(l, 1e-30), rounded once.
// A row of length 0 attends nothing; the TPU kernel then sees every score
// at NEG_INF, so m stays NEG_INF, every p is exp(0) = 1 and it returns the
// mean of V over all nb * bs positions of the row's table. This kernel
// gives the same: such a row (and only such a row) reads its whole table,
// with every score taken as equal.
//
// Bound on this card: decode attention does ~4 flops per K/V byte pair it
// reads, far below the ~295 flop/byte where bf16 compute would matter, so
// it is bound by bytes: the K/V positions a slot attends. Each attended
// pool row is read exactly once, straight from its block through the
// table (no gathered copy); masked positions are never loaded (their
// registers hold zeros), so the junk block 0 and stale pool entries, even
// non-finite ones, cannot reach the output. At serving sizes (8 MB) the
// time is mostly the launch and one chain of dependent loads (length,
// table, K/V, partials), so the design keeps that chain short.
//
// Design (flash-decoding): the grid is (slots, g, splits). The attended
// blocks of a slot, from the window's first block to ceil(len / bs), are
// cut into `splits` contiguous ranges, one per CTA, so that the launch
// fills the card's SMs (the wrapper picks `splits` from the table width,
// `paged_splits` in paged_attention.py; `paged_split_ranges` there is the
// same cut in Python). A CTA reads its table range into shared memory once
// and spreads the range's positions over groups of lanes: one group of
// H * sizeof(T) / 16 lanes holds one K or V row with one 16-byte load per
// lane, and each group loads U positions' rows before it uses any, so many
// loads are in flight. Each group keeps its own online softmax (m, l and
// its slice of acc for each query head) in registers; the scores reduce
// over the group's lanes by shuffles. At the end the groups merge by warp
// shuffles, the warps through shared memory once, and the CTA writes its
// partial (m, l, acc) in f32. The last CTA of a (slot, kv head) to finish
// (an atomic counter per (slot, kv head), which that CTA sets back to 0
// for the next call on the stream) merges the splits: each partial
// rescaled by exp(m_i - m), then divided by max(l, 1e-30). So one launch
// does the whole call. With one split the CTA writes the output itself.
// Scores are kept in log2 units (scale * log2 e in one multiply) for the
// SFU's exp2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = 16;          // query heads per kv head
constexpr int MAX_BS = 64;         // pool block size
constexpr int MAX_SPLIT_BLOCKS = 1024;  // table entries one CTA holds
constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte load as f32: 8 bf16 or 4 f32 values
__device__ __forceinline__ void widen(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float* out,
                                      __nv_bfloat16) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 2^x by the SFU (ex2.approx, subnormal results flushed to 0); exact at
// 0, 0 at NEG_INF
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (m, l, acc) of one stream merged with another's: both rescaled to the
// larger max. Empty streams carry (NEG_INF, 0, 0) and add nothing.
__device__ __forceinline__ void merge_into(float& m, float& l, float* acc,
                                           float m2, float l2,
                                           const float* acc2, int n) {
  const float mx = fmaxf(m, m2);
  const float a = exp2_approx(m - mx), b = exp2_approx(m2 - mx);
  l = l * a + l2 * b;
  for (int e = 0; e < n; ++e) acc[e] = acc[e] * a + acc2[e] * b;
  m = mx;
}

// The range of logical blocks [b0, b1) that split `split` of `splits`
// covers, and the attended positions [first, end) of the row;
// paged_attention.py `paged_split_ranges` is the same cut.
__device__ __forceinline__ void split_range(int len, int nb, int bs,
                                            int window, int split,
                                            int splits, int& first,
                                            int& end, int& b0, int& b1) {
  if (len == 0) {  // the whole table, every score equal
    first = 0;
    end = nb * bs;
  } else {
    first = window > 0 ? max(0, len - window) : 0;
    end = min(len, nb * bs);
  }
  const int j_lo = first / bs;
  const int j_hi = max(j_lo, (end + bs - 1) / bs);
  const int chunk = (j_hi - j_lo + splits - 1) / splits;
  b0 = min(j_hi, j_lo + split * chunk);
  b1 = min(j_hi, b0 + chunk);
}

template <typename T, int H, int RC>
__global__ void __launch_bounds__(THREADS)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters,
                       int n_heads, int kv_heads,
                       int nb, int bs, long long q_ss, long long q_sn,
                       long long pool_sb, long long pool_sr,
                       long long pool_sg, long long table_ss, float scale,
                       int window) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = H / VEC;         // lanes holding one row
  constexpr int GPW = 32 / LPR;        // row groups per warp
  constexpr int NG = WARPS * GPW;      // row groups per CTA
  // positions a group loads before it uses any (registers allowing)
  constexpr int U = RC > 4 ? 2 : RC > 1 ? 4 : 8;
  // q rows [RC][H] while the positions stream, then each warp's partial
  // sums [WARPS][RC][H]
  __shared__ __align__(16) float sbuf[WARPS][RC][H];
  __shared__ float sml[WARPS][RC][2];
  extern __shared__ int stbl[];  // this CTA's table entries
  float(*sq)[H] = sbuf[0];

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int r = n_heads / kv_heads;
  const int head0 = kvh * r;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lengths[slot];
  const bool all = len == 0;
  const float scale_log2 = scale * 1.4426950408889634f;
  int first, end, b0, b1;
  split_range(len, nb, bs, window, split, splits, first, end, b0, b1);

  for (int i = tid; i < r * H; i += THREADS) {
    const int qi = i / H, d = i % H;
    sq[qi][d] = static_cast<float>(q[slot * q_ss + (head0 + qi) * q_sn + d]);
  }
  const int* trow = table + slot * table_ss;
  for (int i = tid; i < b1 - b0; i += THREADS) stbl[i] = trow[b0 + i];
  __syncthreads();

  const int d0 = (lane % LPR) * VEC;  // this lane's slice of a row
  const long long head_off = kvh * pool_sg + d0;
  const int n_pos = (b1 - b0) * bs;        // positions of the range
  const int p_first = first - b0 * bs;     // attended: [p_first, p_end)
  const int p_end = end - b0 * bs;

  float m[RC], l[RC], acc[RC][VEC];
#pragma unroll
  for (int qi = 0; qi < RC; ++qi) {
    m[qi] = NEG_INF;
    l[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[qi][e] = 0.f;
  }

  // the bound is the warp's, so that every lane takes part in the
  // shuffles; lane group lane / LPR of warp w takes positions
  // w * GPW + lane / LPR + k * NG
  for (int base = warp * GPW; base < n_pos; base += NG * U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + lane / LPR + u * NG;
      ok[u] = p < n_pos && p >= p_first && p < p_end;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u]) {
        const int blk = p / bs;
        const long long off = stbl[blk] * pool_sb + (p - blk * bs) * pool_sr +
                              head_off;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(pool_k + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(pool_v + off));
      }
    }
#pragma unroll
    for (int qi = 0; qi < RC; ++qi) {
      if (qi >= r) break;  // uniform over the CTA
      float qv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[e] = sq[qi][d0 + e];
      float s[U];
      float mx = m[qi];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        widen(kr[u], kf, T());
        float part_dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part_dot += qv[e] * kf[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
        s[u] = all ? 0.f : part_dot * scale_log2;
        mx = fmaxf(mx, ok[u] ? s[u] : NEG_INF);
      }
      const float corr = exp2_approx(m[qi] - mx);
      float psum = 0.f;
      float pv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) pv[e] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // a masked position was never loaded (its registers hold zeros), so
        // stale pool entries cannot reach the sums
        const float p = ok[u] ? exp2_approx(s[u] - mx) : 0.f;
        psum += p;
        float vf[VEC];
        widen(vr[u], vf, T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) pv[e] += p * vf[e];
      }
      l[qi] = l[qi] * corr + psum;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[qi][e] = acc[qi][e] * corr + pv[e];
      m[qi] = mx;
    }
  }

  // merge the row groups of each warp (lanes LPR, 2 LPR, ... apart)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int qi = 0; qi < RC; ++qi) {
      if (qi >= r) break;
      float acc2[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc2[e] = __shfl_xor_sync(0xffffffffu, acc[qi][e], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[qi], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[qi], off);
      merge_into(m[qi], l[qi], acc[qi], m2, l2, acc2, VEC);
    }
  }
  __syncthreads();  // every warp is done reading sq, which sbuf reuses
  if (lane < LPR) {
#pragma unroll
    for (int qi = 0; qi < RC; ++qi) {
      if (qi >= r) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e) sbuf[warp][qi][d0 + e] = acc[qi][e];
      if (lane == 0) {
        sml[warp][qi][0] = m[qi];
        sml[warp][qi][1] = l[qi];
      }
    }
  }
  __syncthreads();

  // merge the warps; write the output, or this split's partial
  for (int i = tid; i < r * H; i += THREADS) {
    const int qi = i / H, d = i % H;
    float mm = sml[0][qi][0], ll = sml[0][qi][1], aa = sbuf[0][qi][d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      merge_into(mm, ll, &aa, sml[w][qi][0], sml[w][qi][1], &sbuf[w][qi][d],
                 1);
    const long long row = (long long)slot * n_heads + head0 + qi;
    if (splits == 1) {
      out[row * H + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      float* pr = part + (row * splits + split) * (H + 2);
      pr[2 + d] = aa;
      if (d == 0) {
        pr[0] = mm;
        pr[1] = ll;
      }
    }
  }
  if (splits == 1) return;

  // the last CTA of this (slot, kv head) to finish merges the partials
  // [(m, l, acc[H])] of its splits, each rescaled to the largest m
  __shared__ bool s_last;
  __threadfence();  // this CTA's partial is visible before it counts
  __syncthreads();
  if (tid == 0) {
    int* count = counters + slot * kv_heads + kvh;
    s_last = atomicAdd(count, 1) == splits - 1;
    if (s_last) *count = 0;  // every split has counted: ready for reuse
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < r * H; i += THREADS) {
    const int qi = i / H, d = i % H;
    const long long row = (long long)slot * n_heads + head0 + qi;
    const float* pr = part + row * splits * (H + 2);
    float mx = NEG_INF;
    for (int k = 0; k < splits; ++k) mx = fmaxf(mx, __ldcg(pr + k * (H + 2)));
    float ll = 0.f, aa = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float* pk = pr + k * (H + 2);
      const float w = exp2_approx(__ldcg(pk) - mx);
      ll += __ldcg(pk + 1) * w;
      aa += __ldcg(pk + 2 + d) * w;
    }
    out[row * H + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int H, int RC>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* table, const void* lengths, void* out,
                   void* part, void* counters, int slots, int n_heads,
                   int kv_heads, int nb,
                   int bs, long long q_ss, long long q_sn, long long pool_sb,
                   long long pool_sr, long long pool_sg, long long table_ss,
                   float scale, int window, int splits, cudaStream_t stream) {
  const int chunk = (nb + splits - 1) / splits;
  const dim3 grid(slots, kv_heads, splits);
  paged_split_kernel<T, H, RC>
      <<<grid, THREADS, (size_t)chunk * sizeof(int), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(pool_k),
          static_cast<const T*>(pool_v), static_cast<const int*>(table),
          static_cast<const int*>(lengths), static_cast<T*>(out),
          static_cast<float*>(part), static_cast<int*>(counters), n_heads,
          kv_heads, nb, bs, q_ss, q_sn, pool_sb, pool_sr, pool_sg, table_ss,
          scale, window);
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t launch_r(int r, const void* q, const void* pool_k,
                     const void* pool_v, const void* table,
                     const void* lengths, void* out, void* part,
                     void* counters, int slots, int n_heads, int kv_heads,
                     int nb, int bs,
                     long long q_ss, long long q_sn, long long pool_sb,
                     long long pool_sr, long long pool_sg, long long table_ss,
                     float scale, int window, int splits,
                     cudaStream_t stream) {
#define PAGED_ARGS                                                         \
  q, pool_k, pool_v, table, lengths, out, part, counters, slots, n_heads,    \
      kv_heads, nb, bs, q_ss, q_sn, pool_sb, pool_sr, pool_sg, table_ss,     \
      scale, window, splits, stream
  if (r == 1) return launch<T, H, 1>(PAGED_ARGS);
  if (r <= 4) return launch<T, H, 4>(PAGED_ARGS);
  return launch<T, H, MAX_R>(PAGED_ARGS);
#undef PAGED_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// q is [slots, n, h] with strides (q_ss, q_sn, 1); the pools are one
// layer's [n_blocks, bs, g, h] with strides (pool_sb, pool_sr, pool_sg, 1),
// 16-byte aligned rows; table is int32 [slots, nb] with row stride
// table_ss; lengths int32 [slots]; out a contiguous [slots, n, h]; part an
// f32 scratch of slots * n * splits * (h + 2) values and counters int32
// [slots * g], zero on entry and left zero (both unused when splits is 1).
// Calls that share `counters` must be ordered (one stream). Returns a
// cudaError_t.
extern "C" int paged_decode(const void* q, const void* pool_k,
                            const void* pool_v, const void* table,
                            const void* lengths, void* out, void* part,
                            void* counters, int dtype, int slots,
                            int n_heads, int kv_heads, int head_dim, int nb,
                            int bs, long long q_ss,
                            long long q_sn, long long pool_sb,
                            long long pool_sr, long long pool_sg,
                            long long table_ss, float scale, int window,
                            int splits, void* stream) {
  cudaGetLastError();  // start from a clean error state
  const int r = n_heads / kv_heads;
  if (r > MAX_R || bs > MAX_BS || splits < 1 ||
      (nb + splits - 1) / splits > MAX_SPLIT_BLOCKS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS                                                         \
  r, q, pool_k, pool_v, table, lengths, out, part, counters, slots, n_heads, \
      kv_heads, nb, bs, q_ss, q_sn, pool_sb, pool_sr, pool_sg, table_ss,     \
      scale, window, splits, st
  if (dtype == 0 && head_dim == 64) return launch_r<float, 64>(PAGED_ARGS);
  if (dtype == 0 && head_dim == 128) return launch_r<float, 128>(PAGED_ARGS);
  if (dtype == 1 && head_dim == 64)
    return launch_r<__nv_bfloat16, 64>(PAGED_ARGS);
  if (dtype == 1 && head_dim == 128)
    return launch_r<__nv_bfloat16, 128>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
