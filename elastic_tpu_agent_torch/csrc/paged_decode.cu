// Paged-attention decode for Hopper (sm_90a).
//
// Replaces: elastic_tpu_agent/workloads/paged_attention.py `_paged_kernel`
// (launched by `paged_decode_attention`), the Pallas TPU kernel.
//
// What it computes: one decode query per slot against one layer's paged KV
// pool [n_blocks, bs, g, h]. The r = n / g query heads of a group share
// their kv head. A slot's logical block j lives at physical block
// table[slot, j]; positions p < len (and, with a window, len - 1 - p <
// window) are attended. The softmax runs online over blocks in f32, with
// no rounding of p: q, k and v are widened to f32 and every product and
// sum stays f32, as in the TPU kernel. The output is acc / max(l, 1e-30).
//
// Bound on this card: decode attention does ~4 flops per K/V byte pair it
// reads, far below the ~295 flop/byte where bf16 compute would matter, so
// it is bound by bytes: the K/V positions a slot attends. The design reads
// each attended pool row exactly once, straight from its block through the
// table (no gathered copy), and reads nothing else: each CTA loops only
// from the window's first block to ceil(len / bs) and stops at the length
// (the TPU grid streams every table entry and masks). Masked positions are
// skipped, never multiplied by 0, because the junk block 0 and stale pool
// entries are only guaranteed finite. One CTA per (slot, kv head) is a
// small grid at serving sizes (64 CTAs for 8 slots x 8 kv heads).
//
// Layout: one CTA of 128 threads per (slot, kv head). The group's r query
// rows sit in shared memory. For each block, all threads first stage its
// attended K and V rows into shared memory; a warp then computes one
// position's r scores with the head_dim spread over its lanes; r threads
// update the running max and sum; every thread owns up to MAX_R * H / 128
// accumulator elements of P.V. Each block is a serial chain (table read,
// row loads, four barriers, a one-thread softmax) and only slots x g CTAs
// run, so at serving sizes the kernel is latency-bound, far from its byte
// bound; more blocks per iteration or a split over blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = 16;   // query heads per kv head
constexpr int MAX_BS = 64;  // pool block size
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

__device__ __forceinline__ bool attended(int pos, int len, int window) {
  return pos < len && (window <= 0 || len - 1 - pos < window);
}

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                        const T* __restrict__ pool_v,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int n_heads, int kv_heads, int nb, int bs,
                        long long q_ss, long long q_sn, long long pool_sb,
                        long long pool_sr, long long pool_sg,
                        long long table_ss, float scale, int window) {
  constexpr int EPT = (MAX_R * H + THREADS - 1) / THREADS;
  constexpr int DPL = H / 32;  // head dims per lane
  __shared__ float sq[MAX_R][H];
  __shared__ float sp[MAX_R][MAX_BS];
  __shared__ float s_m[MAX_R], s_l[MAX_R], s_alpha[MAX_R];
  extern __shared__ float kv_smem[];  // this block's K then V rows [bs][H]
  float* sk = kv_smem;
  float* sv = kv_smem + bs * H;

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y;
  const int r = n_heads / kv_heads;
  const int head0 = kvh * r;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lengths[slot];
  const int* trow = table + slot * table_ss;

  for (int i = tid; i < r * H; i += THREADS) {
    const int qi = i / H, d = i % H;
    sq[qi][d] = to_f(q[slot * q_ss + (head0 + qi) * q_sn + d]);
  }
  if (tid < r) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }
  float acc[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) acc[u] = 0.f;

  const int first = window > 0 ? max(0, len - window) : 0;
  const int j_lo = first / bs;
  const int j_hi = min((len + bs - 1) / bs, nb);
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const long long blk = trow[j];
    const T* kblk = pool_k + blk * pool_sb + kvh * pool_sg;
    const T* vblk = pool_v + blk * pool_sb + kvh * pool_sg;
    const int p0 = j * bs;

    // stage the block's attended K/V rows: the rows go to shared
    // memory once, and the score and P.V loops read them from there
    for (int i = tid; i < bs * H; i += THREADS) {
      const int pos = i / H, d = i % H;
      if (attended(p0 + pos, len, window)) {
        sk[i] = to_f(kblk[pos * pool_sr + d]);
        sv[i] = to_f(vblk[pos * pool_sr + d]);
      }
    }
    __syncthreads();

    // scores: one warp per position, head_dim over the lanes
    for (int pos = warp; pos < bs; pos += WARPS) {
      if (!attended(p0 + pos, len, window)) continue;  // warp-uniform
      float kd[DPL];
#pragma unroll
      for (int u = 0; u < DPL; ++u) kd[u] = sk[pos * H + lane + 32 * u];
      for (int qi = 0; qi < r; ++qi) {
        float part = 0.f;
#pragma unroll
        for (int u = 0; u < DPL; ++u) part += sq[qi][lane + 32 * u] * kd[u];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) sp[qi][pos] = part * scale;
      }
    }
    __syncthreads();

    // online-softmax update, one thread per query row
    if (tid < r) {
      const float m_prev = s_m[tid];
      float mx = m_prev;
      for (int pos = 0; pos < bs; ++pos)
        if (attended(p0 + pos, len, window)) mx = fmaxf(mx, sp[tid][pos]);
      float sum = 0.f;
      for (int pos = 0; pos < bs; ++pos) {
        if (!attended(p0 + pos, len, window)) continue;
        const float p = expf(sp[tid][pos] - mx);
        sp[tid][pos] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - mx);
      s_l[tid] = s_l[tid] * alpha + sum;
      s_m[tid] = mx;
      s_alpha[tid] = alpha;
    }
    __syncthreads();

    // P.V over attended positions only
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = tid + THREADS * u;
      if (e < r * H) {
        const int qi = e / H, d = e % H;
        float pv = 0.f;
        for (int pos = 0; pos < bs; ++pos) {
          if (!attended(p0 + pos, len, window)) continue;
          pv += sp[qi][pos] * sv[pos * H + d];
        }
        acc[u] = acc[u] * s_alpha[qi] + pv;
      }
    }
    __syncthreads();  // sp, sk and sv are rewritten by the next block
  }

#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int e = tid + THREADS * u;
    if (e < r * H) {
      const int qi = e / H, d = e % H;
      const float lc = fmaxf(s_l[qi], 1e-30f);
      out[((long long)slot * n_heads + head0 + qi) * H + d] =
          from_f<T>(acc[u] / lc);
    }
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* table, const void* lengths, void* out,
                   int slots, int n_heads, int kv_heads, int nb, int bs,
                   long long q_ss, long long q_sn, long long pool_sb,
                   long long pool_sr, long long pool_sg, long long table_ss,
                   float scale, int window, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)bs * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(slots, kv_heads);
  paged_decode_kernel<T, H><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), n_heads,
      kv_heads, nb, bs, q_ss, q_sn, pool_sb, pool_sr, pool_sg, table_ss,
      scale, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// q is [slots, n, h] with strides (q_ss, q_sn, 1); the pools are one
// layer's [n_blocks, bs, g, h] with strides (pool_sb, pool_sr, pool_sg, 1);
// table is int32 [slots, nb] with row stride table_ss; lengths int32
// [slots]; out a contiguous [slots, n, h]. Returns a cudaError_t.
extern "C" int paged_decode(const void* q, const void* pool_k,
                            const void* pool_v, const void* table,
                            const void* lengths, void* out, int dtype,
                            int slots, int n_heads, int kv_heads,
                            int head_dim, int nb, int bs, long long q_ss,
                            long long q_sn, long long pool_sb,
                            long long pool_sr, long long pool_sg,
                            long long table_ss, float scale, int window,
                            void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (n_heads / kv_heads > MAX_R || bs > MAX_BS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS                                                         \
  q, pool_k, pool_v, table, lengths, out, slots, n_heads, kv_heads, nb, bs, \
      q_ss, q_sn, pool_sb, pool_sr, pool_sg, table_ss, scale, window, st
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(PAGED_ARGS);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(PAGED_ARGS);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(PAGED_ARGS);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
