// Flash attention forward for Hopper (sm_90a).
//
// Replaces: elastic_tpu_agent/workloads/attention.py `_fwd_kernel`
// (launched by `_flash_fwd`), the Pallas TPU kernel.
//
// What it computes, exactly as the TPU kernel does: per (batch, head) an
// online softmax over key tiles with f32 running max `m`, sum `l` and
// accumulator `acc`; masked scores are NEG_INF = -1e30 (not -inf), the
// unnormalised probabilities are rounded to V's dtype before P.V, `l` is
// clamped at 1e-30 and lse = m + log(l) uses the clamped `l`. Causal and
// sliding-window masks are applied per element; key tiles wholly above the
// diagonal or wholly before the window are skipped. The skip range follows
// from this kernel's own 64-row tile; the per-element mask makes the result
// independent of it, because a fully masked tile seen before the first
// visible one is wiped exactly by the later exp(NEG_INF - m) = 0 correction.
//
// Bound on this card: at the serving preset's shapes ([8, 256, 8, 64]) the
// work is ~0.5 GFLOP against 8 MiB of q/k/v/o, so the bf16 tensor-core
// roofline puts it on the bytes side (~2.5 us at 3.35 TB/s). This first
// version does the products with plain FP32 FMAs from shared memory (no
// wgmma, no TMA), so it is bound by FMA throughput instead; what its
// design does about bytes is the flash structure itself: q, k and v are
// read from device memory once per (q tile, key tile), scores never leave
// the SM, and q/k/v are read through strides from the [b, s, n, h]
// layout, so no transposed copy is made. GQA is read in place: query
// head i reads kv head i / (n_heads / kv_heads).
//
// Layout: one CTA of 256 threads per (batch*head, 64-row q tile); four
// threads share a q row. Q, K, V and P tiles are staged in shared memory
// as f32 (rows padded by one word to keep the strided reads conflict-free).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // q rows per CTA
constexpr int BK = 64;             // keys per tile
constexpr int TPR = 4;             // threads per q row
constexpr int THREADS = BQ * TPR;  // 256
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
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

template <int H>
constexpr size_t smem_floats() {
  // Q [BQ][H+1], K [BK][H+1], V [BK][H], P [BQ][BK+1]
  return (size_t)BQ * (H + 1) + (size_t)BK * (H + 1) + (size_t)BK * H +
         (size_t)BQ * (BK + 1);
}

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n_heads, int kv_heads,
                     int seq, long long q_sb, long long q_ss, long long q_sn,
                     long long k_sb, long long k_ss, long long k_sn,
                     long long v_sb, long long v_ss, long long v_sn,
                     float scale, int causal, int window) {
  constexpr int HP = H + 1;
  constexpr int PP = BK + 1;
  constexpr int COLS = BK / TPR;  // score columns per thread
  constexpr int DIMS = H / TPR;   // output dims per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * HP;
  float* sv = sk + BK * HP;
  float* sp = sv + BK * H;

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int head = bh % n_heads;
  const int kvh = head / (n_heads / kv_heads);
  const int q0 = blockIdx.y * BQ;
  const T* qb = q + b * q_sb + head * q_sn;
  const T* kb = k + b * k_sb + kvh * k_sn;
  const T* vb = v + b * v_sb + kvh * v_sn;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int qrow = q0 + row;

  for (int i = tid; i < BQ * H; i += THREADS) {
    const int r = i / H, d = i % H, s = q0 + r;
    sq[r * HP + d] = s < seq ? to_f(qb[s * q_ss + d]) : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DIMS];
#pragma unroll
  for (int e = 0; e < DIMS; ++e) acc[e] = 0.f;

  int lo = 0;
  int hi = (seq + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ - 1, seq - 1);
    hi = min(hi, last_row / BK + 1);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * H; i += THREADS) {
      const int r = i / H, d = i % H, s = k0 + r;
      const bool in = s < seq;
      sk[r * HP + d] = in ? to_f(kb[s * k_ss + d]) : 0.f;
      sv[r * H + d] = in ? to_f(vb[s * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[COLS];
#pragma unroll
    for (int t = 0; t < COLS; ++t) sc[t] = 0.f;
    for (int d = 0; d < H; ++d) {
      const float qd = sq[row * HP + d];
#pragma unroll
      for (int t = 0; t < COLS; ++t) sc[t] += qd * sk[(sub + TPR * t) * HP + d];
    }

    float mx = NEG_INF;
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      const int col = k0 + sub + TPR * t;
      float s = sc[t] * scale;
      if (causal) {
        bool keep = qrow >= col;
        if (window > 0) keep = keep && (qrow - col < window);
        if (!keep) s = NEG_INF;
      }
      // keys past the sequence end do not exist: -inf gives p = 0 exactly
      if (col >= seq) s = -INFINITY;
      sc[t] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      const float p = expf(sc[t] - m_new);
      psum += p;
      // P.V takes p in V's dtype, as the TPU kernel's p.astype(v.dtype)
      sp[row * PP + sub + TPR * t] = to_f(from_f<T>(p));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int e = 0; e < DIMS; ++e) acc[e] *= corr;
    __syncwarp();  // a row's P is written and read by the same four lanes
    for (int c = 0; c < BK; ++c) {
      const float p = sp[row * PP + c];
      const float* vr = sv + c * H + sub;
#pragma unroll
      for (int e = 0; e < DIMS; ++e) acc[e] += p * vr[TPR * e];
    }
  }

  if (qrow < seq) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * seq + qrow) * n_heads + head) * H + sub;
#pragma unroll
    for (int e = 0; e < DIMS; ++e) orow[TPR * e] = from_f<T>(acc[e] / lc);
    if (sub == 0) lse[(long long)bh * seq + qrow] = m + logf(lc);
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int n_heads, int kv_heads,
                   long long q_sb, long long q_ss, long long q_sn,
                   long long k_sb, long long k_ss, long long k_sn,
                   long long v_sb, long long v_ss, long long v_sn,
                   float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats<H>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (seq + BQ - 1) / BQ);
  flash_fwd_kernel<T, H><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n_heads, kv_heads, seq, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss,
      v_sn, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head_dim
// axis must be contiguous. o is a contiguous [b, s, n, h] tensor of q's
// dtype, lse a contiguous f32 [b, n, s] tensor. Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int dtype, int batch, int seq,
                         int n_heads, int kv_heads, int head_dim,
                         long long q_sb, long long q_ss, long long q_sn,
                         long long k_sb, long long k_ss, long long k_sn,
                         long long v_sb, long long v_ss, long long v_sn,
                         float scale, int causal, int window, void* stream) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS                                                       \
  q, k, v, o, lse, batch, seq, n_heads, kv_heads, q_sb, q_ss, q_sn, k_sb, \
      k_ss, k_sn, v_sb, v_ss, v_sn, scale, causal, window, st
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(FLASH_ARGS);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(FLASH_ARGS);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(FLASH_ARGS);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
