// Flash attention backward for Hopper (sm_90a): dK/dV and dQ.
//
// Replaces: elastic_tpu_agent/workloads/attention.py `_dkdv_kernel` and
// `_dq_kernel` (both launched by `_flash_bwd`), the Pallas TPU kernels.
//
// What they compute, exactly as the TPU kernels do: the probabilities are
// recomputed from the forward's lse, p = exp(s * scale - lse) with masked
// scores at NEG_INF = -1e30 (so masked p is exactly 0); dp = dO.V^T;
// ds = p * (dp - delta) * scale, where delta = rowsum(dO * O) - dlse comes
// in precomputed (f32 [b, n, s]); dV = p^T.dO with p rounded to dO's dtype,
// dK = ds^T.Q with ds rounded to Q's dtype, dQ = ds.K with ds rounded to
// K's dtype. Sums are f32, outputs are cast once.
//
// Two kernels and no atomics, as on the TPU: `flash_bwd_dkdv` runs one CTA
// per (batch, kv head, 64-row key tile) and loops over the group's
// n_heads / kv_heads query heads and the q tiles that can see the tile;
// `flash_bwd_dq` runs one CTA per (batch, q head, 64-row q tile) and loops
// over the key tiles it can see. Every output element is written once, in a
// fixed order, so the result is deterministic. The sum over a kv head's
// query heads inside the dK/dV CTA has no counterpart in the TPU kernel,
// whose inputs were already repeated (`jnp.repeat`); here grouped k/v are
// read in place, so the backward of the repeat happens in the kernel.
//
// Skip ranges follow this kernel's 64-row tile (BQ == BK): dK/dV starts at
// the q tile on the diagonal and, under a window, stops after the last row
// that can still see the tile's last key (k0 + BK - 1 + window - 1); dQ
// uses flash_fwd.cu's range. Keys past a ragged sequence end and q rows past
// it get p = 0 explicitly (their staged values are 0 too), so any length
// runs.
//
// Bound on this card: at the training path's shape ([8, 256, 8, 64] bf16,
// causal) dK/dV does four products per visible (q, key) pair and dQ three,
// ~0.67 and ~0.50 GFLOP against ~8 MiB each of inputs and outputs; the bf16
// tensor-core roofline puts both on the bytes side (~2.6 us at 3.35 TB/s).
// This first version does the products with plain FP32 FMAs from shared
// memory (no wgmma, no TMA), so it is bound by FMA throughput instead. What
// its design does about bytes is the flash structure: probabilities are
// recomputed from lse and never stored, q/k/v/dO are read through their
// strides from the [b, s, n, h] layout (no transposed copies), and grouped
// kv heads are read once per group.
//
// Layout: 256 threads; in the score phase four threads share a q row and
// each owns 16 key columns (rows padded by one word keep the strided reads
// conflict-free); in the dK/dV accumulation four threads share a key row.
// Q, dO, K and V tiles are staged in dynamic shared memory as f32: at
// head_dim 128 dK/dV takes ~162 KB (one CTA per SM), dQ ~145 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // q rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int TPR = 4;             // threads per row
constexpr int THREADS = BQ * TPR;  // 256
constexpr int COLS = BK / TPR;     // score columns per thread
constexpr int PP = BK + 1;         // padded score-tile row
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, n;  // elements; the head_dim axis is contiguous
};

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

// x rounded to T's precision and widened back: the TPU kernel's astype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Stage a [64, H] tile of rows r0.. of x (rows past seq as 0) into dst
// with row pitch HP.
template <typename T, int H>
__device__ __forceinline__ void stage(float* dst, const T* x, long long ss,
                                      int r0, int seq) {
  constexpr int HP = H + 1;
  for (int i = threadIdx.x; i < BQ * H; i += THREADS) {
    const int r = i / H, d = i % H, s = r0 + r;
    dst[r * HP + d] = s < seq ? to_f(x[s * ss + d]) : 0.f;
  }
}

// The score phase shared by both kernels, for the thread's q row `qrow`
// (tile row `row`) and key columns k0 + sub + TPR * c: p and ds with the
// causal / window mask, p = 0 for keys or rows past seq.
template <int H>
__device__ __forceinline__ void score_tile(
    const float* sq, const float* sdo, const float* sk, const float* sv,
    int row, int sub, int qrow, int k0, int seq, float l, float dl,
    float scale, int causal, int window, float* p, float* ds) {
  constexpr int HP = H + 1;
  float sc[COLS], dp[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) sc[c] = dp[c] = 0.f;
  for (int d = 0; d < H; ++d) {
    const float qd = sq[row * HP + d];
    const float dod = sdo[row * HP + d];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      sc[c] += qd * sk[(sub + TPR * c) * HP + d];
      dp[c] += dod * sv[(sub + TPR * c) * HP + d];
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = k0 + sub + TPR * c;
    float s = sc[c] * scale;
    if (causal) {
      bool keep = qrow >= col;
      if (window > 0) keep = keep && (qrow - col < window);
      if (!keep) s = NEG_INF;
    }
    p[c] = (qrow < seq && col < seq) ? expf(s - l) : 0.f;
    ds[c] = p[c] * (dp[c] - dl) * scale;
  }
}

template <int H>
constexpr size_t dkdv_smem_floats() {
  // K, V, Q, dO [64][H+1]; P, dS [64][BK+1]; lse, delta [64]
  return 4 * (size_t)BQ * (H + 1) + 2 * (size_t)BQ * PP + 2 * BQ;
}

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int n_heads, int kv_heads,
                          int seq, Strides qs, Strides ks, Strides vs,
                          Strides dos, float scale, int causal, int window) {
  constexpr int HP = H + 1;
  constexpr int DIMS = H / TPR;  // output dims per thread
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + BK * HP;
  float* sq = sv + BK * HP;
  float* sdo = sq + BQ * HP;
  float* sp = sdo + BQ * HP;
  float* sds = sp + BQ * PP;
  float* slse = sds + BQ * PP;
  float* sdelta = slse + BQ;

  const int b = blockIdx.x / kv_heads;
  const int kvh = blockIdx.x % kv_heads;
  const int group = n_heads / kv_heads;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;

  stage<T, H>(sk, k + b * ks.b + kvh * ks.n, ks.s, k0, seq);
  stage<T, H>(sv, v + b * vs.b + kvh * vs.n, vs.s, k0, seq);

  float acc_k[DIMS], acc_v[DIMS];
#pragma unroll
  for (int e = 0; e < DIMS; ++e) acc_k[e] = acc_v[e] = 0.f;

  // q tiles that can see this key tile: from the diagonal on (causal), up
  // to the last row that sees its last key (window)
  int lo = 0;
  int hi = (seq + BQ - 1) / BQ;
  if (causal) {
    lo = blockIdx.y;
    if (window > 0) hi = min(hi, (k0 + BK + window - 2) / BQ + 1);
  }

  for (int t = 0; t < group; ++t) {
    const int head = kvh * group + t;  // jnp.repeat's contiguous groups
    const T* qb = q + b * qs.b + head * qs.n;
    const T* dob = dout + b * dos.b + head * dos.n;
    const long long rows = ((long long)b * n_heads + head) * seq;
    for (int i = lo; i < hi; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // the previous tile's readers are done
      stage<T, H>(sq, qb, qs.s, q0, seq);
      stage<T, H>(sdo, dob, dos.s, q0, seq);
      if (tid < BQ) {
        const int s = q0 + tid;
        slse[tid] = s < seq ? lse[rows + s] : 0.f;
        sdelta[tid] = s < seq ? delta[rows + s] : 0.f;
      }
      __syncthreads();

      float p[COLS], ds[COLS];
      score_tile<H>(sq, sdo, sk, sv, row, sub, q0 + row, k0, seq, slse[row],
                    sdelta[row], scale, causal, window, p, ds);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        sp[row * PP + sub + TPR * c] = round_to<T>(p[c]);     // dO's dtype
        sds[row * PP + sub + TPR * c] = round_to<T>(ds[c]);   // Q's dtype
      }
      __syncthreads();

      // this thread's key row `row`: dV += p^T.dO, dK += ds^T.Q
      for (int r = 0; r < BQ; ++r) {
        const float pr = sp[r * PP + row];
        const float dr = sds[r * PP + row];
        const float* dor = sdo + r * HP + sub;
        const float* qr = sq + r * HP + sub;
#pragma unroll
        for (int e = 0; e < DIMS; ++e) {
          acc_v[e] += pr * dor[TPR * e];
          acc_k[e] += dr * qr[TPR * e];
        }
      }
    }
  }

  const int krow = k0 + row;
  if (krow < seq) {
    const long long off =
        (((long long)b * seq + krow) * kv_heads + kvh) * H + sub;
#pragma unroll
    for (int e = 0; e < DIMS; ++e) {
      dk[off + TPR * e] = from_f<T>(acc_k[e]);
      dv[off + TPR * e] = from_f<T>(acc_v[e]);
    }
  }
}

template <int H>
constexpr size_t dq_smem_floats() {
  // Q, dO, K, V [64][H+1]; dS [64][BK+1]
  return 4 * (size_t)BQ * (H + 1) + (size_t)BQ * PP;
}

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int n_heads, int kv_heads, int seq, Strides qs,
                        Strides ks, Strides vs, Strides dos, float scale,
                        int causal, int window) {
  constexpr int HP = H + 1;
  constexpr int DIMS = H / TPR;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + BQ * HP;
  float* sk = sdo + BQ * HP;
  float* sv = sk + BK * HP;
  float* sds = sv + BK * HP;

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int head = bh % n_heads;
  const int kvh = head / (n_heads / kv_heads);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int qrow = q0 + row;
  const T* kb = k + b * ks.b + kvh * ks.n;
  const T* vb = v + b * vs.b + kvh * vs.n;

  stage<T, H>(sq, q + b * qs.b + head * qs.n, qs.s, q0, seq);
  stage<T, H>(sdo, dout + b * dos.b + head * dos.n, dos.s, q0, seq);
  const long long at = (long long)bh * seq + qrow;
  const float l = qrow < seq ? lse[at] : 0.f;
  const float dl = qrow < seq ? delta[at] : 0.f;

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
    stage<T, H>(sk, kb, ks.s, k0, seq);
    stage<T, H>(sv, vb, vs.s, k0, seq);
    __syncthreads();

    float p[COLS], ds[COLS];
    score_tile<H>(sq, sdo, sk, sv, row, sub, qrow, k0, seq, l, dl, scale,
                  causal, window, p, ds);
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      sds[row * PP + sub + TPR * c] = round_to<T>(ds[c]);  // K's dtype
    __syncwarp();  // a row's dS is written and read by the same four lanes
    for (int c = 0; c < BK; ++c) {
      const float dsv = sds[row * PP + c];
      const float* kr = sk + c * HP + sub;
#pragma unroll
      for (int e = 0; e < DIMS; ++e) acc[e] += dsv * kr[TPR * e];
    }
  }

  if (qrow < seq) {
    T* out = dq + (((long long)b * seq + qrow) * n_heads + head) * H + sub;
#pragma unroll
    for (int e = 0; e < DIMS; ++e) out[TPR * e] = from_f<T>(acc[e]);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int batch, seq, n_heads, kv_heads;
  Strides qs, ks, vs, dos;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int H>
cudaError_t launch_dkdv(const Args& a) {
  const size_t smem = dkdv_smem_floats<H>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.kv_heads, (a.seq + BK - 1) / BK);
  flash_bwd_dkdv_kernel<T, H><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.n_heads,
      a.kv_heads, a.seq, a.qs, a.ks, a.vs, a.dos, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem_floats<H>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.n_heads, (a.seq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, H><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.n_heads, a.kv_heads, a.seq, a.qs, a.ks,
      a.vs, a.dos, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

#define FLASH_BWD_DISPATCH(fn)                                        \
  if (dtype == 0 && head_dim == 64) return fn<float, 64>(a);          \
  if (dtype == 0 && head_dim == 128) return fn<float, 128>(a);        \
  if (dtype == 1 && head_dim == 64) return fn<__nv_bfloat16, 64>(a);  \
  if (dtype == 1 && head_dim == 128) return fn<__nv_bfloat16, 128>(a); \
  return (int)cudaErrorInvalidValue;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout [b, s, n, h], k/v [b, s, g, h]
// with strides in elements (b, s, head) and a contiguous head_dim axis;
// lse and delta contiguous f32 [b, n, s]. dk/dv are contiguous [b, s, g, h]
// of k's dtype, dq contiguous [b, s, n, h]. Each returns a cudaError_t.
#define FLASH_BWD_PARAMS                                                   \
  int dtype, int batch, int seq, int n_heads, int kv_heads, int head_dim, \
      long long q_sb, long long q_ss, long long q_sn, long long k_sb,     \
      long long k_ss, long long k_sn, long long v_sb, long long v_ss,     \
      long long v_sn, long long do_sb, long long do_ss, long long do_sn,  \
      float scale, int causal, int window, void* stream
#define FLASH_BWD_ARGS(o0, o1)                                              \
  Args a{q, k, v, dout, lse, delta, o0, o1, batch, seq, n_heads, kv_heads, \
         {q_sb, q_ss, q_sn}, {k_sb, k_ss, k_sn}, {v_sb, v_ss, v_sn},        \
         {do_sb, do_ss, do_sn}, scale, causal, window,                     \
         static_cast<cudaStream_t>(stream)}

extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              FLASH_BWD_PARAMS) {
  cudaGetLastError();  // start from a clean error state
  FLASH_BWD_ARGS(dk, dv);
  FLASH_BWD_DISPATCH(launch_dkdv)
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, FLASH_BWD_PARAMS) {
  cudaGetLastError();
  FLASH_BWD_ARGS(dq, nullptr);
  FLASH_BWD_DISPATCH(launch_dq)
}

extern "C" const char* flash_bwd_dkdv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
