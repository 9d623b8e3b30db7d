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
// Skip ranges follow the 64-row tile (q and key tiles alike): dK/dV starts
// at the q tile on the diagonal and, under a window, stops after the last
// row that can still see the tile's last key (k0 + 63 + window - 1); dQ
// uses flash_fwd.cu's range. Keys past a ragged sequence end and q rows past
// it get p = 0 explicitly (their staged or TMA-filled values are 0, but a
// zero K row still scores 0 and gives p = exp(-lse) != 0), so any length
// runs.
//
// Bound on this card: at the training path's shape ([8, 256, 8, 64] bf16,
// causal) dK/dV does four products per visible (q, key) pair and dQ three,
// ~0.67 and ~0.50 GFLOP against ~8 MiB each of inputs and outputs; the bf16
// tensor-core roofline puts both on the bytes side (~3-4 us at 3.35 TB/s).
// What the design does about bytes is the flash structure: probabilities
// are recomputed from lse and never stored, q/k/v/dO are read through their
// strides from the [b, s, n, h] layout (no transposed copies), and grouped
// kv heads are read once per group. At the main path's shapes the kernels
// are latency-bound (a few tiles per CTA), as flash_fwd is.
//
// Two instances, chosen by dtype in each C entry:
// - bfloat16 (`flash_bwd_dq_wgmma`, `flash_bwd_dkdv_wgmma`): flash_fwd.cu's
//   pieces (sm90.cuh). One CTA of two warpgroups; the tiles the CTA keeps
//   (Q and dO for dQ, K and V for dK/dV) come in once by TMA, the streamed
//   ones through a 2-stage mbarrier ring per warpgroup; the warpgroups take
//   alternate steps and sum their f32 partials through shared memory at the
//   end, warpgroup 0's first. Every product is a wgmma m64n64k16 (bf16 in,
//   f32 out) in one of flash_fwd's two forms: dQ computes S = Q.K^T and
//   dP = dO.V^T from shared memory (K-major) and dQ += dS.K with dS rounded
//   to bf16 as the register A operand and K the transposed B operand;
//   dK/dV computes the transposed scores S^T = K.Q^T and dP^T = V.dO^T,
//   so that key rows are the M dimension, then dV += P^T.dO and
//   dK += dS^T.Q with P^T and dS^T as bf16 register operands. Those
//   roundings are the TPU kernels' astype. lse and delta are a row's in dQ
//   (four registers) and a column's in dK/dV (a 64-float shared array per
//   step). exp2 on the SFU with scale * log2 e folded in; one instance per
//   mask kind, masks only on edge tiles, as branch-free selects.
// - float32 (`flash_bwd_dq_kernel`, `flash_bwd_dkdv_kernel`): the tensor
//   cores have no exact f32 product (TF32 would miss the f32 limits), so the
//   products are FP32 FMAs from f32 tiles in dynamic shared memory. 256
//   threads; in the score phase four threads share a q row and each owns
//   16 key columns (rows padded by one word keep the strided reads
//   conflict-free); in the dK/dV accumulation four threads share a key row.
//   At head_dim 128 dK/dV takes ~162 KB (one CTA per SM), dQ ~145 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // TMA, mbarrier, wgmma and packing helpers

namespace {

// -- float32: FP32 FMAs ---------------------------------------------------


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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// -- bfloat16: wgmma and TMA (helpers in sm90.cuh) ----------------------

constexpr int STAGES = 2;
constexpr int WGS = 2;  // warpgroups per CTA; they take alternate steps
constexpr float LOG2E = 1.4426950408889634f;

// barrier of one warpgroup's 128 threads (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(wg + 1), "n"(WG_THREADS) : "memory");
}

// dQ of one 64-row q tile. Warpgroup w takes key tiles lo + w, lo + w + 2,
// ... through its own K/V ring. Each thread's two q rows (r0, r0 + 8) are
// fixed by the fragment map, so their lse (in log2 units) and delta sit in
// registers. q tiles run in reverse order of blockIdx.y, so that the
// longest (causal: the last) CTAs start first.
template <int H, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(WGS * WG_THREADS, H == 64 ? 2 : 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int n_heads,
                       int kv_heads, int seq, float scale, int window) {
  constexpr int NA = H / 64;  // swizzle atoms across the head dim
  constexpr uint32_t KV_BYTES = 2 * NA * ATOM;
  constexpr int RING = STAGES * 2 * NA * ATOM;  // one warpgroup's K and V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full[WGS][STAGES],
      empty[WGS][STAGES];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS;
  const int wtid = tid % WG_THREADS;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* sq = smem;                             // [NA][64][64]
  uint8_t* sdo = sq + NA * ATOM;                  // [NA][64][64]
  uint8_t* sk = sdo + NA * ATOM + wg * RING;      // [STAGES][NA][64][64]
  uint8_t* sv = sk + STAGES * NA * ATOM;          // [STAGES][NA][64][64]

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int head = bh % n_heads;
  const int kvh = head / (n_heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const float scale_log2 = scale * LOG2E;

  int lo = 0;
  int hi = (seq + TILE - 1) / TILE;
  if (CAUSAL) {
    const int last_row = min(q0 + TILE - 1, seq - 1);
    hi = min(hi, last_row / TILE + 1);
    if (WINDOWED) lo = max(0, q0 - window + 1) / TILE;
  }
  const int n_tiles = (hi - lo - wg + WGS - 1) / WGS;

  auto load_kv = [&](int it) {  // into stage it % STAGES
    const int st = it % STAGES;
    const int k0 = (lo + wg + WGS * it) * TILE;
    mbar_expect_tx(&full[wg][st], KV_BYTES);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load(sk + (st * NA + a) * ATOM, &map_k, &full[wg][st], 64 * a, k0,
               kvh, b);
      tma_load(sv + (st * NA + a) * ATOM, &map_v, &full[wg][st], 64 * a, k0,
               kvh, b);
    }
  };
  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int w = 0; w < WGS; ++w)
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[w][s], 1);
        mbar_init(&empty[w][s], WG_THREADS / 32);  // one arrival per warp
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, 2 * NA * ATOM);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load(sq + a * ATOM, &map_q, &bar_q, 64 * a, q0, head, b);
      tma_load(sdo + a * ATOM, &map_do, &bar_q, 64 * a, q0, head, b);
    }
  }
  if (wtid == 0)
    for (int it = 0; it < min(STAGES, n_tiles); ++it) load_kv(it);
  __syncwarp();

  // rows r0 = q0 + 16 warp + g and r0 + 8; rows past the end are not
  // written, so their values do not matter
  const int r0 = q0 + 16 * warp + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const long long at = (long long)bh * seq + r;
    lse2[h] = r < seq ? lse[at] * LOG2E : 0.f;
    dl[h] = r < seq ? delta[at] : 0.f;
  }
  float dqa[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[a][i] = 0.f;
  const uint32_t q_base = smem_u32(sq);
  const uint32_t do_base = smem_u32(sdo);
  mbar_wait(&bar_q, 0);
  __syncwarp();

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int phase = (it / STAGES) & 1;
    const int k0 = (lo + wg + WGS * it) * TILE;
    const uint32_t k_base = smem_u32(sk + st * NA * ATOM);
    const uint32_t v_base = smem_u32(sv + st * NA * ATOM);
    mbar_wait(&full[wg][st], phase);
    __syncwarp();  // the wgmma instructions take the warp converged

    // S = Q.K^T and dP = dO.V^T: H / 16 k-steps each, 32 bytes apart
    // inside a 128-byte atom
    float s[32] = {}, dp[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(q_base + off, 16, 1024),
               sw128_desc(k_base + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
      wgmma_ss(dp, sw128_desc(do_base + off, 16, 1024),
               sw128_desc(v_base + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p = exp(s * scale - lse), masked to 0 (only a tile on the diagonal,
    // at the window's edge or past the end has masked elements); element
    // i: row - col = rel0 + 8 ((i >> 1) & 1) - 8 (i >> 2) - (i & 1) and
    // col - k0 - 2 t = 8 (i >> 2) + (i & 1). ds rounded to bf16 is the A
    // operand of dS.K: the TPU kernel's ds.astype(k.dtype).
    const bool edge =
        (CAUSAL && (k0 + TILE - 1 > q0 ||
                    (WINDOWED && q0 + TILE - 1 - k0 >= window))) ||
        k0 + TILE > seq;
    const int rel0 = r0 - k0 - 2 * t;
    const int seq_left = seq - k0 - 2 * t;
    uint32_t da[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      float d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = i + e;
        float p = exp2_approx(s[j] * scale_log2 - lse2[h]);
        if (edge) {
          const int rel = rel0 + 8 * h - 8 * (j >> 2) - e;
          // keys past the sequence end do not exist
          bool keep = 8 * (j >> 2) + e < seq_left;
          if (CAUSAL) {
            keep = keep & (rel >= 0);  // row >= col
            if (WINDOWED) keep = keep & (rel < window);
          }
          p = keep ? p : 0.f;
        }
        d2[e] = p * (dp[j] - dl[h]) * scale;
      }
      da[i >> 1] = pack_bf16(d2[0], d2[1]);
    }

    // dQ += dS.K: 4 k-steps of 16 keys (2048 bytes of K apart), one
    // 64-column atom of K per instruction
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_rs(dqa[a], da + 4 * kk,
                 sw128_desc(k_base + a * ATOM + kk * 2048, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(dqa[a]);

    // this warp is done with the stage; refill it with tile it + STAGES
    if (lane == 0) mbar_arrive(&empty[wg][st]);
    if (wtid == 0 && it + STAGES < n_tiles) {
      mbar_wait(&empty[wg][st], phase);
      load_kv(it + STAGES);
    }
    __syncwarp();
  }

  // warpgroup 1 hands its dQ to warpgroup 0, thread by thread, through the
  // rings both are done with; warpgroup 0 adds it and writes
  float* xch = reinterpret_cast<float*>(sdo + NA * ATOM);  // [NA*32][128]
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        xch[(a * 32 + i) * WG_THREADS + wtid] = dqa[a][i];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= seq) continue;
    __nv_bfloat16* out = dq + (((long long)b * seq + row) * n_heads + head) * H;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * h;
        const float* x = xch + (a * 32 + i) * WG_THREADS + wtid;
        *reinterpret_cast<uint32_t*>(out + 64 * a + 8 * j + 2 * t) =
            pack_bf16(dqa[a][i] + x[0], dqa[a][i + 1] + x[WG_THREADS]);
      }
  }
}

// dK and dV of one 64-row key tile. The steps are (query head of the
// group, q tile) pairs, head-major; warpgroup w takes steps w, w + 2, ...
// through its own Q/dO ring, with its own dK and dV accumulators. The
// scores are computed transposed (key rows are wgmma's M), so lse and
// delta belong to the fragment's columns: each step's 64 of each are
// staged in shared memory (double-buffered, one barrier of the warpgroup)
// and a thread reads its 16 columns 8 (i >> 2) + 2 t + (i & 1).
template <int H, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(WGS * WG_THREADS, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int n_heads,
                         int kv_heads, int seq, float scale, int window) {
  constexpr int NA = H / 64;
  constexpr uint32_t QDO_BYTES = 2 * NA * ATOM;
  constexpr int RING = STAGES * 2 * NA * ATOM;  // one warpgroup's Q and dO
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[WGS][STAGES],
      empty[WGS][STAGES];
  // per warpgroup and step parity: lse (log2 units) of the step's 64 q
  // rows, then their delta
  __shared__ float srows[WGS][2][2 * TILE];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS;
  const int wtid = tid % WG_THREADS;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* sk = smem;                             // [NA][64][64]
  uint8_t* sv = sk + NA * ATOM;                   // [NA][64][64]
  uint8_t* sq = sv + NA * ATOM + wg * RING;       // [STAGES][NA][64][64]
  uint8_t* sdo = sq + STAGES * NA * ATOM;         // [STAGES][NA][64][64]

  const int b = blockIdx.x / kv_heads;
  const int kvh = blockIdx.x % kv_heads;
  const int group = n_heads / kv_heads;
  const int k0 = blockIdx.y * TILE;
  const float scale_log2 = scale * LOG2E;

  // q tiles that can see this key tile: from the diagonal on (causal), up
  // to the last row that sees its last key (window)
  const int q_lo = CAUSAL ? (int)blockIdx.y : 0;
  int q_hi = (seq + TILE - 1) / TILE;
  if (WINDOWED) q_hi = min(q_hi, (k0 + TILE + window - 2) / TILE + 1);
  const int nq = q_hi - q_lo;
  const int n_steps = (group * nq - wg + WGS - 1) / WGS;
  // step it of this warpgroup: its query head (jnp.repeat's contiguous
  // groups) and q tile
  auto step_head = [&](int it) {
    return kvh * group + (wg + WGS * it) / nq;
  };
  auto step_q0 = [&](int it) {
    return (q_lo + (wg + WGS * it) % nq) * TILE;
  };

  auto load_qdo = [&](int it) {  // into stage it % STAGES
    const int st = it % STAGES;
    const int head = step_head(it), q0 = step_q0(it);
    mbar_expect_tx(&full[wg][st], QDO_BYTES);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load(sq + (st * NA + a) * ATOM, &map_q, &full[wg][st], 64 * a, q0,
               head, b);
      tma_load(sdo + (st * NA + a) * ATOM, &map_do, &full[wg][st], 64 * a,
               q0, head, b);
    }
  };
  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    for (int w = 0; w < WGS; ++w)
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[w][s], 1);
        mbar_init(&empty[w][s], WG_THREADS / 32);  // one arrival per warp
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_kv, 2 * NA * ATOM);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load(sk + a * ATOM, &map_k, &bar_kv, 64 * a, k0, kvh, b);
      tma_load(sv + a * ATOM, &map_v, &bar_kv, 64 * a, k0, kvh, b);
    }
  }
  if (wtid == 0)
    for (int it = 0; it < min(STAGES, n_steps); ++it) load_qdo(it);
  __syncwarp();

  float dka[NA][32], dva[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[a][i] = dva[a][i] = 0.f;
  const uint32_t k_base = smem_u32(sk);
  const uint32_t v_base = smem_u32(sv);
  // rows k0 + 16 warp + g (+ 8) of the tile are this thread's keys
  const int kr0 = k0 + 16 * warp + g;
  mbar_wait(&bar_kv, 0);
  __syncwarp();

  for (int it = 0; it < n_steps; ++it) {
    const int st = it % STAGES;
    const int phase = (it / STAGES) & 1;
    const int head = step_head(it), q0 = step_q0(it);
    const uint32_t q_base = smem_u32(sq + st * NA * ATOM);
    const uint32_t do_base = smem_u32(sdo + st * NA * ATOM);
    // thread wtid fetches lse (wtid < 64) or delta of q row q0 + wtid % 64
    float* rows = srows[wg][it & 1];
    const int r = q0 + (wtid & (TILE - 1));
    const long long at = ((long long)b * n_heads + head) * seq + r;
    const float row_val =
        r < seq ? (wtid < TILE ? lse[at] * LOG2E : delta[at]) : 0.f;
    mbar_wait(&full[wg][st], phase);
    __syncwarp();

    // S^T = K.Q^T and dP^T = V.dO^T, both K-major from shared memory
    float s[32] = {}, dp[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(k_base + off, 16, 1024),
               sw128_desc(q_base + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
      wgmma_ss(dp, sw128_desc(v_base + off, 16, 1024),
               sw128_desc(do_base + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    rows[wtid] = row_val;
    wg_sync(wg);  // the step's lse and delta are in place
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p^T and ds^T, masked to 0 on edge tiles; element i: q - key =
    // relt0 + 8 (i >> 2) + (i & 1) - 8 ((i >> 1) & 1) and q - q0 - 2 t =
    // 8 (i >> 2) + (i & 1). Both are rounded to bf16 as the A operands of
    // the next products: the TPU kernel's p.astype(do.dtype) and
    // ds.astype(q.dtype).
    const bool edge =
        (CAUSAL && (k0 + TILE - 1 > q0 ||
                    (WINDOWED && q0 + TILE - 1 - k0 >= window))) ||
        q0 + TILE > seq;
    const int relt0 = q0 + 2 * t - kr0;
    const int seq_left = seq - q0 - 2 * t;
    uint32_t pa[16], da[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = i + e;
        const int c = 8 * (j >> 2) + 2 * t + e;  // the element's q column
        float p = exp2_approx(s[j] * scale_log2 - rows[c]);
        if (edge) {
          const int rel = relt0 + 8 * (j >> 2) + e - 8 * ((j >> 1) & 1);
          bool keep = 8 * (j >> 2) + e < seq_left;  // q rows past the end
          if (CAUSAL) {
            keep = keep & (rel >= 0);  // q >= key
            if (WINDOWED) keep = keep & (rel < window);
          }
          p = keep ? p : 0.f;
        }
        p2[e] = p;
        d2[e] = p * (dp[j] - rows[TILE + c]) * scale;
      }
      pa[i >> 1] = pack_bf16(p2[0], p2[1]);
      da[i >> 1] = pack_bf16(d2[0], d2[1]);
    }

    // dV += P^T.dO and dK += dS^T.Q: 4 k-steps of 16 q rows (2048 bytes
    // apart), one 64-column atom of dO or Q per instruction
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_rs(dva[a], pa + 4 * kk,
                 sw128_desc(do_base + a * ATOM + kk * 2048, 1024, 1024));
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_rs(dka[a], da + 4 * kk,
                 sw128_desc(q_base + a * ATOM + kk * 2048, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      fence_regs(dva[a]);
      fence_regs(dka[a]);
    }

    // this warp is done with the stage; refill it with step it + STAGES
    if (lane == 0) mbar_arrive(&empty[wg][st]);
    if (wtid == 0 && it + STAGES < n_steps) {
      mbar_wait(&empty[wg][st], phase);
      load_qdo(it + STAGES);
    }
    __syncwarp();
  }

  // warpgroup 1 hands its dK and dV to warpgroup 0, thread by thread,
  // through the rings both are done with; warpgroup 0 adds them and writes
  float* xch = reinterpret_cast<float*>(sv + NA * ATOM);  // [2*NA*32][128]
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        xch[(a * 32 + i) * WG_THREADS + wtid] = dka[a][i];
        xch[((NA + a) * 32 + i) * WG_THREADS + wtid] = dva[a][i];
      }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kr0 + 8 * h;
    if (row >= seq) continue;
    const long long off = (((long long)b * seq + row) * kv_heads + kvh) * H;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * h;
        const int col = 64 * a + 8 * j + 2 * t;
        const float* xk = xch + (a * 32 + i) * WG_THREADS + wtid;
        const float* xv = xch + ((NA + a) * 32 + i) * WG_THREADS + wtid;
        *reinterpret_cast<uint32_t*>(dk + off + col) =
            pack_bf16(dka[a][i] + xk[0], dka[a][i + 1] + xk[WG_THREADS]);
        *reinterpret_cast<uint32_t*>(dv + off + col) =
            pack_bf16(dva[a][i] + xv[0], dva[a][i + 1] + xv[WG_THREADS]);
      }
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

// TMA maps of q, k, v and dO (in that order), for the bf16 instances
bool make_maps(CUtensorMap (&m)[4], const Args& a, int h) {
  return make_map(&m[0], a.q, a.batch, a.seq, a.n_heads, h, a.qs.b, a.qs.s,
                  a.qs.n) &&
         make_map(&m[1], a.k, a.batch, a.seq, a.kv_heads, h, a.ks.b, a.ks.s,
                  a.ks.n) &&
         make_map(&m[2], a.v, a.batch, a.seq, a.kv_heads, h, a.vs.b, a.vs.s,
                  a.vs.n) &&
         make_map(&m[3], a.dout, a.batch, a.seq, a.n_heads, h, a.dos.b,
                  a.dos.s, a.dos.n);
}

// the tiles each CTA keeps, two warpgroups' 2-stage rings, and the slack to
// align them to 1024 bytes (the same for both kernels)
template <int H>
constexpr int wgmma_smem() {
  return (2 + WGS * 2 * STAGES) * (H / 64) * ATOM + 1024;
}

template <int H, bool CAUSAL, bool WINDOWED>
cudaError_t launch_dq_wgmma(const Args& a) {
  CUtensorMap m[4];
  if (!make_maps(m, a, H)) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<H, CAUSAL, WINDOWED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wgmma_smem<H>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.batch * a.n_heads, (a.seq + TILE - 1) / TILE);
  flash_bwd_dq_wgmma<H, CAUSAL, WINDOWED>
      <<<grid, WGS * WG_THREADS, wgmma_smem<H>(), a.stream>>>(
          m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta),
          static_cast<__nv_bfloat16*>(a.out0), a.n_heads, a.kv_heads, a.seq,
          a.scale, a.window);
  return cudaGetLastError();
}

template <int H, bool CAUSAL, bool WINDOWED>
cudaError_t launch_dkdv_wgmma(const Args& a) {
  CUtensorMap m[4];
  if (!make_maps(m, a, H)) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<H, CAUSAL, WINDOWED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wgmma_smem<H>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.batch * a.kv_heads, (a.seq + TILE - 1) / TILE);
  flash_bwd_dkdv_wgmma<H, CAUSAL, WINDOWED>
      <<<grid, WGS * WG_THREADS, wgmma_smem<H>(), a.stream>>>(
          m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta),
          static_cast<__nv_bfloat16*>(a.out0),
          static_cast<__nv_bfloat16*>(a.out1), a.n_heads, a.kv_heads, a.seq,
          a.scale, a.window);
  return cudaGetLastError();
}

// one bf16 instance per mask kind
template <int H>
cudaError_t launch_dq_bf16(const Args& a) {
  if (!a.causal) return launch_dq_wgmma<H, false, false>(a);
  if (a.window > 0) return launch_dq_wgmma<H, true, true>(a);
  return launch_dq_wgmma<H, true, false>(a);
}

template <int H>
cudaError_t launch_dkdv_bf16(const Args& a) {
  if (!a.causal) return launch_dkdv_wgmma<H, false, false>(a);
  if (a.window > 0) return launch_dkdv_wgmma<H, true, true>(a);
  return launch_dkdv_wgmma<H, true, false>(a);
}

#define FLASH_BWD_DISPATCH(fma, bf16)                            \
  if (dtype == 0 && head_dim == 64) return fma<float, 64>(a);    \
  if (dtype == 0 && head_dim == 128) return fma<float, 128>(a);  \
  if (dtype == 1 && head_dim == 64) return bf16<64>(a);          \
  if (dtype == 1 && head_dim == 128) return bf16<128>(a);        \
  return (int)cudaErrorInvalidValue;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout [b, s, n, h], k/v [b, s, g, h]
// with strides in elements (b, s, head) and a contiguous head_dim axis
// (bfloat16: 16-byte aligned bases and strides, as TMA reads them); lse and
// delta contiguous f32 [b, n, s]. dk/dv are contiguous [b, s, g, h] of k's
// dtype, dq contiguous [b, s, n, h]. Each returns a cudaError_t.
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
  FLASH_BWD_DISPATCH(launch_dkdv, launch_dkdv_bf16)
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, FLASH_BWD_PARAMS) {
  cudaGetLastError();
  FLASH_BWD_ARGS(dq, nullptr);
  FLASH_BWD_DISPATCH(launch_dq, launch_dq_bf16)
}

extern "C" const char* flash_bwd_dkdv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
