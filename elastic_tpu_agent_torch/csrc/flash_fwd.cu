// Flash attention forward for Hopper (sm_90a).
//
// Replaces: elastic_tpu_agent/workloads/attention.py `_fwd_kernel`
// (launched by `_flash_fwd`), the Pallas TPU kernel.
//
// What it computes, exactly as the TPU kernel does: per (batch, head) an
// online softmax over key tiles with f32 running max `m`, sum `l` and
// accumulator `acc`; masked scores are NEG_INF = -1e30 (not -inf), keys
// past the sequence end -inf; the unnormalised probabilities are rounded
// to V's dtype before P.V, `l` sums them unrounded, is clamped at 1e-30
// and lse = m + log(l) uses the clamped `l`. Causal and sliding-window
// masks are applied per element; key tiles wholly above the diagonal or
// wholly before the window are skipped. The skip range follows from the
// 64-row tile; the per-element mask makes the result independent of it,
// because a fully masked tile seen before the first visible one is wiped
// exactly by the later exp(NEG_INF - m) = 0 correction. GQA is read in
// place: query head i reads kv head i / (n_heads / kv_heads). q, k and v
// are read through their strides from the [b, s, heads, h] layout (the MHA
// layer passes views of one fused projection), so no copy is made.
//
// Bound on this card: at the serving preset's shapes ([8, 256, 8, 64],
// causal) the work is ~0.54 GFLOP against 8 MiB of q/k/v/o, so the bf16
// tensor-core roofline puts it on the bytes side (~2.5 us at 3.35 TB/s).
//
// Two instances, chosen by dtype in `flash_fwd`:
// - bfloat16 (`flash_fwd_wgmma`): one CTA of two warpgroups (256 threads)
//   per (batch * head, 64-row q tile); the warpgroups take alternate key
//   tiles and merge at the end. Q and the K/V tiles come in by TMA
//   (cp.async.bulk.tensor over 4-D maps of the strided views, 128-byte
//   swizzle, rows past the end zero-filled), K and V through a 2-stage
//   mbarrier ring per warpgroup, so that its next tile loads while one
//   computes. S = Q.K^T is wgmma m64n64k16 (bf16 in, f32 out) from shared
//   memory. The online softmax runs on the accumulator fragment in
//   registers: each row lives in one quad of lanes, so its max and sum
//   take two shuffles; no shared P tile and no CTA barrier. P is rounded to
//   bf16 into the register A operand of a second wgmma, O += P.V, with V
//   the B operand read from shared memory transposed; that rounding is the
//   TPU kernel's p.astype(v.dtype). The f32 accumulator layout of S is the
//   bf16 A layout of P.V, so no data moves between lanes. At the main
//   path's shapes the kernel is latency-bound (a few tiles per CTA, every
//   CTA resident at once), so the design shortens each CTA's serial chain:
//   two warpgroups per q tile, masks only on edge tiles and compiled per
//   mask kind, exp2 on the SFU.
// - float32 (`flash_fwd_kernel`): the tensor cores have no exact f32
//   product (TF32 would miss the f32 limits), so both products are FP32
//   FMAs from f32 staging in shared memory: one CTA of 256 threads per
//   (batch * head, 64-row q tile), four threads to a q row, Q, K, V and P
//   tiles staged as f32 (rows padded by one word against bank conflicts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // TMA, mbarrier, wgmma and packing helpers

namespace {

// -- float32: FP32 FMAs ---------------------------------------------------

constexpr int BQ = 64;             // q rows per CTA
constexpr int BK = 64;             // keys per tile
constexpr int TPR = 4;             // threads per q row
constexpr int THREADS = BQ * TPR;  // 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
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


// -- bfloat16: wgmma and TMA (helpers in sm90.cuh) ----------------------

constexpr int STAGES = 2;
constexpr int WGS = 2;           // warpgroups per CTA; they split the keys

// The CTA's two warpgroups split the q tile's key tiles (warpgroup w takes
// tiles lo + w, lo + w + 2, ...), each with its own online softmax and its
// own 2-stage K/V ring, which halves the serial chain of the longest
// (diagonal) q tiles; at the end warpgroup 1 hands its (m, l, O) to
// warpgroup 0 through shared memory, thread by thread (both hold the same
// rows and columns), and warpgroup 0 merges and writes. Scores are kept in
// log2 units (scale * log2 e folded into one multiply) for exp2. The
// instances are compiled per mask kind (CAUSAL, WINDOWED), so that the
// mask is branch-free selects on compile-time column offsets.
template <int H, bool CAUSAL, bool WINDOWED>
__global__ void __launch_bounds__(WGS * WG_THREADS, H == 64 ? 2 : 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int n_heads, int kv_heads, int seq, float scale,
                    int window) {
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
  uint8_t* sq = smem;                           // [NA][64][64]
  uint8_t* sk = sq + NA * ATOM + wg * RING;     // [STAGES][NA][64][64]
  uint8_t* sv = sk + STAGES * NA * ATOM;        // [STAGES][NA][64][64]

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int head = bh % n_heads;
  const int kvh = head / (n_heads / kv_heads);
  const int q0 = blockIdx.y * TILE;
  const float scale_log2 = scale * 1.4426950408889634f;

  int lo = 0;
  int hi = (seq + TILE - 1) / TILE;
  if (CAUSAL) {
    const int last_row = min(q0 + TILE - 1, seq - 1);
    hi = min(hi, last_row / TILE + 1);
    if (WINDOWED) lo = max(0, q0 - window + 1) / TILE;
  }
  // this warpgroup's tiles: lo + wg + WGS * it
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
    mbar_expect_tx(&bar_q, NA * ATOM);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      tma_load(sq + a * ATOM, &map_q, &bar_q, 64 * a, q0, head, b);
  }
  if (wtid == 0)
    for (int it = 0; it < min(STAGES, n_tiles); ++it) load_kv(it);
  __syncwarp();

  float oacc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[a][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows r0 = q0 + 16 warp + g and r0 + 8
  float l[2] = {0.f, 0.f};          // this thread's share of each row's sum
  const int r0 = q0 + 16 * warp + g;
  const uint32_t q_base = smem_u32(sq);
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

    // S = Q.K^T: H / 16 k-steps, 32 bytes apart inside a 128-byte atom
    float s[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(q_base + off, 16, 1024),
               sw128_desc(k_base + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, mask (only a tile on the diagonal, at the window's edge or
    // past the end has masked elements), row max over the quad
    const bool edge =
        (CAUSAL && (k0 + TILE - 1 > q0 ||
                    (WINDOWED && q0 + TILE - 1 - k0 >= window))) ||
        k0 + TILE > seq;
    // element i: row - col = rel0 + 8 ((i >> 1) & 1) - 8 (i >> 2) - (i & 1)
    // and col - k0 - 2 t = 8 (i >> 2) + (i & 1)
    const int rel0 = r0 - k0 - 2 * t;
    const int seq_left = seq - k0 - 2 * t;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int rel = rel0 + 8 * ((i >> 1) & 1) - 8 * (i >> 2) - (i & 1);
        if (CAUSAL) {
          bool keep = rel >= 0;  // row >= col
          if (WINDOWED) keep = keep & (rel < window);
          x = keep ? x : NEG_INF;
        }
        // keys past the sequence end do not exist: -inf gives p = 0 exactly
        x = 8 * (i >> 2) + (i & 1) < seq_left ? x : -INFINITY;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    // p = exp(s - m), summed unrounded, rounded to bf16 for P.V
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2_approx(s[i] - m[h]);
      const float p1 = exp2_approx(s[i + 1] - m[h]);
      l[h] += p0 + p1;
      pa[i >> 1] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[a][i] *= corr[(i >> 1) & 1];

    // O += P.V: 4 k-steps of 16 keys (2048 bytes of V apart), one
    // 64-column atom of V per instruction
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_rs(oacc[a], pa + 4 * kk,
                 sw128_desc(v_base + a * ATOM + kk * 2048, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(oacc[a]);

    // this warp is done with the stage; refill it with tile it + STAGES
    if (lane == 0) mbar_arrive(&empty[wg][st]);
    if (wtid == 0 && it + STAGES < n_tiles) {
      mbar_wait(&empty[wg][st], phase);
      load_kv(it + STAGES);
    }
    __syncwarp();
  }

  // warpgroup 1 hands (O, m, l) to warpgroup 0, thread by thread, through
  // the rings both are done with
  float* xch = reinterpret_cast<float*>(sq + NA * ATOM);  // [NA*32+4][128]
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        xch[(a * 32 + i) * WG_THREADS + wtid] = oacc[a][i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xch[(NA * 32 + h) * WG_THREADS + wtid] = m[h];
      xch[(NA * 32 + 2 + h) * WG_THREADS + wtid] = l[h];
    }
  }
  __syncthreads();
  if (wg == 1) return;
  float c0[2], c1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = xch[(NA * 32 + h) * WG_THREADS + wtid];
    const float l1 = xch[(NA * 32 + 2 + h) * WG_THREADS + wtid];
    const float mm = fmaxf(m[h], m1);
    c0[h] = exp2_approx(m[h] - mm);
    c1[h] = exp2_approx(m1 - mm);
    l[h] = l[h] * c0[h] + l1 * c1[h];
    m[h] = mm;
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      oacc[a][i] = oacc[a][i] * c0[h] +
                   xch[(a * 32 + i) * WG_THREADS + wtid] * c1[h];
    }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= seq) continue;
    __nv_bfloat16* orow = o + (((long long)b * seq + row) * n_heads + head) * H;
    const float inv_l = 1.f / l[h];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(orow + 64 * a + 8 * j + 2 * t) =
            pack_bf16(oacc[a][i] * inv_l, oacc[a][i + 1] * inv_l);
      }
    // lse in natural units: m * ln 2 + log(l)
    if (t == 0)
      lse[(long long)bh * seq + row] = m[h] * 0.6931471805599453f + logf(l[h]);
  }
}


template <int H, bool CAUSAL, bool WINDOWED>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int batch, int seq, int n_heads,
                         int kv_heads, long long q_sb, long long q_ss,
                         long long q_sn, long long k_sb, long long k_ss,
                         long long k_sn, long long v_sb, long long v_ss,
                         long long v_sn, float scale, int causal, int window,
                         cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, batch, seq, n_heads, H, q_sb, q_ss, q_sn) ||
      !make_map(&mk, k, batch, seq, kv_heads, H, k_sb, k_ss, k_sn) ||
      !make_map(&mv, v, batch, seq, kv_heads, H, v_sb, v_ss, v_sn))
    return cudaErrorInvalidValue;
  // Q, each warpgroup's two stages of K and V, and the slack to align
  // them to 1024 bytes
  const int smem = (1 + WGS * 2 * STAGES) * (H / 64) * ATOM + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<H, CAUSAL, WINDOWED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(batch * n_heads, (seq + TILE - 1) / TILE);
  flash_fwd_wgmma<H, CAUSAL, WINDOWED>
      <<<grid, WGS * WG_THREADS, smem, stream>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(o),
          static_cast<float*>(lse), n_heads, kv_heads, seq, scale, window);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_wgmma_masked(const void* q, const void* k, const void* v,
                                void* o, void* lse, int batch, int seq,
                                int n_heads, int kv_heads, long long q_sb,
                                long long q_ss, long long q_sn,
                                long long k_sb, long long k_ss,
                                long long k_sn, long long v_sb,
                                long long v_ss, long long v_sn, float scale,
                                int causal, int window, cudaStream_t stream) {
#define WG_ARGS                                                             \
  q, k, v, o, lse, batch, seq, n_heads, kv_heads, q_sb, q_ss, q_sn, k_sb, \
      k_ss, k_sn, v_sb, v_ss, v_sn, scale, causal, window, stream
  if (!causal) return launch_wgmma<H, false, false>(WG_ARGS);
  if (window > 0) return launch_wgmma<H, true, true>(WG_ARGS);
  return launch_wgmma<H, true, false>(WG_ARGS);
#undef WG_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head_dim
// axis must be contiguous (bfloat16: 16-byte aligned bases and strides,
// as TMA reads them). o is a contiguous [b, s, n, h] tensor of q's dtype,
// lse a contiguous f32 [b, n, s] tensor. Returns a cudaError_t.
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
    return launch_wgmma_masked<64>(FLASH_ARGS);
  if (dtype == 1 && head_dim == 128)
    return launch_wgmma_masked<128>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
