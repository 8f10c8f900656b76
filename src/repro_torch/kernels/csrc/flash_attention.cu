// Online-softmax (flash) attention for Hopper, with per-row key length and
// query offset: o (B,Hq,Sq,D) from q (B,Hq,Sq,D) f32 and K/V (B,Hkv,S,D),
// either f32 (B2) or packed (B5): int8 aligned mantissas with a pow2 scale
// (B,Hkv,S,1) per (token, head).
//
// Replaces (B2) src/repro/kernels/flash_attention.py::
// flash_attention_kernel_call (:70, body _kernel :26, pallas_call :86) and
// its GQA wrapper ops.flash_attention (src/repro/kernels/ops.py:333),
// widened so it also stands in for the jnp mirrors the JAX model calls:
// models/attention.py::blockwise_attention (:116, kv_lens) and
// decode_attention (:220, per-row pos).  Query i of batch row b sits at
// absolute position q_pos0[b] + i; keys at positions >= kv_len[b] are
// masked, as are keys after the query (causal) and keys at or before
// query - window (window > 0).  Masked logits are -1e30 and the output is
// acc / max(l, 1e-30), exactly as the TPU kernel.
//
// Replaces (B5) packed_flash_attention_kernel_call (:166, body
// _packed_kernel :108) and ops.packed_flash_attention (ops.py:354) with the
// same source: the KV-load policy (template PACKED) widens the int8
// mantissas only into shared memory, multiplies the K scale onto the
// logit after the dot and the V scale onto the probability before PV.
// Both folds are products with a power of two, which commute with every
// f32 rounding, so B5 on the card equals B2 over dequantize() bit for bit;
// the f32 instantiation is B2's code unchanged.
//
// Bound on this card: K/V bytes at decode (one query row per head; B5
// reads a quarter of B2's bytes); f32 operations at prefill.  Design of
// this first version: one 128-thread block per (16-query tile, head, batch
// row); a loop over 32-key tiles up to the row's last visible key stages K
// (rows padded to D+1 floats, so lanes reading one column hit distinct
// banks) and V in shared memory as f32; f32 FMA dots, no TF32 and no
// tensor cores.  Warp w keeps the running max and sum of rows w, w+4, w+8,
// w+12 in registers (lane = key of the tile for the score, then warp
// reductions); thread t keeps the output column d = t of all 16 rows in
// registers.  GQA is index arithmetic: head h reads kv head h / (Hq/Hkv).
// D <= 128.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BQ = 16;
constexpr int BKV = 32;
constexpr int DMAX = 128;
constexpr int THREADS = 128;
constexpr int RPW = BQ / 4;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const float* __restrict__ q, const void* __restrict__ k_in,
                 const float* __restrict__ k_scale,
                 const void* __restrict__ v_in,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ kv_len,
                 const int* __restrict__ q_pos0, float* __restrict__ o, int Hq,
                 int Hkv, int Sq, int S, int D, int causal, int window,
                 float scale) {
  using KV = typename std::conditional<PACKED, int8_t, float>::type;
  const KV* k = (const KV*)k_in;
  const KV* v = (const KV*)v_in;
  __shared__ float Qs[BQ][DMAX];
  __shared__ float Ks[BKV][DMAX + 1];
  __shared__ float Vs[BKV][DMAX];
  __shared__ float Ps[BQ][BKV];
  __shared__ float Alpha[BQ];
  __shared__ float Lrow[BQ];
  __shared__ float Ksc[PACKED ? BKV : 1];  // the tile's pow2 K/V scales
  __shared__ float Vsc[PACKED ? BKV : 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  const KV* kb = k + ((size_t)b * Hkv + hk) * (size_t)S * D;
  const KV* vb = v + ((size_t)b * Hkv + hk) * (size_t)S * D;
  const float* ksb = PACKED ? k_scale + ((size_t)b * Hkv + hk) * (size_t)S : nullptr;
  const float* vsb = PACKED ? v_scale + ((size_t)b * Hkv + hk) * (size_t)S : nullptr;
  float* ob = o + ((size_t)b * Hq + h) * (size_t)Sq * D;
  const int len = min(kv_len[b], S);
  const int p0 = q_pos0[b];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    Qs[r][d] = q0 + r < Sq ? qb[(size_t)(q0 + r) * D + d] * scale : 0.f;
  }

  float m_run[RPW], l_run[RPW], acc[BQ];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < BQ; ++r) acc[r] = 0.f;

  // keys past the tile's last query position are masked for every row of
  // the tile: stop there instead of streaming them
  int kv_end = len;
  if (causal) kv_end = min(kv_end, p0 + min(q0 + BQ, Sq));

  for (int t0 = 0; t0 < kv_end; t0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int j = i / D;
      const int d = i - j * D;
      const bool ok = t0 + j < kv_end;
      Ks[j][d] = ok ? (float)kb[(size_t)(t0 + j) * D + d] : 0.f;
      Vs[j][d] = ok ? (float)vb[(size_t)(t0 + j) * D + d] : 0.f;
    }
    if (PACKED && tid < BKV) {
      const bool ok = t0 + tid < kv_end;
      Ksc[tid] = ok ? ksb[t0 + tid] : 0.f;
      Vsc[tid] = ok ? vsb[t0 + tid] : 0.f;
    }
    __syncthreads();

    const int kpos = t0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + 4 * r;
      const int qpos = p0 + q0 + row;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[row][d], Ks[lane][d], s);
      if (PACKED) s = __fmul_rn(s, Ksc[lane]);  // K scale after the dot
      bool ok = kpos < len;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s = ok ? s : NEG_INF;
      const float m_new = fmaxf(m_run[r], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
      Ps[row][lane] = PACKED ? __fmul_rn(p, Vsc[lane]) : p;  // V scale into p
      if (lane == 0) Alpha[row] = alpha;
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int row = 0; row < BQ; ++row) {
        float a = acc[row] * Alpha[row];
#pragma unroll 8
        for (int j = 0; j < BKV; ++j) a = fmaf(Ps[row][j], Vs[j][tid], a);
        acc[row] = a;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) Lrow[warp + 4 * r] = l_run[r];
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int row = 0; row < BQ; ++row)
      if (q0 + row < Sq)
        ob[(size_t)(q0 + row) * D + tid] = acc[row] / fmaxf(Lrow[row], 1e-30f);
  }
}

bool bad_shape(int B, int Hq, int Hkv, int Sq, int S, int D) {
  return B <= 0 || Sq <= 0 || S <= 0 || D <= 0 || D > DMAX || Hkv <= 0 ||
         Hq % Hkv != 0;
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* kv_len,
                                      const void* q_pos0, void* o, int B,
                                      int Hq, int Hkv, int Sq, int S, int D,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, S, D)) return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  attention_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, k, nullptr, v, nullptr, (const int*)kv_len,
      (const int*)q_pos0, (float*)o, Hq, Hkv, Sq, S, D, causal, window, scale);
  return (int)cudaGetLastError();
}

extern "C" int packed_flash_attention_launch(
    const void* q, const void* k_qm, const void* k_scale, const void* v_qm,
    const void* v_scale, const void* kv_len, const void* q_pos0, void* o,
    int B, int Hq, int Hkv, int Sq, int S, int D, int causal, int window,
    float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, S, D)) return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  attention_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, k_qm, (const float*)k_scale, v_qm,
      (const float*)v_scale, (const int*)kv_len, (const int*)q_pos0,
      (float*)o, Hq, Hkv, Sq, S, D, causal, window, scale);
  return (int)cudaGetLastError();
}
