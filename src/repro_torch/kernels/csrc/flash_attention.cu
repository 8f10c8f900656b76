// Online-softmax (flash) attention for Hopper, with per-row key length and
// query offset: o (B,Hq,Sq,D) from q (B,Hq,Sq,D), k/v (B,Hkv,S,D), f32.
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
// Bound on this card: K/V bytes at decode (one query row per head); f32
// operations at prefill.  Design of this first version: one 128-thread
// block per (16-query tile, head, batch row); a loop over 32-key tiles up
// to the row's last visible key stages K (rows padded to D+1 floats, so
// lanes reading one column hit distinct banks) and V in shared memory;
// f32 FMA dots, no TF32 and no tensor cores.  Warp w keeps the running
// max and sum of rows w, w+4, w+8, w+12 in registers (lane = key of the
// tile for the score, then warp reductions); thread t keeps the output
// column d = t of all 16 rows in registers.  GQA is index arithmetic:
// head h reads kv head h / (Hq/Hkv).  D <= 128.
#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ q_pos0, float* __restrict__ o,
                       int Hq, int Hkv, int Sq, int S, int D, int causal,
                       int window, float scale) {
  __shared__ float Qs[BQ][DMAX];
  __shared__ float Ks[BKV][DMAX + 1];
  __shared__ float Vs[BKV][DMAX];
  __shared__ float Ps[BQ][BKV];
  __shared__ float Alpha[BQ];
  __shared__ float Lrow[BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  const float* kb = k + ((size_t)b * Hkv + hk) * (size_t)S * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * (size_t)S * D;
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
      Ks[j][d] = ok ? kb[(size_t)(t0 + j) * D + d] : 0.f;
      Vs[j][d] = ok ? vb[(size_t)(t0 + j) * D + d] : 0.f;
    }
    __syncthreads();

    const int kpos = t0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + 4 * r;
      const int qpos = p0 + q0 + row;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[row][d], Ks[lane][d], s);
      bool ok = kpos < len;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s = ok ? s : NEG_INF;
      const float m_new = fmaxf(m_run[r], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
      Ps[row][lane] = p;
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

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* kv_len,
                                      const void* q_pos0, void* o, int B,
                                      int Hq, int Hkv, int Sq, int S, int D,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || S <= 0 || D <= 0 || D > DMAX || Hkv <= 0 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)kv_len,
      (const int*)q_pos0, (float*)o, Hq, Hkv, Sq, S, D, causal, window, scale);
  return (int)cudaGetLastError();
}
