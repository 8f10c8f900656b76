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
// acc / max(l, 1e-30), as the TPU kernel; a masked key adds exactly 0 to
// l and acc (for a row with a visible key this is the TPU kernel's
// arithmetic: exp(-1e30 - m) is 0).
//
// Replaces (B5) packed_flash_attention_kernel_call (:166, body
// _packed_kernel :108) and ops.packed_flash_attention (ops.py:354) with the
// same source: the KV-load policy (template PACKED) stages the int8
// mantissas and widens them only on the card, multiplies the K scale onto
// the logit after the dot and the V scale onto the probability before PV.
// Both folds are products with a power of two, which commute with every
// f32 rounding, and every sum runs in the same order in both
// instantiations (each rounding spelled as an intrinsic, so the compiler
// contracts nothing differently), so B5 on the card equals B2 over
// dequantize() bit for bit.
//
// Replaces (B6) paged_flash_attention_kernel_call (:264, body
// _paged_kernel :214) and (B7) paged_packed_flash_attention_kernel_call
// (:378, body _paged_packed_kernel :324) with the same source again: a
// third KV-load policy (template PAGED) reads K/V out of a block pool
// (NB,Hkv,bs,D) through a block table (B,MB) int32 instead of a dense
// (B,Hkv,S,D) cache: key j of batch row b, KV head hk lives at pool row
// (table[b*MB + j/bs] * Hkv + hk) * bs + j % bs, for any bs >= 1.  Only the
// address of a key's row changes, never the order or the arithmetic of a
// sum, so B6 over (pool, table) equals B2 over the gathered dense view bit
// for bit, and B7 equals B5 over the gathered packed view.  Table entries
// of keys past a row's last visible key are never read; the wrapper checks
// the others on the CPU only (a check on the card would sync).
//
// Bound on this card: K/V bytes at decode (one query row per head, 4 B of
// f32 K/V per element, a quarter of that packed); f32 FMA operations at
// prefill (no TF32: B2 is held within 1e-5 of its plain version).  The
// first design (one 128-thread block per 16-query tile, 4-byte loads behind
// two or three barriers per 32-key tile, a scalar FMA chain per logit) ran
// 30-130x over that bound.  Two variants of one source, chosen by Sq alone:
//
// Decode (Sq <= DEC_MAX_SQ), split-KV: each row's keys are cut into splits
// of KPS = 128 positions, fixed, so split boundaries depend on key
// positions only.  Grid (splits, KV heads x row chunks, B): a 128-thread
// block serves up to RMAX query rows (the Hq/Hkv query heads of one KV
// head times the Sq queries), so GQA reads each K/V row once.  The split's
// 32-key tiles stream through a two-stage cp.async ring of 16-byte loads;
// warp w owns keys 8w..8w+7 of every tile, lanes hold 4 of the D columns
// (q in registers), a logit is a 4-term FMA chain and an xor butterfly.
// Each warp keeps its own (m, l, acc) and writes it as one partial of the
// row; a second kernel merges the partials of each row in partial order
// with the usual log-sum-exp rescale.  Blocks past a row's last visible key
// exit, and the merge reads only the partials below it.
//
// Prefill (Sq > DEC_MAX_SQ), register-tiled: a 256-thread block owns 64
// queries of one head and walks 64-key tiles up to the tile's last visible
// key (causal early exit), K/V double-buffered by cp.async.  Thread (ty,
// tx) of a 16 x 16 grid keeps a 4 x 4 block of logits (rows 4ty.., keys
// tx + 16j) as an FMA chain over d with float4 shared-memory reads (K rows
// padded to D+4 floats: conflict-free), the online softmax of its 4 rows
// (statistics reduced over the 16 threads of a half-warp by shuffles), and
// a 4 x 8 block of the output (rows 4ty.., columns 4tx.. and 64+4tx..).
// P goes through shared memory within the half-warp.
//
// The contract the tests and chip_smoke.py hold it to: a row's bits depend
// only on its key positions, kv_len and q_pos0 (and Sq, which picks the
// variant): never on B, Hq, Hkv, S or the grid, so a slice of the heads
// or of the batch rows gives the same bits as the matching slice of the
// whole call.  D <= 128 and D % 16 == 0; q, K and V 16-byte aligned.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int DMAX = 128;

// decode: split-KV
constexpr int DEC_MAX_SQ = 8;   // Sq <= this takes the decode variant
constexpr int KPS = 128;        // key positions per split
constexpr int DEC_WARPS = 4;    // partials per split: one per warp
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_TILE = 32;    // keys per staged tile
constexpr int DEC_KPW = DEC_TILE / DEC_WARPS;  // keys per warp and tile
constexpr int RMAX = 8;         // query rows per block

// prefill: register-tiled
constexpr int PBQ = 64;         // queries per block
constexpr int PBK = 64;         // keys per tile
constexpr int P_THREADS = 256;
constexpr int PS_STRIDE = PBK + 4;  // P rows in shared memory

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, zero-filled when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 load4(const float* p) { return *(const float4*)p; }

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *(const char4*)p;
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float s = __fmul_rn(a.x, b.x);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// the pool row (PAGED) or the dense cache row of key j
template <bool PAGED>
__device__ __forceinline__ long long key_row(int j, long long base, const int* tb, int Hkv,
                                             int hk, int bs) {
  if (PAGED) return ((long long)tb[j / bs] * Hkv + hk) * bs + j % bs;
  return base + j;
}

// Start the cp.async loads of keys k0 .. k0+nk-1 (those < k_hi; the rest
// zero-filled) into K/V tiles of row strides ks_ / vs_ elements, and their
// pow2 scales (PACKED).
template <typename KV, bool PACKED, bool PAGED>
__device__ __forceinline__ void load_tile(KV* Kt, KV* Vt, int ks_, int vs_, float* Ksc,
                                          float* Vsc, const KV* k, const KV* v,
                                          const float* ksc, const float* vsc, int k0, int nk,
                                          int k_hi, long long base, const int* tb, int Hkv,
                                          int hk, int bs, int D, int tid, int nthreads) {
  constexpr int EPC = 16 / sizeof(KV);  // elements per 16-byte chunk
  const int cpr = D / EPC;
  for (int i = tid; i < nk * cpr; i += nthreads) {
    const int j = i / cpr;
    const int c = (i - j * cpr) * EPC;
    const bool ok = k0 + j < k_hi;
    const long long row = ok ? key_row<PAGED>(k0 + j, base, tb, Hkv, hk, bs) : 0;
    cp_async16(Kt + j * ks_ + c, k + row * D + c, ok);
    cp_async16(Vt + j * vs_ + c, v + row * D + c, ok);
  }
  if (PACKED) {
    for (int j = tid; j < nk; j += nthreads) {
      const bool ok = k0 + j < k_hi;
      const long long row = ok ? key_row<PAGED>(k0 + j, base, tb, Hkv, hk, bs) : 0;
      cp_async4(Ksc + j, ksc + row, ok);
      cp_async4(Vsc + j, vsc + row, ok);
    }
  }
}

__device__ __forceinline__ bool visible(int key, int len, int qpos, int causal, int window) {
  return key < len && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

__device__ __forceinline__ int last_key(int len, int p0, int q_end, int causal) {
  return causal ? min(len, p0 + q_end) : len;
}

// ---------------------------------------------------------------- decode

// PAGED: k/v (and the scales) are pools with the block axis first, S is
// the logical length MB * bs, and table (B, MB) maps logical blocks to
// pool blocks; otherwise table is null and bs unused.  part holds, per
// query row and partial, acc (D floats) and then, after every row's acc,
// (m, l).  A block serves R query rows: 1 where a KV head has one (MHA
// decode), RMAX otherwise; a row's arithmetic is the same either way.
template <bool PACKED, bool PAGED, int R>
__global__ void __launch_bounds__(DEC_THREADS)
split_kernel(const float* __restrict__ q, const void* __restrict__ k_in,
             const float* __restrict__ k_scale, const void* __restrict__ v_in,
             const float* __restrict__ v_scale, const int* __restrict__ table,
             const int* __restrict__ kv_len, const int* __restrict__ q_pos0,
             float* __restrict__ part, int Hq, int Hkv, int Sq, int S, int D, int bs,
             int causal, int window, float scale, int nparts) {
  using KV = typename std::conditional<PACKED, int8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  KV* Ks = (KV*)smem;                    // [2][DEC_TILE][D]
  KV* Vs = Ks + 2 * DEC_TILE * D;        // [2][DEC_TILE][D]
  float* Ksc = (float*)(Vs + 2 * DEC_TILE * D);  // [2][DEC_TILE], PACKED
  float* Vsc = Ksc + 2 * DEC_TILE;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = Hq / Hkv;
  const int nchunk = (rep * Sq + R - 1) / R;
  const int hk = blockIdx.y / nchunk;
  const int r0 = (blockIdx.y - hk * nchunk) * R;
  const int nr = min(R, rep * Sq - r0);
  const int b = blockIdx.z;
  const int len = min(kv_len[b], S);
  const int p0 = q_pos0[b];
  const int k_lo = blockIdx.x * KPS;
  const int k_end = last_key(len, p0, Sq, causal);
  if (k_lo >= k_end) return;  // the merge reads the splits below k_end only
  const int k_hi = min(k_lo + KPS, k_end);

  const KV* k = (const KV*)k_in;
  const KV* v = (const KV*)v_in;
  const long long base = PAGED ? 0 : ((long long)b * Hkv + hk) * S;
  const int* tb = PAGED ? table + (size_t)b * (S / bs) : nullptr;
  const bool dl = 4 * lane < D;  // this lane's 4 columns exist

  float4 qv[R];
  int qpos[R];
  long long orow[R];  // output row index (b, head, query)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rr = min(r0 + r, rep * Sq - 1);
    const int h = hk * rep + rr / Sq;
    const int qi = rr - (rr / Sq) * Sq;
    orow[r] = ((long long)b * Hq + h) * Sq + qi;
    qpos[r] = p0 + qi;
    qv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr && dl) {
      const float4 t = load4(q + orow[r] * D + 4 * lane);
      qv[r] = make_float4(__fmul_rn(t.x, scale), __fmul_rn(t.y, scale),
                          __fmul_rn(t.z, scale), __fmul_rn(t.w, scale));
    }
  }

  float m[R], l[R];
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int ntile = (k_hi - k_lo + DEC_TILE - 1) / DEC_TILE;
  load_tile<KV, PACKED, PAGED>(Ks, Vs, D, D, Ksc, Vsc, k, v, k_scale, v_scale, k_lo, DEC_TILE,
                               k_hi, base, tb, Hkv, hk, bs, D, tid, DEC_THREADS);
  cp_commit();
  for (int t = 0; t < ntile; ++t) {
    const int nb = (t + 1) & 1;
    if (t + 1 < ntile)
      load_tile<KV, PACKED, PAGED>(Ks + nb * DEC_TILE * D, Vs + nb * DEC_TILE * D, D, D,
                                   Ksc + nb * DEC_TILE, Vsc + nb * DEC_TILE, k, v, k_scale,
                                   v_scale, k_lo + (t + 1) * DEC_TILE, DEC_TILE, k_hi, base,
                                   tb, Hkv, hk, bs, D, tid, DEC_THREADS);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int cb = t & 1;
    const KV* Kt = Ks + cb * DEC_TILE * D;
    const KV* Vt = Vs + cb * DEC_TILE * D;
    const int kbase = k_lo + t * DEC_TILE + warp * DEC_KPW;  // this warp's first key

    float p[R][DEC_KPW];
    unsigned okb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) okb[r] = 0u;
#pragma unroll
    for (int jj = 0; jj < DEC_KPW; ++jj) {
      const int j = warp * DEC_KPW + jj;
      const float4 kk = dl ? load4(Kt + j * D + 4 * lane) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float ks = PACKED ? Ksc[cb * DEC_TILE + j] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) continue;  // block-uniform
        float s = dot4(qv[r], kk);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(FULL_MASK, s, off));
        if (PACKED) s = __fmul_rn(s, ks);  // K scale after the dot
        const bool ok = visible(kbase + jj, len, qpos[r], causal, window);
        p[r][jj] = ok ? s : NEG_INF;
        okb[r] |= ok ? 1u << jj : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) continue;
      float mt = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < DEC_KPW; ++jj) mt = fmaxf(mt, p[r][jj]);
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int jj = 0; jj < DEC_KPW; ++jj) {
        p[r][jj] = (okb[r] >> jj) & 1u ? expf(p[r][jj] - m_new) : 0.f;
        ls = __fadd_rn(ls, p[r][jj]);
      }
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), ls);
      m[r] = m_new;
      acc[r] = make_float4(__fmul_rn(acc[r].x, alpha), __fmul_rn(acc[r].y, alpha),
                           __fmul_rn(acc[r].z, alpha), __fmul_rn(acc[r].w, alpha));
    }
#pragma unroll
    for (int jj = 0; jj < DEC_KPW; ++jj) {
      const int j = warp * DEC_KPW + jj;
      const float4 vv = dl ? load4(Vt + j * D + 4 * lane) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float vsc = PACKED ? Vsc[cb * DEC_TILE + j] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) continue;
        const float pv = PACKED ? __fmul_rn(p[r][jj], vsc) : p[r][jj];  // V scale into p
        acc[r].x = fmaf(pv, vv.x, acc[r].x);
        acc[r].y = fmaf(pv, vv.y, acc[r].y);
        acc[r].z = fmaf(pv, vv.z, acc[r].z);
        acc[r].w = fmaf(pv, vv.w, acc[r].w);
      }
    }
    __syncthreads();  // the next load refills this buffer
  }

  const int pi = blockIdx.x * DEC_WARPS + warp;
  const long long nrows = (long long)gridDim.z * Hq * Sq;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) continue;
    const long long slot = orow[r] * nparts + pi;
    if (dl) *(float4*)(part + slot * D + 4 * lane) = acc[r];
    if (lane == 0) {
      float* ml = part + nrows * nparts * D + slot * 2;
      ml[0] = m[r];
      ml[1] = l[r];
    }
  }
}

// One warp per query row: the row's partials merged in partial order.
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ part, const int* __restrict__ kv_len,
             const int* __restrict__ q_pos0, float* __restrict__ o, int B, int Hq, int Sq,
             int S, int D, int causal, int nparts) {
  const int lane = threadIdx.x & 31;
  const long long nrows = (long long)B * Hq * Sq;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= nrows) return;
  const int b = (int)(row / ((long long)Hq * Sq));
  const int len = min(kv_len[b], S);
  const int k_end = last_key(len, q_pos0[b], Sq, causal);
  const int np = k_end > 0 ? (k_end + KPS - 1) / KPS * DEC_WARPS : 0;
  const float* ml = part + nrows * nparts * D + row * nparts * 2;
  const float* pa = part + row * nparts * D + 4 * lane;
  const bool dl = 4 * lane < D;

  float M = NEG_INF;
  for (int p = 0; p < np; ++p) M = fmaxf(M, ml[2 * p]);
  float L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < np; ++p) {
    const float e = expf(ml[2 * p] - M);
    L = __fadd_rn(L, __fmul_rn(ml[2 * p + 1], e));
    if (dl) {
      const float4 a = load4(pa + (size_t)p * D);
      A = make_float4(__fadd_rn(A.x, __fmul_rn(a.x, e)), __fadd_rn(A.y, __fmul_rn(a.y, e)),
                      __fadd_rn(A.z, __fmul_rn(a.z, e)), __fadd_rn(A.w, __fmul_rn(a.w, e)));
    }
  }
  if (dl) {
    const float den = fmaxf(L, 1e-30f);
    *(float4*)(o + row * D + 4 * lane) =
        make_float4(__fdiv_rn(A.x, den), __fdiv_rn(A.y, den), __fdiv_rn(A.z, den),
                    __fdiv_rn(A.w, den));
  }
}

// --------------------------------------------------------------- prefill

template <bool PACKED>
constexpr size_t tile_smem(int D) {
  // Qs [PBQ][D+4], Ps [PBQ][PS_STRIDE], then
  // f32:    K [2][PBK][D+4], V [2][PBK][D]
  // PACKED: K, V f32 [PBK][D+4] / [PBK][D] (widened), int8 K, V [2][PBK][D],
  //         scales [2][PBK] each
  return 4 * ((size_t)PBQ * (D + 4) + (size_t)PBQ * PS_STRIDE) +
         (PACKED ? 4 * ((size_t)PBK * (D + 4) + (size_t)PBK * D) + 2 * 2 * (size_t)PBK * D +
                       4 * 2 * 2 * PBK
                 : 4 * (2 * (size_t)PBK * (D + 4) + 2 * (size_t)PBK * D));
}

template <bool PACKED, bool PAGED>
__global__ void __launch_bounds__(P_THREADS)
tile_kernel(const float* __restrict__ q, const void* __restrict__ k_in,
            const float* __restrict__ k_scale, const void* __restrict__ v_in,
            const float* __restrict__ v_scale, const int* __restrict__ table,
            const int* __restrict__ kv_len, const int* __restrict__ q_pos0,
            float* __restrict__ o, int Hq, int Hkv, int Sq, int S, int D, int bs, int causal,
            int window, float scale) {
  using KV = typename std::conditional<PACKED, int8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int QS = D + 4;  // Q and K row strides (floats)
  float* Qs = (float*)smem;
  float* Ps = Qs + PBQ * QS;
  float* Kf = Ps + PBQ * PS_STRIDE;  // f32 K tiles (PACKED: the widened one)
  float* Vf = Kf + (PACKED ? 1 : 2) * PBK * QS;
  KV* Kst;  // the staging ring the loads fill
  KV* Vst;
  int kst_stride;
  float* Ksc = nullptr;
  float* Vsc = nullptr;
  if (PACKED) {
    int8_t* k8 = (int8_t*)(Vf + PBK * D);
    Kst = (KV*)k8;
    Vst = (KV*)(k8 + 2 * PBK * D);
    Ksc = (float*)(k8 + 4 * PBK * D);
    Vsc = Ksc + 2 * PBK;
    kst_stride = D;
  } else {
    Kst = (KV*)Kf;
    Vst = (KV*)Vf;
    kst_stride = QS;
  }

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4ty .. 4ty+3
  const int tx = tid & 15;  // keys tx + 16j; output columns 4tx.., 64+4tx..
  const int q0 = blockIdx.x * PBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int len = min(kv_len[b], S);
  const int p0 = q_pos0[b];
  const KV* k = (const KV*)k_in;
  const KV* v = (const KV*)v_in;
  const long long base = PAGED ? 0 : ((long long)b * Hkv + hk) * S;
  const int* tb = PAGED ? table + (size_t)b * (S / bs) : nullptr;
  const float* qb = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  float* ob = o + ((size_t)b * Hq + h) * (size_t)Sq * D;

  // keys past the tile's last query position are masked for every row of
  // the tile: stop there instead of streaming them
  const int k_end = last_key(len, p0, min(q0 + PBQ, Sq), causal);
  const int ntile = k_end > 0 ? (k_end + PBK - 1) / PBK : 0;
  if (ntile > 0)
    load_tile<KV, PACKED, PAGED>(Kst, Vst, kst_stride, D, Ksc, Vsc, k, v, k_scale, v_scale, 0,
                                 PBK, k_end, base, tb, Hkv, hk, bs, D, tid, P_THREADS);
  cp_commit();

  const int d4 = D / 4;
  for (int i = tid; i < PBQ * d4; i += P_THREADS) {
    const int r = i / d4;
    const int c = (i - r * d4) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      t = load4(qb + (size_t)(q0 + r) * D + c);
      t = make_float4(__fmul_rn(t.x, scale), __fmul_rn(t.y, scale), __fmul_rn(t.z, scale),
                      __fmul_rn(t.w, scale));
    }
    *(float4*)(Qs + r * QS + c) = t;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  const int c0 = 4 * tx;       // output columns c0.. and c1..
  const int c1 = 64 + 4 * tx;
  const bool c0ok = c0 < D;
  const bool c1ok = c1 < D;

  for (int t = 0; t < ntile; ++t) {
    const int nb = (t + 1) & 1;
    if (t + 1 < ntile)
      load_tile<KV, PACKED, PAGED>(
          Kst + nb * PBK * kst_stride, Vst + nb * PBK * D, kst_stride, D,
          PACKED ? Ksc + nb * PBK : nullptr, PACKED ? Vsc + nb * PBK : nullptr, k, v,
          k_scale, v_scale, (t + 1) * PBK, PBK, k_end, base, tb, Hkv, hk, bs, D, tid,
          P_THREADS);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int cb = t & 1;
    const float* Kt;
    const float* Vt;
    if (PACKED) {  // widen the int8 mantissas into the f32 tile
      const int8_t* k8 = (const int8_t*)Kst + cb * PBK * D;
      const int8_t* v8 = (const int8_t*)Vst + cb * PBK * D;
      for (int i = tid; i < PBK * d4; i += P_THREADS) {
        const int j = i / d4;
        const int c = (i - j * d4) * 4;
        *(float4*)(Kf + j * QS + c) = load4(k8 + j * D + c);
        *(float4*)(Vf + j * D + c) = load4(v8 + j * D + c);
      }
      __syncthreads();
      Kt = Kf;
      Vt = Vf;
    } else {
      Kt = Kf + cb * PBK * QS;
      Vt = Vf + cb * PBK * D;
    }

    // ---- logits: a 4 x 4 block, an FMA chain over d ----
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(Qs + (4 * ty + i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = load4(Kt + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = fmaf(a[i].x, kk[j].x, s[i][j]);
          x = fmaf(a[i].y, kk[j].y, x);
          x = fmaf(a[i].z, kk[j].z, x);
          s[i][j] = fmaf(a[i].w, kk[j].w, x);
        }
    }

    // ---- online softmax of rows 4ty.. over the 16 threads of a half-warp ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * ty + i;
      const int qpos = p0 + q0 + row;
      bool ok[4];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        float x = s[i][j];
        if (PACKED) x = __fmul_rn(x, Ksc[cb * PBK + kj]);  // K scale after the dot
        ok[j] = visible(t * PBK + kj, len, qpos, causal, window);
        s[i][j] = ok[j] ? x : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps = __fadd_rn(ps, p);
        Ps[row * PS_STRIDE + kj] = PACKED ? __fmul_rn(p, Vsc[cb * PBK + kj]) : p;  // V scale
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps = __fadd_rn(ps, __shfl_xor_sync(FULL_MASK, ps, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncwarp();  // P rows 4ty.. are written and read by one half-warp

    // ---- O += P V: a 4 x 8 block, an FMA chain over the tile's keys ----
    for (int j = 0; j < PBK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = load4(Ps + (4 * ty + i) * PS_STRIDE + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vt + (j + u) * D;
        const float4 v0 = c0ok ? load4(vr + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 v1 = c1ok ? load4(vr + c1) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pr[i].x : u == 1 ? pr[i].y : u == 2 ? pr[i].z : pr[i].w;
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
    __syncthreads();  // the next load refills this buffer
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = ob + (size_t)r * D;
    if (c0ok)
      *(float4*)(orow + c0) = make_float4(__fdiv_rn(acc[i][0], den), __fdiv_rn(acc[i][1], den),
                                          __fdiv_rn(acc[i][2], den), __fdiv_rn(acc[i][3], den));
    if (c1ok)
      *(float4*)(orow + c1) = make_float4(__fdiv_rn(acc[i][4], den), __fdiv_rn(acc[i][5], den),
                                          __fdiv_rn(acc[i][6], den), __fdiv_rn(acc[i][7], den));
  }
}

// --------------------------------------------------------------- launch

template <bool PACKED, bool PAGED>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* table, const void* kv_len, const void* q_pos0, void* o, void* part,
           long long part_floats, int B, int Hq, int Hkv, int Sq, int S, int D, int bs,
           int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || S <= 0 || D <= 0 || D > DMAX || D % 16 || Hkv <= 0 ||
      Hq % Hkv != 0 || (PAGED && bs <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using KV = typename std::conditional<PACKED, int8_t, float>::type;
  // above 48 KB of shared memory only after opting in: once per kernel,
  // for D = DMAX
  const int split_max = (int)(4 * DEC_TILE * DMAX * sizeof(KV) + 16 * DEC_TILE);
  static const cudaError_t split_attr =
      cudaFuncSetAttribute(split_kernel<PACKED, PAGED, 1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, split_max);
  static const cudaError_t split_attr_r =
      cudaFuncSetAttribute(split_kernel<PACKED, PAGED, RMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, split_max);
  static const cudaError_t tile_attr =
      cudaFuncSetAttribute(tile_kernel<PACKED, PAGED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)tile_smem<PACKED>(DMAX));
  if (split_attr != cudaSuccess) return (int)split_attr;
  if (split_attr_r != cudaSuccess) return (int)split_attr_r;
  if (tile_attr != cudaSuccess) return (int)tile_attr;
  cudaError_t err;
  if (Sq <= DEC_MAX_SQ) {
    const int nsplit = (S + KPS - 1) / KPS;
    const int nparts = nsplit * DEC_WARPS;
    const long long need = (long long)B * Hq * Sq * nparts * (D + 2);
    if (part == nullptr || part_floats < need) return (int)cudaErrorInvalidValue;
    const int rows = Hq / Hkv * Sq;  // query rows per KV head
    const int r = rows == 1 ? 1 : RMAX;
    const size_t smem = 4 * (size_t)DEC_TILE * D * sizeof(KV) + (PACKED ? 16 * DEC_TILE : 0);
    const dim3 grid(nsplit, Hkv * ((rows + r - 1) / r), B);
    (r == 1 ? split_kernel<PACKED, PAGED, 1> : split_kernel<PACKED, PAGED, RMAX>)
        <<<grid, DEC_THREADS, smem, st>>>(
            (const float*)q, k, (const float*)ks, v, (const float*)vs, (const int*)table,
            (const int*)kv_len, (const int*)q_pos0, (float*)part, Hq, Hkv, Sq, S, D, bs,
            causal, window, scale, nparts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long nrows = (long long)B * Hq * Sq;
    merge_kernel<<<(unsigned)((nrows + 3) / 4), 128, 0, st>>>(
        (const float*)part, (const int*)kv_len, (const int*)q_pos0, (float*)o, B, Hq, Sq, S,
        D, causal, nparts);
  } else {
    tile_kernel<PACKED, PAGED><<<dim3((Sq + PBQ - 1) / PBQ, Hq, B), P_THREADS, tile_smem<PACKED>(D), st>>>(
        (const float*)q, k, (const float*)ks, v, (const float*)vs, (const int*)table,
        (const int*)kv_len, (const int*)q_pos0, (float*)o, Hq, Hkv, Sq, S, D, bs, causal,
        window, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// part: f32 scratch for the decode variant's partials (Sq <= 8), at least
// B*Hq*Sq * 4*ceil(S/128) * (D+2) floats; unused (may be null) otherwise.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* kv_len, const void* q_pos0, void* o,
                                      void* part, long long part_floats, int B, int Hq,
                                      int Hkv, int Sq, int S, int D, int causal, int window,
                                      float scale, void* stream) {
  return launch<false, false>(q, k, nullptr, v, nullptr, nullptr, kv_len, q_pos0, o, part,
                              part_floats, B, Hq, Hkv, Sq, S, D, 1, causal, window, scale,
                              stream);
}

extern "C" int packed_flash_attention_launch(
    const void* q, const void* k_qm, const void* k_scale, const void* v_qm,
    const void* v_scale, const void* kv_len, const void* q_pos0, void* o, void* part,
    long long part_floats, int B, int Hq, int Hkv, int Sq, int S, int D, int causal,
    int window, float scale, void* stream) {
  return launch<true, false>(q, k_qm, k_scale, v_qm, v_scale, nullptr, kv_len, q_pos0, o,
                             part, part_floats, B, Hq, Hkv, Sq, S, D, 1, causal, window,
                             scale, stream);
}

// B6: pools (NB,Hkv,bs,D) f32, table (B,MB) int32
extern "C" int paged_flash_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* kv_len, const void* q_pos0, void* o, void* part, long long part_floats,
    int B, int Hq, int Hkv, int Sq, int MB, int bs, int D, int causal, int window,
    float scale, void* stream) {
  return launch<false, true>(q, k_pool, nullptr, v_pool, nullptr, table, kv_len, q_pos0, o,
                             part, part_floats, B, Hq, Hkv, Sq, MB * bs, D, bs, causal,
                             window, scale, stream);
}

// B7: pools qm (NB,Hkv,bs,D) int8 and scale (NB,Hkv,bs,1) f32
extern "C" int paged_packed_flash_attention_launch(
    const void* q, const void* k_qm, const void* k_scale, const void* v_qm,
    const void* v_scale, const void* table, const void* kv_len, const void* q_pos0, void* o,
    void* part, long long part_floats, int B, int Hq, int Hkv, int Sq, int MB, int bs, int D,
    int causal, int window, float scale, void* stream) {
  return launch<true, true>(q, k_qm, k_scale, v_qm, v_scale, table, kv_len, q_pos0, o, part,
                            part_floats, B, Hq, Hkv, Sq, MB * bs, D, bs, causal, window,
                            scale, stream);
}
