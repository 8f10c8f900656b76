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
// 30-130x over that bound.  Two variants of one source, chosen by Sq alone,
// each instantiated per head-dim class DC (D <= 128 or D <= 256; the text
// below gives the DC = 128 numbers, DC = 256's follow it):
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
// exit, and the merge reads only the partials below it.  DC = 256: lanes
// hold 8 of the D columns (4 at c and 4 at 128 + c) and the split's keys
// stream in 16-key tiles (warp w owns keys 4w..4w+3 of each), so the ring
// stays at 64 KB; a split still ends every 128 key positions.
//
// Prefill (Sq > DEC_MAX_SQ), register-tiled: a 256-thread block owns 64
// queries of one head and walks 64-key tiles up to the tile's last visible
// key (causal early exit), K/V double-buffered by cp.async.  Thread (ty,
// tx) of a 16 x 16 grid keeps a 4 x 4 block of logits (rows 4ty.., keys
// tx + 16j) as an FMA chain over d with float4 shared-memory reads (K rows
// padded to D+4 floats: conflict-free), the online softmax of its 4 rows
// (statistics reduced over the 16 threads of a half-warp by shuffles), and
// a 4 x 8 block of the output (rows 4ty.., columns 4tx.. and 64+4tx..).
// P goes through shared memory within the half-warp.  DC = 256: 32-key
// tiles (4 x 2 logits a thread, keys tx and tx + 16) and a 4 x 16 block of
// the output (columns 4tx + 64c), so Q, P and the double-buffered K/V tiles
// fit the 227 KB a block may have (203 KB in f32).
//
// Any D up to 256: shared-memory rows are Dp = D rounded up to 16 columns,
// the pad columns of Q, K and V tiles are zero (so they add exact zeros to
// every dot), and where D % 16 != 0 rows are not 16-byte aligned in device
// memory, so K/V are staged by 4-byte cp.async (f32) or byte copies (int8)
// and q, o by single floats: a slower path of the same instantiation,
// chosen per launch, whose arithmetic is that of the aligned path.
//
// The contract the tests and chip_smoke.py hold it to: a row's bits depend
// only on its key positions, kv_len and q_pos0 (and Sq, which picks the
// variant, and D): never on B, Hq, Hkv, S or the grid, so a slice of the
// heads or of the batch rows gives the same bits as the matching slice of
// the whole call.  q, K and V 16-byte aligned.
//
// bfloat16 (the models' dtype at full size): every kernel is also
// instantiated for q, o and float K/V in bf16 (template T; B5 / B7 keep
// their int8 mantissas and f32 scales), in a library of its own built from
// this source with -DFA_BF16 (one element type per build: the two build in
// parallel).  The TPU kernels load bf16 q, k, v,
// cast them to f32, scale q in f32 and round once, to the output's dtype,
// where they write (flash_attention.py :38-40, :64 and the other bodies'
// twins).  So does this source: a bf16 element is widened exactly (4 of
// them a load4, 8 bytes), K/V tiles are staged as bf16 and widened into
// the f32 tile as the int8 mantissas are (prefill), every f32 operation
// and its order are those of the f32 instantiation, and the output (or the
// split-KV merge's) is rounded once with __float2bfloat16_rn.  A bf16 call
// therefore equals the f32 call on the exact upcasts of its operands, its
// output rounded once, bit for bit; it moves half the K/V bytes (2 B an
// element).  Still the f32 FMA pipe: a tensor-core (wgmma) design is later
// work.
//
// Any D above 256 (no config of either package has one; the reference's
// kernels take it): a third kernel, one warp per query row with the head
// dim strided over the lanes (row_kernel, below), for every policy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int DMAX = 256;

// decode: split-KV
constexpr int DEC_MAX_SQ = 8;   // Sq <= this takes the decode variant
constexpr int KPS = 128;        // key positions per split
constexpr int DEC_WARPS = 4;    // partials per split: one per warp
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int RMAX = 8;         // query rows per block

// prefill: register-tiled
constexpr int PBQ = 64;         // queries per block
constexpr int P_THREADS = 256;

// the tiling of one head-dim class (D <= DC)
template <int DC>
struct Dims {
  static_assert(DC == 128 || DC == 256, "head-dim classes: D <= 128, D <= 256");
  static constexpr int NC = DC / 128;                   // decode: float4 columns a lane
  static constexpr int DEC_TILE = DC == 128 ? 32 : 16;  // decode: keys per staged tile
  static constexpr int DEC_KPW = DEC_TILE / DEC_WARPS;  // decode: keys per warp and tile
  static constexpr int PBK = DC == 128 ? 64 : 32;       // prefill: keys per tile
  static constexpr int KJ = PBK / 16;                   // prefill: keys (logits) a thread
  static constexpr int OC = DC / 64;                    // prefill: float4 output columns a thread
  static constexpr int PS_STRIDE = PBK + 4;             // prefill: P rows in shared memory
  static_assert(KPS % DEC_TILE == 0, "a split is whole tiles");
};

// shared-memory row length: D rounded up to 16 columns (pads are zero)
__host__ __device__ constexpr int pad16(int d) { return (d + 15) & ~15; }

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

using bf16 = __nv_bfloat16;

// one element as f32 (exact for every element type) and an f32 value as
// an element (bf16: rounded to nearest even, once)
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ int8_t from_f<int8_t>(float x) { return (int8_t)x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float4 load4(const float* p) { return *(const float4*)p; }

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *(const char4*)p;
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// 4 bf16 (8 bytes) widened to a float4
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *(const uint2*)p;
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// columns c .. c+3 of a row of D elements that need not be aligned (zero
// past D)
template <typename T>
__device__ __forceinline__ float4 load4_any(const T* row, int c, int D) {
  return make_float4(c < D ? to_f(row[c]) : 0.f, c + 1 < D ? to_f(row[c + 1]) : 0.f,
                     c + 2 < D ? to_f(row[c + 2]) : 0.f, c + 3 < D ? to_f(row[c + 3]) : 0.f);
}

// columns c .. c+3 of a row of D elements: one 16-byte (f32) or 8-byte
// (bf16) store where D % 16 == 0 (vec), else the columns below D one by
// one; a bf16 row takes each value rounded once
__device__ __forceinline__ void store4(float* row, int c, int D, bool vec, float4 t) {
  if (vec) {
    *(float4*)(row + c) = t;
    return;
  }
  if (c < D) row[c] = t.x;
  if (c + 1 < D) row[c + 1] = t.y;
  if (c + 2 < D) row[c + 2] = t.z;
  if (c + 3 < D) row[c + 3] = t.w;
}

__device__ __forceinline__ void store4(bf16* row, int c, int D, bool vec, float4 t) {
  if (vec) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(t.x, t.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(t.z, t.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *(uint2*)(row + c) = u;
    return;
  }
  if (c < D) row[c] = __float2bfloat16_rn(t.x);
  if (c + 1 < D) row[c + 1] = __float2bfloat16_rn(t.y);
  if (c + 2 < D) row[c + 2] = __float2bfloat16_rn(t.z);
  if (c + 3 < D) row[c + 3] = __float2bfloat16_rn(t.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float s = __fmul_rn(a.x, b.x);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float dot4_acc(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}

// the pool row (PAGED) or the dense cache row of key j
template <bool PAGED>
__device__ __forceinline__ long long key_row(int j, long long base, const int* tb, int Hkv,
                                             int hk, int bs) {
  if (PAGED) return ((long long)tb[j / bs] * Hkv + hk) * bs + j % bs;
  return base + j;
}

// Start the loads of keys k0 .. k0+nk-1 (those < k_hi; the rest zero-filled)
// into K/V tiles of row strides ks_ / vs_ elements, and their pow2 scales
// (PACKED).  Rows of D elements: 16-byte cp.async where D % 16 == 0 (vec),
// else 4-byte cp.async (f32) or element copies (int8, bf16), columns below
// D only.
template <typename KV, bool PACKED, bool PAGED>
__device__ __forceinline__ void load_tile(KV* Kt, KV* Vt, int ks_, int vs_, float* Ksc,
                                          float* Vsc, const KV* k, const KV* v,
                                          const float* ksc, const float* vsc, int k0, int nk,
                                          int k_hi, long long base, const int* tb, int Hkv,
                                          int hk, int bs, int D, bool vec, int tid,
                                          int nthreads) {
  if (vec) {
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
  } else {
    for (int i = tid; i < nk * D; i += nthreads) {
      const int j = i / D;
      const int c = i - j * D;
      const bool ok = k0 + j < k_hi;
      const long long row = ok ? key_row<PAGED>(k0 + j, base, tb, Hkv, hk, bs) : 0;
      if constexpr (sizeof(KV) == 4) {
        cp_async4(Kt + j * ks_ + c, k + row * D + c, ok);
        cp_async4(Vt + j * vs_ + c, v + row * D + c, ok);
      } else {
        Kt[j * ks_ + c] = ok ? k[row * D + c] : from_f<KV>(0.f);
        Vt[j * vs_ + c] = ok ? v[row * D + c] : from_f<KV>(0.f);
      }
    }
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

// zero the pad columns D .. pad16(D)-1 of `rows` rows of stride `stride`
// (no loads ever write them)
template <typename T>
__device__ __forceinline__ void zero_pads(T* t, int rows, int stride, int D, int tid,
                                          int nthreads) {
  const int w = pad16(D) - D;
  for (int i = tid; i < rows * w; i += nthreads) {
    const int r = i / w;
    t[r * stride + D + (i - r * w)] = from_f<T>(0.f);
  }
}

__device__ __forceinline__ bool visible(int key, int len, int qpos, int causal, int window) {
  return key < len && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

__device__ __forceinline__ int last_key(int len, int p0, int q_end, int causal) {
  return causal ? min(len, p0 + q_end) : len;
}

// ---------------------------------------------------------------- decode

// the K/V element type: int8 mantissas (PACKED) or q's own type
template <typename T, bool PACKED>
using KVT = typename std::conditional<PACKED, int8_t, T>::type;

template <typename T, bool PACKED, int DC>
constexpr size_t split_smem(int Dp) {
  using KV = KVT<T, PACKED>;
  // K, V [2][DEC_TILE][Dp], then (PACKED) their scales [2][DEC_TILE] each
  return 4 * (size_t)Dims<DC>::DEC_TILE * Dp * sizeof(KV) +
         (PACKED ? 16 * Dims<DC>::DEC_TILE : 0);
}

// PAGED: k/v (and the scales) are pools with the block axis first, S is
// the logical length MB * bs, and table (B, MB) maps logical blocks to
// pool blocks; otherwise table is null and bs unused.  part holds, per
// query row and partial, acc (Dp floats) and then, after every row's acc,
// (m, l).  A block serves R query rows: 1 where a KV head has one (MHA
// decode), RMAX otherwise; a row's arithmetic is the same either way.
template <typename T, bool PACKED, bool PAGED, int R, int DC>
__global__ void __launch_bounds__(DEC_THREADS)
split_kernel(const T* __restrict__ q, const void* __restrict__ k_in,
             const float* __restrict__ k_scale, const void* __restrict__ v_in,
             const float* __restrict__ v_scale, const int* __restrict__ table,
             const int* __restrict__ kv_len, const int* __restrict__ q_pos0,
             float* __restrict__ part, int Hq, int Hkv, int Sq, int S, int D, int bs,
             int causal, int window, float scale, int nparts) {
  using KV = KVT<T, PACKED>;
  constexpr int TILE = Dims<DC>::DEC_TILE;
  constexpr int KPW = Dims<DC>::DEC_KPW;
  constexpr int NC = Dims<DC>::NC;
  const int Dp = pad16(D);
  const bool vec = Dp == D;
  extern __shared__ __align__(16) unsigned char smem[];
  KV* Ks = (KV*)smem;                        // [2][TILE][Dp]
  KV* Vs = Ks + 2 * TILE * Dp;               // [2][TILE][Dp]
  float* Ksc = (float*)(Vs + 2 * TILE * Dp);  // [2][TILE], PACKED
  float* Vsc = Ksc + 2 * TILE;

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
  bool dl[NC];  // this lane's 4 columns 4 lane + 128 c exist (pads included)
#pragma unroll
  for (int c = 0; c < NC; ++c) dl[c] = 4 * lane + 128 * c < Dp;

  float4 qv[R][NC];
  int qpos[R];
  long long orow[R];  // output row index (b, head, query)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rr = min(r0 + r, rep * Sq - 1);
    const int h = hk * rep + rr / Sq;
    const int qi = rr - (rr / Sq) * Sq;
    orow[r] = ((long long)b * Hq + h) * Sq + qi;
    qpos[r] = p0 + qi;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      qv[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr && dl[c]) {
        const T* qr = q + orow[r] * D;
        const int col = 4 * lane + 128 * c;
        qv[r][c] = scale4(vec ? load4(qr + col) : load4_any(qr, col, D), scale);
      }
    }
  }

  float m[R], l[R];
  float4 acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (!vec) {
    zero_pads(Ks, 2 * TILE, Dp, D, tid, DEC_THREADS);
    zero_pads(Vs, 2 * TILE, Dp, D, tid, DEC_THREADS);
  }
  const int ntile = (k_hi - k_lo + TILE - 1) / TILE;
  load_tile<KV, PACKED, PAGED>(Ks, Vs, Dp, Dp, Ksc, Vsc, k, v, k_scale, v_scale, k_lo, TILE,
                               k_hi, base, tb, Hkv, hk, bs, D, vec, tid, DEC_THREADS);
  cp_commit();
  for (int t = 0; t < ntile; ++t) {
    const int nb = (t + 1) & 1;
    if (t + 1 < ntile)
      load_tile<KV, PACKED, PAGED>(Ks + nb * TILE * Dp, Vs + nb * TILE * Dp, Dp, Dp,
                                   Ksc + nb * TILE, Vsc + nb * TILE, k, v, k_scale, v_scale,
                                   k_lo + (t + 1) * TILE, TILE, k_hi, base, tb, Hkv, hk, bs, D,
                                   vec, tid, DEC_THREADS);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int cb = t & 1;
    const KV* Kt = Ks + cb * TILE * Dp;
    const KV* Vt = Vs + cb * TILE * Dp;
    const int kbase = k_lo + t * TILE + warp * KPW;  // this warp's first key

    float p[R][KPW];
    unsigned okb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) okb[r] = 0u;
#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int j = warp * KPW + jj;
      float4 kk[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kk[c] = dl[c] ? load4(Kt + j * Dp + 4 * lane + 128 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float ks = PACKED ? Ksc[cb * TILE + j] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) continue;  // block-uniform
        float s = dot4(qv[r][0], kk[0]);
#pragma unroll
        for (int c = 1; c < NC; ++c) s = dot4_acc(qv[r][c], kk[c], s);
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
      for (int jj = 0; jj < KPW; ++jj) mt = fmaxf(mt, p[r][jj]);
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int jj = 0; jj < KPW; ++jj) {
        p[r][jj] = (okb[r] >> jj) & 1u ? expf(p[r][jj] - m_new) : 0.f;
        ls = __fadd_rn(ls, p[r][jj]);
      }
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), ls);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = scale4(acc[r][c], alpha);
    }
#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int j = warp * KPW + jj;
      float4 vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        vv[c] = dl[c] ? load4(Vt + j * Dp + 4 * lane + 128 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float vsc = PACKED ? Vsc[cb * TILE + j] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) continue;
        const float pv = PACKED ? __fmul_rn(p[r][jj], vsc) : p[r][jj];  // V scale into p
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c].x = fmaf(pv, vv[c].x, acc[r][c].x);
          acc[r][c].y = fmaf(pv, vv[c].y, acc[r][c].y);
          acc[r][c].z = fmaf(pv, vv[c].z, acc[r][c].z);
          acc[r][c].w = fmaf(pv, vv[c].w, acc[r][c].w);
        }
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
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (dl[c]) *(float4*)(part + slot * Dp + 4 * lane + 128 * c) = acc[r][c];
    if (lane == 0) {
      float* ml = part + nrows * nparts * Dp + slot * 2;
      ml[0] = m[r];
      ml[1] = l[r];
    }
  }
}

// One warp per query row: the row's partials merged in partial order.
template <typename T, int NC>
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ part, const int* __restrict__ kv_len,
             const int* __restrict__ q_pos0, T* __restrict__ o, int B, int Hq, int Sq,
             int S, int D, int causal, int nparts) {
  const int lane = threadIdx.x & 31;
  const int Dp = pad16(D);
  const long long nrows = (long long)B * Hq * Sq;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= nrows) return;
  const int b = (int)(row / ((long long)Hq * Sq));
  const int len = min(kv_len[b], S);
  const int k_end = last_key(len, q_pos0[b], Sq, causal);
  const int np = k_end > 0 ? (k_end + KPS - 1) / KPS * DEC_WARPS : 0;
  const float* ml = part + nrows * nparts * Dp + row * nparts * 2;
  const float* pa = part + row * nparts * Dp + 4 * lane;
  bool dl[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dl[c] = 4 * lane + 128 * c < Dp;

  float M = NEG_INF;
  for (int p = 0; p < np; ++p) M = fmaxf(M, ml[2 * p]);
  float L = 0.f;
  float4 A[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) A[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < np; ++p) {
    const float e = expf(ml[2 * p] - M);
    L = __fadd_rn(L, __fmul_rn(ml[2 * p + 1], e));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!dl[c]) continue;
      const float4 a = load4(pa + (size_t)p * Dp + 128 * c);
      A[c] = make_float4(__fadd_rn(A[c].x, __fmul_rn(a.x, e)), __fadd_rn(A[c].y, __fmul_rn(a.y, e)),
                         __fadd_rn(A[c].z, __fmul_rn(a.z, e)), __fadd_rn(A[c].w, __fmul_rn(a.w, e)));
    }
  }
  const float den = fmaxf(L, 1e-30f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!dl[c]) continue;
    store4(o + row * D, 4 * lane + 128 * c, D, Dp == D,
           make_float4(__fdiv_rn(A[c].x, den), __fdiv_rn(A[c].y, den), __fdiv_rn(A[c].z, den),
                       __fdiv_rn(A[c].w, den)));
  }
}

// --------------------------------------------------------------- prefill

// K/V staged in another type than f32 (int8 mantissas, bf16) and widened
// into an f32 tile before the products
template <typename T, bool PACKED>
__host__ __device__ constexpr bool widened() {
  return !std::is_same<KVT<T, PACKED>, float>::value;
}

template <typename T, bool PACKED, int DC>
constexpr size_t tile_smem(int Dp) {
  using D_ = Dims<DC>;
  // Qs [PBQ][Dp+4], Ps [PBQ][PS_STRIDE], then
  // f32 K/V:  K [2][PBK][Dp+4], V [2][PBK][Dp]
  // widened:  K, V f32 [PBK][Dp+4] / [PBK][Dp], staged K, V [2][PBK][Dp]
  //           (int8 or bf16), then (PACKED) scales [2][PBK] each
  return 4 * ((size_t)PBQ * (Dp + 4) + (size_t)PBQ * D_::PS_STRIDE) +
         (widened<T, PACKED>()
              ? 4 * ((size_t)D_::PBK * (Dp + 4) + (size_t)D_::PBK * Dp) +
                    2 * 2 * (size_t)D_::PBK * Dp * sizeof(KVT<T, PACKED>) +
                    (PACKED ? 4 * 2 * 2 * D_::PBK : 0)
              : 4 * (2 * (size_t)D_::PBK * (Dp + 4) + 2 * (size_t)D_::PBK * Dp));
}

template <typename T, bool PACKED, bool PAGED, int DC>
__global__ void __launch_bounds__(P_THREADS)
tile_kernel(const T* __restrict__ q, const void* __restrict__ k_in,
            const float* __restrict__ k_scale, const void* __restrict__ v_in,
            const float* __restrict__ v_scale, const int* __restrict__ table,
            const int* __restrict__ kv_len, const int* __restrict__ q_pos0,
            T* __restrict__ o, int Hq, int Hkv, int Sq, int S, int D, int bs, int causal,
            int window, float scale) {
  using KV = KVT<T, PACKED>;
  constexpr bool WIDEN = widened<T, PACKED>();
  constexpr int PBK = Dims<DC>::PBK;
  constexpr int KJ = Dims<DC>::KJ;
  constexpr int OC = Dims<DC>::OC;
  constexpr int PS_STRIDE = Dims<DC>::PS_STRIDE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = pad16(D);
  const bool vec = Dp == D;
  const int QS = Dp + 4;  // Q and K row strides (floats)
  float* Qs = (float*)smem;
  float* Ps = Qs + PBQ * QS;
  float* Kf = Ps + PBQ * PS_STRIDE;  // f32 K tiles (WIDEN: the widened one)
  float* Vf = Kf + (WIDEN ? 1 : 2) * PBK * QS;
  KV* Kst;  // the staging ring the loads fill
  KV* Vst;
  int kst_stride;
  float* Ksc = nullptr;
  float* Vsc = nullptr;
  if (WIDEN) {
    KV* k8 = (KV*)(Vf + PBK * Dp);
    Kst = k8;
    Vst = k8 + 2 * PBK * Dp;
    if (PACKED) {
      Ksc = (float*)(k8 + 4 * PBK * Dp);
      Vsc = Ksc + 2 * PBK;
    }
    kst_stride = Dp;
  } else {
    Kst = (KV*)Kf;
    Vst = (KV*)Vf;
    kst_stride = QS;
  }

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4ty .. 4ty+3
  const int tx = tid & 15;  // keys tx + 16j; output columns 4tx + 64c
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
  const T* qb = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  T* ob = o + ((size_t)b * Hq + h) * (size_t)Sq * D;

  if (!vec) {
    zero_pads(Kst, 2 * PBK, kst_stride, D, tid, P_THREADS);
    zero_pads(Vst, 2 * PBK, Dp, D, tid, P_THREADS);
  }
  // keys past the tile's last query position are masked for every row of
  // the tile: stop there instead of streaming them
  const int k_end = last_key(len, p0, min(q0 + PBQ, Sq), causal);
  const int ntile = k_end > 0 ? (k_end + PBK - 1) / PBK : 0;
  if (ntile > 0)
    load_tile<KV, PACKED, PAGED>(Kst, Vst, kst_stride, Dp, Ksc, Vsc, k, v, k_scale, v_scale, 0,
                                 PBK, k_end, base, tb, Hkv, hk, bs, D, vec, tid, P_THREADS);
  cp_commit();

  const int d4 = Dp / 4;
  for (int i = tid; i < PBQ * d4; i += P_THREADS) {
    const int r = i / d4;
    const int c = (i - r * d4) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      const T* qr = qb + (size_t)(q0 + r) * D;
      t = scale4(vec ? load4(qr + c) : load4_any(qr, c, D), scale);
    }
    *(float4*)(Qs + r * QS + c) = t;
  }

  float m[4], l[4], acc[4][4 * OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * OC; ++c) acc[i][c] = 0.f;
  }
  bool cok[OC];  // output columns 4tx + 64c exist (pads included)
#pragma unroll
  for (int c = 0; c < OC; ++c) cok[c] = 4 * tx + 64 * c < Dp;

  for (int t = 0; t < ntile; ++t) {
    const int nb = (t + 1) & 1;
    if (t + 1 < ntile)
      load_tile<KV, PACKED, PAGED>(
          Kst + nb * PBK * kst_stride, Vst + nb * PBK * Dp, kst_stride, Dp,
          PACKED ? Ksc + nb * PBK : nullptr, PACKED ? Vsc + nb * PBK : nullptr, k, v,
          k_scale, v_scale, (t + 1) * PBK, PBK, k_end, base, tb, Hkv, hk, bs, D, vec, tid,
          P_THREADS);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int cb = t & 1;
    const float* Kt;
    const float* Vt;
    if (WIDEN) {  // widen the int8 mantissas (or bf16 K/V) into the f32 tile
      const KV* k8 = Kst + cb * PBK * Dp;
      const KV* v8 = Vst + cb * PBK * Dp;
      for (int i = tid; i < PBK * d4; i += P_THREADS) {
        const int j = i / d4;
        const int c = (i - j * d4) * 4;
        *(float4*)(Kf + j * QS + c) = load4(k8 + j * Dp + c);
        *(float4*)(Vf + j * Dp + c) = load4(v8 + j * Dp + c);
      }
      __syncthreads();
      Kt = Kf;
      Vt = Vf;
    } else {
      Kt = Kf + cb * PBK * QS;
      Vt = Vf + cb * PBK * Dp;
    }

    // ---- logits: a 4 x KJ block, an FMA chain over d ----
    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dp; d += 4) {
      float4 a[4], kk[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(Qs + (4 * ty + i) * QS + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) kk[j] = load4(Kt + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
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
      bool ok[KJ];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
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
      for (int j = 0; j < KJ; ++j) {
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
      for (int c = 0; c < 4 * OC; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncwarp();  // P rows 4ty.. are written and read by one half-warp

    // ---- O += P V: a 4 x 4*OC block, an FMA chain over the tile's keys ----
    for (int j = 0; j < PBK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = load4(Ps + (4 * ty + i) * PS_STRIDE + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vt + (j + u) * Dp;
        float4 vv[OC];
#pragma unroll
        for (int c = 0; c < OC; ++c)
          vv[c] = cok[c] ? load4(vr + 4 * tx + 64 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pr[i].x : u == 1 ? pr[i].y : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < OC; ++c) {
            acc[i][4 * c] = fmaf(p, vv[c].x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(p, vv[c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv[c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv[c].w, acc[i][4 * c + 3]);
          }
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
    T* orow = ob + (size_t)r * D;
#pragma unroll
    for (int c = 0; c < OC; ++c)
      if (cok[c])
        store4(orow, 4 * tx + 64 * c, D, vec,
               make_float4(__fdiv_rn(acc[i][4 * c], den), __fdiv_rn(acc[i][4 * c + 1], den),
                           __fdiv_rn(acc[i][4 * c + 2], den), __fdiv_rn(acc[i][4 * c + 3], den)));
  }
}

// ------------------------------------------------------- any D (> 256)

// One warp per query row, for D > DMAX, where no head-dim class's tiles
// fit: lane t owns columns t, t + 32, ... of the row.  Keys run in groups
// of ROW_KEYS at fixed positions (a multiple of ROW_KEYS from 0, so a
// group's keys, and with them every rounding, depend on key positions
// only); per group, each key's logit is the lane's FMA chain over its
// columns then an xor butterfly, then one online-softmax update: m, l and
// alpha as the split kernel's, l += the group's probabilities in key
// order, acc = acc * alpha then one FMA per key in key order.  The scaled
// query row and acc live in shared memory, 2 * D floats a warp; where
// even one warp's do not fit, acc lives in the output row itself (device
// memory) and the query is scaled at each use (the same product), so any
// D runs.  The same order for every policy: PACKED multiplies the K scale
// onto the logit after the butterfly and the V scale onto the
// probability, both exact (powers of two), so this path too gives B5 =
// B2 over dequantize() and B6 / B7 = B2 / B5 over the gathered view bit
// for bit.  Bound: as the tiled variants'; nothing is reused across query
// rows (each warp reads its own keys), a simple kernel that is right.
constexpr int ROW_KEYS = 4;
constexpr int ROW_WARPS = 4;
constexpr size_t SMEM_MAX = 232448;  // a block's shared-memory limit on sm_90

// warps a block of the row kernel holds, and whether q and acc go to
// shared memory
__host__ inline int row_warps(int D, bool* smem) {
  const long long per_warp = 8LL * D;
  const long long fit = (long long)SMEM_MAX / per_warp;
  *smem = fit >= 1;
  return fit >= ROW_WARPS || !*smem ? ROW_WARPS : (int)fit;
}

// acc_g: the f32 accumulator rows in device memory where shared memory
// holds none (the output itself for f32; a scratch of B*Hq*Sq*D floats the
// wrapper allocates for bf16).
template <typename T, bool PACKED, bool PAGED>
__global__ void __launch_bounds__(32 * ROW_WARPS)
row_kernel(const T* __restrict__ q, const void* __restrict__ k_in,
           const float* __restrict__ k_scale, const void* __restrict__ v_in,
           const float* __restrict__ v_scale, const int* __restrict__ table,
           const int* __restrict__ kv_len, const int* __restrict__ q_pos0, T* __restrict__ o,
           float* acc_g, int B, int Hq, int Hkv, int Sq, int S, int D, int bs, int causal,
           int window, float scale, int smem) {
  using KV = KVT<T, PACKED>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= (long long)B * Hq * Sq) return;  // no block-wide barrier below
  const int qi = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % Hq);
  const int b = (int)(bh / Hq);
  const int hk = h / (Hq / Hkv);
  const int len = min(kv_len[b], S);
  const int qpos = q_pos0[b] + qi;
  const KV* k = (const KV*)k_in;
  const KV* v = (const KV*)v_in;
  const long long base = PAGED ? 0 : ((long long)b * Hkv + hk) * S;
  const int* tb = PAGED ? table + (size_t)b * (S / bs) : nullptr;
  const T* qr = q + row * D;
  T* orow = o + row * D;
  float* qs = smem ? (float*)smem_raw + (size_t)warp * 2 * D : nullptr;
  float* acc = smem ? qs + D : acc_g + row * D;  // each lane touches its own columns only
  for (int d = lane; d < D; d += 32) {
    if (smem) qs[d] = __fmul_rn(to_f(qr[d]), scale);
    acc[d] = 0.f;
  }

  const int k_end = last_key(len, qpos, 1, causal);
  const int k_beg = window > 0 ? max(qpos - window + 1, 0) / ROW_KEYS * ROW_KEYS : 0;
  float m = NEG_INF, l = 0.f;
  for (int k0 = k_beg; k0 < k_end; k0 += ROW_KEYS) {
    long long kr[ROW_KEYS];
    bool ok[ROW_KEYS];
    float s[ROW_KEYS];
#pragma unroll
    for (int j = 0; j < ROW_KEYS; ++j) {
      ok[j] = k0 + j < k_end && visible(k0 + j, len, qpos, causal, window);
      kr[j] = ok[j] ? key_row<PAGED>(k0 + j, base, tb, Hkv, hk, bs) : 0;
      s[j] = 0.f;
    }
    for (int d = lane; d < D; d += 32) {
      const float qd = smem ? qs[d] : __fmul_rn(to_f(qr[d]), scale);
#pragma unroll
      for (int j = 0; j < ROW_KEYS; ++j)
        if (ok[j]) s[j] = fmaf(qd, to_f(k[kr[j] * D + d]), s[j]);
    }
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < ROW_KEYS; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[j] = __fadd_rn(s[j], __shfl_xor_sync(FULL_MASK, s[j], off));
      if (PACKED && ok[j]) s[j] = __fmul_rn(s[j], k_scale[kr[j]]);  // K scale after the dot
      s[j] = ok[j] ? s[j] : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
    float pv[ROW_KEYS];
#pragma unroll
    for (int j = 0; j < ROW_KEYS; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      ls = __fadd_rn(ls, p);
      pv[j] = PACKED && ok[j] ? __fmul_rn(p, v_scale[kr[j]]) : p;  // V scale into p
    }
    l = __fadd_rn(__fmul_rn(l, alpha), ls);
    m = m_new;
    for (int d = lane; d < D; d += 32) {
      float a = __fmul_rn(acc[d], alpha);
#pragma unroll
      for (int j = 0; j < ROW_KEYS; ++j)
        if (ok[j]) a = fmaf(pv[j], to_f(v[kr[j] * D + d]), a);
      acc[d] = a;
    }
  }
  const float den = fmaxf(l, 1e-30f);
  for (int d = lane; d < D; d += 32) orow[d] = from_f<T>(__fdiv_rn(acc[d], den));
}

template <typename T, bool PACKED, bool PAGED>
int launch_rows(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                const void* table, const void* kv_len, const void* q_pos0, void* o, void* part,
                long long part_floats, int B, int Hq, int Hkv, int Sq, int S, int D, int bs,
                int causal, int window, float scale, cudaStream_t st) {
  bool smem = false;
  const int warps = row_warps(D, &smem);
  const size_t bytes = smem ? (size_t)warps * 8 * D : 0;
  static const cudaError_t attr =
      cudaFuncSetAttribute(row_kernel<T, PACKED, PAGED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const long long nrows = (long long)B * Hq * Sq;
  float* acc_g = nullptr;  // f32 accumulators in device memory (no shared memory)
  if (!smem) {
    if (std::is_same<T, float>::value) {
      acc_g = (float*)o;
    } else {
      if (part == nullptr || part_floats < nrows * D) return (int)cudaErrorInvalidValue;
      acc_g = (float*)part;
    }
  }
  row_kernel<T, PACKED, PAGED><<<(unsigned)((nrows + warps - 1) / warps), 32 * warps, bytes,
                                 st>>>(
      (const T*)q, k, (const float*)ks, v, (const float*)vs, (const int*)table,
      (const int*)kv_len, (const int*)q_pos0, (T*)o, acc_g, B, Hq, Hkv, Sq, S, D, bs, causal,
      window, scale, smem ? 1 : 0);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- launch

// above 48 KB of shared memory only after opting in: once per kernel, for
// the class's largest D
template <typename T, bool PACKED, bool PAGED, int DC>
cudaError_t opt_in() {
  static const cudaError_t err = [] {
    const int split = (int)split_smem<T, PACKED, DC>(DC);
    cudaError_t e = cudaFuncSetAttribute(split_kernel<T, PACKED, PAGED, 1, DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, split);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(split_kernel<T, PACKED, PAGED, RMAX, DC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, split);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tile_kernel<T, PACKED, PAGED, DC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tile_smem<T, PACKED, DC>(DC));
    return e;
  }();
  return err;
}

template <typename T, bool PACKED, bool PAGED, int DC>
int launch_dc(const void* q, const void* k, const void* ks, const void* v, const void* vs,
              const void* table, const void* kv_len, const void* q_pos0, void* o, void* part,
              long long part_floats, int B, int Hq, int Hkv, int Sq, int S, int D, int bs,
              int causal, int window, float scale, cudaStream_t st) {
  const cudaError_t attr = opt_in<T, PACKED, PAGED, DC>();
  if (attr != cudaSuccess) return (int)attr;
  const int Dp = pad16(D);
  if (Sq <= DEC_MAX_SQ) {
    const int nsplit = (S + KPS - 1) / KPS;
    const int nparts = nsplit * DEC_WARPS;
    const long long need = (long long)B * Hq * Sq * nparts * (Dp + 2);
    if (part == nullptr || part_floats < need) return (int)cudaErrorInvalidValue;
    const int rows = Hq / Hkv * Sq;  // query rows per KV head
    const int r = rows == 1 ? 1 : RMAX;
    const dim3 grid(nsplit, Hkv * ((rows + r - 1) / r), B);
    (r == 1 ? split_kernel<T, PACKED, PAGED, 1, DC> : split_kernel<T, PACKED, PAGED, RMAX, DC>)
        <<<grid, DEC_THREADS, split_smem<T, PACKED, DC>(Dp), st>>>(
            (const T*)q, k, (const float*)ks, v, (const float*)vs, (const int*)table,
            (const int*)kv_len, (const int*)q_pos0, (float*)part, Hq, Hkv, Sq, S, D, bs,
            causal, window, scale, nparts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long nrows = (long long)B * Hq * Sq;
    merge_kernel<T, Dims<DC>::NC><<<(unsigned)((nrows + 3) / 4), 128, 0, st>>>(
        (const float*)part, (const int*)kv_len, (const int*)q_pos0, (T*)o, B, Hq, Sq, S,
        D, causal, nparts);
  } else {
    tile_kernel<T, PACKED, PAGED, DC>
        <<<dim3((Sq + PBQ - 1) / PBQ, Hq, B), P_THREADS, tile_smem<T, PACKED, DC>(Dp), st>>>(
            (const T*)q, k, (const float*)ks, v, (const float*)vs, (const int*)table,
            (const int*)kv_len, (const int*)q_pos0, (T*)o, Hq, Hkv, Sq, S, D, bs, causal,
            window, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool PACKED, bool PAGED>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* table, const void* kv_len, const void* q_pos0, void* o, void* part,
           long long part_floats, int B, int Hq, int Hkv, int Sq, int S, int D, int bs,
           int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || S <= 0 || D <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (PAGED && bs <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D > DMAX)
    return launch_rows<T, PACKED, PAGED>(q, k, ks, v, vs, table, kv_len, q_pos0, o, part,
                                         part_floats, B, Hq, Hkv, Sq, S, D, bs, causal,
                                         window, scale, st);
  return D <= 128 ? launch_dc<T, PACKED, PAGED, 128>(q, k, ks, v, vs, table, kv_len, q_pos0, o,
                                                  part, part_floats, B, Hq, Hkv, Sq, S, D, bs,
                                                  causal, window, scale, st)
                  : launch_dc<T, PACKED, PAGED, 256>(q, k, ks, v, vs, table, kv_len, q_pos0, o,
                                                  part, part_floats, B, Hq, Hkv, Sq, S, D, bs,
                                                  causal, window, scale, st);
}

// The element type of q, o and float K/V this library is built for:
// float, or bf16 where the build defines FA_BF16 (build.py compiles this
// source twice, into two libraries, in parallel; the bf16 one exports the
// same entry points with "_bf16" before "_launch").
#ifdef FA_BF16
using Elem = bf16;
#define FA_ENTRY(name) name##_bf16_launch
#else
using Elem = float;
#define FA_ENTRY(name) name##_launch
#endif

}  // namespace

// part: f32 scratch for the decode variant's partials (Sq <= 8), at least
// B*Hq*Sq * 4*ceil(S/128) * (pad16(D)+2) floats; for the row kernel of a
// bf16 q with D > 29056 (no row in shared memory), B*Hq*Sq*D floats;
// unused (may be null) otherwise.
extern "C" int FA_ENTRY(flash_attention)(const void* q, const void* k, const void* v,
                                         const void* kv_len, const void* q_pos0, void* o,
                                         void* part, long long part_floats, int B, int Hq,
                                         int Hkv, int Sq, int S, int D, int causal, int window,
                                         float scale, void* stream) {
  return launch<Elem, false, false>(q, k, nullptr, v, nullptr, nullptr, kv_len, q_pos0, o, part,
                                    part_floats, B, Hq, Hkv, Sq, S, D, 1, causal, window, scale,
                                    stream);
}

extern "C" int FA_ENTRY(packed_flash_attention)(
    const void* q, const void* k_qm, const void* k_scale, const void* v_qm,
    const void* v_scale, const void* kv_len, const void* q_pos0, void* o, void* part,
    long long part_floats, int B, int Hq, int Hkv, int Sq, int S, int D, int causal,
    int window, float scale, void* stream) {
  return launch<Elem, true, false>(q, k_qm, k_scale, v_qm, v_scale, nullptr, kv_len, q_pos0, o,
                                   part, part_floats, B, Hq, Hkv, Sq, S, D, 1, causal, window,
                                   scale, stream);
}

// B6: pools (NB,Hkv,bs,D) of q's type, table (B,MB) int32
extern "C" int FA_ENTRY(paged_flash_attention)(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* kv_len, const void* q_pos0, void* o, void* part, long long part_floats,
    int B, int Hq, int Hkv, int Sq, int MB, int bs, int D, int causal, int window,
    float scale, void* stream) {
  return launch<Elem, false, true>(q, k_pool, nullptr, v_pool, nullptr, table, kv_len, q_pos0, o,
                                   part, part_floats, B, Hq, Hkv, Sq, MB * bs, D, bs, causal,
                                   window, scale, stream);
}

// B7: pools qm (NB,Hkv,bs,D) int8 and scale (NB,Hkv,bs,1) f32
extern "C" int FA_ENTRY(paged_packed_flash_attention)(
    const void* q, const void* k_qm, const void* k_scale, const void* v_qm,
    const void* v_scale, const void* table, const void* kv_len, const void* q_pos0, void* o,
    void* part, long long part_floats, int B, int Hq, int Hkv, int Sq, int MB, int bs, int D,
    int causal, int window, float scale, void* stream) {
  return launch<Elem, true, true>(q, k_qm, k_scale, v_qm, v_scale, table, kv_len, q_pos0, o,
                                  part, part_floats, B, Hq, Hkv, Sq, MB * bs, D, bs, causal,
                                  window, scale, stream);
}
