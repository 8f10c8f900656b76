// One-pass DSBP GEMM for Hopper: y (M,N) = x (M,K') @ packed weight (K',N).
//
// Replaces (B1) src/repro/kernels/dsbp_fused.py::dsbp_fused_kernel_call
// (:73, body _kernel :46, pallas_call :118) with the input-path tile math
// of src/repro/kernels/fp8_quant_align.py::quant_align_tile (:53-112),
// here in quant_align.cuh.
//
// Per 64-group of each activation row: multiply by the pow2 tensor scale
// ts, FP8 quantize, predict the MPU width, align to (b+1)-bit ints; fold
// ts into the pow2 group scale (s/ts) and the weight's per-channel scale
// into its group scale (kscale/tw); then an exact 64-deep integer dot per
// (row, column) against the int8 weight mantissas, accumulated in f32 as
// acc += (float(dot) * sx) * sw in group order g = 0, 1, ....  Every dot
// is an integer below 2^24 and every scale a power of two, so only the
// f32 accumulation rounds, in the same order as the plain version, which
// therefore agrees bit for bit, whatever M, N or the tiling.
//
// Bound on this card: at decode M the weight bytes (int8 ka + f32 kscale,
// 7.4 GB per llama-7b step); at prefill M the integer operations.  The
// first design (one 16 x 32 output tile per block, the input path
// recomputed per tile and group, the weight tile loaded byte by byte
// behind barriers, the MAC on CUDA cores) ran 17-150x over that bound.
// This design:
//
// 1. The input path runs once per (row, group), one warp each, in a first
//    kernel (quant_align.cuh, unchanged, so B3 stays bit-equal to it).  On
//    the TPU its grid visits each x tile once; here the N/BN column blocks
//    would each redo it (128-344x at llama-7b's decode shapes), which costs
//    more instruction slots than streaming the weights.  Each aligned mantissa
//    a (|a| <= 2048, 12 signed bits) is stored as two int8 halves,
//    hi = a >> 6 in [-32, 31] and lo = a & 63, with sx = s/ts: 132 bytes
//    per (row, group) in a scratch the wrapper allocates.
// 2. The GEMM kernel streams the weight: one block owns BN columns over
//    the whole K' (K is never split: each output's f32 sum is taken in
//    group order by one thread), through a ring of NSTAGE stages of GPS
//    groups each, filled by 16-byte cp.async (ka rows, kscale rows, the
//    groups' a halves and sx), so 32 KB or more of weight bytes are in
//    flight per SM at decode.  The 64-deep dot runs on the tensor cores as
//    mma.sync m16n8k32 s8 x s8 -> s32: dot = 64 * (hi . w) + (lo . w),
//    exact by construction (the lo product takes the hi sum times 64 as
//    its accumulator).  A fragments of rows >= M are zero.  After each
//    group the s32 dot folds in registers:
//    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(dot, sx), sw)),
//    sw = __fdiv_rn(kscale, tw) computed once per stage in shared memory.
//    The weight's B fragments need 4 consecutive k of one column; ka is
//    row-major (K', N), so they are gathered byte by byte from the staged
//    tile (rows padded by 16 bytes: 2-way bank conflicts at most).
// The tile is chosen by M alone: M <= 16 (decode: dense and mesh slots,
// the 8 paged lanes) one m16 tile and BN = 32 columns on 4 warps; larger M
// (prefill) 64 x 128 tiles on 8 warps.  N must be a multiple of 16 (the
// wrapper pads it), K' of 64.
#include <cuda_runtime.h>

#include <cstdint>

#include "quant_align.cuh"

namespace {

using dsbp::GROUP;
constexpr int AST = 2 * GROUP + 16;  // staged a row: hi 64 | lo 64 | pad (bytes)
constexpr int A_BYTES = 2 * GROUP;   // scratch a row per (row, group)

template <int BM_, int WM_, int WN_, int NT_, int GPS_, int NSTAGE_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_;          // rows per block (m16 tiles x 16)
  static constexpr int WM = WM_;          // warps along M
  static constexpr int WN = WN_;          // warps along N
  static constexpr int NT = NT_;          // n8 tiles per warp
  static constexpr int GPS = GPS_;        // groups per stage
  static constexpr int NSTAGE = NSTAGE_;  // ring depth
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // resident per SM (registers)
  static constexpr int BN = WN * NT * 8;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WST = BN + 16;  // staged weight row (bytes)
  // one group in a stage: weight tile, a halves, sx, kscale -> sw
  static constexpr int W_OFF = 0;
  static constexpr int A_OFF = W_OFF + GROUP * WST;
  static constexpr int SX_OFF = A_OFF + BM * AST;
  static constexpr int SW_OFF = SX_OFF + 4 * BM;
  static constexpr int GROUP_BYTES = SW_OFF + 4 * BN;
  static constexpr int SMEM = 4 * BN + NSTAGE * GPS * GROUP_BYTES;  // tw, then the ring
};
using DecodeTile = Tile<16, 1, 4, 1, 4, 3, 3>;   // BN 32, 128 threads, 65 KB
using PrefillTile = Tile<64, 4, 2, 8, 1, 4, 2>;  // BN 128, 256 threads, 76 KB
constexpr int DECODE_MAX_M = DecodeTile::BM;

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

// d += a (16x32 s8, row) * b (32x8 s8, col), s32
__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 consecutive k of one column of the staged weight tile, packed
__device__ __forceinline__ unsigned gather4(const uint8_t* w, int stride) {
  return (unsigned)w[0] | ((unsigned)w[stride] << 8) | ((unsigned)w[2 * stride] << 16) |
         ((unsigned)w[3 * stride] << 24);
}

// The input path, once per (row, group): one warp each.
__global__ void __launch_bounds__(256)
prep_kernel(const float* __restrict__ x, const float* __restrict__ ts_ptr,
            int8_t* __restrict__ a, float* __restrict__ sx, int M, int G, dsbp::QACfg c) {
  const int lane = threadIdx.x & 31;
  const long long wg = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (wg >= (long long)M * G) return;
  const float ts = *ts_ptr;
  const float* xr = x + wg * GROUP;  // row wg / G, group wg % G
  int a0, a1, bits;
  float s;
  dsbp::quant_align_group(__fmul_rn(xr[lane], ts), __fmul_rn(xr[lane + 32], ts), c, a0, a1,
                          s, bits);
  int8_t* ar = a + wg * A_BYTES;
  ar[lane] = (int8_t)(a0 >> 6);  // hi: floor(a / 64)
  ar[lane + 32] = (int8_t)(a1 >> 6);
  ar[GROUP + lane] = (int8_t)(a0 & 63);  // lo: a - 64 hi
  ar[GROUP + lane + 32] = (int8_t)(a1 & 63);
  if (lane == 0) sx[wg] = __fdiv_rn(s, ts);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
gemm_kernel(const int8_t* __restrict__ a, const float* __restrict__ sx,
            const int8_t* __restrict__ ka, const float* __restrict__ kscale,
            const float* __restrict__ tw, float* __restrict__ y, int M, int N, int G) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* TW = (float*)smem;
  uint8_t* ring = smem + 4 * T::BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / T::WN;
  const int wn = warp - wm * T::WN;
  const int g8 = lane >> 2;  // mma groupID
  const int t4 = lane & 3;   // mma threadID_in_group
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * T::BN;

  for (int c = tid; c < T::BN; c += T::THREADS) TW[c] = n0 + c < N ? tw[n0 + c] : 1.f;

  // start the loads of stage st (groups st*GPS ..) into its ring slot
  const int nst = (G + T::GPS - 1) / T::GPS;
  auto fill = [&](int st) {
    uint8_t* slot = ring + (st % T::NSTAGE) * T::GPS * T::GROUP_BYTES;
    const int ng = min(T::GPS, G - st * T::GPS);
    for (int gi = 0; gi < ng; ++gi) {
      const int g = st * T::GPS + gi;
      uint8_t* base = slot + gi * T::GROUP_BYTES;
      constexpr int WCH = T::BN / 16;  // 16-byte chunks per weight row
      for (int i = tid; i < GROUP * WCH; i += T::THREADS) {
        const int r = i / WCH;
        const int n = n0 + (i - r * WCH) * 16;
        cp_async16(base + T::W_OFF + r * T::WST + (n - n0),
                   ka + ((long long)g * GROUP + r) * N + (n < N ? n : 0), n < N);
      }
      for (int i = tid; i < T::BM * 8; i += T::THREADS) {
        const int r = i >> 3;
        const int m = m0 + r;
        cp_async16(base + T::A_OFF + r * AST + (i & 7) * 16,
                   a + ((long long)(m < M ? m : 0) * G + g) * A_BYTES + (i & 7) * 16, m < M);
      }
      for (int i = tid; i < T::BM; i += T::THREADS) {
        const int m = m0 + i;
        cp_async4(base + T::SX_OFF + 4 * i, sx + (long long)(m < M ? m : 0) * G + g, m < M);
      }
      for (int i = tid; i < T::BN / 4; i += T::THREADS) {
        const int n = n0 + 4 * i;
        cp_async16(base + T::SW_OFF + 16 * i, kscale + (long long)g * N + (n < N ? n : 0),
                   n < N);
      }
    }
  };

  float acc[T::NT][4];
#pragma unroll
  for (int j = 0; j < T::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < T::NSTAGE - 1; ++st) {
    if (st < nst) fill(st);
    cp_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_wait<T::NSTAGE - 2>();
    __syncthreads();  // stage st landed; stage st-1's readers are done
    if (st + T::NSTAGE - 1 < nst) fill(st + T::NSTAGE - 1);
    cp_commit();

    uint8_t* slot = ring + (st % T::NSTAGE) * T::GPS * T::GROUP_BYTES;
    const int ng = min(T::GPS, G - st * T::GPS);
    for (int i = tid; i < ng * T::BN; i += T::THREADS) {  // sw = kscale / tw
      const int gi = i / T::BN;
      const int c = i - gi * T::BN;
      float* sw = (float*)(slot + gi * T::GROUP_BYTES + T::SW_OFF);
      sw[c] = __fdiv_rn(sw[c], TW[c]);
    }
    __syncthreads();

    // the stage's integer dots first (independent chains: the tensor
    // cores overlap them), then the folds in group order
    int c[T::GPS][T::NT][4];
#pragma unroll
    for (int gi = 0; gi < T::GPS; ++gi) {
      if (gi >= ng) continue;
      const uint8_t* base = slot + gi * T::GROUP_BYTES;
      const uint8_t* A = base + T::A_OFF + (wm * 16 + g8) * AST + 4 * t4;
      const uint8_t* W = base + T::W_OFF + 4 * t4 * T::WST + wn * T::NT * 8 + g8;
      unsigned bf[T::NT][2][2];  // [tile][k-step][reg]
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            bf[j][ks][hh] = gather4(W + (32 * ks + 16 * hh) * T::WST + 8 * j, T::WST);
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[gi][j][e] = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // hi, then lo
        if (half == 1) {
#pragma unroll
          for (int j = 0; j < T::NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[gi][j][e] *= 64;
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint8_t* Ak = A + half * GROUP + 32 * ks;
          const unsigned af[4] = {*(const unsigned*)Ak, *(const unsigned*)(Ak + 8 * AST),
                                  *(const unsigned*)(Ak + 16),
                                  *(const unsigned*)(Ak + 8 * AST + 16)};
#pragma unroll
          for (int j = 0; j < T::NT; ++j) mma_s8(c[gi][j], af, bf[j][ks]);
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < T::GPS; ++gi) {
      if (gi >= ng) continue;
      const uint8_t* base = slot + gi * T::GROUP_BYTES;
      const float* SX = (const float*)(base + T::SX_OFF) + wm * 16 + g8;
      const float* SW = (const float*)(base + T::SW_OFF) + wn * T::NT * 8 + 2 * t4;
      const float sx0 = SX[0];
      const float sx1 = SX[8];
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const float sw0 = SW[8 * j];
        const float sw1 = SW[8 * j + 1];
        acc[j][0] = __fadd_rn(acc[j][0], __fmul_rn(__fmul_rn((float)c[gi][j][0], sx0), sw0));
        acc[j][1] = __fadd_rn(acc[j][1], __fmul_rn(__fmul_rn((float)c[gi][j][1], sx0), sw1));
        acc[j][2] = __fadd_rn(acc[j][2], __fmul_rn(__fmul_rn((float)c[gi][j][2], sx1), sw0));
        acc[j][3] = __fadd_rn(acc[j][3], __fmul_rn(__fmul_rn((float)c[gi][j][3], sx1), sw1));
      }
    }
  }

  const int r0 = m0 + wm * 16 + g8;
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    const int n = n0 + wn * T::NT * 8 + 8 * j + 2 * t4;
    if (n >= N) continue;
    if (r0 < M) *(float2*)(y + (long long)r0 * N + n) = make_float2(acc[j][0], acc[j][1]);
    if (r0 + 8 < M)
      *(float2*)(y + (long long)(r0 + 8) * N + n) = make_float2(acc[j][2], acc[j][3]);
  }
}

template <class T>
cudaError_t run_gemm(const int8_t* a, const float* sx, const void* ka, const void* kscale,
                     const void* tw, void* y, int M, int N, int G, cudaStream_t st) {
  // above 48 KB only after opting in: once per tile shape
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  gemm_kernel<T><<<grid, T::THREADS, T::SMEM, st>>>(a, sx, (const int8_t*)ka,
                                                    (const float*)kscale, (const float*)tw,
                                                    (float*)y, M, N, G);
  return cudaGetLastError();
}

}  // namespace

// scratch: at least M * (K'/64) * 132 bytes, 16-byte aligned
extern "C" int dsbp_fused_launch(const void* x, const void* ts, const void* ka,
                                 const void* kscale, const void* tw, void* y, void* scratch,
                                 long long scratch_bytes, int M, int N, int Kp, int mbits,
                                 int emin, int emax, float max_value, int fixed, float k,
                                 int b_fix, int trunc, void* stream) {
  if (M <= 0 || N <= 0 || N % 16 || Kp <= 0 || Kp % GROUP != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Kp / GROUP;
  const long long rows = (long long)M * G;
  if (scratch == nullptr || scratch_bytes < rows * (A_BYTES + 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* a = (int8_t*)scratch;
  float* sx = (float*)(a + rows * A_BYTES);
  dsbp::QACfg c{mbits, emin, emax, max_value, fixed, k, b_fix, trunc};
  prep_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>((const float*)x, (const float*)ts,
                                                          a, sx, M, G, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = M <= DECODE_MAX_M ? run_gemm<DecodeTile>(a, sx, ka, kscale, tw, y, M, N, G, st)
                          : run_gemm<PrefillTile>(a, sx, ka, kscale, tw, y, M, N, G, st);
  return (int)err;
}
