// The exact grouped integer DSBP GEMM stage on Hopper's tensor cores,
// shared by B1 (dsbp_fused.cu, after its input-path kernel) and B4
// (dsbp_matmul.cu, over B3's outputs):
//
//   y[m,n] = sum_g fold(dot64_g(a, w)[m,n], sx[m,g], sw[g,n])   (g = 0, 1, ...)
//
// with a the aligned input mantissas (|a| <= 2048, 12 signed bits), w the
// packed int8 weight mantissas ka (K', N) row-major, sx (M, G) and sw
// (G, N) power-of-two group scales.  Every 64-deep dot is an exact integer
// (below 2^24) and every scale a power of two, so only the f32 adds round,
// one per group in group order in one thread: the bits depend on neither
// M, N nor the tiling.
//
// Design (B1's GEMM): one block owns BN columns over the whole K'
// (no split-K), through a ring of NSTAGE stages of GPS groups each, filled
// by 16-byte cp.async (weight rows, kscale rows, the groups' A rows and
// sx).  A arrives as hi | lo int8 halves, 128 bytes per (row, group): B1's
// scratch, written by its input-path kernel, or B4's, by its layout pass.
// The dot runs as mma.sync m16n8k32 s8 x s8 -> s32 on the 12-bit input
// split into two int8 halves, hi = a >> 6 in [-32, 31] and lo = a & 63:
// dot = 64 * (hi . w) + (lo . w), exact by construction (the lo product
// takes 64 times the hi sum as its accumulator).  A fragments of rows >= M
// are zero.  The weight's B fragments need 4 consecutive k of one column;
// ka is row-major (K', N), so they are gathered byte by byte from the
// staged tile (rows padded by 16 bytes: 2-way bank conflicts at most).
//
// Template policies:
//   TW   true (B1): sw = kscale / tw, the per-channel weight scale folded
//        in per stage, and acc += (dot * sx) * sw;
//        false (B4): sw = kscale as it is, and acc += dot * (sx * sw), the
//        JAX kernel's order (src/repro/kernels/dsbp_matmul.py:46).
//   VECN true: N % 16 == 0, 16-byte weight and kscale loads and 8-byte
//        output stores; false: any N, byte and 4-byte copies and single
//        stores (a slower instantiation, never a padded copy of the weight).
// The tile is chosen by M alone (run_gemm_any_n): M <= Decode::BM (decode:
// dense and mesh slots, the 8 paged lanes) one m16 tile; larger M
// (prefill) 64-row tiles.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "quant_align.cuh"

namespace dsbp {

constexpr int AST = 2 * GROUP + 16;  // a staged hi | lo row: hi 64 | lo 64 | pad (bytes)
constexpr int A_BYTES = 2 * GROUP;   // a hi | lo row per (row, group) in device memory

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
};

// Shared memory of one (tile, policy): [tw][ring of NSTAGE * GPS groups:
// weight tile, A rows, sx, kscale -> sw]
template <class T, bool TW>
struct Layout {
  static constexpr int W_OFF = 0;
  static constexpr int A_OFF = W_OFF + GROUP * T::WST;
  static constexpr int SX_OFF = A_OFF + T::BM * AST;
  static constexpr int SW_OFF = SX_OFF + 4 * T::BM;
  static constexpr int GROUP_BYTES = SW_OFF + 4 * T::BN;
  static constexpr int RING_OFF = TW ? 4 * T::BN : 0;
  static constexpr int SMEM = RING_OFF + T::NSTAGE * T::GPS * GROUP_BYTES;
};

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

// the int8 halves of four aligned mantissas, packed four to a word in
// element order: hi = a >> 6, lo = a & 63
__device__ __forceinline__ void split4(int a0, int a1, int a2, int a3, unsigned& hi,
                                       unsigned& lo) {
  hi = __byte_perm(__byte_perm(a0 >> 6, a1 >> 6, 0x0040), __byte_perm(a2 >> 6, a3 >> 6, 0x0040),
                   0x5410);
  lo = __byte_perm(__byte_perm(a0, a1, 0x0040), __byte_perm(a2, a3, 0x0040), 0x5410) &
       0x3f3f3f3fu;
}

// a: hi | lo int8 rows, (M, G, 128); sx (M, G); ka (G*64, N); kscale
// (G, N); tw (N) read only if TW.
template <class T, bool TW, bool VECN>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
gemm_kernel(const int8_t* __restrict__ a_in, const float* __restrict__ sx,
            const int8_t* __restrict__ ka, const float* __restrict__ kscale,
            const float* __restrict__ tw, float* __restrict__ y, int M, int N, int G) {
  using Lay = Layout<T, TW>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* TWs = (float*)smem;
  uint8_t* ring = smem + Lay::RING_OFF;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / T::WN;
  const int wn = warp - wm * T::WN;
  const int g8 = lane >> 2;  // mma groupID
  const int t4 = lane & 3;   // mma threadID_in_group
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * T::BN;

  if (TW)
    for (int c = tid; c < T::BN; c += T::THREADS) TWs[c] = n0 + c < N ? tw[n0 + c] : 1.f;

  // start the loads of stage st (groups st*GPS ..) into its ring slot
  const int nst = (G + T::GPS - 1) / T::GPS;
  auto fill = [&](int st) {
    uint8_t* slot = ring + (st % T::NSTAGE) * T::GPS * Lay::GROUP_BYTES;
    const int ng = min(T::GPS, G - st * T::GPS);
    for (int gi = 0; gi < ng; ++gi) {
      const int g = st * T::GPS + gi;
      uint8_t* base = slot + gi * Lay::GROUP_BYTES;
      if (VECN) {
        constexpr int WCH = T::BN / 16;  // 16-byte chunks per weight row
        for (int i = tid; i < GROUP * WCH; i += T::THREADS) {
          const int r = i / WCH;
          const int n = n0 + (i - r * WCH) * 16;
          cp_async16(base + Lay::W_OFF + r * T::WST + (n - n0),
                     ka + ((long long)g * GROUP + r) * N + (n < N ? n : 0), n < N);
        }
        for (int i = tid; i < T::BN / 4; i += T::THREADS) {
          const int n = n0 + 4 * i;
          cp_async16(base + Lay::SW_OFF + 16 * i, kscale + (long long)g * N + (n < N ? n : 0),
                     n < N);
        }
      } else {  // rows not 16-byte aligned: bytes and single floats
        for (int i = tid; i < GROUP * T::BN; i += T::THREADS) {
          const int r = i / T::BN;
          const int n = n0 + i - r * T::BN;
          base[Lay::W_OFF + r * T::WST + (n - n0)] =
              n < N ? (uint8_t)ka[((long long)g * GROUP + r) * N + n] : (uint8_t)0;
        }
        for (int i = tid; i < T::BN; i += T::THREADS) {
          const int n = n0 + i;
          cp_async4(base + Lay::SW_OFF + 4 * i, kscale + (long long)g * N + (n < N ? n : 0),
                    n < N);
        }
      }
      constexpr int ACH = A_BYTES / 16;  // 16-byte chunks per A row
      for (int i = tid; i < T::BM * ACH; i += T::THREADS) {
        const int r = i / ACH;
        const int c = i - r * ACH;
        const int m = m0 + r;
        const long long row = (long long)(m < M ? m : 0) * G + g;  // (row, group)
        cp_async16(base + Lay::A_OFF + r * AST + 16 * c, a_in + row * A_BYTES + 16 * c, m < M);
      }
      for (int i = tid; i < T::BM; i += T::THREADS) {
        const int m = m0 + i;
        cp_async4(base + Lay::SX_OFF + 4 * i, sx + (long long)(m < M ? m : 0) * G + g, m < M);
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

    uint8_t* slot = ring + (st % T::NSTAGE) * T::GPS * Lay::GROUP_BYTES;
    const int ng = min(T::GPS, G - st * T::GPS);
    if (TW) {
      for (int i = tid; i < ng * T::BN; i += T::THREADS) {  // sw = kscale / tw
        const int gi = i / T::BN;
        const int c = i - gi * T::BN;
        float* sw = (float*)(slot + gi * Lay::GROUP_BYTES + Lay::SW_OFF);
        sw[c] = __fdiv_rn(sw[c], TWs[c]);
      }
      __syncthreads();
    }

    // the stage's integer dots first (independent chains: the tensor
    // cores overlap them), then the folds in group order
    int c[T::GPS][T::NT][4];
#pragma unroll
    for (int gi = 0; gi < T::GPS; ++gi) {
      if (gi >= ng) continue;
      const uint8_t* base = slot + gi * Lay::GROUP_BYTES;
      const uint8_t* A = base + Lay::A_OFF + (wm * 16 + g8) * AST + 4 * t4;
      const uint8_t* W = base + Lay::W_OFF + 4 * t4 * T::WST + wn * T::NT * 8 + g8;
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
      const uint8_t* base = slot + gi * Lay::GROUP_BYTES;
      const float* SX = (const float*)(base + Lay::SX_OFF) + wm * 16 + g8;
      const float* SW = (const float*)(base + Lay::SW_OFF) + wn * T::NT * 8 + 2 * t4;
      const float sx0 = SX[0];
      const float sx1 = SX[8];
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const float sw0 = SW[8 * j];
        const float sw1 = SW[8 * j + 1];
        if (TW) {  // (dot * sx) * sw
          acc[j][0] = __fadd_rn(acc[j][0], __fmul_rn(__fmul_rn((float)c[gi][j][0], sx0), sw0));
          acc[j][1] = __fadd_rn(acc[j][1], __fmul_rn(__fmul_rn((float)c[gi][j][1], sx0), sw1));
          acc[j][2] = __fadd_rn(acc[j][2], __fmul_rn(__fmul_rn((float)c[gi][j][2], sx1), sw0));
          acc[j][3] = __fadd_rn(acc[j][3], __fmul_rn(__fmul_rn((float)c[gi][j][3], sx1), sw1));
        } else {  // dot * (sx * sw)
          acc[j][0] = __fadd_rn(acc[j][0], __fmul_rn((float)c[gi][j][0], __fmul_rn(sx0, sw0)));
          acc[j][1] = __fadd_rn(acc[j][1], __fmul_rn((float)c[gi][j][1], __fmul_rn(sx0, sw1)));
          acc[j][2] = __fadd_rn(acc[j][2], __fmul_rn((float)c[gi][j][2], __fmul_rn(sx1, sw0)));
          acc[j][3] = __fadd_rn(acc[j][3], __fmul_rn((float)c[gi][j][3], __fmul_rn(sx1, sw1)));
        }
      }
    }
  }

  const int r0 = m0 + wm * 16 + g8;
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    const int n = n0 + wn * T::NT * 8 + 8 * j + 2 * t4;
    if (n >= N) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 8 * hr;
      if (r >= M) continue;
      float* yr = y + (long long)r * N + n;
      if (VECN) {
        *(float2*)yr = make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
      } else {
        yr[0] = acc[j][2 * hr];
        if (n + 1 < N) yr[1] = acc[j][2 * hr + 1];
      }
    }
  }
}

template <class T, bool TW, bool VECN>
cudaError_t run_gemm(const int8_t* a, const float* sx, const void* ka, const void* kscale,
                     const void* tw, void* y, int M, int N, int G, cudaStream_t st) {
  // above 48 KB only after opting in: once per instantiation
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemm_kernel<T, TW, VECN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T, TW>::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  gemm_kernel<T, TW, VECN><<<grid, T::THREADS, Layout<T, TW>::SMEM, st>>>(
      a, sx, (const int8_t*)ka, (const float*)kscale, (const float*)tw, (float*)y, M, N, G);
  return cudaGetLastError();
}

// the decode tile for M <= Decode::BM, else the prefill tile; VECN by N
template <class Decode, class Prefill, bool TW>
cudaError_t run_gemm_any_n(const int8_t* a, const float* sx, const void* ka, const void* kscale,
                           const void* tw, void* y, int M, int N, int G, cudaStream_t st) {
  if (N % 16 == 0)
    return M <= Decode::BM ? run_gemm<Decode, TW, true>(a, sx, ka, kscale, tw, y, M, N, G, st)
                           : run_gemm<Prefill, TW, true>(a, sx, ka, kscale, tw, y, M, N, G, st);
  return M <= Decode::BM ? run_gemm<Decode, TW, false>(a, sx, ka, kscale, tw, y, M, N, G, st)
                         : run_gemm<Prefill, TW, false>(a, sx, ka, kscale, tw, y, M, N, G, st);
}

}  // namespace dsbp
