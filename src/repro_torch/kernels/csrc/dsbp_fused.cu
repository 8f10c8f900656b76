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
// into its group scale (kscale/tw); then an exact int32 64-deep dot per
// (row, column) against the int8 weight mantissas, accumulated in f32 as
// acc += (float(dot) * sx) * sw in group order g = 0, 1, ....  Products
// are < 2^18 and 64-deep sums < 2^24, so every dot and every scaled
// partial is exact; only the f32 accumulation rounds, in the same order as
// the plain version, which therefore agrees bit for bit.
//
// Bound on this card: at decode M the weight bytes (int8 ka + f32 kscale)
// bound it; at prefill M (hundreds of rows) the integer operations do.
// Design of this first version: a (16 x 32) output tile per 128-thread
// block, a loop over the K' groups inside the block (the TPU's sequential
// kk grid axis), the aligned input ints (int16) and weight tile (int8)
// staged in shared memory, and the MAC on CUDA cores.  Input mantissas
// need up to 12 signed bits, so int8 MMA does not fit.  The fast design
// left for later: exact-integer fp16 wgmma per 64-group (|a_x| <= 2047 and
// |a_w| <= 127 are exact in fp16, the 64-deep dot is exact in f32) with f32
// accumulation and the pow2 scales applied per group.
#include <cuda_runtime.h>

#include <cstdint>

#include "quant_align.cuh"

namespace {

constexpr int BM = 16;       // rows per block
constexpr int BN = 32;       // columns per block (one per lane)
constexpr int THREADS = 128; // 4 warps; warp w owns rows w, w+4, w+8, w+12
constexpr int RPW = BM / 4;  // rows per warp

__global__ void __launch_bounds__(THREADS)
dsbp_fused_kernel(const float* __restrict__ x, const float* __restrict__ ts_ptr,
                  const int8_t* __restrict__ ka,
                  const float* __restrict__ kscale,
                  const float* __restrict__ tw, float* __restrict__ y, int M,
                  int N, int Kp, dsbp::QACfg c) {
  using dsbp::GROUP;
  __shared__ short As[BM][GROUP];        // aligned input mantissas
  __shared__ float Sx[BM];               // folded input group scales s/ts
  __shared__ signed char Ws[GROUP][BN];  // weight mantissa tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n = n0 + lane;
  const bool n_ok = n < N;
  const float ts = *ts_ptr;
  const float twn = n_ok ? tw[n] : 1.f;

  float acc[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) acc[r] = 0.f;

  const int ng = Kp / GROUP;
  for (int g = 0; g < ng; ++g) {
    // ---- input side: one warp per row-group, two elements per lane ----
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + 4 * r;
      const int m = m0 + row;
      if (m >= M) continue;  // warp-uniform
      const float* xr = x + (size_t)m * Kp + (size_t)g * GROUP;
      int a0, a1, bits;
      float s;
      dsbp::quant_align_group(__fmul_rn(xr[lane], ts),
                              __fmul_rn(xr[lane + 32], ts), c, a0, a1, s,
                              bits);
      As[row][lane] = (short)a0;
      As[row][lane + 32] = (short)a1;
      if (lane == 0) Sx[row] = __fdiv_rn(s, ts);
    }
    // ---- weight side: the (64 x 32) int8 tile, neighbours on neighbouring n
    for (int i = tid; i < GROUP * BN; i += THREADS) {
      const int kr = i / BN;
      const int col = i - kr * BN;
      const int nn = n0 + col;
      Ws[kr][col] =
          nn < N ? ka[((size_t)g * GROUP + kr) * (size_t)N + nn] : (int8_t)0;
    }
    const float sw = n_ok ? __fdiv_rn(kscale[(size_t)g * N + n], twn) : 0.f;
    __syncthreads();

    // ---- MAC: exact int32 64-deep dots, then the scaled f32 partial ----
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + 4 * r;
      if (m0 + row >= M) continue;  // warp-uniform
      int dot = 0;
#pragma unroll 16
      for (int i = 0; i < GROUP; ++i) dot += (int)As[row][i] * (int)Ws[i][lane];
      acc[r] = __fadd_rn(acc[r], __fmul_rn(__fmul_rn((float)dot, Sx[row]), sw));
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int m = m0 + warp + 4 * r;
    if (m < M && n_ok) y[(size_t)m * N + n] = acc[r];
  }
}

}  // namespace

extern "C" int dsbp_fused_launch(const void* x, const void* ts, const void* ka,
                                 const void* kscale, const void* tw, void* y,
                                 int M, int N, int Kp, int mbits, int emin,
                                 int emax, float max_value, int fixed, float k,
                                 int b_fix, int trunc, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % dsbp::GROUP != 0)
    return (int)cudaErrorInvalidValue;
  dsbp::QACfg c{mbits, emin, emax, max_value, fixed, k, b_fix, trunc};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dsbp_fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ts, (const int8_t*)ka,
      (const float*)kscale, (const float*)tw, (float*)y, M, N, Kp, c);
  return (int)cudaGetLastError();
}
