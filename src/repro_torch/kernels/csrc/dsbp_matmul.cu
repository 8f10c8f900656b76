// Grouped integer DSBP GEMM for Hopper (B4): y (M,N) f32 =
//   sum_g sx[m,g] * sw[g,n] * dot64_g(ax, aw)
// from aligned input mantissas ax int32 (M,K) and their group scales sx f32
// (M,K/64) (B3's outputs) against a packed weight's kernel-layout operands
// aw int8 (K,N) (PackedDSBPWeight.ka) and sw f32 (K/64,N) (.kscale).
//
// Replaces src/repro/kernels/dsbp_matmul.py::dsbp_matmul_kernel_call (:84,
// bodies _kernel :34 and _kernel_folded :50, pallas_call :124).  Two forms:
//   unfolded (FOLDED=false): an exact int32 64-deep dot per group, then
//     acc = acc + dot * (sx * sw) in group order — every product is exact
//     (|ax| < 2^11, |aw| < 2^7, 64-deep sums < 2^24, pow2 scales), so only
//     the f32 adds round;
//   folded (FOLDED=true, the serving default): one running f32 sum over K
//     of the pow2-prescaled operands (ax*sx) * (aw*sw), here spelled as
//     fmaf(float(ax*aw), sx*sw, acc) — the same exact product, one rounding
//     per term, as the TPU's single rank-bk dot.
// The plain versions (kernels/dsbp_matmul.py) add in the same orders, so
// both forms agree with them bit for bit.
//
// Bound on this card: the weight bytes (int8 aw + f32 sw) at decode M; the
// integer operations at prefill M.  Design of this first version, as B1's
// MAC: a (16 x 32) output tile per 128-thread block, a loop over the K
// groups inside the block (the TPU's sequential kk grid axis), the input
// mantissas (int16 in shared memory: they fit 12 signed bits) and the
// (64 x 32) int8 weight tile staged in shared memory, the MAC on CUDA
// cores (12-bit signed inputs do not fit int8 MMA).  Any M and N; any K
// that is a multiple of 64 (no K % 512 block constraint).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GROUP = 64;
constexpr int BM = 16;       // rows per block
constexpr int BN = 32;       // columns per block (one per lane)
constexpr int THREADS = 128; // 4 warps; warp w owns rows w, w+4, w+8, w+12
constexpr int RPW = BM / 4;  // rows per warp

template <bool FOLDED>
__global__ void __launch_bounds__(THREADS)
dsbp_matmul_kernel(const int* __restrict__ ax, const float* __restrict__ sx,
                   const int8_t* __restrict__ aw,
                   const float* __restrict__ sw, float* __restrict__ y,
                   int M, int N, int K) {
  __shared__ short As[BM][GROUP];        // input mantissas of the group
  __shared__ float Sx[BM];               // input group scales
  __shared__ signed char Ws[GROUP][BN];  // weight mantissa tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n = n0 + lane;
  const bool n_ok = n < N;
  const int ng = K / GROUP;

  float acc[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) acc[r] = 0.f;

  for (int g = 0; g < ng; ++g) {
    // ---- input tile: 16 rows x 64, neighbours on neighbouring k ----
    for (int i = tid; i < BM * GROUP; i += THREADS) {
      const int r = i / GROUP;
      const int kk = i - r * GROUP;
      const int m = m0 + r;
      As[r][kk] = m < M ? (short)ax[(size_t)m * K + (size_t)g * GROUP + kk]
                        : (short)0;
    }
    if (tid < BM) Sx[tid] = m0 + tid < M ? sx[(size_t)(m0 + tid) * ng + g] : 0.f;
    // ---- weight tile: 64 x 32 int8, neighbours on neighbouring n ----
    for (int i = tid; i < GROUP * BN; i += THREADS) {
      const int kr = i / BN;
      const int col = i - kr * BN;
      const int nn = n0 + col;
      Ws[kr][col] =
          nn < N ? aw[((size_t)g * GROUP + kr) * (size_t)N + nn] : (int8_t)0;
    }
    const float swn = n_ok ? sw[(size_t)g * N + n] : 0.f;
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + 4 * r;
      if (m0 + row >= M) continue;  // warp-uniform
      const float s = __fmul_rn(Sx[row], swn);  // pow2 x pow2: exact
      if (FOLDED) {
        float a = acc[r];
#pragma unroll 16
        for (int i = 0; i < GROUP; ++i)
          a = fmaf((float)((int)As[row][i] * (int)Ws[i][lane]), s, a);
        acc[r] = a;
      } else {
        int dot = 0;
#pragma unroll 16
        for (int i = 0; i < GROUP; ++i) dot += (int)As[row][i] * (int)Ws[i][lane];
        acc[r] = __fadd_rn(acc[r], __fmul_rn((float)dot, s));
      }
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

extern "C" int dsbp_matmul_launch(const void* ax, const void* sx,
                                  const void* aw, const void* sw, void* y,
                                  int M, int N, int K, int folded,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % GROUP != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (folded)
    dsbp_matmul_kernel<true><<<grid, THREADS, 0, st>>>(
        (const int*)ax, (const float*)sx, (const int8_t*)aw, (const float*)sw,
        (float*)y, M, N, K);
  else
    dsbp_matmul_kernel<false><<<grid, THREADS, 0, st>>>(
        (const int*)ax, (const float*)sx, (const int8_t*)aw, (const float*)sw,
        (float*)y, M, N, K);
  return (int)cudaGetLastError();
}
