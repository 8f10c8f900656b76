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
// 1. The input path runs once per (row, group), 16 lanes each, in a first
//    kernel (quant_align.cuh, which B3 runs too, so the two stay bit-equal;
//    16-byte loads of x and 4-byte stores of packed halves).  On
//    the TPU its grid visits each x tile once; here the N/BN column blocks
//    would each redo it (128-344x at llama-7b's decode shapes), which costs
//    more instruction slots than streaming the weights.  Each aligned mantissa
//    a (|a| <= 2048, 12 signed bits) is stored as two int8 halves,
//    hi = a >> 6 in [-32, 31] and lo = a & 63, with sx = s/ts: 132 bytes
//    per (row, group) in a scratch the wrapper allocates.
// 2. The GEMM kernel (dsbp_gemm.cuh, shared with B4: its TW = true
//    policy) streams the weight: one block owns BN columns over
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
// (prefill) 64 x 128 tiles on 8 warps.  Any N (N % 16 != 0 through the
// shared GEMM's slower instantiation, no padded copy of the weight); K' a
// multiple of 64.
#include <cuda_runtime.h>

#include <cstdint>

#include "dsbp_gemm.cuh"

namespace {

using dsbp::A_BYTES;
using dsbp::GROUP;
using DecodeTile = dsbp::Tile<16, 1, 4, 1, 4, 3, 3>;   // BN 32, 128 threads, 65 KB
using PrefillTile = dsbp::Tile<64, 4, 2, 8, 1, 4, 2>;  // BN 128, 256 threads, 76 KB

// The input path, once per (row, group): 16 lanes each, two a warp.
__global__ void __launch_bounds__(256)
prep_kernel(const float* __restrict__ x, const float* __restrict__ ts_ptr,
            int8_t* __restrict__ a, float* __restrict__ sx, long long rows, dsbp::QACfg c) {
  const int gl = threadIdx.x & 15;  // lane within the group: elements 4gl ..
  const long long wg = (long long)blockIdx.x * 16 + (threadIdx.x >> 4);  // (row, group)
  const bool ok = wg < rows;  // a lane past the end still takes part in the shuffles
  const float ts = *ts_ptr;
  float4 v = ok ? *(const float4*)(x + wg * GROUP + 4 * gl) : make_float4(0.f, 0.f, 0.f, 0.f);
  v = make_float4(__fmul_rn(v.x, ts), __fmul_rn(v.y, ts), __fmul_rn(v.z, ts),
                  __fmul_rn(v.w, ts));
  int4 q;
  float s;
  int bits;
  dsbp::quant_align_group(v, c, q, s, bits);
  if (!ok) return;
  unsigned hi, lo;
  dsbp::split4(q.x, q.y, q.z, q.w, hi, lo);
  int8_t* ar = a + wg * A_BYTES;
  *(unsigned*)(ar + 4 * gl) = hi;          // hi: floor(a / 64)
  *(unsigned*)(ar + GROUP + 4 * gl) = lo;  // lo: a - 64 hi
  if (gl == 0) sx[wg] = __fdiv_rn(s, ts);
}

}  // namespace

// scratch: at least M * (K'/64) * 132 bytes, 16-byte aligned
extern "C" int dsbp_fused_launch(const void* x, const void* ts, const void* ka,
                                 const void* kscale, const void* tw, void* y, void* scratch,
                                 long long scratch_bytes, int M, int N, int Kp, int mbits,
                                 int emin, int emax, float max_value, int fixed, float k,
                                 int b_fix, int trunc, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % GROUP != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Kp / GROUP;
  const long long rows = (long long)M * G;
  if (scratch == nullptr || scratch_bytes < rows * (A_BYTES + 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* a = (int8_t*)scratch;
  float* sx = (float*)(a + rows * A_BYTES);
  dsbp::QACfg c{mbits, emin, emax, max_value, fixed, k, b_fix, trunc};
  prep_kernel<<<(unsigned)((rows + 15) / 16), 256, 0, st>>>((const float*)x, (const float*)ts,
                                                            a, sx, rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)dsbp::run_gemm_any_n<DecodeTile, PrefillTile, true>(a, sx, ka, kscale, tw, y, M,
                                                                  N, G, st);
}
