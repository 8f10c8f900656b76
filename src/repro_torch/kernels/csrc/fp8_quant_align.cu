// Standalone DSBP input path for Hopper (B3): x (M,K) f32, already
// multiplied by the pow2 per-tensor scale -> aligned mantissas a int32
// (M,K), group scales f32 (M,K/64) and predicted widths int32 (M,K/64).
//
// Replaces src/repro/kernels/fp8_quant_align.py::fp8_quant_align_kernel_call
// (:123, body _kernel :115, pallas_call :146).  The group code is
// quant_align.cuh's quant_align_group, which B1 (dsbp_fused.cu) runs on
// the same values, so the two input paths agree bit for bit by
// construction; the plain version is kernels/dsbp_fused.py::
// quant_align_tile.
//
// Bound on this card: bytes (4 read and 4 written per element, 8 more per
// group); a handful of integer and f32 operations per element.  Design:
// one warp per (row, 64-group), lane l holding elements l and l+32, so
// every load and store of the warp is two coalesced 128-byte lines; eight
// warps a block, as many blocks as groups / 8.  Any M, any K that is a
// multiple of 64 (the Pallas kernel's K % bk == 0 block constraint does not
// carry over).
#include <cuda_runtime.h>

#include <cstdint>

#include "quant_align.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
fp8_quant_align_kernel(const float* __restrict__ x, int* __restrict__ a,
                       float* __restrict__ scale, int* __restrict__ bits,
                       long long n_groups, dsbp::QACfg c) {
  using dsbp::GROUP;
  const int lane = threadIdx.x & 31;
  // groups are numbered row-major: group g of row m is m * (K/64) + g, and
  // its elements start at group * 64 of the contiguous (M,K) input
  const long long grp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (grp >= n_groups) return;  // warp-uniform
  const float* xg = x + grp * GROUP;
  int a0, a1, b;
  float s;
  dsbp::quant_align_group(xg[lane], xg[lane + 32], c, a0, a1, s, b);
  int* ag = a + grp * GROUP;
  ag[lane] = a0;
  ag[lane + 32] = a1;
  if (lane == 0) {
    scale[grp] = s;
    bits[grp] = b;
  }
}

}  // namespace

extern "C" int fp8_quant_align_launch(const void* x, void* a, void* scale,
                                      void* bits, int M, int K, int mbits,
                                      int emin, int emax, float max_value,
                                      int fixed, float k, int b_fix, int trunc,
                                      void* stream) {
  if (M <= 0 || K <= 0 || K % dsbp::GROUP != 0)
    return (int)cudaErrorInvalidValue;
  dsbp::QACfg c{mbits, emin, emax, max_value, fixed, k, b_fix, trunc};
  const long long n_groups = (long long)M * (K / dsbp::GROUP);
  const long long blocks = (n_groups + WARPS - 1) / WARPS;
  fp8_quant_align_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int*)a, (float*)scale, (int*)bits, n_groups, c);
  return (int)cudaGetLastError();
}
