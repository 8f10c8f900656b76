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
// group); a handful of integer and f32 operations per element.  The first
// design (one warp per group, lane l holding elements l and l+32, 4-byte
// loads and stores) reached 45% of the bytes bound at M=512.  This design:
// 16 lanes per (row, 64-group), lane l holding elements 4l .. 4l+3 (the
// mapping quant_align.cuh documents), so each thread moves 16 bytes per
// load and per store and a warp serves two groups; sixteen groups a
// 256-thread block.  Any M, any K that is a multiple of 64 (the Pallas
// kernel's K % bk == 0 block constraint does not carry over).
//
// empty_launch runs a kernel that does nothing, on the same stream: the
// launch floor chip_smoke.py sets beside B3's decode times.
#include <cuda_runtime.h>

#include <cstdint>

#include "quant_align.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / 16;  // groups a block: 16 lanes each

__global__ void __launch_bounds__(THREADS)
fp8_quant_align_kernel(const float* __restrict__ x, int* __restrict__ a,
                       float* __restrict__ scale, int* __restrict__ bits,
                       long long n_groups, dsbp::QACfg c) {
  using dsbp::GROUP;
  const int gl = threadIdx.x & 15;  // lane within the group: elements 4gl ..
  // groups are numbered row-major: group g of row m is m * (K/64) + g, and
  // its elements start at group * 64 of the contiguous (M,K) input
  const long long grp = (long long)blockIdx.x * GROUPS + (threadIdx.x >> 4);
  const bool ok = grp < n_groups;  // a lane past the end still takes part in the shuffles
  const float4 v =
      ok ? *(const float4*)(x + grp * GROUP + 4 * gl) : make_float4(0.f, 0.f, 0.f, 0.f);
  int4 q;
  float s;
  int b;
  dsbp::quant_align_group(v, c, q, s, b);
  if (!ok) return;
  *(int4*)(a + grp * GROUP + 4 * gl) = q;
  if (gl == 0) {
    scale[grp] = s;
    bits[grp] = b;
  }
}

__global__ void empty_kernel() {}

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
  const long long blocks = (n_groups + GROUPS - 1) / GROUPS;
  fp8_quant_align_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int*)a, (float*)scale, (int*)bits, n_groups, c);
  return (int)cudaGetLastError();
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
