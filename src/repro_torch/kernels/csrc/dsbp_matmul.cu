// Grouped integer DSBP GEMM for Hopper (B4): y (M,N) f32 =
//   sum_g sx[m,g] * sw[g,n] * dot64_g(ax, aw)
// from aligned input mantissas ax int32 (M,K) and their group scales sx f32
// (M,K/64) (B3's outputs) against a packed weight's kernel-layout operands
// aw int8 (K,N) (PackedDSBPWeight.ka) and sw f32 (K/64,N) (.kscale).
//
// Replaces src/repro/kernels/dsbp_matmul.py::dsbp_matmul_kernel_call (:84,
// bodies _kernel :34 and _kernel_folded :50, pallas_call :124).
//
// One order for both of the TPU kernel's forms: an exact 64-deep integer
// dot per group (|ax| <= 2^11, |aw| < 2^7: sums below 2^24), folded in
// group order as acc = acc + dot * (sx * sw).  Every product is exact, so
// the TPU's folded form (one rank-bk f32 dot of the pow2-prescaled
// operands) is the same sum taken in an order its MXU does not specify;
// here the exact group dots are both the fastest route and the most exact,
// so `folded` no longer selects other arithmetic and both forms give these
// bits (kernels/dsbp_matmul.py's plain version takes the same order).
//
// Bound on this card: the weight bytes (int8 aw + f32 sw) at decode M; the
// integer operations at prefill M.  The first design (a 16 x 32 output tile
// per 128-thread block, each group loaded synchronously between two
// barriers, the MAC on CUDA cores, the folded form one dependent FMA per
// k) ran 19-47x over the bound at decode.  This design is B1's GEMM stage
// (dsbp_gemm.cuh: a cp.async ring over the whole K, mma.sync m16n8k32 int8
// on the 12-bit input split into hi = a >> 6 and lo = a & 63, the decode
// tile for M <= 16 and the prefill tile above) on B3's operands, with
// sw = kscale as it is (no per-channel tw).  A layout kernel first splits
// the int32 mantissas into B1's hi | lo scratch, once per (row, group),
// and the GEMM reads it as B1's does.  (Splitting per stage in shared
// memory instead, one kernel with twice the A bytes in the ring and the
// same rows split again by every column block, was slower at every
// llama-7b shape on an H100, PERF.md.)  Any M; any K that is a multiple
// of 64; any N, N % 16 != 0 through a slower instantiation (byte loads of
// the weight rows, no padded copy).
#include <cuda_runtime.h>

#include <cstdint>

#include "dsbp_gemm.cuh"

namespace {

using dsbp::A_BYTES;
using dsbp::GROUP;
// B1's tiles
using DecodeTile = dsbp::Tile<16, 1, 4, 1, 4, 3, 3>;   // BN 32, 128 threads, 65 KB
using PrefillTile = dsbp::Tile<64, 4, 2, 8, 1, 4, 2>;  // BN 128, 256 threads, 76 KB

// ax (M, K) int32 -> hi | lo int8 rows per (row, group), B1's scratch
// layout: one thread per 4 mantissas
__global__ void __launch_bounds__(256)
layout_kernel(const int* __restrict__ ax, int8_t* __restrict__ a, long long quads) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= quads) return;
  const int4 v = *(const int4*)(ax + 4 * i);
  unsigned hi, lo;
  dsbp::split4(v.x, v.y, v.z, v.w, hi, lo);
  int8_t* row = a + (i >> 4) * A_BYTES + 4 * (i & 15);  // (row, group) i / 16
  *(unsigned*)row = hi;
  *(unsigned*)(row + GROUP) = lo;
}

}  // namespace

// scratch: at least M * (K/64) * 128 bytes, 16-byte aligned; ax 16-byte
// aligned
extern "C" int dsbp_matmul_launch(const void* ax, const void* sx, const void* aw,
                                  const void* sw, void* y, void* scratch,
                                  long long scratch_bytes, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % GROUP != 0) return (int)cudaErrorInvalidValue;
  const int G = K / GROUP;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)M * G;
  if (scratch == nullptr || scratch_bytes < rows * A_BYTES) return (int)cudaErrorInvalidValue;
  const long long quads = rows * (GROUP / 4);
  layout_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>((const int*)ax,
                                                                  (int8_t*)scratch, quads);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)dsbp::run_gemm_any_n<DecodeTile, PrefillTile, false>(
      (const int8_t*)scratch, (const float*)sx, aw, sw, nullptr, y, M, N, G, st);
}
