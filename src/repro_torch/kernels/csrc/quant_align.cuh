// The DSBP input path for one 64-wide group of one activation row, run by
// one warp: FP8 round-to-nearest-even saturating quantize, group max
// exponent, MPU bitwidth prediction (the paper's Eq. 1) and FIAU alignment
// to (b+1)-bit signed integers with the group scale 2^(e_max-(b-1)).
//
// Replaces the tile math of the TPU kernels:
// src/repro/kernels/fp8_quant_align.py::quant_align_tile (:53-112).
//
// Exactness: every scale is a power of two built from its bit pattern,
// floor(log2|x|) is read from the exponent field, and every rounding is
// spelled out as an IEEE round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn), which the compiler never contracts into an FMA.  The plain
// PyTorch version (repro_torch/kernels/dsbp_fused.py) performs the same
// operations in the same order, so the two agree bit for bit.  The MPU
// sums run as: lane-local pair (element l + element l+32), then an xor
// butterfly over offsets 16, 8, 4, 2, 1 — the plain version reproduces
// that tree with halving slices.
#pragma once

#include <cstdint>

namespace dsbp {

constexpr int GROUP = 64;
constexpr int MAX_SHIFT = 31;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct QACfg {
  int mbits;
  int emin;
  int emax;
  float max_value;
  int fixed;   // 1: clock-gated MPU, b = b_fix
  float k;     // MPU scaling factor
  int b_fix;
  int trunc;   // 1: FIAU truncation (floor), 0: round half to even
};

__device__ __forceinline__ float exp2i(int n) {
  return __int_as_float((n + 127) << 23);
}

__device__ __forceinline__ int floor_log2(float ax) {
  return ((__float_as_int(ax) >> 23) & 0xFF) - 127;
}

// FP8 quantize + field extraction of one (already tensor-scaled) value.
__device__ __forceinline__ void fp8_fields(float x, const QACfg& c, float& q,
                                           int& e_unb, float& m_int,
                                           bool& nz) {
  const float ax = fabsf(x);
  const int e = max(floor_log2(ax > 0.f ? ax : 1.f), c.emin);
  const float step = exp2i(e - c.mbits);
  float qq = __fmul_rn(rintf(__fdiv_rn(x, step)), step);
  qq = fminf(fmaxf(qq, -c.max_value), c.max_value);
  q = ax > 0.f ? qq : 0.f;
  const float aq = fabsf(q);
  const int eu = min(max(floor_log2(aq > 0.f ? aq : 1.f), c.emin), c.emax);
  m_int = rintf(__fmul_rn(aq, exp2i(c.mbits - eu)));
  nz = aq > 0.f;
  e_unb = nz ? eu : c.emin;
}

__device__ __forceinline__ float align_one(float q, float m_int, int shift,
                                           int b, const QACfg& c) {
  const float sgn = q < 0.f ? -1.f : 1.f;
  const float mag =
      __fmul_rn(__fmul_rn(sgn, m_int), exp2i(b - 1 - shift - c.mbits));
  const float lim = exp2i(b);
  if (c.trunc) return fminf(fmaxf(floorf(mag), -lim), lim - 1.f);
  return fminf(fmaxf(rintf(mag), -(lim - 1.f)), lim - 1.f);
}

// Lane `l` holds elements l and l+32 of the group (x0, x1), already
// multiplied by the tensor scale.  Every lane returns its two aligned
// mantissas; all lanes return the group's scale and bitwidth.
__device__ __forceinline__ void quant_align_group(float x0, float x1,
                                                  const QACfg& c, int& a0,
                                                  int& a1, float& scale,
                                                  int& bits) {
  float q0, q1, m0, m1;
  int e0, e1;
  bool nz0, nz1;
  fp8_fields(x0, c, q0, e0, m0, nz0);
  fp8_fields(x1, c, q1, e1, m1, nz1);

  // group max exponent over the non-zero elements
  int emax = max(nz0 ? e0 : -(1 << 30), nz1 ? e1 : -(1 << 30));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    emax = max(emax, __shfl_xor_sync(FULL_MASK, emax, off));
  if (!__any_sync(FULL_MASK, nz0 || nz1)) emax = 0;
  const int sh0 = nz0 ? min(max(emax - e0, 0), MAX_SHIFT) : MAX_SHIFT;
  const int sh1 = nz1 ? min(max(emax - e1, 0), MAX_SHIFT) : MAX_SHIFT;

  int b;
  if (c.fixed) {
    b = c.b_fix;
  } else {
    // MPU, Eq. (1): ratio = sum(shift*2^-shift) / sum(2^-shift)
    const float w0 = nz0 ? exp2i(-sh0) : 0.f;
    const float w1 = nz1 ? exp2i(-sh1) : 0.f;
    float num = __fadd_rn(__fmul_rn((float)sh0, w0), __fmul_rn((float)sh1, w1));
    float den = __fadd_rn(w0, w1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      num = __fadd_rn(num, __shfl_xor_sync(FULL_MASK, num, off));
      den = __fadd_rn(den, __shfl_xor_sync(FULL_MASK, den, off));
    }
    const float ratio = den > 0.f ? __fdiv_rn(num, fmaxf(den, 1e-30f)) : 0.f;
    const float raw = __fadd_rn(__fmul_rn(c.k, ratio), (float)c.b_fix);
    b = (int)fminf(fmaxf(ceilf(raw), 1.f), 11.f);
  }
  a0 = (int)align_one(q0, m0, sh0, b, c);
  a1 = (int)align_one(q1, m1, sh1, b, c);
  scale = exp2i(emax - (b - 1));
  bits = b;
}

}  // namespace dsbp
