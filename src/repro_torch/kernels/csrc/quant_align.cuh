// The DSBP input path for one 64-wide group of one activation row, run by
// 16 lanes of a warp (a warp runs two groups): FP8 round-to-nearest-even
// saturating quantize, group max exponent, MPU bitwidth prediction (the
// paper's Eq. 1) and FIAU alignment to (b+1)-bit signed integers with the
// group scale 2^(e_max-(b-1)).
//
// Replaces the tile math of the TPU kernels:
// src/repro/kernels/fp8_quant_align.py::quant_align_tile (:53-112).
//
// Exactness: every scale is a power of two built from its bit pattern,
// floor(log2|x|) is read from the exponent field, and every rounding is
// spelled out as an IEEE round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn), which the compiler never contracts into an FMA.  The plain
// PyTorch version (repro_torch/kernels/dsbp_fused.py) performs the same
// operations in the same order, so the two agree bit for bit.
//
// Lane mapping: lane l of the group's 16 holds elements 4l .. 4l+3, so
// every load and store of a thread is 16 bytes.  The group max is order-
// free; the two MPU sums are f32 sums that can round (e5m2's shifts reach
// 29), so they keep one fixed tree: element e + element e+32, then e + 16,
// e + 8, e + 4 (xor shuffles over 8, 4, 2, 1 lanes, one per element a
// lane holds), then e + 2 and e + 1 within the lane.  Float addition is
// commutative, so every lane ends with the same bits, and the plain
// version reproduces the tree with halving slices (dsbp_fused._tree_sum).
// B1's input path (dsbp_fused.cu) and B3 (fp8_quant_align.cu) both run
// this function, so they align the same values to the same bits.
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

// Lanes 16h .. 16h+15 of the warp run one group (h = 0, 1; every lane of
// the warp takes part, a lane without a group with any finite x).  Lane l
// of the 16 holds elements 4l .. 4l+3 of the group in x, already multiplied
// by the tensor scale, and gets their aligned mantissas in a; every lane
// of the 16 gets the group's scale and bitwidth.
__device__ __forceinline__ void quant_align_group(const float4 x, const QACfg& c, int4& a,
                                                  float& scale, int& bits) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
  float q[4], mi[4];
  int e[4];
  bool nz[4];
  int emax = -(1 << 30);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fp8_fields(xs[i], c, q[i], e[i], mi[i], nz[i]);
    if (nz[i]) emax = max(emax, e[i]);
  }
  // group max exponent over the non-zero elements (0 where there is none)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    emax = max(emax, __shfl_xor_sync(FULL_MASK, emax, off));
  if (emax == -(1 << 30)) emax = 0;
  int sh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sh[i] = nz[i] ? min(max(emax - e[i], 0), MAX_SHIFT) : MAX_SHIFT;

  int b;
  if (c.fixed) {
    b = c.b_fix;
  } else {
    // MPU, Eq. (1): ratio = sum(shift*2^-shift) / sum(2^-shift)
    float num[4], den[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      den[i] = nz[i] ? exp2i(-sh[i]) : 0.f;
      num[i] = __fmul_rn((float)sh[i], den[i]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        num[i] = __fadd_rn(num[i], __shfl_xor_sync(FULL_MASK, num[i], off));
        den[i] = __fadd_rn(den[i], __shfl_xor_sync(FULL_MASK, den[i], off));
      }
    const float nsum = __fadd_rn(__fadd_rn(num[0], num[2]), __fadd_rn(num[1], num[3]));
    const float dsum = __fadd_rn(__fadd_rn(den[0], den[2]), __fadd_rn(den[1], den[3]));
    const float ratio = dsum > 0.f ? __fdiv_rn(nsum, fmaxf(dsum, 1e-30f)) : 0.f;
    const float raw = __fadd_rn(__fmul_rn(c.k, ratio), (float)c.b_fix);
    b = (int)fminf(fmaxf(ceilf(raw), 1.f), 11.f);
  }
  a = make_int4((int)align_one(q[0], mi[0], sh[0], b, c), (int)align_one(q[1], mi[1], sh[1], b, c),
                (int)align_one(q[2], mi[2], sh[2], b, c), (int)align_one(q[3], mi[3], sh[3], b, c));
  scale = exp2i(emax - (b - 1));
  bits = b;
}

}  // namespace dsbp
