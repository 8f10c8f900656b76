"""Macro throughput / energy model calibrated to the paper (Table I, II, Fig. 8).

Port of ``repro.core.energy`` (pure arithmetic, copied as it is).  Every
number here models the paper's 28 nm DCIM macro (0.052 mm², 250 MHz):
its throughput in TOPS and its efficiency in TOPS/W, fitted to the
published post-layout numbers.  None of them is a measurement of the GPU
the port runs on; wherever they are printed, they are labelled as the
macro's model.

The macro's throughput at aligned bitwidths (I, W) — both including the sign
bit, exactly as the paper reports "Avg. I/W" — is

    Tput(I, W) = 2 * rows * cols * f / (I * W)        [FLOPs or OPs]

which reproduces Table I exactly: 64*96*2*250MHz = 3.072 TOPs of 1b×2b column
work, /16 = 0.192 T @ 4/4, /64 = 0.048 T @ 8/8.

Power is mode-dependent and nearly bitwidth-independent (the array is always
busy; fewer bits just finish sooner — that is *why* efficiency scales ~1/(I·W)):

    P = P_INT                      (INT mode: FP frontend + MPU clock-gated)
      + P_ALIGN_A + P_ALIGN_B * I  (FP modes: FIAU + exponent logic + INT→FP)
      + P_MPU                      (DSBP mode only: the predictor pipeline)

Constants below are least-squares calibrated so every Table I row reproduces
within 3.1% (tests/test_torch_energy.py); they are *calibration* constants of
the published post-layout numbers, not circuit-derived values.
"""
from __future__ import annotations

import dataclasses

from .mac_array import GEOMETRY, ArrayGeometry, macro_cycles

__all__ = [
    "MacroSpec",
    "MACRO",
    "throughput_ops",
    "power_w",
    "efficiency_tops_per_w",
    "gemm_time_energy",
    "TABLE1",
    "TABLE2",
    "FIG8_AREA",
    "FIG8_POWER",
    "FIAU_VS_BARREL",
]


@dataclasses.dataclass(frozen=True)
class MacroSpec:
    geometry: ArrayGeometry = GEOMETRY
    freq_hz: float = 250e6  # 50-250 MHz, peak numbers at 250MHz/0.6V-scaled
    # calibrated power terms (W); see module docstring
    p_int: float = 1.7574e-3
    p_align_a: float = 0.8187e-3
    p_align_b: float = -2.7875e-5  # per input bit (calibration slope)
    p_mpu: float = 0.3289e-3
    area_mm2: float = 0.052
    sram_kb: float = 6.0
    process_nm: int = 28


MACRO = MacroSpec()


def throughput_ops(i_bits: float, w_bits: float, spec: MacroSpec = MACRO) -> float:
    """Sustained OPs/FLOPs per second at average aligned widths (I, W)."""
    g = spec.geometry
    return 2.0 * g.rows * g.cols * spec.freq_hz / (float(i_bits) * float(w_bits))


def power_w(
    i_bits: float,
    w_bits: float,
    mode: str,
    spec: MacroSpec = MACRO,
) -> float:
    """Macro power for mode in {'int', 'fp_fixed', 'fp_dsbp'}."""
    del w_bits
    p = spec.p_int
    if mode in ("fp_fixed", "fp_dsbp"):
        p += spec.p_align_a + spec.p_align_b * float(i_bits)
    if mode == "fp_dsbp":
        p += spec.p_mpu
    elif mode not in ("int", "fp_fixed"):
        raise ValueError(f"unknown mode {mode!r}")
    return p


def efficiency_tops_per_w(
    i_bits: float, w_bits: float, mode: str, spec: MacroSpec = MACRO
) -> float:
    return throughput_ops(i_bits, w_bits, spec) / power_w(i_bits, w_bits, mode, spec) / 1e12


def gemm_time_energy(
    m: int, k: int, n: int, i_bits: float, w_bits: float, mode: str,
    spec: MacroSpec = MACRO,
) -> tuple[float, float]:
    """(seconds, joules) for an (m,k,n) GEMM on one macro at avg widths."""
    cyc = macro_cycles(m, k, n, int(round(i_bits)), max(2, int(round(w_bits))), spec.geometry)
    t = cyc / spec.freq_hz
    return t, t * power_w(i_bits, w_bits, mode, spec)


# ----- published numbers, used by benchmarks + calibration tests -----------

# Table I: (format, avg I, avg W, k, b_fix, throughput T{F}LOPs, eff T{F}LOPS/W)
TABLE1 = [
    {"format": "E5M3", "i": 4, "w": 4, "k": 0, "b_fix": (3, 3), "mode": "fp_fixed",
     "tput": 0.192e12, "eff": 77.9},
    {"format": "E5M7", "i": 8, "w": 8, "k": 0, "b_fix": (7, 7), "mode": "fp_fixed",
     "tput": 0.048e12, "eff": 20.4},
    {"format": "INT4", "i": 4, "w": 4, "k": None, "b_fix": None, "mode": "int",
     "tput": 0.192e12, "eff": 109.3},
    {"format": "INT8", "i": 8, "w": 8, "k": None, "b_fix": None, "mode": "int",
     "tput": 0.048e12, "eff": 27.3},
    {"format": "Precise", "i": 7.65, "w": 6.61, "k": 1, "b_fix": (6, 5), "mode": "fp_dsbp",
     "tput": 0.061e12, "eff": 22.5},
    {"format": "Efficient", "i": 5.58, "w": 6.08, "k": 2, "b_fix": (4, 4), "mode": "fp_dsbp",
     "tput": 0.092e12, "eff": 33.7},
]

# Table II: SOTA comparison (static constants for benchmarks/bench_table2.py)
TABLE2 = {
    "CICC24[6]": {"process": "28nm", "voltage": "0.55-0.9V", "freq": "20-180MHz",
                  "area_mm2": 0.143, "sram_kb": 16, "int_prec": "8b",
                  "fp_prec": "UBF16", "peak_int_eff": 152.0, "peak_fp_eff": 128.0,
                  "dynamic_mantissa": False, "silicon": True},
    "ESSCIRC23[15]": {"process": "28nm", "voltage": "0.55-1.2V",
                      "freq": "650MHz/2.4GHz", "area_mm2": 0.71, "sram_kb": 4,
                      "int_prec": None, "fp_prec": "FP8(E5M2)/BF8",
                      "peak_fp_eff": 66.6, "fp8_eff": 12.1,
                      "dynamic_mantissa": False, "silicon": True},
    "ISCAS25[16]": {"process": "40nm", "voltage": "0.7-1.2V", "freq": "70-435MHz",
                    "area_mm2": 1.876, "sram_kb": 36, "int_prec": "4/8b",
                    "fp_prec": "FP8(E4M3)", "peak_int_eff": 35.7,
                    "peak_fp_eff": 7.1, "dynamic_mantissa": False, "silicon": False},
    "ours": {"process": "28nm", "voltage": "0.6-0.9V", "freq": "50-250MHz",
             "area_mm2": 0.052, "sram_kb": 6, "int_prec": "I:2-12b;W:2/4/6/8",
             "fp_prec": "FP8(all)", "peak_int_eff": 27.3, "peak_fp_eff": 77.9,
             "e5m7_eff": 20.4, "precise_eff": 22.5, "efficient_eff": 33.7,
             "dynamic_mantissa": True, "silicon": False},
}
# Headline claim: ours E5M7 (8/8b) vs [16] E4M3 (8/8b): 20.4 / 7.1 = 2.87x.
FP8_EFFICIENCY_GAIN_VS_ISCAS25 = 20.4 / 7.1

# Fig. 8 breakdown (measured at 8b mantissa). Area fractions stated in the
# text; remaining split is approximate (read from the figure).
FIG8_AREA = {
    "mpu": 0.070,
    "fusion_unit": 0.146,  # of which non-reused datapath:
    "fusion_non_reused": 0.094,
    "input_alignment_other": 0.12,  # FIAU + max-exponent logic (approx.)
    "sram_and_mac": 0.664,  # remainder
}
FIG8_POWER = {
    "mpu": 0.065, "fusion_unit": 0.15, "input_alignment_other": 0.14,
    "sram_and_mac": 0.645,  # approximate figure read-offs; MPU clock-gated in fixed mode
}

# §II-C synthesis comparison, same input configuration, 28nm
FIAU_VS_BARREL = {"area_reduction": 0.217, "power_reduction": 0.341}
