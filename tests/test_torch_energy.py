"""The port's macro energy model (``repro_torch.core.energy``) and array
geometry against the JAX package: the assertions of
``tests/test_energy.py`` on the port's copy, its numbers equal to JAX's
at every Table I point and on a grid of widths (exact: the same
arithmetic), and the DSBP-vs-fixed mechanism on the port's quantized
GEMM.  Every number is the paper's 28 nm macro model, not a device
measurement."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from repro.core import energy as JE  # noqa: E402
from repro.core import mac_array as JMA  # noqa: E402
from repro_torch.core import energy as E  # noqa: E402
from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core import mac_array as MA  # noqa: E402
from repro_torch.core import quantized as Q  # noqa: E402
from repro_torch.core.dsbp import DSBPConfig  # noqa: E402


def test_table1_throughput_exact():
    for row in E.TABLE1:
        tput = E.throughput_ops(row["i"], row["w"])
        assert abs(tput - row["tput"]) / row["tput"] < 0.02, row["format"]


def test_table1_efficiency_calibration():
    for row in E.TABLE1:
        eff = E.efficiency_tops_per_w(row["i"], row["w"], row["mode"])
        assert abs(eff - row["eff"]) / row["eff"] < 0.031, (row["format"], eff)


def test_e5m3_vs_e5m7_4x():
    r = E.efficiency_tops_per_w(4, 4, "fp_fixed") / E.efficiency_tops_per_w(8, 8, "fp_fixed")
    assert 3.5 < r < 4.3


def test_int8_beats_e5m7():
    assert E.efficiency_tops_per_w(8, 8, "int") > E.efficiency_tops_per_w(8, 8, "fp_fixed")


def test_efficient_vs_precise_1p5x():
    precise = E.efficiency_tops_per_w(7.65, 6.61, "fp_dsbp")
    efficient = E.efficiency_tops_per_w(5.58, 6.08, "fp_dsbp")
    assert 1.35 < efficient / precise < 1.65  # paper: 1.5x


def test_fp8_gain_vs_prior_work():
    assert abs(E.FP8_EFFICIENCY_GAIN_VS_ISCAS25 - 2.87) < 0.05  # paper: 2.8x


def test_gemm_time_energy_monotone():
    t4, e4 = E.gemm_time_energy(64, 4096, 64, 4, 4, "fp_fixed")
    t8, e8 = E.gemm_time_energy(64, 4096, 64, 8, 8, "fp_fixed")
    assert t8 > t4 and e8 > e4


def test_mpu_clock_gating():
    assert E.power_w(8, 8, "fp_dsbp") > E.power_w(8, 8, "fp_fixed") > E.power_w(8, 8, "int")
    with pytest.raises(ValueError, match="unknown mode"):
        E.power_w(8, 8, "fp_other")


def test_published_tables_equal_jax():
    assert E.TABLE1 == JE.TABLE1 and E.TABLE2 == JE.TABLE2
    assert (E.FIG8_AREA, E.FIG8_POWER, E.FIAU_VS_BARREL) == \
        (JE.FIG8_AREA, JE.FIG8_POWER, JE.FIAU_VS_BARREL)
    assert dataclasses.asdict(E.MACRO) == dataclasses.asdict(JE.MACRO)


@pytest.mark.parametrize("row", range(6), ids=lambda i: JE.TABLE1[i]["format"])
def test_model_equals_jax_at_table1_point(row):
    r = E.TABLE1[row]
    args = (r["i"], r["w"])
    assert E.throughput_ops(*args) == JE.throughput_ops(*args)
    assert E.power_w(*args, r["mode"]) == JE.power_w(*args, r["mode"])
    assert E.efficiency_tops_per_w(*args, r["mode"]) == \
        JE.efficiency_tops_per_w(*args, r["mode"])
    for mkn in ((4, 4096, 4096), (512, 11008, 4096), (1, 64, 96)):
        assert E.gemm_time_energy(*mkn, *args, r["mode"]) == \
            JE.gemm_time_energy(*mkn, *args, r["mode"])


def test_geometry_equals_jax():
    assert dataclasses.asdict(MA.GEOMETRY) == dataclasses.asdict(JMA.GEOMETRY)
    for w in (2, 4, 6, 8):
        assert MA.effective_output_columns(w) == JMA.effective_output_columns(w)
        for i in (2, 5, 12):
            for mkn in ((4, 4096, 11008), (3, 100, 7)):
                assert MA.macro_cycles(*mkn, i, w) == JMA.macro_cycles(*mkn, i, w)


def _layer_data(seed=0, m=64, k=512, n=32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * np.exp2(rng.integers(-3, 3, (m, k)))).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.03).astype(np.float32)
    return torch.as_tensor(x), torch.as_tensor(w)


def _avg_bits(x, w, cfg):
    """matmul_stats' average aligned widths (incl. the sign bit)."""
    bi = Q.quantize_inputs(x.reshape(-1, x.shape[-1]), cfg.input_cfg)["bits"]
    bw = Q.quantize_weights(w, cfg.weight_cfg)["bits"]
    return float((bi.float() + 1).mean()), float((bw.float() + 1).mean())


def test_dsbp_pareto_vs_fixed():
    """DSBP reaches an error comparable to a fixed config of comparable
    average width (the mechanism behind the paper's Fig. 7)."""
    x, w = _layer_data()
    exact = (x.double() @ w.double()).numpy()

    def rel(cfg):
        y = Q.dsbp_matmul_ref(x, w, cfg).numpy()
        i, ww = _avg_bits(x, w, cfg)
        return np.abs(y - exact).mean() / np.abs(exact).mean(), i * ww

    err_d, cost_d = rel(Q.PRESETS["efficient"])
    fixed = Q.QuantizedMatmulConfig(
        input_cfg=DSBPConfig(fmt="e4m3", side="input", mode="fixed", b_fix=7),
        weight_cfg=DSBPConfig(fmt="e2m5", side="weight", mode="fixed", b_fix=7))
    err_f, cost_f = rel(fixed)
    assert cost_d <= cost_f * 1.35
    assert err_d <= err_f * 2.5


def test_upper_bound_config_matches_fp8():
    """12b-input/8b-weight alignment ~= the FP8 baseline (paper Fig. 6)."""
    x, w = _layer_data(seed=1)
    cfg = Q.QuantizedMatmulConfig(
        input_cfg=DSBPConfig(fmt="e4m3", side="input", mode="fixed", b_fix=11),
        weight_cfg=DSBPConfig(fmt="e2m5", side="weight", mode="fixed", b_fix=7))
    y = Q.dsbp_matmul_ref(x, w, cfg).numpy()
    sx = F.per_tensor_scale(x, "e4m3")
    sw = F.per_tensor_scale(w, "e2m5")
    xq = (F.quantize(x * sx, "e4m3") / sx).double().numpy()
    wq = (F.quantize(w * sw, "e2m5") / sw).double().numpy()
    base = xq @ wq
    exact = (x.double() @ w.double()).numpy()
    align_err = np.abs(y - base).mean()
    quant_err = np.abs(base - exact).mean()
    assert align_err < 0.35 * quant_err
    assert np.abs(y - base).mean() / np.abs(base).mean() < 0.02
