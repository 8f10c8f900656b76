"""The DCIM circuit models in the port against the JAX package, on the CPU.

The same numpy inputs go through ``repro.core.{mpu,fiau,mac_array}`` and
``repro_torch.core.{mpu,fiau,mac_array}``; every result is an integer and
must be equal.  The cases are those of tests/test_mpu.py, test_fiau.py and
test_mac_array.py, each held to JAX's result and to the same oracle
(Eq. 1's float ratio, a plain integer matmul).  Then the port's own
composition (tests/test_macro_composition.py): the MPU predicts each input
group's width, the FIAU aligns every element, the 2b-sliced MAC array
takes the group dots, and the result equals the port's software DSBP GEMM
(``grouped_int_matmul``) exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax.numpy as jnp  # noqa: E402

from repro.core import dsbp as JD  # noqa: E402
from repro.core import fiau as JFI  # noqa: E402
from repro.core import formats as JF  # noqa: E402
from repro.core import mac_array as JMA  # noqa: E402
from repro.core import mpu as JMPU  # noqa: E402
from repro_torch.core import dsbp as D  # noqa: E402
from repro_torch.core import fiau as FI  # noqa: E402
from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core import mac_array as MA  # noqa: E402
from repro_torch.core import mpu as MPU  # noqa: E402
from repro_torch.core.dsbp import DSBPConfig  # noqa: E402
from repro_torch.core.quantized import (QuantizedMatmulConfig, dsbp_matmul_ref,  # noqa: E402
                                        grouped_int_matmul)

# ---------------------------------------------------------------------------
# the MPU (tests/test_mpu.py)
# ---------------------------------------------------------------------------


def _x_groups(n, seed, spread=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 64))
            * np.exp2(rng.integers(-spread, spread, (n, 64)))).astype(np.float32)


def _realistic_shifts(n=2000, seed=0):
    """Shift patterns of real FP8 groups (the max element has shift 0),
    from the port's own decompose and group_shifts, which must give JAX's."""
    x = _x_groups(n, seed)
    d = F.decompose(torch.from_numpy(x), "e4m3")
    shift, _, nz = D.group_shifts(d["e_unb"], d["m_int"])
    jd = JF.decompose(jnp.asarray(x), "e4m3")
    jshift, _, jnz = JD.group_shifts(jd["e_unb"], jd["m_int"])
    np.testing.assert_array_equal(shift.numpy(), np.asarray(jshift))
    np.testing.assert_array_equal(nz.numpy(), np.asarray(jnz))
    return shift, nz


def _both_predict(shift, nz, k_fixed, b_fix, ceil_output=True):
    """(port, JAX) mpu_predict on the same groups, as numpy."""
    got = MPU.mpu_predict(shift, nz, k_fixed, b_fix, ceil_output).numpy()
    want = np.asarray(JMPU.mpu_predict(jnp.asarray(shift.numpy()), jnp.asarray(nz.numpy()),
                                       k_fixed, b_fix, ceil_output))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


def test_reciprocal_lut_equals_jax_and_is_correctly_rounded():
    lut = MPU.reciprocal_lut.numpy()
    np.testing.assert_array_equal(lut, np.asarray(JMPU.reciprocal_lut))
    assert lut.shape == (256,)
    d = np.arange(128, 256)
    assert np.abs(lut[d] / 2.0**15 - 1.0 / d).max() <= 0.5 / 2**15 + 1e-12
    assert (MPU.MPU_F, MPU.MPU_KF, MPU.MPU_Q) == (JMPU.MPU_F, JMPU.MPU_KF, JMPU.MPU_Q)


def test_ratio_equals_jax_and_tracks_the_float_oracle():
    shift, nz = _realistic_shifts()
    got = MPU.mpu_ratio(shift, nz)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JMPU.mpu_ratio(jnp.asarray(shift.numpy()),
                                               jnp.asarray(nz.numpy()))))
    rf = D.predict_bdyn(shift, nz).numpy()
    assert np.abs(rf - got.numpy() / 2.0**MPU.MPU_Q).max() < 0.05  # 8b LUT + F=12


@pytest.mark.parametrize("ceil_output", [True, False], ids=["ceil", "round"])
@pytest.mark.parametrize("k,b_fix", [(0, 3), (1, 6), (1, 5), (2, 4), (2, 3)])
def test_predict_equals_jax_within_one_level(k, b_fix, ceil_output):
    shift, nz = _realistic_shifts(seed=k * 7 + b_fix)
    hw = _both_predict(shift, nz, k * (1 << MPU.MPU_KF), b_fix, ceil_output)
    rf = D.predict_bdyn(shift, nz).numpy()
    raw = np.clip(k * rf + b_fix, 0, 31)
    oracle = (np.ceil(raw) if ceil_output else np.floor(raw + 0.5)).astype(np.int32)
    assert np.abs(hw - oracle).max() <= 1
    assert (hw == oracle).mean() >= 0.95


def test_predict_equals_jax_on_mixed_zero_groups():
    """Some groups all zero, shifts past F, k up to 31.9375 (k_fixed 511)."""
    shift, nz = _realistic_shifts(n=500, seed=11)
    nz = nz.clone()
    nz[::5] = False
    nz[1::5, 32:] = False
    for k_fixed, b_fix in ((511, 0), (1, 31), (40, 7)):
        _both_predict(shift, nz, k_fixed, b_fix)


def _one_group(shift_value, nz_value=True, first=None):
    s = torch.full((1, 64), shift_value, dtype=torch.int32)
    if first is not None:
        s[0, 0] = first
    return s, torch.full((1, 64), nz_value)


@pytest.mark.parametrize("case,k_fixed,b_fix,lo,hi", [
    ("all shifts 0", 16, 4, 4, 4),          # B = b_fix exactly
    ("nearly all 5", 16, 4, 8, 9),          # k=1 adds ~5
    ("saturates at 31", 16, 31, 31, 31),
    ("no wrap past 31", 16, 99, 31, 31),    # saturates, does not wrap
    ("all-zero group", 32, 4, 4, 4),        # ratio 0 -> B_fix
])
def test_paper_examples_and_saturation(case, k_fixed, b_fix, lo, hi):
    shift, nz = {"all shifts 0": _one_group(0), "nearly all 5": _one_group(5, first=0),
                 "saturates at 31": _one_group(0), "no wrap past 31": _one_group(0),
                 "all-zero group": _one_group(9, nz_value=False)}[case]
    b = int(_both_predict(shift, nz, k_fixed, b_fix)[0])
    assert lo <= b <= hi


def test_stage1_fixed_point_widths():
    """num_i maxes at 2**(F-1), den_i at 2**F: the adder trees never overflow."""
    shift = torch.arange(32, dtype=torch.int32)[None].repeat(2, 1)
    nz = torch.ones_like(shift, dtype=torch.bool)
    num, den = MPU._stage1(shift, nz)
    jnum, jden = JMPU._stage1(jnp.asarray(shift.numpy()), jnp.asarray(nz.numpy()))
    np.testing.assert_array_equal(num.numpy(), np.asarray(jnum))
    np.testing.assert_array_equal(den.numpy(), np.asarray(jden))
    assert int(num.max()) <= 1 << (MPU.MPU_F - 1)
    assert int(den.max()) <= 1 << MPU.MPU_F


def test_normalize_finds_the_msb_of_every_reachable_sum():
    """The priority encoder over every den_sum up to 64 * 2**F = 2**18."""
    den = torch.arange(0, 2**18 + 1, dtype=torch.int32)
    d, t = MPU._normalize_u8(den)
    jd, jt = JMPU._normalize_u8(jnp.asarray(den.numpy()))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    pos = den > 0
    assert bool(((d[pos] >= 128) & (d[pos] <= 255)).all())


# ---------------------------------------------------------------------------
# the FIAU (tests/test_fiau.py)
# ---------------------------------------------------------------------------


def test_fiau_exhaustive_small():
    """Every (value, offset, save_len) for a 7-bit FIFO (E2M5 mantissa+sign):
    the pointer machine == JAX's == the barrel shifter, each cycle count
    save_len."""
    grid = [(v, off, sl) for v in range(-64, 64) for off in range(10) for sl in range(2, 13)]
    v, off, sl = (np.asarray(c) for c in zip(*grid))
    barrel = FI.barrel_align(torch.from_numpy(v), torch.from_numpy(off), 7,
                             torch.from_numpy(sl)).numpy()
    np.testing.assert_array_equal(barrel, JFI.barrel_align(v, off, 7, sl))
    for (vv, o, s), b in zip(grid, barrel):
        out, cyc = FI.fiau_serial(vv, 7, o, s)
        assert (out, cyc) == JFI.fiau_serial(vv, 7, o, s) == (b, s)


def test_fiau_wide_fifo():
    """A 9-bit FIFO at offsets 0..31: the barrel shifter over the whole
    grid equals JAX's, and the pointer machine on 300 seeded points."""
    v, off, sl = np.meshgrid(np.arange(-256, 256), np.arange(32), np.arange(2, 13),
                             indexing="ij")
    v, off, sl = v.ravel(), off.ravel(), sl.ravel()
    barrel = FI.barrel_align(torch.from_numpy(v), torch.from_numpy(off), 9,
                             torch.from_numpy(sl)).numpy()
    np.testing.assert_array_equal(barrel, JFI.barrel_align(v, off, 9, sl))
    for i in np.random.default_rng(9).integers(0, v.size, 300):
        args = (int(v[i]), 9, int(off[i]), int(sl[i]))
        assert FI.fiau_serial(*args) == JFI.fiau_serial(*args) == (barrel[i], int(sl[i]))


@pytest.mark.parametrize("v,w_in,off,sl,want", [
    (-37, 7, 2, 5, -37 >> 4),  # arithmetic shift == floor division
    (-1, 7, 20, 6, -1),        # the sign holds: all-ones 2c
    (3, 7, 20, 6, 0),
    (3, 4, 0, 8, 3 << 4),      # read past the LSB: empty slots read 0
])
def test_fiau_semantics(v, w_in, off, sl, want):
    assert FI.fiau_serial(v, w_in, off, sl) == JFI.fiau_serial(v, w_in, off, sl) == (want, sl)
    assert int(FI.barrel_align(v, off, w_in, sl)) == want


def test_fiau_cycle_model():
    off, sl = np.asarray([0, 3, 7]), np.asarray([4, 8, 12])
    np.testing.assert_array_equal(FI.fiau_cycles(off, sl).numpy(), JFI.fiau_cycles(off, sl))
    np.testing.assert_array_equal(FI.barrel_cycles(off, sl).numpy(),
                                  JFI.barrel_cycles(off, sl))
    np.testing.assert_array_equal(FI.barrel_cycles(off, sl).numpy(), [1, 1, 1])


def test_fiau_overflow_guard():
    with pytest.raises(AssertionError):
        FI.fiau_serial(64, 7, 0, 4)


# ---------------------------------------------------------------------------
# the MAC array (tests/test_mac_array.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [2, 4, 6, 8])
def test_slice_roundtrip_equals_jax(width):
    lim = 1 << (width - 1)
    w = np.random.default_rng(width).integers(-lim, lim, (64, 8)).astype(np.int32)
    slices, snf = MA.slice_weights(torch.from_numpy(w), width)
    jslices, jsnf = JMA.slice_weights(jnp.asarray(w), width)
    s = slices.numpy()
    np.testing.assert_array_equal(s, np.asarray(jslices))
    np.testing.assert_array_equal(snf.numpy(), np.asarray(jsnf))
    n = width // 2
    assert s.shape == (64, 8, n)
    assert (s[..., : n - 1] >= 0).all() and (s[..., : n - 1] <= 3).all()
    assert (s[..., n - 1] >= -2).all() and (s[..., n - 1] <= 1).all()
    np.testing.assert_array_equal(sum(s[..., j].astype(np.int64) * 4**j for j in range(n)), w)


def test_slice_weights_refuses_odd_widths():
    with pytest.raises(ValueError, match="2/4/6/8"):
        MA.slice_weights(torch.zeros(64, 1, dtype=torch.int32), 5)


def _both_matmul(x, w, width):
    got = MA.mac_array_matmul(torch.from_numpy(x), torch.from_numpy(w), width)
    assert got.dtype == torch.int32
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(JMA.mac_array_matmul(jnp.asarray(x),
                                                                       jnp.asarray(w), width)))
    np.testing.assert_array_equal(got, x.astype(np.int64) @ w)
    return got


@pytest.mark.parametrize("width", [2, 4, 6, 8])
@pytest.mark.parametrize("i_bits", [2, 4, 8, 12])
def test_matmul_exact_equals_jax(width, i_bits):
    rng = np.random.default_rng(width * 13 + i_bits)
    ilim, wlim = 1 << (i_bits - 1), 1 << (width - 1)
    x = rng.integers(-ilim, ilim, (5, 64)).astype(np.int32)
    w = rng.integers(-wlim, wlim, (64, 24)).astype(np.int32)
    _both_matmul(x, w, width)


def test_six_bit_three_column_path():
    """The 6b mode fuses exactly 3 columns; numerically the same ladder."""
    rng = np.random.default_rng(6)
    w = rng.integers(-32, 32, (64, 4)).astype(np.int32)
    slices, _ = MA.slice_weights(torch.from_numpy(w), 6)
    assert slices.shape[-1] == 3
    x = rng.integers(-8, 8, (3, 64)).astype(np.int32)
    cols = MA.column_mac(torch.from_numpy(x), slices[:, 0, :])
    jcols = JMA.column_mac(jnp.asarray(x), jnp.asarray(slices[:, 0, :].numpy()))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    fused = MA.fuse_columns(cols, 6).numpy()
    np.testing.assert_array_equal(fused, np.asarray(JMA.fuse_columns(jcols, 6)))
    np.testing.assert_array_equal(fused, x @ w[:, 0])


def test_effective_columns_and_macro_cycles():
    for width, cols in ((2, 96), (4, 48), (6, 32), (8, 24)):
        assert MA.effective_output_columns(width) == JMA.effective_output_columns(width) == cols
    c44, c88 = MA.macro_cycles(1, 64, 48, 4, 4), MA.macro_cycles(1, 64, 24, 8, 8)
    assert c88 == c44 * 2  # same work per pass: 2x cycles over half the columns
    assert MA.macro_cycles(2, 65, 48, 4, 4) == 2 * 2 * 1 * 4
    for shape in ((1, 64, 48, 4, 4), (3, 4096, 11008, 6, 8), (2, 65, 7, 2, 6)):
        assert MA.macro_cycles(*shape) == JMA.macro_cycles(*shape)


@pytest.mark.parametrize("width", [2, 4, 6, 8])
def test_random_12_bit_inputs_exact(width):
    """100 seeded cases per width of 12-bit inputs (the property test of
    tests/test_mac_array.py, as seeds)."""
    lim = 1 << (width - 1)
    for seed in range(100):
        rng = np.random.default_rng(seed * 4 + width)
        x = rng.integers(-2048, 2048, (2, 64)).astype(np.int32)
        w = rng.integers(-lim, lim, (64, 3)).astype(np.int32)
        np.testing.assert_array_equal(
            MA.mac_array_matmul(torch.from_numpy(x), torch.from_numpy(w), width).numpy(), x @ w)
    _both_matmul(x, w, width)


# ---------------------------------------------------------------------------
# the macro: MPU -> FIAU -> MAC array (tests/test_macro_composition.py)
# ---------------------------------------------------------------------------


def _fields(x, fmt):
    f = F.get_format(fmt)
    ts = F.per_tensor_scale(x, f)
    d = F.decompose(x * ts, f)
    g = lambda a: D.group_reshape(a, 64)  # noqa: E731
    sign, e, m = g(d["sign"]), g(d["e_unb"]), g(d["m_int"])
    shift, e_max, nz = D.group_shifts(e, m)
    return sign, m, shift, e_max, nz, ts, f


def _hardware_input_path(x, k, b_fix):
    """MPU (8b-LUT fixed point) predicts B; FIAU (trunc) aligns."""
    sign, m, shift, e_max, nz, ts, f = _fields(x, "e4m3")
    b_hw = MPU.mpu_predict(shift, nz, int(k * (1 << MPU.MPU_KF)), b_fix).clamp(1, 11)
    a, scale = D.align_group(sign, m, f.mbits, shift, e_max, b_hw, "trunc")
    return a, scale, b_hw, ts, (sign, m, shift, f)


def _mac_width(bits: int) -> int:
    """A weight group's B_w (1, 3, 5, 7) plus its sign: the array's 2/4/6/8b mode."""
    return {1: 2, 2: 2, 3: 4, 4: 4, 5: 6, 6: 6, 7: 8, 8: 8}[bits]


def test_fiau_alignment_equals_align_group_trunc():
    """Element by element: the serial FIAU read of every mantissa equals
    align_group('trunc') at the MPU's width, and JAX's pipeline gives the
    same widths and aligned mantissas."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(256) * np.exp2(rng.integers(-4, 4, 256))).astype(np.float32)
    a, _, b_hw, _, (sign, m, shift, f) = _hardware_input_path(torch.from_numpy(x), 1.0, 5)
    jf = JF.get_format("e4m3")
    jd = JF.decompose(jnp.asarray(x) * JF.per_tensor_scale(jnp.asarray(x), jf), jf)
    jg = [JD.group_reshape(jd[k], 64) for k in ("sign", "e_unb", "m_int")]
    jshift, je_max, jnz = JD.group_shifts(jg[1], jg[2])
    jb = jnp.clip(JMPU.mpu_predict(jshift, jnz, 16, 5), 1, 11)
    ja, _ = JD.align_group(jg[0], jg[1], jg[2], jf.mbits, jshift, je_max, jb, "trunc")
    np.testing.assert_array_equal(b_hw.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    w_in = f.mbits + 2  # mantissa + implicit bit + sign, 2's complement
    a, v = a.reshape(-1).tolist(), (sign * m).reshape(-1).tolist()
    sh, b = shift.reshape(-1).tolist(), b_hw.repeat_interleave(64).tolist()
    for i in range(256):
        out, cycles = FI.fiau_serial(v[i], w_in, sh[i], b[i] + 1)
        assert (out, cycles) == (a[i], b[i] + 1), (i, v[i], sh[i], b[i])


def test_full_macro_pipeline_equals_software_gemm():
    """(MPU + FIAU + MAC array) GEMM == the port's software DSBP GEMM with
    the MPU's widths, exactly: every (row, column, group) 64-deep dot
    through the 2b-sliced columns equals grouped_int_matmul's exact group
    dot, and the scale fold of those dots equals grouped_int_matmul bit for
    bit."""
    rng = np.random.default_rng(1)
    mdim, kdim, ndim = 8, 192, 12
    x = torch.from_numpy((rng.standard_normal((mdim, kdim))
                          * np.exp2(rng.integers(-3, 3, (mdim, kdim)))).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((kdim, ndim)) * 0.05).astype(np.float32))
    ax, sx, _, tsx, _ = _hardware_input_path(x, k=2.0, b_fix=4)
    wcfg = DSBPConfig(fmt="e2m5", side="weight", k=1.0, b_fix=5, scale_granularity="row")
    qw = D.dsbp_quantize(w.T, wcfg)  # offline weight path (Algorithm 1, rne)
    ng = ax.shape[1]
    part = torch.zeros(mdim, ndim, ng, dtype=torch.int32)
    for g in range(ng):
        for n in range(ndim):
            width = _mac_width(int(qw["bits"][n, g]) + 1)
            part[:, n, g] = MA.mac_array_matmul(ax[:, g], qw["a"][n, g][:, None], width)[:, 0]
    exact = torch.einsum("mgi,ngi->mng", ax.double(), qw["a"].double())
    np.testing.assert_array_equal(part.numpy(), exact.numpy().astype(np.int32))
    qx = {"a": ax, "scale": sx, "tscale": tsx}
    y_sw = grouped_int_matmul(qx, qw)
    y_hw = (part.to(torch.float32) * (sx[:, None, :] * qw["scale"][None])).sum(-1)
    y_hw = y_hw / (tsx * qw["tscale"].reshape(1, -1))
    assert torch.equal(y_hw, y_sw)


def test_software_path_tracks_hardware_predictor():
    """dsbp_matmul_ref (the float Eq. 1 predictor) vs the bit-exact LUT MPU
    feeding the same alignment: the widths agree on >= 90% of groups and
    differ by at most one level; JAX's MPU gives the same widths."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((16, 256))
                          * np.exp2(rng.integers(-3, 3, (16, 256)))).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((256, 8)) * 0.05).astype(np.float32))
    cfg = QuantizedMatmulConfig(
        input_cfg=DSBPConfig(fmt="e4m3", side="input", k=2.0, b_fix=4,
                             mantissa_rounding="trunc"),
        weight_cfg=DSBPConfig(fmt="e2m5", side="weight", k=1.0, b_fix=5,
                              scale_granularity="row"))
    y_sw = dsbp_matmul_ref(x, w, cfg)
    _, _, shift, _, nz, _, _ = _fields(x, "e4m3")
    b_float = D.round_to_valid_input(2.0 * D.predict_bdyn(shift, nz) + 4)
    b_hw = _both_predict(shift, nz, 2 << MPU.MPU_KF, 4)
    b_hw = np.clip(b_hw, 1, 11)
    assert (b_float.numpy() == b_hw).mean() >= 0.90
    assert np.abs(b_float.numpy() - b_hw).max() <= 1
    exact = x @ w
    assert float((y_sw - exact).abs().mean() / exact.abs().mean()) < 0.15


def test_rne_vs_trunc_ablation():
    """Truncation (the FIAU's serial read) against round-to-nearest-even on
    the input path: rne no worse on average, truncation < 60% extra error."""
    errs = {"rne": [], "trunc": []}
    for seed in range(4):
        r = np.random.default_rng(seed)
        x = torch.from_numpy((r.standard_normal((32, 256))
                              * np.exp2(r.integers(-3, 3, (32, 256)))).astype(np.float32))
        w = torch.from_numpy((r.standard_normal((256, 16)) * 0.05).astype(np.float32))
        exact = x @ w
        for mode in ("rne", "trunc"):
            cfg = QuantizedMatmulConfig(
                input_cfg=DSBPConfig(fmt="e4m3", side="input", k=1.0, b_fix=6,
                                     mantissa_rounding=mode),
                weight_cfg=DSBPConfig(fmt="e2m5", side="weight", k=1.0, b_fix=5,
                                      scale_granularity="row"))
            errs[mode].append(float((dsbp_matmul_ref(x, w, cfg) - exact).abs().mean()))
    rne, trunc = np.mean(errs["rne"]), np.mean(errs["trunc"])
    assert rne <= trunc * 1.02
    assert trunc <= rne * 1.6
