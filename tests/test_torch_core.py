"""The port's core numerics against the JAX package, on the CPU: FP8 codecs,
DSBP quantization and the packed weight container are bit-equal; the
packed integer GEMM agrees within f32 reassociation."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dsbp as JD  # noqa: E402
from repro.core import formats as JF  # noqa: E402
from repro.core import quantized as JQ  # noqa: E402
from repro_torch.core import dsbp as TD  # noqa: E402
from repro_torch.core import formats as TF  # noqa: E402
from repro_torch.core import quantized as TQ  # noqa: E402


def _data(shape, seed=0, spread=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-spread, spread, shape))).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(j, t):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j)
    assert j.shape == t.shape, (j.shape, t.shape)
    np.testing.assert_array_equal(_bits(j), _bits(t))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e2m5"])
def test_codecs_bit_equal(fmt):
    x = _data((16, 200), seed=1, spread=12)
    x[0, :5] = [0.0, -0.0, 1e-40, -1e6, 3.0e4]  # zeros, f32 subnormal, saturation
    _equal(JF.quantize(jnp.asarray(x), fmt), TF.quantize(torch.from_numpy(x), fmt))
    jd = JF.decompose(jnp.asarray(x), fmt)
    td = TF.decompose(torch.from_numpy(x), fmt)
    for key in ("sign", "e_unb", "m_int", "value"):
        _equal(jd[key], td[key])
    _equal(JF.per_tensor_scale(jnp.asarray(x), fmt),
           TF.per_tensor_scale(torch.from_numpy(x), fmt))
    assert float(TF.exp2i(torch.tensor(-126))) == 2.0 ** -126


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e2m5"])
@pytest.mark.parametrize("mode", ["dsbp", "fixed"])
@pytest.mark.parametrize("rounding", ["rne", "trunc"])
def test_dsbp_quantize_bit_equal(fmt, mode, rounding):
    cfg = dict(fmt=fmt, mode=mode, mantissa_rounding=rounding, k=1.0, b_fix=6)
    x = _data((12, 250), seed=2, spread=6)  # K % 64 != 0: padded last group
    jq = JD.dsbp_quantize(jnp.asarray(x), JD.DSBPConfig(**cfg))
    tq = TD.dsbp_quantize(torch.from_numpy(x), TD.DSBPConfig(**cfg))
    for key in ("a", "scale", "bits", "tscale", "value"):
        _equal(jq[key], tq[key])


def test_dsbp_quantize_weight_side_bit_equal():
    """Weight path: Algorithm-1 predictor override, per-row scales, valid
    widths {1,3,5,7}."""
    cfg = dict(fmt="e2m5", side="weight", k=2.0, b_fix=3, scale_granularity="row")
    assert TD.DSBPConfig(**cfg).predictor == "algorithm1"
    w = _data((40, 192), seed=3, spread=3)
    jq = JD.dsbp_quantize(jnp.asarray(w), JD.DSBPConfig(**cfg))
    tq = TD.dsbp_quantize(torch.from_numpy(w), TD.DSBPConfig(**cfg))
    for key in ("a", "scale", "bits", "tscale"):
        _equal(jq[key], tq[key])


@pytest.mark.parametrize("preset", sorted(TQ.PRESETS))
@pytest.mark.parametrize("shape", [(256, 96), (100, 48), (3, 128, 64)])
def test_pack_weights_bit_equal(preset, shape):
    w = _data(shape, seed=4, spread=2)
    jp = JQ.pack_weights(jnp.asarray(w), preset)
    tp = TQ.pack_weights(torch.from_numpy(w), preset)
    for key in ("ka", "kscale", "tscale", "bits"):
        _equal(getattr(jp, key), getattr(tp, key))
    assert (tp.k, tp.n, tp.group_size, tp.padded_k) == (jp.k, jp.n, jp.group_size,
                                                        jp.padded_k)
    _equal(jp.dequantize(), tp.dequantize())


@pytest.mark.parametrize("preset", ["precise", "efficient", "e5m3_fixed"])
@pytest.mark.parametrize("k", [256, 100])
def test_packed_matmul_within_reassociation_bound(preset, k):
    """Same exact partials; the f32 sums over groups may associate
    differently: |Δ| <= 2^-20 · Σ_g |partial_g · scale_g| / (tx · tw)."""
    x = _data((8, k), seed=5)
    w = _data((k, 64), seed=6, spread=2)
    jy = np.asarray(JQ.dsbp_matmul_ref(jnp.asarray(x), jnp.asarray(w), JQ.PRESETS[preset]))
    tp = TQ.pack_weights(torch.from_numpy(w), preset)
    ty = TQ.packed_matmul(torch.from_numpy(x), tp).numpy()
    qx = TQ.quantize_inputs(torch.from_numpy(x), TQ.PRESETS[preset].input_cfg)
    qw = TQ.quantize_weights(torch.from_numpy(w), TQ.PRESETS[preset].weight_cfg)
    mag = TQ.grouped_int_matmul(
        {**qx, "a": qx["a"].abs()}, {**qw, "a": qw["a"].abs()}).abs().numpy()
    assert np.all(np.abs(jy - ty) <= 2.0 ** -20 * mag)
