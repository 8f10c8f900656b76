"""The port's DSBP-quantized KV cache against the JAX package, on the CPU.

``quantize_kv`` is bit-equal to JAX (mantissas and scales) for kv8/kv6/kv4
at cache and pool shapes, zero rows included; the ``quantize_like`` write
contract, the spec errors and the byte accounting match.  B5's plain
version is within 1e-5 of JAX ``ops.packed_flash_attention`` (interpret
mode; the online-softmax order differs) and equal bit for bit to B2's
plain version over ``dequantize()`` (both folds are pow2 products).  The
dispatch counter ``count_kv_dequants`` sees the dequantize-oracle path and
nothing on the packed path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kvq as JK  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import kvq as TK  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


def _kv(shape, seed, zero_rows=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * np.exp2(rng.integers(-6, 4, shape[:-1] + (1,)))).astype(np.float32)
    if zero_rows:  # whole (token, head) vectors of zeros, as unwritten slots
        x.reshape(-1, shape[-1])[::7] = 0.0
    return x


SHAPES = [(2, 2, 16, 32),      # dense cache (B, Hkv, S, D)
          (5, 2, 4, 32),       # pool blocks (NB, Hkv, bs, D)
          (2, 3, 2, 1, 128)]   # stacked units (R, B, Hkv, 1, D): one decode token


@pytest.mark.parametrize("preset", sorted(TK.KV_PRESETS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quantize_kv_bit_equal_jax(preset, shape):
    x = _kv(shape, seed=len(shape) * 10 + shape[-2])
    j = JK.quantize_kv(jnp.asarray(x), JK.KV_PRESETS[preset])
    t = TK.quantize_kv(torch.from_numpy(x), TK.KV_PRESETS[preset])
    assert (t.bits, t.fmt) == (j.bits, j.fmt)
    assert t.qm.dtype == torch.int8 and t.scale.shape == (*shape[:-1], 1)
    np.testing.assert_array_equal(np.asarray(j.qm), t.qm.numpy())
    np.testing.assert_array_equal(np.asarray(j.scale).view(np.int32),
                                  t.scale.numpy().view(np.int32))
    # error bound of the aligned grid: one step of each row's scale
    err = np.abs(t.dequantize().numpy() - x)
    assert np.all(err <= t.scale.numpy())


def test_quantize_like_contract():
    x = torch.from_numpy(_kv((2, 2, 8, 32), seed=1))
    float_leaf = torch.zeros(2, 2, 8, 32)
    assert torch.equal(TK.quantize_like(float_leaf, x), x)
    leaf = TK.init_packed_kv((2, 2, 8, 32), TK.KV_PRESETS["kv8"], "cpu")
    assert leaf.qm.dtype == torch.int8 and not leaf.scale.any()
    q = TK.quantize_like(leaf, x)
    ref = TK.quantize_kv(x, TK.KV_PRESETS["kv8"])
    assert torch.equal(q.qm, ref.qm) and torch.equal(q.scale, ref.scale)
    assert TK.quantize_like(leaf, q) is q  # packed fresh passes through
    with pytest.raises(ValueError, match="spec mismatch"):
        TK.quantize_like(leaf, TK.quantize_kv(x, TK.KV_PRESETS["kv6"]))
    with pytest.raises(TypeError, match="float cache leaf"):
        TK.quantize_like(float_leaf, q)


@pytest.mark.parametrize("spec", ["kv5", 9, 1, 1.5, [8]])
def test_resolve_kv_spec_errors_match_jax(spec):
    with pytest.raises((ValueError, TypeError)) as jerr:
        JK.resolve_kv_spec(spec)
    with pytest.raises(jerr.type) as terr:
        TK.resolve_kv_spec(spec)
    assert str(terr.value) == str(jerr.value)


def test_resolve_kv_spec_domain_and_policy_mapping():
    for spec in (None, True, False, "kv8", "kv6", "kv4", 2, 8):
        j, t = JK.resolve_kv_spec(spec), TK.resolve_kv_spec(spec)
        assert (j is None) == (t is None)
        if j is not None:
            assert (t.bits, t.fmt) == (j.bits, j.fmt)
    kv = {"units.0": "kv4", "default": 6}
    for name in ("units.0", "units.1", "tail.0"):
        j, t = JK.kv_policy_cfg(kv, name), TK.kv_policy_cfg(kv, name)
        assert (t.bits, t.fmt) == (j.bits, j.fmt)
    assert TK.kv_policy_cfg(None, "units.0") is None


@pytest.mark.parametrize("kv", [None, "kv8", "kv4"])
def test_kv_cache_nbytes_matches_jax(kv):
    jcfg = jax_smoke_config("llama-7b-paper")
    model = TM.Model(smoke_config("llama-7b-paper"), "cpu")
    jcache = JM.init_cache(jcfg, 3, 24, kv=kv)
    tcache = model.init_cache(3, 24, kv=kv)
    assert TK.kv_cache_nbytes(tcache) == JK.kv_cache_nbytes(jcache)
    assert TK.tree_has_packed_kv(tcache) == JK.tree_has_packed_kv(jcache) == (kv is not None)


def _attn_inputs(b, hq, hkv, sq, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = TK.quantize_kv(torch.from_numpy(_kv((b, hkv, s, d), seed + 1, False)),
                       TK.KV_PRESETS["kv8"])
    v = TK.quantize_kv(torch.from_numpy(_kv((b, hkv, s, d), seed + 2, False)),
                       TK.KV_PRESETS["kv8"])
    return q, k, v


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (2, 2)])
def test_packed_attention_plain_matches_jax_kernel(hq, hkv, window):
    b, sq, s, d = 2, 8, 16, 32
    q, k, v = _attn_inputs(b, hq, hkv, sq, s, d, seed=hq + window)
    jk = JK.PackedKVBlock(jnp.asarray(k.qm.numpy()), jnp.asarray(k.scale.numpy()),
                          bits=8, fmt="e5m7")
    jv = JK.PackedKVBlock(jnp.asarray(v.qm.numpy()), jnp.asarray(v.scale.numpy()),
                          bits=8, fmt="e5m7")
    jo = np.asarray(JO.packed_flash_attention(jnp.asarray(q), jk, jv, causal=True,
                                              window=window or None, interpret=True))
    # the JAX kernel's queries sit at the last Sq of S keys, all valid
    kv_len = torch.full((b,), s, dtype=torch.int32)
    q0 = torch.full((b,), s - sq, dtype=torch.int32)
    to = FA.packed_flash_attention(torch.from_numpy(q), k.qm, k.scale, v.qm, v.scale,
                                   kv_len, q0, causal=True, window=window)
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,causal", [(1, True), (9, True), (9, False)])
def test_packed_attention_plain_bit_equal_b2_over_dequantize(sq, causal):
    b, hq, hkv, s, d = 3, 4, 2, 20, 32
    q, k, v = _attn_inputs(b, hq, hkv, sq, s, d, seed=sq)
    q = torch.from_numpy(q)
    kv_len = torch.tensor([20, 13, 9], dtype=torch.int32)
    q0 = kv_len - sq if causal else torch.zeros(b, dtype=torch.int32)
    packed = FA.packed_flash_attention(q, k.qm, k.scale, v.qm, v.scale, kv_len, q0,
                                       causal=causal)
    oracle = FA.flash_attention(q, k.dequantize(), v.dequantize(), kv_len, q0,
                                causal=causal)
    assert torch.equal(packed, oracle), float((packed - oracle).abs().max())


def test_count_kv_dequants_packed_zero_oracle_positive():
    """The counter counts: the dequantize-oracle path widens the whole
    cache outside any kernel (>= 1); the packed path widens it only inside
    B5 (its plain version stands in for the kernel here): 0."""
    b, hq, hkv, s, d = 2, 4, 2, 16, 32
    q, k, v = _attn_inputs(b, hq, hkv, 1, s, d, seed=3)
    q = torch.from_numpy(q)
    pos = torch.tensor([16, 5], dtype=torch.int32)
    size = k.qm.numel()

    def packed():
        return FA.packed_flash_attention(q, k.qm, k.scale, v.qm, v.scale, pos, pos - 1)

    def oracle():
        return FA.flash_attention(q, k.dequantize(), v.dequantize(), pos, pos - 1)

    assert TO.count_kv_dequants(packed, min_size=size) == 0
    assert TO.count_kv_dequants(oracle, min_size=size) >= 1
