"""The kernels' plain PyTorch versions against the JAX package's Pallas
kernels (interpret mode) and jnp attention, on the CPU.

B1 (fused DSBP GEMM): aligned mantissas, scales and bits of the shared
input-path tile are bit-equal; the GEMM output is within the f32
reassociation bound (the Pallas kernel sums all K in one dot, the port in
group order).  B2 (attention): within 1e-5, the online-softmax order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quantized as JQ  # noqa: E402
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.kernels import fp8_quant_align as JA  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.models import attention as JAT  # noqa: E402
from repro_torch.core import quantized as TQ  # noqa: E402
from repro_torch.kernels import dsbp_fused as DF  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.models import attention as TAT  # noqa: E402


def _data(shape, seed=0, spread=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-spread, spread, shape))).astype(np.float32)


def _cfgs(preset="precise", **kw):
    out = []
    for Q in (JQ, TQ):
        c = Q.PRESETS[preset]
        out.append(dataclasses.replace(c, input_cfg=dataclasses.replace(c.input_cfg, **kw)))
    return out


SWEEP = [  # the tests/test_fused.py sweep: presets x formats, modes, trunc,
    ("precise", {"fmt": "e4m3"}, 16, 256),   # K % 64 != 0, ragged M
    ("precise", {"fmt": "e5m2"}, 16, 256),
    ("efficient", {"fmt": "e4m3"}, 16, 256),
    ("efficient", {"fmt": "e5m2"}, 16, 256),
    ("precise", {"mode": "fixed", "b_fix": 7, "k": 0.0}, 8, 192),
    ("precise", {"mode": "fixed", "b_fix": 3, "k": 0.0}, 8, 192),
    ("precise", {"mode": "dsbp", "b_fix": 4, "k": 2.0}, 8, 192),
    ("efficient", {"mantissa_rounding": "trunc"}, 8, 256),
    ("precise", {}, 4, 100),
    ("precise", {}, 4, 250),
    ("efficient", {}, 1, 128),
    ("efficient", {}, 3, 128),
    ("efficient", {}, 5, 128),
]


@pytest.mark.parametrize("preset,kw,m,k", SWEEP)
def test_quant_align_tile_bit_equal(preset, kw, m, k):
    jcfg, tcfg = _cfgs(preset, **kw)
    kp = -(-k // 64) * 64
    x = np.pad(_data((m, k), seed=m + k, spread=8), ((0, 0), (0, kp - k))) * 8
    ja, js, jb = jax.jit(JA.quant_align_tile, static_argnums=1)(
        jnp.asarray(x), jcfg.input_cfg)
    ta, ts, tb = DF.quant_align_tile(torch.from_numpy(x), tcfg.input_cfg)
    np.testing.assert_array_equal(np.asarray(ja).astype(np.int32), ta.numpy())
    np.testing.assert_array_equal(np.asarray(js).view(np.int32), ts.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("preset,kw,m,k", SWEEP)
def test_dsbp_fused_plain_matches_pallas(preset, kw, m, k):
    jcfg, tcfg = _cfgs(preset, **kw)
    x = _data((m, k), seed=m)
    w = _data((k, 96), seed=k, spread=2)
    jy = np.asarray(JO.dsbp_matmul_fused(jnp.asarray(x), JQ.pack_weights(jnp.asarray(w), jcfg),
                                         interpret=True))
    pw = TQ.pack_weights(torch.from_numpy(w), tcfg)
    ty = TO.dsbp_matmul_fused(torch.from_numpy(x), pw).numpy()
    # bound: the exact group partials summed in another order,
    # |Δ| <= 2^-20 · Σ_g |dot_g| · (s_g/ts) · (kscale_g/tw)
    xm = torch.nn.functional.pad(torch.from_numpy(x), (0, pw.padded_k - k))
    ts = TO.per_tensor_scale(xm, tcfg.input_cfg.fmt)
    a, s, _ = DF.quant_align_tile(xm * ts, tcfg.input_cfg)
    ng = pw.padded_k // 64
    absdots = torch.einsum("mgi,gin->mgn", a.abs().reshape(m, ng, 64).double(),
                           pw.ka.abs().reshape(ng, 64, -1).double())
    mag = (absdots * (s / ts)[:, :, None] * (pw.kscale / pw.tscale.reshape(1, -1))).sum(1)
    diff = np.abs(jy - ty)
    not_equal = int((jy != ty).sum())
    print(f"{preset} {kw} M={m} K={k}: {not_equal}/{jy.size} elements not bit-equal, "
          f"max |diff| {diff.max():.3g}")
    assert np.all(diff <= 2.0 ** -20 * mag.numpy() + 1e-30)


def test_dsbp_fused_plain_batched_shapes():
    """(B, S, K) activations reshape through ops.dsbp_matmul_fused."""
    _, tcfg = _cfgs()
    x = _data((2, 3, 128), seed=7)
    w = _data((128, 64), seed=8, spread=2)
    pw = TQ.pack_weights(torch.from_numpy(w), tcfg)
    y = TO.dsbp_matmul_fused(torch.from_numpy(x), pw)
    flat = TO.dsbp_matmul_fused(torch.from_numpy(x.reshape(6, 128)), pw)
    assert y.shape == (2, 3, 64)
    assert torch.equal(y.reshape(6, 64), flat)
    with pytest.raises(ValueError):
        TO.dsbp_matmul_fused(torch.from_numpy(x[..., :100]), pw)


# ---------------- B2 ----------------

def _qkv(b, hq, hkv, sq, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, s, d), (b, hkv, s, d))]


def _close(j, t):
    # online-softmax order: per-block rescaling rounds differently
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,sq", [(True, None, 64), (True, 16, 64),
                                              (False, None, 32), (True, None, 32)])
def test_attention_plain_matches_pallas_flash(causal, window, sq):
    """Single head, queries at the last Sq positions."""
    q, k, v = _qkv(1, 1, 1, sq, 64, 32, seed=sq)
    jo = JFA.flash_attention_kernel_call(jnp.asarray(q[0, 0]), jnp.asarray(k[0, 0]),
                                         jnp.asarray(v[0, 0]), causal=causal,
                                         window=window, bq=16, bkv=16, interpret=True)
    to = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.tensor([64]), torch.tensor([64 - sq]),
                            causal=causal, window=window or 0)
    _close(jo, to[0, 0])


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_attention_plain_matches_blockwise(hq, hkv, q_offset):
    """GQA and MHA, ragged kv lengths, chunked-prefill query offset."""
    q, k, v = _qkv(3, hq, hkv, 24, 24 + q_offset, 32, seed=hq + q_offset)
    lens = np.asarray([24 + q_offset, 13 + q_offset, 7 + q_offset], np.int32)
    jo = JAT.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)), bq=8, bkv=8,
                                 q_offset=q_offset, kv_lens=jnp.asarray(lens))
    to = TAT.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 q_offset=q_offset, kv_lens=torch.from_numpy(lens))
    _close(jo, to)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
def test_attention_plain_matches_decode(hq, hkv):
    """Per-row positions: row b sees keys < pos[b]."""
    q, k, v = _qkv(3, hq, hkv, 1, 40, 32, seed=hq)
    pos = np.asarray([40, 9, 23], np.int32)
    jo = JAT.decode_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos))
    to = TAT.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(pos))
    _close(jo, to)


@pytest.mark.parametrize("d", [40, 256])  # not a multiple of 16; gemma3-12b's d_head
@pytest.mark.parametrize("causal,window,sq", [(True, None, 16), (True, 8, 16), (False, None, 1)])
def test_attention_plain_matches_pallas_flash_head_dims(d, causal, window, sq):
    """The head dims the card's kernels now take beyond 128 / multiples of
    16, against the Pallas kernel at the same tolerance as d_head 32."""
    q, k, v = _qkv(1, 1, 1, sq, 32, d, seed=d + sq)
    jo = JFA.flash_attention_kernel_call(jnp.asarray(q[0, 0]), jnp.asarray(k[0, 0]),
                                         jnp.asarray(v[0, 0]), causal=causal,
                                         window=window, bq=sq, bkv=16, interpret=True)
    to = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.tensor([32]), torch.tensor([32 - sq]),
                            causal=causal, window=window or 0)
    _close(jo, to[0, 0])


@pytest.mark.parametrize("d", [40, 256])
@pytest.mark.parametrize("hq,hkv", [(16, 8), (10, 1)])  # gemma3-12b's GQA, recurrentgemma-2b's MQA
def test_attention_plain_matches_blockwise_head_dims(d, hq, hkv):
    """GQA / MQA at d_head 40 and 256, ragged kv lengths, a query offset."""
    q, k, v = _qkv(2, hq, hkv, 8, 13, d, seed=d + hq)
    lens = np.asarray([13, 9], np.int32)
    jo = JAT.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)), bq=4, bkv=4,
                                 q_offset=5, kv_lens=jnp.asarray(lens))
    to = TAT.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 q_offset=5, kv_lens=torch.from_numpy(lens))
    _close(jo, to)
