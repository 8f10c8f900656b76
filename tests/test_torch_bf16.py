"""The bfloat16 models of the port against the JAX package's, on the CPU:
modules, the bridge, the attention kernels' plain versions and kv8, at
smoke size, the same numpy-seeded inputs through both.

* Every parameter, cache, pool and state leaf of a bf16 model has its JAX
  leaf's dtype (bf16, with the RG-LRU's ``lam`` / ``ba`` / ``bx``, the
  SSD's ``a_log`` / ``dt_bias`` / ``d_skip`` and the recurrent ``h``
  states f32, kv8 leaves int8 + f32), and the bridge carries bf16 arrays
  bit for bit.
* ``rms_norm``, ``rope`` and ``dense`` (float, packed weight-only and
  packed through the DSBP GEMM) equal JAX's eager bf16 functions bit for
  bit; ``quantize_kv`` of bf16 K/V gives JAX's mantissas and scales bit
  for bit and ``dequantize(bf16)`` its bf16 values.
* The attention plain versions (``blockwise_attention``,
  ``decode_attention``, ``verify_attention``, float and kv8 caches, a
  window) against JAX's jitted functions: within 2 bf16 ulps of max|out|
  (measured 1 or 0: both round q * d**-0.5 to bf16 and keep the scores in
  f32, and the outputs round once; the sums run in other orders).
* ``init(pack=)`` equals ``init`` followed by ``pack_weights_int8`` bit for
  bit in bf16, and packs the bf16-rounded weights.
* Forward logits (MoE capacity lifted, as the engine's prefill) of every
  family, within ``FWD_ULPS`` bf16 ulps of max|logit|.  The two packages
  do not round at the same places: jitted, XLA keeps some bf16 results in
  f32 (a residual sum feeding the next norm, see PERF.md), the port rounds
  each as the reference's source does; measured at most 5.5 ulps on float
  weights (gemma3-12b; three prompt seeds).  Packed weights quantize their
  inputs to FP8 (3 mantissa bits), and a one-ulp difference upstream moves
  an activation across an FP8 rounding boundary now and then, a change of
  2**-3 in that element: measured at most 36 ulps (recurrentgemma-2b),
  the 99.9th percentile 21.
* The refusals: a mesh over a bf16 model names ROADMAP A13, the policy
  loop on one names ROADMAP A12; no path casts a bf16 model to f32.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kvq import KVQuantConfig as JaxKVCfg  # noqa: E402
from repro.kvq import quantize_kv as jax_quantize_kv  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import pack_weights_int8 as jax_pack  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.kvq import KVQuantConfig, PackedKVBlock, quantize_kv  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.packing import pack_weights_int8  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from test_torch_model import np_tree  # noqa: E402

# one config of each family the port serves, at smoke size; the windowed
# and MoE configs at the windows their engine tests use
CASES = {
    "llama-gqa": ("llama-7b-paper", {}),
    "llama-mha": ("llama-7b-paper", {"n_kv_heads": 4}),
    "recurrentgemma-2b": ("recurrentgemma-2b", {"window": 16}),
    "gemma3-12b": ("gemma3-12b", {"window": 16}),
    "mixtral-8x7b": ("mixtral-8x7b", {"window": 8}),
    "mamba2-370m": ("mamba2-370m", {}),
    "musicgen-large": ("musicgen-large", {}),
    "llava-next-34b": ("llava-next-34b", {}),
}
LENS = np.asarray([12, 5, 9], np.int32)
FWD_ULPS = {False: 8, True: 48}  # packed -> bound, in bf16 ulps of max|logit|
BF16 = torch.bfloat16


def ulp(x) -> float:
    """One bf16 ulp at magnitude x (8 significand bits)."""
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


def to_np(a) -> np.ndarray:
    """A JAX array or a tensor as f32 numpy (bf16 values are exact in f32)."""
    if isinstance(a, torch.Tensor):
        return bridge.to_numpy(a)
    return np.asarray(a).astype(np.float32)


def bits(a) -> np.ndarray:
    """The 16-bit patterns of a bf16 JAX array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@functools.lru_cache(maxsize=None)
def bf16_pair(case: str, packed: bool = False):
    """(JAX cfg, JAX params, port model) of ``CASES[case]`` in bf16 with the
    same weights; packed "precise" on both sides (JAX through dsbp_ref,
    the port through dsbp_fused) when ``packed``."""
    arch, kw = CASES[case]
    kw = dict(kw, quant=None)
    jcfg = jax_smoke_config(arch).replace(remat=False, dtype="bfloat16", **kw)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    model = bridge.model_from_jax(np_tree(params), smoke_config(arch).replace(
        dtype="bfloat16", **kw), device="cpu")
    if packed:
        params, _ = jax_pack(params, "precise")
        pack_weights_int8(model, "precise")
        jcfg = jcfg.replace(quant="precise", quant_method="dsbp_ref")
        model.cfg = model.cfg.replace(quant="precise", quant_method="dsbp_fused")
    return jcfg, params, model


def inputs(cfg, lens=LENS, seed=3):
    """Right-padded prompts ((B, L), audio (B, L, K)) and a vlm config's
    standard-normal image embeddings (B, S_img, d), from a numpy seed."""
    rng = np.random.default_rng(seed)
    k = cfg.n_codebooks
    shape = (len(lens), int(max(lens))) + ((k,) if k else ())
    toks = np.zeros(shape, np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, cfg.vocab_size, (n,) + shape[2:])
    img = None
    if cfg.frontend == "vlm_patches":
        img = rng.standard_normal((len(lens), cfg.n_image_tokens, cfg.d_model)).astype(
            np.float32)
    return toks, img


def jbatch(toks, img):
    batch = {"tokens": jnp.asarray(toks)}
    if img is not None:
        batch["image_embeds"] = jnp.asarray(img)
    return batch


def _rand_bf16(shape, seed, scale=1.0):
    """A bf16 JAX array and the equal port tensor."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, bridge.to_tensor(np.asarray(j))


# ---------------------------------------------------------------------------
# dtypes and the bridge
# ---------------------------------------------------------------------------

def _jax_leaf_dtypes(tree) -> list:
    return sorted({str(a.dtype) for a in jax.tree.leaves(tree)})


def _cache_dtypes(cache) -> list:
    out = set()
    for entry in cache:
        for leaf in entry.values():
            ts = (leaf.qm, leaf.scale) if isinstance(leaf, PackedKVBlock) else (leaf,)
            out |= {str(t.dtype).replace("torch.", "") for t in ts}
    return sorted(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_leaf_has_the_jax_leafs_dtype(case):
    """Parameters (the bridge refuses a leaf of another dtype than its
    parameter), the port's own ``init`` (the dtypes of its constructor),
    dense caches float and kv8, and paged pools: per layer and leaf the
    dtype of the JAX leaf."""
    jcfg, params, model = bf16_pair(case)
    cfg = model.cfg
    own = TM.init(cfg, device="cpu")
    assert ({n: p.dtype for n, p in own.named_parameters()}
            == {n: p.dtype for n, p in model.named_parameters()})
    assert {p.dtype for p in model.parameters()} <= {BF16, torch.float32}
    assert model.embed.dtype == BF16
    for kv in (None, "kv8"):
        jc = JM.init_cache(jcfg, 2, 16, kv=kv)
        tc = model.init_cache(2, 16, kv=kv)
        bridged = bridge.cache_from_jax(
            jax.tree.map(np.asarray, jc, is_leaf=lambda x: hasattr(x, "qm")) if kv is None
            else _np_cache(jc), cfg, device="cpu")
        for b, t in zip(bridged, tc):
            assert b.keys() == t.keys()
            for name in t:
                assert _cache_dtypes([{name: b[name]}]) == _cache_dtypes([{name: t[name]}]), (
                    kv, name)
    if any(k in ("attn_full", "attn_local") for k in cfg.pattern):
        jp = JM.init_paged_cache(jcfg, 2, 5, 4)
        tp = model.init_paged_cache(5, 4, batch=2)
        assert _cache_dtypes(tp) == _jax_leaf_dtypes(jp)


def _np_cache(tree):
    """A JAX cache tree with packed leaves as dicts of their children."""
    if hasattr(tree, "qm"):
        return {"qm": np.asarray(tree.qm), "scale": np.asarray(tree.scale),
                "bits": tree.bits, "fmt": tree.fmt}
    if isinstance(tree, dict):
        return {k: _np_cache(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_cache(v) for v in tree]
    return np.asarray(tree)


def test_bridge_round_trip_is_bit_exact():
    """Every 16-bit pattern (zeros, subnormals, infinities, NaNs) goes
    through ``to_tensor`` unchanged, and ``to_numpy`` gives their exact f32
    values (NaN where NaN)."""
    pats = np.arange(-2**15, 2**15, dtype=np.int32).astype(np.int16)
    j = jnp.asarray(pats).view(jnp.bfloat16)
    t = bridge.to_tensor(np.asarray(j))
    assert t.dtype == BF16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), pats)
    np.testing.assert_array_equal(bridge.to_numpy(t), np.asarray(j).astype(np.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_equal_jax_bit_for_bit():
    jx, tx = _rand_bf16((3, 7, 64), 0, 3.0)
    js, ts = _rand_bf16((64,), 1)
    out = TL.rms_norm(ts, tx, 1e-6)
    assert out.dtype == BF16
    np.testing.assert_array_equal(bits(out), bits(JL.rms_norm({"scale": js}, jx, 1e-6)))
    jq, tq = _rand_bf16((2, 4, 9, 32), 2)
    pos = np.asarray([[3, 4, 5, 6, 7, 8, 9, 10, 11], [0, 1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    out = TL.rope(tq, torch.from_numpy(pos))
    assert out.dtype == BF16
    np.testing.assert_array_equal(bits(out), bits(JL.rope(jq, jnp.asarray(pos))))


@pytest.mark.parametrize("how", ["float", "weight-only", "dsbp"])
def test_dense_equals_jax_bit_for_bit(how):
    """x bf16 @ w: the float product (bf16 operands, one rounding), a packed
    container weight-only (dequantized to bf16), and the DSBP GEMM (the
    port's fused kernel's plain version against JAX's dsbp_ref: x widens
    to f32, the f32 product rounds once to bf16)."""
    jx, tx = _rand_bf16((2, 5, 96), 3)
    jw, tw = _rand_bf16((96, 80), 4, 96 ** -0.5)
    jq = tq = None
    if how != "float":
        from repro.core.quantized import pack_weights as jax_pack_w
        from repro_torch.core.quantized import pack_weights
        jw, tw = jax_pack_w(jw, "precise"), pack_weights(tw, "precise")
        assert isinstance(tw, PackedDSBPWeight)
        np.testing.assert_array_equal(tw.ka.numpy(), np.asarray(jw.ka))
    if how == "dsbp":
        jq, tq = JL.Quant("precise", "dsbp_ref"), TL.Quant("precise", "dsbp_fused")
    out = TL.dense(tw, tx, tq)
    assert out.dtype == BF16
    np.testing.assert_array_equal(bits(out), bits(JL.dense(jw, jx, jq)))


# ---------------------------------------------------------------------------
# attention plain versions
# ---------------------------------------------------------------------------

ATTN_ULPS = 2


def _close_ulps(j, t, n=ATTN_ULPS):
    assert t.dtype == BF16
    j, t = to_np(j), to_np(t)
    assert j.shape == t.shape
    err = np.abs(j - t).max()
    assert err <= n * ulp(np.abs(j).max()), (err, np.abs(j).max())


@pytest.mark.parametrize("window", [0, 6])
def test_blockwise_attention_matches_jax(window):
    jq, tq = _rand_bf16((3, 8, 20, 32), 5, 2.0)
    jk, tk = _rand_bf16((3, 2, 20, 32), 6, 2.0)
    jv, tv = _rand_bf16((3, 2, 20, 32), 7)
    lens = np.asarray([20, 7, 13], np.int32)
    j = JA.blockwise_attention(jq, jk, jv, causal=True, window=window,
                               kv_lens=jnp.asarray(lens))
    t = TA.blockwise_attention(tq, tk, tv, causal=True, window=window,
                               kv_lens=torch.from_numpy(lens))
    _close_ulps(j, t)


@pytest.mark.parametrize("kv", [None, "kv8"])
def test_decode_and_verify_attention_match_jax(kv):
    """Per-row positions over a float or kv8 cache (the K/V quantized once
    by each package, bit-equal), and a 3-token verify over the same cache
    plus fresh K/V, with and without a window."""
    jq, tq = _rand_bf16((3, 8, 1, 32), 8, 2.0)
    jk, tk = _rand_bf16((3, 2, 24, 32), 9, 2.0)
    jv, tv = _rand_bf16((3, 2, 24, 32), 10)
    pos = np.asarray([24, 9, 17], np.int32)
    if kv:
        cfg = KVQuantConfig(bits=8)
        jk, jv = (jax_quantize_kv(a, JaxKVCfg(bits=8)) for a in (jk, jv))
        tk, tv = (quantize_kv(a, cfg) for a in (tk, tv))
    _close_ulps(JA.decode_attention(jq, jk, jv, jnp.asarray(pos)),
                TA.decode_attention(tq, tk, tv, torch.from_numpy(pos)))
    jq3, tq3 = _rand_bf16((3, 8, 3, 32), 11, 2.0)
    jn, tn = _rand_bf16((3, 2, 3, 32), 12, 2.0)
    jm, tm = _rand_bf16((3, 2, 3, 32), 13)
    if kv:
        jn, jm = (jax_quantize_kv(a, JaxKVCfg(bits=8)) for a in (jn, jm))
        tn, tm = (quantize_kv(a, cfg) for a in (tn, tm))
    vpos = pos - 3
    for window in (0, 8):
        _close_ulps(JA.verify_attention(jq3, jn, jm, jk, jv, jnp.asarray(vpos), window=window),
                    TA.verify_attention(tq3, tn, tm, tk, tv, torch.from_numpy(vpos),
                                        window=window))


# ---------------------------------------------------------------------------
# kv8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits_", [8, 4])
def test_quantize_kv_of_bf16_equals_jax_bit_for_bit(bits_):
    jx, tx = _rand_bf16((2, 3, 11, 32), 14, 3.0)
    j = jax_quantize_kv(jx, JaxKVCfg(bits=bits_))
    t = quantize_kv(tx, KVQuantConfig(bits=bits_))
    np.testing.assert_array_equal(t.qm.numpy(), np.asarray(j.qm))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    deq = t.dequantize(BF16)
    assert deq.dtype == BF16
    np.testing.assert_array_equal(bits(deq), bits(j.dequantize(jnp.bfloat16)))


# ---------------------------------------------------------------------------
# init and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama-7b-paper", "recurrentgemma-2b", "mixtral-8x7b",
                                  "mamba2-370m"])
def test_init_pack_equals_init_then_pack_in_bf16(arch):
    """``init(pack=)`` draws each parameter in f32, rounds it to bf16 and
    packs the rounded layer: the same model as ``init`` then
    ``pack_weights_int8``, every leaf bit for bit; a container packs the
    f32 upcast of the bf16 weight (JAX ``core/quantized.py:131``)."""
    cfg = smoke_config(arch).replace(dtype="bfloat16")
    a = TM.init(cfg, seed=3, device="cpu", pack="precise")
    b = TM.init(cfg, seed=3, device="cpu")
    raw = dict(b.named_parameters())
    pack_weights_int8(b, "precise")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys() and pa
    for n in pa:
        assert pa[n].dtype == pb[n].dtype, n
        np.testing.assert_array_equal(pa[n].view(torch.int16 if pa[n].dtype == BF16
                                                 else pa[n].dtype).numpy(),
                                      pb[n].view(torch.int16 if pb[n].dtype == BF16
                                                 else pb[n].dtype).numpy(), err_msg=n)
    ma = {n: m for n, m in a.named_modules() if isinstance(m, PackedDSBPWeight)}
    mb = {n: m for n, m in b.named_modules() if isinstance(m, PackedDSBPWeight)}
    assert ma.keys() == mb.keys() and ma
    for n in ma:
        for f in ("ka", "kscale", "tscale", "bits"):
            assert torch.equal(getattr(ma[n], f), getattr(mb[n], f)), (n, f)
    # the draws are the f32 model's, rounded: layer 0's first projection
    f32 = TM.init(smoke_config(arch), seed=3, device="cpu")
    name = next(n for n, p in raw.items() if n.startswith("layers.0.") and p.ndim >= 2)
    assert torch.equal(raw[name], dict(f32.named_parameters())[name].to(BF16))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

FWD = [(c, False) for c in sorted(CASES)] + [("llama-gqa", True), ("llama-mha", True),
                                            ("recurrentgemma-2b", True),
                                            ("mixtral-8x7b", True)]


@pytest.mark.parametrize("case,packed", FWD,
                         ids=[f"{c}-{'packed' if p else 'float'}" for c, p in FWD])
def test_forward_logits_match_jax(case, packed):
    jcfg, params, model = bf16_pair(case, packed)
    toks, img = inputs(jcfg)
    j = jax.jit(JM.forward, static_argnums=(2, 3, 4))(params, jbatch(toks, img), jcfg,
                                                      False, True)
    with torch.inference_mode():
        t = model.forward(torch.from_numpy(toks), no_drop=True, image_embeds=img)
    assert t.dtype == BF16 and j.dtype == jnp.bfloat16
    j, t = to_np(j), to_np(t)
    assert j.shape == t.shape
    err = np.abs(j - t).max()
    assert err <= FWD_ULPS[packed] * ulp(np.abs(j).max()), (err, np.abs(j).max())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_mesh_over_a_bf16_model_names_a13():
    model = TM.init(smoke_config("llama-7b-paper").replace(dtype="bfloat16"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13") as ei:
        Engine(model, ServeConfig(max_len=32, mesh_shape=(1, 2)), device="cpu")
    assert "bfloat16 dtype" in str(ei.value)


@pytest.mark.parametrize("entry", ["calibrate", "autotune"])
def test_policy_loop_on_a_bf16_model_names_a12(entry):
    from repro_torch.policy import autotune, calibrate
    cfg = smoke_config("llama-7b-paper").replace(dtype="bfloat16")
    model = TM.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A12") as ei:
        if entry == "calibrate":
            calibrate(model, cfg, [np.zeros((1, 8), np.int64)])
        else:
            autotune(model, cfg, None, [])
    assert "bfloat16" in str(ei.value)
