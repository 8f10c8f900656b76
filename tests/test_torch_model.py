"""The port's model against the JAX model with bridged weights, on the CPU:
ragged ``prefill(lengths=)`` and per-row ``decode_step(pos)`` logits for
smoke llama-7b-paper (GQA) and its MHA variant, float and packed
"precise" weights.

Tolerances, relative to max|logit|.  Float weights: the two frameworks
accumulate matmuls and normalisations in other orders; 1e-5 (measured
below 1e-6).  Packed weights: the port runs the fused kernel's plain
version, the JAX reference ``dsbp_ref``; both quantize the same
activations, but a last-bit difference upstream can move one activation
across an FP8 rounding boundary, so 1e-3 (measured below 1e-6, i.e. no
such crossing at these seeds)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.core.packed import PackedDSBPWeight as JaxPacked  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import pack_weights_int8 as jax_pack  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.serve.engine import pack_weights_int8  # noqa: E402

LENS = np.asarray([5, 11, 8], np.int32)
VARIANTS = {"gqa": {}, "mha": {"n_kv_heads": 4}}
# dense attn_full configs served by the same modules, at their own smoke size
COPIED_DENSE = ["deepseek-coder-33b", "phi3-medium-14b"]


def np_tree(tree, preset="precise"):
    """A JAX param tree as nested dicts/lists of numpy arrays; packed
    containers become dicts of their children and static fields."""
    if isinstance(tree, JaxPacked):
        return {"ka": np.asarray(tree.ka), "kscale": np.asarray(tree.kscale),
                "tscale": np.asarray(tree.tscale), "bits": np.asarray(tree.bits),
                "k": tree.k, "n": tree.n, "group_size": tree.group_size,
                "cfg": preset, "version": tree.version}
    if isinstance(tree, dict):
        return {k: np_tree(v, preset) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v, preset) for v in tree]
    return np.asarray(tree)


def make_pair(variant: str, packed: bool, seed: int = 0):
    """(JAX cfg, JAX params, port model) with the same weights: smoke
    llama-7b-paper in a ``VARIANTS`` form, or a config of ``COPIED_DENSE``
    by name."""
    arch = variant if variant in COPIED_DENSE else "llama-7b-paper"
    kw = dict(VARIANTS.get(variant, {}), quant="precise" if packed else None)
    jcfg = jax_smoke_config(arch).replace(
        remat=False, quant_method="dsbp_ref" if packed else None, **kw)
    params = JM.init(jax.random.PRNGKey(seed), jcfg)
    model = bridge.model_from_jax(
        np_tree(params), smoke_config(arch).replace(
            quant_method="dsbp_fused" if packed else None, **kw),
        device="cpu")
    if packed:
        params, _ = jax_pack(params, "precise")
        pack_weights_int8(model, "precise")
    return jcfg, params, model


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(LENS), int(LENS.max())), np.int64)
    for j, n in enumerate(LENS):
        toks[j, :n] = rng.integers(0, vocab, n)
    return toks


def _assert_close(j, t, rel):
    j, t = np.asarray(j), t.numpy()
    assert np.abs(j - t).max() <= rel * np.abs(j).max(), np.abs(j - t).max()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
def test_prefill_and_decode_match_jax(variant, packed):
    jcfg, params, model = make_pair(variant, packed)
    rel = 1e-3 if packed else 1e-5
    toks = _prompts(jcfg.vocab_size)
    jl, jcache, _ = JM.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                               max_len=24, lengths=jnp.asarray(LENS))
    with torch.inference_mode():
        tl, tcache, tlen = model.prefill(torch.from_numpy(toks), 24, lengths=LENS)
    assert np.array_equal(tlen.numpy(), LENS)
    _assert_close(jl, tl, rel)
    steps = np.random.default_rng(1).integers(0, jcfg.vocab_size, (len(LENS), 2))
    for t in range(2):
        jl, jcache = JM.decode_step(params, {"tokens": jnp.asarray(steps[:, t:t + 1])},
                                    jcache, jnp.asarray(LENS + t), jcfg)
        with torch.inference_mode():
            tl, tcache = model.decode_step(torch.from_numpy(steps[:, t:t + 1]),
                                           tcache, torch.from_numpy(LENS + t))
        _assert_close(jl, tl, rel)
    # the caches hold the same keys and values (same layout, (B, Hkv, S, D))
    _assert_close(jcache["units"][0]["k"][1], tcache[1]["k"], rel)


def test_bridge_carries_packed_containers():
    """A JAX-packed tree bridges into containers equal to the port's own
    pack of the same float weights."""
    jcfg, params, model = make_pair("gqa", packed=True)
    bridged = bridge.model_from_jax(np_tree(params), model.cfg, device="cpu")
    for (name, a), (_, b) in zip(bridged.named_modules(), model.named_modules()):
        if isinstance(a, PackedDSBPWeight):
            assert isinstance(b, PackedDSBPWeight), name
            for key in ("ka", "kscale", "tscale", "bits"):
                assert torch.equal(getattr(a, key), getattr(b, key)), (name, key)
            assert (a.k, a.n, a.group_size, a.cfg) == (b.k, b.n, b.group_size, b.cfg)
    toks = torch.from_numpy(_prompts(jcfg.vocab_size))
    with torch.inference_mode():
        assert torch.equal(bridged.forward(toks), model.forward(toks))
