"""The port's checkpoint store against the JAX package's, on the CPU: a
tree saved by either package restores in the other with every array equal
(f32, int8, uint8 and bfloat16 leaves, nested lists and tuples, a packed
container), the same files and manifest bytes, atomic publishing and
``latest_step``, the refusals, the layout-v1 upgrade, ``reshard_leaf``,
the DSBP policy's checkpoint across the packages, and a model read from a
JAX param checkpoint (``bridge.model_from_checkpoint``) equal to the same
weights bridged in memory.  Every comparison is exact: a store moves
bytes."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import store as JS  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.core import quantized as JQ  # noqa: E402
from repro.core.packed import PackedDSBPWeight as JaxPacked  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.policy import DSBPPolicy as JaxPolicy  # noqa: E402
from repro.serve.engine import pack_weights_int8 as jax_pack  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import store as TS  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight  # noqa: E402
from repro_torch.policy import DSBPPolicy  # noqa: E402

from test_torch_model import np_tree  # noqa: E402


def _arrays(seed: int = 0) -> dict:
    """Numpy leaves of every dtype the stores carry, nested as a trainer's
    ``(params, opt_state)`` and a packed tree are."""
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((3, 5)).astype(np.float32).astype(ml_dtypes.bfloat16)
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "q": rng.integers(-128, 128, (7,), dtype=np.int8),
            "blob": rng.integers(0, 256, (300,), dtype=np.uint8),
            "h": bf,
            "nest": [rng.standard_normal((2,)).astype(np.float32),
                     (np.asarray(3, np.int32), rng.standard_normal((1, 2)).astype(np.float32))]}


def _jax_tree(a: dict):
    return jax.tree.map(jnp.asarray, a)


def _torch_tree(a):
    if isinstance(a, dict):
        return {k: _torch_tree(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_torch_tree(v) for v in a)
    return bridge.to_tensor(a)


def _bits(x) -> np.ndarray:
    """An array's bytes as integers (bf16 as its 16-bit patterns)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16" or x.dtype.kind == "V":
        return x.view(np.int16)
    return x


def _flat(tree) -> dict:
    return dict(TS._flatten(tree))


def _jax_packed(seed: int = 0):
    w = np.random.default_rng(seed).standard_normal((96, 40)).astype(np.float32)
    return w, JQ.pack_weights(jnp.asarray(w), "precise")


def _port_like(jp: JaxPacked) -> PackedDSBPWeight:
    return bridge.packed_from_jax(np.zeros_like(jp.ka), np.zeros_like(jp.kscale),
                                  np.zeros_like(jp.tscale), np.zeros_like(jp.bits),
                                  k=jp.k, n=jp.n, group_size=jp.group_size, cfg="precise")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_store_round_trip_across_packages(tmp_path, direction):
    """Every leaf equal, bit for bit, through ``restore`` and
    ``restore_flat`` (JAX's ``restore`` cannot cast its own bf16 bytes
    back, so a bf16 leaf crosses to JAX through ``restore_flat``), with
    the same member files and manifest bytes either way."""
    a = _arrays()
    _, jp = _jax_packed()
    d = str(tmp_path / direction)
    if direction == "jax_to_port":
        JS.save(d, 7, {**_jax_tree(a), "p": jp})
        like = {**_torch_tree(jax.tree.map(np.zeros_like, a)), "p": _port_like(jp)}
        got, step = TS.restore(d, like)
        assert step == 7 and isinstance(got["p"], PackedDSBPWeight)
        assert got["h"].dtype == torch.bfloat16 and isinstance(got["nest"][1], tuple)
        want = {**a, "p": {f: np.asarray(getattr(jp, f)) for f in TS._PACKED_FIELDS}}
        flat_got, flat_want = _flat(got), _flat(want)
        flat_raw, _ = TS.restore_flat(d)
        flat_t, _ = TS.restore_flat_tensors(d)
    else:
        tree = {**_torch_tree(a), "p": bridge.packed_from_jax(
            *(np.asarray(getattr(jp, f)) for f in TS._PACKED_FIELDS), k=jp.k, n=jp.n,
            group_size=jp.group_size, cfg="precise")}
        TS.save(d, 7, tree)
        like = jax.tree.map(jnp.zeros_like, {k: v for k, v in a.items() if k != "h"})
        got, step = JS.restore(d, {**like, "p": jp})
        assert step == 7
        flat_got = {JS._path_key(path): np.asarray(leaf)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]}
        flat_want = _flat(tree)
        flat_want.pop("h")
        flat_raw, _ = JS.restore_flat(d)
        flat_t = None
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(_bits(flat_got[k]), _bits(flat_want[k]), err_msg=k)
    want_all = _flat({**a, "p": {f: np.asarray(getattr(jp, f)) for f in TS._PACKED_FIELDS}})
    assert sorted(flat_raw) == sorted(want_all)
    for k, v in want_all.items():
        np.testing.assert_array_equal(_bits(flat_raw[k]), _bits(v), err_msg=k)
        if flat_t is not None:
            np.testing.assert_array_equal(_bits(flat_t[k]), _bits(v), err_msg=k)
    # the other package writes the same files
    other = str(tmp_path / "other")
    if direction == "jax_to_port":
        TS.save(other, 7, {**_torch_tree(a), "p": TS.restore(d, like)[0]["p"]})
    else:
        JS.save(other, 7, {**_jax_tree(a), "p": jp})
    for name in ("manifest.msgpack", "host0.npz"):
        one = open(os.path.join(d, "step_00000007", name), "rb").read()
        two = open(os.path.join(other, "step_00000007", name), "rb").read()
        if name == "manifest.msgpack":
            assert one == two
        else:  # zip members: same names, same .npy bytes
            za, zb = np.load(os.path.join(d, "step_00000007", name)), np.load(
                os.path.join(other, "step_00000007", name))
            assert za.files == zb.files
            for f in za.files:
                np.testing.assert_array_equal(_bits(za[f]), _bits(zb[f]))


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32, -33, -128,
    -129, -32768, -32769, -2**31, -2**31 - 1, "", "x" * 31, "x" * 32, "é" * 200, "x" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)), {str(i): i for i in range(15)},
    {str(i): [i, -i] for i in range(16)}, {"shapes": {"a/0/ka": [4096, 11008]}}],
    ids=lambda v: f"{type(v).__name__}{len(v) if hasattr(v, '__len__') else v}")
def test_manifest_codec_equals_msgpack(value):
    """The port's manifest codec writes ``msgpack.packb``'s bytes and
    reads them back, at every length boundary of its subset (the card's
    machine has no msgpack, so the package is imported here only)."""
    msgpack = pytest.importorskip("msgpack")
    assert TS.packb(value) == msgpack.packb(value)
    assert TS.unpackb(msgpack.packb(value)) == msgpack.unpackb(msgpack.packb(value))


def test_atomic_publish_and_latest_step(tmp_path):
    """A ``.tmp`` directory (a crash mid-save) and a step directory
    without its manifest are never restored; a save over an existing step
    replaces it; an empty or missing directory has no latest step."""
    d = str(tmp_path / "ck")
    assert TS.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        TS.restore_flat(d)
    TS.save(d, 2, {"x": torch.ones(3)})
    JS.save(d, 5, {"x": jnp.full((3,), 5.0)})
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000011"))  # no manifest: incomplete
    assert TS.latest_step(d) == JS.latest_step(d) == 5
    got, step = TS.restore(d, {"x": torch.zeros(3)})
    assert step == 5 and torch.equal(got["x"], torch.full((3,), 5.0))
    TS.save(d, 5, {"x": torch.full((3,), 6.0)})
    assert not os.path.exists(os.path.join(d, "step_00000005.tmp"))
    np.testing.assert_array_equal(JS.restore_flat(d, step=5)[0]["x"], np.full(3, 6.0))
    assert float(TS.restore(d, {"x": torch.zeros(3)}, step=2)[0]["x"][0]) == 1.0


def test_restore_refuses_mismatches(tmp_path):
    """A shape mismatch raises ValueError, a missing key KeyError, as
    JAX's do."""
    d = str(tmp_path / "ck")
    TS.save(d, 1, {"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="ckpt shape"):
        TS.restore(d, {"a": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="ckpt shape"):
        JS.restore(d, {"a": jnp.zeros((3, 2))})
    with pytest.raises(KeyError, match="missing"):
        TS.restore(d, {"a": torch.zeros(2, 3), "b": torch.zeros(1)})


def test_v1_packed_checkpoint_upgrades(tmp_path):
    """A layout-v1 packed checkpoint (``a (N, n_g, G)`` / ``scale (N,
    n_g)``) restores into a v2 container equal to the JAX store's upgrade
    and to the live container, bit for bit."""
    _, jp = _jax_packed(3)
    d = str(tmp_path / "v1")
    v1 = {"p": {"a": np.asarray(jp.a), "scale": np.asarray(jp.scale),
                "tscale": np.asarray(jp.tscale), "bits": np.asarray(jp.bits)}}
    JS.save(d, 1, v1)
    jgot, _ = JS.restore(d, {"p": jp})
    tgot, _ = TS.restore(d, {"p": _port_like(jp)})
    for f in TS._PACKED_FIELDS:
        want = np.asarray(getattr(jp, f))
        np.testing.assert_array_equal(np.asarray(getattr(jgot["p"], f)), want)
        np.testing.assert_array_equal(getattr(tgot["p"], f).numpy(), want)


@pytest.mark.parametrize("parts,axis,new", [(2, 0, 4), (4, 1, 2), (3, 1, 1)])
def test_reshard_leaf_equals_jax(parts, axis, new):
    full = np.arange(48, dtype=np.float32).reshape(12, 4) if axis == 0 else \
        np.arange(48, dtype=np.float32).reshape(4, 12)
    shards = np.split(full, parts, axis=axis)
    want = JS.reshard_leaf(shards, axis, new)
    got = TS.reshard_leaf([torch.from_numpy(s) for s in shards], axis, new)
    assert len(got) == len(want) == new
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        TS.reshard_leaf(shards, axis, 5)


def test_policy_checkpoint_across_packages(tmp_path):
    """A policy saved by either package loads in the other with the same
    JSON (``to_tree``: one uint8 leaf); the newest step wins, an older one
    loads by number."""
    from repro.core.quantized import PRESETS as JP

    keys = ["units/0/attn/wq", "units/0/ffn/w2", "units/1/attn/wo"]
    jpol = JaxPolicy(layers={keys[0]: JP["efficient"], keys[1]: JP["e5m3_fixed"]},
                     default=JP["precise"], meta={"final_acc": [1.0, 0.97]},
                     kv_layers={"units.0": 4}, kv_default="kv8")
    tpol = DSBPPolicy.from_json(jpol.to_json())
    d = str(tmp_path / "pol")
    jpol.save(d, step=1)
    DSBPPolicy.uniform("precise", keys).save(d, step=0)
    assert DSBPPolicy.load(d).to_json() == jpol.to_json()
    assert DSBPPolicy.load(d, step=0).to_json() == JaxPolicy.load(d, step=0).to_json()
    d2 = str(tmp_path / "pol2")
    tpol.save(d2, step=3)
    assert JaxPolicy.load(d2).to_json() == jpol.to_json()
    assert TS.latest_step(d2) == JS.latest_step(d2) == 3
    flat, _ = JS.restore_flat(d2)
    np.testing.assert_array_equal(flat["dsbp_policy_json"], tpol.to_tree()["dsbp_policy_json"])


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "packed"])
def test_model_from_checkpoint_equals_model_from_jax(tmp_path, kind):
    """A smoke llama-7b-paper param tree saved by JAX's store, read by
    ``bridge.model_from_checkpoint``: every parameter and packed child
    equal to ``model_from_jax``'s over the same tree, and its logits bit
    for bit."""
    dtype = "bfloat16" if kind == "bfloat16" else "float32"
    packed = kind == "packed"
    jcfg = jax_smoke_config("llama-7b-paper").replace(dtype=dtype, remat=False)
    params = JM.init(jax.random.PRNGKey(2), jcfg)
    if packed:
        params, _ = jax_pack(params, "precise")
    d = str(tmp_path / kind)
    JS.save(d, 0, params)
    cfg = smoke_config("llama-7b-paper").replace(dtype=dtype, remat=False)
    got = bridge.model_from_checkpoint(d, cfg, device="cpu")
    want = bridge.model_from_jax(np_tree(params), cfg, device="cpu")
    sd_got, sd_want = got.state_dict(), want.state_dict()
    assert sorted(sd_got) == sorted(sd_want)
    for k in sd_want:
        assert sd_got[k].dtype == sd_want[k].dtype, k
        np.testing.assert_array_equal(_bits(sd_got[k]), _bits(sd_want[k]), err_msg=k)
    if packed:
        pw = got.layers[1].ffn.w2
        assert isinstance(pw, PackedDSBPWeight) and (pw.k, pw.n) == (cfg.d_ff, cfg.d_model)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)))
    with torch.no_grad():
        assert torch.equal(got(toks), want(toks))
