"""Multi-rank serving of the port, on the CPU: ranks are processes joined by
a gloo process group (``repro_torch.launch.mesh.spawn``, a FileStore under
the test's ``tmp_path``, a timeout on every collective).

Held here, against the JAX package and the port's single-device engine:

* sharded packing equals the column slice of the global pack, the port's
  and JAX's (bridged), bit for bit, with the indivisible-N fallback;
* B8 (``dsbp_fused_sharded_call`` through ``ops.dsbp_matmul_fused_sharded``,
  B1's plain version per rank) equals JAX's ``dsbp_matmul_ref`` bit for bit
  in every case of JAX's own test (column-, row-parallel, 2-D, batch rows,
  the K'=192 / M=3 fallback), and within 4 ulps on heavy-tailed
  activations, whose row-parallel sum can round (a property of the
  reference's design: the f32 group-order sum is exact only while it does
  not round);
* ``Engine.generate`` and ``Engine.serve`` on meshes (1,2), (2,1), (2,2)
  and (1,4) emit the single-device engine's streams token for token, and
  the JAX ``Engine``'s at a pinned parity prompt seed (3, one of the seeds
  1, 3, 4, 5 that tests/test_torch_engine.py pins);
* each rank's weights hold exactly their shard shapes, and a sharded decode
  step makes no weight-sized relayout;
* a mesh without a process group, or with a path this slice does not
  serve under a mesh, raises.

Rank functions live at module level without JAX: every spawned rank
imports this module."""
import collections
import math
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import quantized as Q  # noqa: E402
from repro_torch.core.formats import per_tensor_scale  # noqa: E402
from repro_torch.core.packed import PackedDSBPWeight, pack_weights_sharded  # noqa: E402
from repro_torch.kernels import dsbp_fused as DF  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch.mesh import RankMesh, spawn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.serve.engine import pack_weights_int8  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ULPS = 4
TIMEOUT = timedelta(seconds=120)  # a missed collective fails a rank this soon
PROMPT_SEED = 3                       # a pinned parity seed (test_torch_engine.py)
GEN_LENS = np.asarray([5, 11, 8, 3], np.int32)
REQ_LENS, REQ_BUDGETS = (5, 11, 8, 3, 9), (4, 2, 5, 3, 4)
N_NEW = 6
MAX_LEN = 32
VARIANTS = {"gqa": {}, "mha": {"n_kv_heads": 4}, "gqa8": {"n_heads": 8}}


def _prompts(vocab):
    rng = np.random.default_rng(PROMPT_SEED)
    toks = np.zeros((len(GEN_LENS), int(GEN_LENS.max())), np.int64)
    for j, n in enumerate(GEN_LENS):
        toks[j, :n] = rng.integers(0, vocab, n)
    return toks


def _requests(vocab, cls=Request):
    rng = np.random.default_rng(PROMPT_SEED)
    return [cls(uid=i, tokens=rng.integers(0, vocab, n), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(REQ_LENS, REQ_BUDGETS))]


def _fake_meshes(shape):
    """Every rank's mesh view, in one process: packing and cutting need
    only the coordinates, no collective."""
    n = int(np.prod(shape))
    return [RankMesh(shape, ("data", "model"), r, {}) for r in range(n)]


# ---------------------------------------------------------------------------
# rank functions (run in spawned processes)
# ---------------------------------------------------------------------------

def _even(mesh, axis, dim):
    if axis is None:
        return slice(0, dim)
    size, c = mesh.shape[axis], mesh.coords[axis]
    return slice(c * dim // size, (c + 1) * dim // size)


def _axes_tuple(ax) -> tuple:
    if not ax:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _sharded_axes(mesh, m, padded_k, n, *, batch_axis=None, k_axis=None, n_axis=None):
    """JAX's per-axis fallbacks of ``dsbp_matmul_fused_sharded``
    (kernels/ops.py:244-257) on a GEMM's global dims: each axis dropped
    (its dim replicates) where the mesh lacks it or the dim does not divide
    (M by the batch axes, N by n_axis, K' by GROUP * size(k_axis)), and one
    axis never splitting two dims."""
    def size(ax):
        axes = _axes_tuple(ax)
        if not axes or any(a not in mesh.shape for a in axes):
            return None
        return math.prod(mesh.shape[a] for a in axes)

    bsz = size(batch_axis)
    if not bsz or m % bsz:
        batch_axis = None
    nsz = size(n_axis)
    if not nsz or n % nsz:
        n_axis = None
    ksz = size(k_axis)
    if not ksz or padded_k % (DF.GROUP * ksz):
        k_axis = None
    if k_axis is not None and k_axis == n_axis:
        n_axis = None
    if batch_axis is not None and k_axis in _axes_tuple(batch_axis):
        batch_axis = None
    return batch_axis, k_axis, n_axis


def _b8_rank(mesh, cases):
    """Each case: cut x and the packed weight as the resolved axes say,
    run the sharded GEMM, assemble y (columns over n_axis, rows over the
    batch axis) on every rank; with each case's output, the collectives
    the sharded GEMM entered, by kind."""
    cfg = Q.PRESETS["precise"]
    out = []
    for x, w, axes in cases:
        m, k = x.shape
        n = w.shape[1]
        kp = -(-k // 64) * 64
        batch_axis, k_axis, n_axis = _sharded_axes(mesh, m, kp, n, **axes)
        ba = batch_axis[0] if batch_axis else None
        rows, ks, cols = _even(mesh, ba, m), _even(mesh, k_axis, kp), _even(mesh, n_axis, n)
        pw = (pack_weights_sharded(torch.from_numpy(w), cfg, mesh, n_axis=n_axis)
              if n_axis else Q.pack_weights(torch.from_numpy(w), cfg))
        if k_axis is not None:
            pw = pw.slice(rows=ks)
        xl = torch.from_numpy(x)[rows, ks]
        before = collections.Counter(mesh.collectives)
        y = TO.dsbp_matmul_fused_sharded(xl, pw, mesh, batch_axis=batch_axis,
                                         k_axis=k_axis, n_axis=n_axis)
        coll = dict(mesh.collectives - before)
        full = torch.zeros(m, n)
        full[rows, cols] = y
        for axis in (ba, n_axis):  # in one order on every rank
            if axis is not None:
                mesh.all_reduce(full, "sum", axis)
        out.append((full.numpy(), (batch_axis, k_axis, n_axis), coll))
    return out


def _serve_rank(mesh, jobs):
    """Each job: a model built from a bridged JAX tree, served on the mesh
    through generate and serve; returns tokens, stats, layer 0's shard
    shapes and the weight relayouts of one sharded decode step."""
    res = []
    for tree, cfg, pool in jobs:
        model = bridge.model_from_jax(tree, cfg, device="cpu")
        eng = Engine(model, ServeConfig(max_len=MAX_LEN, batch_size=pool,
                                        mesh_shape=tuple(mesh.shape.values())), device="cpu")
        gen = eng.generate(_prompts(cfg.vocab_size), N_NEW, lengths=GEN_LENS)
        gst = dict(eng.last_stats)
        served = eng.serve(_requests(cfg.vocab_size))
        layer = eng.model.layers[0]
        shapes = {name: tuple((w.ka if isinstance(w, PackedDSBPWeight) else w).shape)
                  for name, w in [*layer.attn.named_children(), *layer.ffn.named_children(),
                                  *layer.attn.named_parameters(recurse=False),
                                  *layer.ffn.named_parameters(recurse=False)]}
        shapes["lm_head"] = tuple(eng.model.lm_head.shape)
        b = eng.scfg.batch_size
        rows = eng._shard_cache(b)
        b_l = b if rows is None else rows.stop - rows.start
        cache = eng.model.init_cache(b_l, MAX_LEN)
        tok = torch.zeros(b_l, 1, dtype=torch.int64)
        pos = torch.full((b_l,), 3, dtype=torch.int32)
        smallest = min(int(np.prod(s)) for s in shapes.values())
        with torch.inference_mode(), eng._trace_ctx(rows is not None):
            relayouts = TO.count_weight_transposes(eng.model.decode_step, tok, cache, pos,
                                                   eng.quant, min_size=smallest)
        res.append({"generate": gen, "serve": served, "gen_stats": gst,
                    "serve_stats": dict(eng.last_stats), "shapes": shapes,
                    "relayouts": relayouts,
                    "method": eng.cfg.quant_method})
    return res


# ---------------------------------------------------------------------------
# JAX references (computed once per configuration in this process)
# ---------------------------------------------------------------------------

_REFS: dict = {}


def _pair(variant, packed):
    """(JAX cfg, JAX params, numpy tree, port cfg) for one smoke variant."""
    import jax

    from repro.configs import smoke_config as jax_smoke
    from repro.models import model as JM
    from test_torch_model import np_tree

    kw = dict(VARIANTS[variant], quant="precise" if packed else None)
    jcfg = jax_smoke("llama-7b-paper").replace(remat=False, **kw)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, np_tree(params), smoke_config("llama-7b-paper").replace(**kw)


def _references(variant, packed, pool):
    """Tokens of the JAX Engine ('dsbp_ref' where packed, which the JAX
    suite holds bit-exact to its fused kernel) and of the port's
    single-device engine, generate and serve at ``pool`` slots."""
    key = (variant, packed, pool)
    if key not in _REFS:
        from repro.serve.engine import Engine as JaxEngine
        from repro.serve.engine import Request as JaxRequest
        from repro.serve.engine import ServeConfig as JaxServeConfig

        jcfg, params, tree, cfg = _pair(variant, packed)
        jeng = JaxEngine(params, jcfg, JaxServeConfig(
            max_len=MAX_LEN, batch_size=pool, quant_method="dsbp_ref" if packed else None))
        eng = Engine(bridge.model_from_jax(tree, cfg, device="cpu"),
                     ServeConfig(max_len=MAX_LEN, batch_size=pool), device="cpu")
        prompts = _prompts(cfg.vocab_size)
        _REFS[key] = {
            "tree": tree, "cfg": cfg,
            "jax": (jeng.generate(prompts, N_NEW, lengths=GEN_LENS),
                    jeng.serve(_requests(cfg.vocab_size, JaxRequest))),
            "port": (eng.generate(prompts, N_NEW, lengths=GEN_LENS),
                     eng.serve(_requests(cfg.vocab_size)))}
    return _REFS[key]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_sharded_pack_equals_global_pack_slice():
    """Each rank's pack_weights_sharded equals the column slice of the
    port's global pack and of JAX's pack carried over by the bridge
    (the shapes of JAX's test_sharded_pack_equals_pack_then_shard, on its
    (2, 4) mesh); an indivisible N (130 over 4) falls back to the global
    pack on every rank."""
    import jax.numpy as jnp

    from repro.core.quantized import pack_weights as jax_pack

    cfg = Q.PRESETS["precise"]
    rng = np.random.default_rng(0)
    for shape in [(256, 128), (128, 512), (3, 128, 256), (128, 130)]:
        w = rng.normal(size=shape).astype(np.float32)
        jp = jax_pack(jnp.asarray(w), "precise")
        jpw = bridge.packed_from_jax(*(np.asarray(getattr(jp, f)) for f in
                                       ("ka", "kscale", "tscale", "bits")),
                                     k=jp.k, n=jp.n, group_size=jp.group_size, cfg="precise")
        gpw = Q.pack_weights(torch.from_numpy(w), cfg)
        n = shape[-1]
        for mesh in _fake_meshes((2, 4)):
            local = pack_weights_sharded(torch.from_numpy(w), cfg, mesh)
            cols = _even(mesh, "model", n) if n % 4 == 0 else slice(0, n)
            for ref in (gpw.slice(cols=cols), jpw.slice(cols=cols)):
                for f in ("ka", "kscale", "tscale", "bits"):
                    assert torch.equal(getattr(local, f), getattr(ref, f)), (shape, mesh, f)
                assert (local.k, local.n, local.group_size) == (ref.k, ref.n, ref.group_size)


def test_engine_cuts_bridged_packed_model_like_rank_packing():
    """A JAX-packed model crosses the bridge whole; the Engine's cut of
    each container (its column and row slices) equals the rank packing its
    own shard from the raw weights."""
    import jax

    from repro.models import model as JM
    from repro.serve.engine import pack_weights_int8 as jax_pack_int8
    from test_torch_model import np_tree

    jcfg, _, tree, cfg = _pair("gqa8", packed=True)
    jpacked, _ = jax_pack_int8(JM.init(jax.random.PRNGKey(0), jcfg.replace(quant=None)),
                               "precise")
    packed_tree = np_tree(jpacked)
    for mesh in _fake_meshes((1, 4)):
        cuts = SH.serve_cuts(cfg, mesh)
        bridged = bridge.model_from_jax(packed_tree, cfg, device="cpu")
        SH.shard_model(bridged, cuts)
        own = bridge.model_from_jax(tree, cfg, device="cpu")
        pack_weights_int8(own, "precise", mesh=mesh)
        SH.shard_model(own, cuts)
        n_packed = 0
        for (name, a), (_, b) in zip(bridged.named_modules(), own.named_modules()):
            if isinstance(a, PackedDSBPWeight):
                n_packed += 1
                for f in ("ka", "kscale", "tscale", "bits"):
                    assert torch.equal(getattr(a, f), getattr(b, f)), (mesh, name, f)
                assert (a.k, a.n) == (b.k, b.n)
        assert n_packed == 7 * cfg.n_layers
        assert torch.equal(bridged.lm_head, own.lm_head)
        assert own.layers[0].attn.wq.n == 8 * 32 // 4


def test_b8_plain_bit_equal_to_jax_ref(tmp_path):
    """B8 on a (2, 4) mesh of gloo ranks, every case of JAX's
    test_fused_sharded_gemm_bit_exact_vs_ref, bit-equal to JAX's
    dsbp_matmul_ref; heavy-tailed activations (N(0,1) * exp(3 N(0,1)) per
    channel, K=4096) row-parallel over 4 and over 2 ranks within 4 ulps of
    the unsplit B1 and of JAX's reference, the count of differing elements
    printed."""
    import jax.numpy as jnp

    from repro.core.quantized import PRESETS as JAX_PRESETS
    from repro.core.quantized import dsbp_matmul_ref

    rng = np.random.default_rng(1)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    x = rng.normal(size=(8, 256)).astype(np.float32)
    w2 = rng.normal(size=(192, 96)).astype(np.float32)
    x2 = rng.normal(size=(3, 192)).astype(np.float32)
    heavy_rng = np.random.default_rng(7)
    xh = (heavy_rng.normal(size=(4, 4096))
          * np.exp(3 * heavy_rng.normal(size=(1, 4096)))).astype(np.float32)
    wh = (heavy_rng.normal(size=(4096, 256)) * 4096 ** -0.5).astype(np.float32)
    cases = [(x, w, dict(n_axis="model")),                       # column-parallel
             (x, w, dict(k_axis="model")),                       # row-parallel
             (x, w, dict(k_axis="data", n_axis="model")),        # 2-D K x N
             (x, w, dict(batch_axis=("data",), n_axis="model")),  # batch rows
             (x2, w2, dict(batch_axis=("data",), k_axis="model")),  # fallback
             (xh, wh, dict(k_axis="model")),                     # heavy, 4 shards
             (xh, wh, dict(k_axis="data"))]                      # heavy, 2 shards
    ranks = spawn(_b8_rank, (2, 4), cases, device="cpu", store_dir=tmp_path,
                  timeout=TIMEOUT, deadline_s=300)
    cfg = Q.PRESETS["precise"]
    resolved = [axes for _, axes, _ in ranks[0]]
    assert resolved[4] == (None, None, None)  # M=3 / K'=192 do not divide
    assert resolved[0] == (None, None, "model") and resolved[1] == (None, "model", None)
    # the collectives of each call, read from the mesh: the amax reduced
    # over every axis that splits x, and ONE fold over k_axis (row-parallel)
    for i, (batch_axis, k_axis, _) in enumerate(resolved):
        want = collections.Counter(f"max:{a}" for a in _axes_tuple(batch_axis)
                                   + _axes_tuple(k_axis))
        if k_axis is not None:
            want[f"sum:{k_axis}"] += 1
        assert all(r[i][2] == dict(want) for r in ranks), (i, [r[i][2] for r in ranks])
    for i, (xc, wc, _) in enumerate(cases):
        ys = [r[i][0] for r in ranks]
        assert all(np.array_equal(ys[0], y) for y in ys[1:]), f"case {i}: ranks disagree"
        ref = np.asarray(dsbp_matmul_ref(jnp.asarray(xc), jnp.asarray(wc),
                                         JAX_PRESETS["precise"]))
        if i < 5:
            assert np.array_equal(ys[0], ref), f"case {i}: {np.abs(ys[0] - ref).max()}"
            continue
        pw = Q.pack_weights(torch.from_numpy(wc), cfg)
        ts = per_tensor_scale(torch.from_numpy(xc), cfg.input_cfg.fmt).reshape(1)
        unsplit = DF.dsbp_fused_plain(torch.from_numpy(xc), ts, pw.ka, pw.kscale,
                                      pw.tscale.reshape(-1), cfg.input_cfg).numpy()
        for name, want in (("unsplit B1", unsplit), ("JAX dsbp_matmul_ref", ref)):
            diff = np.abs(ys[0] - want)
            ulp = np.spacing(np.abs(want).astype(np.float32))
            print(f"heavy-tailed K=4096, {resolved[i][1]} split: {int((diff > 0).sum())} "
                  f"of {diff.size} elements differ from {name}, at most "
                  f"{float((diff / ulp).max()):.1f} ulps")
            assert (diff <= ULPS * ulp).all(), (i, name, float((diff / ulp).max()))


MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_serve_on_mesh_matches_single_device_and_jax(shape, tmp_path):
    """Smoke llama-7b-paper, float and packed "precise", served through
    ``generate`` (4 ragged prompts) and ``serve`` (5 requests through a
    pool of mesh.size slots) on one spawned mesh: every rank emits the
    single-device engine's streams (same pool) token for token, and the
    JAX Engine's.  GQA and MHA on (1,2), (2,1), (2,2); GQA with 8 q heads
    on (1,4), where wo's K' splits group-aligned over 4 and the 2 KV heads
    do not divide (each rank keeps the one its q heads read).  Each rank's
    layer holds exactly its shard shapes and a sharded decode step makes
    no weight-sized relayout."""
    variants = ["gqa8"] if shape == (1, 4) else ["gqa", "mha"]
    pool = int(np.prod(shape))
    keys = [(v, p) for v in variants for p in (False, True)]
    refs = {key: _references(*key, pool) for key in keys}
    jobs = [(refs[key]["tree"], refs[key]["cfg"], pool) for key in keys]
    ranks = spawn(_serve_rank, shape, jobs, device="cpu", store_dir=tmp_path,
                  timeout=TIMEOUT, deadline_s=600)
    for j, key in enumerate(keys):
        ref = refs[key]
        for rank, res in enumerate(ranks):
            got = res[j]
            tag = (shape, key, rank)
            assert got["method"] == ("dsbp_fused_sharded" if key[1] else None), tag
            for want in (ref["port"], ref["jax"]):
                np.testing.assert_array_equal(got["generate"], want[0], err_msg=str(tag))
                for uid, toks in want[1].items():
                    np.testing.assert_array_equal(got["serve"][uid], toks, err_msg=str(tag))
            st = got["serve_stats"]
            assert st["mesh_shape"] == shape and st["pool_size"] == pool, tag
            assert got["relayouts"] == 0, tag
        # the collectives of one decode step, per layer (2) and kind
        coll = ranks[0][j]["serve_stats"]["collectives_per_decode_step"]
        d, m = shape
        want = {}
        if m > 1:  # wo and w2 row-parallel; the logits over 'model'
            want["sum:model"] = 2 * 2 + 1
            if key[1]:
                want["max:model"] = 2 * 2
        if d > 1:  # every quantized projection's scale over 'data'; the tokens
            want["sum:data"] = 1
            if key[1]:
                want["max:data"] = 7 * 2
        assert coll == want, (shape, key, coll)
    d, dh, ff = 128, 32, 256
    m = shape[1]
    for j, key in enumerate(keys):
        cfg = refs[key]["cfg"]
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        # whole KV heads over 'model', or the one KV head a rank's q heads read
        kv_cols = hkv * dh // m if hkv % m == 0 else dh
        want = {"wq": (d, hq * dh // m), "wk": (d, kv_cols), "wv": (d, kv_cols),
                "wo": (hq * dh // m, d), "w1": (d, ff // m), "w3": (d, ff // m),
                "w2": (ff // m, d), "lm_head": (d, 512 // m)}
        for res in ranks:  # packed containers (ka) and float weights alike
            assert res[j]["shapes"] == want, (shape, key, res[j]["shapes"])


def test_mesh_without_group_or_unported_path_raises():
    cfg = smoke_config("llama-7b-paper")
    model = TM.init(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        Engine(model, ServeConfig(mesh_shape=(1, 2)), device="cpu")
    for bad in (dict(paged=True), dict(kv_quant="kv8"), dict(kv_bits=8),
                dict(quant_method="dsbp_fused"), dict(pack=False)):
        with pytest.raises(NotImplementedError, match="A13"):
            Engine(model, ServeConfig(mesh_shape=(1, 2), **bad), device="cpu")


def test_mesh_of_one_rank_serves_as_no_mesh():
    """(1, 1) needs no process group and serves the single-device streams
    through 'dsbp_fused_sharded' (which degrades to B1)."""
    cfg = smoke_config("llama-7b-paper")
    reqs = _requests(cfg.vocab_size)
    base = Engine(TM.init(cfg, seed=0, device="cpu"), ServeConfig(max_len=MAX_LEN, batch_size=2), device="cpu")
    one = Engine(TM.init(cfg, seed=0, device="cpu"),
                 ServeConfig(max_len=MAX_LEN, batch_size=2, mesh_shape=(1, 1)), device="cpu")
    assert one.cfg.quant_method == "dsbp_fused_sharded"
    a, b = base.serve(reqs), one.serve(reqs)
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid])
    assert one.last_stats["collectives_per_decode_step"] == {}
    assert one.last_stats["pool_size"] == 2


def test_launcher_serves_on_mesh_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--packed",
         "--device", "cpu", "--mesh", "1x2", "--new-tokens", "3", "--ragged"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh (1, 2)" in res.stdout and "served 8 ragged requests" in res.stdout, res.stdout
