"""The port's training substrate against the JAX package, on the CPU:
the synthetic stream, AdamW, the straight-through QAT products, B2's
gradient, FP8 gradient compression (and its all-reduce on two gloo
ranks), the launcher on every family (and its restart) and the refusals.

Tolerances.  Batches and compressed gradients: equal (numpy / the same
rounding).  AdamW: one update within 8 f32 ulps of JAX's per element
(the global norm's sums reduce in another order, and the clip scale
carries that into m and, squared, into v); unclipped, m and v bit-equal.  STE products: the
forward bit-equal to JAX's (the same integer datapath), ``gx`` / ``gw``
within 1e-6 of max|.| (float matmuls accumulating in other orders).  B2's
gradient: 1e-5 of max|.| (a one-block softmax against JAX's blockwise
online softmax)."""
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import quantized as TQ  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_batch_np  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import attention as TAT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import grad_compress as TGC  # noqa: E402

# one AdamW update: the global norm's f32 sums reduce in another order (2
# ulps of the norm), which the clip scale carries into m and, squared,
# into v (8 ulps measured); unclipped, m and v are bit-equal
ULPS = 8
STE_REL = 1e-6
ATTN_REL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------- data ----------------

@pytest.mark.parametrize("arch,seed,shard", [("llama-7b-paper", 1, 0), ("llama-7b-paper", 1, 1),
                                             ("musicgen-large", 2, 0),
                                             ("llava-next-34b", 3, 0)])
def test_synthetic_batches_equal_jax(arch, seed, shard):
    """The same (seed, step, shard) gives the same batch in both packages,
    the audio codebooks and the image embeddings included; a batch is a
    pure function of its step, shards differ, labels are tokens shifted."""
    from repro.configs import smoke_config as jax_smoke
    from repro.data.pipeline import DataConfig as JDC
    from repro.data.pipeline import SyntheticLM as JSL

    kw = dict(seed=seed, batch_size=3, seq_len=24, n_shards=2, shard=shard)
    ours = SyntheticLM(DataConfig(**kw), smoke_config(arch))
    theirs = JSL(JDC(**kw), jax_smoke(arch))
    for step in (0, 5):
        a, b = ours.batch(step), theirs.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(ours.batch(4)["tokens"], ours.batch(4)["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    other = SyntheticLM(DataConfig(**{**kw, "shard": 1 - shard}), smoke_config(arch))
    assert not np.array_equal(other.batch(5)["tokens"], a["tokens"])
    np.testing.assert_array_equal(make_batch_np(smoke_config(arch), 2, 8, seed=seed)["tokens"],
                                  JSL(JDC(seed=seed, batch_size=2, seq_len=8),
                                      jax_smoke(arch)).batch(0)["tokens"])


# ---------------- optimizer ----------------

OPT_CASES = {
    "f32": (dict(), "float32"),
    "f32_unclipped": (dict(clip_norm=1e9), "float32"),
    "bf16_master": (dict(master_dtype="float32"), "bfloat16"),
    "low_mem": (dict(m_dtype="bfloat16"), "bfloat16"),
    "clipped_warm": (dict(clip_norm=0.05, warmup_steps=3, weight_decay=0.0), "float32"),
}


def _as_torch(a):
    import ml_dtypes

    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_updates_match_jax(case):
    """One AdamW update from the same params and gradients: every
    parameter, m, v (and master) within ULPS f32 ulps of JAX's (m and v
    bit-equal without clipping; bf16 leaves on the f32 grid of their
    values), lr and the grad norm too."""
    import jax.numpy as jnp

    from repro.optim import adamw as JA

    kw, pdt = OPT_CASES[case]
    kw = dict(dict(lr_peak=1e-2, warmup_steps=2, total_steps=10), **kw)
    rng = np.random.default_rng(5)
    shapes = {"embed": (12, 8), "layers.0.attn.wq": (8, 16), "norm": (8,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, pdt) for k, v in p0.items()}
    tp = {k: torch.nn.Parameter(_as_torch(np.asarray(v)), requires_grad=False)
          for k, v in jp.items()}
    jcfg, tcfg = JA.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    js, ts = JA.init_state(jp, jcfg), adamw.init_state(tp, tcfg)
    for step in range(1):
        g = {k: rng.standard_normal(s).astype(np.float32) * (step + 1) for k, s in shapes.items()}
        jp, js, jm = JA.apply_updates(jp, js, {k: jnp.asarray(v) for k, v in g.items()}, jcfg)
        tp, ts, tm = adamw.apply_updates(tp, ts, {k: torch.from_numpy(v) for k, v in g.items()},
                                         tcfg)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for name in ("lr", "grad_norm"):
            assert abs(float(tm[name]) - float(jm[name])) <= ULPS * np.spacing(
                np.float32(abs(float(jm[name])))), (name, step)
    groups = [("params", jp, tp), ("m", js["m"], ts["m"]), ("v", js["v"], ts["v"])]
    if "master" in js:
        groups.append(("master", js["master"], ts["master"]))
    for label, want, got in groups:
        for k in shapes:
            w = np.asarray(want[k]).astype(np.float32)
            assert got[k].dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[
                str(np.asarray(want[k]).dtype)], (label, k)
            diff = np.abs(_bits(got[k]) - w)
            ulps = 0 if case == "f32_unclipped" and label in ("m", "v") else ULPS
            assert (diff <= ulps * np.spacing(np.abs(w))).all(), (label, k, diff.max())


def test_adamw_substrate_cases():
    """The port's cases of the JAX substrate tests (tests/test_substrate.py
    :22-66): a quadratic converges, the low-memory state dtypes, the
    master copy, the global-norm clip and the cosine schedule."""
    cfg = adamw.AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_state(params, cfg)
    for _ in range(200):
        params, state, _ = adamw.apply_updates(params, state, {"w": 2 * params["w"]}, cfg)
    assert float(params["w"].abs().max()) < 0.05
    low = adamw.AdamWConfig(m_dtype="bfloat16", v_dtype="float32")
    st = adamw.init_state({"w": torch.zeros(4, 4, dtype=torch.bfloat16)}, low)
    assert st["m"]["w"].dtype == torch.bfloat16 and st["v"]["w"].dtype == torch.float32
    assert "master" not in st
    mcfg = adamw.AdamWConfig(master_dtype="float32")
    p = {"w": torch.ones(2, dtype=torch.bfloat16)}
    st = adamw.init_state(p, mcfg)
    assert st["master"]["w"].dtype == torch.float32
    p2, _, _ = adamw.apply_updates(p, st, {"w": torch.ones(2)}, mcfg)
    assert p2["w"].dtype == torch.bfloat16
    clipped, gn = adamw.clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert abs(float(gn) - 10.0 * np.sqrt(10)) < 1e-3
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    sched = adamw.AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=100, lr_min_ratio=0.1)
    assert float(adamw.cosine_schedule(sched, 0)) == 0.0
    assert abs(float(adamw.cosine_schedule(sched, 10)) - 1.0) < 1e-6
    assert abs(float(adamw.cosine_schedule(sched, 100)) - 0.1) < 1e-6


def test_cosine_schedule_equals_jax():
    import jax.numpy as jnp  # noqa: F401

    from repro.optim import adamw as JA

    for kw in (dict(), dict(lr_peak=1.0, warmup_steps=10, total_steps=100, lr_min_ratio=0.1),
               dict(warmup_steps=0, total_steps=7)):
        for step in (0, 1, 5, 10, 57, 100, 10_000):
            want = float(JA.cosine_schedule(JA.AdamWConfig(**kw), step))
            got = float(adamw.cosine_schedule(adamw.AdamWConfig(**kw), step))
            assert abs(got - want) <= np.spacing(np.float32(abs(want))), (kw, step, got, want)


# ---------------- straight-through products ----------------

def _jax_ste(method: str):
    from repro.core import quantized as JQ
    from repro.kernels import ops as JO

    return {"dsbp_ref": JQ.dsbp_matmul_ste, "dsbp_kernel": JO.dsbp_matmul_ste,
            "dsbp_fused": JO.dsbp_matmul_fused_ste}[method]


PORT_STE = {"dsbp_ref": TQ.dsbp_matmul_ste, "dsbp_kernel": TO.dsbp_matmul_ste,
            "dsbp_fused": TO.dsbp_matmul_fused_ste}


@pytest.mark.parametrize("method", sorted(PORT_STE))
def test_ste_products_match_jax(method):
    """Each method's straight-through product (x (2, 5, 96) @ w (96, 40),
    K padded to two groups): the forward bit-equal to JAX's STE forward
    and to the method's packed path, ``gx`` / ``gw`` within STE_REL of
    ``jax.grad`` through JAX's STE under a random cotangent; the weight
    packed inside the forward records no backward of its own."""
    import jax
    import jax.numpy as jnp

    from repro.core.quantized import PRESETS as JP

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 96 ** -0.5).astype(np.float32)
    g = rng.standard_normal((2, 5, 40)).astype(np.float32)
    jfn = _jax_ste(method)

    def jloss(xx, ww):
        return jnp.sum(jfn(xx, ww, JP["precise"]) * g)

    jy = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), JP["precise"]))
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = PORT_STE[method](tx, tw, TQ.PRESETS["precise"])
    assert ty.grad_fn is not None
    np.testing.assert_array_equal(ty.detach().numpy(), jy)
    (ty * torch.from_numpy(g)).sum().backward()
    assert _rel(tx.grad, jgx) <= STE_REL and _rel(tw.grad, jgw) <= STE_REL, method
    # the method of the registry routes a raw weight here, forward unchanged
    from repro_torch.core.packed import get_quant_method

    y2 = get_quant_method(method).apply(tw, tx, TQ.PRESETS["precise"])
    assert y2.grad_fn is not None and torch.equal(y2.detach(), ty.detach())


def test_ste_bf16_grads_take_the_input_dtypes():
    """A bf16 x and w: the STE's gradients come back in bf16, the f32
    products rounded once (JAX ``_ste_bwd``'s ``astype``)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32)).to(torch.bfloat16)
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = TQ.dsbp_matmul_ste(x, w, TQ.PRESETS["precise"])
    g = torch.ones_like(y)
    y.backward(g)
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, (g @ w.float().T).to(torch.bfloat16))
    assert torch.equal(w.grad, (x.float().T @ g).to(torch.bfloat16))


# ---------------- B2's gradient ----------------

ATTN_CASES = {
    "gqa_ragged": dict(hq=4, hkv=2, sq=12, kv_lens=(12, 7, 3), window=0),
    "mha_full": dict(hq=3, hkv=3, sq=9, kv_lens=None, window=0),
    "gqa_window": dict(hq=4, hkv=1, sq=10, kv_lens=(10, 6, 9), window=4),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_gradient_matches_jax(case):
    """``blockwise_attention`` (B2's autograd function: the kernel's plain
    version forward, its autograd backward) against ``jax.grad`` of JAX's
    ``blockwise_attention`` under a random cotangent: q, k and v gradients
    within ATTN_REL of max|.|, causal, GQA, ragged rows, a window."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as JAT

    c = ATTN_CASES[case]
    b, d = 3, 16
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, c["hq"], c["sq"], d)).astype(np.float32)
    k = rng.standard_normal((b, c["hkv"], c["sq"], d)).astype(np.float32)
    v = rng.standard_normal((b, c["hkv"], c["sq"], d)).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)
    lens = None if c["kv_lens"] is None else np.asarray(c["kv_lens"], np.int32)
    if lens is not None:  # a padded row's queries past its length carry no gradient
        g = g * (np.arange(c["sq"])[None, None, :, None] < lens[:, None, None, None])

    def jloss(qq, kk, vv):
        o = JAT.blockwise_attention(qq, kk, vv, causal=True, window=c["window"], bq=4, bkv=4,
                                    kv_lens=None if lens is None else jnp.asarray(lens))
        return jnp.sum(o * g)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = TAT.blockwise_attention(tq, tk, tv, causal=True, window=c["window"],
                                kv_lens=None if lens is None else torch.from_numpy(lens))
    (o * torch.from_numpy(g)).sum().backward()
    for name, got, want in (("q", tq.grad, jg[0]), ("k", tk.grad, jg[1]), ("v", tv.grad, jg[2])):
        assert _rel(got, want) <= ATTN_REL, (case, name, _rel(got, want))


# ---------------- gradient compression ----------------

@pytest.mark.parametrize("shape", [(1000,), (16, 48), (3, 256)])
def test_compress_decompress_equals_jax(shape):
    """The wire round trip equals JAX's element for element (padding, a
    zero block, per-block scales), and the residual is what it dropped."""
    import jax.numpy as jnp

    from repro.train.grad_compress import compress_decompress as jcd

    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))).astype(np.float32)
    g.reshape(-1)[:256] = 0.0  # an all-zero block: scale 1
    jdeq, jerr = jcd(jnp.asarray(g))
    deq, err = TGC.compress_decompress(torch.from_numpy(g))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal((deq + err).numpy(), g)


def test_error_feedback_carries_the_residual():
    """With error feedback the running sum of compressed gradients tracks
    the true sum to within one step's quantization error."""
    rng = np.random.default_rng(0)
    resid = torch.zeros(512)
    total_true, total_sent = torch.zeros(512), torch.zeros(512)
    for _ in range(20):
        g = torch.from_numpy(rng.standard_normal(512).astype(np.float32)) * 1e-3
        sent, resid = TGC.compress_decompress(g + resid)
        total_true += g
        total_sent += sent
    assert float((total_true - total_sent - resid).abs().max()) < 1e-6
    assert float(resid.abs().max()) <= float(total_true.abs().max()) * 0.1


def _psum_rank(mesh, grads, residuals):
    import torch.distributed as dist

    r = dist.get_rank()
    out, new_res = TGC.psum_compressed(torch.from_numpy(grads[r]),
                                       torch.from_numpy(residuals[r]))
    return out.numpy(), new_res.numpy()


def test_psum_compressed_on_two_gloo_ranks(tmp_path):
    """Two gloo ranks: each rank's reduced gradient equals the mean of
    JAX's ``compress_decompress`` of every rank's ``g + residual`` (JAX's
    own psum test fails in the reference suite, so the oracle is the
    wire round trip), and each rank's new residual what its quantizer
    dropped."""
    import jax.numpy as jnp

    from repro.train.grad_compress import compress_decompress as jcd

    rng = np.random.default_rng(9)
    grads = [rng.standard_normal((5, 130)).astype(np.float32) for _ in range(2)]
    residuals = [rng.standard_normal((5, 130)).astype(np.float32) * 1e-2 for _ in range(2)]
    ranks = spawn(_psum_rank, (2, 1), grads, residuals, device="cpu", store_dir=tmp_path,
                  timeout=timedelta(seconds=60), deadline_s=120)
    deqs = [np.asarray(jcd(jnp.asarray(g + r))[0]) for g, r in zip(grads, residuals)]
    want = (deqs[0] + deqs[1]) / 2
    for r, (out, res) in enumerate(ranks):
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(res, (grads[r] + residuals[r]) - deqs[r])


# ---------------- launcher and refusals ----------------

def test_train_launcher_smoke_on_cpu(tmp_path, capsys):
    """``repro_torch.launch.train --smoke --device cpu`` trains (finite
    losses), says where it cut the depth, checkpoints, and resumes from
    its checkpoint."""
    from repro_torch.launch import train as LT

    base = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt",
            str(tmp_path / "ck"), "--quant", "precise", "--method", "dsbp_fused",
            "--layers", "1"]
    first = LT.main(base + ["--steps", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert "layers=1 (cut from 2)" in lines[0] and "method=dsbp_fused" in lines[0]
    assert len([ln for ln in lines if ln.startswith("step")]) == 2 == len(first)
    second = LT.main(base + ["--steps", "3"])
    steps = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(steps) == 1 and steps[0].split()[1] == "2"
    assert np.isfinite(first + second).all()


NON_DENSE = ["recurrentgemma-2b", "mixtral-8x7b", "grok-1-314b", "mamba2-370m",
             "musicgen-large", "llava-next-34b"]


def _launch(arch, *extra):
    from repro_torch.launch import train as LT

    return LT.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
                    "--quant", "precise", "--method", "dsbp_fused", *extra])


@pytest.mark.parametrize("arch", NON_DENSE)
def test_train_launcher_trains_every_family(arch, capsys):
    """Two QAT steps of each non-dense arch's smoke config through the
    launcher on the CPU: finite losses, one line per step; a cut of the
    hybrid names the pattern units and tail layers it keeps."""
    extra = ("--layers", "4") if arch == "recurrentgemma-2b" else ()
    hist = _launch(arch, "--steps", "2", *extra)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch} ")
    if extra:
        assert "layers=4 (cut from 8: 1 x rglru/rglru/attn_local + rglru)" in lines[0]
    assert len([ln for ln in lines if ln.startswith("step")]) == 2 == len(hist)
    assert np.isfinite(hist).all()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mixtral-8x7b", "mamba2-370m"])
def test_train_launcher_restarts_bit_for_bit(arch, tmp_path, capsys):
    """Four launcher steps checkpointing every two; a second launch
    resumed from the step-2 checkpoint alone runs steps 3-4 with the same
    losses and saves the same step-4 checkpoint, every leaf bit for bit:
    the recurrent leaves (``lam``, ``ba``, ``bx``, ``conv_w``), the expert
    stacks, the SSD leaves (``a_log``, ``dt_bias``, ``d_skip``) and their
    AdamW moments."""
    import shutil

    from repro_torch.checkpoint import store

    a, b = tmp_path / "a", tmp_path / "b"
    first = _launch(arch, "--steps", "4", "--ckpt", str(a), "--ckpt-every", "2")
    shutil.copytree(a / "step_00000002", b / "step_00000002")
    second = _launch(arch, "--steps", "4", "--ckpt", str(b), "--ckpt-every", "2")
    capsys.readouterr()
    assert len(first) == 4 and second == first[2:]
    (want, _), (got, _) = (store.restore_flat_tensors(str(d), step=4) for d in (a, b))
    leaves = {"recurrentgemma-2b": ("lam", "ba", "bx", "conv_w"),
              "mixtral-8x7b": ("router", "w1", "w3", "w2"),
              "mamba2-370m": ("a_log", "dt_bias", "d_skip", "conv_w")}[arch]
    for leaf in leaves:
        assert any(k.startswith("0/layers.") and k.endswith("." + leaf) for k in want), leaf
    assert sorted(want) == sorted(got)
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_check_trainable_refuses_packed_and_mesh():
    """What neither package trains: a packed projection (JAX's
    ``value_and_grad`` refuses its integer leaves), and a model under a
    rank mesh (ROADMAP A13); a raw model of every family passes."""
    from repro_torch.models import model as TM
    from repro_torch.models.packing import pack_weights_int8
    from repro_torch.parallel.context import sharding_ctx

    for arch in NON_DENSE:
        TM.check_trainable(TM.init(smoke_config(arch), device="cpu"))
    model = TM.init(smoke_config("mamba2-370m"), device="cpu")
    with sharding_ctx(object()):
        with pytest.raises(NotImplementedError, match="ROADMAP A13"):
            TM.check_trainable(model)
    pack_weights_int8(model, "precise")
    with pytest.raises(ValueError, match="packed projection"):
        TM.loss_fn(model, make_batch_np(smoke_config("mamba2-370m"), 2, 8))


def test_launcher_mesh_refuses():
    from repro_torch.launch import train as LT

    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        LT.main(["--smoke", "--device", "cpu", "--mesh", "1x2"])
