"""The two-kernel DSBP method's plain versions against the JAX package's
Pallas kernels (interpret mode), on the CPU.

B3 (input path): aligned mantissas, scales and widths bit-equal to JAX
``fp8_quant_align_kernel_call`` across formats, modes, truncation and
ragged M.  B4 (grouped integer GEMM): bit-equal to JAX
``dsbp_matmul_kernel_call`` on unit single-group scales, where every sum
is an exact integer, and unfolded at any scales (exact group dots, the
same group-ordered f32 adds); JAX's folded form within 3e-5 * max|y|
otherwise (the f32 sum order, the tolerance of
``tests/test_kernels.py:177``): the port takes the unfolded order for both
forms, folded and unfolded bit-equal.  The
``dsbp_kernel`` method on a bridged packed container matches JAX's, and
the dispatch counter ``count_weight_transposes`` sees no per-call weight
relayout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax.numpy as jnp  # noqa: E402

from repro.core import packed as JP  # noqa: E402
from repro.core import quantized as JQ  # noqa: E402
from repro.core.dsbp import DSBPConfig as JCfg  # noqa: E402
from repro.core.formats import per_tensor_scale as jax_ts  # noqa: E402
from repro.kernels.dsbp_matmul import dsbp_matmul_kernel_call  # noqa: E402
from repro.kernels.fp8_quant_align import fp8_quant_align_kernel_call  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import packed as TP  # noqa: E402
from repro_torch.core import quantized as TQ  # noqa: E402
from repro_torch.core.dsbp import DSBPConfig as TCfg  # noqa: E402
from repro_torch.kernels import dsbp_matmul as DM  # noqa: E402
from repro_torch.kernels import fp8_quant_align as QA  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402

TOL = 3e-5  # relative to max|y|: f32 summation order only


def _data(shape, seed=0, spread=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-spread, spread, shape))).astype(np.float32)


B3_CASES = [(fmt, mode, k, b_fix, "rne", 16, 256)
            for fmt in ("e2m5", "e3m4", "e4m3", "e5m2")
            for mode, k, b_fix in (("dsbp", 1.0, 6), ("fixed", 0.0, 7))]
B3_CASES += [("e4m3", "dsbp", 1.0, 5, "trunc", 8, 128),
             ("e4m3", "dsbp", 2.0, 4, "trunc", 8, 128)]
B3_CASES += [("e4m3", "dsbp", 1.0, 5, "rne", m, 128) for m in (1, 3, 5)]


@pytest.mark.parametrize("fmt,mode,k,b_fix,rounding,m,kk", B3_CASES)
def test_b3_plain_bit_equal_jax(fmt, mode, k, b_fix, rounding, m, kk):
    kw = dict(fmt=fmt, side="input", mode=mode, k=k, b_fix=b_fix,
              mantissa_rounding=rounding)
    x = jnp.asarray(_data((m, kk), seed=m + kk, spread=8))
    xs = np.array(x * jax_ts(x, fmt))
    ja, js, jb = fp8_quant_align_kernel_call(jnp.asarray(xs), JCfg(**kw), interpret=True)
    before = QA.fp8_quant_align.launches
    ta, ts, tb = QA.fp8_quant_align(torch.from_numpy(xs), TCfg(**kw))
    assert QA.fp8_quant_align.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(js).view(np.int32), ts.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


def _b4_operands(m, k, n, seed, unit=False):
    rng = np.random.default_rng(seed)
    ng = k // 64
    ax = rng.integers(-2047, 2048, (m, k)).astype(np.int32)
    aw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    if unit:
        return ax, np.ones((m, ng), np.float32), aw, np.ones((ng, n), np.float32)
    sx = np.exp2(rng.integers(-8, 8, (m, ng))).astype(np.float32)
    sw = np.exp2(rng.integers(-8, 8, (ng, n))).astype(np.float32)
    return ax, sx, aw, sw


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("m,k,n,unit", [(5, 64, 64, True), (16, 64, 128, True),
                                        (5, 256, 64, False), (3, 512, 128, False),
                                        (16, 128, 64, False)])
def test_b4_plain_matches_jax(m, k, n, unit, folded):
    ax, sx, aw, sw = _b4_operands(m, k, n, seed=m + k + n, unit=unit)
    jy = np.asarray(dsbp_matmul_kernel_call(*map(jnp.asarray, (ax, sx, aw, sw)),
                                            folded=folded, interpret=True))
    ty = DM.dsbp_matmul(*map(torch.from_numpy, (ax, sx, aw, sw)), folded=folded).numpy()
    if unit or not folded:  # exact dots; the same f32 adds in group order
        np.testing.assert_array_equal(ty, jy)
    else:
        assert np.abs(ty - jy).max() <= TOL * np.abs(jy).max()


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_b4_plain_sums_in_kernel_order(folded):
    """The plain version adds in the kernel's order, so the kernel is held
    to it bit for bit on the card: for either form, y = y + dot_g * (sx_g *
    sw_g) by group, with dot_g the exact 64-deep integer dot (one order for
    both forms on Hopper)."""
    m, k, n = 4, 256, 32
    ax, sx, aw, sw = map(torch.from_numpy, _b4_operands(m, k, n, seed=9))
    y = DM.dsbp_matmul(ax, sx, aw, sw, folded=folded)
    ref = torch.zeros(m, n)
    for g in range(k // 64):
        a, w = ax[:, 64 * g:64 * (g + 1)].double(), aw[64 * g:64 * (g + 1)].double()
        ref = ref + (a @ w).float() * (sx[:, g:g + 1] * sw[g:g + 1])
    assert torch.equal(y, ref)


@pytest.mark.parametrize("m,k,n", [(4, 256, 32), (17, 640, 44), (3, 1024, 96)])
def test_b4_folded_equals_unfolded(m, k, n):
    """Every product is exact, so the folded form is the same sum: on
    Hopper both forms take the one group-order fold, so each gives the bits
    of JAX's unfolded kernel (an independent implementation of that order),
    with heavy-tailed pow2 scales too.  The card's kernel is held to the
    same in tests/test_torch_gpu_kernels.py."""
    ax, sx, aw, sw = _b4_operands(m, k, n, seed=m + n)
    sx = sx * np.exp2(np.random.default_rng(m).integers(-20, 20, sx.shape)).astype(np.float32)
    jy = np.asarray(dsbp_matmul_kernel_call(*map(jnp.asarray, (ax, sx, aw, sw)), bk=64,
                                            folded=False, interpret=True))
    args = [torch.from_numpy(t) for t in (ax, sx, aw, sw)]
    for folded in (True, False):
        np.testing.assert_array_equal(DM.dsbp_matmul(*args, folded=folded).numpy(), jy)


def _pair(k, n, seed, preset="precise"):
    """The same packed weight in both packages (bridged by its children)."""
    w = _data((k, n), seed=seed, spread=2)
    jpw = JQ.pack_weights(jnp.asarray(w), preset)
    tpw = bridge.packed_from_jax(np.asarray(jpw.ka), np.asarray(jpw.kscale),
                                 np.asarray(jpw.tscale), np.asarray(jpw.bits),
                                 k=jpw.k, n=jpw.n, group_size=jpw.group_size, cfg=preset)
    return w, jpw, tpw


@pytest.mark.parametrize("preset", ["precise", "efficient", "e5m7_fixed"])
@pytest.mark.parametrize("m,k,n", [(5, 256, 128), (3, 512, 64), (8, 128, 128)])
def test_dsbp_kernel_method_matches_jax(preset, m, k, n):
    _, jpw, tpw = _pair(k, n, seed=k + n, preset=preset)
    x = _data((m, k), seed=m)
    jy = np.asarray(JP.get_quant_method("dsbp_kernel").apply(
        jpw, jnp.asarray(x), JQ.PRESETS[preset]))
    ty = TP.get_quant_method("dsbp_kernel").apply(
        tpw, torch.from_numpy(x), TQ.PRESETS[preset]).numpy()
    assert np.abs(ty - jy).max() <= TOL * np.abs(jy).max()


@pytest.mark.parametrize("kw", [{}, {"fmt": "e5m2"}, {"mode": "fixed", "k": 0.0, "b_fix": 7},
                                {"mantissa_rounding": "trunc"}])
def test_two_kernel_path_matches_fused(kw):
    """B3+B4 hold the same aligned ints as B1's input path; only the order
    of the f32 scale folds and sums differs (K % 64 != 0 included)."""
    cfg = TQ.PRESETS["precise"]
    icfg = dataclasses.replace(cfg.input_cfg, **kw)
    pw = TQ.pack_weights(torch.from_numpy(_data((200, 96), seed=4, spread=2)), cfg)
    x = torch.from_numpy(_data((2, 3, 200), seed=5))
    fused = TO.dsbp_matmul_fused(x, pw, input_cfg=icfg)
    for folded in (False, True):
        two = TO.dsbp_matmul_packed(x, pw, input_cfg=icfg, folded=folded)
        assert two.shape == (2, 3, 96)
        assert float((two - fused).abs().max()) <= TOL * float(fused.abs().max())


def test_dsbp_matmul_use_kernel_matches_jax():
    w = _data((256, 64), seed=6, spread=1) * 0.05
    x = _data((4, 256), seed=7)
    cfg_j, cfg_t = JQ.PRESETS["precise"], TQ.PRESETS["precise"]
    jy = np.asarray(JQ.dsbp_matmul(jnp.asarray(x), jnp.asarray(w), cfg_j, use_kernel=True))
    ty = TQ.dsbp_matmul(torch.from_numpy(x), torch.from_numpy(w), cfg_t, use_kernel=True)
    ref = TQ.dsbp_matmul(torch.from_numpy(x), torch.from_numpy(w), cfg_t)
    assert np.abs(ty.numpy() - jy).max() <= TOL * np.abs(jy).max()
    assert float((ty - ref).abs().max()) <= TOL * float(ref.abs().max())


def test_packed_projection_makes_no_weight_relayout():
    """The no-relayout contract: both packed methods read the container's
    kernel-layout operands as stored; the legacy (N, n_g, G) view does
    permute them, which shows the counter counts."""
    _, _, pw = _pair(256, 128, seed=1)
    x = torch.from_numpy(_data((4, 256), seed=2))
    cfg = TQ.PRESETS["precise"]
    size = pw.ka.numel()
    for name in ("dsbp_kernel", "dsbp_fused"):
        method = TP.get_quant_method(name)
        assert TO.count_weight_transposes(method.apply, pw, x, cfg, min_size=size) == 0
    assert TO.count_weight_transposes(lambda: pw.a.contiguous(), min_size=size) >= 1
