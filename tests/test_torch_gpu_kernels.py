"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided at run time, never at import).  Run on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quantized as Q  # noqa: E402
from repro_torch.core.formats import per_tensor_scale  # noqa: E402
from repro_torch.kernels import dsbp_fused as DF  # noqa: E402
from repro_torch.kernels import dsbp_matmul as DM  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import fp8_quant_align as QA  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kvq import KV_PRESETS, quantize_kv  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _data(shape, seed=0, spread=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-spread, spread, shape))).astype(np.float32)


def _operands(m, k, n, cfg, device, seed=0):
    pw = Q.pack_weights(torch.from_numpy(_data((k, n), seed + 1, 2)), cfg).to(device)
    x = torch.nn.functional.pad(torch.from_numpy(_data((m, k), seed)),
                                (0, pw.padded_k - k)).to(device)
    ts = per_tensor_scale(x, cfg.input_cfg.fmt).reshape(1)
    tw = pw.tscale.reshape(-1).contiguous()
    return x, ts, pw.ka, pw.kscale, tw


def _cfg(preset="precise", **kw):
    cfg = Q.PRESETS[preset]
    return dataclasses.replace(cfg, input_cfg=dataclasses.replace(cfg.input_cfg, **kw))


@pytest.mark.parametrize("m,k,n,preset,kw", [
    (4, 512, 256, "precise", {}),
    (37, 640, 96, "precise", {}),            # ragged M and N tile edges
    (5, 250, 48, "efficient", {}),           # K % 64 != 0
    (16, 256, 64, "precise", {"fmt": "e5m2"}),
    (16, 256, 64, "precise", {"mode": "fixed", "k": 0.0, "b_fix": 7}),
    (16, 256, 64, "efficient", {"mantissa_rounding": "trunc"}),
])
def test_dsbp_fused_kernel_bit_equal_plain(cuda, m, k, n, preset, kw):
    cfg = _cfg(preset, **kw)
    x, ts, ka, kscale, tw = _operands(m, k, n, cfg, cuda, seed=m)
    before = DF.dsbp_fused.launches
    y = DF.dsbp_fused(x, ts, ka, kscale, tw, cfg.input_cfg)
    torch.cuda.synchronize()
    assert DF.dsbp_fused.launches == before + 1
    ref = DF.dsbp_fused_plain(x, ts, ka, kscale, tw, cfg.input_cfg)
    assert torch.equal(y, ref), float((y - ref).abs().max())
    # and the same bits as the plain version on the CPU
    cpu = DF.dsbp_fused(*(t.cpu() for t in (x, ts, ka, kscale, tw)), cfg.input_cfg)
    assert torch.equal(y.cpu(), cpu)


@pytest.mark.parametrize("b,hq,hkv,sq,s,d,causal,window", [
    (2, 4, 2, 40, 40, 32, True, 0),      # GQA prefill, ragged lengths
    (3, 4, 4, 1, 70, 128, True, 0),      # MHA decode at per-row positions
    (1, 2, 1, 33, 33, 64, True, 8),      # sliding window
    (2, 2, 2, 17, 50, 32, False, 0),     # non-causal, queries offset
])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, sq, s, d,
                                              causal, window):
    g = torch.Generator().manual_seed(b * 100 + s)
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    k = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    v = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    if sq == 1:
        pos = torch.randint(0, s, (b,), generator=g)
        kv_len, q0 = pos + 1, pos
    elif sq == s and not window:
        kv_len = torch.randint(1, s + 1, (b,), generator=g)
        q0 = torch.zeros(b, dtype=torch.int64)
    else:  # every query row keeps a visible key under the window
        kv_len = torch.full((b,), s)
        q0 = torch.full((b,), s - sq)
    kv_len, q0 = kv_len.to(cuda, torch.int32), q0.to(cuda, torch.int32)
    before = FA.flash_attention.launches
    o = FA.flash_attention(q, k, v, kv_len, q0, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    ref = FA.flash_attention_plain(q, k, v, kv_len, q0, causal=causal, window=window)
    # online-softmax order: the kernel rescales per 32-key tile
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,preset,kw", [
    (4, 512, "precise", {}),
    (37, 640, "precise", {}),                # ragged M, K not a multiple of 512
    (5, 192, "efficient", {}),
    (16, 256, "precise", {"fmt": "e5m2"}),
    (16, 256, "precise", {"mode": "fixed", "k": 0.0, "b_fix": 7}),
    (16, 256, "efficient", {"mantissa_rounding": "trunc"}),
])
def test_fp8_quant_align_kernel_bit_equal_plain(cuda, m, k, preset, kw):
    icfg = _cfg(preset, **kw).input_cfg
    x = torch.from_numpy(_data((m, k), seed=m + k, spread=8)).to(cuda)
    xs = x * per_tensor_scale(x, icfg.fmt)
    before = QA.fp8_quant_align.launches
    got = QA.fp8_quant_align(xs, icfg)
    torch.cuda.synchronize()
    assert QA.fp8_quant_align.launches == before + 1
    for g, r in zip(got, QA.fp8_quant_align_plain(xs, icfg)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("m,k,n", [(4, 512, 256), (37, 640, 96), (5, 192, 48)])
@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_dsbp_matmul_kernel_bit_equal_plain(cuda, m, k, n, folded):
    rng = np.random.default_rng(m + k + n)
    ax = torch.from_numpy(rng.integers(-2047, 2048, (m, k)).astype(np.int32)).to(cuda)
    aw = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(cuda)
    sx = torch.from_numpy(np.exp2(rng.integers(-8, 8, (m, k // 64))).astype(np.float32)).to(cuda)
    sw = torch.from_numpy(np.exp2(rng.integers(-8, 8, (k // 64, n))).astype(np.float32)).to(cuda)
    before = DM.dsbp_matmul.launches
    y = DM.dsbp_matmul(ax, sx, aw, sw, folded=folded)
    torch.cuda.synchronize()
    assert DM.dsbp_matmul.launches == before + 1
    # exact products, and the plain version adds them in the kernel's order
    ref = DM.dsbp_matmul_plain(ax, sx, aw, sw, folded=folded)
    assert torch.equal(y, ref), float((y - ref).abs().max())


def test_two_kernel_path_matches_fused_kernel(cuda):
    pw = Q.pack_weights(torch.from_numpy(_data((600, 192), 4, 2)), _cfg()).to(cuda)
    x = torch.from_numpy(_data((8, 600), 3)).to(cuda)  # K % 64 != 0: padded
    fused = TO.dsbp_matmul_fused(x, pw)
    two = TO.dsbp_matmul_packed(x, pw)
    torch.cuda.synchronize()
    assert float((two - fused).abs().max()) <= 3e-5 * float(fused.abs().max())


@pytest.mark.parametrize("b,hq,hkv,sq,s,causal", [
    (3, 4, 4, 1, 70, True),     # decode at per-row positions
    (2, 4, 2, 40, 40, True),    # GQA prefill-shaped, ragged lengths
    (2, 2, 2, 17, 50, False),   # non-causal
])
def test_packed_flash_attention_kernel(cuda, b, hq, hkv, sq, s, causal):
    g = torch.Generator().manual_seed(b * 100 + s)
    d = 128
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    k = quantize_kv(torch.randn(b, hkv, s, d, generator=g).to(cuda), KV_PRESETS["kv8"])
    v = quantize_kv(torch.randn(b, hkv, s, d, generator=g).to(cuda), KV_PRESETS["kv8"])
    if sq == 1:
        pos = torch.randint(0, s, (b,), generator=g)
        kv_len, q0 = pos + 1, pos
    elif causal:
        kv_len = torch.randint(1, s + 1, (b,), generator=g)
        q0 = torch.zeros(b, dtype=torch.int64)
    else:
        kv_len, q0 = torch.full((b,), s), torch.zeros(b, dtype=torch.int64)
    kv_len, q0 = kv_len.to(cuda, torch.int32), q0.to(cuda, torch.int32)
    before = FA.packed_flash_attention.launches
    o = FA.packed_flash_attention(q, k.qm, k.scale, v.qm, v.scale, kv_len, q0, causal=causal)
    torch.cuda.synchronize()
    assert FA.packed_flash_attention.launches == before + 1
    # one source with B2: the pow2 folds commute with every rounding
    b2 = FA.flash_attention(q, k.dequantize(), v.dequantize(), kv_len, q0, causal=causal)
    assert torch.equal(o, b2), float((o - b2).abs().max())
    ref = FA.packed_flash_attention_plain(q, k.qm, k.scale, v.qm, v.scale, kv_len, q0,
                                          causal=causal)
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
