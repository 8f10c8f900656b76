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
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

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


@pytest.mark.parametrize("b,hq,hkv,sq,bs,mb,window", [
    (4, 4, 4, 1, 16, 8, 0),     # decode, bs 16: whole blocks per 32-key tile
    (3, 4, 2, 1, 4, 12, 0),     # GQA decode, bs 4: a tile spans 8 blocks
    (2, 2, 2, 16, 16, 6, 0),    # a 16-query chunk at q_pos0 > 0
    (2, 4, 2, 9, 3, 11, 7),     # bs 3 (tiles straddle blocks), sliding window
    (2, 2, 1, 1, 1, 40, 0),     # bs 1: one key per block
])
@pytest.mark.parametrize("packed", [False, True], ids=["B6", "B7"])
def test_paged_flash_attention_kernels(cuda, b, hq, hkv, sq, bs, mb, window, packed):
    g = torch.Generator().manual_seed(b * 100 + bs * 10 + mb)
    d, nb = 128, mb * b + 3
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    pk = torch.randn(nb, hkv, bs, d, generator=g).to(cuda)
    pv = torch.randn(nb, hkv, bs, d, generator=g).to(cuda)
    # shuffled tables that share blocks between rows
    table = torch.stack([torch.randperm(nb, generator=g)[:mb] for _ in range(b)])
    table[1:, 0] = table[0, 0]
    table = table.to(cuda, torch.int32)
    s = mb * bs
    kv_len = torch.randint(max(sq, 1), s + 1, (b,), generator=g)  # partial last blocks
    kv_len, q0 = kv_len.to(cuda, torch.int32), (kv_len - sq).to(cuda, torch.int32)
    if packed:
        kq, vq = (quantize_kv(t, KV_PRESETS["kv8"]) for t in (pk, pv))
        args = (q, kq.qm, kq.scale, vq.qm, vq.scale, table, kv_len, q0)
        fn, dense, plain = (FA.paged_packed_flash_attention, FA.packed_flash_attention,
                            FA.paged_packed_flash_attention_plain)
        gathered = [FA.gather_blocks(t, table) for t in (kq.qm, kq.scale, vq.qm, vq.scale)]
    else:
        args = (q, pk, pv, table, kv_len, q0)
        fn, dense, plain = (FA.paged_flash_attention, FA.flash_attention,
                            FA.paged_flash_attention_plain)
        gathered = [FA.gather_blocks(t, table) for t in (pk, pv)]
    before = fn.launches
    o = fn(*args, window=window)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    # one source with B2/B5: only the address of a key's row changes
    ref = dense(q, *gathered, kv_len, q0, window=window)
    assert torch.equal(o, ref), float((o - ref).abs().max())
    torch.testing.assert_close(o, plain(*args, window=window), rtol=1e-5, atol=1e-5)


def test_sharded_call_launches_b1_on_one_rank(cuda):
    """B8 on a mesh of one rank equals its plain version (B1's plain
    version over the whole weight) and B1, bit for bit, and counts its own
    launch beside B1's."""
    from repro_torch.launch.mesh import RankMesh

    cfg = Q.PRESETS["precise"]
    x, ts, ka, kscale, tw = _operands(4, 512, 256, cfg, cuda)
    mesh = RankMesh((1, 1), ("data", "model"), 0, {}, cuda)
    b1, b8 = DF.dsbp_fused.launches, DF.dsbp_fused_sharded_call.launches
    y = DF.dsbp_fused_sharded_call(x, ts, ka, kscale, tw, cfg.input_cfg, mesh, k_axis="model")
    plain = DF.dsbp_fused_plain(x, ts, ka, kscale, tw, cfg.input_cfg)
    ref = DF.dsbp_fused(x, ts, ka, kscale, tw, cfg.input_cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, plain), float((y - plain).abs().max())
    assert torch.equal(y, ref)
    assert DF.dsbp_fused.launches == b1 + 2 and DF.dsbp_fused_sharded_call.launches == b8 + 1


def test_sharded_call_raises_when_b1_cannot_launch(cuda):
    """A CUDA activation with a scale left on the CPU: B1 refuses it, so
    B8 raises (no fallback to the plain version)."""
    cfg = Q.PRESETS["precise"]
    x, ts, ka, kscale, tw = _operands(4, 512, 256, cfg, cuda)
    with pytest.raises(ValueError, match="ts must be"):
        DF.dsbp_fused_sharded_call(x, ts.cpu(), ka, kscale, tw, cfg.input_cfg)


# ---- the Hopper designs: B1's two tiles, B2's two variants ----

def _device_operands(m, k, n, cfg, device, seed):
    """x (M, K) and a weight (K, N) from seeded numpy, packed on the card."""
    pw = Q.pack_weights(torch.from_numpy(_data((k, n), seed + 1, 2)).to(device), cfg)
    x = torch.from_numpy(_data((m, k), seed)).to(device)
    ts = per_tensor_scale(x, cfg.input_cfg.fmt).reshape(1)
    return x, ts, pw.ka, pw.kscale, pw.tscale.reshape(-1).contiguous()


@pytest.mark.parametrize("m,k,n,kw", [
    *[(m, 4096, 4096, {}) for m in (1, 3, 4, 5, 8, 16, 17, 64, 512)],  # both tiles
    (4, 64, 4096, {}), (64, 64, 4096, {}),                 # one group
    (4, 11008, 4096, {}), (64, 11008, 4096, {}),           # w2's 172 groups
    (4, 4096, 44, {}), (17, 4096, 44, {}),                 # N padded to 48
    (4, 4096, 11008, {}), (17, 4096, 11008, {}),           # w1/w3's width
    (4, 4096, 1024, {}), (64, 4096, 1024, {}),             # mixtral-8x7b's wk/wv
    (4, 4096, 4096, {"fmt": "e5m2"}), (64, 4096, 4096, {"fmt": "e5m2"}),
    (4, 4096, 4096, {"mode": "fixed", "k": 0.0, "b_fix": 7}),
    (64, 4096, 4096, {"mode": "fixed", "k": 0.0, "b_fix": 7}),
    (4, 4096, 4096, {"mantissa_rounding": "trunc"}),
    (64, 4096, 4096, {"mantissa_rounding": "trunc"}),
])
def test_dsbp_fused_bit_equal_plain_at_serving_shapes(cuda, m, k, n, kw):
    """B1's decode (M <= 16) and prefill tiles at llama-7b's projection
    widths, every e4m3/e5m2 and fixed/trunc case: bit-equal to the plain
    version (exact integer dots, folds in group order)."""
    cfg = _cfg("precise", **kw)
    x, ts, ka, kscale, tw = _device_operands(m, k, n, cfg, cuda, seed=m + k + n)
    y = DF.dsbp_fused(x, ts, ka, kscale, tw, cfg.input_cfg)
    ref = DF.dsbp_fused_plain(x, ts, ka, kscale, tw, cfg.input_cfg)
    torch.cuda.synchronize()
    assert y.shape == (m, n)
    assert torch.equal(y, ref), float((y - ref).abs().max())


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("cols", [(1000, 1044), (512, 1024), (0, 32)])
def test_dsbp_fused_column_slice_bit_equal(cuda, m, cols):
    """A column slice of the packed weight gives the matching columns of
    the whole product bit for bit: an output's bits do not depend on N or
    the column tiling (B8's column shards)."""
    cfg = _cfg()
    x, ts, ka, kscale, tw = _device_operands(m, 4096, 4096, cfg, cuda, seed=m)
    full = DF.dsbp_fused(x, ts, ka, kscale, tw, cfg.input_cfg)
    a, b = cols
    part = DF.dsbp_fused(x, ts, ka[:, a:b], kscale[:, a:b], tw[a:b], cfg.input_cfg)
    torch.cuda.synchronize()
    assert torch.equal(part, full[:, a:b])


ATT_LENS = [1, FA.KEYS_PER_SPLIT - 1, FA.KEYS_PER_SPLIT, FA.KEYS_PER_SPLIT + 1, 512]


@pytest.mark.parametrize("sq", [1, 3, 16, 17, 64, 130])
@pytest.mark.parametrize("rep,window", [(1, 0), (2, 0), (4, 0), (2, 20)])
def test_attention_variants_against_plain_and_each_other(cuda, sq, rep, window):
    """B2 (decode variant for Sq <= 8, register-tiled above) within 1e-5
    of its plain version on every row with a visible key, at kv_len 1,
    KEYS_PER_SPLIT - 1, KEYS_PER_SPLIT, KEYS_PER_SPLIT + 1 and 512; B6 over
    a shuffled pool equal to B2 over the gathered view, B7 to B5 over the
    gathered packed view and B5 to B2 over the dequantized view, bit for
    bit.  Window 20 leaves whole 128-key splits fully masked."""
    g = torch.Generator().manual_seed(sq * 10 + rep + window)
    b, hkv, d, bs, mb = len(ATT_LENS), 2, 128, 16, 32
    hq, nb = hkv * rep, b * mb + 1
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    pk = torch.randn(nb, hkv, bs, d, generator=g).to(cuda)
    pv = torch.randn(nb, hkv, bs, d, generator=g).to(cuda)
    table = (torch.randperm(nb - 1, generator=g)[:b * mb] + 1).reshape(b, mb)
    table = table.to(cuda, torch.int32)
    kv_len = torch.tensor(ATT_LENS, dtype=torch.int32)
    q0 = torch.clamp(kv_len - sq, min=0)
    kv_len, q0 = kv_len.to(cuda), q0.to(cuda, torch.int32)
    kw = {"causal": True, "window": window}
    k, v = FA.gather_blocks(pk, table), FA.gather_blocks(pv, table)

    o = FA.flash_attention(q, k, v, kv_len, q0, **kw)
    ref = FA.flash_attention_plain(q, k, v, kv_len, q0, **kw)
    o6 = FA.paged_flash_attention(q, pk, pv, table, kv_len, q0, **kw)
    kq, vq = (quantize_kv(t, KV_PRESETS["kv8"]) for t in (pk, pv))
    gq = [FA.gather_blocks(t, table) for t in (kq.qm, kq.scale, vq.qm, vq.scale)]
    o5 = FA.packed_flash_attention(q, *gq, kv_len, q0, **kw)
    o7 = FA.paged_packed_flash_attention(q, kq.qm, kq.scale, vq.qm, vq.scale, table, kv_len,
                                         q0, **kw)
    o2d = FA.flash_attention(q, gq[0].float() * gq[1], gq[2].float() * gq[3], kv_len, q0, **kw)
    ref5 = FA.packed_flash_attention_plain(q, *gq, kv_len, q0, **kw)
    torch.cuda.synchronize()
    vis = FA.attention_mask(kv_len, q0, sq, mb * bs, causal=True, window=window).any(-1)
    vis = vis[:, None].expand(-1, hq, -1)  # (B, Hq, Sq): rows with a visible key
    torch.testing.assert_close(o[vis], ref[vis], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o5[vis], ref5[vis], rtol=1e-5, atol=1e-5)
    assert torch.equal(o6, o), float((o6 - o).abs().max())
    assert torch.equal(o7, o5), float((o7 - o5).abs().max())
    assert torch.equal(o5, o2d), float((o5 - o2d).abs().max())


@pytest.mark.parametrize("sq", [1, 3, 130])
@pytest.mark.parametrize("hkv", [32, 8])
def test_attention_slices_bit_equal(cuda, sq, hkv):
    """A row's bits depend on its keys, kv_len and q_pos0 only: B2 on
    heads [0:16], or on batch rows [2:4], equals the matching slice of the
    whole call bit for bit (the mesh's head split, the data axis's row
    split)."""
    g = torch.Generator().manual_seed(sq + hkv)
    b, hq, s, d = 4, 32, 600, 128
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    k = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    v = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    kv_len = torch.tensor([600, 257, 130, 9], dtype=torch.int32)
    q0 = torch.clamp(kv_len - sq, min=0)
    kv_len, q0 = kv_len.to(cuda), q0.to(cuda, torch.int32)
    full = FA.flash_attention(q, k, v, kv_len, q0)
    kh = 16 // (hq // hkv)
    heads = FA.flash_attention(q[:, :16], k[:, :kh], v[:, :kh], kv_len, q0)
    rows = FA.flash_attention(q[2:4], k[2:4], v[2:4], kv_len[2:4], q0[2:4])
    torch.cuda.synchronize()
    assert torch.equal(heads, full[:, :16])
    assert torch.equal(rows, full[2:4])


# ---- B4 and B3 redesigned; the attention kernels at every head dim ----

def _b4_operands(m, k, n, device, seed):
    rng = np.random.default_rng(seed)
    ax = rng.integers(-2048, 2048, (m, k)).astype(np.int32)
    aw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = np.exp2(rng.integers(-8, 8, (m, k // 64))).astype(np.float32)
    sw = np.exp2(rng.integers(-8, 8, (k // 64, n))).astype(np.float32)
    return [torch.from_numpy(t).to(device) for t in (ax, sx, aw, sw)]


@pytest.mark.parametrize("m,k,n", [
    (1, 4096, 4096), (4, 4096, 11008), (16, 256, 64),     # the decode tile
    (17, 640, 96), (64, 4096, 4096), (65, 11008, 4096),   # the prefill tile, ragged M
    (4, 640, 44), (17, 256, 100), (65, 192, 1000),        # N % 16 != 0
    (4, 11008, 4096), (512, 4096, 11008),                 # llama-7b's shapes
])
def test_dsbp_matmul_tiles_bit_equal_plain_both_forms(cuda, m, k, n):
    """B4 on both tiles (M <= 16 and above, crossing the boundary), at N
    not a multiple of 16: bit-equal to the plain version in both forms, and
    the folded form equal to the unfolded one (one order for both)."""
    ax, sx, aw, sw = _b4_operands(m, k, n, cuda, seed=m + k + n)
    ref = DM.dsbp_matmul_plain(ax, sx, aw, sw)
    out = {folded: DM.dsbp_matmul(ax, sx, aw, sw, folded=folded)
           for folded in (False, True)}
    torch.cuda.synchronize()
    for y in out.values():
        assert y.shape == (m, n)
        assert torch.equal(y, ref), float((y - ref).abs().max())
    assert torch.equal(out[True], out[False])


@pytest.mark.parametrize("m", [1, 3, 17, 33])
@pytest.mark.parametrize("kw", [{}, {"fmt": "e5m2"}, {"fmt": "e2m5"}, {"fmt": "e3m4"},
                                {"mode": "fixed", "k": 0.0, "b_fix": 7},
                                {"mantissa_rounding": "trunc"},
                                {"mode": "dsbp", "k": 2.0, "b_fix": 4}])
def test_fp8_quant_align_ragged_m_every_format_and_mode(cuda, m, kw):
    """B3 (16 lanes per group, two groups a warp) bit-equal to the plain
    version at ragged M, where the last warp's second group is missing, in
    every format and mode."""
    icfg = _cfg("precise", **kw).input_cfg
    x = torch.from_numpy(_data((m, 320), seed=m, spread=8)).to(cuda)
    xs = x * per_tensor_scale(x, icfg.fmt)
    got = QA.fp8_quant_align(xs, icfg)
    torch.cuda.synchronize()
    for g, r in zip(got, QA.fp8_quant_align_plain(xs, icfg)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("m,k,kw", [(4, 4096, {}), (37, 640, {}), (5, 192, {"fmt": "e5m2"}),
                                    (16, 256, {"mode": "fixed", "k": 0.0, "b_fix": 7}),
                                    (9, 256, {"mantissa_rounding": "trunc"})])
def test_fp8_quant_align_equals_b1_scratch(cuda, m, k, kw):
    """B3's outputs are the values B1's input-path kernel writes to its
    scratch: a = 64 * hi + lo and sx = scale / ts, bit for bit (one group
    function, quant_align.cuh)."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import build

    icfg = _cfg("precise", **kw).input_cfg
    f = get_format(icfg.fmt)
    x = torch.from_numpy(_data((m, k), seed=m + k, spread=8)).to(cuda)
    ts = per_tensor_scale(x, icfg.fmt).reshape(1)
    a, s, _ = QA.fp8_quant_align(x * ts, icfg)
    g, n = k // 64, 16
    ka = torch.zeros(k, n, dtype=torch.int8, device=cuda)
    kscale = torch.ones(g, n, device=cuda)
    tw = torch.ones(n, device=cuda)
    y = torch.empty(m, n, device=cuda)
    scratch = torch.empty(m * g * 132, dtype=torch.uint8, device=cuda)
    err = build.load("dsbp_fused")(
        x.data_ptr(), ts.data_ptr(), ka.data_ptr(), kscale.data_ptr(), tw.data_ptr(),
        y.data_ptr(), scratch.data_ptr(), scratch.numel(), m, n, k, f.mbits, f.emin, f.emax,
        f.max_value, int(icfg.mode == "fixed"), float(icfg.k), int(icfg.b_fix),
        int(icfg.mantissa_rounding == "trunc"), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    halves = scratch[:m * g * 128].view(torch.int8).reshape(m, g, 2, 64).to(torch.int32)
    assert torch.equal(halves[:, :, 0] * 64 + halves[:, :, 1], a.reshape(m, g, 64))
    assert torch.equal(scratch[m * g * 128:].view(torch.float32).reshape(m, g), s / ts)


@pytest.mark.parametrize("d", [40, 64, 256, 300, 320, 512])
@pytest.mark.parametrize("hq,hkv,window", [(16, 8, 0),    # gemma3-12b's GQA
                                           (10, 1, 24)])  # recurrentgemma-2b's MQA, windowed
@pytest.mark.parametrize("sq", [1, 3, 130])
def test_attention_every_head_dim(cuda, d, hq, hkv, window, sq):
    """B2 at d_head 40 (not a multiple of 16: the unaligned load path), 64
    and 256 (the second head-dim class), and 300, 320 and 512 (one warp per
    query row; 300 leaves lanes without a last column) within 1e-5 of its
    plain version;
    B6 equal to B2 over the gathered view, B5 to B2 over the dequantized
    cache, B7 to B5 over the gathered packed view, bit for bit; head and
    row slices of B2 bit-equal to the whole call."""
    g = torch.Generator().manual_seed(d * 10 + hq + sq)
    b, bs, mb = len(ATT_LENS), 16, 32
    nb = b * mb + 1
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    pk = torch.randn(nb, hkv, bs, d, generator=g).to(cuda)
    pv = torch.randn(nb, hkv, bs, d, generator=g).to(cuda)
    table = (torch.randperm(nb - 1, generator=g)[:b * mb] + 1).reshape(b, mb)
    table = table.to(cuda, torch.int32)
    kv_len = torch.tensor(ATT_LENS, dtype=torch.int32)
    q0 = torch.clamp(kv_len - sq, min=0)
    kv_len, q0 = kv_len.to(cuda), q0.to(cuda, torch.int32)
    kw = {"causal": True, "window": window}
    k, v = FA.gather_blocks(pk, table), FA.gather_blocks(pv, table)

    o = FA.flash_attention(q, k, v, kv_len, q0, **kw)
    ref = FA.flash_attention_plain(q, k, v, kv_len, q0, **kw)
    o6 = FA.paged_flash_attention(q, pk, pv, table, kv_len, q0, **kw)
    kq, vq = (quantize_kv(t, KV_PRESETS["kv8"]) for t in (pk, pv))
    gq = [FA.gather_blocks(t, table) for t in (kq.qm, kq.scale, vq.qm, vq.scale)]
    o5 = FA.packed_flash_attention(q, *gq, kv_len, q0, **kw)
    o7 = FA.paged_packed_flash_attention(q, kq.qm, kq.scale, vq.qm, vq.scale, table, kv_len,
                                         q0, **kw)
    o2d = FA.flash_attention(q, gq[0].float() * gq[1], gq[2].float() * gq[3], kv_len, q0, **kw)
    rep, kh = hq // hkv, max(1, hkv // 2)
    heads = FA.flash_attention(q[:, :kh * rep], k[:, :kh], v[:, :kh], kv_len, q0, **kw)
    rows = FA.flash_attention(q[2:4], k[2:4], v[2:4], kv_len[2:4], q0[2:4], **kw)
    torch.cuda.synchronize()
    vis = FA.attention_mask(kv_len, q0, sq, mb * bs, causal=True, window=window).any(-1)
    vis = vis[:, None].expand(-1, hq, -1)  # (B, Hq, Sq): rows with a visible key
    torch.testing.assert_close(o[vis], ref[vis], rtol=1e-5, atol=1e-5)
    assert torch.equal(o6, o), float((o6 - o).abs().max())
    assert torch.equal(o5, o2d), float((o5 - o2d).abs().max())
    assert torch.equal(o7, o5), float((o7 - o5).abs().max())
    assert torch.equal(heads, o[:, :kh * rep]) and torch.equal(rows, o[2:4])


def test_attention_head_dim_beyond_shared_memory(cuda):
    """A head dim whose query row and accumulator (8 * D bytes) exceed a
    block's shared memory: the row kernel accumulates in the output row
    itself, within 1e-5 of the plain version, B5 = B2 over the dequantized
    cache and B7 = B5 over the gathered view bit for bit."""
    g = torch.Generator().manual_seed(30000)
    b, hq, hkv, sq, d, bs, mb = 2, 2, 1, 2, 30000, 4, 4
    nb = b * mb + 1
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    pk = torch.randn(nb, hkv, bs, d, generator=g).to(cuda)
    pv = torch.randn(nb, hkv, bs, d, generator=g).to(cuda)
    table = (torch.randperm(nb - 1, generator=g)[:b * mb] + 1).reshape(b, mb)
    table = table.to(cuda, torch.int32)
    kv_len = torch.tensor([16, 7], dtype=torch.int32, device=cuda)
    q0 = kv_len - sq
    k, v = FA.gather_blocks(pk, table), FA.gather_blocks(pv, table)
    o = FA.flash_attention(q, k, v, kv_len, q0)
    ref = FA.flash_attention_plain(q, k, v, kv_len, q0)
    kq, vq = (quantize_kv(t, KV_PRESETS["kv8"]) for t in (pk, pv))
    gq = [FA.gather_blocks(t, table) for t in (kq.qm, kq.scale, vq.qm, vq.scale)]
    o5 = FA.packed_flash_attention(q, *gq, kv_len, q0)
    o7 = FA.paged_packed_flash_attention(q, kq.qm, kq.scale, vq.qm, vq.scale, table, kv_len,
                                         q0)
    o2d = FA.flash_attention(q, gq[0].float() * gq[1], gq[2].float() * gq[3], kv_len, q0)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(o5, o2d) and torch.equal(o7, o5)


# ---- speculative decoding: B1 over draft views; a spec serve on the card ----

@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("k,n", [(512, 256), (640, 96), (1024, 512)])
@pytest.mark.parametrize("bits", [1, 4, 7])
def test_dsbp_fused_over_draft_view_bit_equal_plain(cuda, m, k, n, bits):
    """B1 over a ``draft_view`` container (the draft's M = B rows, the
    verify's B * (spec_k + 1)) equals its plain version bit for bit."""
    from repro_torch.core.packed import draft_view

    cfg = _cfg()
    pw = Q.pack_weights(torch.from_numpy(_data((k, n), k + n, 2)), cfg).to(cuda)
    dv = draft_view(pw, bits)
    x = torch.nn.functional.pad(torch.from_numpy(_data((m, k), m)),
                                (0, pw.padded_k - k)).to(cuda)
    ts = per_tensor_scale(x, cfg.input_cfg.fmt).reshape(1)
    tw = dv.tscale.reshape(-1).contiguous()
    y = DF.dsbp_fused(x, ts, dv.ka, dv.kscale, tw, cfg.input_cfg)
    ref = DF.dsbp_fused_plain(x, ts, dv.ka, dv.kscale, tw, cfg.input_cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, ref), float((y - ref).abs().max())


@pytest.mark.parametrize("paged,kv", [(False, None), (False, "kv8"), (True, None),
                                      (True, "kv8")],
                         ids=["dense-float", "dense-kv8", "paged-float", "paged-kv8"])
def test_spec_serve_card_equals_cpu(cuda, paged, kv):
    """A 2-layer smoke model served speculatively (the draft through B1)
    on the card and on the CPU: the same tokens and the same
    accepted-length histogram, equal to the card's non-speculative
    stream."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    cfg = smoke_config("llama-7b-paper").replace(quant="precise")
    gpu_model = TM.init(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n), max_new_tokens=8)
            for i, n in enumerate([5, 11, 8, 3, 19])]
    scfg = dict(max_len=48, batch_size=2, kv_quant=kv, spec_draft_method="dsbp_fused",
                paged=paged, kv_block_size=4, max_active=3, chunk_prefill_tokens=12,
                kv_draft_bits=6 if kv else None)
    gpu = Engine(gpu_model, ServeConfig(spec_k=3, **scfg), device=cuda)  # packs on the card
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), ServeConfig(spec_k=3, **scfg),
                 device="cpu")
    out, hist = {}, {}
    for name, eng in (("cpu", cpu), ("gpu", gpu)):
        out[name] = eng.serve(reqs)
        hist[name] = eng.last_stats["accepted_hist"]
    base = Engine(gpu.model, ServeConfig(**dict(scfg, kv_draft_bits=None)), device=cuda)
    plain = base.serve(reqs)
    for uid in plain:
        np.testing.assert_array_equal(out["gpu"][uid], out["cpu"][uid])
        np.testing.assert_array_equal(out["gpu"][uid], plain[uid])
    assert hist["gpu"] == hist["cpu"]


# ---- the policy loop's configs: every ladder rung, kv4 and kv6 ----

def _ladder_rungs():
    from repro_torch.policy.cost import candidate_ladder, input_bitwidth_ladder

    return input_bitwidth_ladder((6, 4, 3, 2)) + candidate_ladder()


@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("rung", range(8), ids=lambda i: _ladder_rungs()[i][0])
def test_dsbp_fused_bit_equal_plain_at_every_ladder_rung(cuda, m, rung):
    """B1 under each rung the autotuner serves (inputs at B_fix 6/4/3/2
    against weights packed at B_fix 7; Table I's precise / efficient and
    the balanced / aggressive points), at decode and prefill, K=4096:
    the kernel carries the rung's k, B_fix and mode, bit-equal to plain."""
    name, cfg = _ladder_rungs()[rung]
    x, ts, ka, kscale, tw = _device_operands(m, 4096, 4096, cfg, cuda, seed=m + rung)
    y = DF.dsbp_fused(x, ts, ka, kscale, tw, cfg.input_cfg)
    ref = DF.dsbp_fused_plain(x, ts, ka, kscale, tw, cfg.input_cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, ref), (name, float((y - ref).abs().max()))


@pytest.mark.parametrize("kv", ["kv4", "kv6"])
@pytest.mark.parametrize("sq,hkv", [(1, 4), (1, 2), (17, 2)])
def test_packed_attention_at_narrow_kv_bits(cuda, kv, sq, hkv):
    """B5 over a kv4 / kv6 cache equals B2 over its dequantize() bit for
    bit, and B7 over the same entries in a block pool equals B5 over the
    gathered view: the packed load is bits-agnostic (int8 mantissa times a
    pow2 scale)."""
    g = torch.Generator().manual_seed(len(kv) * 10 + sq + hkv)
    b, hq, d, bs, mb = 3, 4, 128, 16, 6
    s = bs * mb
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    k = quantize_kv(torch.randn(b, hkv, s, d, generator=g).to(cuda), KV_PRESETS[kv])
    v = quantize_kv(torch.randn(b, hkv, s, d, generator=g).to(cuda), KV_PRESETS[kv])
    kv_len = torch.randint(sq, s + 1, (b,), generator=g)
    kv_len, q0 = kv_len.to(cuda, torch.int32), (kv_len - sq).to(cuda, torch.int32)
    o = FA.packed_flash_attention(q, k.qm, k.scale, v.qm, v.scale, kv_len, q0)
    b2 = FA.flash_attention(q, k.dequantize(), v.dequantize(), kv_len, q0)
    torch.cuda.synchronize()
    assert torch.equal(o, b2), float((o - b2).abs().max())
    torch.testing.assert_close(o, FA.packed_flash_attention_plain(
        q, k.qm, k.scale, v.qm, v.scale, kv_len, q0), rtol=1e-5, atol=1e-5)
    # the same entries scattered over a shuffled block pool (B7)
    nb = b * mb + 2
    # distinct blocks per row: each row's entries land in blocks of its own
    table = torch.randperm(nb, generator=g)[:b * mb].reshape(b, mb)
    pools = []
    for t in (k.qm, k.scale, v.qm, v.scale):
        pool = torch.zeros((nb, hkv, bs, t.shape[-1]), dtype=t.dtype)
        for r in range(b):
            pool[table[r]] = t[r].cpu().reshape(hkv, mb, bs, -1).transpose(0, 1)
        pools.append(pool.to(cuda))
    table = table.to(cuda, torch.int32)
    o7 = FA.paged_packed_flash_attention(q, *pools, table, kv_len, q0)
    gathered = [FA.gather_blocks(t, table) for t in pools]
    o5 = FA.packed_flash_attention(q, *gathered, kv_len, q0)
    torch.cuda.synchronize()
    assert torch.equal(o7, o5), float((o7 - o5).abs().max())
    assert torch.equal(o5, o)


# ---- the numeric guard and quantization health on the card ----

def test_guard_finite_flags_card_equals_cpu(cuda):
    """The guard's reduction on the card, against isfinite().all() on the
    CPU: NaN, +-inf, huge finite values and the -1e30 padded-vocab mask."""
    from repro_torch.kernels.ops import finite_flags

    x = torch.from_numpy(_data((9, 32000), seed=7, spread=20))
    x[1, 5], x[2, 31999], x[3, 0], x[4, 17] = float("nan"), float("inf"), -float("inf"), 3e38
    x[5, 31000:] = -1e30
    want = torch.isfinite(x).all(-1)
    assert torch.equal((finite_flags(x.to(cuda)) == 0).cpu(), want)
    assert want.tolist() == [True, False, False, False, True, True, True, True, True]


@pytest.mark.parametrize("paged,policy", [(False, "quarantine"), (True, "quarantine"),
                                          (False, "fallback"), (True, "fallback")])
def test_guarded_serve_card_equals_cpu(cuda, paged, policy):
    """The engine's guard end to end on a 2-layer smoke model: the same
    NaN plan on the card and on the CPU gives the same statuses, counters
    and streams (the verdict crosses to the host in the tokens' copy)."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    from repro_torch.serve.faults import FaultPlan

    cfg = smoke_config("llama-7b-paper").replace(quant="precise")
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n), max_new_tokens=8)
            for i, n in enumerate([5, 11, 8, 3])]
    scfg = ServeConfig(max_len=32, batch_size=3, paged=paged, kv_block_size=4,
                       numeric_guard=policy, observe=True)
    gpu = Engine(TM.init(cfg, seed=0, device=cuda), scfg, device=cuda)
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
    res = {}
    for name, eng in (("cpu", cpu), ("gpu", gpu)):
        out = eng.serve(reqs, faults=FaultPlan(nan_steps={1: (0,), 3: (1, 2)}))
        st = eng.last_stats
        res[name] = (out, st["request_status"], st["guard_checks"], st["numeric_faults"],
                     st["fallback_steps"], eng.obs.trace.signature())
    for uid in res["cpu"][0]:
        np.testing.assert_array_equal(res["gpu"][0][uid], res["cpu"][0][uid])
    assert res["gpu"][1:] == res["cpu"][1:]
    assert res["gpu"][3] > 0


@pytest.mark.parametrize("tscale", [None, 2.0 ** 12])
def test_quant_sat_stats_card_equals_cpu(cuda, tscale):
    x = torch.from_numpy(_data((257, 128), seed=5, spread=12))
    x[0, 0], x[1, 1] = float("nan"), float("inf")
    assert TO.quant_sat_stats(x.to(cuda), "e5m7", tscale=tscale) == \
        TO.quant_sat_stats(x, "e5m7", tscale=tscale)


@pytest.mark.parametrize("kv", [None, "kv8"])
def test_sample_cache_card_equals_cpu(cuda, kv):
    """QuantHealth.sample_cache over a smoke model's cache on the card and
    over the same cache on the CPU (two samples, the second scaled so the
    frozen scale overflows): equal snapshots, the histogram built by
    bincount on each device."""
    from repro_torch.configs import smoke_config
    from repro_torch.kvq import PackedKVBlock
    from repro_torch.models import model as TM
    from repro_torch.obs import QuantHealth

    model = TM.init(smoke_config("llama-7b-paper"), seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (3, 12))).to(cuda)
    with torch.inference_mode():
        _, cache, _ = model.prefill(toks, 32, kv=kv)

    def moved(c, dev, scale=1.0):
        def leaf(x):
            if isinstance(x, PackedKVBlock):
                return PackedKVBlock(x.qm.to(dev), x.scale.to(dev) * scale, bits=x.bits,
                                     fmt=x.fmt)
            return x.to(dev) * scale
        return [{n: leaf(layer[n]) for n in ("k", "v")} for layer in c]

    snaps = []
    for dev in (cuda, torch.device("cpu")):
        qh = QuantHealth()
        for scale in (1.0, 4096.0):
            qh.sample_cache(model.cache_tree(moved(cache, dev, scale)))
        snaps.append(qh.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["entries"]["units.0"]["overflow"] > 0


# ---- the Griffin hybrid: wrapped rings, windowed prefill at its shape ----

@pytest.mark.parametrize("kernel", ["B2", "B5", "B6", "B7"])
@pytest.mark.parametrize("hq,hkv,d", [(10, 1, 256), (4, 2, 128)])
def test_decode_past_a_wrapped_ring_equals_kv_len_s(cuda, kernel, hq, hkv, d):
    """A ring decode passes kv_len = pos + 1 > S once the ring wraps; every
    decode variant reads it as S (its key loop and its partials are bounded
    by S), bit for bit."""
    g = torch.Generator().manual_seed(hq * 10 + d)
    b, bs, mb = 3, 16, 8
    s = bs * mb
    q = torch.randn(b, hq, 1, d, generator=g).to(cuda)
    k = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    v = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    pos = torch.tensor([s - 1, s + 5, 3 * s + 17], dtype=torch.int32, device=cuda)
    if kernel in ("B5", "B7"):
        kq, vq = (quantize_kv(t, KV_PRESETS["kv8"]) for t in (k, v))
        ops = (kq.qm, kq.scale, vq.qm, vq.scale)
    else:
        ops = (k, v)
    if kernel in ("B6", "B7"):
        nb = b * mb + 1
        table = (torch.randperm(nb - 1, generator=g)[: b * mb] + 1).reshape(b, mb)
        table = table.to(cuda, torch.int32)
        flat = table.to(torch.int64).reshape(-1)

        def pool(x):
            p = torch.zeros((nb, x.shape[1], bs, x.shape[-1]), dtype=x.dtype, device=cuda)
            p[flat] = x.reshape(b, x.shape[1], mb, bs, x.shape[-1]).permute(
                0, 2, 1, 3, 4).reshape(-1, x.shape[1], bs, x.shape[-1])
            return p

        ops = (*(pool(t) for t in ops), table)
    fn = {"B2": FA.flash_attention, "B5": FA.packed_flash_attention,
          "B6": FA.paged_flash_attention, "B7": FA.paged_packed_flash_attention}[kernel]
    full = torch.full_like(pos, s)
    o_wrapped = fn(q, *ops, pos + 1, pos)
    o_s = fn(q, *ops, full, pos)
    torch.cuda.synchronize()
    assert torch.equal(o_wrapped, o_s)
    plain = {"B2": FA.flash_attention_plain, "B5": FA.packed_flash_attention_plain,
             "B6": FA.paged_flash_attention_plain,
             "B7": FA.paged_packed_flash_attention_plain}[kernel]
    torch.testing.assert_close(o_s, plain(q, *ops, full, pos), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,lens", [(300, [300, 211, 64]), (130, [130, 1, 97])])
def test_windowed_prefill_at_the_hybrid_shape(cuda, sq, lens):
    """B2's prefill with a sliding window at recurrentgemma-2b's heads (Hq
    10, Hkv 1, D 256), ragged rows, against its plain version."""
    g = torch.Generator().manual_seed(sq)
    b, hq, hkv, d, window = len(lens), 10, 1, 256, 64
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    k = torch.randn(b, hkv, sq, d, generator=g).to(cuda)
    v = torch.randn(b, hkv, sq, d, generator=g).to(cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q0 = torch.zeros(b, dtype=torch.int32, device=cuda)
    o = FA.flash_attention(q, k, v, kv_len, q0, window=window)
    ref = FA.flash_attention_plain(q, k, v, kv_len, q0, window=window)
    torch.cuda.synchronize()
    for i, n in enumerate(lens):  # queries past a row's length are pad: not compared
        torch.testing.assert_close(o[i, :, :n], ref[i, :, :n], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_hybrid_serve_card_equals_cpu(cuda, paged):
    """Smoke recurrentgemma-2b at window 16 (rings wrap), packed "precise",
    served on the card and on the CPU: the same tokens."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    cfg = smoke_config("recurrentgemma-2b").replace(quant="precise", window=16)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n), max_new_tokens=6)
            for i, n in enumerate([30, 11, 23, 5, 19])]
    scfg = ServeConfig(max_len=48, batch_size=2, paged=paged, kv_block_size=4,
                       max_active=3, chunk_prefill_tokens=24)
    gpu = Engine(TM.init(cfg, seed=0, device=cuda), scfg, device=cuda)
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
    a, b = gpu.serve(reqs), cpu.serve(reqs)
    for uid in b:
        np.testing.assert_array_equal(a[uid], b[uid])


# ---- the MoE family: mixtral-8x7b ----

def test_streamed_packed_init_bit_equal_at_full_width(cuda):
    """mixtral-8x7b at full width and 2 layers: ``init(pack=)``, drawn and
    packed one layer at a time, equals ``init`` followed by
    ``pack_weights_int8`` on the card, every parameter and container
    child bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import pack_weights_int8

    cfg = get_config("mixtral-8x7b").replace(n_layers=2)
    want = TM.init(cfg, seed=7, device=cuda)
    pack_weights_int8(want, "precise")
    want = {n: t.cpu() for n, t in list(want.named_parameters()) + list(want.named_buffers())}
    torch.cuda.empty_cache()
    got = TM.init(cfg, seed=7, device=cuda, pack="precise")
    got = list(got.named_parameters()) + list(got.named_buffers())
    assert [n for n, _ in got] == list(want)
    for name, t in got:
        assert torch.equal(t.cpu(), want[name]), name


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_moe_serve_card_equals_cpu(cuda, paged):
    """Smoke mixtral-8x7b at window 8 (rings wrap), packed "precise",
    served on the card and on the CPU: the same tokens."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    cfg = smoke_config("mixtral-8x7b").replace(quant="precise", window=8)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n), max_new_tokens=6)
            for i, n in enumerate([6, 14, 10, 12, 9])]
    scfg = ServeConfig(max_len=24, batch_size=2, prefill_bucket=8, paged=paged,
                       kv_block_size=4)
    gpu = Engine(TM.init(cfg, seed=0, device=cuda, pack="precise"), scfg, device=cuda)
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
    a, b = gpu.serve(reqs), cpu.serve(reqs)
    for uid in b:
        np.testing.assert_array_equal(a[uid], b[uid])


# ---- the SSD family: mamba2-370m ----

@pytest.mark.parametrize("m", [1, 4, 16, 17, 512, 2048])
@pytest.mark.parametrize("k,n", [(1024, 4384), (2048, 1024)], ids=["w_in", "w_out"])
def test_dsbp_fused_bit_equal_plain_at_ssd_shapes(cuda, m, k, n):
    """B1 at mamba2-370m's projections, decode (M <= 16) and prefill
    tiles: w_in's N = 4,384 is a multiple of 32 but not of 128, so the
    prefill tile ends in a partial column block of 32.  Bit-equal to the
    plain version."""
    cfg = _cfg("precise")
    x, ts, ka, kscale, tw = _device_operands(m, k, n, cfg, cuda, seed=m + k + n)
    y = DF.dsbp_fused(x, ts, ka, kscale, tw, cfg.input_cfg)
    ref = DF.dsbp_fused_plain(x, ts, ka, kscale, tw, cfg.input_cfg)
    torch.cuda.synchronize()
    assert y.shape == (m, n)
    assert torch.equal(y, ref), float((y - ref).abs().max())


def test_ssd_decode_step_card_equals_cpu_at_full_width(cuda):
    """mamba2-370m at full width and 2 layers, packed "precise": a ragged
    prefill (a 128-token chunk) and two decode steps on the card (B1) and
    on the CPU (plain versions): logits within 0.1 of max|logit| (phase
    9's rule in chip_smoke.py) and the greedy tokens equal unless the top-2
    gap is below max(1e-3 * max|logit|, twice the logit difference)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    cfg = get_config("mamba2-370m").replace(n_layers=2, quant="precise")
    gpu = TM.init(cfg, seed=21, device=cuda, pack="precise")
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.default_rng(21)
    lens = np.asarray([128, 37, 90, 5], np.int32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 128)))
    fed = []  # the card's greedy tokens, fed to both (the same contexts)
    with torch.inference_mode():
        outs = []
        for model, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
            lg, cache, _ = model.prefill(toks.to(dev), 256, lengths=lens)
            rows = [lg[:, -1].float().cpu()]
            for t in range(2):
                if len(fed) <= t:
                    fed.append(torch.argmax(rows[-1], dim=-1))
                lg, cache = model.decode_step(fed[t][:, None].to(dev), cache,
                                              torch.from_numpy(lens + t).to(dev))
                rows.append(lg[:, -1].float().cpu())
            outs.append(torch.stack(rows, dim=1))
    a, b = outs
    top = a.abs().amax(-1)
    delta = (a - b).abs().amax(-1)
    assert torch.all(delta <= 0.1 * top), (delta / top).max()
    top2 = torch.topk(a, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = a.argmax(-1) != b.argmax(-1)
    assert torch.all(~differ | (gap < torch.maximum(1e-3 * top, 2 * delta)))


# ---- the modality frontends: musicgen-large (MHA, d_head 64) and
# llava-next-34b (GQA 56 : 8 and its 20,480-wide FFN) ----

@pytest.mark.parametrize("m", [2, 4, 64])
@pytest.mark.parametrize("k,n", [(7168, 20480), (20480, 7168), (2048, 8192)],
                         ids=["llava_w1", "llava_w2", "musicgen_w1"])
def test_dsbp_fused_bit_equal_plain_at_frontend_shapes(cuda, m, k, n):
    """B1 at llava-next-34b's FFN (w1 / w3 K=7168 N=20480, w2 K=20480
    N=7168: 320 groups) and musicgen-large's (K=2048 N=8192), at llava's
    decode M 2, musicgen's 4 and a prefill tile: bit-equal to plain."""
    cfg = _cfg("precise")
    x, ts, ka, kscale, tw = _device_operands(m, k, n, cfg, cuda, seed=m + k + n)
    y = DF.dsbp_fused(x, ts, ka, kscale, tw, cfg.input_cfg)
    ref = DF.dsbp_fused_plain(x, ts, ka, kscale, tw, cfg.input_cfg)
    torch.cuda.synchronize()
    assert y.shape == (m, n)
    assert torch.equal(y, ref), float((y - ref).abs().max())


@pytest.mark.parametrize("hq,hkv,d,sq,lens", [
    (56, 8, 128, 1, [300, 129]),        # llava's GQA (ratio 7), decode
    (56, 8, 128, 300, [300, 131]),      # the same, a ragged prefill
    (32, 32, 64, 1, [300, 17]),         # musicgen's MHA at d_head 64, decode
], ids=["gqa7-decode", "gqa7-prefill", "mha-d64-decode"])
def test_attention_at_frontend_head_layouts(cuda, hq, hkv, d, sq, lens):
    """B2 within 1e-5 of its plain version, B5 over a kv8 cache bit-equal
    to B2 over its dequantized view and within 1e-5 of its own plain
    version, at the frontends' head layouts."""
    g = torch.Generator().manual_seed(hq + hkv + d + sq)
    b, s = len(lens), 300
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    k = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    v = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q0 = (kv_len - 1) if sq == 1 else torch.zeros_like(kv_len)
    o = FA.flash_attention(q, k, v, kv_len, q0)
    ref = FA.flash_attention_plain(q, k, v, kv_len, q0)
    kq, vq = (quantize_kv(t, KV_PRESETS["kv8"]) for t in (k, v))
    o5 = FA.packed_flash_attention(q, kq.qm, kq.scale, vq.qm, vq.scale, kv_len, q0)
    o2d = FA.flash_attention(q, kq.dequantize(), vq.dequantize(), kv_len, q0)
    ref5 = FA.packed_flash_attention_plain(q, kq.qm, kq.scale, vq.qm, vq.scale, kv_len, q0)
    torch.cuda.synchronize()
    vis = FA.attention_mask(kv_len, q0, sq, s, causal=True, window=0).any(-1)
    vis = vis[:, None].expand(-1, hq, -1)  # rows with a visible key (pad queries have none)
    torch.testing.assert_close(o[vis], ref[vis], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o5[vis], ref5[vis], rtol=1e-5, atol=1e-5)
    assert torch.equal(o5, o2d), float((o5 - o2d).abs().max())


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_frontend_generate_card_equals_cpu(cuda, arch):
    """Smoke musicgen-large ((B, L, K) prompts, (B, n, K) frames) and
    llava-next-34b (image embeddings in ``extra``), packed "precise",
    ragged: ``Engine.generate`` on the card (B1, B2) and on the CPU (plain
    versions) gives equal tokens."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = smoke_config(arch).replace(quant="precise")
    gpu = TM.init(cfg, seed=4, device=cuda, pack="precise")
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.default_rng(4)
    lens = np.asarray([12, 5, 9], np.int32)
    shape = (3, 12) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    toks = rng.integers(0, cfg.vocab_size, shape)
    extra = None
    if cfg.n_image_tokens:
        extra = {"image_embeds": rng.standard_normal(
            (3, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}
    outs = []
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        eng = Engine(model, ServeConfig(max_len=48), device=dev)
        outs.append(eng.generate(toks, 4, extra=extra, lengths=lens))
    assert outs[0].shape == (3, 4) + shape[2:]
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# bfloat16: the attention kernels' bf16 instantiation, and a bf16 model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128, 200, 256, 320, 30000])
@pytest.mark.parametrize("sq", [1, 3, 130])
@pytest.mark.parametrize("packed,paged", [(False, False), (True, False), (False, True),
                                          (True, True)], ids=["B2", "B5", "B6", "B7"])
def test_bf16_attention_equals_f32_kernel_on_upcasts(cuda, d, sq, packed, paged):
    """bf16 q (and float K/V, pools) launch the bf16 instantiation, whose
    output is the f32 kernel's on the exact upcasts rounded once, bit for
    bit, at every variant (decode, prefill, the row kernel, beyond shared
    memory) and a head dim off the 16-column grid; within 2**-6 of
    max|out| of the plain version (which rounds q * d**-0.5 to bf16)."""
    if d == 30000 and sq == 130:
        pytest.skip("the beyond-shared-memory row kernel is held at sq 1 and 3")
    gen = torch.Generator(device="cuda").manual_seed(d + sq)
    b, hq, hkv, bs = 2, 4, 2, 8
    mb = -(-(sq + 10) // bs)  # every query row sees a key (kv_len - sq >= 1)
    s = bs * mb
    q = torch.randn(b, hq, sq, d, generator=gen, device=cuda).to(torch.bfloat16)
    kv_len = torch.tensor([s, s - 9], dtype=torch.int32, device=cuda)
    q0 = kv_len - sq
    shape = (b * mb + 1, hkv, bs, d) if paged else (b, hkv, s, d)
    k = torch.randn(*shape, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(*shape, generator=gen, device=cuda).to(torch.bfloat16)
    if packed:
        k, v = (quantize_kv(t, KV_PRESETS["kv8"]) for t in (k, v))
        kv = (k.qm, k.scale, v.qm, v.scale)
    else:
        kv = (k, v)
    table = (torch.arange(1, b * mb + 1, dtype=torch.int32, device=cuda).reshape(b, mb),)
    fn, plain = {(False, False): (FA.flash_attention, FA.flash_attention_plain),
                 (True, False): (FA.packed_flash_attention, FA.packed_flash_attention_plain),
                 (False, True): (FA.paged_flash_attention, FA.paged_flash_attention_plain),
                 (True, True): (FA.paged_packed_flash_attention,
                                FA.paged_packed_flash_attention_plain)}[(packed, paged)]
    args = (q, *kv, *(table if paged else ()), kv_len, q0)
    up = tuple(t.float() if t.dtype == torch.bfloat16 else t for t in args)
    before = fn.bf16_launches
    o = fn(*args)
    o32 = fn(*up)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert fn.bf16_launches == before + 1 and o.dtype == torch.bfloat16
    assert torch.equal(o, o32.to(torch.bfloat16))
    err = float((o.float() - ref.float()).abs().max())
    assert err <= 2 ** -6 * float(ref.float().abs().max()), err


def test_bf16_attention_refuses_mixed_dtypes(cuda):
    q = torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, 2, 8, 64, device=cuda)
    n = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        FA.flash_attention(q, k, k, n, n - 1)


@pytest.mark.parametrize("arch", ["llama-7b-paper", "recurrentgemma-2b", "mamba2-370m"])
def test_bf16_smoke_generate_card_equals_cpu(cuda, arch):
    """A packed bf16 smoke model: the card's greedy tokens equal the CPU's
    (plain versions) up to a near tie of 8 bf16 ulps of max|logit|."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = smoke_config(arch).replace(dtype="bfloat16", quant="precise")
    model = TM.init(cfg, seed=3, device="cpu", pack="precise")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 12))
    lens = np.asarray([12, 5, 9])
    outs, logits = [], []
    for dev, m in (("cpu", model), ("cuda", TM.shared(model).to(cuda))):
        eng = Engine(m, ServeConfig(max_len=32), device=dev)
        outs.append(eng.generate(toks, 5, lengths=lens))
        with torch.inference_mode():
            lg, _, _ = eng.model.prefill(torch.as_tensor(toks, device=dev), 32, lengths=lens,
                                         quant=eng.quant)
        logits.append(lg.float().cpu())
    assert logits[1].isfinite().all()
    top = float(logits[0].abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float((logits[0] - logits[1]).abs().max()) <= 16 * ulp
    for r in range(3):
        bad = np.flatnonzero(outs[0][r] != outs[1][r])
        if bad.size:  # a divergence only after a first token within a near tie
            assert bad[0] > 0 or float(logits[0][r, -1].topk(2).values.diff().abs()) <= 8 * ulp


# ---------------- training: the kernel Functions' gradients ----------------

@pytest.mark.parametrize("b,hq,hkv,s,d,lens,window", [
    (2, 4, 2, 40, 32, (40, 17), 0),         # GQA, ragged
    (3, 4, 4, 70, 128, (70, 33, 1), 0),     # MHA, a one-key row
    (2, 8, 2, 64, 64, (64, 50), 16),        # GQA with a window
    (1, 2, 1, 129, 256, (129,), 0),         # d_head 256
    (1, 10, 1, 80, 256, (80,), 32),         # recurrentgemma-2b's MQA past a window
    (1, 14, 2, 96, 128, (96,), 0),          # llava-next-34b's GQA 7
    (2, 4, 4, 64, 64, (64, 40), 0),         # musicgen-large's MHA at d_head 64
])
def test_flash_attention_grad_on_the_card(cuda, b, hq, hkv, s, d, lens, window):
    """B2's autograd function on the card: its forward is one B2 launch
    within 1e-5 of the plain version, and q / k / v gradients within 1e-5
    of the plain version's autograd on the card and of the CPU's."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q0 = torch.zeros(b, dtype=torch.int32, device=cuda)
    g = torch.from_numpy(rng.standard_normal((b, hq, s, d)).astype(np.float32)).to(cuda)
    g = g * (torch.arange(s, device=cuda)[None, None, :, None] < kv_len[:, None, None, None])
    out = {}
    for name, dev, fn in (("kernel", cuda, FA.flash_attention_grad),
                          ("plain", cuda, FA.flash_attention_plain),
                          ("cpu", "cpu", FA.flash_attention_grad)):
        qkv = [t.to(dev).clone().requires_grad_(True) for t in (q, k, v)]
        before = FA.flash_attention.launches
        o = fn(*qkv, kv_len.to(dev), q0.to(dev), causal=True, window=window)
        assert FA.flash_attention.launches - before == (name == "kernel")
        out[name] = [t.cpu() for t in (o.detach(), *torch.autograd.grad(o, qkv, g.to(dev)))]
    for ref in ("plain", "cpu"):
        for got, want in zip(out["kernel"], out[ref]):
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), ref


@pytest.mark.parametrize("method", ["dsbp_fused", "dsbp_kernel"])
@pytest.mark.parametrize("m,k,n", [(4, 512, 256), (37, 640, 96), (64, 250, 48)])
def test_ste_products_on_the_card(cuda, method, m, k, n):
    """The straight-through QAT products on the card: the forward is the
    method's kernels (one launch of each) and bit-equal
    to the same product on the CPU's plain versions; gx / gw within 1e-6
    of the CPU's."""
    from repro_torch.core.packed import get_quant_method

    cfg = Q.PRESETS["precise"]
    x = torch.from_numpy(_data((m, k), m))
    w = torch.from_numpy(_data((k, n), m + 1, 2)) * k ** -0.5
    gy = torch.from_numpy(_data((m, n), m + 2, 1))
    kernels = {"dsbp_fused": [DF.dsbp_fused],
               "dsbp_kernel": [QA.fp8_quant_align, DM.dsbp_matmul]}[method]
    res = {}
    for dev in (cuda, torch.device("cpu")):
        xs, ws = x.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
        before = [f.launches for f in kernels]
        y = get_quant_method(method).apply(ws, xs, cfg)
        if dev.type == "cuda":
            assert [f.launches - b for f, b in zip(kernels, before)] == [1] * len(kernels)
        res[dev.type] = [t.cpu() for t in (y.detach(), *torch.autograd.grad(y, (xs, ws),
                                                                          gy.to(dev)))]
    (y, gx, gw), (yc, gxc, gwc) = res["cuda"], res["cpu"]
    assert torch.equal(y, yc), float((y - yc).abs().max())
    for got, want in ((gx, gxc), (gw, gwc)):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mixtral-8x7b", "mamba2-370m",
                                  "musicgen-large", "llava-next-34b"])
def test_family_train_step_card_equals_cpu(cuda, arch):
    """One float train step of each non-dense family's smoke config on the
    card (B2's autograd function, no quantization) and on the CPU (plain
    versions) from the same weights and batch: the loss within 1e-6 and
    every gradient within 1e-5 of its norm (f32 products and reductions in
    another order)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import make_batch_np
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw

    cfg = smoke_config(arch)
    batch = make_batch_np(cfg, 2, 32, seed=3)
    out = {}
    for dev in ("cpu", cuda):
        model = TM.init(cfg, seed=3, device="cpu").to(dev)
        p = adamw.trainable(model)
        loss, _ = TM.loss_fn(model, batch)
        out[str(dev)] = (float(loss), [g.cpu() for g in torch.autograd.grad(loss, list(
            p.values()))])
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-6 * abs(lc)
    for a, b in zip(gg, gc):
        assert float(torch.linalg.vector_norm(a - b)) <= 1e-5 * float(torch.linalg.vector_norm(b))


# ---- the copied configs and the eleventh: yi-9b (GQA 32 : 4), phi3-medium-14b
# (40 : 10, d 5,120), deepseek-coder-33b (d_ff 19,200), grok-1-314b (48 : 8) ----

@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("k,n", [(4096, 512), (5120, 5120), (5120, 1280), (5120, 17920),
                                 (17920, 5120), (7168, 19200), (19200, 7168), (6144, 6144),
                                 (6144, 1024)],
                         ids=["yi_wk", "phi3_wq", "phi3_wk", "phi3_w1", "phi3_w2",
                              "deepseek_w1", "deepseek_w2", "grok_wq", "grok_wk"])
def test_dsbp_fused_bit_equal_plain_at_config_shapes(cuda, m, k, n):
    """B1 at every (K, N) of the copied configs and grok that no other case
    holds, at the decode M 4 and the prefill tile's M 512: bit-equal to
    plain."""
    cfg = _cfg("precise")
    x, ts, ka, kscale, tw = _device_operands(m, k, n, cfg, cuda, seed=m + k + n)
    y = DF.dsbp_fused(x, ts, ka, kscale, tw, cfg.input_cfg)
    ref = DF.dsbp_fused_plain(x, ts, ka, kscale, tw, cfg.input_cfg)
    torch.cuda.synchronize()
    assert y.shape == (m, n)
    assert torch.equal(y, ref), float((y - ref).abs().max())


@pytest.mark.parametrize("hq,hkv", [(48, 8), (32, 4), (40, 10)],
                         ids=["grok-48:8", "yi-32:4", "phi3-40:10"])
@pytest.mark.parametrize("sq,lens", [(1, [300, 129, 17]), (300, [300, 131, 64])],
                         ids=["decode", "prefill"])
def test_attention_at_config_head_layouts(cuda, hq, hkv, sq, lens):
    """B2 at the new GQA ratios (6, 8 and 4, with 10 KV heads) and D 128:
    within 1e-5 of its plain version, and a head slice bit-equal to the
    whole call."""
    g = torch.Generator().manual_seed(hq + hkv + sq)
    b, s, d = len(lens), 300, 128
    q = torch.randn(b, hq, sq, d, generator=g).to(cuda)
    k = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    v = torch.randn(b, hkv, s, d, generator=g).to(cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q0 = (kv_len - 1) if sq == 1 else torch.zeros_like(kv_len)
    o = FA.flash_attention(q, k, v, kv_len, q0)
    ref = FA.flash_attention_plain(q, k, v, kv_len, q0)
    kh = hkv // 2
    heads = FA.flash_attention(q[:, :kh * hq // hkv], k[:, :kh], v[:, :kh], kv_len, q0)
    torch.cuda.synchronize()
    vis = FA.attention_mask(kv_len, q0, sq, s, causal=True, window=0).any(-1)
    vis = vis[:, None].expand(-1, hq, -1)  # rows with a visible key (pad queries have none)
    torch.testing.assert_close(o[vis], ref[vis], rtol=1e-5, atol=1e-5)
    assert torch.equal(heads, o[:, :kh * hq // hkv])


def test_circuit_models_card_equal_cpu(cuda):
    """The MPU, the FIAU's barrel reference and the MAC array on CUDA
    tensors equal the CPU's, integer for integer."""
    from repro_torch.core import dsbp as D
    from repro_torch.core import fiau as FI
    from repro_torch.core import mac_array as MA
    from repro_torch.core import mpu as MPU
    from repro_torch.core.formats import decompose

    x = torch.from_numpy(_data((64, 1024), 7))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        d = decompose(x.to(dev), "e4m3")
        sign, e, m = (D.group_reshape(d[key], 64) for key in ("sign", "e_unb", "m_int"))
        shift, _, nz = D.group_shifts(e, m)
        b = MPU.mpu_predict(shift, nz, 32, 4)
        fiau = FI.barrel_align(sign * m, shift, 5, b[..., None].clamp(1, 11) + 1)
        w = torch.from_numpy(np.random.default_rng(3).integers(-32, 32, (64, 40))).to(dev)
        mac = MA.mac_array_matmul(fiau[:, 0], w, 6)
        res[dev.type] = [t.cpu() for t in (b, fiau, mac)]
    for got, want in zip(res["cuda"], res["cpu"]):
        assert torch.equal(got, want)
    assert torch.equal(res["cpu"][2].long(), res["cpu"][1][:, 0] @ torch.from_numpy(
        np.random.default_rng(3).integers(-32, 32, (64, 40))))
