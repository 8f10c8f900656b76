"""Online-softmax attention (B2) and its packed-KV form (B5): wrappers,
plain PyTorch versions, launch counts.

``flash_attention(q, k, v, kv_len, q_pos0, causal=, window=)`` with q
(B, Hq, Sq, D), k/v (B, Hkv, S, D) f32 (GQA when Hkv < Hq), ``kv_len``
(B,) int32 valid keys per row and ``q_pos0`` (B,) int32 absolute position
of each row's first query.  Keys at/after ``kv_len``, after the query
(causal) or at/before ``query - window`` (window > 0) are masked with
-1e30; the output is ``acc / max(l, 1e-30)``.  Every query row needs at
least one visible key (the output of a fully masked row is undefined).

  prefill: kv_len = prompt lengths, q_pos0 = 0  (blockwise_attention)
  decode:  Sq = 1, kv_len = pos + 1, q_pos0 = pos  (decode_attention)

``packed_flash_attention(q, k_qm, k_scale, v_qm, v_scale, ...)`` is the
same function over a packed cache: int8 mantissas (B, Hkv, S, D) and pow2
scales (B, Hkv, S, 1).  The K scale multiplies the logits after the dot,
the V scale the probabilities before PV; both are exact, so it equals
``flash_attention`` over ``qm * scale`` bit for bit.

On a CUDA tensor each launches ``csrc/flash_attention.cu`` (or raises); on
a CPU tensor it runs its plain version.  Replaces
``src/repro/kernels/flash_attention.py::flash_attention_kernel_call`` (:70)
and ``packed_flash_attention_kernel_call`` (:166), and the jnp mirrors
``models/attention.py`` :116 / :220 (with the packed ``qk_logits`` /
``pv_out`` branches, :36-63).
"""
from __future__ import annotations

import torch

from . import build

NEG_INF = -1e30

__all__ = ["flash_attention", "flash_attention_plain", "packed_flash_attention",
           "packed_flash_attention_plain", "attention_mask"]


def attention_mask(kv_len, q_pos0, sq: int, s: int, *, causal: bool,
                   window: int) -> torch.Tensor:
    """(B, Sq, S) bool: key j visible to query i of row b."""
    dev = kv_len.device
    qpos = q_pos0.to(torch.int64)[:, None] + torch.arange(sq, device=dev)[None, :]
    kpos = torch.arange(s, device=dev)
    mask = (kpos[None, None, :] < kv_len.to(torch.int64)[:, None, None]).expand(-1, sq, -1)
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    if window:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    return mask


def _attention_plain(q, k, v, kv_len, q_pos0, causal, window, k_scale=None,
                     v_scale=None):
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = (q.to(torch.float32) * d ** -0.5).reshape(b, hkv, rep * sq, d)
    logits = torch.matmul(qg, k.to(torch.float32).transpose(-1, -2))
    if k_scale is not None:  # pow2 K scale after the dot: exact
        logits = logits * k_scale.reshape(b, hkv, 1, s)
    logits = logits.reshape(b, hkv, rep, sq, s)
    mask = attention_mask(kv_len, q_pos0, sq, s, causal=causal, window=window)
    logits = torch.where(mask[:, None, None], logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:  # pow2 V scale into the probabilities: exact
        p = p * v_scale.reshape(b, hkv, 1, 1, s)
    acc = torch.matmul(p.reshape(b, hkv, rep * sq, s), v.to(torch.float32))
    out = acc.reshape(b, hkv, rep, sq, d) / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention_plain(q, k, v, kv_len, q_pos0, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The same function in PyTorch: ``blockwise_attention`` with a single
    key block (masked logits -1e30, running max/sum/acc in f32)."""
    return _attention_plain(q, k, v, kv_len, q_pos0, causal, window)


def packed_flash_attention_plain(q, k_qm, k_scale, v_qm, v_scale, kv_len, q_pos0,
                                 *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """:func:`flash_attention_plain` over int8 mantissas with the two pow2
    folds (the JAX ``qk_logits`` / ``pv_out`` packed branches)."""
    return _attention_plain(q, k_qm, v_qm, kv_len, q_pos0, causal, window,
                            k_scale=k_scale, v_scale=v_scale)


def _check(q, k, v, kv_len, q_pos0):
    b, hq, sq, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hq % k.shape[1]):
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_len.shape != (b,) or q_pos0.shape != (b,):
        raise ValueError(f"flash_attention: kv_len/q_pos0 must be ({b},), got "
                         f"{tuple(kv_len.shape)}/{tuple(q_pos0.shape)}")
    for name, t in (("k", k), ("v", v), ("kv_len", kv_len), ("q_pos0", q_pos0)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")


def flash_attention(q, k, v, kv_len, q_pos0, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    _check(q, k, v, kv_len, q_pos0)
    if not q.is_cuda:
        with build.plain_body():
            return flash_attention_plain(q, k, v, kv_len, q_pos0, causal=causal,
                                         window=window)
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if q.dtype != torch.float32 or k.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError("flash_attention kernel takes float32 q/k/v")
    if d > 128:
        raise ValueError(f"flash_attention kernel takes d_head <= 128, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    q_pos0 = q_pos0.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    launch = build.load("flash_attention")
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 q_pos0.data_ptr(), o.data_ptr(), b, hq, hkv, sq, s, d,
                 int(causal), int(window), float(d ** -0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def _check_packed(q, k_qm, k_scale, v_qm, v_scale, kv_len, q_pos0):
    _check(q, k_qm, v_qm, kv_len, q_pos0)
    want = (*k_qm.shape[:3], 1)
    for name, t, dt, shape in (("k_qm", k_qm, torch.int8, k_qm.shape),
                               ("v_qm", v_qm, torch.int8, k_qm.shape),
                               ("k_scale", k_scale, torch.float32, want),
                               ("v_scale", v_scale, torch.float32, want)):
        if t.dtype != dt or t.shape != shape or t.device != q.device:
            raise ValueError(f"packed_flash_attention: {name} must be {dt} "
                             f"{tuple(shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def packed_flash_attention(q, k_qm, k_scale, v_qm, v_scale, kv_len, q_pos0, *,
                           causal: bool = True, window: int = 0) -> torch.Tensor:
    _check_packed(q, k_qm, k_scale, v_qm, v_scale, kv_len, q_pos0)
    if not q.is_cuda:
        with build.plain_body():
            return packed_flash_attention_plain(q, k_qm, k_scale, v_qm, v_scale,
                                                kv_len, q_pos0, causal=causal,
                                                window=window)
    b, hq, sq, d = q.shape
    hkv, s = k_qm.shape[1], k_qm.shape[2]
    if q.dtype != torch.float32:
        raise ValueError("packed_flash_attention kernel takes a float32 q")
    if d > 128:
        raise ValueError(f"packed_flash_attention kernel takes d_head <= 128, got {d}")
    q, k_qm, k_scale, v_qm, v_scale = (t.contiguous() for t in (q, k_qm, k_scale, v_qm, v_scale))
    kv_len = kv_len.to(torch.int32).contiguous()
    q_pos0 = q_pos0.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    launch = build.load("packed_flash_attention")
    err = launch(q.data_ptr(), k_qm.data_ptr(), k_scale.data_ptr(), v_qm.data_ptr(),
                 v_scale.data_ptr(), kv_len.data_ptr(), q_pos0.data_ptr(), o.data_ptr(),
                 b, hq, hkv, sq, s, d, int(causal), int(window), float(d ** -0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_flash_attention kernel launch failed: CUDA error {err}")
    packed_flash_attention.launches += 1
    return o


packed_flash_attention.launches = 0
