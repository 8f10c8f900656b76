"""Online-softmax attention (B2) and its packed-KV form (B5): wrappers,
plain PyTorch versions, launch counts.

``flash_attention(q, k, v, kv_len, q_pos0, causal=, window=)`` with q
(B, Hq, Sq, D), k/v (B, Hkv, S, D) f32 or all bf16 (GQA when Hkv < Hq), ``kv_len``
(B,) int32 valid keys per row and ``q_pos0`` (B,) int32 absolute position
of each row's first query.  Keys at/after ``kv_len``, after the query
(causal) or at/before ``query - window`` (window > 0) are masked with
-1e30; the output is ``acc / max(l, 1e-30)``.  Every query row needs at
least one visible key (the output of a fully masked row is undefined).

  prefill: kv_len = prompt lengths, q_pos0 = 0  (blockwise_attention)
  decode:  Sq = 1, kv_len = pos + 1, q_pos0 = pos  (decode_attention)

``flash_attention_grad`` is the same call as an autograd function, for
training: its forward is ``flash_attention`` (B2 on the card, the plain
version on the CPU), and its backward recomputes the plain version under
autograd from the saved q, k, v, ``kv_len`` and ``q_pos0``, as JAX
differentiates its jnp ``blockwise_attention`` (the reference has no
Pallas backward; a backward kernel is speed work, ROADMAP B).  The
recompute materializes the (B, Hq, Sq, S) f32 scores of one call; a
profile names it ``flash_attention_backward``.

``packed_flash_attention(q, k_qm, k_scale, v_qm, v_scale, ...)`` is the
same function over a packed cache: int8 mantissas (B, Hkv, S, D) and pow2
scales (B, Hkv, S, 1).  The K scale multiplies the logits after the dot,
the V scale the probabilities before PV; both are exact, so it equals
``flash_attention`` over ``qm * scale`` bit for bit.

``paged_flash_attention(q, k_pool, v_pool, table, kv_len, q_pos0, ...)``
(B6) and ``paged_packed_flash_attention(q, k_qm, k_scale, v_qm, v_scale,
table, ...)`` (B7) read K/V out of a block pool (NB, Hkv, bs, D) through
a block table (B, MB) int32: key j of row b is row ``j % bs`` of pool
block ``table[b, j // bs]``, so the logical length is MB * bs.  They equal
``flash_attention`` / ``packed_flash_attention`` over the gathered dense
view (:func:`gather_blocks`) bit for bit: the kernel changes only the
address of a key's row.  Their plain versions are exactly that, gather
then the dense plain version.

bfloat16.  q and o (and float K/V, pools) may be bf16 throughout; packed
K/V stay int8 with f32 scales.  Two roundings of a bf16 q differ:

* the card's kernels follow the TPU kernels (``flash_attention.py``
  :38-40, :64): q, k, v widen exactly to f32, q is scaled by the f32
  d**-0.5, all arithmetic is f32 and the output rounds once to bf16, so a
  bf16 call equals the f32 call on the upcasts, rounded once, bit for bit;
* the plain versions (the CPU path, which the parity tests hold against
  the JAX model) follow the JAX model's jnp code as XLA compiles it:
  ``q * d**-0.5`` in bf16 (the scale and the product round to bf16,
  :func:`scale_q`), and the scores of a float K in f32, unrounded (the
  jitted ``einsum`` in bf16 followed by its cast to f32 compiles to one
  f32 dot); P·V in f32, the output rounded once.

So kernel and plain version differ by the rounding of the scaled q alone:
a relative error of at most 2**-9 in each logit, which moves a softmax
weight by at most about |logit| * 2**-9; the card checks hold the two
within 2**-6 of max|out| (a few bf16 ulps), and hold the kernel to the
f32 kernel on the upcasts bit for bit.

On a CUDA tensor each launches ``csrc/flash_attention.cu`` (or raises): a
split-KV decode variant for Sq <= DECODE_MAX_SQ, whose per-split partials
live in a scratch the wrapper allocates, and a register-tiled variant
above, each built for d_head <= 128 and for d_head <= 256 (any d_head up to
MAX_D_HEAD, every one the reference's configs use; one not a multiple of 16
takes a slower load path of the same instantiation).  On a CPU tensor it
runs its plain version.  Replaces
``src/repro/kernels/flash_attention.py::flash_attention_kernel_call`` (:70)
``packed_flash_attention_kernel_call`` (:166),
``paged_flash_attention_kernel_call`` (:264) and
``paged_packed_flash_attention_kernel_call`` (:378), and the jnp mirrors
``models/attention.py`` :116 / :220 (with the packed ``qk_logits`` /
``pv_out`` branches, :36-63).
"""
from __future__ import annotations

import functools

import torch

from . import build

NEG_INF = -1e30
# csrc/flash_attention.cu's decode variant (Sq <= DECODE_MAX_SQ) keeps one
# partial (acc, m, l) per warp of every KEYS_PER_SPLIT-key split in a
# scratch the wrapper allocates; its launcher refuses a smaller one
DECODE_MAX_SQ = 8
KEYS_PER_SPLIT = 128
PARTS_PER_SPLIT = 4
# the largest head dim of csrc/flash_attention.cu's tiled variants
# (gemma3-12b's and recurrentgemma-2b's 256); above it, one warp per query
# row, with no partials, whose q and f32 accumulator fit a block's shared
# memory up to ROW_SMEM_MAX_D (232,448 bytes / 8)
TILED_MAX_D_HEAD = 256
ROW_SMEM_MAX_D = 29056
# q (and float K/V) element types the kernels are instantiated for
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ["flash_attention", "flash_attention_grad", "flash_attention_plain",
           "packed_flash_attention",
           "packed_flash_attention_plain", "paged_flash_attention",
           "paged_flash_attention_plain", "paged_packed_flash_attention",
           "paged_packed_flash_attention_plain", "gather_blocks", "attention_mask", "scale_q"]


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


@functools.lru_cache(maxsize=None)
def _rounded_scale(d: int, dtype: torch.dtype) -> float:
    """d**-0.5 rounded to ``dtype`` (JAX multiplies q by a weakly typed
    Python scalar, which takes q's dtype first)."""
    return float(torch.tensor(d ** -0.5, dtype=torch.float64).to(dtype))


def scale_q(q: torch.Tensor) -> torch.Tensor:
    """``q * d**-0.5`` in q's dtype, as the JAX model computes it: in a
    bf16 model the scale and the product round to bf16 (the TPU kernels,
    and the card's, scale the f32 upcast of q by the f32 scale instead)."""
    return q * _rounded_scale(q.shape[-1], q.dtype)


def _attention_plain(q, k, v, kv_len, q_pos0, causal, window, k_scale=None,
                     v_scale=None):
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = scale_q(q).to(torch.float32).reshape(b, hkv, rep * sq, d)
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


def _kernel_dims(name: str, q, *floats):
    """The kernels' element types: q (and the float K/V or pools
    ``floats``) all float32 or all bfloat16."""
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype for t in floats):
        raise ValueError(f"{name} kernel takes q{' and K/V' if floats else ''} all float32 "
                         f"or all bfloat16, got {[str(t.dtype) for t in (q, *floats)]}")


def _scratch(q, s: int):
    """The decode variant's partials for q (B, Hq, Sq, D) over S keys, and
    their count of floats (None, 0 for the prefill variant and the
    one-warp-per-row kernel, but for a bf16 q whose row kernel keeps its
    f32 accumulators in device memory: D past ROW_SMEM_MAX_D)."""
    b, hq, sq, d = q.shape
    if d > TILED_MAX_D_HEAD:
        if q.dtype == torch.float32 or d <= ROW_SMEM_MAX_D:
            return None, 0
        n = b * hq * sq * d
        return torch.empty(n, dtype=torch.float32, device=q.device), n
    if sq > DECODE_MAX_SQ:
        return None, 0
    dp = -(-d // 16) * 16  # the kernel's row length: d rounded up to 16 columns
    n = b * hq * sq * PARTS_PER_SPLIT * -(-s // KEYS_PER_SPLIT) * (dp + 2)
    return torch.empty(n, dtype=torch.float32, device=q.device), n


def _launch(fn, q, s: int, operands, ints) -> torch.Tensor:
    """Run the kernel of wrapper ``fn`` on ``operands`` (tensors, in the C
    order before the output) and ``ints`` (the shape and mask ints before
    the scale), in q's dtype's instantiation (a library of its own for
    bf16); count the launch."""
    bf16 = q.dtype == torch.bfloat16
    name = fn.__name__ + ("_bf16" if bf16 else "")
    o = torch.empty_like(q)
    part, n = _scratch(q, s)
    err = build.load(name)(*(t.data_ptr() for t in operands), o.data_ptr(),
                           None if part is None else part.data_ptr(), n, *ints,
                           float(q.shape[3] ** -0.5),
                           torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    fn.launches += 1
    fn.bf16_launches += bf16
    return o


def flash_attention(q, k, v, kv_len, q_pos0, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    _check(q, k, v, kv_len, q_pos0)
    if not q.is_cuda:
        with build.plain_body():
            return flash_attention_plain(q, k, v, kv_len, q_pos0, causal=causal,
                                         window=window)
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    _kernel_dims("flash_attention", q, k, v)
    q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
    kv_len = kv_len.to(torch.int32).contiguous()
    q_pos0 = q_pos0.to(torch.int32).contiguous()
    return _launch(flash_attention, q, s, (q, k, v, kv_len, q_pos0),
                   (b, hq, hkv, sq, s, d, int(causal), int(window)))


class _FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_pos0, causal, window):
        ctx.save_for_backward(q, k, v, kv_len, q_pos0)
        ctx.mask = (causal, window)
        return flash_attention(q, k, v, kv_len, q_pos0, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_len, q_pos0 = ctx.saved_tensors  # under remat: recomputed first
        with torch.profiler.record_function("flash_attention_backward"), torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _attention_plain(*qkv, kv_len, q_pos0, *ctx.mask)
            gq, gk, gv = torch.autograd.grad(out, qkv, g)
        return gq, gk, gv, None, None, None, None


def flash_attention_grad(q, k, v, kv_len, q_pos0, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """:func:`flash_attention` with a gradient for q, k and v (the plain
    version's, recomputed in the backward)."""
    return _FlashAttentionFn.apply(q, k, v, kv_len, q_pos0, causal, window)


def _check_children(fn: str, q, k_qm, k_scale, v_qm, v_scale):
    """Packed K/V operands: int8 mantissas (..., D) and f32 scales (..., 1)
    sharing every leading axis, on q's device."""
    want = (*k_qm.shape[:3], 1)
    for name, t, dt, shape in (("k_qm", k_qm, torch.int8, k_qm.shape),
                               ("v_qm", v_qm, torch.int8, k_qm.shape),
                               ("k_scale", k_scale, torch.float32, want),
                               ("v_scale", v_scale, torch.float32, want)):
        if t.dtype != dt or t.shape != shape or t.device != q.device:
            raise ValueError(f"{fn}: {name} must be {dt} {tuple(shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_packed(q, k_qm, k_scale, v_qm, v_scale, kv_len, q_pos0):
    _check(q, k_qm, v_qm, kv_len, q_pos0)
    _check_children("packed_flash_attention", q, k_qm, k_scale, v_qm, v_scale)


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
    _kernel_dims("packed_flash_attention", q)
    q, k_qm, v_qm = (build.aligned(t) for t in (q, k_qm, v_qm))
    k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    q_pos0 = q_pos0.to(torch.int32).contiguous()
    return _launch(packed_flash_attention, q, s,
                   (q, k_qm, k_scale, v_qm, v_scale, kv_len, q_pos0),
                   (b, hq, hkv, sq, s, d, int(causal), int(window)))


# ---------------- paged: K/V through a block table (B6, B7) ----------------

def gather_blocks(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The dense view (B, Hkv, MB * bs, D) of a pool (NB, Hkv, bs, D)
    through a table (B, MB): a KV-sized copy, which the kernels never
    make."""
    view = pool[table.to(torch.int64)]          # (B, MB, Hkv, bs, D)
    b, mb, h, bs, d = view.shape
    return view.permute(0, 2, 1, 3, 4).reshape(b, h, mb * bs, d)


def paged_flash_attention_plain(q, k_pool, v_pool, table, kv_len, q_pos0, *,
                                causal: bool = True, window: int = 0) -> torch.Tensor:
    """:func:`flash_attention_plain` over the gathered view: the oracle B6
    equals bit for bit on the card (B2 over ``gather_kv_view``)."""
    return flash_attention_plain(q, gather_blocks(k_pool, table),
                                 gather_blocks(v_pool, table), kv_len, q_pos0,
                                 causal=causal, window=window)


def paged_packed_flash_attention_plain(q, k_qm, k_scale, v_qm, v_scale, table, kv_len,
                                       q_pos0, *, causal: bool = True,
                                       window: int = 0) -> torch.Tensor:
    """:func:`packed_flash_attention_plain` over the gathered packed view
    (both children of each pool through the same table)."""
    g = [gather_blocks(t, table) for t in (k_qm, k_scale, v_qm, v_scale)]
    return packed_flash_attention_plain(q, *g, kv_len, q_pos0, causal=causal,
                                        window=window)


def _check_paged(name, q, k_pool, v_pool, table, kv_len, q_pos0):
    b, hq, sq, d = q.shape
    if (k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != d
            or hq % k_pool.shape[1]):
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if table.ndim != 2 or table.shape[0] != b or table.dtype not in (torch.int32,
                                                                     torch.int64):
        raise ValueError(f"{name}: table must be ({b}, MB) int32, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if kv_len.shape != (b,) or q_pos0.shape != (b,):
        raise ValueError(f"{name}: kv_len/q_pos0 must be ({b},), got "
                         f"{tuple(kv_len.shape)}/{tuple(q_pos0.shape)}")
    for what, t in (("pools", k_pool), ("pools", v_pool), ("table", table),
                    ("kv_len", kv_len), ("q_pos0", q_pos0)):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on {q.device}")
    if not q.is_cuda:  # on the card these checks would sync: the host's job
        nb, s = k_pool.shape[0], table.shape[1] * k_pool.shape[2]
        if table.numel() and (int(table.min()) < 0 or int(table.max()) >= nb):
            raise ValueError(f"{name}: table entries must lie in [0, {nb})")
        if kv_len.numel() and int(kv_len.max()) > s:
            raise ValueError(f"{name}: kv_len {int(kv_len.max())} exceeds the "
                             f"table's {s} slots")


def _launch_dims(name, q, pool, table, *floats):
    b, hq, sq, d = q.shape
    _kernel_dims(name, q, *floats)
    return b, hq, pool.shape[1], sq, table.shape[1], pool.shape[2], d


def paged_flash_attention(q, k_pool, v_pool, table, kv_len, q_pos0, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """B6: q (B, Hq, Sq, D) over pools (NB, Hkv, bs, D) of q's dtype (f32
    or bf16) through ``table`` (B, MB) int32."""
    _check_paged("paged_flash_attention", q, k_pool, v_pool, table, kv_len, q_pos0)
    if not q.is_cuda:
        with build.plain_body():
            return paged_flash_attention_plain(q, k_pool, v_pool, table, kv_len,
                                               q_pos0, causal=causal, window=window)
    dims = _launch_dims("paged_flash_attention", q, k_pool, table, k_pool, v_pool)
    q, k_pool, v_pool = build.aligned(q), build.aligned(k_pool), build.aligned(v_pool)
    table, kv_len, q_pos0 = (t.to(torch.int32).contiguous() for t in (table, kv_len, q_pos0))
    return _launch(paged_flash_attention, q, dims[4] * dims[5],
                   (q, k_pool, v_pool, table, kv_len, q_pos0),
                   (*dims, int(causal), int(window)))


def paged_packed_flash_attention(q, k_qm, k_scale, v_qm, v_scale, table, kv_len, q_pos0,
                                 *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """B7: B6 over packed pools, ``qm`` int8 (NB, Hkv, bs, D) and
    ``scale`` f32 (NB, Hkv, bs, 1) for K and V."""
    name = "paged_packed_flash_attention"
    _check_paged(name, q, k_qm, v_qm, table, kv_len, q_pos0)
    _check_children(name, q, k_qm, k_scale, v_qm, v_scale)
    if not q.is_cuda:
        with build.plain_body():
            return paged_packed_flash_attention_plain(
                q, k_qm, k_scale, v_qm, v_scale, table, kv_len, q_pos0,
                causal=causal, window=window)
    dims = _launch_dims(name, q, k_qm, table)
    q, k_qm, v_qm = (build.aligned(t) for t in (q, k_qm, v_qm))
    k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    table, kv_len, q_pos0 = (t.to(torch.int32).contiguous() for t in (table, kv_len, q_pos0))
    return _launch(paged_packed_flash_attention, q, dims[4] * dims[5],
                   (q, k_qm, k_scale, v_qm, v_scale, table, kv_len, q_pos0),
                   (*dims, int(causal), int(window)))


# each wrapper's launches of its kernel, and of those the bf16 instantiation's
for _fn in (flash_attention, packed_flash_attention, paged_flash_attention,
            paged_packed_flash_attention):
    _fn.launches = 0
    _fn.bf16_launches = 0
