"""Pack-once DSBP weight container and the quantized-linear-method registry.

Port of ``repro.core.packed``.  :class:`PackedDSBPWeight` holds the offline
weight path in **kernel layout** (layout v2), as buffers of an
``nn.Module`` so ``.to(device)`` moves it with the model:

  ka      int8  (..., K', N)   aligned mantissas, reduction axis leading;
                               K' = n_g * G is the group-padded width
  kscale  f32   (..., n_g, N)  per-64-group scales (powers of two)
  tscale  f32   (..., N, 1)    per-channel (or 0-d per-tensor) scale
  bits    int8  (..., N, n_g)  predicted aligned widths B_g

plus the static logical GEMM shape ``(k, n)``, the group size, the
:class:`~repro_torch.core.quantized.QuantizedMatmulConfig` it was packed
under and the layout ``version``.

The registry decides how ``models.layers.dense`` executes a projection:

  dense_bf16   plain matmul, no quantization
  dsbp_ref     reference DSBP numerics (torch grouped int contraction)
  dsbp_kernel  the two-kernel DSBP GEMM: the input path (B3), then the
               grouped integer GEMM (B4) off the stored operands
  dsbp_fused   the one-pass fused DSBP GEMM (CUDA kernel on the card,
               its plain PyTorch version on the CPU) — the serving default
  dsbp_fused_sharded
               the fused GEMM on one rank of a mesh (B8): the projection's
               name picks its tensor-parallel split
               (``parallel.context``); the default under a mesh

Every method takes the projection's ``name`` (``wq``, ``w2``, ...); only
the sharded one reads it, as in JAX.  :func:`pack_weights_sharded` packs a
rank's column shard straight into its kernel layout; :func:`draft_view`
derives a container's MSB-slice draft (speculative decoding).
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = [
    "PackedDSBPWeight",
    "LAYOUT_VERSION",
    "to_kernel_layout",
    "QuantMethod",
    "register_quant_method",
    "get_quant_method",
    "pack_weights_sharded",
    "draft_view",
]

LAYOUT_VERSION = 2


def to_kernel_layout(a, scale):
    """``a (..., N, n_g, G)`` / ``scale (..., N, n_g)`` -> ``ka (..., K', N)``
    / ``kscale (..., n_g, N)``: a pure permutation, run once at pack time."""
    lead = a.shape[:-3]
    n, ng, g = a.shape[-3:]
    ka = a.reshape(*lead, n, ng * g).transpose(-1, -2).contiguous()
    return ka, scale.transpose(-1, -2).contiguous()


class PackedDSBPWeight(nn.Module):
    """Offline-quantized DSBP weight for a logical ``(k, n)`` GEMM."""

    def __init__(self, ka, kscale, tscale, bits, *, k, n, group_size, cfg,
                 version: int = LAYOUT_VERSION):
        super().__init__()
        self.register_buffer("ka", ka)
        self.register_buffer("kscale", kscale)
        self.register_buffer("tscale", tscale)
        self.register_buffer("bits", bits)
        self.k = k
        self.n = n
        self.group_size = group_size
        self.cfg = cfg
        self.version = version

    @property
    def padded_k(self) -> int:
        """K rounded up to a multiple of the group (zero-filled lanes)."""
        return self.ka.shape[-2]

    @property
    def a(self) -> torch.Tensor:
        """Legacy ``(..., N, n_g, G)`` aligned-mantissa view of :attr:`ka`."""
        lead = self.ka.shape[:-2]
        kp, n = self.ka.shape[-2:]
        g = self.group_size
        return self.ka.transpose(-1, -2).reshape(*lead, n, kp // g, g)

    @property
    def scale(self) -> torch.Tensor:
        """Legacy ``(..., N, n_g)`` group-scale view of :attr:`kscale`."""
        return self.kscale.transpose(-1, -2)

    def extra_repr(self) -> str:
        return (f"k={self.k}, n={self.n}, group={self.group_size}, "
                f"v{self.version}")

    def slice(self, rows: slice | None = None, cols: slice | None = None) -> "PackedDSBPWeight":
        """The container of logical rows ``rows`` (group-aligned) and
        output columns ``cols`` of this one: every child cut along its own
        axes (``ka``/``kscale`` rows and columns, ``tscale`` per-channel
        rows, ``bits`` rows and groups).  Exact: the weight path is fixed
        per column and per group."""
        g = self.group_size
        rows = slice(0, self.k) if rows is None else rows
        cols = slice(0, self.n) if cols is None else cols
        if (rows.start, rows.stop) == (0, self.k):
            kr, gr, k = slice(None), slice(None), self.k
        elif rows.start % g or rows.stop % g:
            raise ValueError(f"row slice {rows} is not group-aligned (group {g})")
        else:
            kr, gr, k = rows, slice(rows.start // g, rows.stop // g), rows.stop - rows.start
        ts = self.tscale
        if ts.ndim == self.ka.ndim:  # per-channel (..., N, 1)
            ts = ts[..., cols, :]
        return PackedDSBPWeight(
            self.ka[..., kr, cols].contiguous(), self.kscale[..., gr, cols].contiguous(),
            ts.contiguous(), self.bits[..., cols, gr].contiguous(), k=k,
            n=len(range(*cols.indices(self.n))), group_size=g, cfg=self.cfg,
            version=self.version)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Back to a dense ``(..., k, n)`` matrix (weight-only consumption):
        ``ka * group scale / tscale``, JAX's arithmetic in JAX's order, in
        place on the one new tensor (the group scale broadcast over its
        rows, not repeated), so a stack of experts costs three passes."""
        lead = self.ka.shape[:-2]
        kp, n = self.ka.shape[-2:]
        g = self.group_size
        deq = self.ka.to(dtype, copy=True, memory_format=torch.contiguous_format)
        deq.view(*lead, kp // g, g, n).mul_(self.kscale.to(dtype)[..., :, None, :])
        ts = self.tscale.to(dtype)
        if ts.ndim >= 2:  # per-channel (..., N, 1) -> (..., 1, N)
            ts = ts.transpose(-1, -2)
        if ts.ndim < deq.ndim:
            ts = ts.reshape(*ts.shape, *([1] * (deq.ndim - ts.ndim)))
        return deq.div_(ts)[..., : self.k, :]


def draft_view(pw: PackedDSBPWeight, draft_bits: int) -> PackedDSBPWeight:
    """MSB-slice view of a packed container: the top ``draft_bits``
    magnitude bits of every aligned mantissa, as a new container (port of
    ``repro.core.packed.draft_view``, :200).

    Per group, ``s_g = max(B_g - draft_bits, 0)``: ``ka >> s_g`` (an
    arithmetic shift, floor(a / 2^s_g), on the kernel-layout (K', N)
    operand, the shift broadcast over the group's rows without repeating
    it) and ``kscale * 2^s_g`` (exact: pow2 times pow2, ``2^s`` from its bit
    pattern), ``bits = min(bits, draft_bits)``; ``tscale`` and the static
    fields are shared.  ``draft_bits`` 7 returns the container's exact
    numerics.  A new, plain v2 container: it goes through every method
    unchanged.  The source container is neither copied nor modified; the
    view's ``ka`` and ``kscale`` are new tensors of the same shapes, which
    the caller drops after use."""
    if not 1 <= int(draft_bits) <= 7:
        raise ValueError(f"draft_bits must be in [1, 7], got {draft_bits}")
    from .formats import exp2i  # local import: packed stays dependency-light

    shift = torch.clamp(pw.bits.to(torch.int32) - int(draft_bits), min=0)  # (..., N, n_g)
    shift_k = shift.transpose(-1, -2)                                        # (..., n_g, N)
    lead, (kp, n) = pw.ka.shape[:-2], pw.ka.shape[-2:]
    g = pw.group_size
    ka = (pw.ka.reshape(*lead, kp // g, g, n)
          >> shift_k.to(torch.int8)[..., :, None, :]).reshape(pw.ka.shape)
    return PackedDSBPWeight(
        ka, pw.kscale * exp2i(shift_k), pw.tscale, pw.bits.clamp(max=int(draft_bits)),
        k=pw.k, n=pw.n, group_size=g, cfg=pw.cfg, version=pw.version)


# ---------------------------------------------------------------------------
# Quantized-linear-method registry
# ---------------------------------------------------------------------------

class QuantMethod:
    """How a projection executes: ``apply(w, x, cfg, name)`` computes the
    logical ``x (..., K) @ w (K, N)``, with ``w`` a raw tensor or a
    :class:`PackedDSBPWeight`, ``cfg`` the active
    ``QuantizedMatmulConfig`` (None = no activation quantization) and
    ``name`` the projection's weight name."""

    name: str = "?"

    def apply(self, w, x, cfg, name=None):
        if isinstance(w, PackedDSBPWeight):
            if cfg is None:
                return _matmul(w.dequantize(x.dtype), x)
            return self._apply_packed(w, x, cfg, name=name)
        if cfg is None:
            return _matmul(w, x)
        return self._apply_raw(w, x, cfg, name=name)

    def _apply_packed(self, pw, x, cfg, name=None):
        raise NotImplementedError

    def _apply_raw(self, w, x, cfg, name=None):
        raise NotImplementedError


_REGISTRY: dict[str, QuantMethod] = {}


def register_quant_method(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def get_quant_method(name: str) -> QuantMethod:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown quant method {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def _matmul(w, x):
    return torch.matmul(x, w.to(x.dtype))


@register_quant_method
class DenseBF16Method(QuantMethod):
    """No quantization: the float matmul baseline."""

    name = "dense_bf16"

    def apply(self, w, x, cfg, name=None):
        del cfg, name
        if isinstance(w, PackedDSBPWeight):
            w = w.dequantize(x.dtype)
        return _matmul(w, x)


@register_quant_method
class DSBPRefMethod(QuantMethod):
    """Reference DSBP numerics: packed weights take the integer path
    (on-the-fly input quantization + grouped int contraction off the packed
    form); raw weights quantize both operands per call, with a
    straight-through backward (QAT)."""

    name = "dsbp_ref"

    def _apply_packed(self, pw, x, cfg, name=None):
        from . import quantized as Q

        return Q.packed_matmul(x, pw, input_cfg=cfg.input_cfg).to(x.dtype)

    def _apply_raw(self, w, x, cfg, name=None):
        from . import quantized as Q

        return Q.dsbp_matmul_ste(x, w, cfg).to(x.dtype)


@register_quant_method
class DSBPKernelMethod(QuantMethod):
    """The two-kernel DSBP GEMM (``kernels.ops.dsbp_matmul_packed``): the
    int8 aligned mantissas of a packed weight feed the grouped GEMM
    directly, under the *active* config's input path.  Raw weights pack
    per call, with a straight-through backward (QAT)."""

    name = "dsbp_kernel"

    def _apply_packed(self, pw, x, cfg, name=None):
        from repro_torch.kernels import ops

        return ops.dsbp_matmul_packed(x, pw, input_cfg=cfg.input_cfg).to(x.dtype)

    def _apply_raw(self, w, x, cfg, name=None):
        from repro_torch.kernels import ops

        return ops.dsbp_matmul_ste(x, w, cfg).to(x.dtype)


@register_quant_method
class DSBPFusedMethod(QuantMethod):
    """The one-pass fused DSBP GEMM (``kernels.ops.dsbp_matmul_fused``):
    FP8 quantize + predict + align + MAC in one kernel off the container's
    kernel-layout operands.  Raw weights pack per call, with a
    straight-through backward: QAT trains through B1's forward."""

    name = "dsbp_fused"

    def _apply_packed(self, pw, x, cfg, name=None):
        from repro_torch.kernels import ops

        return ops.dsbp_matmul_fused(x, pw, input_cfg=cfg.input_cfg).to(x.dtype)

    def _apply_raw(self, w, x, cfg, name=None):
        from repro_torch.kernels import ops

        return ops.dsbp_matmul_fused_ste(x, w, cfg).to(x.dtype)


@register_quant_method
class DSBPFusedShardedMethod(DSBPFusedMethod):
    """The fused one-pass GEMM on one rank of a mesh (B8).

    Under a sharding context (``parallel.context.sharding_ctx``, entered
    by a multi-rank Engine around every model call) each packed projection
    runs :func:`repro_torch.kernels.ops.dsbp_matmul_fused_sharded` with the
    split the weights were cut under, looked up by the projection's name:
    wq/wk/wv/w1/w3 column-parallel on their N shards (no collective),
    wo/w2 row-parallel on group-aligned K shards with ONE ``all_reduce``
    after the in-kernel scale division; the input scale is reduced over
    every rank that splits the activation.  Without a context this is
    'dsbp_fused'.  Raw weights pack per call and take the same route
    (serving only: training under a mesh waits for ROADMAP A13)."""

    name = "dsbp_fused_sharded"

    def _apply_raw(self, w, x, cfg, name=None):
        from . import quantized as Q

        return self._apply_packed(Q.pack_weights(w, cfg), x, cfg, name=name)

    def _apply_packed(self, pw, x, cfg, name=None):
        from repro_torch.parallel import context as PC

        ctx = PC.active_ctx()
        if ctx is None or pw.ka.ndim != 2:
            return super()._apply_packed(pw, x, cfg, name=name)
        from repro_torch.kernels import ops

        k_axis, n_axis = ctx.plan.get(name, (None, None))
        return ops.dsbp_matmul_fused_sharded(
            x, pw, ctx.mesh, input_cfg=cfg.input_cfg, batch_axis=ctx.batch_axes,
            k_axis=k_axis, n_axis=n_axis).to(x.dtype)


def pack_weights_sharded(w, cfg, mesh, *, n_axis: str = "model",
                         cols: slice | None = None) -> PackedDSBPWeight:
    """Pack only this rank's output columns of ``w (..., K, N)`` straight
    into kernel layout: its even shard over ``n_axis`` of ``mesh``, or the
    columns ``cols`` (the kv-head columns its q heads read).  The full
    quantized container never exists on the rank.

    Bit-identical to slicing the global pack: with per-column weight
    scales (every PRESETS entry packs with ``scale_granularity='row'``)
    the whole weight path — scale, group scales, width prediction,
    alignment — is independent per output column.  Per-tensor scales
    couple the columns through the global max, so that case packs globally
    and slices; an ``N`` that ``n_axis`` does not divide (or a mesh
    without it) falls back to the global pack, as JAX's does."""
    from . import quantized as Q  # local import: packed stays dependency-light

    if isinstance(cfg, str):
        cfg = Q.PRESETS[cfg]
    n = w.shape[-1]
    if cols is None:
        size = mesh.shape.get(n_axis, 0)
        if not size or n % size:
            return Q.pack_weights(w, cfg)
        c = mesh.coords[n_axis]
        cols = slice(c * n // size, (c + 1) * n // size)
    if cfg.weight_cfg.scale_granularity != "row":
        return Q.pack_weights(w, cfg).slice(cols=cols)
    return Q.pack_weights(w[..., cols], cfg)
