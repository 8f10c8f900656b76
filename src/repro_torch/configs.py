"""Architecture configs the port serves: its own copy of ``ArchConfig``,
``smoke_config`` and the two dense decoders on the main path.

The fields, defaults and derived properties are the JAX package's, field
for field (tests/test_torch_engine.py compares them), so one config value
means the same model in both packages.  Only the two configs this slice
serves are copied; the others join as their layer families are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig", "ARCH_IDS", "get_config", "smoke_config"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "audio", "vlm", "hybrid", "ssm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # layer pattern: repeating unit of kinds in
    #   {"attn_full", "attn_local", "rglru", "ssd"}
    pattern: tuple[str, ...] = ("attn_full",)
    window: int = 0  # sliding-window size for attn_local
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 512
    # SSM / recurrent
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    d_conv: int = 4
    ssd_chunk: int = 256
    rnn_width: int = 0
    # modality frontend stubs
    frontend: Literal["none", "audio_codebooks", "vlm_patches"] = "none"
    n_codebooks: int = 0
    n_image_tokens: int = 0
    # numerics / misc
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "float32"
    # JAX compile knobs, kept so the two packages' configs stay comparable
    # field for field; the port reads neither
    remat: bool = True
    scan_unroll: int = 1
    # DSBP quantization preset for projections (None = float baseline)
    quant: str | None = None
    # quantized-linear method executing the preset (repro_torch.core.packed
    # registry name); None auto-selects 'dsbp_ref' when quant is set
    quant_method: str | None = None
    source: str = ""

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> tuple[str, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256; padded logit rows are
        masked in the head."""
        return -(-self.vocab_size // 256) * 256

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_CONFIGS = {
    # Llama-7b, the paper's own evaluation model (its section III):
    # 32L d_model=4096 32H (MHA) d_ff=11008 vocab=32000 [arXiv:2302.13971],
    # carrying the paper's "Precise" DSBP preset.
    "llama-7b-paper": ArchConfig(
        name="llama-7b-paper",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_head=128,
        d_ff=11008,
        vocab_size=32_000,
        pattern=("attn_full",),
        quant="precise",
        source="arXiv:2302.13971; paper §III",
    ),
    # Yi-9B: llama-architecture dense decoder with GQA
    # 48L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000 [arXiv:2403.04652]
    "yi-9b": ArchConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=11008,
        vocab_size=64_000,
        pattern=("attn_full",),
        source="arXiv:2403.04652; hf",
    ),
}

ARCH_IDS = list(_CONFIGS)


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise ValueError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    return _CONFIGS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: small widths/layers, tiny vocab."""
    cfg = get_config(name)
    pat_len = len(cfg.pattern)
    n_layers = max(2 * pat_len, pat_len) + (1 if cfg.tail else 0)
    if cfg.tail:
        n_layers = 2 * pat_len + len(cfg.tail)
    kw = dict(
        n_layers=n_layers,
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        window=min(cfg.window, 64) if cfg.window else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2),
        moe_group=64,
        ssm_state=32 if cfg.ssm_state else 0,
        ssm_headdim=32,
        rnn_width=64 if cfg.rnn_width else 0,
        n_image_tokens=16 if cfg.frontend == "vlm_patches" else 0,
        remat=False,
    )
    return cfg.replace(**kw)
