"""Architecture configs the port serves: its own copy of ``ArchConfig``,
``smoke_config`` and the arch configs the port serves.

The fields, defaults and derived properties are the JAX package's, field
for field (tests/test_torch_engine.py compares them), so one config value
means the same model in both packages.  The configs copied are the ones
the ported layer families serve: the dense ``attn_full`` decoders, the
Griffin hybrid (RG-LRU + ``attn_local`` rings, tied embeddings),
gemma3's 5:1 local:global pattern, the MoE decoders mixtral-8x7b
(sliding-window) and grok-1-314b (full attention), the attention-free
Mamba-2 SSD stack mamba2-370m, and the two modality frontends over the
dense stack: musicgen-large (K codebook embeddings summed, K heads) and
llava-next-34b (precomputed patch embeddings prepended).  That is all
eleven of the JAX package's configs, and ``ARCH_IDS`` lists them in its
order.  Full-depth grok-1-314b (~346 GB packed) does not fit one card:
the launcher refuses it until the expert axis spreads it over ranks
(ROADMAP A13).
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
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssd_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256; padded logit rows are
        masked in the head."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssd" for k in self.pattern)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), as JAX's: an
        audio model's K codebooks widen the embedding and the head K-fold."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * self.n_heads * self.d_head * 2  # q, o
        attn += d * self.n_kv_heads * self.d_head * 2  # k, v
        dense_ffn = 3 * d * ff
        per_kind = {}
        per_kind["attn_full"] = per_kind["attn_local"] = attn + (
            dense_ffn if not self.n_experts else 3 * d * ff * self.n_experts + d * self.n_experts
        )
        rd = self.rnn_dim
        per_kind["rglru"] = 3 * d * rd + 2 * rd + 4 * rd + rd * self.d_conv + dense_ffn
        din, ns = self.d_inner, self.ssm_state
        nh = self.n_ssd_heads if self.ssm_state else 0
        conv_dim = din + 2 * ns
        per_kind["ssd"] = d * (2 * din + 2 * ns + nh) + conv_dim * self.d_conv + din * d + 2 * nh
        total = 0
        for k in list(self.pattern) * self.n_units + list(self.tail):
            total += per_kind[k] + 2 * d  # 2 norms/block
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.frontend == "audio_codebooks":
            total += (self.n_codebooks - 1) * v * d * (2 if not self.tie_embeddings else 1)
        return total


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
    # Gemma3-12B: dense decoder, 5:1 local:global attention
    # 48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144
    # [hf:google/gemma-3-12b-pt; unverified]; local window 1024, tied
    "gemma3-12b": ArchConfig(
        name="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_head=256,
        d_ff=15360,
        vocab_size=262_144,
        pattern=("attn_local",) * 5 + ("attn_full",),
        window=1024,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        source="hf:google/gemma-3-12b-pt; unverified",
    ),
    # DeepSeek-Coder-33B: llama-architecture dense decoder
    # 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 [arXiv:2401.14196]
    "deepseek-coder-33b": ArchConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=19200,
        vocab_size=32_256,
        pattern=("attn_full",),
        source="arXiv:2401.14196; hf",
    ),
    # Phi-3-medium-14B: dense decoder, RoPE + SwiGLU + GQA
    # 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
    # [arXiv:2404.14219; unverified]
    "phi3-medium-14b": ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_head=128,
        d_ff=17920,
        vocab_size=100_352,
        pattern=("attn_full",),
        source="arXiv:2404.14219; unverified",
    ),
    # RecurrentGemma-2B (Griffin): (rglru, rglru, attn_local) x 8 + 2
    # recurrent tail; 26L d_model=2560 10H (kv=1, head_dim=256) d_ff=7680
    # vocab=256000, window 2048, tied [arXiv:2402.19427]
    "recurrentgemma-2b": ArchConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_head=256,
        d_ff=7680,
        vocab_size=256_000,
        pattern=("rglru", "rglru", "attn_local"),
        window=2048,
        rnn_width=2560,
        tie_embeddings=True,
        source="arXiv:2402.19427; hf",
    ),
    # Mixtral-8x7B: sparse MoE decoder, 8 experts top-2, sliding-window
    # attention (window 4096 on every layer); 32L d_model=4096 32H (GQA
    # kv=8) d_ff=14336 vocab=32000 [arXiv:2401.04088]
    "mixtral-8x7b": ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=32_000,
        pattern=("attn_local",),
        window=4096,
        n_experts=8,
        top_k=2,
        source="arXiv:2401.04088; hf",
    ),
    # Grok-1 (314B): sparse MoE decoder, 8 experts top-2, full attention;
    # 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072
    # [hf:xai-org/grok-1; unverified]
    "grok-1-314b": ArchConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=32768,
        vocab_size=131_072,
        pattern=("attn_full",),
        n_experts=8,
        top_k=2,
        source="hf:xai-org/grok-1; unverified",
    ),
    # Mamba2-370M: attention-free SSM via SSD (state-space duality); 48L
    # d_model=1024, vocab=50280 (padded to 50432), ssm_state=128,
    # headdim=64, expand=2 (d_inner=2048, 32 SSD heads), tied
    # [arXiv:2405.21060; unverified]; ssd_chunk 128 as in the JAX package's
    # config (the paper's listing chunks by 256)
    "mamba2-370m": ArchConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_head=0,
        d_ff=0,
        vocab_size=50_280,
        pattern=("ssd",),
        ssd_chunk=128,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        tie_embeddings=True,
        source="arXiv:2405.21060; unverified",
    ),
    # MusicGen-large: decoder-only transformer over EnCodec tokens; 48L
    # d_model=2048 32H (MHA) d_ff=8192 vocab=2048 per codebook, K=4
    # codebooks [arXiv:2306.05284; hf:facebook/musicgen-large]; the EnCodec
    # frontend is a stub: (B, S, K) codebook ids in, K embeddings summed, K
    # heads out
    "musicgen-large": ArchConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,
        vocab_size=2048,
        pattern=("attn_full",),
        frontend="audio_codebooks",
        n_codebooks=4,
        source="arXiv:2306.05284; hf",
    ),
    # LLaVA-NeXT-34B: the 34B LM backbone with anyres patch tokens; 60L
    # d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
    # [hf:llava-hf/llava-v1.6-34b-hf; unverified]; the vision tower is a
    # stub: (B, 2880, d_model) precomputed patch embeddings prepended
    "llava-next-34b": ArchConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=20480,
        vocab_size=64_000,
        pattern=("attn_full",),
        frontend="vlm_patches",
        n_image_tokens=2880,
        source="hf:llava-hf/llava-v1.6-34b-hf; unverified",
    ),
}

# the JAX package's order (``repro.configs.ARCH_IDS``)
ARCH_IDS = ["musicgen-large", "gemma3-12b", "yi-9b", "deepseek-coder-33b", "phi3-medium-14b",
            "mixtral-8x7b", "grok-1-314b", "llava-next-34b", "recurrentgemma-2b",
            "mamba2-370m", "llama-7b-paper"]
assert sorted(ARCH_IDS) == sorted(_CONFIGS)


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
