"""The DSBP policy artifact: per-layer GEMM configs + provenance.

Port of ``repro.policy.policy``.  A :class:`DSBPPolicy` assigns one
:class:`~repro_torch.core.quantized.QuantizedMatmulConfig` to each
quantizable projection, keyed by JAX's stacked path (``units/<pos>/attn/wq``;
the port's layer i resolves ``units/<i % P>/...`` through
:func:`repro_torch.spec.draft.stacked_key`), so an entry covers every layer
at that pattern position, the granularity a packed container can express.
Its KV side maps cache-entry names (``units.<pos>`` / ``tail.<i>``) to
:class:`~repro_torch.kvq.KVQuantConfig` specs.

:meth:`DSBPPolicy.to_json` writes the JAX package's string, key for key, and
:meth:`DSBPPolicy.from_json` reads it, so one artifact serves both packages.
``save`` / ``load`` store it through :mod:`repro_torch.checkpoint.store` as
JAX's do (``to_tree``: a one-leaf tree, the JSON's UTF-8 bytes as uint8
under ``dsbp_policy_json``), so a policy checkpoint written by either
package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.dsbp import DSBPConfig
from repro_torch.core.quantized import PRESETS, QuantizedMatmulConfig
from repro_torch.kvq import KVQuantConfig, resolve_kv_spec

__all__ = ["DSBPPolicy", "POLICY_LEAF"]

POLICY_LEAF = "dsbp_policy_json"


def _cfg_to_dict(cfg: QuantizedMatmulConfig) -> dict:
    return {
        "input_cfg": dataclasses.asdict(cfg.input_cfg),
        "weight_cfg": dataclasses.asdict(cfg.weight_cfg),
    }


def _cfg_from_dict(d: dict) -> QuantizedMatmulConfig:
    return QuantizedMatmulConfig(
        input_cfg=DSBPConfig(**d["input_cfg"]),
        weight_cfg=DSBPConfig(**d["weight_cfg"]),
    )


def _kv_to_dict(cfg: KVQuantConfig | None):
    return None if cfg is None else {"bits": cfg.bits, "fmt": cfg.fmt}


def _kv_from_dict(d) -> KVQuantConfig | None:
    return None if d is None else KVQuantConfig(bits=d["bits"], fmt=d["fmt"])


@dataclasses.dataclass
class DSBPPolicy:
    """Per-layer-path quantization assignment + provenance metadata.

    ``layers`` maps projection path keys to full configs; ``default`` (a
    config or a PRESETS name) covers quantizable projections the mapping
    does not name; ``meta`` is free-form JSON-able provenance.
    ``kv_layers`` / ``kv_default`` are the KV-cache side of a joint
    artifact: cache-entry names mapped to KV specs (KV_PRESETS names, int
    bitwidths, configs, or None for a float entry).  The engine takes the
    whole policy as ``ServeConfig.pack_preset`` and as ``kv_quant``."""

    layers: dict[str, QuantizedMatmulConfig] = dataclasses.field(default_factory=dict)
    default: QuantizedMatmulConfig | None = None
    meta: dict = dataclasses.field(default_factory=dict)
    kv_layers: dict[str, KVQuantConfig | None] = dataclasses.field(default_factory=dict)
    kv_default: KVQuantConfig | None = None

    def __post_init__(self):
        if isinstance(self.default, str):
            self.default = PRESETS[self.default]
        self.layers = {k: (PRESETS[v] if isinstance(v, str) else v)
                       for k, v in self.layers.items()}
        self.kv_default = resolve_kv_spec(self.kv_default)
        self.kv_layers = {k: resolve_kv_spec(v) for k, v in self.kv_layers.items()}

    # ---- lookup ----

    def config_for(self, path_key: str) -> QuantizedMatmulConfig | None:
        """Config for one projection path; ``default`` when unnamed."""
        return self.layers.get(path_key, self.default)

    def kv_spec_for(self, entry: str) -> KVQuantConfig | None:
        """KV spec for one cache entry (``units.{pos}`` / ``tail.{i}``);
        ``kv_default`` when unnamed."""
        return self.kv_layers.get(entry, self.kv_default)

    def replace_layer(self, path_key: str, cfg: QuantizedMatmulConfig) -> "DSBPPolicy":
        layers = dict(self.layers)
        layers[path_key] = cfg
        return DSBPPolicy(layers=layers, default=self.default, meta=dict(self.meta),
                          kv_layers=dict(self.kv_layers), kv_default=self.kv_default)

    def with_kv(self, kv_layers, kv_default=None,
                meta_update: dict | None = None) -> "DSBPPolicy":
        """Joint weight+KV policy: the same weight assignment, the KV side
        replaced.  A ``"default"`` key of ``kv_layers`` (the shape
        :func:`~repro_torch.policy.kv_bits.price_kv_bits` returns) becomes
        ``kv_default``."""
        kv_layers = dict(kv_layers)
        kv_default = kv_layers.pop("default", kv_default)
        meta = dict(self.meta)
        meta.update(meta_update or {})
        return DSBPPolicy(layers=dict(self.layers), default=self.default,
                          meta=meta, kv_layers=kv_layers, kv_default=kv_default)

    @classmethod
    def uniform(cls, cfg: QuantizedMatmulConfig | str,
                layer_keys=(), meta: dict | None = None) -> "DSBPPolicy":
        """One config everywhere: the degenerate policy that serves what
        the same config as a global preset serves."""
        cfg = PRESETS[cfg] if isinstance(cfg, str) else cfg
        return cls(layers={k: cfg for k in layer_keys}, default=cfg,
                   meta=dict(meta or {}))

    # ---- serialization ----

    def to_json(self) -> str:
        # version 1, as JAX's: the KV keys are additive and read with
        # defaults, so weight-only blobs round-trip too
        return json.dumps({
            "version": 1,
            "layers": {k: _cfg_to_dict(v) for k, v in sorted(self.layers.items())},
            "default": None if self.default is None else _cfg_to_dict(self.default),
            "kv_layers": {k: _kv_to_dict(v) for k, v in sorted(self.kv_layers.items())},
            "kv_default": _kv_to_dict(self.kv_default),
            "meta": self.meta,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "DSBPPolicy":
        d = json.loads(blob)
        return cls(
            layers={k: _cfg_from_dict(v) for k, v in d["layers"].items()},
            default=None if d["default"] is None else _cfg_from_dict(d["default"]),
            meta=d.get("meta", {}),
            kv_layers={k: _kv_from_dict(v) for k, v in d.get("kv_layers", {}).items()},
            kv_default=_kv_from_dict(d.get("kv_default")),
        )

    def to_tree(self) -> dict:
        """The policy as a one-leaf tree for ``checkpoint.store.save``."""
        blob = np.frombuffer(self.to_json().encode("utf-8"), np.uint8).copy()
        return {POLICY_LEAF: blob}

    @classmethod
    def from_tree(cls, tree: dict) -> "DSBPPolicy":
        return cls.from_json(bytes(np.asarray(tree[POLICY_LEAF])).decode("utf-8"))

    def save(self, ckpt_dir: str, step: int = 0) -> str:
        """Atomic save under ``<ckpt_dir>/step_<N>`` via checkpoint.store."""
        from repro_torch.checkpoint import store

        return store.save(ckpt_dir, step, self.to_tree())

    @classmethod
    def load(cls, ckpt_dir: str, step: int | None = None) -> "DSBPPolicy":
        from repro_torch.checkpoint import store

        flat, _ = store.restore_flat(ckpt_dir, step=step)
        return cls.from_tree(flat)

    # ---- introspection ----

    def summary(self) -> str:
        """One line per layer: path, mode, (k, b_in/b_w); KV entries after."""
        lines = []
        for key in sorted(self.layers):
            c = self.layers[key]
            ic, wc = c.input_cfg, c.weight_cfg
            lines.append(
                f"{key:40s} {c.mode:8s} k={ic.k:g} "
                f"b_fix={ic.b_fix}/{wc.b_fix} fmt={ic.fmt}/{wc.fmt}"
            )
        for key in sorted(self.kv_layers):
            c = self.kv_layers[key]
            desc = "float" if c is None else f"kv{c.bits} fmt={c.fmt}"
            lines.append(f"{'kv:' + key:40s} {desc}")
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self.layers)
