"""DSBP-quantized KV cache (port of ``repro.kvq``)."""
from .packed_kv import (KV_MAX_BITS, KV_MIN_BITS, KV_PRESETS, KVQuantConfig,
                        PackedKVBlock, init_packed_kv, kv_cache_nbytes,
                        kv_policy_cfg, quantize_kv, quantize_like,
                        resolve_kv_spec, tree_has_packed_kv)

__all__ = ["KV_MAX_BITS", "KV_MIN_BITS", "KV_PRESETS", "KVQuantConfig",
           "PackedKVBlock", "init_packed_kv", "kv_cache_nbytes", "kv_policy_cfg",
           "quantize_kv", "quantize_like", "resolve_kv_spec", "tree_has_packed_kv"]
