"""Serving engine: pack-once DSBP weights and length-aware batching.

Port of the dense main path of ``repro.serve.engine``: ``ServeConfig``
(main-path fields and the DSBP-quantized KV cache's ``kv_quant`` /
``kv_bits``), ``Request``, ``PROJ_NAMES``, ``pack_weights_int8`` (:229),
``sample_tokens`` (:287) and ``Engine`` with ``__init__`` (pack once,
``pack_report``, ``_norm_kv`` :667), ``generate`` (:867) and the dense
``serve`` slot scheduler (:951) with ``_admit`` (:1175).

When the config carries a quant preset, every projection is packed ONCE
at ``Engine.__init__`` into a :class:`PackedDSBPWeight` (int8 aligned
mantissas + one f32 scale per 64-group) and runs through the fused
one-pass DSBP GEMM (``quant_method='dsbp_fused'``).  The engine takes the
model over: its projections are replaced by the packed containers, and it
moves to the engine's device.  Where the JAX engine donates its cache to a
jitted step, this one keeps a preallocated KV pool and updates it in
place.  With ``kv_quant`` every cache write quantizes K/V into int8
aligned mantissas + pow2 scales, and decode attention reads them packed.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.packed import PackedDSBPWeight
from repro_torch.core.quantized import PRESETS, pack_weights
from repro_torch.kvq import kv_cache_nbytes, resolve_kv_spec, tree_has_packed_kv
from repro_torch.models import blocks
from repro_torch.models.layers import Quant
from repro_torch.models.model import Model

__all__ = ["ServeConfig", "Request", "Engine", "PROJ_NAMES",
           "pack_weights_int8", "sample_tokens"]

# projection leaf names that carry a DSBP-quantizable GEMM
PROJ_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "w1", "w2", "w3", "w_in", "w_gate", "w_out",
    "wa", "wx",
})


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    batch_size: int = 4          # slot-pool size for serve()
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0
    # pack projections once at Engine.__init__ when a preset is configured
    # (cfg.quant, or pack_preset: a PRESETS name); False serves raw weights,
    # quantizing them on every matmul call
    pack: bool = True
    pack_preset: str | None = None
    # quantized-linear method; None = 'dsbp_fused' when the config quantizes
    quant_method: str | None = None
    eos_id: int | None = None    # serve(): a slot frees when this is sampled
    prefill_bucket: int = 16     # admission prompts pad up to a multiple
    # DSBP-quantized KV cache: a preset name ('kv8'/'kv6'/'kv4'), an int
    # total bitwidth in [2, 8], a repro_torch.kvq.KVQuantConfig, True (kv8)
    # or a per-entry mapping {'units.<i>': spec, 'tail.<i>': spec,
    # 'default': spec}; None serves the float cache
    kv_quant: object = None
    kv_bits: int | None = None   # uniform shorthand for kv_quant (exclusive)


@dataclasses.dataclass
class Request:
    """One queued generation request for :meth:`Engine.serve`."""
    uid: object
    tokens: np.ndarray           # (L,) prompt token ids
    max_new_tokens: int = 32


def pack_weights_int8(model: Model, preset="precise") -> dict:
    """Offline DSBP pass over every projection, run ONCE and in place:
    each raw 2-D projection parameter named in :data:`PROJ_NAMES` (with at
    least one full group of rows) becomes a :class:`PackedDSBPWeight` on
    the same device.  Returns the average packed weight width (incl. the
    sign bit) and the number of projections packed."""
    if isinstance(preset, str):
        if preset not in PRESETS:
            raise ValueError(f"unknown quant preset {preset!r}: valid presets "
                             f"are {sorted(PRESETS)}")
        preset = PRESETS[preset]
    bits_sum, groups, layers = 0, 0, 0
    for module in list(model.modules()):
        for name, p in list(module.named_parameters(recurse=False)):
            if (name not in PROJ_NAMES or p.ndim < 2
                    or p.shape[-2] < preset.weight_cfg.group_size):
                continue
            pw = pack_weights(p.data, preset)
            delattr(module, name)  # frees the raw weight as we go
            setattr(module, name, pw)
            bits_sum += int((pw.bits.to(torch.int64) + 1).sum())
            groups += pw.bits.numel()
            layers += 1
    return {"avg_w_bits": bits_sum / max(groups, 1), "layers_packed": layers}


def _nbytes(model: Model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """THE token selection: greedy argmax (temperature 0, first maximum on
    ties) or categorical sampling from ``generator``.  logits: (B, V)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class Engine:
    """Length-aware batching server over ``Model.prefill``/``decode_step``.

    * :meth:`generate` — one batch in, ``(B, n_new)`` out; ragged prompts
      via ``lengths``, each row generating what it generates alone.
    * :meth:`serve` — a queue of :class:`Request` through a fixed pool of
      ``batch_size`` slots, freed slots refilled from the queue mid-flight.

    Runs on the CUDA card unless ``device`` names another device.
    """

    def __init__(self, model: Model, scfg: ServeConfig, *, device=None):
        self.device = resolve_device(device)
        cfg = model.cfg
        preset = scfg.pack_preset if scfg.pack_preset is not None else cfg.quant
        if cfg.quant is not None and (scfg.quant_method or cfg.quant_method) is None:
            cfg = cfg.replace(quant_method="dsbp_fused")
        elif scfg.quant_method is not None:
            cfg = cfg.replace(quant_method=scfg.quant_method)
        self.cfg = cfg
        self.scfg = scfg
        self.kv_spec = self._norm_kv(scfg)
        self.quant = Quant(cfg.quant, cfg.quant_method)
        self.model = model.to(self.device)
        self.pack_report = None
        packed = any(isinstance(m, PackedDSBPWeight) for m in model.modules())
        if scfg.pack and preset is not None and not packed:
            raw = _nbytes(self.model)
            with torch.no_grad():
                stats = pack_weights_int8(self.model, preset)
            self.pack_report = {"preset": preset, "raw_nbytes": raw,
                                "packed_nbytes": _nbytes(self.model), **stats}
        self.last_stats: dict | None = None

    @staticmethod
    def _norm_kv(scfg: ServeConfig):
        """``kv_quant``/``kv_bits`` -> None, a KVQuantConfig, or a mapping
        of resolved configs; spec errors surface at construction."""
        kv = scfg.kv_quant
        if scfg.kv_bits is not None:
            if kv is not None:
                raise ValueError("kv_bits is a uniform shorthand for kv_quant: "
                                 "set one, not both")
            kv = int(scfg.kv_bits)
        if isinstance(kv, Mapping):
            return {str(k): resolve_kv_spec(v) for k, v in kv.items()}
        return resolve_kv_spec(kv)

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.scfg.seed)

    def _sample(self, logits, gen) -> torch.Tensor:
        return sample_tokens(logits, self.scfg.temperature, gen)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # batch API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, prompts, n_new: int, lengths=None) -> np.ndarray:
        """prompts (B, L) token ids, right-padded when ragged; ``lengths``
        (B,) each row's true prompt length.  Returns (B, n_new) tokens and
        records prefill/decode wall times in ``last_stats``."""
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        dev, scfg = self.device, self.scfg
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        logits, cache, length = self.model.prefill(
            toks, scfg.max_len, lengths=lengths, quant=self.quant, kv=self.kv_spec)
        b = toks.shape[0]
        pos = torch.as_tensor(length, dtype=torch.int32, device=dev).expand(b).clone()
        gen = self._generator()
        tok = self._sample(logits[:, -1], gen)
        self._sync()
        t1 = time.perf_counter()
        outs = [tok]
        for _ in range(n_new - 1):
            logits, cache = self.model.decode_step(tok[:, None], cache, pos, self.quant)
            pos += 1
            tok = self._sample(logits[:, -1], gen)
            outs.append(tok)
        out = torch.stack(outs, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        self.last_stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                           "decode_steps": n_new - 1,
                           "decode_tokens": b * (n_new - 1)}
        return out

    # ------------------------------------------------------------------
    # continuous batching
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def serve(self, requests, max_new_tokens: int = 32) -> dict:
        """Run a queue of requests (:class:`Request` or plain token
        sequences) through the slot pool; returns {uid: generated ids} and
        records scheduler stats in ``last_stats``."""
        scfg, dev = self.scfg, self.device
        queue = self._build_queue(requests, max_new_tokens)
        nreq = len(queue)
        B = scfg.batch_size
        pool = self.model.init_cache(B, scfg.max_len, kv=self.kv_spec)
        # KV bytes one slot's token pins, from the leaves' actual dtypes
        kv_bpt = kv_cache_nbytes(pool) / max(B * scfg.max_len, 1)
        active: list[Request | None] = [None] * B
        tok = np.zeros(B, np.int64)        # last sampled token per slot
        pos = np.zeros(B, np.int32)        # next absolute position per slot
        out: dict = {}
        gen = self._generator()
        stats = {"decode_steps": 0, "occupied_lanes": 0, "admissions": 0,
                 "prefill_tokens": 0, "decode_tokens": 0, "prefill_time_s": 0.0,
                 "decode_time_s": 0.0}
        while queue or any(s is not None for s in active):
            free = [i for i in range(B) if active[i] is None]
            if queue and free:
                t0 = time.perf_counter()
                self._admit(pool, queue, free, active, tok, pos, out, stats, gen)
                stats["prefill_time_s"] += time.perf_counter() - t0
            if not any(s is not None for s in active):
                continue  # every admitted request finished at token 1
            stats["decode_steps"] += 1
            stats["occupied_lanes"] += sum(s is not None for s in active)
            t0 = time.perf_counter()
            logits, pool = self.model.decode_step(
                torch.as_tensor(tok, device=dev)[:, None], pool,
                torch.as_tensor(pos, device=dev), self.quant)
            nxt = self._sample(logits[:, -1], gen).cpu().numpy()  # syncs
            stats["decode_time_s"] += time.perf_counter() - t0
            for i in range(B):
                r = active[i]
                if r is None:
                    continue  # idle lane: output ignored, slot unchanged
                pos[i] += 1
                t = int(nxt[i])
                out[r.uid].append(t)
                tok[i] = t
                stats["decode_tokens"] += 1
                if self._done(t, out[r.uid], r):
                    active[i] = None  # freed; the next admission reuses it
        self.last_stats = dict(
            stats, requests=nreq,
            occupancy=stats["occupied_lanes"] / max(stats["decode_steps"] * B, 1),
            decode_tps=stats["decode_tokens"] / max(stats["decode_time_s"], 1e-9),
            kv_bytes_per_token=kv_bpt, kv_packed=tree_has_packed_kv(pool))
        return {uid: np.asarray(t, np.int64) for uid, t in out.items()}

    def _admit(self, pool, queue, free, active, tok, pos, out, stats, gen):
        """Admit up to len(free) queued requests: one ragged group prefill
        (padded to a bucket multiple, per-row lengths), then each continuing
        row's K/V is written straight into its slot of the pool — the JAX
        engine builds a fresh cache and copies its rows in (_cache_insert);
        writing in place skips that max_len-sized copy."""
        scfg = self.scfg
        group = [queue.popleft() for _ in range(min(len(free), len(queue)))]
        lens = np.asarray([len(r.tokens) for r in group], np.int32)
        bucket = scfg.prefill_bucket
        L = max(-(-int(lens.max()) // bucket) * bucket, bucket)
        toks = np.zeros((len(group), L), np.int64)
        for j, r in enumerate(group):
            toks[j, : lens[j]] = r.tokens
        lens_t = torch.as_tensor(lens, device=self.device)
        logits, kvs, _ = self.model.prefill_trunk(
            torch.as_tensor(toks, device=self.device), lens_t, self.quant)
        first = self._sample(logits[:, -1], gen).cpu().numpy()
        stats["admissions"] += len(group)
        stats["prefill_tokens"] += int(lens.sum())
        rows, slots = [], []
        for j, r in enumerate(group):
            t = int(first[j])
            out[r.uid] = [t]
            if self._done(t, out[r.uid], r):
                continue  # finished at its first token: the slot stays free
            slot = free.pop(0)
            rows.append(j)
            slots.append(slot)
            active[slot] = r
            tok[slot] = t
            pos[slot] = int(lens[j])
        if rows:
            rows_t = torch.as_tensor(rows, device=self.device)
            for c, (k, v) in zip(pool, kvs):
                blocks.fill_kv_cache(c, k, v, lens_t[rows_t], slots=slots, rows=rows_t)

    def _build_queue(self, requests, max_new_tokens: int) -> deque:
        reqs = [self._norm_request(r, i, max_new_tokens)
                for i, r in enumerate(requests)]
        if len({r.uid for r in reqs}) != len(reqs):
            raise ValueError("request uids must be unique (results key on uid)")
        for r in reqs:
            if len(r.tokens) + r.max_new_tokens > self.scfg.max_len:
                raise ValueError(
                    f"request {r.uid!r}: prompt {len(r.tokens)} + budget "
                    f"{r.max_new_tokens} exceeds max_len {self.scfg.max_len}")
        return deque(reqs)

    def _done(self, t: int, emitted: list, r: Request) -> bool:
        eos = self.scfg.eos_id
        return (eos is not None and t == eos) or len(emitted) >= r.max_new_tokens

    @staticmethod
    def _norm_request(r, i: int, max_new: int) -> Request:
        """Normalize + validate one queue entry, failing here with a clear
        message instead of as a shape error deep inside prefill."""
        if not isinstance(r, Request):
            r = Request(uid=i, tokens=np.asarray(r, np.int64), max_new_tokens=max_new)
        toks = np.asarray(r.tokens, np.int64)
        if toks.ndim != 1 or toks.shape[0] == 0:
            raise ValueError(f"request {r.uid!r}: prompt must be a non-empty "
                             f"1-D token sequence, got shape {tuple(toks.shape)}")
        if int(r.max_new_tokens) < 1:
            raise ValueError(f"request {r.uid!r}: max_new_tokens must be >= 1, "
                             f"got {r.max_new_tokens}")
        try:
            hash(r.uid)
        except TypeError:
            raise ValueError(f"request uid {r.uid!r} is unhashable") from None
        return dataclasses.replace(r, tokens=toks)
