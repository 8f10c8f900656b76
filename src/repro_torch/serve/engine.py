"""Serving engine: pack-once DSBP weights and length-aware batching.

Port of the dense main path of ``repro.serve.engine``: ``ServeConfig``
(main-path fields and the DSBP-quantized KV cache's ``kv_quant`` /
``kv_bits``), ``Request``, ``PROJ_NAMES`` and ``pack_weights_int8``
(:229, both kept in ``models.packing`` and named here as in JAX),
``sample_tokens`` (:287) and ``Engine`` with ``__init__`` (pack once,
``pack_report``, ``_norm_kv`` :667), ``generate`` (:867), the dense
``serve`` slot scheduler (:951) with ``_admit`` (:1175), the
priority-ordered ``_build_queue`` (:721), and the paged scheduler
(``paged=True``): ``_init_paged`` (:514), ``_serve_paged`` (:1237),
``_reserve_blocks`` (:1475), ``_admit_paged`` (:1515), ``_pick_victim``
(:1636), ``_preempt_lane`` (:1646), ``_release_lane`` (:1675),
``_cow_writable`` (:1683), ``_chunk_step`` (:1755) and ``_requeue``
(:851); and self-speculative decoding (``spec_k > 0``) in both
schedulers: ``_spec_advance`` (:1109), ``_spec_advance_paged`` (:1836)
and ``_spec_summary`` (:1097).  The robustness and observability layers
of both schedulers are here as well: ``REQUEST_STATES`` and the guard
policies (:51), ``ServeConfig.numeric_guard`` / ``invariant_checks`` /
``observe`` / ``obs_max_events``, ``Request.deadline_steps``,
``_ServeControl`` (:217), ``_norm_guard`` (:655), ``cancel`` (:707),
``_robust_stats`` (:716), ``_drain_control`` (:738), ``_apply_guard``
(:777), ``_quarantine`` (:806), the 'fallback' retry through
``dsbp_ref`` (:814, :829), ``_finish`` (:843), ``serve(faults=)`` with
``serve/faults.FaultPlan`` and ``check_invariants``, and the
``obs.ServeRecorder`` hooks (``Engine.obs``).  The DSBP policy loop's
serving side is
here too: ``pack_weights_int8`` (:229) under a per-layer policy (each
projection under ``policy.config_for`` of its stacked key, served in the
``"policy"`` quant mode), ``ServeConfig.pack_preset`` / ``kv_quant``
taking a ``repro_torch.policy.DSBPPolicy`` (``_norm_kv`` :364), and
``score_continuations`` (:904), the likelihood scoring of the eval
harness and the autotuner.  Multi-rank
serving (``mesh_shape``) ports ``_build_mesh`` (:605), ``_trace_ctx``
(:624) and ``_shard_cache`` (:638) for the dense float-KV scheduler and
``generate``; the pool is ``batch_size`` slots (JAX's
``per_device_batch_size`` and ``mesh_axes`` are not ported: the axes are
('data', 'model') until the expert axis is).  The Griffin hybrid's layers
ride in both schedulers as JAX's ``_cache_insert`` modes (:306) have
them: a dense admission scatters recurrent state rows like K/V rows, a
paged one inserts only the lanes' states (its K/V went through the
tables), a chunk lane starts from the pristine state, and idle and
chunk-phase lanes keep theirs through a decode step; the paged pool
takes every KV ring length of the layer kinds (``_kv_scs``, :522).  The
MoE family (mixtral-8x7b) serves through all of them: its expert stacks
pack as one container each with a leading E axis and run weight-only
(``models.moe``); under a mesh it raises naming ROADMAP A13 (the expert
axis).  The SSD family (mamba2-370m) is the first model with no KV layer:
its state rides like the RG-LRU's, and the paged scheduler runs it as
JAX's does (:523-551, :1257-1290), with no allocator, no prefix cache, a
pool of one block and chunks of ``prefill_bucket`` tokens
(``last_stats['kv_blocks']`` 0).  Its chunked scan needs every padded
prompt batch shorter than ``ssd_chunk`` or a multiple of it: serve it
with ``prefill_bucket = cfg.ssd_chunk``.

The two modality frontends ride on ``generate`` alone, as in JAX
(:867-899): an audio model (musicgen-large) takes (B, L, K) codebook
prompts and returns (B, n_new, K) frames, each codebook sampled from its
own block of the head; a vlm model (llava-next-34b) takes
``extra={"image_embeds": ...}``, and its text ``lengths`` grow by the
image prefix.  ``serve`` (both schedulers) and ``score_continuations``
refuse them with JAX's reasons; a mesh refuses them naming ROADMAP A13.

When the config carries a quant preset, every projection is packed ONCE
at ``Engine.__init__`` into a :class:`PackedDSBPWeight` (int8 aligned
mantissas + one f32 scale per 64-group) and runs through the fused
one-pass DSBP GEMM (``quant_method='dsbp_fused'``).  The engine takes the
model over: its projections are replaced by the packed containers, and it
moves to the engine's device.  Where the JAX engine donates its cache to a
jitted step, this one keeps a preallocated KV pool and updates it in
place.  With ``kv_quant`` every cache write quantizes K/V into int8
aligned mantissas + pow2 scales, and decode attention reads them packed.

With ``paged=True``, ``serve`` keeps K/V in one pool of ``kv_block_size``
-token blocks per layer, addressed through a block table per lane:
admission waits for free blocks instead of free slots, requests that share
a prompt prefix share refcounted blocks (split copy-on-write on the first
divergent write), long prompts prefill in chunks between decode steps, and
a higher-priority request preempts a lower one, which is recomputed when
it resumes.  Paged decode attention reads the pool through the tables with
the B6/B7 kernels.

With ``spec_k > 0`` either scheduler advances its lanes by speculation
rounds (``repro_torch.spec``): the draft is the packed containers'
MSB-slice view (``spec_draft_bits``), derived per projection at call time,
so it adds no weight bytes (``spec_report``); ``spec_k`` tokens are
drafted, verified in one target forward, and the longest greedy-matching
prefix commits.  Committed tokens are the target's own argmax, so the
stream is the non-speculative one (up to near ties between the batched
verify and sequential decode).  ``kv_draft_bits`` lets the draft attend a
narrower view of a packed KV cache.

Every request ends in one of ``REQUEST_STATES`` (``last_stats
['request_status']``, set even when the loop raises).  Requests can be
cancelled (:meth:`Engine.cancel`, or a plan's schedule) and expire
(``deadline_steps``); a ``numeric_guard`` checks the sampling logits of
every step on the device, its verdict crossing to the host in the same
copy as the tokens, and fails fast, quarantines the lane, or retries the
step through ``dsbp_ref``.  That retry rewrites the same slots the failed
step wrote (the cache updates in place) before any attention reads them,
so it equals JAX's retry from the pre-step cache.  ``observe=True``
records lifecycle spans, metrics and guard-trip health (``Engine.obs``).

With ``mesh_shape=(D, M)`` the engine is one rank of a ``torch.distributed``
group of ``D*M`` processes (``launch.mesh.spawn``), each running the same
host scheduler in lockstep.  Weights are cut and packed per rank
(``parallel.sharding``: the Megatron split over 'model', by whole heads),
every projection runs the fused GEMM on its shards
(``'dsbp_fused_sharded'``, B8: the input scale reduced over the ranks that
split the activation, row-parallel partials folded with one all_reduce),
the logits assemble over 'model', and the pool of ``batch_size`` slots
splits over 'data' (where the data axis divides it): each data rank decodes
the slots it holds, and the sampled tokens assemble with one all_reduce.
Admission prefills run the whole group on every data rank (the input
scale then spans the group as on one device); each rank keeps the K/V of
its own slots.  Guards, fault plans and the recorder are not ported to
the mesh (ROADMAP A13).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
from collections import deque
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.packed import PackedDSBPWeight
from repro_torch.kernels.ops import finite_flags
from repro_torch.kvq import (KV_MAX_BITS, KV_MIN_BITS, kv_cache_nbytes, resolve_kv_spec,
                             tree_has_packed_kv)
from repro_torch.models.layers import Quant
from repro_torch.models.model import Model
from repro_torch.models.packing import PROJ_NAMES, pack_weights_int8
from repro_torch.obs import ServeRecorder
from repro_torch.parallel import context as PC
from repro_torch.parallel import sharding as SH
from repro_torch.serve import blocks as SB
from repro_torch.serve import faults as FA
from repro_torch.spec import (acceptance_summary, build_spec_round,
                              build_spec_round_paged)

__all__ = ["ServeConfig", "Request", "Engine", "PROJ_NAMES", "REQUEST_STATES",
           "pack_weights_int8", "sample_tokens"]

# terminal request lifecycle states: every served uid ends in exactly one,
# reported in last_stats["request_status"]
REQUEST_STATES = ("ok", "preempted", "cancelled", "deadline", "quarantined")

_GUARD_POLICIES = ("fail-fast", "quarantine", "fallback")

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    batch_size: int = 4          # slot-pool size for serve()
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0
    # pack projections once at Engine.__init__ when a preset is configured
    # (cfg.quant, or pack_preset: a PRESETS name, a QuantizedMatmulConfig,
    # or a repro_torch.policy.DSBPPolicy of per-layer configs, served in
    # the 'policy' quant mode); False serves raw weights, quantizing them
    # on every matmul call
    pack: bool = True
    pack_preset: object = None
    # quantized-linear method; None = 'dsbp_fused' when the config quantizes
    quant_method: str | None = None
    eos_id: int | None = None    # serve(): a slot frees when this is sampled
    prefill_bucket: int = 16     # admission prompts pad up to a multiple
    # DSBP-quantized KV cache: a preset name ('kv8'/'kv6'/'kv4'), an int
    # total bitwidth in [2, 8], a repro_torch.kvq.KVQuantConfig, True (kv8)
    # or a per-entry mapping {'units.<i>': spec, 'tail.<i>': spec,
    # 'default': spec}; a DSBPPolicy is read by its kv_layers / kv_default;
    # None serves the float cache
    kv_quant: object = None
    kv_bits: int | None = None   # uniform shorthand for kv_quant (exclusive)
    # --- self-speculative decoding ---
    # spec_k > 0 makes serve() speculative: per pool step, draft spec_k
    # tokens per lane with the MSB-slice view of the packed weights, verify
    # them in ONE target forward, commit the longest greedy-matching prefix
    # (1 .. spec_k + 1 tokens) and roll the cache back past it.  Greedy only
    # (temperature 0).  Committed tokens are the target's argmax over the
    # verify logits, equal to sequential decode's up to float round-off, so
    # the stream is the non-speculative one except at near ties
    spec_k: int = 0
    # aligned-mantissa width of the draft view: an int, or a per-layer
    # artifact {path: bits, 'default': bits} (repro_torch.spec.draft)
    spec_draft_bits: object = 4
    # quantized-linear method of the DRAFT forward ('dsbp_ref': the plain
    # integer path, as JAX's default; None inherits the serving method)
    spec_draft_method: str | None = "dsbp_ref"
    # speculative rounds draft over an even narrower view of a packed KV
    # cache (repro_torch.kvq.kv_narrow_view); the verify and the committed
    # writes keep the serving width, so tokens never change, only
    # acceptance.  Needs kv_quant; None drafts over the serving width
    kv_draft_bits: int | None = None
    # --- multi-rank serving ---
    # mesh_shape (D, M) makes the engine one rank of a torch.distributed
    # group of D*M processes: weights cut and packed per rank (Megatron
    # split over 'model'), projections through 'dsbp_fused_sharded' (B8),
    # the batch_size slots split over 'data'; the axes are ('data',
    # 'model').  (1, 1) needs no process group and serves as no mesh; None
    # (default) is the single-device engine
    mesh_shape: tuple[int, ...] | None = None
    # --- paged KV cache ---
    # paged=True swaps serve()'s dense per-slot caches for a pool of
    # kv_block_size-token blocks addressed through per-lane block tables:
    # admission is gated on free blocks, requests sharing a prompt prefix
    # share refcounted blocks (copy-on-write on the first divergent
    # write), long prompts prefill in prefill_bucket-sized chunks
    # interleaved with decode steps, and a reservation or COW split the pool
    # cannot meet preempts a lower-priority lane (recomputed on resume)
    paged: bool = False
    kv_block_size: int = 16      # ring slots per block; must divide max_len
    # blocks in the pool INCLUDING the reserved scratch block 0; None sizes
    # it to the dense engine's KV budget: batch_size * max_len / bs + 1
    kv_blocks: int | None = None
    # concurrent lanes of the paged scheduler (None = batch_size); blocks
    # are the real budget, so prefix sharing can serve more lanes
    max_active: int | None = None
    # prompts STRICTLY longer than this admit via chunked prefill (None:
    # 4 * prefill_bucket); chunked admissions skip prefix sharing
    chunk_prefill_tokens: int | None = None
    prefix_sharing: bool = True  # hash-chained prefix cache + COW splits
    # --- robustness layer ---
    # per-step finiteness check of the logits every sampling decision reads,
    # with a policy for non-finite lanes:
    #   None / 'off'  -- no guard (no check runs at all)
    #   'fail-fast'   -- raise serve.faults.NumericFault (whole batch)
    #   'quarantine'  -- release the lane, keep its partial output, status
    #                    'quarantined' ('quarantine-lane' alias)
    #   'fallback'    -- retry the step through the dsbp_ref reference path
    #                    (it rewrites the slots the step wrote), then
    #                    quarantine if still non-finite; not with spec_k
    numeric_guard: str | None = None
    # paged scheduler: assert serve.faults.check_invariants after every
    # iteration (always on while a FaultPlan is active)
    invariant_checks: bool = False
    # --- observability ---
    # observe=True threads repro_torch.obs.ServeRecorder through the
    # scheduler: lifecycle spans (Engine.obs.trace), a metrics registry
    # (Engine.obs.metrics) and guard-trip health (Engine.obs.health);
    # last_stats is the same either way
    observe: bool = False
    # trace-event capacity; past it events are counted as dropped
    obs_max_events: int = 200_000


@dataclasses.dataclass
class Request:
    """One queued generation request for :meth:`Engine.serve`."""
    uid: object
    tokens: np.ndarray           # (L,) prompt token ids
    max_new_tokens: int = 32
    # higher admits first and is never preempted by a lower value; the
    # paged scheduler only evicts a victim strictly below the contender
    priority: int = 0
    # scheduler iterations the request may stay resident after its first
    # admission before it is released with status 'deadline' (None: none)
    deadline_steps: int | None = None


@dataclasses.dataclass
class _ServeControl:
    """Per-serve() bookkeeping shared by both schedulers and every helper
    they call."""
    stats: dict
    out: dict                    # uid -> emitted token list
    status: dict                 # uid -> lifecycle state (REQUEST_STATES)
    faults: object | None = None
    step: int = 0                # scheduler iteration counter
    admit_step: dict = dataclasses.field(default_factory=dict)
    preempts: dict = dataclasses.field(default_factory=dict)
    gen: torch.Generator | None = None  # the serve's sampling generator


def _nbytes(model: Model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  generator: torch.Generator | None = None,
                  out: torch.Tensor | None = None, n_codebooks: int = 0) -> torch.Tensor:
    """THE token selection: greedy argmax (temperature 0, first maximum on
    ties) or categorical sampling from ``generator``.  logits: (B, V);
    ``out`` an optional (B,) int64 tensor the tokens are written into.
    With ``n_codebooks`` K (an audio head, V = K * Vp) each codebook block
    is sampled on its own, as (B * K, Vp) rows from the one generator, and
    the tokens come back (B, K) (JAX :287-303)."""
    if n_codebooks:
        b = logits.shape[0]
        tok = sample_tokens(logits.reshape(b * n_codebooks, -1), temperature,
                            generator).reshape(b, n_codebooks)
        return tok if out is None else out.copy_(tok)
    if temperature <= 0:
        return torch.argmax(logits, dim=-1, out=out)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return tok if out is None else out.copy_(tok)


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
        packed = any(isinstance(m, PackedDSBPWeight) for m in model.modules())
        # a DSBPPolicy to pack with flips serving into the per-layer
        # 'policy' quant mode: each container runs under its own config
        if hasattr(preset, "config_for") or (cfg.quant == "policy" and packed):
            cfg = cfg.replace(quant="policy")
        # serving default: the fused one-pass kernel — its per-rank form
        # (B8) under a mesh — unless the arch config or ServeConfig pins one
        if cfg.quant is not None and (scfg.quant_method or cfg.quant_method) is None:
            cfg = cfg.replace(quant_method=("dsbp_fused" if scfg.mesh_shape is None
                                            else "dsbp_fused_sharded"))
        elif scfg.quant_method is not None:
            cfg = cfg.replace(quant_method=scfg.quant_method)
        self.cfg = cfg
        self.scfg = scfg
        self.kv_spec = self._norm_kv(scfg)
        self.quant = Quant(cfg.quant, cfg.quant_method)
        # --- robustness layer ---
        self._guard = self._norm_guard(scfg.numeric_guard)
        if self._guard == "fallback" and scfg.spec_k:
            raise ValueError(
                "numeric_guard='fallback' retries a decode step through the "
                "reference path, but a speculative round commits its tokens "
                "inside one jit and cannot be re-run — use 'quarantine' or "
                "'fail-fast' with spec_k")
        self._cancel_pending: set = set()
        # the guard's device reduction (None: no guard, no check runs)
        self._finite = finite_flags if self._guard else None
        self._last_alloc = self._last_prefix = None  # post-serve conservation checks
        # --- observability: one recorder for both schedulers, a bag of
        # no-ops unless observe=True
        self.obs = ServeRecorder(enabled=scfg.observe, max_events=scfg.obs_max_events)
        if scfg.mesh_shape is not None:
            self._check_mesh_config(preset)
        self.mesh = self._build_mesh(scfg, self.device)
        self._init_spec()
        if scfg.paged:
            self._init_paged(model)
        self.model = model.to(self.device)
        self.pack_report = None
        if scfg.pack and preset is not None and not packed:
            raw = _nbytes(self.model)
            with torch.no_grad():
                stats = pack_weights_int8(self.model, preset, mesh=self.mesh)
            self.pack_report = {"preset": preset, "raw_nbytes": raw,
                                "packed_nbytes": _nbytes(self.model), **stats}
        self._plan = {}
        if self.mesh is not None:
            # whatever is still global (raw weights of a float model, lm_head,
            # containers that arrived packed) is cut to this rank's shard
            cuts = SH.serve_cuts(cfg, self.mesh)
            with torch.no_grad():
                SH.shard_model(self.model, cuts)
            self._plan = {name: (c.k_axis, c.n_axis) for name, c in cuts.items()}
        self.last_stats: dict | None = None

    # ------------------------------------------------------------------
    # multi-rank plumbing
    # ------------------------------------------------------------------

    def _check_mesh_config(self, preset) -> None:
        """What this slice serves under a mesh: the dense float-KV
        scheduler and ``generate``, packed weights through
        'dsbp_fused_sharded' (or a float model)."""
        scfg, cfg = self.scfg, self.cfg
        missing = []
        if scfg.paged:
            missing.append("the paged KV pool (paged=True)")
        if self.kv_spec is not None:
            missing.append("a DSBP-quantized KV cache (kv_quant/kv_bits)")
        if cfg.quant is not None and cfg.quant_method != "dsbp_fused_sharded":
            missing.append(f"quant_method {cfg.quant_method!r} (only 'dsbp_fused_sharded')")
        if cfg.quant is not None and (not scfg.pack or preset is None):
            missing.append("per-call quantization of raw weights (pack=False)")
        if scfg.spec_k:
            missing.append("speculative rounds (spec_k > 0)")
        kinds = sorted(set(cfg.pattern) - {"attn_full"})
        if kinds:
            what = {"attn_local": "sliding-window rings", "rglru": "the RG-LRU's recurrent state",
                    "ssd": "the SSD state"}
            missing.append(f"layer kinds {kinds} ({', '.join(what[k] for k in kinds)})")
        if cfg.tie_embeddings:
            missing.append("tied embeddings (the head over embed.T)")
        if cfg.n_experts:
            missing.append(f"MoE layers ({cfg.n_experts} experts: the expert axis)")
        if cfg.frontend != "none":
            missing.append(f"the {cfg.frontend} frontend (generate over embedded prompts)")
        if cfg.quant == "policy":
            missing.append("a DSBPPolicy (per-layer configs)")
        if cfg.dtype != "float32":
            missing.append(f"the {cfg.dtype} dtype (a float32 model only)")
        if self._guard is not None:
            missing.append(f"the numeric guard (numeric_guard={scfg.numeric_guard!r})")
        if scfg.observe:
            missing.append("the serve recorder (observe=True)")
        if missing:
            raise NotImplementedError(
                "under a mesh the port serves the dense float-KV scheduler only; not "
                "ported yet (ROADMAP A13): " + "; ".join(missing))

    @staticmethod
    def _build_mesh(scfg: ServeConfig, device):
        """This rank's mesh (None without ``mesh_shape``); raises unless a
        process group of ``prod(mesh_shape)`` ranks is initialized — only a
        mesh of one rank runs without one."""
        if scfg.mesh_shape is None:
            return None
        from repro_torch.launch.mesh import make_mesh

        return make_mesh(scfg.mesh_shape, device=device)

    def _trace_ctx(self, rows_split: bool):
        """The sharding context every model call runs under (none without
        a mesh): the weights' plan, and the data axis as a batch axis when
        this rank's activation rows are its own share."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return PC.sharding_ctx(self.mesh, SH.batch_axes(self.mesh) if rows_split else (),
                               self._plan)

    def _shard_cache(self, batch: int) -> slice | None:
        """The rows of a ``batch``-row cache this rank holds (the dense
        rule of ``cache_pspecs``): its share over 'data', or None for all
        of them (no mesh, or a batch the data axis does not divide)."""
        return SH.cache_rows(self.mesh, batch) if self.mesh is not None else None

    def _sample_rows(self, logits, gen, rows: slice | None, n: int) -> torch.Tensor:
        """Tokens of all ``n`` rows on every rank from this rank's logits
        of ``rows`` (None: of every row, replicated over 'data'): sampled
        here, placed in a zero-filled (n,) tensor and summed over 'data'
        — a replicated batch contributes data rank 0's, so every rank goes
        on with the same tokens whatever its generator drew."""
        tok = self._sample(logits, gen)
        if self.mesh is None or self.mesh.shape["data"] == 1:
            return tok
        full = torch.zeros(n, dtype=torch.int64, device=tok.device)
        if rows is not None:
            full[rows] = tok
        elif self.mesh.coords["data"] == 0:
            full.copy_(tok)
        return self.mesh.all_reduce(full, "sum", "data")

    def _collectives(self) -> collections.Counter:
        """A copy of this rank's collective counts (empty without a mesh)."""
        return collections.Counter(self.mesh.collectives if self.mesh else ())

    def _mesh_stats(self, coll: collections.Counter, steps: int) -> dict:
        if self.mesh is None:
            return {}
        return {"mesh_shape": tuple(self.scfg.mesh_shape), "pool_size": self.scfg.batch_size,
                "collectives_per_decode_step": {k: v / max(steps, 1)
                                                for k, v in sorted(coll.items())}}

    def _init_spec(self):
        """The speculation rounds of both schedulers (None without
        ``spec_k``), validated with JAX's messages, and ``spec_report``."""
        scfg, cfg = self.scfg, self.cfg
        self._spec = self._spec_paged = None
        self.spec_report = None
        if not scfg.spec_k:
            return
        if scfg.temperature > 0:
            raise ValueError(
                "speculative serving uses greedy token-match acceptance; "
                "set temperature=0 (temperature sampling acceptance is "
                "not implemented)")
        if cfg.window and 0 < cfg.window <= scfg.spec_k:
            raise ValueError(
                f"spec_k={scfg.spec_k} needs spec_k+1 <= window "
                f"({cfg.window}): a verify pass must not wrap its own "
                f"tokens around the SWA ring cache")
        args = (cfg, scfg.spec_k, scfg.spec_draft_bits, scfg.spec_draft_method)
        guard = self._guard is not None  # the round returns its finiteness mask
        if scfg.paged:
            self._spec_paged = build_spec_round_paged(
                *args, max_len=scfg.max_len, guard=guard, kv_draft_bits=scfg.kv_draft_bits)
        else:
            self._spec = build_spec_round(*args, guard=guard, kv_draft_bits=scfg.kv_draft_bits)
        # the draft view is derived per projection at call time: the
        # engine's containers are the only weights
        self.spec_report = {
            "spec_k": scfg.spec_k,
            "draft_bits": scfg.spec_draft_bits,
            "draft_method": scfg.spec_draft_method,
            "kv_draft_bits": scfg.kv_draft_bits,
            "extra_weight_nbytes": 0,
        }

    def _init_paged(self, model: Model):
        """Pool geometry of the paged scheduler, validated at
        construction: the ring lengths S_c of the model's KV layers
        (``blocks.cache_len``; an ``attn_local`` ring is min(max_len,
        window) slots long), each a multiple of the block size.  A model
        with no KV layer (the SSD stack) has no pool to page: no
        allocator, no prefix cache, a pool of one block, chunks of
        ``prefill_bucket`` tokens (JAX :523-551)."""
        scfg, cfg = self.scfg, self.cfg
        bs = int(scfg.kv_block_size)
        if bs < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {bs}")
        self._kv_scs = model.kv_ring_lens(scfg.max_len)
        for s_c in self._kv_scs:
            if s_c % bs:
                raise ValueError(
                    f"kv_block_size {bs} must divide every KV cache length; "
                    f"layer S_c {s_c} (max_len {scfg.max_len}, window "
                    f"{cfg.window}) is not a multiple")
        self._s_c = s_c = self._kv_scs[-1] if self._kv_scs else 0
        # prefix sharing is sound only while no KV ring has wrapped during
        # the prompt: prompts longer than the shortest ring neither take
        # nor register hits
        self._share_limit = self._kv_scs[0] if self._kv_scs else 0
        # one table entry spans kv_block_size ring slots of EVERY KV layer
        span = SB.block_span(s_c, bs)
        self._table_width = max(span, 1)
        self.kv_blocks = (int(scfg.kv_blocks) if scfg.kv_blocks is not None
                          else scfg.batch_size * span + 1)
        if self._kv_scs and self.kv_blocks < 2:
            raise ValueError(f"kv_blocks must be >= 2, got {self.kv_blocks}")
        self.lanes = int(scfg.max_active or scfg.batch_size)
        self._chunk_threshold = int(scfg.chunk_prefill_tokens
                                    or 4 * scfg.prefill_bucket)
        # chunk width: a verify pass must keep its ring slots distinct
        self._chunk_T = min([scfg.prefill_bucket, *self._kv_scs])

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
        # a DSBPPolicy: its per-entry mapping, plus kv_default for the
        # entries it does not name; a policy without a KV side serves a
        # float cache
        if hasattr(kv, "kv_layers"):
            pol = kv
            kv = dict(pol.kv_layers or {})
            kv.setdefault("default", pol.kv_default)
            if not any(v is not None for v in kv.values()):
                kv = None
        if isinstance(kv, Mapping):
            kv = {str(k): resolve_kv_spec(v) for k, v in kv.items()}
        else:
            kv = resolve_kv_spec(kv)
        if scfg.kv_draft_bits is not None:
            if kv is None:
                raise ValueError(
                    "kv_draft_bits needs a packed KV cache: set kv_quant "
                    "(or kv_bits) as well")
            db = int(scfg.kv_draft_bits)
            if not KV_MIN_BITS <= db <= KV_MAX_BITS:
                raise ValueError(
                    f"kv_draft_bits must be in [{KV_MIN_BITS}, "
                    f"{KV_MAX_BITS}], got {db}")
        return kv

    @staticmethod
    def _norm_guard(policy):
        if policy in (None, "off"):
            return None
        if policy == "quarantine-lane":  # the CLI spelling
            return "quarantine"
        if policy not in _GUARD_POLICIES:
            raise ValueError(
                f"unknown numeric_guard {policy!r}: pick one of "
                f"{sorted(_GUARD_POLICIES)} (or 'off')")
        return policy

    def _refuse_frontend(self, reason: str) -> None:
        """JAX's refusal of a modality frontend outside ``generate``
        (:917-920, :963-966): ``reason`` with the frontend's name in its
        ``{}``."""
        if self.cfg.frontend != "none":
            raise NotImplementedError(reason.format(self.cfg.frontend))

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.scfg.seed)

    def _sample(self, logits, gen, out=None) -> torch.Tensor:
        audio = self.cfg.frontend == "audio_codebooks"
        return sample_tokens(logits, self.scfg.temperature, gen, out=out,
                             n_codebooks=self.cfg.n_codebooks if audio else 0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # batch API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, prompts, n_new: int, extra: dict | None = None,
                 lengths=None) -> np.ndarray:
        """prompts (B, L) token ids (audio: (B, L, K) codebook ids),
        right-padded when ragged; ``lengths`` (B,) each row's true prompt
        length; ``extra`` the frontend's inputs, ``{"image_embeds": (B,
        S_img, d)}`` for a vlm model, whose lengths then count the image
        prefix too (JAX :877-879).  Returns (B, n_new) tokens ((B, n_new, K)
        codebook frames for audio) and records prefill/decode wall times in
        ``last_stats``."""
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        dev, scfg = self.device, self.scfg
        prompts = np.asarray(prompts)
        b = prompts.shape[0]
        extra = dict(extra or {})
        image = extra.pop("image_embeds", None)
        if extra:
            raise ValueError(f"generate() takes extra inputs {{'image_embeds'}}, got "
                             f"{sorted(extra)}")
        if image is None and self.cfg.frontend == "vlm_patches":
            raise ValueError("a vlm_patches model takes image_embeds (B, S_img, d)")
        # under a mesh each data rank runs its share of the rows (all of
        # them when the data axis does not divide the batch)
        rows = self._shard_cache(b)
        mine = slice(None) if rows is None else rows
        if image is not None:
            image = torch.as_tensor(np.asarray(image, np.float32)[mine], device=dev)
        if lengths is not None:
            lengths = np.asarray(lengths)[mine]
            if self.cfg.frontend == "vlm_patches":  # embedded positions incl. the image
                lengths = lengths + image.shape[1]
        toks = torch.as_tensor(prompts[mine], dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        with self._trace_ctx(rows is not None):
            logits, cache, length = self.model.prefill(
                toks, scfg.max_len, lengths=lengths, quant=self.quant, kv=self.kv_spec,
                image_embeds=image)
            pos = torch.as_tensor(length, dtype=torch.int32,
                                  device=dev).expand(toks.shape[0]).clone()
            gen = self._generator()
            tok = self._sample_rows(logits[:, -1], gen, rows, b)
            self._sync()
            t1 = time.perf_counter()
            outs = [tok]
            before = self._collectives()
            for _ in range(n_new - 1):
                logits, cache = self.model.decode_step(tok[mine, None], cache, pos,
                                                       self.quant)
                pos += 1
                tok = self._sample_rows(logits[:, -1], gen, rows, b)
                outs.append(tok)
            out = torch.stack(outs, dim=1).cpu().numpy()
            coll = self._collectives() - before
        t2 = time.perf_counter()
        self.last_stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                           "decode_steps": n_new - 1,
                           "decode_tokens": b * (n_new - 1),
                           **self._mesh_stats(coll, n_new - 1)}
        return out

    # ------------------------------------------------------------------
    # likelihood scoring (multiple-choice eval, repro_torch.eval.harness)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def score_continuations(self, sequences, prompt_lens) -> np.ndarray:
        """Sum of continuation log-probs under the engine's weights.

        ``sequences`` are 1-D token arrays (context + continuation),
        ``prompt_lens`` each one's context length.  Returns (B,) f32:
        the sum of log P(tok_p | tok_<p) over p in [prompt_len, len).  The
        sequences right-pad to a shared length, a multiple of
        ``prefill_bucket``, and run one :meth:`Model.forward` with the MoE
        capacity lifted (``no_drop``, JAX :933): causal attention keeps the
        pad out of every real position and no row takes another's expert
        slot, so each row's
        score equals scoring it alone up to the per-tensor input scale
        the batch shares (batch invariance, which the eval harness and the
        autotuner rely on)."""
        self._refuse_frontend("score_continuations() takes plain token sequences; "
                              "unsupported for the {} frontend")
        if self.mesh is not None:
            raise NotImplementedError("score_continuations under a mesh is not "
                                      "ported yet (ROADMAP A13)")
        seqs = [np.asarray(s, np.int64) for s in sequences]
        lens = np.asarray([len(s) for s in seqs], np.int32)
        plens = np.asarray(prompt_lens, np.int32)
        if np.any(plens >= lens):
            raise ValueError("every sequence needs >= 1 continuation token")
        bucket = self.scfg.prefill_bucket
        width = max(-(-int(lens.max()) // bucket) * bucket, bucket)
        toks = np.zeros((len(seqs), width), np.int64)
        for i, s in enumerate(seqs):
            toks[i, : lens[i]] = s
        dev = self.device
        toks_d = torch.as_tensor(toks, device=dev)
        logits = self.model.forward(toks_d, quant=self.quant, no_drop=True)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        lp = torch.gather(logp[:, :-1], -1, toks_d[:, 1:, None])[..., 0]
        p = torch.arange(1, width, device=dev)[None]
        mask = ((p >= torch.as_tensor(plens, device=dev)[:, None])
                & (p < torch.as_tensor(lens, device=dev)[:, None]))
        return (lp * mask).sum(dim=1).cpu().numpy().astype(np.float32)

    # ------------------------------------------------------------------
    # continuous batching
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # robustness layer: lifecycle control, numeric guards
    # ------------------------------------------------------------------

    def cancel(self, uid) -> None:
        """Request cancellation of ``uid``, queued or mid-generation: the
        scheduler frees its slot/lane and blocks at the next iteration
        boundary, keeps the tokens already emitted, and records status
        'cancelled'.  Unknown or finished uids are ignored."""
        self._cancel_pending.add(uid)

    @staticmethod
    def _robust_stats() -> dict:
        return {"cancelled": 0, "deadline_expired": 0, "quarantined": 0,
                "numeric_faults": 0, "guard_checks": 0, "fallback_steps": 0,
                "preemptions": 0, "resumed": 0, "invariant_checks": 0}

    def _drain_control(self, ctl: _ServeControl, queue, live) -> None:
        """Top-of-iteration control sweep: pending cancellations
        (:meth:`cancel` and the fault plan's schedule), then expired
        deadlines.  ``live`` maps uid -> (Request, release_fn); release_fn
        frees the slot/lane and every block it holds."""
        cancels = list(self._cancel_pending)
        self._cancel_pending.clear()
        if ctl.faults is not None:
            cancels += list(ctl.faults.cancels_at(ctl.step))
        for uid in cancels:
            if uid in live:
                _, release = live.pop(uid)
                release()
            elif any(r.uid == uid for r in queue):
                rest = [r for r in queue if r.uid != uid]
                queue.clear()
                queue.extend(rest)
            else:
                continue
            self._terminal(ctl, uid, "cancelled", "cancelled")
        for uid, (r, release) in list(live.items()):
            if r.deadline_steps is None:
                continue
            if ctl.step - ctl.admit_step.get(uid, ctl.step) >= r.deadline_steps:
                live.pop(uid)
                release()
                self._terminal(ctl, uid, "deadline", "deadline_expired")

    def _terminal(self, ctl: _ServeControl, uid, status: str, counter: str) -> None:
        ctl.status[uid] = status
        ctl.stats[counter] += 1
        ctl.out.setdefault(uid, [])
        self.obs.terminal(uid, status, ctl.step, tokens=len(ctl.out[uid]))

    def _apply_guard(self, last, occ, uid_of, ctl: _ServeControl, *, rows=None, n=None,
                     retry: bool = False, inject: bool = True, cache=None):
        """Fault injection, sampling and the numeric guard over one step's
        sampling logits ``last`` (n, V).  ``occ`` are the rows actually
        serving, ``uid_of(i)`` names them.  Returns (the sampled tokens on
        the host, the bad row ids) and leaves the policy action to the
        caller; 'fail-fast' raises here.  The guard's verdict (the
        :func:`finite_flags` reduction) is computed on the device and
        crosses to the host in the same copy as the tokens: no sync of its
        own.  ``cache`` (the post-step cache) lets the recorder attribute a
        trip to the entry a real numeric fault poisoned."""
        if ctl.faults is not None and inject:
            last = ctl.faults.corrupt_logits(last, occ, retry=retry)
        if self._guard is None:
            n = last.shape[0] if n is None else n
            return self._sample_rows(last, ctl.gen, rows, n).cpu().numpy(), []
        b = last.shape[0]
        buf = torch.empty((2, b), dtype=torch.int64, device=last.device)
        self._sample(last, ctl.gen, out=buf[0])
        self._finite(last, out=buf[1].view(torch.float32)[:b])  # f32 flags in the int64 row
        host = buf.cpu()
        finite = host[1].view(torch.float32)[:b].numpy() == 0
        ctl.stats["guard_checks"] += 1
        bad = [i for i in occ if not finite[i]]
        if bad:
            ctl.stats["numeric_faults"] += len(bad)
            # telemetry before the policy action, while the cache still
            # holds whatever the fault wrote
            self._guard_trip(ctl, [uid_of(i) for i in bad], cache)
        return host[0].numpy(), bad

    def _guard_trip(self, ctl: _ServeControl, uids, cache) -> None:
        if self.obs.enabled:
            self.obs.guard_trip(uids, ctl.step,
                                cache=None if cache is None else self.model.cache_tree(cache))
        if self._guard == "fail-fast":
            raise FA.NumericFault(uids, ctl.step)

    def _quarantine(self, uid, ctl: _ServeControl, release) -> None:
        release()
        self._terminal(ctl, uid, "quarantined", "quarantined")

    def _ref_quant(self) -> Quant:
        """The 'fallback' retry's quantization: the serving config through
        'dsbp_ref', the plain integer path (on the engine's device; the
        retry is a policy the user selects, counted in fallback_steps)."""
        return Quant(self.cfg.quant, "dsbp_ref") if self.cfg.quant is not None else self.quant

    def _finish(self, ctl: _ServeControl, uid) -> None:
        """A request that completed its stream: 'ok', or 'preempted' when
        it survived at least one eviction on the way."""
        ctl.status[uid] = "preempted" if ctl.preempts.get(uid) else "ok"
        self.obs.terminal(uid, ctl.status[uid], ctl.step, tokens=len(ctl.out.get(uid) or ()))

    # ------------------------------------------------------------------
    # continuous batching
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def serve(self, requests, max_new_tokens: int = 32, faults=None) -> dict:
        """Run a queue of requests (:class:`Request` or plain token
        sequences) through the slot pool; returns {uid: generated ids} and
        records scheduler stats in ``last_stats`` (per-request lifecycle
        states under ``request_status``, set however the loop ends).
        ``faults`` takes a :class:`~repro_torch.serve.faults.FaultPlan`, a
        deterministic schedule of injected allocator failures, NaNs and
        cancellations; invariant checks then run after every paged
        scheduler iteration."""
        scfg, dev = self.scfg, self.device
        self._refuse_frontend("serve() schedules plain token prompts; use generate() for "
                              "the {} frontend")
        if faults is not None and self.mesh is not None:
            raise NotImplementedError("fault plans (serve(faults=...)) under a mesh are not "
                                      "ported yet (ROADMAP A13)")
        if scfg.paged:
            return self._serve_paged(requests, max_new_tokens, faults)
        queue = self._build_queue(requests, max_new_tokens)
        nreq = len(queue)
        self.obs.serve_start("dense", [(r.uid, len(r.tokens)) for r in queue])
        if faults is not None:
            faults.reset()
            faults.observer = self.obs.fault_injected
        B = scfg.batch_size
        # this rank's slots of the pool (all of them without a mesh)
        rows = self._shard_cache(B)
        mine = slice(None) if rows is None else rows
        b_l = len(range(B)[mine])
        pool = self.model.init_cache(b_l, scfg.max_len, kv=self.kv_spec)
        # KV bytes one slot's token pins, from the leaves' actual dtypes
        kv_bpt = kv_cache_nbytes(pool) / max(b_l * scfg.max_len, 1)
        coll = collections.Counter()
        active: list[Request | None] = [None] * B
        tok = np.zeros(B, np.int64)        # last sampled token per slot
        pos = np.zeros(B, np.int32)        # next absolute position per slot
        stats = {"decode_steps": 0, "occupied_lanes": 0, "admissions": 0,
                 "prefill_tokens": 0, "decode_tokens": 0, "prefill_time_s": 0.0,
                 "decode_time_s": 0.0, **self._robust_stats()}
        ctl = _ServeControl(stats=stats, out={}, status={r.uid: "queued" for r in queue},
                            faults=faults, gen=self._generator())
        slot_accepted = slot_rounds = None
        if self._spec is not None:
            # accepted-length histogram over occupied lanes: index j =
            # rounds that committed j tokens (1 .. spec_k + 1)
            stats.update(spec_rounds=0, draft_tokens=0,
                         accepted_hist=np.zeros(scfg.spec_k + 2, np.int64))
            slot_accepted = np.zeros(B, np.int64)
            slot_rounds = np.zeros(B, np.int64)
        completed = False
        try:
            while queue or any(s is not None for s in active):
                live = {active[i].uid: (active[i], functools.partial(active.__setitem__, i, None))
                        for i in range(B) if active[i] is not None}
                self._drain_control(ctl, queue, live)
                free = [i for i in range(B) if active[i] is None]
                if queue and free:
                    t0 = time.perf_counter()
                    self._admit(pool, queue, free, active, tok, pos, ctl, rows)
                    stats["prefill_time_s"] += time.perf_counter() - t0
                if not any(s is not None for s in active):
                    ctl.step += 1
                    continue  # every admitted request finished at token 1
                stats["decode_steps"] += 1
                n_occ = sum(s is not None for s in active)
                stats["occupied_lanes"] += n_occ
                t_step = time.perf_counter()
                if self._spec is not None:
                    pool = self._spec_advance(pool, active, tok, pos, ctl, slot_accepted,
                                              slot_rounds)
                    dt = time.perf_counter() - t_step  # the round's tokens are on the host
                    stats["decode_time_s"] += dt
                    self.obs.decode_step(ctl.step, n_occ, dt)
                    ctl.step += 1
                    continue
                before = self._collectives()
                nxt = self._decode_slots(pool, active, tok, pos, ctl, rows)
                coll += self._collectives() - before
                dt = time.perf_counter() - t_step  # the step's tokens are on the host
                stats["decode_time_s"] += dt
                self.obs.decode_step(ctl.step, n_occ, dt)
                for i in range(B):
                    r = active[i]
                    if r is None:
                        continue  # idle lane: output ignored, slot unchanged
                    pos[i] += 1
                    t = int(nxt[i])
                    ctl.out[r.uid].append(t)
                    tok[i] = t
                    stats["decode_tokens"] += 1
                    if self._done(t, ctl.out[r.uid], r):
                        active[i] = None  # freed; the next admission reuses it
                        self._finish(ctl, r.uid)
                ctl.step += 1
            completed = True
        finally:
            # last_stats lands even when an exception unwinds the loop
            self.last_stats = dict(
                stats, requests=nreq, completed=completed, request_status=dict(ctl.status),
                occupancy=stats["occupied_lanes"] / max(stats["decode_steps"] * B, 1),
                decode_tps=stats["decode_tokens"] / max(stats["decode_time_s"], 1e-9),
                kv_bytes_per_token=kv_bpt, kv_packed=tree_has_packed_kv(pool),
                **self._mesh_stats(coll, stats["decode_steps"]))
            if self._spec is not None:
                self._spec_summary(stats, slot_accepted, slot_rounds)
            self.obs.serve_end(self.last_stats)
        for uid in ctl.status:  # every uid reports, however it ended
            ctl.out.setdefault(uid, [])
        return {uid: np.asarray(t, np.int64) for uid, t in ctl.out.items()}

    def _decode_guarded(self, step, cache, occ, uid_of, release, ctl: _ServeControl,
                        **sample) -> np.ndarray:
        """One decode step ``step(quant) -> logits`` that updates ``cache``
        in place, then fault injection, sampling and the guard over its
        last logits, the 'fallback' retry, and the quarantines
        (``release(i)`` frees lane i).  The retry runs the whole step again
        through 'dsbp_ref': it rewrites the KV slots the failed step wrote
        before its attention reads them, and it starts from the recurrent
        states the failed step started from (kept by reference: a step
        replaces state and never writes into it), so it decodes from the
        pre-step cache, as JAX's retry does, and it draws from the
        generator state the failed step drew from.  Returns the sampled
        tokens on the host."""
        state = refs = None
        if self._guard == "fallback":
            state, refs = ctl.gen.get_state(), self.model.state_refs(cache)
        nxt, bad = self._apply_guard(step(self.quant)[:, -1], occ, uid_of, ctl, cache=cache,
                                     **sample)
        if bad and self._guard == "fallback":
            ctl.stats["fallback_steps"] += 1
            ctl.gen.set_state(state)
            self.model.restore_states(cache, refs)
            nxt, bad = self._apply_guard(step(self._ref_quant())[:, -1], occ, uid_of, ctl,
                                         retry=True, cache=cache, **sample)
        for i in bad:
            self._quarantine(uid_of(i), ctl, functools.partial(release, i))
        return nxt

    def _decode_slots(self, pool, active, tok, pos, ctl: _ServeControl, rows) -> np.ndarray:
        """One guarded decode step of the slot pool (this rank's ``rows``
        of it under a mesh); returns the (B,) sampled tokens on the host."""
        dev, B = self.device, len(active)
        mine = slice(None) if rows is None else rows
        step_tok = torch.as_tensor(tok[mine], device=dev)[:, None]
        step_pos = torch.as_tensor(pos[mine], device=dev)
        with self._trace_ctx(rows is not None):
            return self._decode_guarded(
                lambda q: self.model.decode_step(step_tok, pool, step_pos, q)[0], pool,
                [i for i in range(B) if active[i] is not None], lambda i: active[i].uid,
                lambda i: active.__setitem__(i, None), ctl, rows=rows, n=B)

    def _spec_summary(self, stats, slot_accepted=None, slot_rounds=None) -> None:
        """The speculation epilogue of both schedulers: the accepted-length
        histogram into ``last_stats`` (dense: per-slot means as well) and
        the recorder."""
        self.last_stats.update(acceptance_summary(
            stats["accepted_hist"], self.scfg.spec_k,
            slot_accepted=slot_accepted, slot_rounds=slot_rounds))
        self.obs.spec_summary(self.last_stats)

    def _commit_round(self, ctl: _ServeControl, lanes, target, keep, pos, tok, release):
        """Commit one round's accepted tokens per live lane ``i`` of
        ``lanes`` (a list of (i, request)): the first ``keep[i]`` verify
        tokens, dropping any past an EOS or the budget (``release(i)``
        frees the lane there and the request finishes)."""
        stats, out = ctl.stats, ctl.out
        for i, r in lanes:
            kp = int(keep[i])
            stats["accepted_hist"][kp] += 1
            committed = 0
            for j in range(kp):
                t = int(target[i, j])
                out[r.uid].append(t)
                committed += 1
                stats["decode_tokens"] += 1
                if self._done(t, out[r.uid], r):
                    release(i)  # tokens past EOS / the budget are dropped
                    self._finish(ctl, r.uid)
                    break
            pos[i] += committed
            tok[i] = int(target[i, committed - 1])

    def _round_guard(self, res, occ, uid_of, release, ctl: _ServeControl, cache):
        """Fault injection and the guard over one speculation round's
        result ``res`` ((target, keep, cache[, finite]) on the device):
        returns (target, keep) on the host.  A lane whose verify logits are
        not finite is quarantined before any of its round's tokens commit
        (the round has already put its slots back past its accepted
        writes)."""
        target, keep = res[0], res[1]
        finite = res[3] if self._guard is not None else None
        if ctl.faults is not None and finite is not None:
            finite = ctl.faults.corrupt_finite(finite, occ)
        target, keep = target.cpu().numpy(), keep.cpu().numpy()
        if ctl.faults is not None:
            # an injected verify mismatch clamps acceptance to 1: every
            # committed token is the target's own argmax, so only speed drops
            keep = ctl.faults.clip_spec_keep(keep)
        if finite is not None:
            finite = finite.cpu().numpy()
            ctl.stats["guard_checks"] += 1
            bad = [i for i in occ if not finite[i]]
            if bad:
                ctl.stats["numeric_faults"] += len(bad)
                self._guard_trip(ctl, [uid_of(i) for i in bad], cache)
                for i in bad:
                    self._quarantine(uid_of(i), ctl, functools.partial(release, i))
        return target, keep

    def _spec_advance(self, pool, active, tok, pos, ctl: _ServeControl, slot_accepted,
                      slot_rounds):
        """One speculation round for the whole slot pool (draft -> verify
        -> accept -> rollback), the guard, then the accepted greedy tokens
        of every occupied slot commit."""
        dev = self.device
        occ = [i for i, r in enumerate(active) if r is not None]
        res = self._spec(self.model, pool, torch.as_tensor(tok, device=dev),
                         torch.as_tensor(pos, device=dev))
        pool = res[2]
        target, keep = self._round_guard(res, occ, lambda i: active[i].uid,
                                         lambda i: active.__setitem__(i, None), ctl, pool)
        live = [(i, r) for i, r in enumerate(active) if r is not None]
        ctl.stats["spec_rounds"] += 1
        ctl.stats["draft_tokens"] += self.scfg.spec_k * len(live)
        self.obs.spec_round(ctl.step, [int(keep[i]) for i, _ in live])
        for i, _ in live:  # idle slots: their rolled-back writes are
            # overwritten at the slot's next admission
            slot_accepted[i] += int(keep[i])
            slot_rounds[i] += 1
        self._commit_round(ctl, live, target, keep, pos, tok,
                           lambda i: active.__setitem__(i, None))
        return pool

    def _admit(self, pool, queue, free, active, tok, pos, ctl: _ServeControl, pool_rows=None):
        """Admit up to len(free) queued requests: one ragged group prefill
        (padded to a bucket multiple, per-row lengths), then each continuing
        row's K/V is written straight into its slot of the pool — the JAX
        engine builds a fresh cache and copies its rows in (_cache_insert);
        writing in place skips that max_len-sized copy (the rows of
        recurrent layers' states go in the same way).  The guard checks
        the prefill's logits too (no injection there; 'fallback' degrades to
        quarantine: there is no per-row prefill retry).  Under a mesh every
        data rank prefills the whole group, and keeps the K/V of the slots
        in its ``pool_rows`` of the pool."""
        scfg, stats = self.scfg, ctl.stats
        group = [queue.popleft() for _ in range(min(len(free), len(queue)))]
        lens = np.asarray([len(r.tokens) for r in group], np.int32)
        for j, r in enumerate(group):
            self.obs.admitted(r.uid, ctl.step, prompt_len=int(lens[j]))
        bucket = scfg.prefill_bucket
        L = max(-(-int(lens.max()) // bucket) * bucket, bucket)
        toks = np.zeros((len(group), L), np.int64)
        for j, r in enumerate(group):
            toks[j, : lens[j]] = r.tokens
        lens_t = torch.as_tensor(lens, device=self.device)
        with self._trace_ctx(False):
            logits, kvs, _ = self.model.prefill_trunk(
                torch.as_tensor(toks, device=self.device), lens_t, self.quant)
            first, badrows = self._apply_guard(logits[:, -1], list(range(len(group))),
                                               lambda j: group[j].uid, ctl, inject=False)
        stats["admissions"] += len(group)
        stats["prefill_tokens"] += int(lens.sum())
        badset = set(badrows)
        rows, slots = [], []
        for j, r in enumerate(group):
            if j in badset:
                self._quarantine(r.uid, ctl, lambda: None)
                continue
            t = int(first[j])
            ctl.out[r.uid] = [t]
            ctl.admit_step.setdefault(r.uid, ctl.step)
            self.obs.first_token(r.uid, ctl.step)
            if self._done(t, ctl.out[r.uid], r):
                self._finish(ctl, r.uid)
                continue  # finished at its first token: the slot stays free
            slot = free.pop(0)
            rows.append(j)
            slots.append(slot)
            active[slot] = r
            tok[slot] = t
            pos[slot] = int(lens[j])
        lo, hi = (0, len(active)) if pool_rows is None else (pool_rows.start, pool_rows.stop)
        keep = [(j, s - lo) for j, s in zip(rows, slots) if lo <= s < hi]
        if keep:
            # K/V rows and recurrent state rows scatter alike (JAX
            # _cache_insert, mode 'scatter')
            rows_t = torch.as_tensor([j for j, _ in keep], device=self.device)
            self.model.fill_cache(pool, kvs, lens_t[rows_t], slots=[s for _, s in keep],
                                  rows=rows_t)

    # ------------------------------------------------------------------
    # paged serving: block tables, COW prefix sharing, chunked prefill,
    # priority preemption
    # ------------------------------------------------------------------

    def _serve_paged(self, requests, max_new_tokens: int = 32, faults=None) -> dict:
        """The paged twin of the dense serve loop: one block pool per
        layer, one int32 block table per lane.  Per iteration: drain
        control events (cancellations, deadlines) -> admit (reserve blocks
        -> grouped short prefill / chunk-lane setup, preempting a
        strictly-lower-priority victim when a reservation fails) ->
        COW-split the shared blocks the step writes -> ONE decode step over
        every lane -> one chunk step -> the invariant check (always under a
        fault plan).  Every block returns to the pool and the prefix cache
        drops its references on any exit."""
        scfg = self.scfg
        queue = self._build_queue(requests, max_new_tokens)
        nreq = len(queue)
        B, bs = self.lanes, scfg.kv_block_size
        headroom = scfg.spec_k  # a round writes up to spec_k slots past the budget
        # a reservation that exceeds the whole pool can never succeed
        for r in queue:
            span = SB.block_span(min(len(r.tokens) + r.max_new_tokens + headroom,
                                     self._s_c), bs)
            if self._kv_scs and span > self.kv_blocks - 1:
                raise SB.BlockError(
                    f"request {r.uid!r} cannot be admitted even with an "
                    f"idle pool: its reservation ({span} blocks) exceeds "
                    f"kv_blocks={self.kv_blocks} ({self.kv_blocks - 1} "
                    f"usable)")
        self.obs.serve_start("paged", [(r.uid, len(r.tokens)) for r in queue])
        if faults is not None:
            faults.reset()
            faults.observer = self.obs.fault_injected
        # a model with no KV layer has no pool to allocate from (JAX
        # :1277-1284): no allocator for a fault plan to act on, no prefix
        # cache, a pool of one block
        check = (scfg.invariant_checks or faults is not None) and bool(self._kv_scs)
        alloc = prefix = None
        if self._kv_scs:
            alloc = (faults.allocator(self.kv_blocks, bs) if faults is not None
                     else SB.BlockAllocator(self.kv_blocks, bs))
            prefix = SB.PrefixCache(alloc) if scfg.prefix_sharing else None
        self._last_alloc, self._last_prefix = alloc, prefix
        nb_pool = self.kv_blocks if alloc is not None else 1
        cache = self.model.init_paged_cache(nb_pool, bs, kv=self.kv_spec, batch=B)
        # bytes one table entry pins across every layer's pool, from the
        # leaves' actual dtypes (both children of a packed pool)
        blk_bytes = kv_cache_nbytes(cache) // nb_pool
        tables = np.zeros((B, self._table_width), np.int32)
        lanes: list[dict | None] = [None] * B
        tok = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int32)
        stats = {"decode_steps": 0, "occupied_lanes": 0, "admissions": 0,
                 "prefill_tokens": 0, "decode_tokens": 0, "prefill_time_s": 0.0,
                 "decode_time_s": 0.0, "cow_splits": 0, "chunk_steps": 0,
                 "chunked_requests": 0,
                 # decode lanes advance every iteration, chunked prefills
                 # in flight or not: 0 by construction
                 "stalled_decode_steps": 0, "interleaved_decode_steps": 0,
                 "max_concurrent": 0, "shared_blocks_peak": 0,
                 "admission_blocked": 0, **self._robust_stats()}
        ctl = _ServeControl(stats=stats, out={}, status={r.uid: "queued" for r in queue},
                            faults=faults, gen=self._generator())
        if self._spec_paged is not None:
            stats.update(spec_rounds=0, draft_tokens=0,
                         accepted_hist=np.zeros(scfg.spec_k + 2, np.int64))
        idle_spins = 0
        completed = False
        try:
            while queue or any(l is not None for l in lanes):
                live = {lanes[i]["req"].uid:
                        (lanes[i]["req"],
                         functools.partial(self._release_lane, i, lanes, tables, alloc))
                        for i in range(B) if lanes[i] is not None}
                self._drain_control(ctl, queue, live)
                free = [i for i in range(B) if lanes[i] is None]
                if queue and free:
                    t0 = time.perf_counter()
                    cache = self._admit_paged(cache, queue, free, lanes, tables, alloc,
                                              prefix, tok, pos, ctl)
                    stats["prefill_time_s"] += time.perf_counter() - t0
                dec = [i for i, l in enumerate(lanes)
                       if l is not None and l["phase"] == "decode"]
                chk = [i for i, l in enumerate(lanes)
                       if l is not None and l["phase"] == "chunk"]
                if not dec and not chk:
                    if queue:  # blocked admission with an idle pool must end
                        idle_spins += 1
                        if idle_spins > 4 * self.kv_blocks + 64:
                            raise SB.BlockError(
                                f"scheduler made no progress for {idle_spins} "
                                f"iterations with an idle pool: request "
                                f"{queue[0].uid!r} cannot reserve its blocks")
                    ctl.step += 1
                    continue  # every admitted request finished at token 1
                idle_spins = 0
                stats["max_concurrent"] = max(stats["max_concurrent"], len(dec) + len(chk))
                if alloc is not None:
                    stats["shared_blocks_peak"] = max(stats["shared_blocks_peak"],
                                                      alloc.shared_blocks())
                    self.obs.pool_sample(ctl.step, alloc, prefix)
                if dec:
                    t_step = time.perf_counter()
                    # every ring slot this step writes (a round: 1 + spec_k)
                    # must be exclusively owned; under pool pressure this
                    # may preempt a lane
                    cache = self._cow_writable(
                        cache, tables, alloc, prefix,
                        [(i, int(pos[i]), 1 + headroom) for i in dec],
                        stats, lanes=lanes, queue=queue, ctl=ctl)
                    dec = [i for i in dec if lanes[i] is not None]
                    chk = [i for i in chk if lanes[i] is not None]
                if dec:
                    stats["decode_steps"] += 1
                    stats["occupied_lanes"] += len(dec) + len(chk)
                    if chk:
                        stats["interleaved_decode_steps"] += 1
                    if self._spec_paged is not None:
                        cache = self._spec_advance_paged(cache, lanes, tables, alloc, dec,
                                                         tok, pos, ctl)
                    else:
                        nxt = self._decode_lanes(cache, lanes, tables, alloc, dec, tok, pos,
                                                 ctl)
                        for i in dec:
                            if lanes[i] is None:
                                continue  # quarantined this step
                            r = lanes[i]["req"]
                            pos[i] += 1
                            t = int(nxt[i])
                            ctl.out[r.uid].append(t)
                            tok[i] = t
                            stats["decode_tokens"] += 1
                            if self._done(t, ctl.out[r.uid], r):
                                self._release_lane(i, lanes, tables, alloc)
                                self._finish(ctl, r.uid)
                    dt = time.perf_counter() - t_step  # the step's tokens are on the host
                    stats["decode_time_s"] += dt
                    self.obs.decode_step(ctl.step, len(dec) + len(chk), dt)
                if chk:
                    t0 = time.perf_counter()
                    cache = self._chunk_step(cache, lanes, tables, alloc, prefix, queue,
                                             chk, tok, pos, ctl)
                    stats["prefill_time_s"] += time.perf_counter() - t0
                if check:
                    FA.check_invariants(alloc, tables, lanes, prefix)
                    stats["invariant_checks"] += 1
                ctl.step += 1
            completed = True
        finally:
            # conservation on any exit: every live lane's block references
            # return to the pool and the prefix cache releases its own
            for i in range(B):
                if lanes[i] is not None:
                    self._release_lane(i, lanes, tables, alloc)
            if prefix is not None:
                prefix.drop_all()
            usable = self.kv_blocks - 1 if alloc is not None else 0
            self.last_stats = dict(
                stats, requests=nreq, paged=True, lanes=B, kv_block_size=bs,
                kv_blocks=self.kv_blocks if alloc is not None else 0, completed=completed,
                request_status=dict(ctl.status),
                occupancy=stats["occupied_lanes"] / max(stats["decode_steps"] * B, 1),
                decode_tps=stats["decode_tokens"] / max(stats["decode_time_s"], 1e-9),
                block_peak_used=alloc.peak_used if alloc is not None else 0,
                # 0 unless a block reference leaked past the releases above
                blocks_in_use_at_exit=alloc.used_blocks if alloc is not None else 0,
                block_utilization=alloc.peak_used / usable if usable else 0.0,
                block_bytes=blk_bytes,
                prefix_lookups=prefix.lookups if prefix is not None else 0,
                prefix_hit_blocks=prefix.hits if prefix is not None else 0,
                # every prefix hit is one block of KV not re-materialized
                bytes_saved_sharing=(prefix.hits if prefix is not None else 0) * blk_bytes,
                kv_bytes_per_token=blk_bytes / max(bs, 1),
                kv_packed=tree_has_packed_kv(cache))
            if self._spec_paged is not None:
                self._spec_summary(stats)
            self.obs.serve_end(self.last_stats)
        for uid in ctl.status:  # every uid reports, however it ended
            ctl.out.setdefault(uid, [])
        return {uid: np.asarray(t, np.int64) for uid, t in ctl.out.items()}

    def _decode_lanes(self, cache, lanes, tables, alloc, dec, tok, pos,
                      ctl: _ServeControl) -> np.ndarray:
        """One guarded decode step over every decode lane of the block
        pools (idle and chunk lanes write nothing; a retry writes each live
        lane's slot at pos again, nothing else); quarantined lanes release
        their blocks.  Returns the (B,) sampled tokens on the host."""
        live = np.zeros(self.lanes, np.int32)
        live[dec] = 1  # idle and chunk lanes: write_len 0
        step_tok = torch.as_tensor(tok, device=self.device)[:, None]
        return self._decode_guarded(
            lambda q: self.model.decode_step_paged(step_tok, cache, tables, pos, live,
                                                   self.scfg.max_len, q)[0],
            cache, dec, lambda i: lanes[i]["req"].uid,
            functools.partial(self._release_lane, lanes=lanes, tables=tables, alloc=alloc),
            ctl)

    def _spec_advance_paged(self, cache, lanes, tables, alloc, dec, tok, pos,
                            ctl: _ServeControl):
        """One speculation round through the block tables: the round drafts
        and verifies, and commits only each decode lane's accepted prefix
        (commit-on-accept); then the guard, and the lanes' tokens commit."""
        live = np.zeros(self.lanes, np.int32)
        live[dec] = 1
        res = self._spec_paged(self.model, cache, tables,
                               torch.as_tensor(tok, device=self.device), pos, live)
        cache = res[2]
        release = functools.partial(self._release_lane, lanes=lanes, tables=tables,
                                    alloc=alloc)
        target, keep = self._round_guard(res, dec, lambda i: lanes[i]["req"].uid,
                                         release, ctl, cache)
        dec = [i for i in dec if lanes[i] is not None]
        ctl.stats["spec_rounds"] += 1
        ctl.stats["draft_tokens"] += self.scfg.spec_k * len(dec)
        self.obs.spec_round(ctl.step, [int(keep[i]) for i in dec])
        self._commit_round(ctl, [(i, lanes[i]["req"]) for i in dec], target, keep, pos,
                           tok, release)
        return cache

    def _reserve_blocks(self, alloc, prefix, r, use_prefix=True, done: int = 0):
        """Reserve the lane's whole logical span up front: blocks for
        min(prompt + remaining budget + spec_k, S_c) ring slots, minus prefix hits
        (``done`` tokens already emitted ride inside a resumed request's
        prompt).  Returns (block_ids, n_hit_blocks), or None when the pool
        cannot cover it even after evicting cache-only prefix blocks (or a
        fault plan refuses the allocation: the hits go back, atomically).
        Without a pool (no KV layer) there is nothing to reserve."""
        if alloc is None:
            return [], 0
        bs = self.scfg.kv_block_size
        total = min(len(r.tokens) + max(r.max_new_tokens - done, 1) + self.scfg.spec_k,
                    self._s_c)
        span = SB.block_span(total, bs)
        hits = []
        if use_prefix and prefix is not None and len(r.tokens) <= self._share_limit:
            hits = prefix.lookup(r.tokens)
        need = span - len(hits)
        while need > alloc.free_blocks:
            if prefix is None or not prefix.evict_one():
                break
        if need > alloc.free_blocks:
            if hits:
                alloc.free(hits)
            return None
        try:
            fresh = alloc.alloc(need)
        except SB.BlockError:
            if hits:
                alloc.free(hits)
            return None
        return hits + fresh, len(hits)

    def _admit_paged(self, cache, queue, free, lanes, tables, alloc, prefix, tok, pos,
                     ctl: _ServeControl):
        """Admit queued requests into free lanes.  Short prompts run one
        grouped :meth:`Model.prefill_paged` (per-row ``write_start`` skips
        prefix-hit blocks); prompts past the chunk threshold become
        'chunk' lanes.  Priority order, FIFO among equals: a request that
        cannot reserve its blocks parks the queue unless a strictly lower-
        priority lane exists, which is preempted before the retry.  A
        resumed request re-prefills prompt + emitted and appends."""
        scfg = self.scfg
        stats, out = ctl.stats, ctl.out
        group, chunk_new = [], []
        while queue and free:
            r = queue[0]
            done = len(out.get(r.uid, []))
            chunked = len(r.tokens) > self._chunk_threshold
            res = self._reserve_blocks(alloc, prefix, r, use_prefix=not chunked, done=done)
            if res is None:
                victim = self._pick_victim(lanes, tables)
                if victim is not None and lanes[victim]["req"].priority < r.priority:
                    self._preempt_lane(victim, lanes, tables, alloc, prefix, queue, ctl)
                    free.append(victim)
                    continue  # retry the reservation with the freed blocks
                stats["admission_blocked"] += 1
                break
            queue.popleft()
            bids, n_hit = res
            lane = free.pop(0)
            ctl.admit_step.setdefault(r.uid, ctl.step)
            self.obs.admitted(r.uid, ctl.step, prompt_len=len(r.tokens), resumed=bool(done),
                              chunked=chunked)
            if done:
                stats["resumed"] += 1
            tables[lane, :] = 0
            tables[lane, : len(bids)] = bids
            # 'done0' = output length at THIS admission: a later preemption
            # re-queues prompt + out[uid][done0:]
            if chunked:
                lanes[lane] = {"req": r, "phase": "chunk", "done": 0, "done0": done}
                chunk_new.append(lane)
                stats["chunked_requests"] += 1
                stats["admissions"] += 1
                continue
            lanes[lane] = {"req": r, "phase": "prefill", "done0": done}
            # register at reservation time: within one grouped prefill every
            # pool write lands before any lane's first read, so later group
            # members already share these entries
            if prefix is not None and len(r.tokens) <= self._share_limit:
                prefix.register(r.tokens, tables[lane])
            group.append((lane, r, n_hit * scfg.kv_block_size))
        # chunk lanes start from the pristine recurrent state; their KV
        # arrives chunk by chunk through the block table
        self.model.insert_states(cache, None, (), chunk_new)
        if group:
            lens = np.asarray([len(r.tokens) for _, r, _ in group], np.int32)
            bucket = scfg.prefill_bucket
            L = max(-(-int(lens.max()) // bucket) * bucket, bucket)
            toks = np.zeros((len(group), L), np.int64)
            for j, (_, r, _) in enumerate(group):
                toks[j, : lens[j]] = r.tokens
            starts = np.asarray([s for _, _, s in group], np.int32)
            logits, src, _ = self.model.prefill_paged(
                torch.as_tensor(toks, device=self.device), cache,
                tables[[ln for ln, _, _ in group]], scfg.max_len, lengths=lens,
                write_start=starts, quant=self.quant)
            first, badrows = self._apply_guard(logits[:, -1], list(range(len(group))),
                                               lambda j: group[j][1].uid, ctl, inject=False)
            stats["admissions"] += len(group)
            stats["prefill_tokens"] += int(lens.sum())
            badset = set(badrows)
            rows, slots = [], []
            for j, (lane, r, _) in enumerate(group):
                if j in badset:
                    self._quarantine(r.uid, ctl, functools.partial(
                        self._release_lane, lane, lanes, tables, alloc))
                    continue
                t = int(first[j])
                out.setdefault(r.uid, []).append(t)  # a resume continues
                self.obs.first_token(r.uid, ctl.step)
                if self._done(t, out[r.uid], r):
                    self._release_lane(lane, lanes, tables, alloc)
                    self._finish(ctl, r.uid)
                    continue
                rows.append(j)
                slots.append(lane)
                lanes[lane] = {"req": r, "phase": "decode", "done0": lanes[lane]["done0"]}
                tok[lane] = t
                pos[lane] = int(lens[j])
            # K/V landed in the pools through the tables; only the
            # recurrent lane states need the row insert (JAX mode 'src')
            self.model.insert_states(cache, src, rows, slots)
        return cache

    def _pick_victim(self, lanes, tables):
        """Lowest priority first, then most blocks held (one eviction frees
        the most pool), then lowest lane id; None when no lane is live."""
        cand = [i for i, l in enumerate(lanes) if l is not None]
        if not cand:
            return None
        return min(cand, key=lambda i: (lanes[i]["req"].priority,
                                        -int(np.count_nonzero(tables[i])), i))

    def _preempt_lane(self, lane, lanes, tables, alloc, prefix, queue, ctl: _ServeControl):
        """Evict one lane: register its written prefix (prompt +
        emitted[:-1]) so the resume replays it as prefix hits, release
        every block reference, and re-queue the request with ``tokens =
        prompt + emitted`` (recompute-on-resume: greedy decode continues
        exactly where the lane stopped)."""
        l = lanes[lane]
        r = l["req"]
        emitted = list(ctl.out.get(r.uid, []))[int(l.get("done0", 0)):]
        if prefix is not None and l.get("phase") == "decode" and emitted:
            written = np.concatenate([np.asarray(r.tokens, np.int64),
                                      np.asarray(emitted[:-1], np.int64)])
            if len(written) <= self._share_limit:
                prefix.register(written, tables[lane])
        self._release_lane(lane, lanes, tables, alloc)
        toks = (np.concatenate([np.asarray(r.tokens, np.int64),
                                np.asarray(emitted, np.int64)])
                if emitted else np.asarray(r.tokens, np.int64))
        self._requeue(queue, dataclasses.replace(r, tokens=toks))
        ctl.preempts[r.uid] = ctl.preempts.get(r.uid, 0) + 1
        ctl.status[r.uid] = "preempted"
        ctl.stats["preemptions"] += 1
        self.obs.preempted(r.uid, ctl.step)

    @staticmethod
    def _requeue(queue, r: Request) -> None:
        """Re-insert a preempted request in priority order, ahead of
        equal-priority waiters (it was admitted first)."""
        idx = 0
        for idx, q in enumerate(queue):
            if q.priority <= r.priority:
                break
        else:
            idx = len(queue)
        queue.insert(idx, r)

    @staticmethod
    def _release_lane(lane, lanes, tables, alloc):
        """Free one reference on every block the lane's table holds (the
        prefix cache's references keep shared blocks alive); zero the row."""
        lanes[lane] = None
        if alloc is not None:
            alloc.free(int(b) for b in tables[lane] if b)
        tables[lane, :] = 0

    def _cow_writable(self, cache, tables, alloc, prefix, writes, stats, *, lanes, queue,
                      ctl):
        """Copy-on-write before a step: for each (lane, start_pos,
        n_tokens) write, split every shared block it touches and copy the
        contents on the device in one batched call.  Under pool pressure,
        evict cache-only prefix blocks, then un-register a block only the
        cache shares with the writer, then preempt a
        victim lane; the caller re-derives its lane sets afterwards.
        Without a pool there is nothing to split."""
        if alloc is None:
            return cache
        bs = self.scfg.kv_block_size
        src_all, dst_all = [], []

        def flush(cache):
            nonlocal src_all, dst_all
            if src_all:
                stats["cow_splits"] += len(src_all)
                cache = SB.copy_blocks(cache, src_all, dst_all)
                src_all, dst_all = [], []
            return cache

        for lane, p0, n in writes:
            if lanes[lane] is None:
                continue  # victimized earlier in this very pass
            ent = sorted({j for s_c in self._kv_scs for j in SB.blocks_written(p0, n, s_c, bs)})
            while True:
                try:
                    s, d = alloc.ensure_writable(tables[lane], ent)
                    src_all += s
                    dst_all += d
                    break
                except SB.BlockError:
                    if prefix is not None and prefix.evict_one():
                        continue
                    forgot = False
                    if prefix is not None:
                        for j in ent:
                            bid = int(tables[lane][j])
                            if alloc.refcount(bid) == 2 and prefix.forget(bid):
                                forgot = True
                    if forgot:
                        continue
                    # flush pending copies first: the victim's blocks return
                    # to the pool, and a deferred copy must never land in a
                    # re-allocated block
                    cache = flush(cache)
                    victim = self._pick_victim(lanes, tables)
                    if victim is None:
                        raise  # nothing left to evict: real exhaustion
                    self._preempt_lane(victim, lanes, tables, alloc, prefix, queue, ctl)
                    if victim == lane:
                        break  # the writer itself was evicted
        return flush(cache)

    def _chunk_step(self, cache, lanes, tables, alloc, prefix, queue, chk, tok, pos,
                    ctl: _ServeControl):
        """Advance every chunk lane by one <= chunk_T-token slice through
        the verify path (a teacher-forced forward over known prompt
        tokens, every lane in the batch) and commit keep = n_valid.  The
        final chunk's last logit samples the first token (guarded as an
        admission's) and the lane turns to 'decode'."""
        scfg = self.scfg
        stats, out = ctl.stats, ctl.out
        B, T = self.lanes, self._chunk_T
        toks = np.zeros((B, T), np.int64)
        posv = np.zeros(B, np.int32)
        keep = np.zeros(B, np.int32)  # 0 freezes idle and decode lanes
        fin = []  # (lane, n_valid in this chunk)
        for i in chk:
            l = lanes[i]
            r = l["req"]
            start = l["done"]
            n = min(T, len(r.tokens) - start)
            toks[i, :n] = r.tokens[start:start + n]
            posv[i] = start
            keep[i] = n
            l["done"] = start + n
            self.obs.chunk(r.uid, ctl.step, n, l["done"], len(r.tokens))
            if l["done"] == len(r.tokens):
                fin.append((i, n))
        cache = self._cow_writable(cache, tables, alloc, prefix,
                                   [(i, int(posv[i]), int(keep[i])) for i in chk], stats,
                                   lanes=lanes, queue=queue, ctl=ctl)
        # a COW preemption may have evicted a chunk lane mid-pass: freeze it
        for i in chk:
            if lanes[i] is None:
                keep[i] = 0
        fin = [(i, n) for i, n in fin if lanes[i] is not None]
        logits, steps = self.model.verify_step_paged(
            torch.as_tensor(toks, device=self.device), cache, tables, posv,
            scfg.max_len, self.quant)
        cache = self.model.rollback_cache_paged(cache, tables, steps, keep, posv,
                                                scfg.max_len)
        stats["chunk_steps"] += 1
        stats["prefill_tokens"] += int(sum(int(keep[i]) for i in chk))
        if fin:
            sel = logits[torch.as_tensor([i for i, _ in fin], device=self.device),
                         torch.as_tensor([n - 1 for _, n in fin], device=self.device)]
            first, badrows = self._apply_guard(sel, list(range(len(fin))),
                                               lambda j: lanes[fin[j][0]]["req"].uid, ctl,
                                               inject=False)
            badset = set(badrows)
            for j, (i, _) in enumerate(fin):
                r = lanes[i]["req"]
                if j in badset:
                    self._quarantine(r.uid, ctl, functools.partial(
                        self._release_lane, i, lanes, tables, alloc))
                    continue
                done0 = int(lanes[i].get("done0", 0))
                t = int(first[j])
                out.setdefault(r.uid, []).append(t)  # a resume continues
                self.obs.first_token(r.uid, ctl.step)
                # register only now: the blocks filled progressively
                if prefix is not None and len(r.tokens) <= self._share_limit:
                    prefix.register(r.tokens, tables[i])
                if self._done(t, out[r.uid], r):
                    self._release_lane(i, lanes, tables, alloc)
                    self._finish(ctl, r.uid)
                    continue
                lanes[i] = {"req": r, "phase": "decode", "done0": done0}
                tok[i] = t
                pos[i] = len(r.tokens)
        return cache

    def _build_queue(self, requests, max_new_tokens: int) -> deque:
        """Validated admission queue: normalized Requests, unique uids,
        max_len feasibility, stable highest-priority-first order."""
        reqs = [self._norm_request(r, i, max_new_tokens)
                for i, r in enumerate(requests)]
        if len({r.uid for r in reqs}) != len(reqs):
            raise ValueError("request uids must be unique (results key on uid)")
        headroom = self.scfg.spec_k
        for r in reqs:
            if len(r.tokens) + r.max_new_tokens + headroom > self.scfg.max_len:
                raise ValueError(
                    f"request {r.uid!r}: prompt {len(r.tokens)} + budget "
                    f"{r.max_new_tokens}"
                    f"{f' + spec_k {headroom}' if headroom else ''}"
                    f" exceeds max_len {self.scfg.max_len}")
        return deque(sorted(reqs, key=lambda r: -r.priority))

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
            raise ValueError(
                f"request {r.uid!r}: prompt must be a non-empty 1-D token "
                f"sequence, got shape {tuple(toks.shape)} — an empty prompt "
                f"has no logits to sample a first token from")
        if int(r.max_new_tokens) < 1:
            raise ValueError(
                f"request {r.uid!r}: max_new_tokens must be >= 1, got "
                f"{r.max_new_tokens} (admission samples the first token "
                f"from the prefill logits, so every request emits >= 1)")
        try:
            hash(r.uid)
        except TypeError:
            raise ValueError(
                f"request uid {r.uid!r} is unhashable: results, statuses "
                f"and cancellation all key on uid — use a str/int/tuple "
                f"id") from None
        if r.deadline_steps is not None and int(r.deadline_steps) < 1:
            raise ValueError(
                f"request {r.uid!r}: deadline_steps must be >= 1 scheduler "
                f"iterations (or None), got {r.deadline_steps}")
        return dataclasses.replace(r, tokens=toks)
