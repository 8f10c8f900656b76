"""Serving launcher for the port: pack once, then generate or serve.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b-paper \\
      --packed [--ragged] [--kv-quant kv8] [--method dsbp_kernel] \\
      [--paged --kv-block-size 16 [--kv-blocks N] [--max-active N]] \\
      [--spec-k 3 [--spec-draft-bits 4] [--spec-draft-method dsbp_fused] \\
       [--kv-draft-bits 6]] [--mesh DxM] [--policy POLICY.json] \
      [--deadline-steps N] [--numeric-guard quarantine-lane] \
      [--observe [--metrics-json M.json] [--trace T.json]] [--smoke --device cpu]

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain PyTorch
versions instead (use it with ``--smoke``).  ``--ragged`` draws mixed-length
prompts (2 per slot) through the ``Engine.serve`` slot scheduler instead of
one uniform ``generate`` batch; ``--paged`` serves them from a pool of KV
blocks through per-lane block tables (and implies ``--ragged``).
``--spec-k K`` serves speculatively: each pool step drafts K tokens per lane
with the MSB-slice view of the packed weights (``--spec-draft-bits``,
through ``--spec-draft-method``), verifies them in one target forward and
commits the longest greedy-matching prefix; with a packed KV cache
``--kv-draft-bits`` narrows the draft's view of it.  It implies
``--ragged``.

``--policy POLICY.json`` serves a per-layer ``DSBPPolicy`` artifact, as
``DSBPPolicy.to_json`` writes it in either package (the JAX package's
``repro.policy.DSBPPolicy`` or the port's): each projection packs under
the policy's config for its stacked key and the KV cache takes the
policy's ``kv_layers`` / ``kv_default`` unless ``--kv-quant`` or
``--kv-bits`` is given.

``--deadline-steps N`` releases a request N scheduler iterations after its
admission (status 'deadline'); ``--numeric-guard`` checks every step's
sampling logits for non-finite values (fail-fast, quarantine-lane or
fallback); ``--observe`` records lifecycle spans, metrics and guard
telemetry and prints each request's TTFT, total time and tokens/s, and
``--metrics-json`` / ``--trace`` write the metrics snapshot and the
Chrome trace (both imply ``--observe``).  All of them imply ``--ragged``.

``--packed`` draws and packs the model one layer at a time
(``models.model.init(pack=)``), so a model larger than the card in f32
serves packed: ``--arch mixtral-8x7b --packed`` on one H100.

An SSD model (``--arch mamba2-370m``) serves with ``prefill_bucket`` set
to its ``ssd_chunk``: every padded prompt batch is then a multiple of the
chunk, which the chunked scan needs (an uncut ``generate`` prompt of
``--prompt-len`` tokens must be shorter than the chunk or a multiple).

The modality frontends serve through ``Engine.generate``, as in the
reference: ``--arch musicgen-large`` draws (B, L, K) codebook prompts and
prints (B, new, K) frames; ``--arch llava-next-34b`` draws seeded
standard-normal ``image_embeds`` (B, n_image_tokens, d) and passes them
in ``extra``.  ``--ragged`` gives them a ragged ``generate`` (text
lengths; a vlm row's image prefix is added by the engine); ``--paged``,
``--spec-k``, ``--policy``, ``--mesh`` and the serve-only flags
(``--deadline-steps``, ``--observe``) are refused, as the engine refuses
``serve`` for them.

``--mesh DxM`` serves on a (data, model) mesh of D*M ranks, the port's
counterpart of JAX's ``--mesh``: the launcher builds the kernels, then
starts one process per rank (``launch.mesh.spawn``; gloo on the CPU or on
one shared card, NCCL with a card per rank).  Every rank draws the same
seeded weights, in turn, and keeps only its shards; rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request, ServeConfig, _nbytes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b-paper")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--packed", action="store_true",
                    help="serve pack-once DSBP int8 weights (quantized path)")
    ap.add_argument("--preset", default="precise")
    ap.add_argument("--ragged", action="store_true",
                    help="mixed-length prompts through the slot scheduler")
    ap.add_argument("--method", default=None,
                    help="quantized-linear method: dsbp_fused (default, the "
                         "one-pass kernel), dsbp_kernel (input-path kernel + "
                         "grouped integer GEMM), dsbp_ref")
    ap.add_argument("--kv-quant", default=None,
                    help="DSBP-quantized KV cache: a preset name ('kv8' is the "
                         "8-bit preset, 'kv6'/'kv4' trade accuracy for bytes); "
                         "K/V quantize at cache-write time into int8 aligned "
                         "mantissas + pow2 group scales")
    ap.add_argument("--kv-bits", type=int, default=None,
                    help="uniform KV bitwidth shorthand in [2, 8] "
                         "(alternative to --kv-quant; set one, not both)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: block-pool storage, per-lane block "
                         "tables, copy-on-write prefix sharing and chunked "
                         "prefill (implies --ragged)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="ring slots per KV block (max_len rounds up to a "
                         "multiple)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="blocks in the pool incl. scratch (default: --batch "
                         "dense slots' worth)")
    ap.add_argument("--max-active", type=int, default=None,
                    help="paged lane count; with prefix sharing it can exceed "
                         "--batch at the same --kv-blocks budget")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative serving: draft tokens per pool step "
                         "(0 = off; implies the --ragged scheduler path)")
    ap.add_argument("--spec-draft-bits", type=int, default=4,
                    help="aligned-mantissa bits of the MSB-slice draft view")
    ap.add_argument("--spec-draft-method", default="dsbp_ref",
                    help="quantized-linear method of the draft forward "
                         "(dsbp_ref, the default as in JAX; dsbp_fused runs "
                         "B1 over the draft view)")
    ap.add_argument("--kv-draft-bits", type=int, default=None,
                    help="with --spec-k and a packed KV cache: draft over an "
                         "MSB-slice view of the cached mantissas at this width "
                         "(served tokens unchanged; only acceptance can move)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a (data, model) mesh of D*M ranks, e.g. '1x2': "
                         "weights cut per rank (Megatron split over model), the "
                         "fused GEMM on each rank's shards (B8), the slot pool "
                         "split over data; one process per rank")
    ap.add_argument("--policy", default=None, metavar="POLICY.json",
                    help="serve a DSBPPolicy JSON artifact (per-layer configs, "
                         "and its KV side unless --kv-quant/--kv-bits is set)")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="scheduler iterations a request may stay resident after "
                         "admission before it is released with status 'deadline' "
                         "(implies --ragged)")
    ap.add_argument("--observe", action="store_true",
                    help="observability: per-request lifecycle spans, a metrics "
                         "registry and guard telemetry; prints a per-request "
                         "TTFT/total/tok-s summary (implies --ragged)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the obs registry + health snapshot as JSON after "
                         "serving (implies --observe)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="dump the Chrome trace-event timeline after serving, for "
                         "Perfetto / chrome://tracing (implies --observe)")
    ap.add_argument("--numeric-guard", default=None,
                    choices=["off", "fail-fast", "quarantine-lane", "fallback"],
                    help="per-step finiteness guard on sampling logits: fail-fast "
                         "raises, quarantine-lane releases the bad lane with its "
                         "partial output, fallback retries the step through the "
                         "dsbp_ref reference path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain PyTorch versions)")
    args = ap.parse_args()
    if not args.smoke:  # before anything is drawn
        _refuse_past_one_card(get_config(args.arch))
    if args.metrics_json or args.trace:
        args.observe = True
    frontend = get_config(args.arch).frontend
    if frontend != "none":  # generate alone: the engine refuses serve() for it
        refused = [flag for flag, on in (
            ("--paged", args.paged), ("--spec-k", args.spec_k), ("--policy", args.policy),
            ("--mesh", args.mesh), ("--deadline-steps", args.deadline_steps),
            ("--observe", args.observe)) if on]
        if refused:
            ap.error(f"the {frontend} frontend serves through Engine.generate only, "
                     f"which takes none of {', '.join(refused)}")
        _run(None, args)
        return
    if args.paged or args.spec_k or args.deadline_steps or args.observe:
        args.ragged = True  # all of them live in the serve() scheduler
    if args.mesh is None:
        _run(None, args)
        return
    shape = tuple(int(s) for s in args.mesh.lower().split("x"))
    if len(shape) != 2 or min(shape) < 1:
        ap.error(f"--mesh takes DxM (two positive sizes), got {args.mesh!r}")
    device = resolve_device(args.device)
    if device.type == "cuda":  # once, before the ranks load the libraries
        from repro_torch.kernels import build

        build.build_all()
    from repro_torch.launch.mesh import spawn

    spawn(_run, shape, args, device=str(device))


# one H100's memory: what a full-size config is held against where no card
# is visible
H100_BYTES = 80 * 10**9


def packed_nbytes(cfg) -> int:
    """Bytes of ``cfg`` at full depth packed by ``init(pack=)``, from its
    parameter count: each projection weight an int8 mantissa, 1/16 of an
    f32 group scale and 1/64 of an int8 group width (64-groups), the
    embedding and head f32 (norms and routers, a few MB, left out)."""
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2) * max(
        1, cfg.n_codebooks)
    return int((cfg.param_count() - emb) * (1 + 5 / 64) + 4 * emb)


def _refuse_past_one_card(cfg) -> None:
    """Raises, naming ROADMAP A13, for a full-size config whose packed
    weights alone outgrow the card (grok-1-314b: ~346 GB)."""
    have = (torch.cuda.get_device_properties(0).total_memory if torch.cuda.is_available()
            else H100_BYTES)
    need = packed_nbytes(cfg)
    if need > have:
        raise NotImplementedError(
            f"{cfg.name} at full depth is {need / 1e9:.1f} GB packed against the card's "
            f"{have / 1e9:.1f} GB: one card cannot hold it, and spreading its experts "
            f"over ranks (the expert axis) is not ported yet (ROADMAP A13); serve it "
            f"with --smoke, or cut its depth through models.model.init")


def _run(mesh, args):
    """Build, pack and serve (one rank of ``mesh``, or the only process)."""
    device = args.device if mesh is None else mesh.device
    rank0 = mesh is None or mesh.rank == 0
    # full size serves bfloat16, as the reference's launcher (its :136-137)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch).replace(
        dtype="bfloat16")
    cfg = cfg.replace(quant=args.preset if args.packed else None)
    max_len = args.prompt_len + cfg.n_image_tokens + args.new_tokens + args.spec_k + 8
    if args.paged:  # block pools need block-aligned ring lengths
        max_len = -(-max_len // args.kv_block_size) * args.kv_block_size
    policy = None
    if args.policy is not None:
        from repro_torch.policy import DSBPPolicy

        with open(args.policy) as f:
            policy = DSBPPolicy.from_json(f.read())
    kv_quant = args.kv_quant
    if policy is not None and args.kv_quant is None and args.kv_bits is None:
        kv_quant = policy
    # the SSD scan's chunk must divide every padded prompt batch
    bucket = {"prefill_bucket": cfg.ssd_chunk} if "ssd" in cfg.pattern else {}
    scfg = ServeConfig(max_len=max_len, batch_size=args.batch, pack_preset=policy,
                       quant_method=args.method, kv_quant=kv_quant,
                       kv_bits=args.kv_bits, paged=args.paged,
                       kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
                       max_active=args.max_active, spec_k=args.spec_k,
                       spec_draft_bits=args.spec_draft_bits,
                       spec_draft_method=args.spec_draft_method,
                       kv_draft_bits=args.kv_draft_bits,
                       numeric_guard=args.numeric_guard, observe=args.observe,
                       mesh_shape=None if mesh is None else tuple(mesh.shape.values()),
                       **bucket)
    eng = None
    # one device draws and packs a layer at a time (a model larger than the
    # card in f32 fits packed); ranks that share a card draw the whole
    # model one after another, each keeping only its shards
    streamed = args.packed and mesh is None
    for turn in range(1 if mesh is None else mesh.size):
        if mesh is None or mesh.rank == turn:
            pack = (policy if policy is not None else args.preset) if streamed else None
            eng = Engine(M.init(cfg, seed=0, device=device, pack=pack), scfg, device=device)
        if mesh is not None:
            mesh.barrier()
    say = print if rank0 else (lambda *a, **k: None)  # rank 0 reports for the mesh
    if mesh is not None:
        say(f"mesh {tuple(mesh.shape.values())}: {mesh.size} ranks, "
            f"{scfg.batch_size} slots, {eng.cfg.quant_method or 'float'} projections")
    if args.paged and not eng._kv_scs:
        say(f"paged: no KV layer, no block pool; {eng.lanes} lanes of dense state")
    elif args.paged:
        say(f"paged KV: {eng.kv_blocks} blocks x {args.kv_block_size} slots, "
            f"{eng.lanes} lanes, table width {eng._table_width}")
    if streamed:
        say(f"packed weights: drawn and packed one layer at a time, "
            f"{_nbytes(eng.model) / 1e6:.1f} MB ("
            + (f"policy of {len(policy)} layer entries)" if policy is not None
               else f"preset {args.preset})"))
    if eng.pack_report:
        rep = eng.pack_report
        say(f"packed weights: {rep['raw_nbytes']/1e6:.1f} -> "
            f"{rep['packed_nbytes']/1e6:.1f} MB (avg W bits "
            f"{rep['avg_w_bits']:.2f}, "
            + (f"policy of {len(policy)} layer entries)" if policy is not None
               else f"preset {rep['preset']})"))
    if eng.kv_spec is not None:
        say(f"packed KV cache: {eng.kv_spec}")
    if eng.spec_report:
        rep = eng.spec_report
        say(f"speculative: spec_k {rep['spec_k']}, draft bits {rep['draft_bits']}, draft "
            f"method {rep['draft_method']}, kv draft bits {rep['kv_draft_bits']}, extra "
            f"weight bytes {rep['extra_weight_nbytes']}")
    rng = np.random.default_rng(0)
    if args.ragged and cfg.frontend == "none":
        lens = rng.integers(args.prompt_len // 2, args.prompt_len + 1, 2 * args.batch)
        reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, (int(n),)),
                        max_new_tokens=args.new_tokens, deadline_steps=args.deadline_steps)
                for i, n in enumerate(lens)]
        t0 = time.monotonic()
        out = eng.serve(reqs, max_new_tokens=args.new_tokens)
        dt = time.monotonic() - t0
        st = eng.last_stats
        say(f"served {st['requests']} ragged requests (lens {lens.tolist()}) "
            f"in {dt:.2f}s ({st['decode_tps']:.1f} decode tok/s, occupancy "
            f"{st['occupancy']*100:.0f}%, {st['decode_steps']} pool steps, "
            f"{st['kv_bytes_per_token']:.0f} KV bytes/token)")
        if args.paged and st["kv_blocks"]:
            say(f"block pool: peak {st['block_peak_used']}/{st['kv_blocks'] - 1} used "
                f"({st['block_utilization'] * 100:.0f}%), {st['shared_blocks_peak']} "
                f"shared at peak, {st['prefix_hit_blocks']} prefix hits, "
                f"{st['cow_splits']} COW splits, {st['chunk_steps']} chunk steps "
                f"({st['chunked_requests']} chunked requests), "
                f"{st['stalled_decode_steps']} stalled decode steps")
        if args.spec_k:
            say(f"speculation: {st['spec_rounds']} rounds, mean accepted "
                f"{st['mean_accepted']:.2f}/{args.spec_k + 1} (accepted_hist "
                f"{st['accepted_hist']})")
        if mesh is not None:
            say(f"collectives per decode step: {st['collectives_per_decode_step']}")
        if args.deadline_steps or args.numeric_guard:
            by_state: dict = {}
            for status in st["request_status"].values():
                by_state[status] = by_state.get(status, 0) + 1
            say(f"lifecycle: {by_state} (deadline_expired {st['deadline_expired']}, "
                f"quarantined {st['quarantined']}, preemptions {st['preemptions']}, "
                f"guard_checks {st['guard_checks']})")
        if args.observe:
            summ = eng.obs.request_summary()
            for uid in sorted(summ, key=str):
                q = summ[uid]
                ttft = f"{q['ttft_s'] * 1e3:7.1f}ms" if q["ttft_s"] is not None else "      -"
                total = (f"{q['total_s'] * 1e3:7.1f}ms" if q["total_s"] is not None
                         else "      -")
                say(f"  req{uid}: {str(q['status']):<11} ttft {ttft}  total {total}  "
                    f"{q['tokens']:>3} tok  {q['tok_s']:6.1f} tok/s")
        if args.metrics_json:
            eng.obs.save_metrics(args.metrics_json)
            say(f"metrics snapshot -> {args.metrics_json}")
        if args.trace:
            eng.obs.save_trace(args.trace)
            say(f"chrome trace ({len(eng.obs.trace.events)} events) -> {args.trace} "
                f"(open in Perfetto / chrome://tracing)")
        for uid in list(out)[:2]:
            say(f"  req{uid}: {out[uid].tolist()}")
        return
    _generate(eng, cfg, args, rng, say)


def _generate(eng, cfg, args, rng, say):
    """One ``generate`` batch: text prompts, (B, L, K) codebook prompts
    for audio, text prompts and seeded ``image_embeds`` for vlm; a
    frontend's is ragged (``lengths``) under ``--ragged``, where a text
    model goes to ``serve()`` instead."""
    shape = (args.batch, args.prompt_len)
    if cfg.frontend == "audio_codebooks":
        shape += (cfg.n_codebooks,)
    prompts = rng.integers(0, cfg.vocab_size, shape)
    lens = None
    if args.ragged:
        lens = rng.integers(args.prompt_len // 2, args.prompt_len + 1, args.batch)
        lens[0] = args.prompt_len
        for b, n in enumerate(lens):
            prompts[b, n:] = 0
    extra = None
    if cfg.frontend == "vlm_patches":
        extra = {"image_embeds": rng.standard_normal(
            (args.batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}
    t0 = time.monotonic()
    out = eng.generate(prompts, args.new_tokens, extra=extra, lengths=lens)
    dt = time.monotonic() - t0
    st = eng.last_stats
    what = {"none": "", "audio_codebooks": f"{cfg.n_codebooks} codebooks per frame; ",
            "vlm_patches": f"{cfg.n_image_tokens} image tokens before each prompt; "}
    say(f"generated {out.shape} ({what[cfg.frontend]}prompt lens "
        f"{[args.prompt_len] * args.batch if lens is None else lens.tolist()}) in "
        f"{dt:.2f}s ({args.batch * args.new_tokens / dt:.1f} tok/s): prefill "
        f"{st['prefill_s']:.3f}s, "
        f"{1e3 * st['decode_s'] / max(st['decode_steps'], 1):.2f} ms per decode step")
    for b in range(min(2, args.batch)):
        say(f"  seq{b}: {out[b].tolist()}")


if __name__ == "__main__":
    main()
