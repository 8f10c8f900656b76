#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; nothing falls back to the CPU):
  1. build every CUDA kernel of the main paths from src/repro_torch/kernels/csrc
     with nvcc (one process per source, all at once) and print the ptxas
     register/shared-memory report;
  2. B1, the fused DSBP GEMM, against its plain PyTorch version on the card at
     the llama-7b projection shapes (decode M=4 and prefill M=512): bit-equal;
     kernel, plain and bound times;
  3. B2, flash attention, against its plain version at prefill (B=4, H=32,
     S=512, D=128, ragged lengths) and decode (per-row positions), with
     torch's scaled_dot_product_attention timed on the same work as a
     yardstick;
  4. a 2-layer model at full llama-7b width, the same packed weights served
     once on the CPU (plain versions) and once on the card (kernels): logits
     within tolerance, greedy tokens equal;
  5. full-width 32-layer llama-7b-paper with random weights from a seeded
     torch.Generator, packed "precise": one ragged Engine.generate of 4
     prompts and Engine.serve of 8 requests through 4 slots, with each
     kernel's launch count over that run;
  6. B3, the standalone input path, against its plain version: bit-equal at
     M in {4, 512} x K in {4096, 11008}, e5m2, fixed and trunc;
  7. B4, the grouped integer GEMM, against its plain versions at the
     projection shapes, folded and unfolded (bit-equal: the plain versions
     add in the kernel's order), and B3+B4 against B1 (within 3e-5 *
     max|y|: the scale folds and sums run in other orders);
  8. B5, packed-KV flash attention, against B2 over dequantize() (bit-equal:
     one source, pow2 folds) and its plain version (1e-5), at decode (B=4,
     H=32, S=2048, ragged) and a 128-query chunk at q_pos0 > 0;
  9. the 2-layer model of phase 4 served with kv_quant="kv8",
     quant_method="dsbp_kernel": CPU vs card greedy tokens equal, and on the
     card packed-KV serving equal token for token to serving over a float
     cache whose every write is quantized then dequantized;
  10. the full-width model of phase 5 with kv8 + dsbp_kernel (generate +
     serve, launch counts of B2-B5 per step and prefill, bytes per token,
     zero weight relayouts and zero KV dequantizes dispatched by a decode
     step), then serve with kv8 + the default dsbp_fused.
Prints the kernels' JSON record, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp16
# tensor-core operations/s (the exact-integer DSBP MAC's type on Hopper, see
# csrc/dsbp_fused.cu), f32 FMA-pipe operations/s (the attention kernel's type)
HBM_BPS = 3.35e12
FP16_OPS = 989e12
F32_OPS = 67e12
# B3's f32/int operations per element (quantize, fields, shift, align), an
# estimate for its operations bound; its bytes bound it by far
B3_OPS_PER_ELEM = 16
LLAMA_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))  # (K, N): wq.., w1/w3, w2
L2_BYTES = 50 * 2**20
TIE = 1e-3  # logit tolerance, relative to max|logit|
# CPU vs card decode logits (phase 9): the attention kernels differ from
# their plain versions in the last bits (sum order, expf), and such a bit
# can move one projection input across an FP8 rounding boundary, which the
# following layers compound (phase 9's kv8 run does so at its second decode
# step: 4.7% of max|logit| over 2 full-width layers, PERF.md); a kernel
# fault gives differences of the order of max|logit| itself
KV_TIE = 0.1


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, args_list, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn(*args) per call, CUDA events around ``iters``
    calls cycling through ``args_list`` (copies that overflow the L2 cache,
    so every call reads its operands from device memory, as serving does)."""
    import torch

    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_b1(torch, Q, DF, per_tensor_scale):
    print("== phase 2: B1 dsbp_fused vs plain on the card")
    cases = [(m, k, n, "precise", {}) for m in (4, 512) for k, n in LLAMA_SHAPES]
    cases += [(512, 4096, 4096, "precise", {"fmt": "e5m2"}),
              (512, 4096, 4096, "precise", {"mode": "fixed", "k": 0.0, "b_fix": 7}),
              (512, 4096, 4096, "precise", {"mantissa_rounding": "trunc"})]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, max_err = [], 0.0
    for m, k, n, preset, kw in cases:
        cfg = Q.PRESETS[preset]
        icfg = dataclasses.replace(cfg.input_cfg, **kw)
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        pw = Q.pack_weights(w, cfg)
        del w
        x = torch.randn(m, k, generator=gen, device="cuda")
        ts = per_tensor_scale(x, icfg.fmt).reshape(1)
        tw = pw.tscale.reshape(-1).contiguous()
        y = DF.dsbp_fused(x, ts, pw.ka, pw.kscale, tw, icfg)
        ref = DF.dsbp_fused_plain(x, ts, pw.ka, pw.kscale, tw, icfg)
        torch.cuda.synchronize()
        if not torch.equal(y, ref):
            raise AssertionError(f"B1 kernel != plain at M={m} K={k} N={n} {kw}: max "
                                 f"|diff| {float((y - ref).abs().max())}")
        max_err = max(max_err, float((y - ref).abs().max()))
        wbytes = pw.ka.numel() + pw.kscale.numel() * 4
        copies = [(x, ts, pw.ka.clone(), pw.kscale.clone(), tw, icfg)
                  for _ in range(max(1, math.ceil(2 * L2_BYTES / wbytes)))]
        ms = cuda_ms(DF.dsbp_fused, copies, iters=30 if m <= 4 else 10)
        plain_ms = cuda_ms(DF.dsbp_fused_plain, copies[:1], iters=3, warmup=1)
        ng = pw.padded_k // 64
        nbytes = m * pw.padded_k * 4 + wbytes + n * 4 + 4 + m * n * 4
        b_ms, b_by = bound(nbytes, 2.0 * m * pw.padded_k * n, FP16_OPS)
        row = {"M": m, "K": k, "N": n, "cfg": kw or "precise e4m3", "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "groups": ng}
        rows.append(row)
        print(f"  B1 M={m:4d} K={k:5d} N={n:5d} {str(row['cfg']):40s} bit-equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        del pw, copies
    torch.cuda.empty_cache()
    return rows, max_err


def phase_b2(torch, FA):
    print("== phase 2: B2 flash_attention vs plain on the card")
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, s, d = 4, 32, 512, 128
    q = torch.randn(b, h, s, d, generator=gen, device="cuda")
    k = torch.randn(b, h, s, d, generator=gen, device="cuda")
    v = torch.randn(b, h, s, d, generator=gen, device="cuda")
    out = {}
    for name, qq, kv_len, q0 in (
            ("prefill", q, [512, 300, 129, 77], [0, 0, 0, 0]),
            ("decode", q[:, :, :1].contiguous(), [512, 301, 129, 18], [511, 300, 128, 17])):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        q0 = torch.tensor(q0, dtype=torch.int32, device="cuda")
        o = FA.flash_attention(qq, k, v, kv_len, q0)
        ref = FA.flash_attention_plain(qq, k, v, kv_len, q0)
        torch.cuda.synchronize()
        err = float((o - ref).abs().max())
        # online-softmax order: per-tile rescaling rounds differently
        if not torch.allclose(o, ref, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"B2 {name}: kernel vs plain max |diff| {err}")
        mask = FA.attention_mask(kv_len, q0, qq.shape[2], s, causal=True, window=0)
        visible = float(mask.sum())  # (b, query, key) pairs this run attends
        args = [(qq, k, v, kv_len, q0)]
        ms = cuda_ms(FA.flash_attention, args, iters=20)
        plain_ms = cuda_ms(FA.flash_attention_plain, args, iters=5)
        nbytes = 2 * qq.numel() * 4 + 2 * float(kv_len.sum()) * h * d * 4 + 8 * b
        b_ms, b_by = bound(nbytes, visible * h * 4 * d, F32_OPS)
        am = mask[:, None]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=am),
                         [()], iters=20)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "max_abs_err": err}
        print(f"  B2 {name:7s} B={b} H={h} Sq={qq.shape[2]} S={s} D={d}: max |diff| {err:.3g};"
              f" kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), sdpa {lib_ms:.4f} ms")
    return out


def _prompts(vocab, lens, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, vocab, n)
    return toks, np.asarray(lens, np.int32)


def phase_cross_device(torch, TM, Engine, ServeConfig, cfg):
    print("== phase 4: 2-layer full-width model, CPU (plain) vs card (kernels)")
    import numpy as np

    cfg2 = cfg.replace(n_layers=2)
    gpu_model = TM.Model(cfg2, "cuda")
    gpu_model.load_state_dict(TM.init(cfg2, seed=0, device="cpu").state_dict())
    scfg = ServeConfig(max_len=64)
    gpu = Engine(gpu_model, scfg, device="cuda")        # packs on the card
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [5, 17, 9, 12], seed=3)
    logits = {}
    for name, eng in (("cpu", cpu), ("gpu", gpu)):
        with torch.inference_mode():
            lg, _, _ = eng.model.prefill(torch.as_tensor(toks, device=eng.device),
                                         scfg.max_len, lengths=lens, quant=eng.quant)
        logits[name] = lg.float().cpu()
    diff = float((logits["cpu"] - logits["gpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    if not (torch.isfinite(logits["gpu"]).all() and diff <= TIE * scale):
        raise AssertionError(f"CPU vs card prefill logits: max |diff| {diff} > "
                             f"{TIE} * {scale}")
    n_new = 8
    t_cpu = cpu.generate(toks, n_new, lengths=lens)
    t_gpu = gpu.generate(toks, n_new, lengths=lens)
    for r in range(len(lens)):
        bad = np.flatnonzero(t_cpu[r] != t_gpu[r])
        if bad.size:  # allowed only where the reference itself is a near tie
            t = int(bad[0])
            seq = np.concatenate([toks[r, :lens[r]], t_cpu[r, :t]])[None]
            with torch.inference_mode():
                lg = cpu.model.forward(torch.as_tensor(seq), quant=cpu.quant)[0, -1]
            top2 = torch.topk(lg, 2).values
            gap = float(top2[0] - top2[1])
            if gap >= TIE * float(lg.abs().max()):
                raise AssertionError(f"row {r} tokens diverge at step {t}: "
                                     f"{t_cpu[r]} vs {t_gpu[r]} (top-2 gap {gap})")
            print(f"  row {r}: near tie at step {t} (top-2 gap {gap:.3g}), "
                  f"compared up to it")
    print(f"  prefill logits max |diff| {diff:.3g} (max |logit| {scale:.3g}, "
          f"tolerance {TIE} relative); greedy tokens equal: {t_gpu.tolist()}")
    return gpu.model, cpu.model  # packed once; phase 9 serves them again


def phase_serve(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg):
    print("== phase 5: full-width llama-7b-paper, packed 'precise', generate + serve")
    import numpy as np

    t0 = time.perf_counter()
    model = TM.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = Engine(model, ServeConfig(max_len=512, batch_size=4), device="cuda")
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    rep = eng.pack_report
    print(f"  init {t_init:.2f} s, pack {t_pack:.2f} s: {rep['layers_packed']} projections, "
          f"{rep['raw_nbytes'] / 1e9:.3f} -> {rep['packed_nbytes'] / 1e9:.3f} GB, "
          f"avg W bits {rep['avg_w_bits']:.3f}, preset {rep['preset']}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    toks, lens = _prompts(cfg.vocab_size, [16, 48, 96, 128], seed=4)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, int(n)),
                    max_new_tokens=16) for i, n in enumerate(rng.integers(16, 129, 8))]

    # ---- the main path: counts from 0 over exactly this run ----
    DF.dsbp_fused.launches = 0
    FA.flash_attention.launches = 0
    out = eng.generate(toks, 16, lengths=lens)
    gst = dict(eng.last_stats)
    served = eng.serve(reqs, max_new_tokens=16)
    torch.cuda.synchronize()
    launches = {"dsbp_fused": DF.dsbp_fused.launches,
                "flash_attention": FA.flash_attention.launches}
    sst = eng.last_stats

    peak = torch.cuda.max_memory_allocated()
    if out.shape != (4, 16) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"generate output {out.shape} out of range")
    if sorted(served) != list(range(8)) or any(len(t) != 16 for t in served.values()):
        raise AssertionError("serve did not return 16 tokens for each of 8 requests")
    with torch.inference_mode():
        lg, _, _ = eng.model.prefill(torch.as_tensor(toks, device="cuda"), 512,
                                     lengths=lens, quant=eng.quant)
    if lg.shape != (4, 1, cfg.padded_vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError("full-width prefill logits are not finite")
    n_layers = cfg.n_layers
    print(f"  generate: 4 prompts (lens {lens.tolist()}), 16 new tokens: prefill "
          f"{gst['prefill_s']:.3f} s, decode {gst['decode_tokens'] / gst['decode_s']:.1f} "
          f"tok/s, {1e3 * gst['decode_s'] / gst['decode_steps']:.2f} ms/step")
    print(f"  serve: 8 requests (lens {[len(r.tokens) for r in reqs]}) through 4 slots: "
          f"{sst['decode_steps']} steps, {sst['admissions']} admissions, prefill "
          f"{sst['prefill_time_s']:.3f} s, decode {sst['decode_tps']:.1f} tok/s, "
          f"{1e3 * sst['decode_time_s'] / sst['decode_steps']:.2f} ms/step, occupancy "
          f"{sst['occupancy']:.3f}")
    print(f"  peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"  launches over generate + serve: {launches} (per decode step and per "
          f"prefill: dsbp_fused {7 * n_layers}, flash_attention {n_layers})")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    print(f"  KV bytes per token (float cache): {sst['kv_bytes_per_token']:.0f}")
    return eng.model, launches, sst['kv_bytes_per_token']


def phase_b3(torch, Q, QA, per_tensor_scale):
    print("== phase 6: B3 fp8_quant_align vs plain on the card")
    cases = [(m, k, {}) for m in (4, 512) for k in (4096, 11008)]
    cases += [(512, 4096, {"fmt": "e5m2"}),
              (512, 4096, {"mode": "fixed", "k": 0.0, "b_fix": 7}),
              (512, 4096, {"mantissa_rounding": "trunc"})]
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for m, k, kw in cases:
        icfg = dataclasses.replace(Q.PRESETS["precise"].input_cfg, **kw)
        x = torch.randn(m, k, generator=gen, device="cuda")
        xs = x * per_tensor_scale(x, icfg.fmt)
        got = QA.fp8_quant_align(xs, icfg)
        ref = QA.fp8_quant_align_plain(xs, icfg)
        torch.cuda.synchronize()
        for name, g, r in zip(("a", "scale", "bits"), got, ref):
            if not torch.equal(g, r):
                raise AssertionError(f"B3 kernel != plain ({name}) at M={m} K={k} {kw}")
        ms = cuda_ms(QA.fp8_quant_align, [(xs, icfg)], iters=50)
        plain_ms = cuda_ms(QA.fp8_quant_align_plain, [(xs, icfg)], iters=5, warmup=1)
        nbytes = 8 * m * k + 8 * m * (k // 64)  # x in; a, scale, bits out
        b_ms, b_by = bound(nbytes, B3_OPS_PER_ELEM * m * k, F32_OPS)
        rows.append({"M": m, "K": k, "cfg": kw or "precise e4m3", "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        print(f"  B3 M={m:4d} K={k:5d} {str(kw or 'precise e4m3'):40s} bit-equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return rows


def phase_b4(torch, Q, DM, TO):
    print("== phase 7: B4 dsbp_matmul vs plain, and B3+B4 vs B1, on the card")
    cfg = Q.PRESETS["precise"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows, max_err = [], 0.0
    for m in (4, 512):
        for k, n in LLAMA_SHAPES:
            w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
            pw = Q.pack_weights(w, cfg)
            del w
            x = torch.randn(m, k, generator=gen, device="cuda")
            qx = TO.fp8_quant_align(x, cfg.input_cfg)
            ax, sx = qx["a"], qx["scale"]
            wbytes = pw.ka.numel() + pw.kscale.numel() * 4
            copies = [(ax, sx, pw.ka.clone(), pw.kscale.clone())
                      for _ in range(max(1, math.ceil(2 * L2_BYTES / wbytes)))]
            row = {"M": m, "K": k, "N": n}
            for folded in (False, True):
                form = "folded" if folded else "unfolded"
                y = DM.dsbp_matmul(ax, sx, pw.ka, pw.kscale, folded=folded)
                ref = DM.dsbp_matmul_plain(ax, sx, pw.ka, pw.kscale, folded=folded)
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                if not torch.equal(y, ref):
                    raise AssertionError(f"B4 {form} M={m} K={k} N={n} != plain: {err}")
                max_err = max(max_err, err)
                kern = functools.partial(DM.dsbp_matmul, folded=folded)
                plain = functools.partial(DM.dsbp_matmul_plain, folded=folded)
                row[form] = {"ms": cuda_ms(kern, copies, iters=30 if m <= 4 else 10),
                             "plain_ms": cuda_ms(plain, copies[:1], iters=3, warmup=1),
                             "max_abs_err": err}
                del y, ref
            two = TO.dsbp_matmul_packed(x, pw)
            one = TO.dsbp_matmul_fused(x, pw)
            torch.cuda.synchronize()
            d12, top = float((two - one).abs().max()), float(one.abs().max())
            if d12 > 3e-5 * top:
                raise AssertionError(f"B3+B4 vs B1 at M={m} K={k} N={n}: max |diff| {d12} "
                                     f"> 3e-5 * {top}")
            ng = k // 64
            nbytes = m * k * 4 + m * ng * 4 + wbytes + m * n * 4
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * m * k * n, FP16_OPS)
            row["b3b4_vs_b1"] = d12
            rows.append(row)
            print(f"  B4 M={m:4d} K={k:5d} N={n:5d}: bit-equal; unfolded "
                  f"{row['unfolded']['ms']:.4f} ms (plain {row['unfolded']['plain_ms']:.3f}), "
                  f"folded {row['folded']['ms']:.4f} ms (plain {row['folded']['plain_ms']:.3f}); "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                  f"B3+B4 vs B1 |diff| {d12:.3g} (max |y| {top:.3g})")
            del pw, copies, two, one, qx, ax, sx, x
    torch.cuda.empty_cache()
    return rows, max_err


def phase_b5(torch, FA, KVQ):
    print("== phase 8: B5 packed_flash_attention vs B2 over dequantize() and plain")
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(8)
    b, h, s, d = 4, 32, 2048, 128
    kv8 = KVQ.KV_PRESETS["kv8"]
    k = KVQ.quantize_kv(torch.randn(b, h, s, d, generator=gen, device="cuda"), kv8)
    v = KVQ.quantize_kv(torch.randn(b, h, s, d, generator=gen, device="cuda"), kv8)
    kd, vd = k.dequantize(), v.dequantize()
    out = {}
    for name, sq, kv_len, q0 in (
            ("decode", 1, [2048, 1501, 700, 37], [2047, 1500, 699, 36]),
            ("chunk", 128, [2048, 1128, 328, 192], [1920, 1000, 200, 64])):
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda")
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        q0 = torch.tensor(q0, dtype=torch.int32, device="cuda")
        args = (q, k.qm, k.scale, v.qm, v.scale, kv_len, q0)
        o = FA.packed_flash_attention(*args)
        b2 = FA.flash_attention(q, kd, vd, kv_len, q0)
        ref = FA.packed_flash_attention_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(o, b2):
            raise AssertionError(f"B5 {name} != B2 over dequantize(): max |diff| "
                                 f"{float((o - b2).abs().max())}")
        err = float((o - ref).abs().max())
        if not torch.allclose(o, ref, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"B5 {name}: kernel vs plain max |diff| {err}")
        mask = FA.attention_mask(kv_len, q0, sq, s, causal=True, window=0)
        visible = float(mask.sum())
        ms = cuda_ms(FA.packed_flash_attention, [args], iters=20)
        plain_ms = cuda_ms(FA.packed_flash_attention_plain, [args], iters=5)
        b2_ms = cuda_ms(FA.flash_attention, [(q, kd, vd, kv_len, q0)], iters=20)
        am = mask[:, None]
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=am),
                          [()], iters=20)
        # each row reads its keys up to kv_len once: int8 K/V + f32 scales
        nbytes = 2 * q.numel() * 4 + 2 * float(kv_len.sum()) * h * (d + 4) + 8 * b
        b_ms, b_by = bound(nbytes, visible * h * 4 * d, F32_OPS)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "b2_ms": b2_ms, "sdpa_dequantized_ms": sdpa_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        print(f"  B5 {name:6s} B={b} H={h} Sq={sq} S={s} D={d}: bit-equal to B2 over "
              f"dequantize(), |diff| to plain {err:.3g}; kernel {ms:.4f} ms, B2 {b2_ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), sdpa over "
              f"dequantized K/V {sdpa_ms:.4f} ms (yardstick)")
    del k, v, kd, vd
    torch.cuda.empty_cache()
    return out


def phase_kv_cross_device(torch, Engine, ServeConfig, Request, blocks, KVQ, models, cfg):
    print("== phase 9: 2-layer full width, kv8 + dsbp_kernel: CPU (plain) vs card "
          "(kernels); packed KV vs quantize-dequantize oracle on the card")
    import numpy as np

    gpu_model, cpu_model = models
    scfg = ServeConfig(max_len=64, kv_quant="kv8", quant_method="dsbp_kernel")
    gpu = Engine(gpu_model, scfg, device="cuda")
    cpu = Engine(cpu_model, scfg, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [5, 17, 9, 12], seed=3)
    n_new = 8
    t_cpu = cpu.generate(toks, n_new, lengths=lens)
    t_gpu = gpu.generate(toks, n_new, lengths=lens)

    # the CPU's tokens teacher-forced through both devices: per step logits
    # and, after the run, the packed caches
    def forced(eng):
        with torch.inference_mode():
            lg, cache, _ = eng.model.prefill(torch.as_tensor(toks, device=eng.device),
                                             scfg.max_len, lengths=lens, quant=eng.quant,
                                             kv=eng.kv_spec)
            steps = [lg[:, -1].float().cpu()]
            pos = torch.as_tensor(lens, device=eng.device)
            for t in range(n_new - 1):
                lg, cache = eng.model.decode_step(
                    torch.as_tensor(t_cpu[:, t:t + 1], device=eng.device), cache, pos + t,
                    eng.quant)
                steps.append(lg[:, -1].float().cpu())
        return torch.stack(steps, dim=1), cache

    l_cpu, c_cpu = forced(cpu)
    l_gpu, c_gpu = forced(gpu)
    delta = (l_cpu - l_gpu).abs().amax(dim=-1)  # (B, n_new) max |logit diff|
    top = float(l_cpu.abs().max())
    flips = sum(int((a[n].qm != b[n].qm.cpu()).sum()) for a, b in zip(c_cpu, c_gpu)
                for n in ("k", "v"))
    flip_max = max(int((a[n].qm.int() - b[n].qm.cpu().int()).abs().max())
                   for a, b in zip(c_cpu, c_gpu) for n in ("k", "v"))
    total = sum(a[n].qm.numel() for a in c_cpu for n in ("k", "v"))
    print(f"  teacher-forced max |logit diff| CPU vs card per step: "
          f"{[round(float(x), 6) for x in delta.amax(dim=0)]} (max |logit| {top:.3g}); "
          f"KV mantissas differing: {flips} of {total}, by at most {flip_max}")
    if float(delta[:, 0].max()) > TIE * top:  # prefill, as phase 4
        raise AssertionError(f"kv8+dsbp_kernel prefill logits differ by "
                             f"{float(delta[:, 0].max())} > {TIE} * {top}")
    if float(delta.max()) > KV_TIE * top:
        raise AssertionError(f"kv8+dsbp_kernel decode logits differ by {float(delta.max())} "
                             f"> {KV_TIE} * {top}")
    for r in range(len(lens)):
        bad = np.flatnonzero(t_cpu[r] != t_gpu[r])
        if bad.size:  # allowed only where the two devices' logits disagree on the order
            t = int(bad[0])
            top2 = torch.topk(l_cpu[r, t], 2).values
            gap = float(top2[0] - top2[1])
            if gap >= max(TIE * top, 2 * float(delta[r, t])):
                raise AssertionError(f"kv8+dsbp_kernel row {r} tokens diverge at step {t}: "
                                     f"{t_cpu[r]} vs {t_gpu[r]} (top-2 gap {gap}, logit "
                                     f"diff {float(delta[r, t])})")
            print(f"  row {r}: near tie at step {t} (top-2 gap {gap:.3g} < twice the "
                  f"CPU-vs-card logit diff {float(delta[r, t]):.3g}), compared up to it")
    print(f"  CPU vs card greedy tokens: {t_gpu.tolist()}")

    rng = np.random.default_rng(9)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n), max_new_tokens=8)
            for i, n in enumerate([5, 17, 9, 12, 7, 20])]
    packed = gpu.serve(reqs)
    real = blocks.quantize_like

    def qdq(leaf, fresh):  # a float cache whose every write is quantized first
        if not isinstance(leaf, KVQ.PackedKVBlock):
            return KVQ.quantize_kv(fresh, KVQ.KV_PRESETS["kv8"]).dequantize()
        return real(leaf, fresh)

    blocks.quantize_like = qdq
    try:
        oracle = Engine(gpu_model, ServeConfig(max_len=64, quant_method="dsbp_kernel"),
                        device="cuda").serve(reqs)
    finally:
        blocks.quantize_like = real
    for uid in packed:
        if not np.array_equal(packed[uid], oracle[uid]):
            raise AssertionError(f"request {uid}: packed-KV serving {packed[uid]} != "
                                 f"quantize-dequantize oracle {oracle[uid]}")
    print(f"  packed-KV serve == qdq-oracle serve for {len(reqs)} requests through 4 slots")
    del gpu, cpu, gpu_model, cpu_model
    torch.cuda.empty_cache()


def _reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0


def phase_kv_serve(torch, Engine, ServeConfig, Request, TO, kernels, model, cfg,
                   float_bpt):
    print("== phase 10: full-width llama-7b-paper, kv8 + dsbp_kernel generate + serve, "
          "then kv8 + dsbp_fused serve")
    import numpy as np

    toks, lens = _prompts(cfg.vocab_size, [16, 48, 96, 128], seed=4)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, int(n)),
                    max_new_tokens=16) for i, n in enumerate(rng.integers(16, 129, 8))]
    n_layers = cfg.n_layers
    eng = Engine(model, ServeConfig(max_len=512, batch_size=4, kv_quant="kv8",
                                    quant_method="dsbp_kernel"), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- this slice's main path: counts from 0 over exactly this run ----
    _reset_launches(kernels)
    out = eng.generate(toks, 16, lengths=lens)
    gst = dict(eng.last_stats)
    served = eng.serve(reqs, max_new_tokens=16)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    sst = dict(eng.last_stats)
    peak = torch.cuda.max_memory_allocated()

    if out.shape != (4, 16) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"kv8 generate output {out.shape} out of range")
    if sorted(served) != list(range(8)) or any(len(t) != 16 for t in served.values()):
        raise AssertionError("kv8 serve did not return 16 tokens for each of 8 requests")
    steps = gst["decode_steps"] + sst["decode_steps"]
    prefills = launches["flash_attention"] // n_layers
    if launches["dsbp_fused"] or launches["flash_attention"] % n_layers or not prefills \
            or launches["packed_flash_attention"] != n_layers * steps \
            or not (launches["fp8_quant_align"] == launches["dsbp_matmul"]
                    == 7 * n_layers * (prefills + steps)):
        raise AssertionError(f"kv8 + dsbp_kernel launches {launches} do not match "
                             f"{steps} decode steps and {n_layers} layers")
    bpt = sst["kv_bytes_per_token"]
    if not sst["kv_packed"] or bpt != 2 * n_layers * cfg.n_kv_heads * (cfg.d_head + 4):
        raise AssertionError(f"kv8 bytes per token {bpt}")
    print(f"  generate: prefill {gst['prefill_s']:.3f} s, decode "
          f"{gst['decode_tokens'] / gst['decode_s']:.1f} tok/s, "
          f"{1e3 * gst['decode_s'] / gst['decode_steps']:.2f} ms/step")
    print(f"  serve: {sst['decode_steps']} steps, {sst['admissions']} admissions, prefill "
          f"{sst['prefill_time_s']:.3f} s, decode {sst['decode_tps']:.1f} tok/s, "
          f"{1e3 * sst['decode_time_s'] / sst['decode_steps']:.2f} ms/step, occupancy "
          f"{sst['occupancy']:.3f}")
    print(f"  peak memory {peak / 2**30:.2f} GiB; KV bytes per token {bpt:.0f} packed vs "
          f"{float_bpt:.0f} float ({float_bpt / bpt:.2f}x less)")
    print(f"  launches over generate + serve: {launches} ({steps} decode steps, {prefills} "
          f"prefills; per decode step and per prefill: B3 = B4 = {7 * n_layers}, "
          f"B5 = {n_layers} per step, B2 = {n_layers} per prefill)")

    # ---- the dispatch contracts over one full-width decode step ----
    with torch.inference_mode():
        lg, cache, _ = eng.model.prefill(torch.as_tensor(toks, device="cuda"), 512,
                                         lengths=lens, quant=eng.quant, kv=eng.kv_spec)
        step = torch.argmax(lg[:, -1], dim=-1)[:, None]
        pos = torch.as_tensor(lens, device="cuda")

        def decode():
            return eng.model.decode_step(step, cache, pos, eng.quant)

        relayouts = TO.count_weight_transposes(decode, min_size=4096 * 4096)
        dequants = TO.count_kv_dequants(decode, min_size=cache[0]["k"].qm.numel())
    if relayouts or dequants:
        raise AssertionError(f"a packed decode step dispatched {relayouts} weight-sized "
                             f"relayouts and {dequants} KV-sized dequantizes")
    print("  one decode step dispatches 0 weight-sized relayouts and 0 KV-sized "
          "int8->float conversions outside the kernels")
    del cache, lg

    fused = Engine(model, ServeConfig(max_len=512, batch_size=4, kv_quant="kv8"),
                   device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kernels)
    served = fused.serve(reqs, max_new_tokens=16)
    torch.cuda.synchronize()
    fl = {name: fn.launches for name, fn in kernels.items()}
    fst = dict(fused.last_stats)
    fpeak = torch.cuda.max_memory_allocated()
    if sorted(served) != list(range(8)) or any(len(t) != 16 for t in served.values()):
        raise AssertionError("kv8 + dsbp_fused serve did not return 16 tokens each")
    if fl["dsbp_fused"] <= 0 or fl["flash_attention"] <= 0 or fl["packed_flash_attention"] \
            != n_layers * fst["decode_steps"] or fl["fp8_quant_align"] or fl["dsbp_matmul"]:
        raise AssertionError(f"kv8 + dsbp_fused launches {fl}")
    print(f"  kv8 + dsbp_fused serve: {fst['decode_steps']} steps, prefill "
          f"{fst['prefill_time_s']:.3f} s, decode {fst['decode_tps']:.1f} tok/s, "
          f"{1e3 * fst['decode_time_s'] / fst['decode_steps']:.2f} ms/step, peak "
          f"{fpeak / 2**30:.2f} GiB; launches {fl}")
    return launches, fl


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch import kvq as KVQ
    from repro_torch.core import quantized as Q
    from repro_torch.core.formats import per_tensor_scale
    from repro_torch.kernels import build
    from repro_torch.kernels import dsbp_fused as DF
    from repro_torch.kernels import dsbp_matmul as DM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fp8_quant_align as QA
    from repro_torch.kernels import ops as TO
    from repro_torch.models import blocks
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("== phase 1: build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  built {build.LIBRARIES} in {time.perf_counter() - t0:.1f} s")
    for name, report in build.reports.items():
        print(f"  ptxas report, {name}.cu:\n" + "\n".join(
            "    " + line for line in report.strip().splitlines() if "ptxas" in line
            or "registers" in line or "spill" in line))

    b1_rows, b1_err = phase_b1(torch, Q, DF, per_tensor_scale)
    b2 = phase_b2(torch, FA)
    cfg = get_config("llama-7b-paper")
    models = phase_cross_device(torch, TM, Engine, ServeConfig, cfg)
    model, launches, float_bpt = phase_serve(torch, TM, Engine, ServeConfig, Request,
                                             DF, FA, cfg)
    b3_rows = phase_b3(torch, Q, QA, per_tensor_scale)
    b4_rows, b4_err = phase_b4(torch, Q, DM, TO)
    b5 = phase_b5(torch, FA, KVQ)
    phase_kv_cross_device(torch, Engine, ServeConfig, Request, blocks, KVQ, models, cfg)
    kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
               "packed_flash_attention": FA.packed_flash_attention,
               "fp8_quant_align": QA.fp8_quant_align, "dsbp_matmul": DM.dsbp_matmul}
    kv_launches, _ = phase_kv_serve(torch, Engine, ServeConfig, Request, TO, kernels,
                                    model, cfg, float_bpt)

    b1 = next(r for r in b1_rows if (r["M"], r["K"], r["N"]) == (4, 4096, 11008))
    b3 = next(r for r in b3_rows if (r["M"], r["K"]) == (4, 4096))
    b4 = next(r for r in b4_rows if (r["M"], r["K"], r["N"]) == (4, 4096, 11008))
    kernels = [
        {"name": "dsbp_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dsbp_fused.cu",
         "replaces": "src/repro/kernels/dsbp_fused.py:73",
         "launches": launches["dsbp_fused"], "max_abs_err": b1_err,
         "ms": b1["ms"], "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
         "bound_by": b1["bound_by"], "library_ms": None,
         "shape": "decode M=4 K=4096 N=11008", "path": "phase 5 (float KV, dsbp_fused)"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:70",
         "launches": launches["flash_attention"],
         "max_abs_err": max(v["max_abs_err"] for v in b2.values()),
         "ms": b2["prefill"]["ms"], "plain_ms": b2["prefill"]["plain_ms"],
         "bound_ms": b2["prefill"]["bound_ms"], "bound_by": b2["prefill"]["bound_by"],
         "library_ms": b2["prefill"]["library_ms"],
         "decode_ms": b2["decode"]["ms"], "decode_library_ms": b2["decode"]["library_ms"],
         "shape": "prefill B=4 H=32 S=512 D=128", "path": "phase 5 (float KV, dsbp_fused)"},
        {"name": "fp8_quant_align", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fp8_quant_align.cu",
         "replaces": "src/repro/kernels/fp8_quant_align.py:123",
         "launches": kv_launches["fp8_quant_align"], "max_abs_err": 0.0,
         "ms": b3["ms"], "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"],
         "bound_by": b3["bound_by"], "library_ms": None,
         "shape": "decode M=4 K=4096", "path": "phase 10 (kv8, dsbp_kernel)"},
        {"name": "dsbp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dsbp_matmul.cu",
         "replaces": "src/repro/kernels/dsbp_matmul.py:84",
         "launches": kv_launches["dsbp_matmul"], "max_abs_err": b4_err,
         "ms": b4["folded"]["ms"], "plain_ms": b4["folded"]["plain_ms"],
         "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"], "library_ms": None,
         "unfolded_ms": b4["unfolded"]["ms"],
         "shape": "decode M=4 K=4096 N=11008, folded", "path": "phase 10 (kv8, dsbp_kernel)"},
        {"name": "packed_flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:166",
         "launches": kv_launches["packed_flash_attention"],
         "max_abs_err": max(v["max_abs_err"] for v in b5.values()),
         "ms": b5["decode"]["ms"], "plain_ms": b5["decode"]["plain_ms"],
         "bound_ms": b5["decode"]["bound_ms"], "bound_by": b5["decode"]["bound_by"],
         "library_ms": None, "sdpa_dequantized_ms": b5["decode"]["sdpa_dequantized_ms"],
         "shape": "decode B=4 H=32 S=2048 D=128, ragged", "path": "phase 10 (kv8, dsbp_kernel)"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
