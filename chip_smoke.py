#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; nothing falls back to the CPU):
  1. build every CUDA kernel of the main path from src/repro_torch/kernels/csrc
     with nvcc and print the ptxas register/shared-memory report;
  2. B1, the fused DSBP GEMM, against its plain PyTorch version on the card at
     the llama-7b projection shapes (decode M=4 and prefill M=512): bit-equal;
     kernel, plain and bound times;
  3. B2, flash attention, against its plain version at prefill (B=4, H=32,
     S=512, D=128, ragged lengths) and decode (per-row positions), with
     torch's scaled_dot_product_attention timed on the prefill work as a
     yardstick;
  4. a 2-layer model at full llama-7b width, the same packed weights served
     once on the CPU (plain versions) and once on the card (kernels): logits
     within tolerance, greedy tokens equal;
  5. full-width 32-layer llama-7b-paper with random weights from a seeded
     torch.Generator, packed "precise": one ragged Engine.generate of 4
     prompts and Engine.serve of 8 requests through 4 slots, with each
     kernel's launch count over that run.
Prints the kernels' JSON record, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import copy
import dataclasses
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
L2_BYTES = 50 * 2**20
TIE = 1e-3  # logit tolerance, relative to max|logit|


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
    cases = [(m, k, n, "precise", {}) for m in (4, 512)
             for k, n in ((4096, 4096), (4096, 11008), (11008, 4096))]
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
        lib_ms = None
        if name == "prefill":
            am = mask[:, None]
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=am),
                             [()], iters=20)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "max_abs_err": err}
        print(f"  B2 {name:7s} B={b} H={h} Sq={qq.shape[2]} S={s} D={d}: max |diff| {err:.3g};"
              f" kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), sdpa {lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}")
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
    del gpu, cpu, gpu_model
    torch.cuda.empty_cache()
    return diff


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
    return launches, gst, sst, peak


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import quantized as Q
    from repro_torch.core.formats import per_tensor_scale
    from repro_torch.kernels import build
    from repro_torch.kernels import dsbp_fused as DF
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("== phase 1: build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  built {sorted(build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s")
    for name, report in build.reports.items():
        print(f"  ptxas report, {name}.cu:\n" + "\n".join(
            "    " + line for line in report.strip().splitlines() if "ptxas" in line
            or "registers" in line or "spill" in line))

    b1_rows, b1_err = phase_b1(torch, Q, DF, per_tensor_scale)
    b2 = phase_b2(torch, FA)
    cfg = get_config("llama-7b-paper")
    phase_cross_device(torch, TM, Engine, ServeConfig, cfg)
    launches, _, _, _ = phase_serve(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg)

    b1 = next(r for r in b1_rows if (r["M"], r["K"], r["N"]) == (4, 4096, 11008))
    kernels = [
        {"name": "dsbp_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dsbp_fused.cu",
         "replaces": "src/repro/kernels/dsbp_fused.py:73",
         "launches": launches["dsbp_fused"], "max_abs_err": b1_err,
         "ms": b1["ms"], "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
         "bound_by": b1["bound_by"], "library_ms": None,
         "shape": "decode M=4 K=4096 N=11008"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:70",
         "launches": launches["flash_attention"],
         "max_abs_err": max(v["max_abs_err"] for v in b2.values()),
         "ms": b2["prefill"]["ms"], "plain_ms": b2["prefill"]["plain_ms"],
         "bound_ms": b2["prefill"]["bound_ms"], "bound_by": b2["prefill"]["bound_by"],
         "library_ms": b2["prefill"]["library_ms"],
         "shape": "prefill B=4 H=32 S=512 D=128"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
