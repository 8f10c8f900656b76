"""Serving launcher for the port: pack once, then generate or serve.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b-paper \\
      --packed [--ragged] [--kv-quant kv8] [--method dsbp_kernel] \\
      [--smoke --device cpu]

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain PyTorch
versions instead (use it with ``--smoke``).  ``--ragged`` draws mixed-length
prompts (2 per slot) through the ``Engine.serve`` slot scheduler instead of
one uniform ``generate`` batch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request, ServeConfig


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain PyTorch versions)")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(quant=args.preset if args.packed else None)
    model = M.init(cfg, seed=0, device=args.device)
    max_len = args.prompt_len + args.new_tokens + 8
    scfg = ServeConfig(max_len=max_len, batch_size=args.batch,
                       quant_method=args.method, kv_quant=args.kv_quant,
                       kv_bits=args.kv_bits)
    eng = Engine(model, scfg, device=args.device)
    if eng.pack_report:
        rep = eng.pack_report
        print(f"packed weights: {rep['raw_nbytes']/1e6:.1f} -> "
              f"{rep['packed_nbytes']/1e6:.1f} MB (avg W bits "
              f"{rep['avg_w_bits']:.2f}, preset {rep['preset']})")
    if eng.kv_spec is not None:
        print(f"packed KV cache: {eng.kv_spec}")
    rng = np.random.default_rng(0)
    if args.ragged:
        lens = rng.integers(args.prompt_len // 2, args.prompt_len + 1, 2 * args.batch)
        reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, (int(n),)),
                        max_new_tokens=args.new_tokens)
                for i, n in enumerate(lens)]
        t0 = time.monotonic()
        out = eng.serve(reqs, max_new_tokens=args.new_tokens)
        dt = time.monotonic() - t0
        st = eng.last_stats
        print(f"served {st['requests']} ragged requests (lens {lens.tolist()}) "
              f"in {dt:.2f}s ({st['decode_tps']:.1f} decode tok/s, occupancy "
              f"{st['occupancy']*100:.0f}%, {st['decode_steps']} pool steps, "
              f"{st['kv_bytes_per_token']:.0f} KV bytes/token)")
        for uid in list(out)[:2]:
            print(f"  req{uid}: {out[uid].tolist()}")
        return
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.monotonic()
    out = eng.generate(prompts, args.new_tokens)
    dt = time.monotonic() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {out[b].tolist()}")


if __name__ == "__main__":
    main()
