"""Training launcher for the port: QAT on the synthetic stream, with
checkpoints and restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-7b-paper \\
      [--smoke] [--layers N] --steps 20 --batch 8 --seq 128 --lr 1e-3 \\
      [--ckpt DIR [--ckpt-every N]] [--quant precise] [--method dsbp_fused] \\
      [--device cpu]

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain PyTorch
versions instead (use it with ``--smoke``).  A full-size config trains in
bfloat16, as the JAX launcher's does; ``--smoke`` in f32.  Every arch
trains: an audio config on (B, S, K) codebook ids, a vlm config with its
image embeddings in front of the text.  ``--layers N`` cuts the depth of
any config: the first line says so and, where the pattern has more than
one kind, which pattern units and tail layers the cut keeps;
``--quant`` / ``--method`` set the projections' DSBP preset and method (a
raw weight trains through the method's kernel forward with a
straight-through backward).  ``--ckpt`` saves ``(params, opt_state)``
every ``--ckpt-every`` steps (50, as JAX's) and at the end, and resumes
from its newest step.  A mesh other than 1x1 waits for ROADMAP A13.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b-paper")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--quant", default=None, help="a DSBP preset (default: the config's)")
    ap.add_argument("--method", default=None, help="dsbp_fused, dsbp_kernel or dsbp_ref")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: training on a mesh waits for "
                                  f"ROADMAP A13")
    cfg = (smoke_config(args.arch) if args.smoke else
           get_config(args.arch).replace(dtype="bfloat16"))
    full_layers = cfg.n_layers
    kw = {}
    if args.layers is not None:
        kw["n_layers"] = args.layers
    if args.quant is not None:
        kw["quant"] = args.quant
    if args.method is not None:
        kw["quant_method"] = args.method
    cfg = cfg.replace(**kw)
    device = resolve_device(args.device)
    cut = ""
    if cfg.n_layers != full_layers:
        cut = f" (cut from {full_layers}"
        if len(cfg.pattern) > 1:  # which kinds the cut keeps
            cut += f": {cfg.n_units} x {'/'.join(cfg.pattern)}"
            cut += f" + {'/'.join(cfg.tail)}" if cfg.tail else ""
        cut += ")"
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M layers={cfg.n_layers}{cut} "
          f"dtype={cfg.dtype} quant={cfg.quant} method={cfg.quant_method} device={device}")
    ocfg = adamw.AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 10, 1),
                             total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                       log_every=1)
    tr = Trainer(cfg, tcfg, ocfg, DataConfig(seed=0, batch_size=args.batch, seq_len=args.seq),
                 device=device)

    def report(step, m):
        print(f"step {step:5d} loss {m['loss']:.4f} ({m['step_time_s'] * 1e3:.0f} ms)")

    _, opt_state, history = tr.run(on_metrics=report)
    if args.ckpt:
        print(f"saved step {int(opt_state['step'])} to {args.ckpt}")
    return history


if __name__ == "__main__":
    main()
