"""Calibration + policy-autotuning launcher (port of ``repro.launch.calibrate``).

  PYTHONPATH=src python -m repro_torch.launch.calibrate --arch yi-9b --smoke \\
      --device cpu [--batches 2] [--items 64] [--ladder 6 4 3 2] \\
      [--max-drop 0.0] [--quant-method dsbp_fused]

Runs the exploration loop on one arch, on the CUDA card unless
``--device`` names another device: synthetic calibration batches ->
per-layer DSBP statistics -> synthetic BoolQ/Winogrande gold labels from
the float model -> the accuracy-constrained greedy autotune -> a servable
``DSBPPolicy``, printed with its summary and as ``policy.to_json()`` (the
JAX package's format: save it to a file and serve it with
``launch.serve --policy FILE`` in either package).  The weights are random,
from the seeded ``torch.Generator`` of ``models.model.init``.  JAX's
``--trained-like`` (it imports the JAX-side ``benchmarks.common``) and
``--save`` (it needs ``checkpoint.store``) are not ported (ROADMAP A1, A12).
The TOPS/W it prints is the paper's 28 nm macro model
(``core.energy``), not a measurement of the device.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.eval import harness
from repro_torch.models import model as M
from repro_torch.policy import autotune, calibrate, synthetic_calibration_batches
from repro_torch.policy.cost import input_bitwidth_ladder


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--items", type=int, default=64)
    ap.add_argument("--margin", type=float, nargs=2, default=(1.0, 2.0),
                    help="decided-item margin floors (boolq, winogrande)")
    ap.add_argument("--ladder", type=int, nargs="+", default=(6, 4, 3, 2),
                    help="input B_fix demotion rungs, most precise first")
    ap.add_argument("--max-drop", type=float, default=0.0)
    ap.add_argument("--quant-method", default=None,
                    help="trial-engine method (default: the serving default, "
                         "dsbp_fused; JAX's launcher defaults to dsbp_ref)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = M.init(cfg, seed=0, device=device)

    report = calibrate(model, cfg, synthetic_calibration_batches(
        cfg, args.batches, args.batch, args.seq, seed=0))
    print(f"calibrated {len(report.layers)} projection paths over "
          f"{report.meta['n_tokens']} tokens "
          f"({report.total_flops / 1e9:.2f} GFLOP observed)")
    for path in sorted(report.layers):
        s = report.layers[path]
        print(f"  {path:28s} K={s.k:5d} N={s.n:5d} "
              f"flop_share={report.flop_share(path):5.1%} nz={s.nz_frac:.2f}")

    tasks, golds = harness.decided_tasks(model, cfg, args.items, tuple(args.margin))
    for t, lo in zip(tasks, args.margin):
        print(f"{t.name}: {len(t.items)}/{t.meta['subset_of']} decided "
              f"items (margin >= {lo})")

    policy = autotune(model, cfg, report, tasks,
                      ladder=input_bitwidth_ladder(tuple(args.ladder)),
                      max_drop=args.max_drop,
                      quant_method=args.quant_method, log=print)
    print("\nchosen policy:")
    print(policy.summary())
    m = policy.meta["modeled"]
    print(f"modeled on the paper's 28 nm macro (core.energy, not this device): avg "
          f"I/W {m['avg_i']:.2f}/{m['avg_w']:.2f}, {m['eff_tops_w']:.2f} TOPS/W; acc "
          f"{policy.meta['final_acc']} (baseline {policy.meta['baseline_acc']})")
    print("policy JSON:")
    print(policy.to_json())


if __name__ == "__main__":
    main()
