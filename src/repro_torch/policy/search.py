"""Accuracy-constrained greedy policy autotuner.

Port of ``repro.policy.search``.  :func:`autotune` walks per-layer
configs:

  1. every calibrated projection starts at the most precise ladder rung;
     the baseline accuracy on the eval tasks comes from a real
     policy-packed :class:`~repro_torch.serve.engine.Engine`;
  2. layers are ordered by modeled time share at the precise widths, most
     bit-hungry first;
  3. per layer, ladder rungs are tried from the cheapest up, and the first
     whose end-to-end accuracy stays within ``max_drop`` of the baseline
     on EVERY task is kept; a trial repacks only the touched projection;
  4. the result is a :class:`~repro_torch.policy.policy.DSBPPolicy` with
     the chosen configs and the provenance (trace, accuracies, modeled
     cost) in ``meta``.

JAX packs each trial from its untouched raw tree, functionally.  Here the
raw model stays resident and unchanged (its float weights give the gold
labels and every trial's containers), and the trials run on one packed
:func:`~repro_torch.models.model.shared` view of it: the view shares the
raw model's embedding, norms and head, holds the packed containers, and
a trial swaps one projection's containers in place
(:func:`_replace_container`), putting the old ones back when the rung is
rejected.  The view is dropped when the search ends.
"""
from __future__ import annotations

from repro_torch.core.quantized import pack_weights
from repro_torch.eval import harness
from repro_torch.models.model import shared
from repro_torch.models.packing import pack_weights_int8
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.spec.draft import stacked_key

from .calibrate import CalibrationReport, raw_projections, refuse_unported
from .cost import assignment_cost, candidate_ladder, resolve_cfg
from .kv_bits import price_kv_bits
from .policy import DSBPPolicy

__all__ = ["autotune"]


def _replace_container(model, path_key: str, new) -> list:
    """Swap the containers of one projection path (every layer its stacked
    key covers) in place: ``new`` is the list of the new containers, in
    layer order.  Returns the old ones, in the same order."""
    old = []
    for mod_name, module in model.named_modules():
        if not mod_name.startswith("layers."):
            continue
        for name, child in list(module.named_children()):
            if stacked_key(model.cfg, f"{mod_name}.{name}") == path_key:
                setattr(module, name, new[len(old)])
                old.append(child)
    if len(old) != len(new):
        raise ValueError(f"{path_key!r}: {len(old)} containers for {len(new)} new ones")
    return old


def autotune(model, cfg, report: CalibrationReport, tasks,
             *, ladder=None, max_drop: float = 0.0, max_len: int = 256,
             min_accuracy=None, quant_method: str | None = None,
             batch_items: int = 16, kv_stats=None, kv_fine="kv8",
             kv_coarse="kv4", kv_budget_frac_fine: float = 0.5,
             log=None) -> DSBPPolicy:
    """Greedy accuracy-constrained per-layer search; returns the policy.

    ``model`` is the RAW float model (gold labels need it; it is not
    changed), ``report`` a :func:`~repro_torch.policy.calibrate.calibrate`
    result, ``tasks`` a list of :class:`~repro_torch.eval.tasks.MCTask`.
    ``max_drop`` is the allowed accuracy drop against the most-precise-rung
    baseline (0.0 = equal or better on every task); ``min_accuracy``
    (per-task floors) tightens it.  ``quant_method`` pins the trial
    engines' method (None = the serving default, 'dsbp_fused').
    ``kv_stats`` (a :func:`~repro_torch.policy.kv_bits.collect_kv_stats`
    result) extends the result into a joint weight+KV policy through
    :func:`~repro_torch.policy.kv_bits.price_kv_bits`."""
    refuse_unported(cfg, "autotune")
    log = log or (lambda *_: None)
    ladder = list(ladder or candidate_ladder())
    names = [n for n, _ in ladder]
    rungs = [resolve_cfg(c) for _, c in ladder]
    paths = sorted(report.layers)
    if not paths:
        raise ValueError("calibration report names no quantizable layers")
    raw = raw_projections(model, cfg)

    def accuracies(view):
        eng = Engine(view, ServeConfig(max_len=max_len, pack=False,
                                       quant_method=quant_method), device=model.device)
        return [harness.evaluate(eng, t, g, batch_items)
                for t, g in zip(tasks, golds)]

    golds = []
    for t in tasks:
        gold, _ = harness.gold_labels_and_margins(model, cfg, t, batch_items)
        golds.append(gold)

    # rung 0 everywhere: the precision ceiling and the accuracy constraint.
    # Projections outside the report pack at the ceiling via `default`
    assignment = {p: rungs[0] for p in paths}
    view = shared(model, cfg.replace(quant="policy"))
    pack_weights_int8(view, DSBPPolicy(layers=dict(assignment), default=rungs[0]))
    acc0 = accuracies(view)
    floor = [a - max_drop for a in acc0]
    if min_accuracy is not None:
        floor = [max(f, m) for f, m in zip(floor, min_accuracy)]
        if any(a < f for a, f in zip(acc0, floor)):
            raise ValueError(
                f"the {names[0]}-everywhere baseline scores {acc0}, below "
                f"the requested min_accuracy floor {list(min_accuracy)} — "
                f"no demotion can certify against it; raise the ceiling "
                f"rung or lower the floor")
    log(f"baseline ({names[0]} everywhere): acc={acc0} floor={floor}")

    # most bit-hungry first: modeled time share at the precise rung
    base_cost = assignment_cost(report, assignment)
    order = sorted(paths, key=lambda p: -base_cost["per_layer"][p]["time_s"])

    trace = []
    acc_now = acc0
    for path in order:
        chosen = 0
        trials = []
        # cheapest rung first; first one inside the constraint wins
        for ri in range(len(rungs) - 1, 0, -1):
            old = _replace_container(view, path,
                                     [pack_weights(w.data, rungs[ri]) for w in raw[path]])
            acc = accuracies(view)
            ok = all(a >= f for a, f in zip(acc, floor))
            trials.append({"rung": names[ri],
                           "acc": [round(a, 4) for a in acc], "accepted": ok})
            log(f"{path}: {names[ri]} acc={acc} {'OK' if ok else 'reject'}")
            if ok:
                chosen = ri
                assignment[path] = rungs[ri]
                acc_now = acc
                break
            _replace_container(view, path, old)
        trace.append({"layer": path, "chosen": names[chosen], "trials": trials})
    del view

    modeled = assignment_cost(report, assignment)
    policy = DSBPPolicy(
        layers=dict(assignment),
        default=rungs[0],  # uncalibrated projections stay at the ceiling
        meta={
            "arch": cfg.name,
            "ladder": names,
            "max_drop": max_drop,
            "baseline_acc": [round(a, 4) for a in acc0],
            "final_acc": [round(a, 4) for a in acc_now],
            "tasks": [t.name for t in tasks],
            "rungs": {p: names[rungs.index(assignment[p])] for p in paths},
            "modeled": {k: modeled[k] for k in
                        ("time_s", "energy_j", "eff_tops_w", "avg_i", "avg_w")},
            "calibration": report.meta,
            "trace": trace,
        },
    )
    if kv_stats:
        kv_artifact, kv_info = price_kv_bits(
            kv_stats, fine=kv_fine, coarse=kv_coarse,
            budget_frac_fine=kv_budget_frac_fine)
        policy = policy.with_kv(kv_artifact, meta_update={"kv_pricing": kv_info})
        log(f"kv pricing: {kv_info['assignment']} "
            f"(fine byte share {kv_info['fine_byte_share']:.2f})")
    return policy
