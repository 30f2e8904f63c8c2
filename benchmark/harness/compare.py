"""The numbers that decide `correct`, each held to a limit of its own
(workloads/<cell>.json).

Training (the checked steps of the run: the first step, then whole
blocks of the cell's steps_per_call, which set-up drives through the
window's own entry, trainer.fit, and hands on to it), each program side
against the plain reference's:

- loss_gap: the widest gap between a loss and the reference's, over
  the first step's and the first block's mean, against the larger of
  the reference's loss there and at the first step (a trained model's
  loss falls near 0, where a relative gap is rounding's);
  loss_gap_later, the same over each block's last loss and the later
  blocks' means, is computed and printed; rounding alone moves those
  later losses by as much as a fault in a block (PERF.md, section 2);
- grad_gap: the first gradient as the optimizer got it (its first
  moment after one step, divided by 1 - beta1), by the worst leaf: the
  gap between the program's and the reference's norm of the leaf,
  against the larger of the reference's norm of that leaf and of the
  median leaf;
- grad_diff_elem: the same gradient element by element: the median over
  its elements that are not 0 of the gap against the reference's
  element, the number that separates float32 from TF32 (PERF.md,
  section 2);
- change_gap: each leaf's change over the checked steps, its gap of
  norms as grad_gap has it, the worst leaf; change_gap_median, the
  median leaf's.

A cell's limits file names the numbers it compares.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone; they are left out of the
change by that rule (LeNet-5 has none at the seeds tried, but the rule
stands).
"""

from __future__ import annotations

import statistics

import torch

NULL_GRAD = 1e-3      # a leaf under this share of the median leaf's


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: the gap between the two norms of the leaf, against the
    larger of the reference's norm of that leaf and of the median
    leaf}."""
    pn, rn = _norms(prog), _norms(ref)
    keys = [k for k in rn if keep is None or k in keep]
    med = statistics.median(rn[k] for k in keys)
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def worst_leaf(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """(worst relative gap of norms, its leaf)."""
    gaps = leaf_gaps(prog, ref, keep)
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def diff_elems(prog: dict, ref: dict) -> float:
    """The median, over every element of every leaf where the reference
    is not 0, of the gap between the two values against the
    reference's. (A unit that no input activates has a gradient of
    exactly 0 on both sides; on some seeds such elements are half of
    LeNet-5's, and the median would read 0 whatever the precision.)"""
    rel = []
    for k, r in ref.items():
        r = r.double().flatten()
        live = r != 0
        rel.append((prog[k].double().flatten()[live] - r[live]).abs()
                   / r[live].abs())
    return float(torch.cat(rel).median())


def train_readings(prog: dict, ref: dict, init: dict) -> dict:
    """prog and ref: {"losses": [the first step's, then each block's last
    and mean], "grads": {leaf: the first gradient}, "params": {leaf:
    tensor after the last step}}; init: the parameters both started
    from."""
    first = abs(ref["losses"][0])
    steps = [abs(p - r) / max(abs(r), first, 1e-30)
             for p, r in zip(prog["losses"], ref["losses"])]
    grad_gap, grad_leaf = worst_leaf(prog["grads"], ref["grads"])
    gn = _norms(ref["grads"])
    med = statistics.median(gn.values())
    keep = {k for k, v in gn.items() if v >= NULL_GRAD * med}
    delta = lambda tree: {k: tree[k].double().cpu() - init[k].double().cpu()  # noqa: E731
                          for k in tree}
    changes = leaf_gaps(delta(prog["params"]), delta(ref["params"]), keep)
    change_leaf = max(changes, key=changes.get)
    return {"loss_gap": max(steps[0], steps[2]),
            "loss_gap_later": max([steps[1]] + steps[3:]),
            "grad_gap": grad_gap,
            "grad_diff_elem": diff_elems(prog["grads"], ref["grads"]),
            "change_gap": changes[change_leaf],
            "change_gap_median": statistics.median(changes.values()),
            "_leaves": {"grad": grad_leaf, "change": change_leaf,
                        "left_out": sorted(set(gn) - keep)},
            "_steps": steps}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the readings that have
    a limit; a reading that is not a finite number fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = (isinstance(value, (int, float)) and value == value
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
