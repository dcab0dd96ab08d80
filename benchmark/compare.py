"""The comparison that decides ``correct`` for a training cell.

Both sides hand in a record of the same first steps from the same state
and inputs: ``losses`` (each step's loss), ``grad`` (each leaf's norm of
the first gradient as the optimizer got it, worked out from its first
moment after one step) and ``changes`` (after each step, each leaf's norm
of its change since the start).  Three numbers, each to be at most its
limit; the cell's file says over how many steps (``loss_steps``) and after
which step (``change_step``):

* ``loss``: the largest relative gap of a step's loss;
* ``grad``: the gap of gradient norms of the worst leaf (``grad_leaf``
  "worst"), each over the reference's norm of that leaf or of the median
  leaf, whichever is larger (some gradients are all but zero); or
  ("group_median") the worst, over the groups of leaves, of the group's
  median leaf, each gap over the larger of that leaf's and the group's
  median norm.  A leaf's group is its name up to the first ``.``, trailing
  digits dropped: ``sdf_net.w3`` and ``sdf_net.b0`` are ``sdf_net``,
  ``mlp2`` is ``mlp``;
* ``change``: the same by the worst leaf for the norms of the leaves'
  changes, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with a gradient nought to
  rounding moves under Adam by round-off alone); a moving average of the
  parameters (``ema/NAME``) counts as its parameter does.

A gap that is not a number reads as infinite."""
from __future__ import annotations

import math
import re
import statistics

ROUND_OFF_GRAD = 1e-3  # of the median leaf's gradient norm


def _gap(p: float, r: float, scale: float) -> float:
    g = abs(p - r) / scale if scale > 0 else abs(p - r)
    return g if math.isfinite(g) else math.inf


def worst_leaf(prog: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    if not leaves:
        return 0.0
    med = statistics.median(ref[k] for k in leaves)
    return max(_gap(prog[k], ref[k], max(ref[k], med)) for k in leaves)


def median_leaf(prog: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    return statistics.median(_gap(prog[k], ref[k], max(ref[k], med)) for k in leaves)


def leaf_group(name: str) -> str:
    return re.sub(r"\d+$", "", name.split(".")[0])


def group_median(prog: dict, ref: dict, leaves) -> float:
    groups = {}
    for k in leaves:
        groups.setdefault(leaf_group(k), []).append(k)
    return max((median_leaf(prog, ref, ks) for ks in groups.values()), default=0.0)


BY_LEAF = {"worst": worst_leaf, "group_median": group_median}


def counted_leaves(ref_grad: dict, keys) -> list:
    """``keys`` whose parameter's reference gradient (a key ``ema/NAME``
    reads NAME's: a moving average of parameters moves with them) is at
    least ``ROUND_OFF_GRAD`` of the median leaf's."""
    med = statistics.median(ref_grad.values())
    return [k for k in keys if ref_grad.get(k.removeprefix("ema/"), 0.0) >= ROUND_OFF_GRAD * med]


def compare(prog: dict, ref: dict, loss_steps: int, change_step: int, grad_leaf: str = "worst") -> dict:
    if (len(prog["losses"]) < loss_steps or len(ref["losses"]) < loss_steps
            or len(prog["changes"]) < change_step or len(ref["changes"]) < change_step
            or set(prog["grad"]) != set(ref["grad"])
            or set(prog["changes"][change_step - 1]) != set(ref["changes"][change_step - 1])):
        return {"loss": math.inf, "grad": math.inf, "change": math.inf}
    loss = max(_gap(p, r, abs(r)) for p, r in zip(prog["losses"][:loss_steps], ref["losses"][:loss_steps]))
    pc, rc = prog["changes"][change_step - 1], ref["changes"][change_step - 1]
    return {"loss": loss, "grad": BY_LEAF[grad_leaf](prog["grad"], ref["grad"], ref["grad"]),
            "change": worst_leaf(pc, rc, counted_leaves(ref["grad"], rc))}
