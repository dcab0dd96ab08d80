"""A reconstruction cell: the port's ``Reconstructor.train_step`` in a
closed loop, one step after another, as the CLI's training loop runs it.

Built through ``train/setup.reconstructor_from_flags`` from the
configuration file, as ``train_gshell`` builds it; the state is
``Reconstructor.make_state`` of the parameters that ``inputs`` draws, at
the traffic's state step, its Adam moments warm (``inputs.warm_adam``).
Step ``k`` takes ``batch`` views drawn from the
seed and the draw source ``step{k}``.  The reference is the plain copy in
``reference/recon``, given the same parameters, batches and draws."""
from __future__ import annotations

import contextlib

import torch

from ..draws import KeyedDraws
from ..inputs import reconstruction as inputs
from ..reference.recon import trainer as ref_trainer

BETA1 = 0.9  # torch.optim.Adam's default, the port's and the reference's
FAULTS = ("unchanged", "half_batch")


def named_leaves(params_geo: dict, params_mat: dict, light_base) -> dict:
    out = {}
    for k, v in params_geo.items():
        if isinstance(v, dict):
            for n, ts in v.items():
                out.update({f"{k}.{n}{i}": t for i, t in enumerate(ts)})
        else:
            out[k] = v
    out["tables"] = params_mat["tables"]
    out.update({f"mlp{i}": w for i, w in enumerate(params_mat["mlp"])})
    out["light"] = light_base
    return out


def first_moments(optimizers) -> dict:
    """{id(parameter): Adam's first moment} over the three optimizers."""
    return {id(p): s["exp_avg"] for opt in optimizers for p, s in opt.state.items()}


class Cell:

    def __init__(self, config_path: str, traffic: dict, seed: int, device, fault: str | None = None):
        from gshell_tpu_torch.train.setup import reconstructor_from_flags
        from gshell_tpu_torch.utils.config import load_flags

        if fault not in (None,) + FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.config_path, self.traffic, self.seed, self.fault = config_path, traffic, int(seed), fault
        self.device = torch.device(device)
        self.flags = load_flags(config_path)
        self.rec = reconstructor_from_flags(self.flags, self.device)
        geo, mat, light = inputs.make_params(self.flags, self.seed, self.device, traffic["shape_fit_steps"],
                                             traffic["shape_fit_points"])
        self.initial = {"geo": geo, "mat": mat, "light": light}
        self.state = self.rec.make_state(geo, mat, light, step=traffic["state_step"])
        inputs.warm_adam(self.state.optimizers, self.leaves(), self.seed, traffic["adam_moments"])
        self.targets = inputs.render_targets(self.flags, self.seed, self.device, traffic["n_views"],
                                             traffic["cam_radius"], traffic["fovy_deg"])
        self.batch_size = self.flags.batch
        self.units_per_step = 1
        self.faces = []  # each step's face count (0-d tensors, read after the window)

    def notes(self) -> str:
        return f"faces a step: {[int(f) for f in self.faces]}"

    def batch(self, k: int) -> dict:
        target = inputs.batch(self.targets, self.seed, k, self.batch_size)
        if self.fault == "half_batch":
            target = {n: t[: self.batch_size // 2] for n, t in target.items()}
        return target

    def step(self, k: int):
        """Train step ``k`` → its total loss (a 0-d tensor, not waited for)."""
        if self.fault == "unchanged":
            before = [t.detach().clone() for t in self.leaves().values()]
        m = self.rec.train_step(self.state, KeyedDraws(self.seed, self.device, f"step{k}"), self.batch(k))
        self.faces.append(m["n_faces"])
        if self.fault == "unchanged":
            with torch.no_grad():
                for t, b in zip(self.leaves().values(), before):
                    t.copy_(b)
        return m["total"]

    def spans(self):
        """No span of its own: the step is one call."""
        return contextlib.nullcontext()

    def leaves(self) -> dict:
        s = self.state
        return named_leaves(s.params_geo, s.params_mat, s.light_base)

    def follow(self, n: int) -> dict:
        """Steps 0 .. n−1, recorded: every loss, each leaf's first gradient
        as Adam got it (its first moment after step 0, less β1 times the warm
        one it started from, over 1 − β1) and, after each step, each leaf's
        change since the start."""
        losses, grad, changes = [], {}, []
        init = named_leaves(self.initial["geo"], self.initial["mat"], self.initial["light"])
        for k in range(n):
            losses.append(float(self.step(k)))
            if k == 0:
                grad = self.leaf_grads(self.leaves(), first_moments(self.state.optimizers))
            changes.append(leaf_changes(self.leaves(), init))
        return {"losses": losses, "grad": grad, "changes": changes}

    def free(self) -> None:
        """Drop the program's state and model (the initial parameters and the
        targets stay: the reference takes them)."""
        self.state = self.rec = None

    def reference(self, n: int, lower: bool = False) -> dict:
        """The plain reference's record of the same ``n`` steps; ``lower``:
        its products in TF32, the control.  Also the MLP evaluations of its
        first step (``evaluations``)."""
        ref = ref_trainer.ReferenceReconstructor(self.config_path, self.device, tf32=lower)
        init = self.initial
        state = ref.make_state(init["geo"], init["mat"], init["light"], step=self.traffic["state_step"])
        leaves = named_leaves(state.params_geo, state.params_mat, state.light_base)
        inputs.warm_adam(state.optimizers, leaves, self.seed, self.traffic["adam_moments"])
        base = named_leaves(init["geo"], init["mat"], init["light"])
        losses, grad, changes, evaluations = [], {}, [], []
        for k in range(n):
            target = inputs.batch(self.targets, self.seed, k, self.batch_size)
            m = ref.train_step(state, KeyedDraws(self.seed, self.device, f"step{k}"), target)
            losses.append(m["total"])
            if k == 0:
                evaluations = m["evaluations"]
                grad = self.leaf_grads(leaves, first_moments(state.optimizers))
            changes.append(leaf_changes(leaves, base))
        return {"losses": losses, "grad": grad, "changes": changes, "evaluations": evaluations}

    @torch.no_grad()
    def leaf_grads(self, leaves: dict, moments: dict) -> dict:
        spec = self.traffic["adam_moments"]
        return {k: float(torch.linalg.vector_norm(
                    moments[id(t)] - BETA1 * inputs.first_moment(k, t.shape, self.seed, t.device, spec)))
                / (1.0 - BETA1) for k, t in leaves.items()}


@torch.no_grad()
def leaf_changes(leaves: dict, start: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.detach() - start[k])) for k, t in leaves.items()}

