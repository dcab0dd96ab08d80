"""A G-Shell-on-FlexiCubes cell: the port's ``Reconstructor.train_step`` over
``GShellFlexiGeometry`` in a closed loop, as ``train_gshell --flexicubes``
trains.

The reconstruction cell (:mod:`.reconstruction`) with FlexiCubes' inputs
(``inputs/flexi``: the voxel lattice, ``cube_weights``) and reference
(``reference/flexi``).  Built through ``train/setup.reconstructor_from_flags``
from the configuration file, whose ``use_flexicubes`` selects the geometry.
Each step's surface cubes, quad edges, faces and the three overflow flags
are kept as the step returns them and read after the window (a count the
program does not return is left out)."""
from __future__ import annotations

import torch

from ..draws import KeyedDraws
from ..inputs import flexi as flexi_inputs
from ..inputs import reconstruction as inputs
from ..reference.flexi import trainer as ref_trainer
from . import reconstruction
from .reconstruction import FAULTS, first_moments, leaf_changes, named_leaves

COUNTS = ("n_surf_cubes", "n_quad_edges", "n_faces", "cube_slot_overflow", "edge_slot_overflow",
          "face_cap_overflow")


class Cell(reconstruction.Cell):

    def __init__(self, config_path: str, traffic: dict, seed: int, device, fault: str | None = None):
        from gshell_tpu_torch.train.setup import reconstructor_from_flags
        from gshell_tpu_torch.utils.config import load_flags

        if fault not in (None,) + FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.config_path, self.traffic, self.seed, self.fault = config_path, traffic, int(seed), fault
        self.device = torch.device(device)
        self.flags = load_flags(config_path)
        if not self.flags.use_flexicubes:
            raise ValueError(f"{config_path}: a FlexiCubes cell needs use_flexicubes")
        self.rec = reconstructor_from_flags(self.flags, self.device)
        geo, mat, light = flexi_inputs.make_params(self.flags, self.seed, self.device, traffic["shape_fit_steps"],
                                                   traffic["shape_fit_points"])
        self.initial = {"geo": geo, "mat": mat, "light": light}
        self.state = self.rec.make_state(geo, mat, light, step=traffic["state_step"])
        inputs.warm_adam(self.state.optimizers, self.leaves(), self.seed, traffic["adam_moments"])
        self.targets = inputs.render_targets(self.flags, self.seed, self.device, traffic["n_views"],
                                             traffic["cam_radius"], traffic["fovy_deg"])
        self.batch_size = self.flags.batch
        self.units_per_step = 1
        self.faces = []
        self.counts = []  # each step's COUNTS (0-d tensors, read after the window)

    def notes(self) -> str:
        """Each step's counts against their capacities, read now."""
        ext, cap = self.rec.geo.extractor, self.rec.geo.face_cap
        rows = {k: [int(c[k]) for c in self.counts] for k in COUNTS if all(c[k] is not None for c in self.counts)}
        return (f"a step (max_cubes {ext.max_cubes}, max_edges {ext.max_edges}, face cap {cap}): "
                + "; ".join(f"{k} {v}" for k, v in rows.items()))

    def step(self, k: int):
        """Train step ``k`` → its total loss (a 0-d tensor, not waited for)."""
        if self.fault == "unchanged":
            before = [t.detach().clone() for t in self.leaves().values()]
        m = self.rec.train_step(self.state, KeyedDraws(self.seed, self.device, f"step{k}"), self.batch(k))
        self.faces.append(m["n_faces"])
        self.counts.append({c: m.get(c) for c in COUNTS})  # a program may not count them all
        if self.fault == "unchanged":
            with torch.no_grad():
                for t, b in zip(self.leaves().values(), before):
                    t.copy_(b)
        return m["total"]

    def reference(self, n: int, lower: bool = False) -> dict:
        """The plain reference's record of the same ``n`` steps; ``lower``:
        its products in TF32, the control.  Also the MLP evaluations of its
        first step (``evaluations``)."""
        ref = ref_trainer.ReferenceFlexiReconstructor(self.config_path, self.device, tf32=lower)
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
