"""Explicit random-draw sources.

Every function of the port that draws random numbers takes a draw source and
names each draw (``"shade/rot"``, ``"shade/u/step3"``, ``"hashgrid/sel"``,
…).  :class:`TorchDraws` draws from a ``torch.Generator`` (the main path).
:class:`ReplayDraws` hands back arrays that a callback computes for each
name — the parity tests use it to replay the JAX package's ``jax.random``
draws, which torch cannot reproduce, so both sides compute from the same
numbers.  ``child(prefix)`` scopes names, mirroring a key split;
``fork(prefix)`` also gives the scope a stream of its own, so that what it
draws does not depend on what was drawn before it in other scopes (the
banded render's cells, which ranks render in different subsets);
``rows(...)`` draws only some rows of a global draw, the same values
whichever rows a caller takes (a data-parallel rank's share of a batch)."""
from __future__ import annotations

import numpy as np
import torch


class Draws:
    """Interface: named uniform / normal / randint draws."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def _name(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def child(self, prefix: str) -> "Draws":
        raise NotImplementedError

    def fork(self, prefix: str) -> "Draws":
        """``child(prefix)`` with a stream of its own.  Names already select
        a draw independently of the order of draws, so by default it is
        ``child``."""
        return self.child(prefix)

    def rows(self, kind: str, name: str, shape, first: int, count: int, *bounds):
        """Rows [first, first + count) of the ``kind`` ("uniform",
        "normal" or "randint", with its ``bounds``) draw ``name`` of the
        global shape ``shape``, equal whichever rows a caller asks for.  By
        default the whole draw, sliced."""
        return getattr(self, kind)(name, shape, *bounds)[first:first + count]

    def uniform(self, name, shape, lo=0.0, hi=1.0):
        raise NotImplementedError

    def normal(self, name, shape):
        raise NotImplementedError

    def randint(self, name, shape, lo, hi):
        raise NotImplementedError


class TorchDraws(Draws):
    """Draws from one ``torch.Generator`` (on the device the draws land on)."""

    def __init__(self, generator: torch.Generator, prefix: str = ""):
        super().__init__(prefix)
        self.gen = generator
        self.device = generator.device

    def child(self, prefix: str) -> "TorchDraws":
        return TorchDraws(self.gen, self._name(prefix))

    def fork(self, prefix: str) -> "TorchDraws":
        """A new generator on this one's device, seeded by one draw of this
        one: every caller that forks the same scopes in the same order gets
        the same streams, whichever of them it then draws from."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.gen, device=self.device))
        return TorchDraws(torch.Generator(self.device).manual_seed(seed), self._name(prefix))

    def rows(self, kind: str, name: str, shape, first: int, count: int, *bounds):
        """Each row from a stream of its own, ``fork(f"{name}/row{j}")``
        for every row j in order, so that only the rows asked for are drawn
        (a data-parallel rank's share of a global batch)."""
        streams = [self.fork(f"{name}/row{j}") for j in range(shape[0])][first:first + count]
        return torch.cat([getattr(s, kind)(name, (1,) + tuple(shape[1:]), *bounds) for s in streams])

    def uniform(self, name, shape, lo=0.0, hi=1.0):
        u = torch.rand(tuple(shape), generator=self.gen, device=self.device)
        return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u

    def normal(self, name, shape):
        return torch.randn(tuple(shape), generator=self.gen, device=self.device)

    def randint(self, name, shape, lo, hi):
        return torch.randint(int(lo), int(hi), tuple(shape), generator=self.gen,
                             device=self.device)


class ReplayDraws(Draws):
    """Replays arrays: ``source(kind, name, shape, lo, hi)`` returns a numpy
    array for the fully scoped ``name``; kind is uniform/normal/randint."""

    def __init__(self, source, device="cpu", prefix: str = ""):
        super().__init__(prefix)
        self.source = source
        self.device = torch.device(device)

    def child(self, prefix: str) -> "ReplayDraws":
        return ReplayDraws(self.source, self.device, self._name(prefix))

    def _get(self, kind, name, shape, lo, hi, dtype):
        arr = self.source(kind, self._name(name), tuple(shape), lo, hi)
        t = torch.as_tensor(np.array(arr)).to(device=self.device, dtype=dtype)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed {self._name(name)}: shape {tuple(t.shape)} != {tuple(shape)}")
        return t

    def uniform(self, name, shape, lo=0.0, hi=1.0):
        return self._get("uniform", name, shape, lo, hi, torch.float32)

    def normal(self, name, shape):
        return self._get("normal", name, shape, None, None, torch.float32)

    def randint(self, name, shape, lo, hi):
        return self._get("randint", name, shape, lo, hi, torch.int64)
