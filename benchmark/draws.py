"""The random draws a cell hands to the program and to its reference.

:class:`KeyedDraws` answers the program's named draws (``uniform`` /
``normal`` / ``randint`` under ``child`` scopes, the interface of the
port's ``utils/rng.Draws``): each draw is a function of the run's seed and
the draw's full name alone, made on the device by a generator of its own.
So the numbers do not depend on the order in which the program asks for
them, a recomputed forward gets the same numbers again (the port replays a
draw source without a ``gen`` attribute by name), and the reference,
asking by the same names, gets the same numbers as the program."""
from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for ``names`` under the run's ``seed``."""
    h = hashlib.blake2b("/".join([str(int(seed))] + [str(n) for n in names]).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(seed: int, device, *names) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(sub_seed(seed, *names))


class KeyedDraws:
    def __init__(self, seed: int, device, prefix: str = ""):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.prefix = prefix

    def _name(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def _gen(self, name: str) -> torch.Generator:
        return generator(self.seed, self.device, "draw", self._name(name))

    def child(self, prefix: str) -> "KeyedDraws":
        return KeyedDraws(self.seed, self.device, self._name(prefix))

    def fork(self, prefix: str) -> "KeyedDraws":
        return self.child(prefix)

    def rows(self, kind: str, name: str, shape, first: int, count: int, *bounds):
        return getattr(self, kind)(name, shape, *bounds)[first:first + count]

    def uniform(self, name, shape, lo=0.0, hi=1.0):
        u = torch.rand(tuple(shape), generator=self._gen(name), device=self.device)
        return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u

    def normal(self, name, shape):
        return torch.randn(tuple(shape), generator=self._gen(name), device=self.device)

    def randint(self, name, shape, lo, hi):
        return torch.randint(int(lo), int(hi), tuple(shape), generator=self._gen(name), device=self.device)
