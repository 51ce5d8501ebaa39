"""The benchmark's draws: every random number a run hands the program or a
reference comes from a ``torch.Generator`` seeded here from ``--seed``."""

from __future__ import annotations

import torch

_MUL = 6364136223846793005
_ADD = 1442695040888963407


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for the stream ``parts`` of run seed ``seed`` (any
    whole number)."""
    h = int(seed) % 2 ** 63
    for p in parts:
        h = (h * _MUL + int(p) + _ADD) % 2 ** 63
    return h


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g


class MergeDraws:
    """The enhanced merge loop's draws (the sampler it is handed), kept in
    order with the vocabulary size at each call: ``("coherence", V,
    samples)`` at every corpus sync, ``("curvature", V, (negatives, ii,
    jj))`` at every curvature step. The log is what a reference needs to
    follow the training."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = generator(seed, self.device)
        self.log = []

    def _randint(self, shape, high: int) -> torch.Tensor:
        return torch.randint(0, int(high), shape, generator=self.generator,
                             device=self.device, dtype=torch.int32)

    def coherence(self, n: int, high: int) -> torch.Tensor:
        x = self._randint((n,), high)
        self.log.append(("coherence", int(high), x))
        return x

    def curvature(self, hp: int, hn: int, ds: int, high: int):
        out = (self._randint((hp, hn), high), self._randint((ds,), high),
               self._randint((ds,), high))
        self.log.append(("curvature", int(high), out))
        return out


class EmbedDraws:
    """The embedding trainer's draws: ``randint(shape, high)`` (int64 ids in
    ``[0, high)``) and ``uniform(shape)``, from one generator."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = generator(seed, self.device)

    def randint(self, shape, high: int) -> torch.Tensor:
        return torch.randint(0, int(high), tuple(shape),
                             generator=self.generator, device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)
