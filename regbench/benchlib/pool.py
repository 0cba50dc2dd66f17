"""The traffic's inputs: a pool of distinct raw pairs made from the seed
by the frozen scene generator, padded to the configuration's raw
capacity and stacked into the batches the client sends, in pinned host
memory where the run uses a card (the raw clouds a user hands to the
copy)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import scene


class Batch(NamedTuple):
    """B pairs' raw clouds, the B sources then the B targets."""

    points: torch.Tensor  # (2B, N, 3) float32
    mask: torch.Tensor    # (2B, N) bool

    @property
    def pairs(self) -> int:
        return self.points.shape[0] // 2

    def pair(self, r):
        """Pair ``r`` as (src, src_mask, tar, tar_mask), each with a
        leading axis of 1."""
        B = self.pairs
        return (self.points[r:r + 1], self.mask[r:r + 1],
                self.points[B + r:B + r + 1], self.mask[B + r:B + r + 1])


class Pool(NamedTuple):
    batches: list           # [Batch], the pool's pairs in order
    gts: np.ndarray         # (pairs, 4, 4) float32: T_gt, source -> target
    seeds: list             # each pair's scene seed
    points: list            # each pair's raw (source, target) point counts


def raw_capacity(caps: dict) -> int:
    return caps["max_raw_points"] or caps["max_points"]


def pair_seeds(seed: int, n: int) -> list:
    """``n`` scene seeds drawn from the run's seed (any whole number)."""
    state = np.random.SeedSequence(seed % 2**64).generate_state(n, np.uint32)
    return [int(s) for s in state]


def make_pool(config: dict, traffic: dict, seed: int, pin: bool) -> Pool:
    """The pool of ``traffic["pool_pairs"]`` pairs in batches of
    ``traffic["batch"]``."""
    n, B = traffic["pool_pairs"], traffic["batch"]
    if n % B:
        raise ValueError(f"pool_pairs {n} is no multiple of batch {B}")
    N = raw_capacity(config["caps"])
    seeds = pair_seeds(seed, n)
    clouds, gts, points = [], [], []
    for s in seeds:
        src, tar, T_gt = scene.make_pair(seed=s, **config["scene"],
                                         **config["pair"])
        clouds.append((scene.pad_points(src, N), scene.pad_points(tar, N)))
        gts.append(T_gt)
        points.append((int(src.shape[0]), int(tar.shape[0])))
    batches = []
    for b in range(0, n, B):
        rows = clouds[b:b + B]
        parts = [torch.from_numpy(np.stack([r[side][k] for side in (0, 1)
                                            for r in rows]))
                 for k in (0, 1)]
        if pin:
            parts = [p.pin_memory() for p in parts]
        batches.append(Batch(*parts))
    return Pool(batches, np.stack(gts), seeds, points)
