"""The scene every head starts from, and the comparison's bookkeeping."""
from __future__ import annotations

import random

import torch

from .. import scene_draw
from ..reference.model import Prior, Scene

LOW = torch.bfloat16   # the control: one precision below the float32 the configurations state


def scene_and_prior(cfg: dict) -> tuple[Scene, Prior]:
    return Scene(**cfg["scene"]), Prior(**cfg["prior"])


def mock_scene(cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(truth (n_stars, 3), image (H, W)), float32 on the host: the JAX
    records' mock scene, drawn by the frozen copy of its threefry draws."""
    sc, pr = scene_and_prior(cfg)
    truth = scene_draw.sample_prior(scene_draw.key(cfg["truth_seed"]), cfg["n_stars"], pr)
    x, y, f = scene_draw.constrain(truth, sc)
    return truth, scene_draw.make_mock_image(scene_draw.key(cfg["data_seed"]), x, y, f, sc)


def capacity(cfg: dict, traffic: dict) -> int:
    k = traffic["kmax"]
    return cfg["n_stars"] if k == "n_stars" else int(k)


class Sample:
    """A seeded uniform sample of ``k`` units of a stream whose length is not
    known in advance (the window's blocks or steps), besides the units in
    ``always``: a reservoir, so the window holds at most k + len(always)
    units whatever its length.  The draws come from ``seed`` alone, so one
    seed over the same units keeps the same ones."""

    def __init__(self, seed: int, k: int, always=(0,)):
        self.rng, self.k, self.always = random.Random(seed), max(0, k), set(always)
        self.fixed: dict = {}
        self.slots: list = []
        self.seen = 0

    def offer(self, i: int, make) -> None:
        """Unit ``i``: keep ``make()`` if the sample takes it (make is called
        only then, so a unit left out costs nothing)."""
        if i in self.always:
            self.fixed[i] = make()
            return
        n, self.seen = self.seen, self.seen + 1
        if n < self.k:
            self.slots.append((i, make()))
            return
        r = self.rng.randrange(n + 1)
        if r < self.k:
            self.slots[r] = (i, make())

    def units(self) -> list:
        """(unit, kept item) of every kept unit, by unit."""
        return sorted(list(self.fixed.items()) + self.slots, key=lambda u: u[0])


def rows_off(theta_prog, mask_prog, theta_ref, mask_ref, delta: float) -> torch.Tensor:
    """Per row: the mask differs, or an alive coordinate lies more than
    delta from the reference's, or is not finite."""
    alive = (mask_ref != 0)[..., None]
    gap = torch.where(alive, (theta_prog.double() - theta_ref.double()).abs(),
                      torch.zeros((), dtype=torch.float64, device=theta_ref.device))
    gap = torch.nan_to_num(gap, nan=float("inf")).amax(dim=(-2, -1))
    return (gap > delta) | (mask_prog.double() != mask_ref.double()).any(-1)


def gap_quantiles(theta_prog, theta_ref) -> list[float]:
    """The 50th, 90th, 99th percentile and largest per-row gap, for the record."""
    g = (theta_prog.double() - theta_ref.double()).abs().amax(dim=(-2, -1))
    g = torch.nan_to_num(g, nan=float("inf")).cpu()
    return [float(torch.quantile(g, q)) for q in (0.5, 0.9, 0.99)] + [float(g.max())]
