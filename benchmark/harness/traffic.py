"""The one traffic generator: it reads a traffic mix's data file
(``benchmark/traffic/<name>.json``) and the run's seed.

A mix today is a closed loop of ``clients`` = 1 caller that sends batches of
``batch`` uint8 images back to back. Each batch comes from one camera of
``cameras`` ([H, W] and a whole-number ``share``): the cameras follow each
other in blocks that hold every camera ``share`` times, each block in an
order drawn from the seed, so every seed sends the same mix of sizes. The
images of a camera come from a pool of ``pool_batches`` batches drawn from
the seed on the device before the window and kept in host memory; requests
of a camera cycle through its pool. On a card the pool is in pinned host
memory, as a server holds its decoded frames.

``check`` names the requests whose outputs the run compares with the
reference: for each camera, ``per_camera`` of its first ``among_first``
requests, drawn from the seed, so the largest camera is always among them.
"""

from __future__ import annotations

import random

import torch

from benchmark.harness.weights import subseed

KINDS = ("closed_loop",)


def _host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    return t.cpu().pin_memory() if pinned else t.cpu()


class Plan:
    """The requests of one run, in order: ``request(i)`` gives the camera
    index and the batch of request ``i``, and whether its outputs are
    compared."""

    def __init__(self, traffic: dict, seed: int, device):
        if traffic["kind"] not in KINDS or traffic.get("clients", 1) != 1:
            raise ValueError(f"traffic kind {traffic['kind']!r} with {traffic.get('clients')} clients: "
                             f"the generator runs {KINDS} with one client")
        self.batch = traffic["batch"]
        self.cameras = [tuple(c["hw"]) for c in traffic["cameras"]]
        self.block = [i for i, c in enumerate(traffic["cameras"]) for _ in range(c["share"])]
        self._rng = random.Random(subseed(seed, "order"))
        self._order: list[int] = []
        g = torch.Generator(device=device).manual_seed(subseed(seed, "images"))
        pinned = torch.device(device).type == "cuda"
        self.pool = [
            [_host(torch.randint(0, 256, (self.batch, h, w, 3), dtype=torch.uint8, generator=g, device=device), pinned)
             for _ in range(traffic["pool_batches"])]
            for h, w in self.cameras
        ]
        check = traffic["check"]
        crng = random.Random(subseed(seed, "check"))
        self._checked_ordinals = [set(crng.sample(range(check["among_first"]), check["per_camera"]))
                                  for _ in self.cameras]
        self._seen = [0] * len(self.cameras)
        self._next = 0
        self.checked_total = check["per_camera"] * len(self.cameras)

    def camera(self, i: int) -> int:
        while len(self._order) <= i:
            block = list(self.block)
            self._rng.shuffle(block)
            self._order.extend(block)
        return self._order[i]

    def request(self, i: int):
        """(camera index, uint8 batch on the host, whether it is checked);
        call with i = 0, 1, 2, ... in turn."""
        if i != self._next:
            raise ValueError("requests are drawn in order")
        self._next += 1
        c = self.camera(i)
        n = self._seen[c]
        self._seen[c] += 1
        pool = self.pool[c]
        return c, pool[n % len(pool)], n in self._checked_ordinals[c]
