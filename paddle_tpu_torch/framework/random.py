"""Generators (the counterpart of ``paddle_tpu/framework/random.py``).

The JAX package splits a framework key per random op; the port keeps one
explicit ``torch.Generator`` per device that advances with every draw
(:func:`default_generator`), and never draws from torch's global RNG.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["make_generator", "default_generator", "seed", "initial_seed"]


def make_generator(seed_value: int, device: Union[str, torch.device]) -> torch.Generator:
    """An explicit ``torch.Generator`` on ``device`` seeded with ``seed_value``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed_value))
    return g


_DEFAULT_GENERATORS: dict = {}
_SEED = 0


def default_generator(device: Union[str, torch.device]) -> torch.Generator:
    """The one generator of ``device`` that draws advance (the counterpart of
    the JAX package's framework key): a layer built without ``generator=``
    draws its parameters and dropout masks from it, and the random ops of
    the op namespace draw from it.  Made seeded with the last :func:`seed`
    value (0 before any); :func:`seed` resets it."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.Generator()     # a recording's shape inference draws nothing
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = _DEFAULT_GENERATORS.get(dev)
    if g is None:
        g = _DEFAULT_GENERATORS[dev] = make_generator(_SEED, dev)
    return g


def seed(s: int) -> None:
    """Seed torch's global generators and every :func:`default_generator`
    (the ``paddle.seed`` counterpart).

    Models and recipes draw from the generator they are given (or one made
    from their ``seed``); the defaults serve layers built without one and
    the op namespace's random ops."""
    global _SEED
    _SEED = int(s)
    torch.manual_seed(_SEED)
    for g in _DEFAULT_GENERATORS.values():
        g.manual_seed(_SEED)


def initial_seed() -> int:
    """The value of the last :func:`seed` (0 before any): what the io
    samplers seed numpy with, as the JAX package's."""
    return _SEED

