"""paddle_tpu_torch — the PyTorch/CUDA counterpart of ``paddle_tpu``.

Module for module, this package mirrors ``paddle_tpu`` (same names, same
parameter names, same public tensor layouts) so each piece can be held
against its JAX original on identical weights.  Plain tensor code is
PyTorch; every Pallas kernel on a ported path becomes a CUDA kernel written
for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Covered so far: the serving path — ``serving.Engine`` over
``models.llama.LlamaForCausalLM`` with the paged KV cache, and
``LlamaForCausalLM.generate`` — and the pretraining path: ``jit.TrainStep``
over ``compute_loss`` with ``optimizer.AdamW`` and the presets of
``models.presets``; the SSD family, ``models.ssd.SSDForCausalLM``, in
training and through the Engine's recurrent and hybrid paths; the
Mixture-of-Experts Llama (``incubate.moe``, the ``moe`` preset) in training
and serving; and the rest of ``incubate`` (fused ops and layers, optimizer
wrappers).

Device policy: entry points take an explicit ``device``; when none is given
it is ``"cuda"``, and a missing card raises instead of running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["seed", "default_device", "default_generator", "make_generator", "to_dtype", "DTYPES"]

DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int64": torch.int64,
}


def to_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``paddle_tpu`` dtype string (``"bfloat16"``) -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(DTYPES)}")


def default_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means ``"cuda"``.  A CUDA device without a usable card raises:
    nothing falls back to the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: CUDA is not available; pass device='cpu' "
            "explicitly to run the plain PyTorch path on the CPU")
    return dev


def make_generator(seed_value: int, device: Union[str, torch.device]) -> torch.Generator:
    """An explicit ``torch.Generator`` on ``device`` seeded with ``seed_value``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed_value))
    return g


_DEFAULT_GENERATORS: dict = {}


def default_generator(device: Union[str, torch.device]) -> torch.Generator:
    """The one generator of ``device`` that draws advance (the counterpart of
    the JAX package's framework key): a layer built without ``generator=``
    draws its parameters and dropout masks from it, so two such layers draw
    different numbers.  Seeded with 0 when first made; :func:`seed` resets
    it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = _DEFAULT_GENERATORS.get(dev)
    if g is None:
        g = _DEFAULT_GENERATORS[dev] = make_generator(0, dev)
    return g


def seed(s: int) -> None:
    """Seed torch's global generators and every :func:`default_generator`
    (the ``paddle.seed`` counterpart).

    Models and recipes draw from the generator they are given (or one made
    from their ``seed``); the defaults serve layers built without one."""
    torch.manual_seed(int(s))
    for g in _DEFAULT_GENERATORS.values():
        g.manual_seed(int(s))
