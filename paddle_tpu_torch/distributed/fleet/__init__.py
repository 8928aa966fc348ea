"""``paddle_tpu_torch.distributed.fleet``: what the port has of
``paddle_tpu.distributed.fleet`` so far, the single-process
:class:`CheckpointManager`."""

from .elastic import CheckpointManager  # noqa: F401

__all__ = ["CheckpointManager"]
