"""``paddle_tpu_torch.distributed.fleet``: what the port has of
``paddle_tpu.distributed.fleet`` so far: the elastic half
(:class:`CheckpointManager`, :class:`ElasticManager`)."""

from .elastic import ELASTIC_EXIT_CODE, CheckpointManager, ElasticManager  # noqa: F401

__all__ = ["CheckpointManager", "ElasticManager", "ELASTIC_EXIT_CODE"]
