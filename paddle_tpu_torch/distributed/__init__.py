"""``paddle_tpu_torch.distributed``: what the ported paths use of
``paddle_tpu.distributed`` so far: the cross-entropy helper of
``parallel.mp_layers``, the single-process checkpoint
(``distributed.checkpoint``), ``fleet.CheckpointManager`` and
``fleet.ElasticManager``, and the host control plane: the ``TCPStore``
(``store``) and its replicated form (``store_replicated``), fault tolerance
(``fault_tolerance``), the collective watchdog (``watchdog``) and the
launcher with elastic restart (``python -m
paddle_tpu_torch.distributed.launch``).  Meshes, collectives and ZeRO come
with the distributed slice."""

from .store import TCPStore  # noqa: F401
from .store_replicated import ReplicatedStore  # noqa: F401
