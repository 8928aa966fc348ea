"""``paddle_tpu_torch.distributed``: what the ported paths use of
``paddle_tpu.distributed`` so far: the cross-entropy helper of
``parallel.mp_layers``, the single-process checkpoint
(``distributed.checkpoint``) and ``fleet.CheckpointManager``; meshes,
collectives and ZeRO come with the distributed slice."""
