"""PyTorch / CUDA port of the ``repro`` serving stack (GLM-5 reproduction).

The JAX package ``repro`` is the reference; this package mirrors its module
names so every port file has one counterpart there, and imports nothing of
it (nor of JAX).  Slice 1 covers the paged continuous-batching serving path
for the dense GQA family: ``serving.scheduler.ContinuousEngine`` over
``models.transformer`` with the hand-written Hopper kernels for paged
decode and span prefill in ``kernels/paged_attention`` (CUDA C++ under
``csrc/``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that request it raises (see
``repro_torch.device.resolve_device``).
"""
