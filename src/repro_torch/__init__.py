"""PyTorch / CUDA port of the ``repro`` serving and training stack (GLM-5
reproduction).

The JAX package ``repro`` is the reference; this package mirrors its module
names so every port file has one counterpart there, and imports nothing of
it (nor of JAX).  It covers the paged continuous-batching serving path
(``serving.scheduler.ContinuousEngine`` over ``models.transformer``: GQA,
MLA + MoE, DSA) with the hand-written Hopper kernels for paged decode and
span prefill in ``kernels/paged_attention`` and the serving layers around
it (``serving.frontend``, ``session``, ``spill``, ``migrate``,
``disagg``), and the training path
(``launch.train``: loss, Muon Split, checkpoints, data) with the flash
attention, chunked cross-entropy and lightning-indexer kernels in
``kernels/{flash_attention,chunked_ce,lightning_indexer}`` (CUDA C++ under
``csrc/``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that request it raises (see
``repro_torch.device.resolve_device``).
"""
