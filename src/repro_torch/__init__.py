"""PyTorch/CUDA port of the AIDW interpolation system.

A second package beside ``repro`` (the JAX/Pallas reference): the same
module layout, plain PyTorch for the glue, and hand-written CUDA kernels for
the hot loops.  It imports neither ``jax`` nor anything of ``repro``.

Entry points: :func:`repro_torch.engine.build_plan`,
:func:`repro_torch.engine.execute`, :func:`repro_torch.engine.execute_with_stats`
and :func:`repro_torch.kernels.aidw`.  Plans live on ``"cuda"`` unless the
caller passes ``device="cpu"``, where every kernel runs its plain version.
"""
