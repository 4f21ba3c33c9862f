"""HierTrain in PyTorch and CUDA: the port of the ``repro`` package.

Module paths mirror ``src/repro/``, which stays the reference the port
is held against.  The front door is :mod:`repro_torch.api`
(``Fleet`` → ``plan`` → ``Plan.step_fn``).  The package imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.
"""
