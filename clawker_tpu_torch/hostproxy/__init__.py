"""Host-proxy side channel (reference: internal/hostproxy, SURVEY.md 2.10).

The port's copy of ``clawker_tpu/hostproxy``.  This ``__init__`` imports
nothing, so ``python -m clawker_tpu_torch.hostproxy`` loads neither torch
nor the kernels.
"""
