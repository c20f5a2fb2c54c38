"""Hand-written CUDA kernels of the anomaly lane, their plain PyTorch
versions, and the nvcc build that makes them at first use.

``anomaly`` holds the wrappers (K1 score, K2 fit step, K3 fit, K5 the fit
step over rows split into shards) with their launch counters, ``reference`` the plain versions, ``build`` the compiler
driver, ``csrc/`` the CUDA C++ sources for ``sm_90a``.
"""
