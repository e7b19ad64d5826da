"""PyTorch/CUDA port of `dart_tpu`, slice by slice, held to the JAX package.

The subpackages mirror `dart_tpu`'s (`models`, `adapt`, `solver`, `ops`,
`control`, `physics`, `rollout`, `io`, `parallel`, `cli`, `utils`), so
each module sits where its JAX counterpart does. This package imports `torch` and never `jax`. The hot
kernels on the ported paths (the whole PMPC box-DDP solve, the whole RMPC
augmented-Lagrangian solve and the batched Riccati backward pass) are
hand-written CUDA C++ in `csrc/`, built with `nvcc` at first use
(`ops/kernels/_build.py`).
"""
