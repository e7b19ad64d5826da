"""PyTorch/CUDA port of `dart_tpu`, slice by slice, held to the JAX package.

The subpackages mirror `dart_tpu`'s (`models`, `solver`, `ops`, `control`,
`rollout`, `utils`), so each module sits where its JAX counterpart does.
This package imports `torch` and never `jax`. The one hot kernel on the
ported path, the whole PMPC box-DDP solve, is hand-written CUDA C++ in
`csrc/pmpc_solve.cu`, built with `nvcc` at first use
(`ops/kernels/_build.py`).
"""
