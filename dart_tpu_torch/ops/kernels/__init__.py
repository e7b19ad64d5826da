"""Hand-written CUDA kernels, each with its plain PyTorch version.

A wrapper takes its plain version only for tensors that lie on the CPU; on a
CUDA tensor it launches its kernel or raises.
"""
