"""Hand-written CUDA kernels (``csrc/*.cu``) and their PyTorch wrappers.

Each module holds one kernel's wrapper, its plain PyTorch version and its
launch counter. The wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""
