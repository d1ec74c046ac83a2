"""CUDA kernels (csrc/*.cu) built with nvcc and bound with ctypes
(build.py), and their wrappers (megakernel.py)."""
