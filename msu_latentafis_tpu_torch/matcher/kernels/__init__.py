"""The dense matcher's CUDA kernels (``csrc/``), their build and wrappers."""
