"""PyTorch/CUDA port of the TPU latent-fingerprint engine for NVIDIA Hopper.

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package: it keeps its own copies of the template codec and packing. Its
entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the three exact-score kernels of the dense matcher are CUDA C++ for
``sm_90a`` (``matcher/kernels/csrc``), each with a plain PyTorch version
that the CPU path runs.
"""
__version__ = "0.1.0"
