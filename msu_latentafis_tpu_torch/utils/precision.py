"""f32 on the card: cuDNN's convolutions and cuBLAS's products default to
TF32 on Hopper (``torch.backends.cudnn.allow_tf32`` is True). The port's
nets and image ops run in f32, as the JAX package's do on the CPU;
``f32_compute(allow_tf32=True)`` is the opt-in to TF32 (training with a
lower matmul precision, as the JAX package allows)."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_compute(allow_tf32: bool = False):
    """cuDNN convolutions and cuBLAS products inside run in f32, or may run
    in TF32 where ``allow_tf32`` (both settings restored after)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
