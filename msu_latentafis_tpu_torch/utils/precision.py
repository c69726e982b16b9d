"""f32 on the card: cuDNN's convolutions and cuBLAS's products default to
TF32 on Hopper (``torch.backends.cudnn.allow_tf32`` is True). The port's
nets and image ops run in f32, as the JAX package's do on the CPU."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_compute():
    """cuDNN convolutions and cuBLAS products inside run in f32, not TF32
    (both settings restored after)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
