"""Descriptor dimensionality-reduction MLP (192 -> 96).

Counterpart of the JAX package's ``models/compnet.py`` (after the
reference implementation's extraction/models/net_compress.py:7-54):
Linear + BatchNorm + LeakyReLU 0.2 input layer, one residual BasicBlock,
Linear + BatchNorm output. The DR stage renormalizes each output row to
||.|| = 1.73 (descriptor_DR.py:150-153): ``compress_descriptors``. The
models run in eval mode, on the running statistics.

``compnet_from_flax`` carries the JAX package's Flax variables over
(``models.weights``): a ``Dense`` kernel is [in, out], so it is transposed
into ``Linear.weight``; ``BatchNorm`` scale / bias / mean / var become
weight / bias / running_mean / running_var, with Flax's eps 1e-5.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pq import f32_matmul
from .batchnorm import FlaxBatchNorm1d
from .weights import load_flax

DES_NORM = 1.73
COMPRESS_ROWS = 1 << 20  # rows per forward pass of compress_rows


class BasicBlock(nn.Module):
    def __init__(self, dims: int):
        super().__init__()
        self.fc1 = nn.Linear(dims, dims)
        self.bn1 = FlaxBatchNorm1d(dims)
        self.fc2 = nn.Linear(dims, dims)
        self.bn2 = FlaxBatchNorm1d(dims)

    def forward(self, x):
        y = F.leaky_relu(self.bn1(self.fc1(x)), 0.2)
        y = self.bn2(self.fc2(y))
        return F.leaky_relu(y + x, 0.2)

    def flax_modules(self, prefix: str) -> dict:
        return {f"{prefix}/Dense_0": self.fc1, f"{prefix}/BatchNorm_0": self.bn1,
                f"{prefix}/Dense_1": self.fc2, f"{prefix}/BatchNorm_1": self.bn2}


class CompNet(nn.Module):
    def __init__(self, in_dims: int = 192, out_dims: int = 96):
        super().__init__()
        self.fc_in = nn.Linear(in_dims, out_dims)
        self.bn_in = FlaxBatchNorm1d(out_dims)
        self.block = BasicBlock(out_dims)
        self.fc_out = nn.Linear(out_dims, out_dims)
        self.bn_out = FlaxBatchNorm1d(out_dims)

    def forward(self, x):
        x = F.leaky_relu(self.bn_in(self.fc_in(x)), 0.2)
        x = self.block(x)
        return self.bn_out(self.fc_out(x))

    def flax_modules(self) -> dict:
        return {"Dense_0": self.fc_in, "BatchNorm_0": self.bn_in,
                **self.block.flax_modules("BasicBlock_0"),
                "Dense_1": self.fc_out, "BatchNorm_1": self.bn_out}


def compnet_from_flax(variables: Mapping) -> CompNet:
    """A CompNet in eval mode holding the JAX package's Flax variables
    ``{"params": ..., "batch_stats": ...}`` (leaves as arrays). Raises on a
    variable that no submodule takes or a submodule left without one."""
    kernel = np.shape(variables["params"]["Dense_0"]["kernel"])
    return load_flax(CompNet(in_dims=kernel[0], out_dims=kernel[1]),
                     variables)


def compress_rows(model: CompNet, x: torch.Tensor) -> torch.Tensor:
    """DR f32 rows [N, in] on the model's device -> [N, out], each row
    renormalized to DES_NORM; COMPRESS_ROWS at a time, in f32."""
    out = torch.empty((x.shape[0], model.fc_out.out_features),
                      dtype=torch.float32, device=x.device)
    R = COMPRESS_ROWS
    with torch.inference_mode(), f32_matmul():
        for a in range(0, x.shape[0], R):
            y = model(x[a:a + R])
            out[a:a + R] = y / y.norm(dim=1, keepdim=True) * DES_NORM
    return out


def compress_descriptors(model: CompNet, des: np.ndarray) -> np.ndarray:
    """DR a [N, 192] descriptor matrix -> [N, 96] on the model's device,
    renormalized to 1.73 (descriptor_DR.extract_features + the renorm at
    :150-153); [0, 96] for no rows. Rows are independent, so there is no
    padding to the JAX package's batch of 128."""
    if len(des) == 0:
        return np.zeros((0, model.fc_out.out_features), np.float32)
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(des, np.float32), device=device)
    return compress_rows(model, x).cpu().numpy()
