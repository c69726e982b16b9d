"""Train states and (sharded) train steps.

Counterpart of the JAX package's ``training/trainer.py``. Optimizer as the
reference trainers': Adam(lr 1e-4, betas (0.5, 0.9), eps 1e-8)
(minutiae_AEC.py:276-279, enhancement_AEC.py:314-317), on every parameter
(BatchNorm scales and biases too, as optax does). A step runs the net in
train mode, so its Flax BatchNorms (``models.batchnorm``) normalize with
the batch's statistics and update the running ones as Flax does; the net
is back in eval mode after it. Steps run in f32 with TF32 off
(``utils.precision.f32_compute``, the JAX package's "highest" matmul
precision); ``PRETRAIN_PRECISION`` naming a lower precision of JAX's
allows TF32, and a name JAX does not know raises.

Sharded training uses a 2-D (data, model) ``DeviceMesh``: the global batch
splits over ``data``; each parameter that ``param_spec`` shards (ndim >= 2,
its Flax last axis divisible by n_model and >= 8 n_model) is held as one
slice per rank of ``model``, with its Adam moments, and gathered for the
forward. The step keeps the unsharded step's semantics, as GSPMD keeps the
JAX package's: BatchNorm statistics over the global batch, the loss over
the global batch (``l2`` is a sum, so gradients add over ``data``; the
batch-hard triplet mines over the gathered embeddings of every shard).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.func import functional_call

from ..models.batchnorm import set_stats_group
from ..models.weights import to_flax
from ..utils.precision import f32_compute
from . import losses

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class TrainState:
    """A net, its Adam and the number of steps taken."""
    model: nn.Module
    tx: torch.optim.Optimizer
    step: int = 0

    def variables(self) -> dict:
        """The Flax variable tree (numpy) of the net's parameters and
        running statistics."""
        return to_flax(self.model)


def create_train_state(model: nn.Module, learning_rate: float = 1e-4,
                       b1: float = 0.5, b2: float = 0.9) -> TrainState:
    """Adam over every parameter of ``model`` (already initialized, on its
    device)."""
    tx = torch.optim.Adam(model.parameters(), lr=learning_rate,
                          betas=(b1, b2), eps=1e-8)
    return TrainState(model=model, tx=tx)


# jax_default_matmul_precision's names: products in at least f32, or lower
F32_PRECISIONS = ("highest", "float32", "F32_F32_F32", "F64_F64_F64")
LOWER_PRECISIONS = (
    "default", "high", "bfloat16", "tensorfloat32", "ANY_F8_ANY_F8_F32",
    "ANY_F8_ANY_F8_F32_FAST_ACCUM", "ANY_F8_ANY_F8_ANY",
    "ANY_F8_ANY_F8_ANY_FAST_ACCUM", "F16_F16_F16", "F16_F16_F32",
    "BF16_BF16_BF16", "BF16_BF16_F32", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6",
    "BF16_BF16_F32_X9", "TF32_TF32_F32", "TF32_TF32_F32_X3")


def step_precision():
    """f32 with TF32 off where PRETRAIN_PRECISION names full f32 (the
    default "highest"); TF32 allowed where it names a lower precision."""
    name = os.environ.get("PRETRAIN_PRECISION", "highest")
    if name not in F32_PRECISIONS + LOWER_PRECISIONS:
        raise ValueError(f"PRETRAIN_PRECISION={name!r}: not one of "
                         f"{F32_PRECISIONS + LOWER_PRECISIONS}")
    return f32_compute(allow_tf32=name in LOWER_PRECISIONS)


@contextlib.contextmanager
def training(model: nn.Module):
    """``model`` in train mode inside, eval mode after."""
    model.train()
    try:
        yield
    finally:
        model.eval()


def standard_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` with row-major strides. An NHWC array permuted to NCHW with one
    channel counts as contiguous in torch but keeps channels-last strides,
    which send the convolutions down their channels-last kernels; on the
    CPU (torch 2.13) a train-mode step of the descriptor net on such an
    input corrupts the heap."""
    want, acc = [], 1
    for n in reversed(x.shape):
        want.insert(0, acc)
        acc *= n
    if list(x.stride()) == want:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def train_step(state: TrainState, loss_of: Callable, x: torch.Tensor):
    """One step: ``loss_of(model(x))``, its gradient, Adam. -> (state,
    the loss, detached)."""
    with training(state.model), step_precision():
        loss = loss_of(state.model(standard_layout(x)))
        state.tx.zero_grad(set_to_none=True)
        loss.backward()
        state.tx.step()
    state.step += 1
    return state, loss.detach()


def normalized(emb: torch.Tensor) -> torch.Tensor:
    return emb / (torch.linalg.norm(emb, dim=1, keepdim=True) + 1e-8)


def l2_train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
    """One AEC step: the L2 loss between prediction and target (NCHW)."""
    return train_step(state, lambda out: losses.l2_reconstruction(out, y), x)


def triplet_train_step(state: TrainState, x: torch.Tensor,
                       labels: torch.Tensor, margin: float = 0.3):
    """One descriptor step: batch-hard triplet on L2-normalized
    embeddings."""
    return train_step(state, lambda emb: losses.batch_hard_triplet(
        normalized(emb), labels, margin), x)


# ---------------------------------------------------------------------------
# Sharded training
# ---------------------------------------------------------------------------

def make_train_mesh(n_data: Optional[int] = None, n_model: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the initialized process group; every
    process on the data axis by default."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"{n_data} x {n_model} != {world} processes")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def param_spec(flax_shape, n_model: int) -> bool:
    """The tensor-parallel rule on a Flax leaf's shape: shard its last
    (output-channel) axis when it is divisible by n_model and at least
    8 n_model long; biases and scales stay replicated."""
    return (len(flax_shape) >= 2 and flax_shape[-1] % n_model == 0
            and flax_shape[-1] >= 8 * n_model)


def shard_dims(model: nn.Module, n_model: int) -> Dict[str, Optional[int]]:
    """Parameter name -> the torch dim that holds its Flax last axis where
    ``param_spec`` shards it, else None. That axis is dim 0 of a
    ``Conv2d`` or ``Linear`` weight and dim 1 of a ``ConvTranspose2d``'s
    ([in, out, kh, kw])."""
    dims = {}
    for name, mod in model.named_modules():
        for attr, p in mod.named_parameters(recurse=False):
            dim = None
            if attr == "weight" and p.dim() >= 2:
                dim = 1 if isinstance(mod, nn.ConvTranspose2d) else 0
            flax_last = p.shape[dim] if dim is not None else p.shape[-1]
            shape = (0,) * (p.dim() - 1) + (flax_last,)
            dims[f"{name}.{attr}" if name else attr] = \
                dim if dim is not None and param_spec(shape, n_model) \
                else None
    return dims


class _GatherSum(torch.autograd.Function):
    """Concatenation of every rank's ``t`` along ``dim`` over ``group``; the
    gradient of a rank's slice is the sum of every rank's gradient of
    it."""

    @staticmethod
    def forward(ctx, t, dim, group):
        n = dist.get_world_size(group)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        ctx.dim, ctx.group, ctx.n = dim, group, n
        ctx.rank = dist.get_rank(group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None


def gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherSum.apply(t, dim, group)


def _set_param(model: nn.Module, name: str, p: nn.Parameter) -> None:
    mod = model
    *path, attr = name.split(".")
    for part in path:
        mod = getattr(mod, part)
    setattr(mod, attr, p)


@dataclasses.dataclass
class ShardedTrainState:
    """A net whose sharded parameters hold this rank's slice (``dims``
    names their sharded dim), its Adam over them, and the mesh."""
    model: nn.Module
    tx: torch.optim.Optimizer
    mesh: DeviceMesh
    dims: Dict[str, Optional[int]]
    step: int = 0

    def full_parameters(self, grads: bool = False) -> dict:
        """Parameter name -> the whole tensor, or with ``grads`` the whole
        gradient of the last step (sharded ones gathered)."""
        group = self.mesh.get_group(MODEL_AXIS)
        with torch.no_grad():
            return {n: gather(t, self.dims[n], group)
                    if self.dims[n] is not None else t
                    for n, p in self.model.named_parameters()
                    for t in [p.grad if grads else p]}

    def variables(self) -> dict:
        """The Flax variable tree of the whole net (every rank)."""
        net = copy.deepcopy(self.model)
        for n, t in self.full_parameters().items():
            _set_param(net, n, nn.Parameter(t.detach().clone()))
        return to_flax(net)


def make_sharded_train_step(model: nn.Module, mesh: DeviceMesh,
                            step_kind: str = "l2",
                            learning_rate: float = 1e-4):
    """(state, step) over a (data, model) mesh for ``model`` as it stands
    (the same on every rank). ``state, loss = step(state, x, y)`` takes the
    GLOBAL batch on every rank (NCHW; y the targets, or the labels for
    ``"triplet"``) and returns the global loss."""
    from ..parallel.distributed import check_backend
    device = next(model.parameters()).device
    data_group = mesh.get_group(DATA_AXIS)
    model_group = mesh.get_group(MODEL_AXIS)
    check_backend(data_group, device)
    n_data, n_model = mesh[DATA_AXIS].size(), mesh[MODEL_AXIS].size()
    d = mesh.get_local_rank(DATA_AXIS)
    m = mesh.get_local_rank(MODEL_AXIS)
    dims = shard_dims(model, n_model)
    for name, p in list(model.named_parameters()):
        if dims[name] is not None:
            local = p.detach().chunk(n_model, dims[name])[m].clone()
            _set_param(model, name, nn.Parameter(local))
    tx = torch.optim.Adam(model.parameters(), lr=learning_rate,
                          betas=(0.5, 0.9), eps=1e-8)
    state = ShardedTrainState(model=model, tx=tx, mesh=mesh, dims=dims)
    if step_kind not in ("l2", "triplet"):
        raise ValueError(f"unknown step kind {step_kind!r}")

    def step(state: ShardedTrainState, x: torch.Tensor, y: torch.Tensor):
        net = state.model
        xs = standard_layout(x.chunk(n_data)[d])
        set_stats_group(net, data_group)
        try:
            with training(net), step_precision():
                full = {n: gather(p, dims[n], model_group)
                        for n, p in net.named_parameters()
                        if dims[n] is not None}
                out = functional_call(net, full, (xs,))
                if step_kind == "l2":
                    local = losses.l2_reconstruction(out, y.chunk(n_data)[d])
                    total = local.detach().clone()
                    dist.all_reduce(total, group=data_group)
                else:
                    emb = gather(normalized(out), 0, data_group)
                    total = losses.batch_hard_triplet(emb, y)
                    # every data rank holds the same global loss, and the
                    # gather adds their gradients: each backs 1 / n_data
                    local, total = total / n_data, total.detach()
                state.tx.zero_grad(set_to_none=True)
                local.backward()
                for n, p in net.named_parameters():
                    if p.grad is None:
                        continue
                    dist.all_reduce(p.grad, group=data_group)
                    if dims[n] is not None:
                        # the model ranks ran the same forward on the same
                        # shard: the gather added n_model equal gradients
                        p.grad.div_(n_model)
                state.tx.step()
        finally:
            set_stats_group(net, None)
        state.step += 1
        return state, total

    return state, step
