"""The port's model zoo against the JAX package's Flax zoo on the CPU: each
net built from the Flax net's own ``init`` variables (``*_from_flax``: its
module paths and shapes, leaf for leaf), then from seeded variables with
non-trivial batch statistics, its eval-mode forward against Flax's on the
same input; the "SAME" max pool and the hourglass's nearest upsample at
odd sizes against their JAX counterparts.

Tolerance: 2 K u max|out| (u = 2^-24), K the forward's dot lengths
(in * kh * kw of every layer, the bilinear pool's pixels) added up: each
layer's first-order error in f32, relative to the output's scale. Dropout
nets compare in eval mode (their train-mode masks are each package's
own)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu.models import zoo as jz
from msu_latentafis_tpu_torch.models import weights
from msu_latentafis_tpu_torch.models import zoo as tz
from msu_latentafis_tpu_torch.utils.synthetic import random_flax_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


U = 2.0 ** -24

# name: (Flax net, port *_from_flax, its config, input NHWC)
CASES = {
    "ResNet": (jz.ResNet(stage_sizes=(1, 2), width=8, num_outputs=16),
               tz.resnet_from_flax,
               dict(stage_sizes=(1, 2), width=8, num_outputs=16),
               (2, 30, 33, 1)),
    "PreActResNet": (jz.PreActResNet(stage_sizes=(2, 1), width=8,
                                     num_outputs=16),
                     tz.preact_resnet_from_flax,
                     dict(stage_sizes=(2, 1), width=8, num_outputs=16),
                     (2, 32, 31, 2)),
    "SphereFaceNet": (jz.SphereFaceNet(widths=(8, 16), embedding_size=32),
                      tz.sphereface_from_flax,
                      dict(widths=(8, 16), embedding_size=32,
                           input_hw=(33, 30)), (2, 33, 30, 1)),
    "InceptionResnetV1": (jz.InceptionResnetV1(embedding_size=32, n35=1,
                                               n17=1, n8=1),
                          tz.inception_resnet_v1_from_flax,
                          dict(embedding_size=32, n35=1, n17=1, n8=1),
                          (1, 75, 75, 1)),
    "Hourglass": (jz.Hourglass(depth=2, features=8),
                  tz.hourglass_from_flax, dict(depth=2, features=8),
                  (2, 16, 20, 3)),
    "StackedHourglass": (jz.StackedHourglass(n_stacks=2, features=8,
                                             num_outputs=12),
                         tz.stacked_hourglass_from_flax,
                         dict(n_stacks=2, features=8, num_outputs=12),
                         (2, 32, 32, 1)),
    "StackedHourglass1": (jz.StackedHourglass(n_stacks=1, features=8,
                                              num_outputs=5),
                          tz.stacked_hourglass_from_flax,
                          dict(n_stacks=1, features=8, num_outputs=5),
                          (1, 24, 16, 1)),
    "BCNN": (jz.BCNN(widths=(4, 8), num_outputs=16), tz.bcnn_from_flax,
             dict(widths=(4, 8), num_outputs=16), (2, 32, 30, 1)),
    "DropoutMLP": (jz.DropoutMLP(hidden=(32, 24), num_outputs=16),
                   tz.dropout_mlp_from_flax,
                   dict(hidden=(32, 24), num_outputs=16), (3, 8, 6, 2)),
    "PlainNet": (jz.PlainNet(num_classes=5), tz.plainnet_from_flax,
                 dict(num_classes=5, input_hw=(36, 32)), (2, 36, 32, 1)),
}


def dot_k(net) -> int:
    k = 0
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            k += m.weight[0].numel()
    if isinstance(net, tz.BCNN):
        k += 32 * 32                     # the bilinear pool's pixel sums
    return k


def to_nchw(x):
    t = torch.as_tensor(x)
    return t.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)


def port_out(net, x) -> np.ndarray:
    with torch.no_grad():
        out = net(to_nchw(x))
    if out.dim() == 4:
        return out.permute(0, 2, 3, 1).numpy()
    if out.dim() == 5:                                   # stacked outputs
        return out.permute(0, 1, 3, 4, 2).numpy()
    return out.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_zoo_net_matches_flax(name):
    jnet, from_flax, config, shape = CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape).astype(np.float32)
    init = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                            jnp.zeros(shape), train=False))
    blank = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), init)
    net = from_flax(blank, **config)            # every Flax leaf has a home
    variables = random_flax_variables(net, 3)
    assert weights.flatten(variables).keys() == weights.flatten(blank).keys()
    net = from_flax(variables, **config)
    assert not net.training
    want = np.asarray(jax.jit(lambda v, a: jnet.apply(v, a, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    got = port_out(net, x)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 2 * dot_k(net) * U * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the variables go back out unchanged
    back = weights.flatten(weights.to_flax(net))
    for k, v in weights.flatten(variables).items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("size", [(7, 9), (8, 8), (1, 5)])
def test_same_max_pool_and_nearest_resize_match_jax(size):
    import flax.linen as fnn
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + size + (3,)).astype(np.float32)
    for k, s in ((3, 2), (2, 2), (3, 1)):
        want = np.asarray(fnn.max_pool(jnp.asarray(x), (k, k), (s, s),
                                       padding="SAME"))
        got = tz.max_pool_same(to_nchw(x), k, s).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), want)
    for out in ((2 * size[0], 2 * size[1]), (size[0] + 3, size[1] * 3),
                (max(size[0] - 2, 1), size[1])):
        want = np.asarray(jax.image.resize(jnp.asarray(x),
                                           (2,) + out + (3,), "nearest"))
        got = tz.resize_nearest(to_nchw(x), out).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_nets_train_mode_runs():
    """In train mode the dropout masks are torch's: the outputs differ
    from eval mode's, and are finite."""
    net = tz.DropoutMLP(48, hidden=(32,), num_outputs=8, rate=0.5)
    x = torch.randn(4, 48)
    net.train()
    a = net(x)
    net.eval()
    assert torch.isfinite(a).all() and not torch.equal(a, net(x))
