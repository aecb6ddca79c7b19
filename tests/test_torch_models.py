"""Port's AtariCNN vs the JAX package's, in float32.

The JAX parameters are carried across by ``convert`` (HWIO→OIHW, Dense
transposes, and ``Dense_0``'s rows permuted from NHWC to NCHW flatten
order), and the same uint8 frames go through both forwards.  Both run in
float32 (the JAX side at full matmul precision, ``tests/conftest.py``).
The sums are taken in another order by XLA's and PyTorch's CPU
convolutions, so Q values agree to rtol 1e-5 / atol 1e-5, not bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.models import AtariCNN as JaxAtariCNN
from border_tpu_torch import convert
from border_tpu_torch.models import AtariCNN

RTOL = ATOL = 1e-5


def _frames(b=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, 84, 84, 4), dtype=np.uint8)


@pytest.mark.parametrize("scale_in_kernel", [True, False])
@pytest.mark.parametrize("skip_linear", [False, True])
def test_forward_matches_jax_float32(scale_in_kernel, skip_linear):
    x = _frames()
    jnet = JaxAtariCNN(out_dim=6, dtype=jnp.float32, skip_linear=skip_linear,
                       scale_in_kernel=scale_in_kernel)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))

    net = AtariCNN(6, dtype=torch.float32, skip_linear=skip_linear,
                   scale_in_kernel=scale_in_kernel)
    convert.load_atari_cnn(net, params)
    got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (6, 512 if skip_linear else 6)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 1e-3  # not a trivially zero output


def test_param_conversion_round_trips():
    jnet = JaxAtariCNN(out_dim=6)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 84, 84, 4), jnp.uint8))
    net = convert.load_atari_cnn(AtariCNN(6), params)
    back = convert.atari_cnn_to_flax(net)["params"]
    for name, leaves in params["params"].items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(back[name][leaf], np.asarray(value))


def test_init_matches_flax_lecun_normal_scale():
    """The port's own init draws flax's lecun_normal (truncated normal,
    variance 1/fan_in) and zero biases."""
    net = AtariCNN(6)
    net.reset_parameters(torch.Generator().manual_seed(0))
    for m in (net.conv0, net.conv1, net.conv2, net.fc0):
        fan_in = m.weight[0].numel()
        std = m.weight.std().item()
        assert std == pytest.approx(fan_in ** -0.5, rel=0.1)
        assert m.weight.abs().max().item() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
        assert (m.bias == 0).all()


def test_bf16_forward_close_to_float32():
    """The default compute type is bf16 (params stay float32, Q is
    float32).  bf16 keeps ~3 significant digits, so the check is loose."""
    x = torch.from_numpy(_frames(4, seed=1))
    net = AtariCNN(6)
    net.reset_parameters(torch.Generator().manual_seed(2))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    q16 = net(x)
    net.dtype = torch.float32
    q32 = net(x)
    assert q16.dtype == torch.float32
    scale = q32.abs().max().item()
    assert (q16 - q32).abs().max().item() <= 0.05 * scale


# -- the layout handed to the convolutions ------------------------------------

def _plain_forward(net, x):
    """The torso as a plain NCHW ``F.conv2d``/``F.linear`` stack over the
    module's own parameters, in float64: conv0 8×8 stride 4 on the frames,
    ``fc0`` on the NCHW flatten."""
    import torch.nn.functional as F

    h = x.permute(0, 3, 1, 2).double()
    w0 = net.conv0.weight
    if net.scale_in_kernel:
        w0 = w0 / 255.0
    else:
        h = h / 255.0
    h = F.relu(F.conv2d(h, w0, net.conv0.bias, stride=4))
    h = F.relu(F.conv2d(h, net.conv1.weight, net.conv1.bias, stride=2))
    h = F.relu(F.conv2d(h, net.conv2.weight, net.conv2.bias, stride=1))
    h = F.relu(F.linear(h.flatten(1), net.fc0.weight, net.fc0.bias))
    if net.skip_linear:
        return h.float()
    return F.linear(h, net.fc1.weight, net.fc1.bias).float()


def _float64_net(in_channels, skip_linear, scale_in_kernel):
    net = AtariCNN(6, skip_linear=skip_linear, dtype=torch.float64,
                   scale_in_kernel=scale_in_kernel, in_channels=in_channels)
    net.reset_parameters(torch.Generator().manual_seed(in_channels))
    with torch.no_grad():  # biases off zero, so their gradients are read
        for p in net.parameters():
            if p.dim() == 1:
                p.uniform_(-0.1, 0.1)
    return net.double()


def _union_stack(b, in_channels, seed=3):
    """``[B, 84, 84, C]`` NHWC view of a ``[B, C+1, 84, 84]`` gather's
    first C frames, as the union sample hands it to the torso: not dense."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(
        rng.integers(0, 256, (b, in_channels + 1, 84, 84), dtype=np.uint8))
    return g[:, :in_channels].permute(0, 2, 3, 1)


@pytest.mark.parametrize("scale_in_kernel", [True, False])
@pytest.mark.parametrize("skip_linear", [False, True])
@pytest.mark.parametrize("in_channels", [1, 4])
def test_space_to_depth_forward_and_grads_equal_plain_stack(
        in_channels, skip_linear, scale_in_kernel):
    """In float64 the space-to-depth conv0, the channels-last convolutions
    and ``fc0``'s permuted columns give the plain NCHW stack's output and
    the gradient of every master weight (conv0's through its rearranged
    copy, ``fc0``'s through its permuted one)."""
    net = _float64_net(in_channels, skip_linear, scale_in_kernel)
    x = _union_stack(5, in_channels)
    got, want = net(x), _plain_forward(net, x)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (5, 512 if skip_linear else 6)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert want.abs().max() > 1e-3
    cot = torch.from_numpy(
        np.random.default_rng(4).standard_normal(tuple(got.shape)))
    params = list(net.parameters())
    g_got = torch.autograd.grad((got.double() * cot).sum(), params)
    g_want = torch.autograd.grad((want.double() * cot).sum(), params)
    for (name, _), a, b in zip(net.named_parameters(), g_got, g_want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)
        assert b.abs().max() > 0, name


@pytest.mark.parametrize("scale_in_kernel", [True, False])
@pytest.mark.parametrize("skip_linear", [False, True])
@pytest.mark.parametrize("in_channels", [1, 4])
def test_state_dict_keys_shapes_and_order_unchanged(
        in_channels, skip_linear, scale_in_kernel):
    """The parameters stay the JAX-convertible float32 masters: OIHW
    convolutions and ``fc0`` over the NCHW flatten, in this order."""
    net = AtariCNN(6, skip_linear=skip_linear, in_channels=in_channels,
                   scale_in_kernel=scale_in_kernel)
    want = [("conv0.weight", (32, in_channels, 8, 8)), ("conv0.bias", (32,)),
            ("conv1.weight", (64, 32, 4, 4)), ("conv1.bias", (64,)),
            ("conv2.weight", (64, 64, 3, 3)), ("conv2.bias", (64,)),
            ("fc0.weight", (512, 3136)), ("fc0.bias", (512,))]
    if not skip_linear:
        want += [("fc1.weight", (6, 512)), ("fc1.bias", (6,))]
    sd = net.state_dict()
    assert [(k, tuple(v.shape)) for k, v in sd.items()] == want
    assert all(v.dtype == torch.float32 and v.is_contiguous()
               for v in sd.values())


@pytest.mark.parametrize("scale_in_kernel", [True, False])
@pytest.mark.parametrize("skip_linear", [False, True])
@pytest.mark.parametrize("in_channels", [1, 4])
def test_space_to_depth_counter_counts_eager_forwards(
        in_channels, skip_linear, scale_in_kernel):
    """Each eager torso forward adds one to ``space_to_depth.launches`` and
    none to ``captured``; the counter is one that graph replays add to."""
    from border_tpu_torch.models.cnn import space_to_depth
    from border_tpu_torch.ops import COUNTED

    assert space_to_depth in COUNTED
    net = AtariCNN(6, skip_linear=skip_linear, in_channels=in_channels,
                   scale_in_kernel=scale_in_kernel)
    x = _union_stack(2, in_channels)
    before = (space_to_depth.launches, space_to_depth.captured)
    with torch.no_grad():
        for _ in range(3):
            net(x)
    assert (space_to_depth.launches, space_to_depth.captured) == (
        before[0] + 3, before[1])


@pytest.mark.parametrize("in_channels", [1, 4])
def test_space_to_depth_layout(in_channels):
    """The input's channel ``(c·4 + p)·4 + q`` at ``(i, j)`` is pixel
    ``(4i + p, 4j + q)`` of frame ``c``, stored channels-last and dense;
    the weight's is ``w[:, c, 4a + p, 4b + q]`` at ``(a, b)``."""
    from border_tpu_torch.models.cnn import (space_to_depth,
                                             space_to_depth_weight)

    x = _union_stack(2, in_channels)
    s = space_to_depth(x, 4, torch.bfloat16)
    assert s.shape == (2, 16 * in_channels, 21, 21)
    assert s.dtype == torch.bfloat16
    assert s.is_contiguous(memory_format=torch.channels_last)
    c, p, q, i, j = in_channels - 1, 2, 3, 20, 7
    k = (c * 4 + p) * 4 + q
    assert torch.equal(s[:, k, i, j], x[:, 4 * i + p, 4 * j + q, c].bfloat16())
    w = torch.randn(32, in_channels, 8, 8)
    sw = space_to_depth_weight(w, 4, torch.float32)
    assert sw.shape == (32, 16 * in_channels, 2, 2)
    assert sw.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(sw[:, k, 1, 0], w[:, c, 4 + p, q])
