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
