"""The port's VGG16 perceptual loss against `make_vgg_loss_fn` of the JAX
package, with the same random parameters (`init_random_vgg`, moved over by
`jax_vgg_to_state_dict`) and the same numpy images (2 at 32 px; the three
pools leave 4x4 relu5_3 features).  fp32 on the CPU, in both stats modes:
the loss within rtol 1e-4; its gradient with respect to the second image
within 2e-3 of the largest (measured 4.5e-4): thirteen random-weight
convolutions summed in another order, and relu5_3 channels that are almost
all zero, whose instance norm divides by sqrt(var + 1e-5) and so magnifies
the last bits in which the two sides differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.models.vgg import init_random_vgg, make_vgg_loss_fn as jax_vgg_loss
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu_torch.interop.jax_params import jax_vgg_to_state_dict
from dwcgan_tpu_torch.models import vgg as port_vgg
from dwcgan_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)
REL, GRAD_REL = 1e-4, 2e-3


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, init_random_vgg(0))


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2)]


def _port_net(params):
    net = port_vgg.Vgg16Features()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         jax_vgg_to_state_dict(params["params"]).items()})
    return net


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
def test_loss_and_input_gradient_match_jax(params, stats):
    x, y = _images(0)
    jnorms.set_stats_mode(stats)
    try:
        jv, jg = jax.value_and_grad(lambda b: jax_vgg_loss(params)(jnp.asarray(x), b))(
            jnp.asarray(y))
    finally:
        jnorms.set_stats_mode("2pass")
    loss = port_vgg.make_vgg_loss_fn(_port_net(params), stats=stats)
    ty = torch.from_numpy(y).requires_grad_()
    tv = loss(torch.from_numpy(x), ty)
    (tg,) = torch.autograd.grad(tv, ty)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=REL)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, atol=GRAD_REL * np.abs(jg).max(), rtol=0)


def test_frozen_and_no_graph_for_an_input_without_grad(params):
    net = _port_net(params)
    assert not any(p.requires_grad for p in net.parameters())
    x, _ = _images(1)
    feats = net(port_vgg.vgg_preprocess(torch.from_numpy(x)))
    assert not feats.requires_grad and feats.shape == (2, 512, 4, 4)


def test_preprocess_matches_jax():
    from dwcgan_tpu.models.vgg import vgg_preprocess
    x, _ = _images(2)
    want = np.asarray(vgg_preprocess(jnp.asarray(x)))
    got = port_vgg.vgg_preprocess(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_random_init_is_lecun_normal_and_npz_loads(params, tmp_path):
    net = port_vgg.Vgg16Features()
    port_vgg.init_random_vgg(net, 0)
    w = net.conv3_1.weight
    assert abs(float(w.std()) - (1.0 / w[0].numel()) ** 0.5) < 0.05 * (1.0 / w[0].numel()) ** 0.5
    assert float(net.conv3_1.bias.abs().max()) == 0.0
    # the .npz layout of dwcgan_tpu/cli/convert_vgg.py: {name}_kernel HWIO
    p = params["params"]
    np.savez(tmp_path / "vgg16.npz", **{f"{n}_{leaf}": p[n][leaf] for n in p
                                        for leaf in ("kernel", "bias")})
    loaded = port_vgg.Vgg16Features()
    port_vgg.load_vgg_npz(loaded, str(tmp_path / "vgg16.npz"))
    for a, b in zip(loaded.state_dict().values(), _port_net(params).state_dict().values()):
        assert torch.equal(a, b)


def test_cpu_loss_launches_no_kernel(params):
    before = dict(kernels.LAUNCHES)
    x, y = _images(3)
    port_vgg.make_vgg_loss_fn(_port_net(params))(torch.from_numpy(x), torch.from_numpy(y))
    assert kernels.LAUNCHES == before
