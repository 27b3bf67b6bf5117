"""The port's discriminator against the JAX `MsImageDis`.

`configs/smoke.yaml`'s discriminator (dim 8, 3 layers, 2 scales, 32 px),
fp32 on the CPU, with norms none (the shipped setting), in and ln.  The
JAX parameters go into the port through `load_jax_dis_params`; both see
the same numpy images.  Every output within atol 1e-5 (summation order
only).  The port's `state_dict()` converts back through the JAX package's
reference importer exactly.

In bf16 both compute in the compute dtype, and the outputs are bit-equal
on this CPU (the JAX fp32-vs-bf16 gap there: up to 4.4e-3 with in, 1.4e-3
with ln).  That holds the port's LeakyReLU to JAX's (the slope rounded to
bf16 before the product) and its scales to JAX's order: the image halved
in its own dtype, cast per tower.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.interop.torch_import import convert_reference_discriminator
from dwcgan_tpu.models.discriminator import MsImageDis as JaxDis
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.ops.resize import downsample2x as j_downsample2x
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import flatten_params, load_jax_dis_params
from dwcgan_tpu_torch.models.discriminator import MsImageDis, build_discriminator
from dwcgan_tpu_torch.ops.resize import downsample2x

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
ATOL = 1e-5


@pytest.fixture(scope="module", params=["none", "in", "ln"])
def both(request):
    jcfg = jax_load_config(CONFIG)
    jcfg.dis.norm = request.param
    jdis = JaxDis(cfg=jcfg.dis, dtype=jnp.float32)
    images = np.random.default_rng(0).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    params = jdis.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))["params"]
    if request.param == "ln":   # a non-trivial affine
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.1 if "ln_beta" in jax.tree_util.keystr(p) else v, params)
    params = jax.tree_util.tree_map(np.asarray, params)
    ref = {ms: jax.tree_util.tree_map(np.asarray, jdis.apply(
        {"params": params}, images, ms)) for ms in (True, False)}
    tcfg = load_config(CONFIG)
    tcfg.dis.norm = request.param
    port = MsImageDis(tcfg.dis)
    load_jax_dis_params(port, params)
    return dict(ref=ref, port=port, params=params, images=images, jcfg=jcfg)


@pytest.mark.parametrize("multiscale", [True, False])
def test_forward_matches_jax(both, multiscale):
    with torch.no_grad():
        got = both["port"](torch.from_numpy(both["images"]), multiscale)
    want = both["ref"][multiscale]
    assert len(got) == len(want) == (2 if multiscale else 1)
    for (gs, gc), (ws, wc) in zip(got, want):
        assert tuple(gs.shape) == ws.shape and tuple(gc.shape) == wc.shape
        np.testing.assert_allclose(gs.numpy(), ws, atol=ATOL, rtol=0)
        np.testing.assert_allclose(gc.numpy(), wc, atol=ATOL, rtol=0)


@pytest.mark.parametrize("multiscale", [True, False])
def test_bf16_forward_bit_equal_to_jax_bf16(both, multiscale):
    jdis = JaxDis(cfg=both["jcfg"].dis, dtype=jnp.bfloat16)
    want = jdis.apply({"params": both["params"]}, both["images"], multiscale)
    port = MsImageDis(both["port"].cfg, torch.bfloat16)
    port.load_state_dict(both["port"].state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(both["images"]), multiscale)
    assert len(got) == len(want)
    for pair, wpair in zip(got, want):
        for g, w in zip(pair, wpair):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def test_state_dict_round_trips_through_the_reference_importer(both):
    back = convert_reference_discriminator(both["port"].state_dict(),
                                           both["jcfg"].dis)
    want, got = flatten_params(both["params"]), flatten_params(back)
    keys = [k for k in want if "ln_" not in k]   # the importer has no LN
    assert sorted(keys) == sorted(got)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_seeded_init_is_gaussian_and_reproducible():
    cfg = load_config(CONFIG)
    a = build_discriminator(cfg, device="cpu", seed=3)
    b = build_discriminator(cfg, device="cpu", seed=3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert float(p.abs().max()) == 0.0
    w = torch.cat([p.flatten() for n, p in a.named_parameters()
                   if n.endswith("weight")])
    assert abs(float(w.std()) - 0.02) < 0.002


def test_bn_is_not_in_this_slice():
    """bn builds now (its parity is in test_torch_block_options.py); a norm
    the JAX block does not know is rejected with the JAX block's wording."""
    cfg = load_config(CONFIG)
    cfg.dis.norm = "bn"
    assert "cnns_feat.0.1.norm.weight" in MsImageDis(cfg.dis).state_dict()
    cfg.dis.norm = "gn"
    with pytest.raises(ValueError, match="Unsupported normalization: gn"):
        MsImageDis(cfg.dis)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_downsample2x_matches_jax(dtype):
    x = np.random.default_rng(1).normal(size=(2, 6, 8, 3)).astype(np.float32)
    if dtype == "bfloat16":
        ref = np.asarray(j_downsample2x(jnp.asarray(x, jnp.bfloat16)), np.float32)
        got = downsample2x(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)).float()
    else:
        ref = np.asarray(j_downsample2x(jnp.asarray(x)))
        got = downsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6, rtol=0)


@pytest.fixture(autouse=True)
def _restore_jax_stats_mode():
    yield
    jnorms.set_stats_mode("2pass")
