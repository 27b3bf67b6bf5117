"""The monitoring grid on the CPU: `style_replace` bit-equal to the JAX
package's, and `make_sample_fn`'s five rows against JAX's `make_sample_fn`
on the same generator weights (through `load_jax_params`), the same images
and commands and the same standard-normal style draws, in fp32 at
`configs/smoke.yaml` widths, within 2e-5 (fp32 summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.data.pipeline import synthetic_batch
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.text.vocab import Vocab
from dwcgan_tpu.train.sampler import make_sample_fn as jax_make_sample_fn
from dwcgan_tpu.train.sampling import style_replace as jax_style_replace
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import load_jax_params
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.train.sampler import make_sample_fn
from dwcgan_tpu_torch.train.sampling import style_replace
from dwcgan_tpu_torch.utils.images import make_grid

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
ATOL = 2e-5
N = 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_style_replace_matches_jax(seed):
    rng = np.random.default_rng(seed)
    c_src = np.where(rng.random((5, 8)) < 0.5, -1.0, 1.0).astype(np.float32)
    c_trg = np.where(rng.random((5, 8)) < 0.5, -1.0, 1.0).astype(np.float32)
    z_src = rng.standard_normal((5, 64)).astype(np.float32)
    z_trg = rng.standard_normal((5, 64)).astype(np.float32)
    got = style_replace(*map(torch.from_numpy, (c_src, c_trg, z_src, z_trg)), 8)
    want = jax_style_replace(c_src, c_trg, z_src, z_trg, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keep = np.repeat(c_src == c_trg, 8, axis=1)
    np.testing.assert_array_equal(got.numpy(), np.where(keep, z_src, z_trg))


@pytest.fixture(scope="module")
def grids():
    """Both samplers' rows with attention on and off, and the batch."""
    jcfg = jax_load_config(CONFIG)
    vocab = Vocab(jcfg.dataset)
    jgen = JaxGenerator(cfg=jcfg.gen, input_dim=jcfg.input_dim,
                        vocab_size=vocab.size, dtype=jnp.float32)
    dummy = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3), jnp.float32)
    params = jax.jit(jgen.init)({"params": jax.random.PRNGKey(3),
                                 "dropout": jax.random.PRNGKey(4)}, dummy)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    b = synthetic_batch(N, jcfg.image_size, seed=5, max_text_len=jcfg.max_text_len)
    key = jax.random.PRNGKey(7)
    # the draws JAX's sample_style makes from this key
    eps = np.array(jax.random.normal(key, (N, jcfg.gen.num_cls, jcfg.c_dim),
                                     jnp.float32))

    cfg = load_config(CONFIG)
    gen = build_generator(cfg, vocab.size, device="cpu", train=True)
    load_jax_params(gen, params)
    sample = make_sample_fn(cfg, gen)
    jsample = jax.jit(jax_make_sample_fn(jcfg, jgen))
    x, txt, lens = (torch.from_numpy(np.asarray(a)) for a in (b.image, b.txt, b.txt_len))
    out = {}
    for att_on in (True, False):
        ours = sample(x, txt, lens, att_on, eps=torch.from_numpy(eps))
        theirs = jsample(params, key, b.image, b.txt, b.txt_len, jnp.asarray(att_on))
        out[att_on] = ([r.numpy() for r in ours], [np.asarray(r) for r in theirs])
    return out, b, gen


@pytest.mark.parametrize("att_on", [True, False])
def test_sample_rows_match_jax(grids, att_on):
    ours, theirs = grids[0][att_on]
    assert len(ours) == len(theirs) == 5      # real, rec, text, sampled, attention
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape == (N, 32, 32, 3) and a.dtype == np.float32, i
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"row {i}")
    np.testing.assert_array_equal(ours[0], grids[1].image)
    assert all(np.abs(r).max() <= 1.0 for r in ours)


def test_sampler_leaves_the_generator_in_eval_and_the_grid_tiles(grids):
    out, _, gen = grids
    assert not gen.training
    on, off = out[True][0], out[False][0]
    # the attention gate changes the blended rows only
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[4], off[4])
    assert not np.array_equal(on[1], off[1])
    grid = make_grid(on, N)
    assert grid.shape == (5 * 32, N * 32, 3) and grid.dtype == np.uint8


def test_the_style_draw_comes_from_the_given_generator(grids):
    """Without eps, the draws come from the generator: the same seed draws
    the same grid, another seed another sampled row."""
    cfg = load_config(CONFIG)
    _, b, gen = grids
    sample = make_sample_fn(cfg, gen)
    x, txt, lens = (torch.from_numpy(np.asarray(a)) for a in (b.image, b.txt, b.txt_len))
    rows = lambda s: sample(x, txt, lens, True, generator=torch.Generator().manual_seed(s))
    a, a2, c = rows(3), rows(3), rows(4)
    for r, r2 in zip(a, a2):
        assert torch.equal(r, r2)
    assert torch.equal(a[2], c[2]) and not torch.equal(a[3], c[3])
