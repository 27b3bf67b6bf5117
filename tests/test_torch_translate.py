"""The port's translate CLI end to end on the CPU: three tiny PNGs, a `.npz`
of JAX generator parameters, and the written edits against the JAX
package's `make_infer_fn` on the same inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.data.celeba import _center_crop_resize as jax_crop_resize
from dwcgan_tpu.eval.harness import read_src2trg as jax_read_src2trg
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.text.vocab import Vocab, encode_commands
from dwcgan_tpu.train.sampler import make_infer_fn as jax_make_infer_fn
from dwcgan_tpu_torch.cli import translate
from dwcgan_tpu_torch.interop.jax_params import flatten_params

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
EDITS = [("a.png", "make her smile"), ("b.png", "add eyeglasses"),
         ("a.png", "remove the beard . make him older")]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("translate")
    rng = np.random.default_rng(0)
    for name, size in (("a.png", (44, 48)), ("b.png", (40, 40))):
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(
            tmp / name)
    with open(tmp / "edits.tsv", "w") as f:
        f.write("\n".join(f"{n}\t{c}" for n, c in EDITS) + "\n\n")

    cfg = jax_load_config(CONFIG)
    vocab = Vocab(cfg.dataset)
    gen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim,
                       vocab_size=vocab.size, dtype=jnp.float32)
    dummy = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    params = jax.jit(gen.init)({"params": jax.random.PRNGKey(3),
                                "dropout": jax.random.PRNGKey(4)}, dummy)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    np.savez(tmp / "gen.npz", **flatten_params(params))
    return tmp, cfg, vocab, gen, params


def test_read_src2trg_matches_jax_package(setup):
    tmp = setup[0]
    assert translate.read_src2trg(str(tmp / "edits.tsv")) == \
        jax_read_src2trg(str(tmp / "edits.tsv")) == EDITS


def test_center_crop_resize_matches_jax_pil_path(setup):
    tmp, cfg = setup[0], setup[1]
    for name in ("a.png", "b.png"):
        with Image.open(tmp / name) as im:
            ours = translate._center_crop_resize(im, cfg.crop_size, cfg.image_size)
            theirs = jax_crop_resize(im, cfg.crop_size, cfg.image_size, backend="pil")
        assert ours.shape == (cfg.image_size, cfg.image_size, 3)
        np.testing.assert_array_equal(ours, theirs)


def test_translate_main_matches_jax_infer(setup):
    tmp, cfg, vocab, gen, params = setup
    out_dir = tmp / "out"
    translate.main(["--config", CONFIG, "--weights", str(tmp / "gen.npz"),
                    "--list", str(tmp / "edits.tsv"), "--image_dir", str(tmp),
                    "--out_dir", str(out_dir), "--batch_size", "2",
                    "--device", "cpu"])
    names = sorted(os.listdir(out_dir))
    assert names == ["000000_a.png", "000001_b.png", "000002_a.png"]

    imgs = []
    for name, _ in EDITS:
        with Image.open(tmp / name) as im:
            imgs.append(jax_crop_resize(im, cfg.crop_size, cfg.image_size,
                                        backend="pil"))
    ids, lens = encode_commands([c for _, c in EDITS], vocab, cfg.max_text_len)
    try:
        ref = np.asarray(jax_make_infer_fn(cfg, gen)(params, np.stack(imgs),
                                                     ids, lens))
    finally:
        jnorms.set_stats_mode("2pass")
    ref_u8 = ((np.clip(ref, -1, 1) + 1) * 127.5 + 0.5).astype(np.uint8)
    for name, want in zip(names, ref_u8):
        got = np.asarray(Image.open(out_dir / name))
        # float results agree to ~1e-6; a value on a rounding boundary may
        # land one level apart
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_translate_batch_returns_nhwc_on_the_device(setup):
    tmp, cfg, vocab, gen, params = setup
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.interop.jax_params import load_jax_params
    from dwcgan_tpu_torch.models.generator import build_generator
    from dwcgan_tpu_torch.train.sampler import make_infer_fn
    tcfg = load_config(CONFIG)
    port = build_generator(tcfg, vocab.size, device="cpu")
    load_jax_params(port, params)
    images = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    out = translate.translate_batch(make_infer_fn(tcfg, port), images,
                                    ["make her smile", "do nothing"], vocab,
                                    tcfg.max_text_len, torch.device("cpu"))
    assert out.shape == (2, 32, 32, 3) and out.device.type == "cpu"
    assert torch.isfinite(out).all()
