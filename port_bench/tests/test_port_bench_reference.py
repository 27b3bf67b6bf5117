"""The plain reference against the port's CPU path at `configs/smoke.yaml`
widths in float32: the same parameter names and shapes, a served batch,
and three training steps (losses, first gradients, changes)."""

import pytest

import _smoke  # noqa: F401
from _smoke import smoke_config, smoke_run
from port_bench.reference import params
from port_bench.reference.vocab import Vocab as RefVocab


@pytest.mark.parametrize("config", ["smoke", "flagship", "flagship-sn"])
def test_parameter_names_and_shapes(config):
    import torch
    from dwcgan_tpu_torch.config import config_from_dict
    from dwcgan_tpu_torch.models.discriminator import MsImageDis
    from dwcgan_tpu_torch.models.generator import Generator
    from dwcgan_tpu_torch.models.vgg import Vgg16Features
    from dwcgan_tpu_torch.text.vocab import Vocab
    from port_bench import core

    cfg = smoke_config() if config == "smoke" else core.load_json(
        "configs", "dwcgan-celeba128" + ("-sn" if config.endswith("sn") else ""))["config"]
    c = config_from_dict(cfg)
    with torch.device("meta"):
        gen = Generator(c.gen, c.input_dim, Vocab(c.dataset).size)
        dis = MsImageDis(c.dis)
        vgg = Vgg16Features()
    shapes = lambda m: {k: tuple(v.shape) for k, v in m.state_dict().items()}
    spec = lambda s: {n: tuple(shape) for n, shape, _ in s}
    assert spec(params.gen_specs(cfg, RefVocab(cfg["dataset"]).size)) == shapes(gen)
    assert spec(params.dis_specs(cfg)) == shapes(dis)
    assert spec(params.vgg_specs()) == shapes(vgg)
    assert [n for n, _, _ in params.gen_specs(cfg, 102)] == list(shapes(gen))


def test_serving_matches_the_port(tmp_path):
    from port_bench import core
    rec = core.load_driver("serve").run(smoke_run("serve", tmp_path))
    assert rec["numbers"]["edit_rel_err"] < 1e-5


def test_training_steps_match_the_port(tmp_path):
    from port_bench import core
    rec = core.load_driver("train").run(smoke_run("train", tmp_path))
    n = rec["numbers"]
    # fp32 on both sides: only the summation order differs
    assert n["loss"] < 1e-5 and n["grad1"] < 1e-3 and n["grad1_med"] < 1e-4
    assert n["change3_med"] < 1e-4


def test_reference_feed_matches_the_port(tmp_path):
    """The reference's own decode of the data set's files gives the port's
    feed's first batches: the same rows, labels, commands and flips, and
    the same pixels to float32 rounding."""
    import numpy as np
    from dwcgan_tpu_torch.data.celeba import CelebADataset
    from dwcgan_tpu_torch.data.pipeline import DataPipeline
    from port_bench.reference import feed
    from port_bench.traffic import celeba_files

    data = celeba_files.ensure(tmp_path, {"images": 48, "data_seed": 3})
    seed, split, batch = 2 ** 33 + 17, 8, 8
    images, attrs = str(data / "images"), str(data / "list_attr_celeba.txt")
    ds = CelebADataset(images, attrs, mode="train", crop_size=178, image_size=128,
                       max_text_len=80, seed=seed, test_split=split)
    it = iter(DataPipeline(ds, batch, num_workers=2, seed=seed))
    try:
        prog = [next(it) for _ in range(3)]
    finally:
        it.close()
    ref = feed.first_batches(images, attrs, seed, split, batch, 3, 178, 128, 80)
    for p, r in zip(prog, ref):
        np.testing.assert_allclose(p.image, r[0], rtol=0, atol=2e-6)
        for j in range(1, 5):
            np.testing.assert_array_equal(p[j], r[j])
