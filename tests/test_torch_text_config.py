"""The port's own copies of the config loader, vocabulary and command
synthesizer give what the JAX package's give."""

import dataclasses
import glob
import random

import numpy as np
import pytest
import yaml

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.text.synthesis import TextSynthesizer as JaxSynth
from dwcgan_tpu.text.vocab import Vocab as JaxVocab
from dwcgan_tpu.text.vocab import encode_commands as jax_encode
from dwcgan_tpu_torch.config import load_config, parse_yaml
from dwcgan_tpu_torch.text.synthesis import TextSynthesizer
from dwcgan_tpu_torch.text.vocab import Vocab, encode_commands

CONFIGS = sorted(glob.glob("configs/*.yaml"))


def test_every_shipped_config_is_found():
    assert len(CONFIGS) >= 10 and "configs/celeba_faces.yaml" in CONFIGS


@pytest.mark.parametrize("path", CONFIGS)
def test_parse_yaml_equals_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == (yaml.safe_load(text) or {})


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_equals_jax_package(path):
    assert dataclasses.asdict(load_config(path)) == \
        dataclasses.asdict(jax_load_config(path))


@pytest.mark.parametrize("text", [
    "gen: {dim: 8}\n", "- a\n- b\n", "a: [1, 2]\n", "a: &x 1\n",
    "  indented: 1\n", "a: |\n  multi\n"])
def test_parse_yaml_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_parse_yaml_scalars():
    text = ("a: 1\nb: 1e-4\nc: 0.5\nd: True\ne: off\nf: null\ng: ~\n"
            "h: 'q # not a comment'\ni: word  # comment\nj:\nk: -3\n"
            "l: 1_000_000\nm: .inf\nn: 1e-4x\n")
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("dataset", ["CelebA", "CUB"])
def test_vocab_ids_equal_jax_package(dataset):
    jv, tv = JaxVocab(dataset), Vocab(dataset)
    assert tv.size == jv.size and list(tv.itos) == list(jv.itos)
    cmds = ["make her smile", "add eyeglasses . remove the beard!",
            "unknownword and more", ""]
    for a, b in zip(encode_commands(cmds, tv, 6), jax_encode(cmds, jv, 6)):
        np.testing.assert_array_equal(a, b)


def test_synthesizer_gives_the_jax_package_commands():
    rng = np.random.default_rng(0)
    ours, theirs = TextSynthesizer(random.Random(7)), JaxSynth(random.Random(7))
    for _ in range(300):
        src, trg = rng.integers(0, 2, 8), rng.integers(0, 2, 8)
        assert ours(src, trg) == theirs(src, trg)
