"""F8: the training CLI's VGG16 weights where the config names none.

With `vgg_model_path` empty, the JAX CLI reads `<output_path>/models/
vgg16.npz` (`dwcgan_tpu/cli/train.py:148-169`), where the README puts the
converter's output.  The port's `build_vgg_loss` must read the same file:
a seeded `.npz` in the layout of `dwcgan_tpu.cli.convert_vgg` goes there,
and the port's loss equals JAX's `make_vgg_loss_fn(load_vgg_params(path))`
on seeded images, fp32 on the CPU, within the rtol 1e-4 of
`tests/test_torch_vgg.py`.  The CLI's `main` passes its `--output_path`.
"""

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp
from dwcgan_tpu.models.vgg import _LAYERS, load_vgg_params, make_vgg_loss_fn
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu_torch.cli import train
from dwcgan_tpu_torch.config import load_config

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
REL = 1e-4


def write_npz(path, seed=0):
    """Seeded weights in the `.npz` layout of the converters."""
    rng = np.random.default_rng(seed)
    arrays, cin = {}, 3
    for name, ch, _ in _LAYERS:
        arrays[f"{name}_kernel"] = rng.normal(
            scale=(2.0 / (9 * cin)) ** 0.5, size=(3, 3, cin, ch)).astype(np.float32)
        arrays[f"{name}_bias"] = rng.normal(scale=0.05, size=(ch,)).astype(np.float32)
        cin = ch
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return str(path)


def _cfg(**over):
    cfg = load_config(CONFIG)
    cfg.vgg_w, cfg.vgg_model_path = 0.1, ""
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
def test_empty_vgg_model_path_reads_output_path_models(tmp_path, stats, capsys):
    path = write_npz(tmp_path / "models" / "vgg16.npz")
    rng = np.random.default_rng(1)
    x, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    loss = train.build_vgg_loss(_cfg(norm_stats=stats), "cpu", str(tmp_path))
    assert f"perceptual loss on (weights: {path})" in capsys.readouterr().out
    got = float(loss(torch.from_numpy(x), torch.from_numpy(y)))
    jnorms.set_stats_mode(stats)
    try:
        want = float(make_vgg_loss_fn(load_vgg_params(path))(jnp.asarray(x),
                                                              jnp.asarray(y)))
    finally:
        jnorms.set_stats_mode("2pass")
    np.testing.assert_allclose(got, want, rtol=REL)


def test_a_named_vgg_model_path_wins_and_a_missing_file_falls_back(tmp_path, capsys):
    write_npz(tmp_path / "models" / "vgg16.npz", seed=0)
    named = write_npz(tmp_path / "elsewhere.npz", seed=2)
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
            for _ in range(2))
    a = train.build_vgg_loss(_cfg(vgg_model_path=named), "cpu", str(tmp_path))(x, y)
    assert f"(weights: {named})" in capsys.readouterr().out
    b = train.build_vgg_loss(_cfg(), "cpu", str(tmp_path))(x, y)
    assert float(a) != float(b)
    missing = tmp_path / "empty"
    assert train.build_vgg_loss(_cfg(), "cpu", str(missing)) is not None
    out = capsys.readouterr().out
    assert f"no weights at {missing / 'models' / 'vgg16.npz'}" in out
    assert "RANDOM-INIT" in out
    assert train.build_vgg_loss(_cfg(vgg_random_fallback=False), "cpu",
                                str(missing)) is None
    assert "perceptual loss off" in capsys.readouterr().out


def test_train_main_looks_under_its_output_path(tmp_path, capsys):
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["vgg_w"] = 0.1
    (tmp_path / "smoke.yaml").write_text(yaml.safe_dump(cfg))
    out = tmp_path / "run"
    path = write_npz(out / "models" / "vgg16.npz")
    train.main(["--config", str(tmp_path / "smoke.yaml"), "--output_path", str(out),
                "--device", "cpu", "--synthetic_data", "--max_steps", "1"])
    assert f"perceptual loss on (weights: {path})" in capsys.readouterr().out
