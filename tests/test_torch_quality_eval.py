"""The port's quality protocol (`dwcgan_tpu_torch/cli/quality_eval.py`)
against the JAX tool's (`tools/quality_eval.py`), on the CPU.

Config: `configs/smoke.yaml`'s generator widths at 64 px, the size at
which `tests/test_procedural.py` runs the probe; 16 held-out faces in
batches of 8.

1. `held_out_set` is bit-equal to the arrays the JAX tool builds
   (tools/quality_eval.py:66-92, rebuilt here from `dwcgan_tpu.data.procedural`
   and `dwcgan_tpu.text.vocab`; `tools/` is not imported).
2. `evaluate`'s row against the JAX tool's (its calls at :121-146:
   `make_infer_fn`, `attribute_accuracy`, `compute_fid_is`, the recon L1)
   on a JAX generator's random parameters carried across by
   `load_jax_params` and a random JAX InceptionV3 by `load_jax_inception`
   (from `jax.eval_shape`, filled with seeded numpy as
   `tests/test_torch_eval.py` does): the per-bit accuracies equal,
   `nochange_recon_l1` within rtol 1e-5, `fid_rel` and `is_mean` within
   rtol 1e-4 (summation order only).
3. `main` over a run directory that two steps of the port's
   `cli/train.py` wrote (a snapshot every step): a row per checkpoint
   from its EMA generator (the file's `ema_gen` replaced by another seed's
   weights, so that the live generator's row cannot pass for it), a grid
   each, `quality_trend.json` with the JAX tool's keys.

About a minute alone: InceptionV3 at 299 px on one thread takes about
10 s per 32 images.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dwcgan_tpu_torch.cli import quality_eval as qe
from dwcgan_tpu_torch.config import load_config
from test_torch_eval import jax_variables

torch.set_num_threads(1)

N_EVAL, BATCH = 16, 8
RECON_RTOL, SCORE_RTOL = 1e-5, 1e-4
OVER = {"image_size": 64, "crop_size": 80, "log_iter": 1, "image_display_iter": 100,
        "image_save_iter": 100, "snapshot_save_iter": 1, "num_workers": 0}
ROW_KEYS = {"step", "fid_rel", "is_mean", "attr_transfer_acc", "attr_acc_per_bit",
            "nochange_recon_l1"}
TREND_KEYS = {"n_eval", "inception", "config", "config_sha256_16", "run_dir",
              "norm_stats", "seed", "results"}


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    raw = yaml.safe_load((root / "configs" / "smoke.yaml").read_text())
    raw.update(OVER)
    raw["dis"] = {**raw["dis"], "image_size": 64}
    path = tmp_path_factory.mktemp("cfg") / "quality.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.fixture(scope="module")
def held(config_path):
    return qe.held_out_set(load_config(config_path), N_EVAL, BATCH)


def _jax_held_out(config_path):
    """tools/quality_eval.py:66-92 with the JAX package's modules."""
    from dwcgan_tpu.config import load_config as jax_load_config
    from dwcgan_tpu.data.procedural import ProceduralFaceDataset
    from dwcgan_tpu.text.vocab import tokens_to_ids
    cfg = jax_load_config(config_path)
    ds = ProceduralFaceDataset(n_samples=max(N_EVAL, 512), image_size=cfg.image_size,
                               seed=cfg.seed + 777, mode="test",
                               max_text_len=cfg.max_text_len)
    n = min(N_EVAL, len(ds))
    rng = np.random.default_rng(123)
    perm = rng.permutation(len(ds))[:n]
    reals, srcs, trgs, cmds = [], [], [], []
    for i in range(n):
        reals.append(ds.render(i))
        srcs.append(ds.labels[i])
        trg = ds.labels[perm[i]]
        trgs.append(trg)
        cmds.append(ds.synth.labels2text(ds.labels[i], trg).split())
    reals, trgs = np.stack(reals), np.stack(trgs)
    txt, lens = tokens_to_ids(cmds, ds.vocab, max_len=cfg.max_text_len)
    txt_id, lens_id = tokens_to_ids(
        [ds.synth.labels2text(s, s).split() for s in srcs[:BATCH]],
        ds.vocab, max_len=cfg.max_text_len)
    return dict(reals=reals, srcs=np.stack(srcs), trgs=trgs, txt=txt, lens=lens,
                txt_id=txt_id, lens_id=lens_id)


def test_held_out_set_is_the_jax_tools(config_path, held):
    want = _jax_held_out(config_path)
    assert held.batch == BATCH and len(held.reals) == N_EVAL
    assert held.reals.shape == (N_EVAL, 64, 64, 3)
    for k, w in want.items():
        got = getattr(held, k)
        assert got.dtype == w.dtype and got.shape == w.shape, k
        np.testing.assert_array_equal(got, w, err_msg=k)
    # the no-change commands are other commands than the translations'
    assert not np.array_equal(held.txt_id, held.txt[:BATCH])


@pytest.fixture(scope="module")
def jax_models(config_path):
    """A JAX generator's random parameters and a random JAX InceptionV3."""
    from dwcgan_tpu.config import load_config as jax_load_config
    from dwcgan_tpu.eval import inception as jinc
    from dwcgan_tpu.train.state import build_models
    from dwcgan_tpu_torch.text.vocab import Vocab
    cfg = jax_load_config(config_path)
    gen, _ = build_models(cfg, Vocab(cfg.dataset).size)
    key = jax.random.PRNGKey(3)
    dummy = jnp.zeros((1, cfg.image_size, cfg.image_size, cfg.input_dim), jnp.float32)
    params = jax.jit(lambda k: gen.init({"params": k, "dropout": k}, dummy,
                                        deterministic=True))(key)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return cfg, gen, params, jax_variables(jinc.InceptionV3(), jnp.zeros((1, 299, 299, 3)), 0)


def _jax_row(jcfg, jgen, params, inc_vars, held):
    """The JAX tool's row (tools/quality_eval.py:121-146), unrounded."""
    from dwcgan_tpu.data.procedural import attribute_accuracy
    from dwcgan_tpu.eval.harness import compute_fid_is
    from dwcgan_tpu.ops import norms as jnorms
    from dwcgan_tpu.train.sampler import make_infer_fn
    try:
        infer = jax.jit(make_infer_fn(jcfg, jgen))
        n, b = len(held.reals), held.batch
        fakes = np.concatenate([np.asarray(infer(params, jnp.asarray(held.reals[i:i + b]),
                                                 jnp.asarray(held.txt[i:i + b]),
                                                 jnp.asarray(held.lens[i:i + b])),
                                           np.float32) for i in range(0, n, b)])
        acc = attribute_accuracy(fakes, held.trgs)
        fid = compute_fid_is((held.reals[i:i + b] for i in range(0, n, b)),
                             (fakes[i:i + b] for i in range(0, n, b)), inc_vars)
        rec = np.asarray(infer(params, jnp.asarray(held.reals[:b]),
                               jnp.asarray(held.txt_id), jnp.asarray(held.lens_id)),
                         np.float32)
    finally:
        jnorms.set_stats_mode("2pass")
    return {"fid_rel": float(fid["fid"]), "is_mean": float(fid["is_mean"]),
            "attr_transfer_acc": float(acc.mean()),
            "attr_acc_per_bit": [float(a) for a in acc],
            "nochange_recon_l1": float(np.abs(rec - held.reals[:b]).mean())}


def test_evaluate_row_matches_the_jax_tools(config_path, held, jax_models):
    from dwcgan_tpu_torch.eval.inception import InceptionV3
    from dwcgan_tpu_torch.interop.jax_params import load_jax_inception, load_jax_params
    from dwcgan_tpu_torch.models.generator import build_generator
    from dwcgan_tpu_torch.text.vocab import Vocab
    from dwcgan_tpu_torch.train.sampler import make_infer_fn
    jcfg, jgen, params, inc_vars = jax_models
    want = _jax_row(jcfg, jgen, params, inc_vars, held)
    cfg = load_config(config_path)
    gen = build_generator(cfg, Vocab(cfg.dataset).size, device="cpu")
    load_jax_params(gen, params)
    iv3 = InceptionV3()
    load_jax_inception(iv3, inc_vars)
    got = qe.evaluate(make_infer_fn(cfg, gen), iv3, held, rounded=False)
    print(f"port {got}\nJAX  {want}")
    assert got.keys() == want.keys()
    assert got["attr_acc_per_bit"] == want["attr_acc_per_bit"]
    assert got["attr_transfer_acc"] == want["attr_transfer_acc"]
    np.testing.assert_allclose(got["nochange_recon_l1"], want["nochange_recon_l1"],
                               rtol=RECON_RTOL)
    for k in ("fid_rel", "is_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_RTOL, err_msg=k)


def test_main_scores_each_checkpoints_ema_generator(config_path, tmp_path):
    from dwcgan_tpu_torch.cli import train
    from dwcgan_tpu_torch.eval.inception import init_random_inception
    from dwcgan_tpu_torch.models.generator import build_generator
    from dwcgan_tpu_torch.text.vocab import Vocab
    from dwcgan_tpu_torch.train.checkpoint import checkpoint_steps
    from dwcgan_tpu_torch.train.sampler import make_infer_fn
    run = tmp_path / "run"
    train.main(["--config", config_path, "--procedural_data", "--procedural_size", "16",
                "--max_steps", "2", "--output_path", str(run), "--device", "cpu"])
    ckpts = run / "outputs" / "quality" / "checkpoints"
    assert checkpoint_steps(str(ckpts)) == [1, 2]
    # the EMA copy of step 2 becomes another seed's generator: main's row
    # must be that generator's, not the live one's
    cfg = load_config(config_path)
    vocab = Vocab(cfg.dataset)
    path = ckpts / "ckpt_00000002.pt"
    ck = torch.load(path, weights_only=True)
    ck["ema_gen"] = build_generator(cfg, vocab.size, device="cpu", seed=5).state_dict()
    torch.save(ck, path)

    out = tmp_path / "artifacts"
    rows = qe.main(["--run_dir", str(run), "--config", config_path, "--n_eval",
                    str(N_EVAL), "--batch", str(BATCH), "--out", str(out),
                    "--device", "cpu"])
    assert [r["step"] for r in rows] == [1, 2]
    assert all(set(r) == ROW_KEYS for r in rows)
    trend = json.loads((out / "quality_trend.json").read_text())
    assert set(trend) == TREND_KEYS
    assert trend["results"] == rows and trend["n_eval"] == N_EVAL
    assert trend["seed"] == cfg.seed and trend["norm_stats"] == cfg.norm_stats
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("grid_")) == \
        ["grid_00000001.jpg", "grid_00000002.jpg"]

    # the row is the substituted EMA copy's, which is not the live one
    gen = build_generator(cfg, vocab.size, device="cpu")
    gen.load_state_dict(ck["ema_gen"])
    held = qe.held_out_set(cfg, N_EVAL, BATCH)
    assert rows[1] == {"step": 2, **qe.evaluate(make_infer_fn(cfg, gen),
                                                init_random_inception(0), held)}
    assert any(not torch.equal(ck["gen"][k], v) for k, v in ck["ema_gen"].items())
    # `--run_dir` may name the checkpoints' parent, as the JAX tool's, or the
    # training CLI's output path
    for run_dir in (run, ckpts.parent):
        assert qe.checkpoint_dir(str(run_dir), config_path) == str(ckpts)
