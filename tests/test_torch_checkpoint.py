"""The port's checkpoints on the CPU (`configs/smoke.yaml` widths): a
round trip restores every tensor of the training state bit-equal (the
nets, the EMA copies, Adam's moments and counts, the step and the step's
random generator), the newest `max_to_keep` files stay, a checkpoint of
another run is refused, a save is written whole or not at all, and
`warm_start` copies what it should and nothing else."""

import os

import pytest
import torch

from dwcgan_tpu_torch.cli.train import build_trainer, synthetic_batches
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.train import checkpoint as ck
from dwcgan_tpu_torch.train.checkpoint import (CheckpointManager,
                                               checkpoint_header, warm_start)

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"


def _trained(steps=1, seed=None):
    cfg = load_config(CONFIG)
    state, step, vocab = build_trainer(cfg, "cpu", seed=seed)
    for b in synthetic_batches(cfg, "cpu", n=steps, seed=11):
        step(state, b)
    return cfg, state, vocab


def state_tensors(state):
    """A copy of every tensor of a TrainState, by name (the optimizers' by
    parameter position), with the step and the generator's state."""
    out = {"step": torch.tensor(state.step), "rng": state.rng.get_state()}
    for name in ("gen", "dis", "ema_gen", "ema_dis"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v.clone()
    for name in ("gen_opt", "dis_opt"):
        sd = getattr(state, name).state_dict()
        for i, s in sd["state"].items():
            for k, v in s.items():
                out[f"{name}.{i}.{k}"] = v.clone()
        out[f"{name}.groups"] = repr(sd["param_groups"])
    return out


def assert_same_state(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        if isinstance(ta[k], str):
            assert ta[k] == tb[k], k
        else:
            assert ta[k].dtype == tb[k].dtype and ta[k].device == tb[k].device, k
            assert torch.equal(ta[k], tb[k]), k


@pytest.fixture(scope="module")
def trained():
    return _trained(steps=2)


def test_round_trip_restores_every_tensor_bit_equal(trained, tmp_path):
    cfg, state, vocab = trained
    mgr = CheckpointManager(str(tmp_path), header=checkpoint_header(cfg, vocab.size, "smoke"))
    path = mgr.save(state)
    assert os.path.basename(path) == "ckpt_00000002.pt" and mgr.latest_step() == 2
    fresh = build_trainer(cfg, "cpu", seed=99)[0]
    assert not torch.equal(fresh.gen.enc_content.model[0].conv.weight,
                           state.gen.enc_content.model[0].conv.weight)
    assert mgr.restore(fresh) is fresh
    assert_same_state(fresh, state)
    # Adam's counts stay on the host, where Adam keeps them
    counts = [s["step"] for s in fresh.gen_opt.state.values()]
    assert counts and all(c.device.type == "cpu" and float(c) == 2 for c in counts)


def test_restored_generator_continues_the_draws(trained, tmp_path):
    cfg, state, vocab = trained
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    fresh = build_trainer(cfg, "cpu", seed=5)[0]
    mgr.restore(fresh)
    assert torch.equal(torch.randn(16, generator=fresh.rng),
                       torch.randn(16, generator=state.rng))


def test_max_to_keep_keeps_the_newest(trained, tmp_path):
    cfg, state, _ = trained
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    step0 = state.step
    try:
        for s in (3, 6, 9, 12):
            state.step = s
            mgr.save(state)
    finally:
        state.step = step0
    assert ck.checkpoint_steps(str(tmp_path)) == [9, 12]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000009.pt", "ckpt_00000012.pt"]


@pytest.mark.parametrize("field,value", [("vocab_size", 7), ("compute_dtype", "bfloat16"),
                                         ("config", "celeba_faces")])
def test_restore_refuses_another_runs_checkpoint(trained, tmp_path, field, value):
    cfg, state, vocab = trained
    header = checkpoint_header(cfg, vocab.size, "smoke")
    CheckpointManager(str(tmp_path), header=header).save(state)
    other = CheckpointManager(str(tmp_path), header={**header, field: value})
    with pytest.raises(ValueError, match=field):
        other.restore(build_trainer(cfg, "cpu")[0])
    # a header value of None is not checked (translate names no config)
    CheckpointManager(str(tmp_path), header={**header, "config": None}).restore(
        build_trainer(cfg, "cpu")[0])


def test_a_save_is_whole_or_absent(trained, tmp_path, monkeypatch):
    """A save that dies mid-write leaves the previous file the latest and
    no file under a checkpoint's name; a stray temporary file is no
    checkpoint."""
    cfg, state, _ = trained
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    real_save = torch.save

    def dying_save(obj, f):
        real_save({"half": torch.zeros(4)}, f)
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", dying_save)
    state.step += 1
    try:
        with pytest.raises(OSError, match="disk full"):
            mgr.save(state)
    finally:
        state.step -= 1
    assert mgr.latest_step() == state.step
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002.pt", "ckpt_00000003.pt.tmp"]
    with pytest.raises(FileNotFoundError):
        ck.checkpoint_file(str(tmp_path), state.step + 1)


def test_checkpoint_file_takes_a_directory_or_a_file(trained, tmp_path):
    cfg, state, _ = trained
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.checkpoint_file(str(tmp_path))
    path = CheckpointManager(str(tmp_path)).save(state)
    assert ck.checkpoint_file(str(tmp_path)) == path
    assert ck.checkpoint_file(path) == path
    assert ck.checkpoint_file(str(tmp_path), 2) == path


def test_warm_start_copies_all_but_the_embedding(trained, tmp_path):
    cfg, donor, _ = trained
    CheckpointManager(str(tmp_path)).save(donor)
    fresh = build_trainer(cfg, "cpu", seed=42)[0]
    before = state_tensors(fresh)
    emb = "enc_txt.embed_tokens.weight"
    assert warm_start(fresh, str(tmp_path)) is fresh
    for net in ("gen", "dis"):
        got, donor_sd = getattr(fresh, net).state_dict(), getattr(donor, net).state_dict()
        for name, _ in getattr(fresh, net).named_parameters():
            want = before[f"{net}.{name}"] if name == emb else donor_sd[name]
            assert torch.equal(got[name], want), (net, name)
    after = state_tensors(fresh)
    # EMA copies, optimizers, step and generator as they were
    for k in before:
        if not k.startswith(("gen.", "dis.")):
            assert (before[k] == after[k]) if isinstance(before[k], str) \
                else torch.equal(before[k], after[k]), k
    assert fresh.step == 0 and not fresh.gen_opt.state


def test_warm_start_skips_shape_mismatches(trained, tmp_path):
    """A donor of another generator width lends only the parameters whose
    shapes match; the others keep their own."""
    _, donor, _ = trained
    CheckpointManager(str(tmp_path)).save(donor)
    cfg = load_config(CONFIG)
    cfg.gen.dim = 16
    wide = build_trainer(cfg, "cpu", seed=42)[0]
    before = {k: v.clone() for k, v in wide.gen.state_dict().items()}
    warm_start(wide, str(tmp_path))
    donor_sd = donor.gen.state_dict()
    for name, p in wide.gen.named_parameters():
        if p.shape == donor_sd[name].shape and "embed_tokens" not in name:
            assert torch.equal(p, donor_sd[name]), name
        else:
            assert torch.equal(p, before[name]), name
    assert any(p.shape != donor_sd[n].shape for n, p in wide.gen.named_parameters())
