"""The port's offline tools against the JAX package's, on the CPU.

- `convert_vgg` and `convert_inception` write `.npz` files bit-equal, key
  for key, to the JAX tools' from the same fabricated torchvision `.pth`
  (torchvision's names and shapes, as tests/test_convert_weights.py
  fabricates them; the Inception one with `AuxLogits` tensors and
  `num_batches_tracked`); `load_converted` puts the trunk back exactly;
- `build_embeddings` writes the same pickle as JAX's from a tiny `.vec`,
  which the training CLI reads;
- `import_reference` on a seeded reference-layout `state_dict` with a
  nonzero `bias_hh` (`{'a': ...}`, `{'b': ...}`): at `configs/smoke.yaml`
  widths the imported generator matches JAX's `convert_reference_generator`
  (encode, encode_txt, decode, infer) within atol 1e-4 and the
  discriminator `convert_reference_discriminator` within 1e-5, the
  tolerances of tests/test_torch_generator.py and
  tests/test_torch_discriminator.py; its checkpoint serves through
  `translate --checkpoint`, resumes one step through `cli/train.py
  --resume 1` and evaluates through `cli/evaluate.py`, whose JSON line has
  the JAX CLI's five keys.
"""

import json
import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dwcgan_tpu.cli import build_embeddings as jax_embeddings
from dwcgan_tpu.cli import convert_inception as jax_conv_inception
from dwcgan_tpu.cli import convert_vgg as jax_conv_vgg
from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.interop.torch_import import (convert_reference_discriminator,
                                             convert_reference_generator)
from dwcgan_tpu.models.discriminator import MsImageDis as JaxDis
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.text.vocab import encode_commands
from dwcgan_tpu.train.sampler import make_infer_fn as jax_make_infer_fn
from dwcgan_tpu_torch.cli import (build_embeddings, convert_inception, convert_vgg,
                                  evaluate, import_reference, train, translate)
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.eval.inception import init_random_inception, InceptionV3
from dwcgan_tpu_torch.interop.jax_params import jax_inception_to_state_dict
from dwcgan_tpu_torch.interop.reference import reference_generator_state
from dwcgan_tpu_torch.models.discriminator import build_discriminator
from dwcgan_tpu_torch.models.generator import build_embedding_matrix, build_generator
from dwcgan_tpu_torch.models.vgg import LAYERS
from dwcgan_tpu_torch.text.vocab import Vocab

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
GEN_ATOL, DIS_ATOL = 1e-4, 1e-5
STEP = 3
COMMANDS = ["make her smile", "add glasses and remove the beard . make him older",
            "keep it unchanged!"]
VGG_TORCH_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def assert_npz_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert za.files == zb.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


# --------------------------------------------------------------- converters

def test_convert_vgg_writes_the_jax_tools_npz(tmp_path):
    rng = np.random.default_rng(0)
    sd, cin = {}, 3
    for (name, ch, _), idx in zip(LAYERS, VGG_TORCH_IDX):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(scale=0.05, size=(ch, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(scale=0.05, size=(ch,)).astype(np.float32))
        cin = ch
    sd["classifier.0.weight"] = torch.zeros(8, 16)      # ignored by both
    sd["classifier.0.bias"] = torch.zeros(8)
    torch.save(sd, tmp_path / "vgg16.pth")
    convert_vgg.convert(str(tmp_path / "vgg16.pth"), str(tmp_path / "port.npz"))
    jax_conv_vgg.convert(str(tmp_path / "vgg16.pth"), str(tmp_path / "jax.npz"))
    assert_npz_equal(tmp_path / "port.npz", tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as z:
        assert len(z.files) == 26 and z["conv1_1_kernel"].shape == (3, 3, 3, 64)


@pytest.fixture(scope="module")
def inception_pth(tmp_path_factory):
    """A torchvision-layout InceptionV3 `.pth`: the port's module with
    random weights and BN statistics, plus `AuxLogits` tensors and every
    `num_batches_tracked`, as torchvision ships them."""
    tmp = tmp_path_factory.mktemp("iv3")
    model = init_random_inception(1)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.add_(0.1 * torch.rand(buf.shape, generator=g))
    sd = dict(model.state_dict())
    for name in [k for k in sd if k.endswith(".bn.running_var")]:
        sd[name.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["AuxLogits.conv0.conv.weight"] = torch.ones(128, 768, 1, 1)
    sd["AuxLogits.conv0.bn.running_mean"] = torch.zeros(128)
    sd["AuxLogits.fc.weight"] = torch.ones(1000, 768)
    sd["AuxLogits.fc.bias"] = torch.zeros(1000)
    torch.save(sd, tmp / "iv3.pth")
    convert_inception.convert(str(tmp / "iv3.pth"), str(tmp / "iv3.npz"))
    return tmp, model


def test_convert_inception_writes_the_jax_tools_npz(inception_pth):
    tmp, _ = inception_pth
    jax_conv_inception.convert(str(tmp / "iv3.pth"), str(tmp / "jax.npz"))
    assert_npz_equal(tmp / "iv3.npz", tmp / "jax.npz")


def test_load_converted_restores_the_trunk(inception_pth):
    tmp, model = inception_pth
    loaded = convert_inception.load_converted(str(tmp / "iv3.npz"), InceptionV3())
    want = model.state_dict()
    got = loaded.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the JAX loader's tree, AuxLogits aside, is the same trunk
    tree = jax_conv_inception.load_converted(str(tmp / "iv3.npz"))["params"]
    tree.pop("AuxLogits")
    for k, v in jax_inception_to_state_dict(tree).items():
        np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)


def test_load_converted_is_strict(inception_pth, tmp_path):
    tmp, _ = inception_pth
    with np.load(tmp / "iv3.npz") as z:
        arrays = {k: z[k] for k in z.files if k != "Mixed_6c.branch7x7_2/bn_var"}
    np.savez(tmp_path / "short.npz", **arrays)
    with pytest.raises(RuntimeError, match="Missing key"):
        convert_inception.load_converted(str(tmp_path / "short.npz"), InceptionV3())


# --------------------------------------------------------------- embeddings

def test_build_embeddings_writes_the_jax_tools_pickle(tmp_path, capsys):
    vocab = Vocab("CelebA")
    rng = np.random.default_rng(3)
    words = [w for w in vocab.itos if w.isalpha()][:12] + ["zzz_decoy"]
    with open(tmp_path / "tiny.vec", "w") as f:
        f.write(f"{len(words)} 300\nbroken 1.0 2.0\n")
        for w in words + words[:2]:                 # repeats: the first wins
            f.write(w + " " + " ".join(f"{v:.7e}" for v in rng.normal(size=300)) + "\n")
    build_embeddings.build(str(tmp_path / "tiny.vec"), "CelebA", str(tmp_path / "port.npy"))
    jax_embeddings.build(str(tmp_path / "tiny.vec"), "CelebA", str(tmp_path / "jax.npy"))
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(":", 1)[1] == out[1].split(":", 1)[1]
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    table = train.load_pretrained_embeddings(str(tmp_path / "port.npy"))
    assert set(table) == set(words[:12])
    with open(tmp_path / "jax.npy", "rb") as f:
        want = pickle.load(f)
    for w in table:
        assert table[w].dtype == np.float32
        np.testing.assert_array_equal(table[w], want[w])
    mat = build_embedding_matrix(vocab, 300, table, seed=0)
    np.testing.assert_array_equal(mat[vocab.stoi[words[0]]], want[words[0]])


# ------------------------------------------------------------------- import

@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A seeded reference-layout generator and discriminator (the port's
    names; `bias_hh` nonzero), written as the reference saves them and
    imported at step 3 into `<out>/outputs/smoke/checkpoints`."""
    tmp = tmp_path_factory.mktemp("import")
    cfg = load_config(CONFIG)
    vocab = Vocab(cfg.dataset)
    g = torch.Generator().manual_seed(5)
    gen_sd = {k: v.clone() for k, v in
              build_generator(cfg, vocab.size, device="cpu", seed=21).state_dict().items()}
    for k in gen_sd:
        if "bias_hh" in k or "bias_ih" in k:
            gen_sd[k] = 0.3 * torch.randn(gen_sd[k].shape, generator=g)
    dis_sd = {k: v.clone() for k, v in
              build_discriminator(cfg, device="cpu", seed=22).state_dict().items()}
    for k in dis_sd:
        if k.endswith("bias"):
            dis_sd[k] = 0.1 * torch.randn(dis_sd[k].shape, generator=g)
    torch.save({"a": gen_sd}, tmp / "gen.pt")
    torch.save({"b": dis_sd}, tmp / "dis.pt")
    ckpts = tmp / "run" / "outputs" / "smoke" / "checkpoints"
    cfg_path = tmp / "smoke.yaml"
    with open(CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["data_root"] = str(tmp / "images")
    cfg_path.write_text(yaml.safe_dump(raw))
    path = import_reference.main(["--config", str(cfg_path), "--gen_pt", str(tmp / "gen.pt"),
                                  "--dis_pt", str(tmp / "dis.pt"), "--out", str(ckpts),
                                  "--step", str(STEP), "--device", "cpu"])
    return dict(tmp=tmp, cfg=cfg, cfg_path=str(cfg_path), vocab=vocab, gen_sd=gen_sd,
                dis_sd=dis_sd, ckpts=ckpts, path=path)


def test_import_folds_bias_hh_and_fills_the_checkpoint(imported):
    ck = torch.load(imported["path"], weights_only=True)
    assert ck["step"] == STEP and ck["header"]["config"] == "smoke"
    assert ck["gen_opt"]["state"] == {} and ck["dis_opt"]["state"] == {}
    sd = imported["gen_sd"]
    for name in ("gen", "ema_gen"):
        got = ck[name]
        assert got.keys() == sd.keys()
        for k, v in sd.items():
            if "bias_hh" in k:
                assert float(got[k].abs().max()) == 0.0, k
            elif "bias_ih" in k:
                want = v + sd[k.replace("bias_ih", "bias_hh")]
                assert torch.equal(got[k], want), k
            else:
                assert torch.equal(got[k], v), k
    for name in ("dis", "ema_dis"):
        for k, v in imported["dis_sd"].items():
            assert torch.equal(ck[name][k], v), k


def test_top_level_embedding_is_the_text_encoders():
    sd = {"embed_tokens.weight": torch.ones(3, 2),
          "enc_txt.embed_tokens.weight": torch.zeros(3, 2)}
    out = reference_generator_state(sd)
    assert list(out) == ["enc_txt.embed_tokens.weight"]
    assert torch.equal(out["enc_txt.embed_tokens.weight"], torch.ones(3, 2))


def test_import_refuses_another_config(imported, tmp_path):
    sd = dict(imported["gen_sd"])
    sd.pop("mlp.model.0.fc.bias")
    torch.save(sd, tmp_path / "gen.pt")
    with pytest.raises(RuntimeError, match="mlp.model.0.fc.bias"):
        import_reference.main(["--config", CONFIG, "--gen_pt", str(tmp_path / "gen.pt"),
                               "--out", str(tmp_path / "ck"), "--device", "cpu"])


def _inputs(cfg, vocab):
    rng = np.random.default_rng(9)
    s = cfg.image_size
    ids, lens = encode_commands(COMMANDS, vocab, cfg.max_text_len)
    return dict(images=rng.uniform(-1, 1, (3, s, s, 3)).astype(np.float32),
                ids=np.asarray(ids), lens=np.asarray(lens),
                style=rng.normal(size=(3, cfg.gen.style_dim)).astype(np.float32),
                content=rng.normal(size=(3, s // 4, s // 4, 4 * cfg.gen.dim)).astype(np.float32))


def test_imported_generator_matches_the_jax_reference_import(imported):
    cfg, vocab = imported["cfg"], imported["vocab"]
    gen = build_generator(cfg, vocab.size, device="cpu")
    translate.load_checkpoint(gen, cfg, vocab.size, str(imported["ckpts"]))
    jcfg = jax_load_config(CONFIG)
    params = convert_reference_generator(imported["gen_sd"], jcfg.gen, vocab.size)["params"]
    jgen = JaxGenerator(cfg=jcfg.gen, input_dim=jcfg.input_dim, vocab_size=vocab.size,
                        dtype=jnp.float32)
    inp = _inputs(jcfg, vocab)
    v = {"params": params}
    try:
        want = dict(
            encode=jgen.apply(v, inp["images"], method="encode"),
            encode_txt=jgen.apply(v, inp["style"], inp["ids"], inp["lens"],
                                  method="encode_txt"),
            decode=jgen.apply(v, inp["content"], inp["style"], method="decode"),
            infer=[jax_make_infer_fn(jcfg, jgen)(params, inp["images"], inp["ids"],
                                                 inp["lens"])])
    finally:
        jnorms.set_stats_mode("2pass")
    from dwcgan_tpu_torch.train.sampler import make_infer_fn
    t = {k: torch.from_numpy(a) for k, a in inp.items()}
    with torch.inference_mode():
        got = dict(encode=gen.encode(t["images"]),
                   encode_txt=gen.encode_txt(t["style"], t["ids"], t["lens"]),
                   decode=gen.decode(t["content"], t["style"]))
    got["infer"] = [make_infer_fn(cfg, gen)(t["images"], t["ids"], t["lens"])]
    for k in want:
        for g_, w_ in zip(got[k], want[k]):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=GEN_ATOL, rtol=0,
                                       err_msg=k)


def test_imported_discriminator_matches_the_jax_reference_import(imported):
    cfg = imported["cfg"]
    ck = torch.load(imported["path"], weights_only=True)
    dis = build_discriminator(cfg, device="cpu")
    dis.load_state_dict(ck["dis"])
    jcfg = jax_load_config(CONFIG)
    params = convert_reference_discriminator(imported["dis_sd"], jcfg.dis)["params"]
    images = np.random.default_rng(10).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    want = JaxDis(cfg=jcfg.dis, dtype=jnp.float32).apply({"params": params}, images, True)
    with torch.no_grad():
        got = dis(torch.from_numpy(images), True)
    assert len(got) == len(want) == 2
    for pair, wpair in zip(got, want):
        for g_, w_ in zip(pair, wpair):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=DIS_ATOL, rtol=0)


def _write_images(imported, n=5):
    d = imported["tmp"] / "images"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(11)
    names = [f"{i:06d}.png" for i in range(n)]
    for name in names:
        Image.fromarray(rng.integers(0, 256, (48, 44, 3), dtype=np.uint8)).save(d / name)
    return d, names


def test_imported_checkpoint_serves_and_resumes(imported):
    d, names = _write_images(imported)
    edits = imported["tmp"] / "edits.tsv"
    edits.write_text("".join(f"{n}\t{c}\n" for n, c in zip(names, COMMANDS)))
    out = imported["tmp"] / "edited"
    translate.main(["--config", imported["cfg_path"], "--checkpoint", str(imported["ckpts"]),
                    "--list", str(edits), "--image_dir", str(d), "--out_dir", str(out),
                    "--device", "cpu"])
    assert len(list(out.iterdir())) == 3
    state, metrics = train.main(["--config", imported["cfg_path"], "--output_path",
                                 str(imported["tmp"] / "run"), "--synthetic_data",
                                 "--resume", "1", "--max_steps", str(STEP + 1),
                                 "--device", "cpu"])
    assert state.step == STEP + 1
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert (imported["ckpts"] / f"ckpt_{STEP + 1:08d}.pt").exists()


def test_evaluate_cli_prints_the_five_keys(imported, inception_pth, capsys):
    d, names = _write_images(imported)
    tmp = imported["tmp"]
    (tmp / "trg.lst").write_text("\n".join(names[:4]) + "\n")
    (tmp / "s2t.lst").write_text("".join(f"{n}\t{c}\n" for n, c in
                                         zip(names[1:], COMMANDS * 2)))
    argv = ["--config", imported["cfg_path"], "--checkpoint",
            str(imported["path"]), "--real_list", str(tmp / "trg.lst"),
            "--src2trg_list", str(tmp / "s2t.lst"), "--batch_size", "3",
            "--device", "cpu"]
    capsys.readouterr()
    res = evaluate.main(argv + ["--inception", str(inception_pth[0] / "iv3.npz")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == res
    assert set(res) == {"fid", "is_mean", "is_std", "n_real", "n_fake"}
    assert (res["n_real"], res["n_fake"]) == (4, 4)
    assert all(math.isfinite(res[k]) for k in ("fid", "is_mean", "is_std"))
    res2 = evaluate.main(argv + ["--limit", "2", "--use_ema", "0"])
    assert "random-init extractor" in capsys.readouterr().out
    assert (res2["n_real"], res2["n_fake"]) == (2, 2)
