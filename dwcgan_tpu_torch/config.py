"""Validated, dataclass-based configuration (the PyTorch port's own copy).

The same dataclasses, defaults and validation as `dwcgan_tpu/config.py`, so
every file in `configs/` loads unchanged.  PyYAML is not assumed to be
installed: :func:`parse_yaml` reads the subset of YAML those files use
(scalars, one nested mapping level, `#` comments, null and booleans).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

_VALID_ACTIVATIONS = ("relu", "lrelu", "prelu", "selu", "tanh", "sigmoid", "none")
_VALID_PAD = ("zero", "reflect", "replicate")
_VALID_GAN = ("lsgan", "nsgan", "wgan")
_VALID_INIT = ("gaussian", "xavier", "kaiming", "orthogonal", "default")
_VALID_LR_POLICY = ("const", "step", "cosa")
_VALID_DIST_MODE = ("kls", "kl", "em")


@dataclass
class GenConfig:
    """Generator hyperparameters (reference: `configs/celeba_faces.yaml:44-60`)."""

    dim: int = 64                  # filters in bottommost conv layer
    mlp_dim: int = 256             # hidden width of the AdaIN-parameter MLP
    c_dim: int = 8                 # latent dims per attribute
    num_cls: int = 8               # number of attributes
    activ: str = "relu"
    style_downsample: int = 5      # stride-2 stages in the style encoder
    content_downsample: int = 2    # stride-2 stages in the content encoder
    n_res: int = 4                 # residual blocks in content encoder / decoder
    pad_type: str = "reflect"
    use_attention: bool = True
    embed_dim: int = 300           # word-embedding dim
    hidden_size: int = 300         # LSTM hidden size
    num_layers: int = 2            # LSTM layers
    dropout_in: float = 0.1
    dropout_out: float = 0.1
    use_map: bool = True           # 2-layer mapping MLP in the style encoder

    @property
    def style_dim(self) -> int:
        # reference: networks_v2.py:28
        return self.c_dim * self.num_cls

    def validate(self) -> None:
        assert self.activ in _VALID_ACTIVATIONS, f"bad activ {self.activ}"
        assert self.pad_type in _VALID_PAD, f"bad pad_type {self.pad_type}"
        assert self.style_downsample >= 2
        assert self.content_downsample >= 1
        assert self.num_layers >= 1


@dataclass
class DisConfig:
    """Discriminator hyperparameters (reference: `configs/celeba_faces.yaml:61-71`)."""

    dim: int = 64
    norm: str = "none"
    activ: str = "lrelu"
    n_layer: int = 5
    gan_type: str = "lsgan"
    num_scales: int = 2
    pad_type: str = "reflect"
    num_cls: int = 8
    image_size: int = 128
    dataset: str = "CelebA"

    def validate(self) -> None:
        assert self.gan_type in _VALID_GAN, f"bad gan_type {self.gan_type}"
        assert self.activ in _VALID_ACTIVATIONS
        assert self.pad_type in _VALID_PAD
        # every scale must survive n_layer stride-2 convs
        smallest = self.image_size // (2 ** (self.num_scales - 1))
        assert smallest // (2 ** self.n_layer) >= 1, (
            f"image_size {self.image_size} too small for "
            f"{self.num_scales} scales x {self.n_layer} layers"
        )


@dataclass
class Config:
    """Full experiment configuration.

    Field names track the reference YAML (`configs/celeba_faces.yaml`) so that
    file loads directly; extra TPU-first fields are documented inline.
    """

    dataset: str = "CelebA"

    # logger options
    image_save_iter: int = 10000
    image_display_iter: int = 500
    display_size: int = 8
    snapshot_save_iter: int = 10000
    log_iter: int = 100

    # optimization
    max_iter: int = 1_000_000
    batch_size: int = 16           # reference trains at 1 (`configs:13`); TPU wants >=8/chip
    weight_decay: float = 1e-4     # torch-style coupled L2 (added to grads pre-Adam)
    beta1: float = 0.5
    beta2: float = 0.999
    init: str = "kaiming"
    lr: float = 1e-4
    lr_policy: str = "step"
    step_size: int = 100_000
    ds_iter: int = 800_000
    eta_min: float = 0.0
    t_mult: int = 1
    gamma: float = 0.5
    stddev: float = 0.5            # GMM component stddev
    n_critic: int = 1              # D updates per G update (reference: train.py:31)

    # loss weights
    gan_w: float = 1.0
    cls_w: float = 1.0
    ds_w: float = 1.0
    kl_w: float = 0.1
    recon_x_w: float = 10.0
    recon_s_w: float = 1.0
    recon_c_w: float = 1.0
    recon_x_cyc_w: float = 10.0
    vgg_w: float = 0.1
    gp_w: float = 0.0
    use_r1: bool = False
    dist_w: float = 0.1
    dist_mode: str = "kls"

    c_dim: int = 8
    v_dim: int = 1

    gen: GenConfig = field(default_factory=GenConfig)
    dis: DisConfig = field(default_factory=DisConfig)

    # data options
    input_dim: int = 3
    num_workers: int = 2
    image_size: int = 128
    crop_size: int = 178
    data_root: str = "./datasets/celeba/images"
    attr_path: str = "./datasets/celeba/list_attr_celeba.txt"
    pretrained_embed: Optional[str] = "./datasets/embeddings.npy"
    use_pretrain: bool = False
    gen_pretrain: str = ""
    dis_pretrain: str = ""
    vgg_model_path: str = ""
    max_text_len: int = 80         # tokens before BOS/EOS (reference: celeba_data.py:98)
    test_split: int = 1999         # first N shuffled rows -> test (celeba_data.py:68)

    # --- TPU-first additions (no reference equivalent) ---
    seed: int = 1234               # reference: train.py:23
    compute_dtype: str = "bfloat16"   # conv/matmul compute dtype; params stay float32
    mesh_data: int = -1            # data-parallel axis size; -1 = all local devices
    mesh_model: int = 1            # model/tensor-parallel axis size
    d_reg_every: int = 16          # R1 cadence (reference: solver.py:54)
    ckpt_keep: int = 5             # orbax max_to_keep (reference keeps all)
    # Attention blending activates at iteration >= this (reference hardcodes
    # 10000 at solver.py:109-111; default keeps parity).  Consumed inside
    # the jitted step as a step-indexed predicate, so changing it never
    # retriggers compilation.
    attention_warm_iter: int = 10000
    # FiniteGuard (utils/guard.py) NaN-tripwire cadence/patience.  Checking
    # a metric forces a device->host scalar fetch, so `guard_every` trades
    # detection latency against sync cost: the worst case is
    # guard_every * guard_patience steps of NaN training before the trip
    # (e.g. 100 * 2 = 200 steps at the defaults).  guard_every 0 = follow
    # log_iter (those scalars are fetched for logging anyway).
    guard_every: int = 0
    guard_patience: int = 2
    # Fused Pallas instance/layer-norm kernels (ops/pallas/norm_kernels.py).
    # Default OFF: the round-3 A/B at batch 32 measured 136.2 img/s with
    # XLA-native norms vs 130.1 with the kernels (docs/PERF.md) — XLA's own
    # fusions beat the hand-written VMEM pass on this graph, and the 128px
    # decoder LayerNorm exceeds the kernel's VMEM tile anyway.  Kept as an
    # option (correctness pinned by tests/test_pallas_kernels.py) for
    # shapes/hardware where the balance differs.
    use_pallas: bool = False
    # Fused Pallas 7x7 stem kernel (ops/pallas/stem_kernels.py): the whole
    # reflect-pad + conv + instance-norm + ReLU encoder stem as ONE VMEM
    # pass per image with K=147 on the MXU reduction dim and a custom VJP
    # (the round-5 form of the stem lever after the pure-XLA parity
    # rewrites measured negative in-graph — docs/PERF.md).  Off by default
    # until/unless the on-chip A/B wins; correctness pinned by
    # tests/test_stem_kernels.py.
    stem_pallas: bool = False
    # Parity-space (space-to-depth) rewrites of the MXU-lane-starved
    # boundary convolutions: the 3-channel encoder/discriminator stems and
    # the decoder's narrow output head (ops/parity_conv.py).  Float-exact
    # up to reassociation (pinned in float64 by tests/test_parity_conv.py);
    # parameter tree unchanged.  Accepts False/"off", "stems", "head",
    # True/"all".  Default "head": the round-3 TPU A/B measured 137.7 img/s
    # (head) vs 136.2 (off) vs 133.0 (stems) at batch 32 — the head rewrite
    # sits at the graph edge and wins, while the stem rewrites' s2d
    # transposes break XLA's stem->instance-norm fusions and lose despite
    # winning standalone (docs/PERF.md).
    parity_convs: object = "head"
    # Instance/AdaIN/LayerNorm statistics strategy (ops/norms.py):
    # "2pass" = reference-exact mean-then-centered-variance (3 activation
    # reads per norm site); "1pass" = E[x^2]-mean^2 with fp32 accumulation
    # (2 reads — fewer HBM bytes on the bandwidth-saturated norm chains;
    # A/B + quality replication in docs/PERF.md).
    norm_stats: str = "2pass"
    # "fp32" = reference-parity normalize arithmetic; "bf16" = run the
    # (x-mean)*rstd[*scale+bias] chain in the activation dtype (stats stay
    # fp32-accumulated either way) — measured lever, ops/norms.py.
    norm_compute: str = "fp32"
    # share ONE generator forward between the D and G phases of the fused
    # step (n_critic == 1 only): D consumes stop-gradient'ed fakes from the
    # same forward whose vjp later backs G's update, instead of recomputing
    # encode + text-encode + a 2n decode with fresh dropout/style draws the
    # way the reference does (solver.py:320-331 vs :151-209).  Deliberate
    # deviation: D sees the *same* fake realizations G trains on that step.
    fuse_gd_forward: bool = True
    # rematerialize the generator/discriminator sub-passes in the fused step
    # (jax.checkpoint): recompute activations in the backward instead of
    # storing them — trades MXU headroom for HBM traffic on a
    # bandwidth-bound step (docs/PERF.md roofline)
    remat: bool = False
    # zero-egress fallback: when vgg_w > 0 but no converted weights exist,
    # use random-init VGG features so the training recipe (loss graph + cost)
    # still matches the reference (configs/celeba_faces.yaml:34 vgg_w: 0.1)
    vgg_random_fallback: bool = True

    def validate(self) -> "Config":
        assert self.init in _VALID_INIT
        assert self.lr_policy in _VALID_LR_POLICY
        assert self.dist_mode in _VALID_DIST_MODE
        assert self.batch_size >= 1
        assert self.n_critic >= 1
        assert self.compute_dtype in ("float32", "bfloat16")
        assert self.norm_stats in ("2pass", "1pass"), self.norm_stats
        assert self.norm_compute in ("fp32", "bf16"), self.norm_compute
        assert self.attention_warm_iter >= 0
        assert self.guard_every >= 0 and self.guard_patience >= 1
        self.gen.validate()
        self.dis.validate()
        assert self.gen.c_dim == self.c_dim
        assert self.dis.image_size == self.image_size
        return self

    @property
    def style_dim(self) -> int:
        return self.gen.style_dim

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _filter_fields(cls, raw: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """Build a validated Config from a (possibly reference-format) dict."""
    raw = dict(raw)
    gen = GenConfig(**_filter_fields(GenConfig, raw.pop("gen", {}) or {}))
    dis = DisConfig(**_filter_fields(DisConfig, raw.pop("dis", {}) or {}))
    cfg = Config(gen=gen, dis=dis, **_filter_fields(Config, raw))
    return cfg.validate()


_NULL = ("", "~", "null", "Null", "NULL")
_TRUE = ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")
_FALSE = ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF")
# YAML 1.1 number forms as PyYAML's resolver reads them (decimal only)
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "-.", "+."):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _strip_comment(line: str) -> str:
    # a '#' starts a comment at the line start or after whitespace, outside
    # a quoted scalar
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset of the repo's configs into a dict.

    Top-level `key: value` lines, and `key:` followed by indented
    `key: value` lines for one nested mapping (`gen:`, `dis:`).  Anything
    else (lists, flow style, anchors, multi-line scalars) raises ValueError.
    """
    out: Dict[str, Any] = {}
    nested: Optional[Dict[str, Any]] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indented = line[0] in " \t"
        key, sep, value = line.strip().partition(":")
        if not sep or not key or key[0] in "-[{&*!|>" or \
                (value and value[0] not in " \t"):
            raise ValueError(f"unsupported YAML at line {lineno}: {raw!r}")
        value = value.strip()
        if value[:1] in ("[", "{", "&", "*", "!", "|", ">"):
            raise ValueError(f"unsupported YAML at line {lineno}: {raw!r}")
        if indented:
            if nested is None:
                raise ValueError(f"unexpected indent at line {lineno}: {raw!r}")
            nested[key] = _scalar(value)
        elif value:
            out[key], nested = _scalar(value), None
        else:
            # a bare `key:` opens a nested mapping; left empty it is null
            nested = {}
            out[key] = nested
    return {k: (v if v != {} else None) for k, v in out.items()}


def load_config(path: str) -> Config:
    """Load a YAML config file (reference schema accepted unchanged)."""
    with open(path, "r", encoding="utf-8") as f:
        raw = parse_yaml(f.read())
    return config_from_dict(raw)
