"""The plain reference of one DWC-GAN training iteration with the shared
generator forward (the step the recipe runs: `fuse_gd_forward` with one
discriminator update per generator update), over the nets of `nets.py`.

1. the generator forward: encode the real batch, text-encode the command,
   decode at 4n (reconstruction, text-guided fake, two GMM-sampled fakes),
   re-encode at 3n, the cycle decode and the VGG term; every loss but the
   adversarial one;
2. the discriminator update on the detached fakes at 3n: least-squares or
   other adversarial term per scale plus BCE on the real labels, Adam;
3. the generator's adversarial head against the updated discriminator at
   2n, the discriminator's parameters taking no gradient, one backward
   through the generator graph, Adam;
4. EMA (decay 0.999) of both nets.

Adam has coupled weight decay (torch's `weight_decay`), betas and eps
from the config, lr from the step schedule; a trainable leaf without a
gradient takes a zero one.  The random draws come from a `torch.Generator`
in the order the step draws them: the style encoder's mapping dropout at n,
the embedding dropout, the LSTM's inter-layer dropout, two GMM style draws,
the mapping dropout at 3n.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench.reference.nets import (Discriminator, Drop, Generator, Ops,
                                       VggLoss, blend)

EMA_DECAY = 0.999
MULTI_LABEL = ("CelebA", "CUB200")


def lr_at(cfg: dict, step: int) -> float:
    policy = cfg["lr_policy"]
    if policy == "const":
        return cfg["lr"]
    if policy == "step":
        return cfg["lr"] * cfg["gamma"] ** (step // cfg["step_size"])
    raise ValueError(f"lr_policy {policy!r} is not in the reference")


def adv_d(f, r, gan_type):
    if gan_type == "lsgan":
        return f.square().mean() + (r - 1.0).square().mean()
    if gan_type == "nsgan":
        return (F.binary_cross_entropy_with_logits(f, torch.zeros_like(f))
                + F.binary_cross_entropy_with_logits(r, torch.ones_like(r)))
    if gan_type == "wgan":
        return f.mean() - r.mean()
    raise ValueError(gan_type)


def adv_g(f, gan_type):
    if gan_type == "lsgan":
        return (f - 1.0).square().mean()
    if gan_type == "nsgan":
        return F.binary_cross_entropy_with_logits(f, torch.ones_like(f))
    if gan_type == "wgan":
        return -f.mean()
    raise ValueError(gan_type)


def cls_loss(logits, target, dataset):
    if dataset in MULTI_LABEL:
        return F.binary_cross_entropy_with_logits(logits, target)
    return F.cross_entropy(logits, target.long())


def gmm_kl(mu, logvar, means, sigma_sq):
    m = means[:, :, None]
    kl = 0.5 * (math.log(sigma_sq) - logvar
                + (logvar.exp() + (mu - m).square()) / sigma_sq - 1.0)
    return kl.sum(dim=2).mean(dim=0).sum()


def gmm_emd(mu, means):
    return (mu - means[:, :, None]).abs().sum(dim=2).mean(dim=0).sum()


def l1(a, b):
    return (a - b).abs().mean()


class Trainer:
    """The reference's training state and step: parameter dicts for G and
    D (trainable leaves require grad), their EMA copies, two Adams."""

    def __init__(self, cfg: dict, gen_w: Dict[str, torch.Tensor],
                 dis_w: Dict[str, torch.Tensor], vgg_w: Dict[str, torch.Tensor],
                 frozen, rng: torch.Generator, ops: Ops):
        self.cfg, self.ops, self.rng = cfg, ops, rng
        self.G = {k: v.detach().clone().requires_grad_(k not in frozen)
                  for k, v in gen_w.items()}
        self.D = {k: v.detach().clone().requires_grad_(True) for k, v in dis_w.items()}
        self.ema_G = {k: v.detach().clone() for k, v in gen_w.items()}
        self.ema_D = {k: v.detach().clone() for k, v in dis_w.items()}
        self.gen = Generator(cfg, self.G, ops)
        self.dis = Discriminator(cfg, self.D, ops)
        use_vgg = cfg["vgg_w"] > 0 and cfg["recon_x_cyc_w"] > 0
        self.vgg = VggLoss(vgg_w, ops) if use_vgg else None
        adam = dict(betas=(cfg["beta1"], cfg["beta2"]), eps=1e-8,
                    weight_decay=cfg["weight_decay"], lr=cfg["lr"])
        self.g_params = [v for v in self.G.values() if v.requires_grad]
        self.d_params = list(self.D.values())
        self.g_opt = torch.optim.Adam(self.g_params, **adam)
        self.d_opt = torch.optim.Adam(self.d_params, **adam)
        self.step_count = 0

    def _apply(self, opt, params: List[torch.Tensor], lr: float):
        for group in opt.param_groups:
            group["lr"] = lr
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        opt.zero_grad(set_to_none=True)

    def sample_style(self, means, device):
        n, k = means.shape
        eps = torch.randn((n, k, self.cfg["c_dim"]), generator=self.rng, device=device)
        return (means[:, :, None] + self.cfg["stddev"] * eps).reshape(n, -1)

    def step(self, image, src_label, trg_label, txt, txt_len) -> Dict[str, torch.Tensor]:
        """One iteration on a batch (NHWC image in [-1, 1], 0/1 labels,
        token ids, lengths on the host); returns its two losses.  Without
        a generator (`rng` None) dropout is off and the style draws come
        from torch's default generator (the FLOP count on the meta
        device)."""
        cfg, gen, dis = self.cfg, self.gen, self.dis
        step = self.step_count
        drop = Drop(self.rng) if self.rng is not None else None
        n = image.shape[0]
        att_on = cfg["gen"]["use_attention"] and step >= cfg["attention_warm_iter"]
        lr = lr_at(cfg, step)
        c_src, c_trg = src_label * 2.0 - 1.0, trg_label * 2.0 - 1.0
        ds_w = max(cfg["ds_w"] - (step + 1) * 1e-5, 0.0)
        sigma_sq = cfg["stddev"] ** 2
        gan, data = cfg["dis"]["gan_type"], cfg["dataset"]

        # the generator forward
        content, mu, logvar = gen.encode(image, drop)
        style_real = mu.reshape(n, -1)
        mu_txt, logvar_txt = gen.encode_txt(style_real, txt, txt_len, drop)
        style_txt = mu_txt.reshape(n, -1)
        style1 = self.sample_style(c_trg, image.device)
        style2 = self.sample_style(c_trg, image.device)
        x4, att4 = gen.decode(content.repeat(4, 1, 1, 1),
                              torch.cat([style_real, style_txt, style1, style2]))
        atts = att4.chunk(4) if att4 is not None else (None,) * 4
        xr, xf, xf1, xf2 = [blend(x, a, image, att_on) for x, a in zip(x4.chunk(4), atts)]
        loss_ds = (xf1 - xf2.detach()).abs().mean()
        content3, mu3, _ = gen.encode(torch.cat([xr, xf, xf1]), drop)
        c_rec, c_fake, c_rand = content3.chunk(3)
        mu_rec, mu_fake, mu_rand = mu3.chunk(3)
        zero = image.new_zeros(())
        loss_cyc = loss_vgg = zero
        if cfg["recon_x_cyc_w"] > 0:
            xc, att_c = gen.decode(c_fake, style_real)
            x_cycle = blend(xc, att_c, image, att_on)
            loss_cyc = l1(x_cycle, image)
            if self.vgg is not None:
                loss_vgg = self.vgg(image, x_cycle)
        if cfg["dist_mode"] in ("kls", "kl"):
            kl = gmm_kl(mu, logvar, c_src, sigma_sq) + gmm_kl(mu_txt, logvar_txt, c_trg, sigma_sq)
        else:
            kl = gmm_emd(mu, c_src) + gmm_emd(mu_txt, c_trg)
        partial = (cfg["recon_x_w"] * l1(xr, image)
                   + cfg["recon_c_w"] * (l1(c_rec, content) + l1(c_fake, content)
                                         + l1(c_rand, content))
                   + cfg["recon_s_w"] * (l1(mu_rec, mu) + l1(mu_fake, mu_txt)
                                         + l1(mu_rand.reshape(n, -1), style1))
                   + cfg["recon_x_cyc_w"] * loss_cyc + cfg["kl_w"] * kl
                   + cfg["vgg_w"] * loss_vgg - ds_w * loss_ds)

        # the discriminator update on the detached fakes
        outs = dis(torch.cat([image, xf.detach(), xf1.detach()]))
        loss_d = zero
        for fake in (1, 2):
            for src, cls in outs:
                s = src.chunk(3)
                loss_d = loss_d + adv_d(s[fake], s[0], gan) * cfg["gan_w"]
                loss_d = loss_d + cls_loss(cls.chunk(3)[0], src_label, data) * cfg["cls_w"]
        for p in self.d_params:
            p.grad = None
        loss_d.backward()
        self._apply(self.d_opt, self.d_params, lr)

        # the generator's adversarial head on the updated discriminator
        outs = dis(torch.cat([xf, xf1]), {k: v.detach() for k, v in self.D.items()})
        loss_adv = zero
        for fake in (0, 1):
            for src, cls in outs:
                loss_adv = loss_adv + adv_g(src.chunk(2)[fake], gan) * cfg["gan_w"]
                loss_adv = loss_adv + cls_loss(cls.chunk(2)[fake], trg_label, data) * cfg["cls_w"]
        total = partial + loss_adv
        for p in self.g_params:
            p.grad = None
        total.backward()
        self._apply(self.g_opt, self.g_params, lr)

        with torch.no_grad():
            for ema, live in ((self.ema_G, self.G), (self.ema_D, self.D)):
                for k in ema:
                    ema[k].lerp_(live[k], 1.0 - EMA_DECAY)
        self.step_count += 1
        return {"loss_gen_total": total.detach(), "loss_dis_all": loss_d.detach()}

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """After one step: each trainable leaf's gradient as Adam got it,
        worked out from its first moment, m1 / (1 - beta1) - wd * p0
        (`p0` the weights before the step, held by the caller: this
        returns m1 / (1 - beta1))."""
        out = {}
        for opt, named in ((self.g_opt, self.G), (self.d_opt, self.D)):
            for name, p in named.items():
                if p.requires_grad:
                    prefix = "gen." if named is self.G else "dis."
                    out[prefix + name] = opt.state[p]["exp_avg"] / (1.0 - self.cfg["beta1"])
        return out
