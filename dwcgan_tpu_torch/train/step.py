"""One training iteration (the counterpart of `dwcgan_tpu/train/step.py`).

`make_train_step(cfg, gen, dis, gen_opt, dis_opt, vgg_loss_fn)` returns
`step(state, batch, draws=None) -> metrics`, which updates `state` (the
nets, both optimizers, the EMA copies, the step count) in place.  With
`fuse_gd_forward` on and `n_critic == 1` it is `train_step_shared`
(step.py:366-440):

1. one G forward that keeps its graph: encode the real batch, text-encode
   the command, one decoder pass at 4n (reconstruction, text-guided fake,
   two GMM-sampled fakes), one re-encode at 3n, the cycle decode and the
   VGG term; every loss but the adversarial one;
2. the D update on the detached fakes, one multi-scale D pass at 3n;
3. G's adversarial head against the *updated* D, one pass at 2n, with D's
   parameters taking no gradient;
4. one G backward through the whole graph;
5. both Adam updates (lr from the global step), then EMA of both nets.

Otherwise it is the non-shared `train_step` (step.py:442-480): the D
update on fakes from its own no-grad G forward, then, every `n_critic`
steps, the full G update against the updated D.

Also as in JAX: the diversity weight decays by 1e-5 per G update and is
subtracted; attention blending starts at `attention_warm_iter`; R1 every
`d_reg_every` steps when `use_r1`, WGAN-GP when `gp_w > 0`; the metric
names are the JAX step's.  The random numbers come from `state.rng` (the
GMM style draws, the GP mixing weights and the dropout masks), or from
`draws` where a test injects the numbers JAX drew: "style1", "style2" (the
G forward), "d_style1" (the non-shared D phase), "gp_alpha".
`_deterministic` turns dropout off (the modules stay in train mode).

Metrics are 0-d tensors on the device (no host sync inside the step),
except `lr` and `ds_w`, which are Python floats.

Spans (`utils/profiling.py`): `train.step` around either step, holding
`train.g_forward`, `train.d_update` (with `train.d_backward`, the backward
and its all-reduce, and `train.adam_d`), `train.g_update` (with
`train.g_backward` and `train.adam_g`) and `train.ema`.

Data parallel (`axis`, a `parallel.mesh.DataAxis`): `batch` holds this
rank's rows of the global batch, every random draw is made at the global
batch and cut to them (`axis.rows`; the pass-batched calls at 3n, 4n and
2n keep their rows of each chunk), each net's gradients are averaged over
the ranks between its backward and its gradient norm (`all_reduce_grads`,
so the norm and Adam see the global gradient), and the returned metrics
are averaged (`all_reduce_metrics`).  Every loss term is a mean over the
batch's rows (`parallel/mesh.py`), so the ranks together take the step of
one process on the global batch.  EMA needs nothing: replicated weights
stay replicated.

Tensor parallel (the model axis of `axis`): the nets hold their shards
(`parallel/rules.py::shard_`) and their sharded layers issue the model
group's collectives in the forward and the backward; every rank of a
model group draws the same random numbers from the same rows, so
`state.rng` stays equal on them.  The gradient norms count a replicated
parameter once and sum the shards' squares over the model group
(`_global_norm`); Adam and EMA are elementwise and run on the shards.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dwcgan_tpu_torch.config import Config
from dwcgan_tpu_torch.losses.gan import (dis_loss, diversity_loss, gen_adv_loss,
                                         gradient_penalty, r1_penalty, recon_l1)
from dwcgan_tpu_torch.losses.gmm import gmm_emd, gmm_kl
from dwcgan_tpu_torch.parallel.mesh import (DataAxis, all_reduce_grads,
                                            all_reduce_metrics, draw)
from dwcgan_tpu_torch.parallel.tensor import all_reduce_sum
from dwcgan_tpu_torch.train.sampling import blend_attention, sample_style
from dwcgan_tpu_torch.train.schedules import lr_schedule
from dwcgan_tpu_torch.train.state import TrainState, ema_update
from dwcgan_tpu_torch.utils.profiling import span

GEN_METRIC_KEYS = (
    "loss_gen_total", "loss_gen_adv", "loss_gen_recon_x",
    "loss_gen_recon_c_real", "loss_gen_recon_c_fake", "loss_gen_recon_c_rand",
    "loss_gen_recon_s_real", "loss_gen_recon_s_fake", "loss_gen_recon_s_rand",
    "loss_gen_cycrecon_x", "loss_kl_x", "loss_kl_trg", "loss_gen_vgg",
    "loss_ds", "ds_w", "grad_gen_norm",
)


def _split_outs(outs, k):
    """Per-scale (src, cls) of a [k*n] D pass -> k lists of per-scale pairs."""
    parts = [(src.chunk(k), cls.chunk(k)) for src, cls in outs]
    return [[(src[i], cls[i]) for src, cls in parts] for i in range(k)]


def _global_norm(params) -> torch.Tensor:
    """The L2 norm of the gradients of `params`.  Under a model axis a
    replicated parameter counts once and the squared sum of the sharded
    ones' slices (`tp_shard`) is all-reduced over the model group before
    the root."""
    grads = [p.grad for p in params if p.grad is not None]
    sharded = [p for p in params if p.grad is not None and hasattr(p, "tp_shard")]
    if not sharded:
        return torch.nn.utils.get_total_norm(grads)
    rep = torch.nn.utils.get_total_norm([p.grad for p in params if p.grad is not None
                                         and not hasattr(p, "tp_shard")])
    part = torch.nn.utils.get_total_norm([p.grad for p in sharded])
    whole = all_reduce_sum(part.float().square(), sharded[0].tp_shard.mg,
                           "all_reduce_norm")
    return torch.sqrt(rep.float().square() + whole)


def _apply(opt: torch.optim.Adam, lr: float) -> None:
    """One Adam step at `lr`; a parameter without a gradient takes a zero
    one, as every leaf of the JAX tree gets one (its coupled decay still
    applies)."""
    for group in opt.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_train_step(cfg: Config, gen, dis, gen_opt, dis_opt, vgg_loss_fn=None,
                    _deterministic: bool = False, axis: Optional[DataAxis] = None):
    """Build step(state, batch, draws=None) -> metrics (module docstring).

    `gen`, `dis`, `gen_opt` and `dis_opt` are the ones `state` holds;
    `vgg_loss_fn`: (x, y) -> scalar perceptual loss, or None (term off);
    `axis`: the data axis of a data-parallel run (None: one process)."""
    if cfg.dis.norm == "bn":
        raise ValueError(
            "dis.norm='bn' is incompatible with the pass-batched step: "
            "batch-norm statistics would mix real and fake samples in the "
            "concatenated discriminator pass (use 'none', 'in' or 'ln')")
    for net in (gen, dis):
        net.set_norm_stats(cfg.norm_stats)
        net.set_norm_compute(cfg.norm_compute)
    gen.train()
    dis.train()
    gen.set_dropout(not _deterministic)
    C, stddev = cfg.c_dim, cfg.stddev
    sigma_sq = cfg.stddev ** 2
    sched = lr_schedule(cfg)
    use_vgg = vgg_loss_fn is not None and cfg.vgg_w > 0 and cfg.recon_x_cyc_w > 0
    # every parameter that takes a gradient, the frozen embedding included
    # (its gradient counts in grad_gen_norm, as in the JAX step)
    gen_params = [p for p in gen.parameters() if p.requires_grad]
    dis_params = [p for p in dis.parameters() if p.requires_grad]
    rows = axis.rows if axis is not None else None

    def chunk(t, k):
        return t.chunk(k) if t is not None else (None,) * k

    # ---------------- D update ----------------

    def dis_update(state: TrainState, batch, x_fake, x_fake1, lr, draws):
        with span("train.d_update"):
            x_real = batch.image
            n = x_real.shape[0]
            outs_real, outs_f, outs_f1 = _split_outs(
                dis(torch.cat([x_real, x_fake, x_fake1])), 3)
            args = (batch.src_label, cfg.dis.gan_type, cfg.dataset, cfg.gan_w,
                    cfg.cls_w)
            loss = dis_loss(outs_f, outs_real, *args) + dis_loss(outs_f1, outs_real, *args)
            metrics = {"loss_dis": loss.detach()}
            zero = torch.zeros((), device=x_real.device)
            src0 = lambda x: dis(x, multiscale=False)[0][0]
            loss_gp = zero
            if cfg.gp_w > 0:
                alpha = draws.get("gp_alpha")
                if alpha is None:
                    alpha = draw(torch.rand, (n, 1, 1, 1), state.rng, x_real.device,
                                 rows)
                x_hat = alpha * x_real + (1 - alpha) * x_fake
                loss_gp = gradient_penalty(src0, x_hat) * cfg.gp_w
                loss = loss + loss_gp
            metrics["loss_gp"] = loss_gp.detach()
            loss_r1 = zero
            if cfg.use_r1 and (state.step + 1) % cfg.d_reg_every == 0:
                loss_r1 = r1_penalty(src0, x_real) * 5.0   # 10 / 2 (solver.py:349)
                loss = loss + loss_r1
            metrics["loss_r1"] = loss_r1.detach()
            metrics["loss_dis_all"] = loss.detach()
            for p in dis_params:
                p.grad = None
            with span("train.d_backward"):
                loss.backward()
                all_reduce_grads(dis_params, axis)
            metrics["grad_dis_norm"] = _global_norm(dis_params)
            with span("train.adam_d"):
                _apply(dis_opt, lr)
            return metrics

    # ---------------- G forward (all but the adversarial head) ----------

    def g_forward(state, batch, att_on, c_src, c_trg, ds_w, draws):
        """((x_fake, x_fake1, partial_loss), aux metrics), differentiable in
        the generator's parameters."""
        with span("train.g_forward"):
            rng = state.rng
            x_real = batch.image
            n = x_real.shape[0]
            content_real, mu, logvar = gen.encode(x_real, rng, rows)
            style_real = mu.reshape(n, -1)
            mu_txt, logvar_txt = gen.encode_txt(style_real, batch.txt,
                                                batch.txt_len, rng, rows)
            style_txt = mu_txt.reshape(n, -1)
            style1 = sample_style(c_trg, C, stddev, draws.get("style1"), rng, rows)
            style2 = sample_style(c_trg, C, stddev, draws.get("style2"), rng, rows)

            # the four decodes share content_real: one decoder pass at 4n
            x4, att4 = gen.decode(content_real.repeat(4, 1, 1, 1),
                                  torch.cat([style_real, style_txt, style1, style2]))
            xr, xf, xf1, xf2 = x4.chunk(4)
            att_r, att_f, att_1, att_2 = chunk(att4, 4)
            x_real_rec = blend_attention(xr, att_r, x_real, att_on)
            x_fake = blend_attention(xf, att_f, x_real, att_on)
            x_fake1 = blend_attention(xf1, att_1, x_real, att_on)
            x_fake2 = blend_attention(xf2, att_2, x_real, att_on)
            loss_ds = diversity_loss(x_fake1, x_fake2)

            # re-encode {reconstruction, text-guided fake, sampled fake} at 3n
            content3, mu3, _ = gen.encode(torch.cat([x_real_rec, x_fake, x_fake1]),
                                          rng, rows)
            content_real_rec, content_fake_rec, content_rand = content3.chunk(3)
            mu_rec, mu_fake_rec, mu_rand = mu3.chunk(3)

            zero = torch.zeros((), device=x_real.device)
            loss_cyc, loss_vgg = zero, zero
            if cfg.recon_x_cyc_w > 0:
                xc, att_c = gen.decode(content_fake_rec, style_real)
                x_cycle = blend_attention(xc, att_c, x_real, att_on)
                loss_cyc = recon_l1(x_cycle, x_real)
                if use_vgg:
                    loss_vgg = vgg_loss_fn(x_real, x_cycle)

            loss_recon_x = recon_l1(x_real_rec, x_real)
            loss_recon_c_real = recon_l1(content_real_rec, content_real)
            loss_recon_c_fake = recon_l1(content_fake_rec, content_real)
            loss_recon_c_rand = recon_l1(content_rand, content_real)
            loss_recon_s_real = recon_l1(mu_rec, mu)
            loss_recon_s_fake = recon_l1(mu_fake_rec, mu_txt)
            loss_recon_s_rand = recon_l1(mu_rand.reshape(n, -1), style1)
            if cfg.dist_mode in ("kls", "kl"):
                loss_kl_x = gmm_kl(mu, logvar, c_src, sigma_sq)
                loss_kl_trg = gmm_kl(mu_txt, logvar_txt, c_trg, sigma_sq)
            else:
                loss_kl_x = gmm_emd(mu, c_src)
                loss_kl_trg = gmm_emd(mu_txt, c_trg)

            partial = (cfg.recon_x_w * loss_recon_x
                       + cfg.recon_c_w * (loss_recon_c_real + loss_recon_c_fake
                                          + loss_recon_c_rand)
                       + cfg.recon_s_w * (loss_recon_s_real + loss_recon_s_fake
                                          + loss_recon_s_rand)
                       + cfg.recon_x_cyc_w * loss_cyc
                       + cfg.kl_w * (loss_kl_x + loss_kl_trg)
                       + cfg.vgg_w * loss_vgg
                       - ds_w * loss_ds)
            aux = {
                "loss_gen_recon_x": loss_recon_x,
                "loss_gen_recon_c_real": loss_recon_c_real,
                "loss_gen_recon_c_fake": loss_recon_c_fake,
                "loss_gen_recon_c_rand": loss_recon_c_rand,
                "loss_gen_recon_s_real": loss_recon_s_real,
                "loss_gen_recon_s_fake": loss_recon_s_fake,
                "loss_gen_recon_s_rand": loss_recon_s_rand,
                "loss_gen_cycrecon_x": loss_cyc,
                "loss_kl_x": loss_kl_x,
                "loss_kl_trg": loss_kl_trg,
                "loss_gen_vgg": loss_vgg,
                "loss_ds": loss_ds,
            }
            aux = {k: v.detach() for k, v in aux.items()}
            aux["ds_w"] = ds_w
            return (x_fake, x_fake1, partial), aux

    def g_update(state, batch, x_fake, x_fake1, partial, aux, lr):
        """G's adversarial head on the (updated) D at 2n, one backward
        through the whole G graph, the Adam step."""
        with span("train.g_update"):
            for p in dis_params:
                p.requires_grad_(False)
            try:
                outs_f, outs_f1 = _split_outs(dis(torch.cat([x_fake, x_fake1])), 2)
            finally:
                for p in dis_params:
                    p.requires_grad_(True)
            adv = (batch.trg_label, cfg.dis.gan_type, cfg.dataset, cfg.gan_w,
                   cfg.cls_w)
            loss_adv = gen_adv_loss(outs_f, *adv) + gen_adv_loss(outs_f1, *adv)
            total = partial + loss_adv
            for p in gen_params:
                p.grad = None
            with span("train.g_backward"):
                total.backward()
                all_reduce_grads(gen_params, axis)
            metrics = {**aux, "loss_gen_adv": loss_adv.detach(),
                       "loss_gen_total": total.detach(),
                       "grad_gen_norm": _global_norm(gen_params)}
            with span("train.adam_g"):
                _apply(gen_opt, lr)
            return metrics

    def finish(state, d_metrics, g_metrics, lr):
        with span("train.ema"):
            ema_update(state.ema_gen, gen)
            ema_update(state.ema_dis, dis)
        state.step += 1
        return all_reduce_metrics({**d_metrics, **g_metrics, "lr": lr}, axis)

    def labels(batch):
        return batch.src_label * 2.0 - 1.0, batch.trg_label * 2.0 - 1.0

    def train_step_shared(state: TrainState, batch,
                          draws: Optional[Dict] = None) -> Dict:
        with span("train.step"):
            draws = draws or {}
            step = state.step
            att_on = cfg.gen.use_attention and step >= cfg.attention_warm_iter
            lr = sched(step)
            c_src, c_trg = labels(batch)
            ds_w = max(cfg.ds_w - (step + 1) * 1e-5, 0.0)
            (x_fake, x_fake1, partial), aux = g_forward(state, batch, att_on, c_src,
                                                        c_trg, ds_w, draws)
            d_metrics = dis_update(state, batch, x_fake.detach(), x_fake1.detach(),
                                   lr, draws)
            g_metrics = g_update(state, batch, x_fake, x_fake1, partial, aux, lr)
            return finish(state, d_metrics, g_metrics, lr)

    def train_step(state: TrainState, batch, draws: Optional[Dict] = None) -> Dict:
        with span("train.step"):
            draws = draws or {}
            step = state.step
            att_on = cfg.gen.use_attention and step >= cfg.attention_warm_iter
            lr = sched(step)
            c_src, c_trg = labels(batch)
            x_real = batch.image
            n = x_real.shape[0]
            with torch.no_grad():   # D's own fakes (solver.py:320-331)
                content, mu, _ = gen.encode(x_real, state.rng, rows)
                mu_txt, _ = gen.encode_txt(mu.reshape(n, -1), batch.txt,
                                           batch.txt_len, state.rng, rows)
                style1 = sample_style(c_trg, C, stddev, draws.get("d_style1"),
                                      state.rng, rows)
                x2, att2 = gen.decode(content.repeat(2, 1, 1, 1),
                                      torch.cat([mu_txt.reshape(n, -1), style1]))
                xf, xf1 = x2.chunk(2)
                att_f, att_f1 = chunk(att2, 2)
                x_fake = blend_attention(xf, att_f, x_real, att_on)
                x_fake1 = blend_attention(xf1, att_f1, x_real, att_on)
            d_metrics = dis_update(state, batch, x_fake, x_fake1, lr, draws)
            if (step + 1) % cfg.n_critic == 0:
                gen_iter = step // cfg.n_critic
                ds_w = max(cfg.ds_w - (gen_iter + 1) * 1e-5, 0.0)
                (xf, xf1, partial), aux = g_forward(state, batch, att_on, c_src,
                                                    c_trg, ds_w, draws)
                g_metrics = g_update(state, batch, xf, xf1, partial, aux, lr)
            else:
                g_metrics = {k: torch.zeros((), device=x_real.device)
                             for k in GEN_METRIC_KEYS}
            return finish(state, d_metrics, g_metrics, lr)

    if cfg.fuse_gd_forward and cfg.n_critic == 1:
        return train_step_shared
    return train_step
