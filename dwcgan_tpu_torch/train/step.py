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

On the card the shared step of one process (the nets on a CUDA device, no
process group: no `axis`, or the one-process `DataAxis` that `cli/train.py`
passes) runs as CUDA graphs (`StepGraphs`): each key (attention on, R1 on
this step, the batch's shapes) runs eagerly `WARM_STEPS` times, which
makes every lazy set-up (cuBLAS and cuDNN handles, Adam's state, the
kernels' one-time settings), is then captured once and replayed for every
later step of that key; the host issues a few launches a step instead of
thousands.  Every step of this path, eager or replayed, computes the same:
`lr` and `ds_w` are 0-d tensors on the card, filled before each step, Adam
runs in its capturable form, and the text encoder runs the text's full
width of steps, its lengths on the card (`MaskedBiLSTM.forward`).
`state.rng` is registered with each graph, so a replay draws what an eager
step would from the same generator state.  A graph is dropped when a tensor
it holds (a parameter, an EMA copy, an optimizer moment or count) or the
generator is replaced, as a checkpoint restore replaces the optimizer
state.  The CPU, a process group (data or model parallel) and the
non-shared step run eagerly as before; so does a step given `draws`.
`GRAPH_STEPS` counts the path's captures, replays and eager steps, as
`ops/cuda/kernels.py`'s `LAUNCHES` counts the kernels (a replay adds the
launches its capture recorded).

Spans (`utils/profiling.py`): `train.step` around either step (count
`graph`: 1 where the step replayed a graph, 0 where it ran eagerly),
holding `train.g_forward`, `train.d_update` (with `train.d_backward`, the
backward and its all-reduce, and `train.adam_d`), `train.g_update` (with
`train.g_backward` and `train.adam_g`) and `train.ema` on an eager step,
and `train.capture` (around the capture, whose recording runs those
phases once) on the step that captures.

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

import itertools
from collections import Counter
from typing import Dict, NamedTuple, Optional

import torch

from dwcgan_tpu_torch.config import Config
from dwcgan_tpu_torch.data.pipeline import Batch
from dwcgan_tpu_torch.losses.gan import (dis_loss, diversity_loss, gen_adv_loss,
                                         gradient_penalty, r1_penalty, recon_l1)
from dwcgan_tpu_torch.losses.gmm import gmm_emd, gmm_kl
from dwcgan_tpu_torch.ops.cuda import kernels
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

# the graphed step's captures, replays and eager steps in this process
GRAPH_STEPS = {"capture": 0, "replay": 0, "eager": 0}
WARM_STEPS = 2       # eager steps of a key before it is captured


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


def _apply(opt: torch.optim.Adam, lr) -> None:
    """One Adam step at `lr`; a parameter without a gradient takes a zero
    one, as every leaf of the JAX tree gets one (its coupled decay still
    applies).  `lr` a float, or a 0-d tensor on the card: Adam then runs in
    its capturable form (its counts on the card, nothing read back), which a
    CUDA graph can hold; each count moves to where the form keeps it."""
    capturable = torch.is_tensor(lr) and lr.is_cuda
    for group in opt.param_groups:
        group["lr"] = lr
        group["capturable"] = capturable
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            st = opt.state.get(p)
            if st and st["step"].is_cuda != capturable:
                st["step"] = st["step"].to(p.device if capturable else "cpu")
    opt.step()
    opt.zero_grad(set_to_none=True)


def graphed(cfg: Config, axis: Optional[DataAxis], device) -> bool:
    """Whether `make_train_step`'s step runs as CUDA graphs: the shared
    step (`fuse_gd_forward`, `n_critic` 1) of one process (no process
    group, so no collective: what `all_reduce_grads` observes), its nets on
    the card."""
    return (torch.device(device).type == "cuda" and (axis is None or not axis.grouped)
            and cfg.fuse_gd_forward and cfg.n_critic == 1)


class _Graph(NamedTuple):
    """One captured step: its graph, the fixed buffers it reads the batch
    from and writes the metrics to, and the kernel launches it holds."""
    graph: "torch.cuda.CUDAGraph"
    inputs: Batch
    outputs: Dict[str, torch.Tensor]
    launches: Dict[str, int]
    arith_launches: Dict[str, int]


def _held(state: TrainState):
    """What a captured step holds of `state`: the generator, and where
    every parameter, buffer and optimizer tensor lies."""
    nets = (state.gen, state.dis, state.ema_gen, state.ema_dis)
    ts = [t for m in nets for t in itertools.chain(m.parameters(), m.buffers())]
    ts += [v for opt in (state.gen_opt, state.dis_opt) for st in opt.state.values()
           for v in st.values() if torch.is_tensor(v)]
    return state.rng, [t.data_ptr() for t in ts]


class StepGraphs:
    """The shared step of one process on the card as CUDA graphs, one per
    key (module docstring).  `body(state, batch, att_on, r1, lr, ds_w,
    draws)` is the step's device work; it returns the metrics but
    `lr`."""

    def __init__(self, body, device: torch.device):
        self.body = body
        self.device = device
        self.stream = torch.cuda.Stream(device)   # the eager steps' and captures'
        self.lr = torch.zeros((), device=device)
        self.ds_w = torch.zeros((), device=device)
        self.graphs: Dict[tuple, _Graph] = {}
        self.warm: Counter = Counter()
        self.held = None

    def __call__(self, state: TrainState, batch, att_on: bool, r1: bool,
                 lr: float, ds_w: float, draws: Dict) -> Dict:
        if self.graphs and _held(state) != self.held:
            self.graphs.clear()
            self.warm.clear()
        key = (att_on, r1) + tuple((tuple(t.shape), t.dtype) for t in batch)
        graph = self.graphs.get(key)
        replay = not draws and (graph is not None or self.warm[key] >= WARM_STEPS)
        self.lr.fill_(lr)
        self.ds_w.fill_(ds_w)
        with span("train.step", graph=int(replay)):
            if not replay:
                GRAPH_STEPS["eager"] += 1
                self.warm[key] += not draws
                txt_len = batch.txt_len.to(self.device, non_blocking=True)
                return self._on_stream(state, batch._replace(txt_len=txt_len), att_on,
                                       r1, draws)
            if graph is None:
                graph = self.graphs[key] = self._capture(state, batch, att_on, r1)
            for dst, src in zip(graph.inputs, batch):
                dst.copy_(src, non_blocking=True)
            graph.graph.replay()
            GRAPH_STEPS["replay"] += 1
            for counts, add in ((kernels.LAUNCHES, graph.launches),
                                (kernels.ARITH_LAUNCHES, graph.arith_launches)):
                for k, v in add.items():
                    counts[k] += v
            return {k: v.clone() for k, v in graph.outputs.items()}

    def _on_stream(self, state, batch, att_on, r1, draws):
        """An eager step on the stream the captures use, so that what it
        sets up lazily is set up for them."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            metrics = self.body(state, batch, att_on, r1, self.lr, self.ds_w, draws)
        main.wait_stream(self.stream)
        return metrics

    def _capture(self, state, batch, att_on, r1) -> _Graph:
        """Record one step into a new graph (nothing runs: the caller
        replays it).  The launches the recording counted move to the
        graph, which adds them at each replay."""
        inputs = Batch(*(t.to(self.device, copy=True) for t in batch))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.rng)
        before = dict(kernels.LAUNCHES), dict(kernels.ARITH_LAUNCHES)
        with span("train.capture"):
            with torch.cuda.graph(graph, stream=self.stream):
                outputs = self.body(state, inputs, att_on, r1, self.lr, self.ds_w, {})
        GRAPH_STEPS["capture"] += 1
        moved = []
        for counts, old in zip((kernels.LAUNCHES, kernels.ARITH_LAUNCHES), before):
            moved.append({k: counts[k] - old[k] for k in old if counts[k] != old[k]})
            counts.update(old)
        self.held = _held(state)
        return _Graph(graph, inputs, outputs, *moved)


def make_train_step(cfg: Config, gen, dis, gen_opt, dis_opt, vgg_loss_fn=None,
                    _deterministic: bool = False, axis: Optional[DataAxis] = None):
    """Build step(state, batch, draws=None) -> metrics (module docstring).

    `gen`, `dis`, `gen_opt` and `dis_opt` are the ones `state` holds;
    `vgg_loss_fn`: (x, y) -> scalar perceptual loss, or None (term off);
    `axis`: the data axis of a data-parallel run (None: one process).  The
    shared step also carries `body(state, batch, att_on, r1, lr, ds_w,
    draws)`, its work on the device (what a graph holds)."""
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

    def dis_update(state: TrainState, batch, x_fake, x_fake1, lr, draws, r1):
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
            if r1:
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

    def ema(state):
        with span("train.ema"):
            ema_update(state.ema_gen, gen)
            ema_update(state.ema_dis, dis)

    def finish(state, metrics, lr):
        state.step += 1
        return all_reduce_metrics({**metrics, "lr": lr}, axis)

    def labels(batch):
        return batch.src_label * 2.0 - 1.0, batch.trg_label * 2.0 - 1.0

    def r1_now(step):
        return cfg.use_r1 and (step + 1) % cfg.d_reg_every == 0

    def shared(state: TrainState, batch, att_on, r1, lr, ds_w, draws) -> Dict:
        """The shared step's work on the device at these scalars (floats,
        or 0-d tensors on the card): every metric but `lr`."""
        c_src, c_trg = labels(batch)
        (x_fake, x_fake1, partial), aux = g_forward(state, batch, att_on, c_src,
                                                    c_trg, ds_w, draws)
        d_metrics = dis_update(state, batch, x_fake.detach(), x_fake1.detach(),
                               lr, draws, r1)
        g_metrics = g_update(state, batch, x_fake, x_fake1, partial, aux, lr)
        ema(state)
        return {**d_metrics, **g_metrics}

    dev = next(gen.parameters()).device
    graphs = StepGraphs(shared, dev) if graphed(cfg, axis, dev) else None

    def train_step_shared(state: TrainState, batch,
                          draws: Optional[Dict] = None) -> Dict:
        draws = draws or {}
        step = state.step
        att_on = cfg.gen.use_attention and step >= cfg.attention_warm_iter
        lr = sched(step)
        ds_w = max(cfg.ds_w - (step + 1) * 1e-5, 0.0)
        if graphs is None:
            with span("train.step", graph=0):
                metrics = shared(state, batch, att_on, r1_now(step), lr, ds_w, draws)
                return finish(state, metrics, lr)
        metrics = graphs(state, batch, att_on, r1_now(step), lr, ds_w, draws)
        metrics["ds_w"] = ds_w
        # the groups keep the float, as a checkpoint saves them (Adam read
        # the graphs' tensor)
        for opt in (gen_opt, dis_opt):
            for group in opt.param_groups:
                group["lr"] = lr
        return finish(state, metrics, lr)

    def train_step(state: TrainState, batch, draws: Optional[Dict] = None) -> Dict:
        with span("train.step", graph=0):
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
            d_metrics = dis_update(state, batch, x_fake, x_fake1, lr, draws,
                                   r1_now(step))
            if (step + 1) % cfg.n_critic == 0:
                gen_iter = step // cfg.n_critic
                ds_w = max(cfg.ds_w - (gen_iter + 1) * 1e-5, 0.0)
                (xf, xf1, partial), aux = g_forward(state, batch, att_on, c_src,
                                                    c_trg, ds_w, draws)
                g_metrics = g_update(state, batch, xf, xf1, partial, aux, lr)
            else:
                g_metrics = {k: torch.zeros((), device=x_real.device)
                             for k in GEN_METRIC_KEYS}
            ema(state)
            return finish(state, {**d_metrics, **g_metrics}, lr)

    if cfg.fuse_gd_forward and cfg.n_critic == 1:
        train_step_shared.body = shared
        return train_step_shared
    return train_step
