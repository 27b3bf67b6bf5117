"""Train cells: a closed loop over the port's trainer as
`cli/train.py::_train` runs it: `build_trainer`, then per step the next
batch of a `DataPipeline` over `CelebADataset` (the config's
`num_workers` threads decoding JPEGs), `to_device`, and the step.

Set-up: the CelebA-format files and the VGG16 weights in the cache (made
once per checkout), `build_trainer` with the benchmark's seeded weights
loaded into the nets and their EMA copies and the step's generator seeded
by the benchmark, the pipeline, and the first three steps, which are both
the warm-up and the steps the reference follows: their losses, Adam's
first moments after step 1 and the nets after step 3 are kept.
Window: steps back to back for the run's seconds, the host time of each
step's `next` + `to_device` kept (`feed_wait_ms`); it ends in a device
synchronize.  Traced run, after the window: a profiled slice of
`slice_units` steps.  Then the peak memory is read, the program freed, and
the plain reference decodes the same three batches from the files itself
(`reference/feed.py`) and runs the three steps on them in float32 (TF32
off).
"""

from __future__ import annotations

import gc
import time

import torch

from port_bench import compare
from port_bench.core import Run
from port_bench.reference import feed, nets, params
from port_bench.reference.step import Trainer
from port_bench.reference.vocab import Vocab as RefVocab
from port_bench.traffic import celeba_files
from port_bench.yardstick.trace import profile_slice

CHECK_STEPS = 3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _named(net, prefix):
    return {f"{prefix}.{k}": p for k, p in net.named_parameters()}


def _weights(run: Run, cfg_dict: dict, dev):
    w_seed = run.sub_seeds()[0]
    g = torch.Generator(device=dev).manual_seed(w_seed)
    gspecs = params.gen_specs(cfg_dict, RefVocab(cfg_dict["dataset"]).size)
    gw = params.make_weights(gspecs, g, dev)
    dw = params.make_weights(params.dis_specs(cfg_dict), g, dev)
    return gspecs, gw, dw


def reference_record(run: Run, batches, vgg_path: str, ops: nets.Ops) -> dict:
    """The reference's losses, first gradients and changes over the three
    check steps, from the same weights and generator seed, on the batches
    it decoded itself (`reference/feed.py`)."""
    dev = torch.device(run.device)
    cfg = run.config
    gspecs, gw, dw = _weights(run, cfg, dev)
    p0 = {**{f"gen.{k}": v for k, v in gw.items()}, **{f"dis.{k}": v for k, v in dw.items()}}
    vgg = params.load_vgg_npz(vgg_path, dev) if cfg["vgg_w"] > 0 else {}
    rng = torch.Generator(device=dev).manual_seed(run.sub_seeds()[1])
    trainer = Trainer(cfg, gw, dw, vgg, params.frozen_names(gspecs), rng, ops)
    rec = {"losses": []}
    with compare.plain_fp32():
        for i, (image, src, trg, txt, txt_len) in enumerate(batches):
            t = lambda a, dt=torch.float32: torch.as_tensor(a).to(dev, dt)
            losses = trainer.step(t(image), t(src), t(trg), t(txt, torch.long),
                                  torch.as_tensor(txt_len).long())
            rec["losses"].append({k: float(v) for k, v in losses.items()})
            if i == 0:
                rec["grad1"] = {k: v - cfg["weight_decay"] * p0[k]
                                for k, v in trainer.first_grads().items()}
    change = {}
    for net, live, ema in (("gen", trainer.G, trainer.ema_G), ("dis", trainer.D, trainer.ema_D)):
        for k in live:
            change[f"{net}.{k}"] = live[k].detach() - p0[f"{net}.{k}"]
            change[f"ema:{net}.{k}"] = ema[k] - p0[f"{net}.{k}"]
    rec["change3"] = change
    return rec


def run(run: Run) -> dict:
    from dwcgan_tpu_torch.cli.train import build_trainer
    from dwcgan_tpu_torch.config import config_from_dict
    from dwcgan_tpu_torch.data.celeba import CelebADataset
    from dwcgan_tpu_torch.data.pipeline import DataPipeline, to_device

    traffic = run.cell["traffic"]
    _, rng_seed, data_seed, _ = run.sub_seeds()
    dev = torch.device(run.device)
    cfg = config_from_dict(run.config)
    data = celeba_files.ensure(run.cache, traffic)
    cfg.data_root, cfg.attr_path = str(data / "images"), str(data / "list_attr_celeba.txt")
    vgg_path = params.vgg_npz(run.cache, traffic["vgg_seed"], dev) if cfg.vgg_w > 0 else ""
    cfg.vgg_model_path = vgg_path
    state, step_fn, _ = build_trainer(cfg, dev, seed=rng_seed)
    _, gw, dw = _weights(run, run.config, dev)
    for net, w in ((state.gen, gw), (state.ema_gen, gw), (state.dis, dw), (state.ema_dis, dw)):
        net.load_state_dict(w, strict=True)
    p0 = {**{f"gen.{k}": v for k, v in gw.items()}, **{f"dis.{k}": v for k, v in dw.items()}}
    state.rng.manual_seed(rng_seed)
    step_fn = run.wrap(step_fn)
    dataset = CelebADataset(cfg.data_root, cfg.attr_path, mode="train",
                            crop_size=cfg.crop_size, image_size=cfg.image_size,
                            max_text_len=cfg.max_text_len, seed=data_seed,
                            test_split=cfg.test_split)
    pipe = DataPipeline(dataset, cfg.batch_size, num_workers=cfg.num_workers, seed=data_seed)
    batches = iter(pipe)
    try:
        rec = _drive(run, cfg, state, step_fn, batches, to_device, dev, p0)
    finally:
        batches.close()
    del state, step_fn, gw, dw, p0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checked = feed.first_batches(cfg.data_root, cfg.attr_path, data_seed, cfg.test_split,
                                 cfg.batch_size, CHECK_STEPS, cfg.crop_size, cfg.image_size,
                                 cfg.max_text_len)
    ref = reference_record(run, checked, vgg_path, nets.Ops())
    rec["numbers"] = compare.train_numbers(rec.pop("prog"), ref)
    if run.control:
        ctl = reference_record(run, checked, vgg_path, nets.Ops(fp8=True))
        rec["control"] = compare.train_numbers(ctl, ref)
    return rec


def _drive(run, cfg, state, step_fn, batches, to_device, dev, p0) -> dict:
    """The three check steps, the window, the traced slice."""
    prog = {"losses": []}
    names = {**_named(state.gen, "gen"), **_named(state.dis, "dis")}
    opt_of = {id(p): opt for opt in (state.gen_opt, state.dis_opt)
              for group in opt.param_groups for p in group["params"]}
    for i in range(CHECK_STEPS):
        m = step_fn(state, to_device(next(batches), dev))
        prog["losses"].append({k: float(m[k]) for k in ("loss_gen_total", "loss_dis_all")})
        if i == 0:   # a leaf Adam holds no moment for took no step: zero
            first = lambda p: opt_of[id(p)].state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            prog["grad1"] = {k: first(p) / (1.0 - cfg.beta1) - cfg.weight_decay * p0[k]
                             for k, p in names.items() if id(p) in opt_of}
    change = {}
    for net, live, ema in (("gen", state.gen, state.ema_gen), ("dis", state.dis, state.ema_dis)):
        for (k, p), (_, e) in zip(live.named_parameters(), ema.named_parameters()):
            change[f"{net}.{k}"] = p.detach() - p0[f"{net}.{k}"]
            change[f"ema:{net}.{k}"] = e.detach() - p0[f"{net}.{k}"]
    prog["change3"] = change
    _sync(dev)

    feed_ms = []
    steps = 0
    t0 = time.perf_counter()
    while True:
        tf = time.perf_counter()
        b = to_device(next(batches), dev)
        feed_ms.append(1e3 * (time.perf_counter() - tf))
        step_fn(state, b)
        steps += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    _sync(dev)
    window = time.perf_counter() - t0
    rec = {"t0": t0, "window_s": window, "steps": steps, "units": steps, "images": steps * cfg.batch_size,
           "feed_wait_ms": feed_ms, "prog": prog,
           "attempted": steps * cfg.batch_size, "failed": 0}
    if run.trace:
        rec["trace"] = profile_slice(lambda: step_fn(state, to_device(next(batches), dev)),
                                     run.cell["traffic"]["slice_units"])
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    return rec
