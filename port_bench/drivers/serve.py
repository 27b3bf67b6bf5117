"""Serve cells: one client in a closed loop over the port's
`cli/translate.py::translate_batch` (host images and commands in, edited
images copied back to the host), at the cell's batch size.

Set-up: the generator of the configuration (`build_generator`), the
benchmark's seeded weights loaded into it, `make_infer_fn`, the request
pool, and `warmup` pool batches served once.
Window: batches back to back for the run's seconds (a closed loop of one
client); every request's host latency; a seeded reservoir of
`check_batches` finished batches is kept.
Traced run, after the window: the text encoder timed alone on the pool
(synchronised, `encode_txt_ms`), then a profiled slice of `slice_units`
batches.  Then the peak memory is read, the program freed, and the plain
reference translates the kept batches in float32 (TF32 off).
"""

from __future__ import annotations

import gc
import random
import time

import torch

from port_bench import compare
from port_bench.core import Run
from port_bench.reference import nets, params
from port_bench.reference.vocab import Vocab as RefVocab, encode_commands as ref_encode
from port_bench.traffic.requests import request_pool
from port_bench.yardstick.trace import profile_slice


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reference_outputs(run: Run, pool, kept, ops: nets.Ops) -> dict:
    """{batch index: reference output} of the kept batches."""
    w_seed = run.sub_seeds()[0]
    dev = torch.device(run.device)
    vocab = RefVocab(run.config["dataset"])
    specs = params.gen_specs(run.config, vocab.size)
    w = params.make_weights(specs, torch.Generator(device=dev).manual_seed(w_seed), dev)
    gen = nets.Generator(run.config, w, ops)
    out = {}
    with compare.plain_fp32():
        for i in kept:
            imgs, cmds = pool[i % len(pool)]
            ids, lens = ref_encode(cmds, vocab, run.config["max_text_len"])
            x = torch.from_numpy(imgs).to(dev)
            out[i] = nets.translate(gen, x, torch.from_numpy(ids).to(dev),
                                    torch.from_numpy(lens)).cpu()
    return out


def run(run: Run) -> dict:
    from dwcgan_tpu_torch.cli.translate import translate_batch
    from dwcgan_tpu_torch.config import config_from_dict
    from dwcgan_tpu_torch.models.generator import build_generator
    from dwcgan_tpu_torch.text.vocab import Vocab, encode_commands
    from dwcgan_tpu_torch.train.sampler import make_infer_fn

    traffic = run.cell["traffic"]
    w_seed, _, req_seed, sample_seed = run.sub_seeds()
    cfg = config_from_dict(run.config)
    dev = torch.device(run.device)
    vocab = Vocab(cfg.dataset)
    gen = build_generator(cfg, vocab.size, device=dev)
    specs = params.gen_specs(run.config, RefVocab(cfg.dataset).size)
    weights = params.make_weights(specs, torch.Generator(device=dev).manual_seed(w_seed), dev)
    gen.load_state_dict(weights, strict=True)
    del weights
    infer = run.wrap(make_infer_fn(cfg, gen))
    pool = request_pool(traffic, cfg.image_size, req_seed)

    def serve(i):
        imgs, cmds = pool[i % len(pool)]
        return translate_batch(infer, imgs, cmds, vocab, cfg.max_text_len, dev).cpu().numpy()

    for i in range(min(len(pool), traffic["warmup"])):
        serve(i)
    _sync(dev)

    # the window: a closed loop of one client
    k = traffic["check_batches"]
    pick = random.Random(sample_seed)
    kept, latencies = {}, []
    i = 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        out = serve(i)
        t = time.perf_counter()
        latencies.append(t - ts)
        # reservoir sample of k finished batches
        if i < k:
            kept[i] = out
        else:
            j = pick.randrange(i + 1)
            if j < k:
                kept.pop(sorted(kept)[j])
                kept[i] = out
        i += 1
        if t - t0 >= run.seconds:
            break
    served = i
    rec = dict(t0=t0, window_s=t - t0, batches=served, units=served,
               images=served * traffic["batch"], latencies=latencies)

    if run.trace:
        ms = []
        with torch.inference_mode():
            for imgs, cmds in pool:
                ids, lens = encode_commands(cmds, vocab, cfg.max_text_len)
                x = torch.from_numpy(imgs).to(dev)
                _, mu, _ = gen.encode(x)
                style = mu.reshape(mu.shape[0], -1)
                ids = torch.from_numpy(ids).to(dev)
                lens = torch.from_numpy(lens)
                _sync(dev)
                ts = time.perf_counter()
                gen.encode_txt(style, ids, lens)
                _sync(dev)
                ms.append(1e3 * (time.perf_counter() - ts))
        rec["encode_txt_ms"] = ms
        counter = iter(range(10 ** 9))
        rec["trace"] = profile_slice(lambda: serve(next(counter)), traffic["slice_units"])
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    del gen, infer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_outputs(run, pool, sorted(kept), nets.Ops())
    x_of = lambda b: torch.from_numpy(pool[b % len(pool)][0])
    rec["numbers"] = {"edit_rel_err": max(
        compare.edit_rel_err(torch.from_numpy(out), ref[b], x_of(b)) for b, out in kept.items())}
    if run.control:
        ctl = reference_outputs(run, pool, sorted(kept), nets.Ops(fp8=True))
        rec["control"] = {"edit_rel_err": max(
            compare.edit_rel_err(ctl[b], ref[b], x_of(b)) for b in kept)}
    rec["attempted"], rec["failed"] = served * traffic["batch"], 0
    return rec
