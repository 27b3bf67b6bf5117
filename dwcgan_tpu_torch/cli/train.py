"""Training CLI of the port (the counterpart of `dwcgan_tpu/cli/train.py`).

    python -m dwcgan_tpu_torch.cli.train --config configs/celeba_faces.yaml \
        --procedural_data --output_path OUT [--resume 1] [--device cuda]
    python -m torch.distributed.run --nproc_per_node=N \
        -m dwcgan_tpu_torch.cli.train --config ... # data parallel, N cards
    python -m torch.distributed.run --nproc_per_node=N \
        -m dwcgan_tpu_torch.cli.train --config ... --mesh_model M
        # an N/M x M mesh: tensor parallel over M cards, data over N/M

Builds the generator and discriminator of `--config` in train mode with
random weights from the config's seed (the word embeddings from
`pretrained_embed` when that file exists and `--use_pretrained_embed` is
1, then frozen), both Adam optimizers, the EMA copies and the VGG16
perceptual loss (weights from `vgg_model_path`, or from
`OUT/models/vgg16.npz` when the config names none, as the JAX CLI; else
random-init under `vgg_random_fallback`), and trains on the device
(the card unless `--device cpu`) for `max_iter` steps (`--max_steps`).

Data: `--procedural_data` (label-controlled faces, `data/procedural.py`),
`--synthetic_data` (random images with synthesized commands), or CelebA
from `data_root` and `attr_path` (synthetic when the attribute file is
missing), fed by the threaded `DataPipeline` in a fixed order.

Outputs, as the JAX CLI's: `OUT/outputs/<name>/config.yaml`, the sample
grids from the EMA generator in `images/` (`train_current` every
`image_display_iter` steps; `test_<step>` and `train_<step>` every
`image_save_iter`, with `index.html`), one checkpoint file per
`snapshot_save_iter` steps in `checkpoints/`, and
`OUT/logs/<name>/metrics.jsonl` every `log_iter` steps; a clean end also
logs, draws `train_current`, writes `index.html` and saves a snapshot at
the last step where its cadence did not.
`--resume 1` restores the newest checkpoint, the step's random generator
included, and continues the data stream where it stopped: the run goes on
as if never interrupted.  With `use_pretrain`, `gen_pretrain` (a port
checkpoint) warm-starts the parameters.  FiniteGuard stops the run on
non-finite losses; StallWatchdog reports a stalled loop.

Data and tensor parallel (`parallel/mesh.py`): under
`torch.distributed.run` every rank joins the process group (NCCL, one card
a rank: `cuda:LOCAL_RANK`) and takes its place on the `mesh_data x
mesh_model` mesh (`mesh_data` -1: the world size over `mesh_model`;
`--mesh_model` overrides the config's).  A mesh smaller than the world
takes ranks 0 .. `mesh_data x mesh_model` - 1, as JAX takes the first
devices; every other rank creates the groups, writes nothing and exits 0.
`cfg.batch_size` is the global
batch; each rank's `DataPipeline` feeds its data index's share of every
global batch, the same rows to every rank of a model group.  The ranks of a
model group hold their shards of the tensor-parallel layers
(`parallel/rules.py`); the step averages the gradients and the metrics over
the data axis, so FiniteGuard and the final snapshot take the same
decision on every rank.  Only rank 0 writes the config copy, the metric
log, the sample grids, `index.html`, the snapshots and a profile; every
rank steps and takes part in each snapshot (the shards are gathered), and
every rank of rank 0's model group runs the EMA generator for a grid.
FID/IS evaluation is `cli/evaluate.py`.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil

import numpy as np
import torch

from dwcgan_tpu_torch.config import Config, load_config
from dwcgan_tpu_torch.data.pipeline import (Batch, DataPipeline, synthetic_batch,
                                            to_device)
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.models.generator import build_embedding_matrix
from dwcgan_tpu_torch.models.vgg import (Vgg16Features, init_random_vgg,
                                         load_vgg_npz, make_vgg_loss_fn)
from dwcgan_tpu_torch.parallel.mesh import (DataAxis, destroy,
                                            maybe_initialize_distributed)
from dwcgan_tpu_torch.parallel.rules import full_numel
from dwcgan_tpu_torch.text.vocab import Vocab
from dwcgan_tpu_torch.train.checkpoint import (CheckpointManager,
                                               checkpoint_header, warm_start)
from dwcgan_tpu_torch.train.sampler import make_sample_fn
from dwcgan_tpu_torch.train.state import create_train_state
from dwcgan_tpu_torch.train.step import make_train_step
from dwcgan_tpu_torch.utils.guard import FiniteGuard, StallWatchdog
from dwcgan_tpu_torch.utils.html import write_html_gallery
from dwcgan_tpu_torch.utils.images import save_image_grid
from dwcgan_tpu_torch.utils.logging import MetricWriter
from dwcgan_tpu_torch.utils.profiling import span
from dwcgan_tpu_torch.utils.timer import StepTimer

BATCH_POOL = 8
PROFILE_STEPS = (10, 20)   # --profile_dir traces these steps


def build_vgg_loss(cfg: Config, device, output_path: str = "."):
    """The perceptual loss of the recipe, or None when vgg_w is 0 or no
    weights exist and the random fallback is off.  The weights are
    `vgg_model_path`, or `<output_path>/models/vgg16.npz` when that is
    empty (`dwcgan_tpu/cli/train.py:148-169`; `cli/convert_vgg.py` writes
    the file)."""
    if cfg.vgg_w <= 0:
        return None
    vgg_path = cfg.vgg_model_path or os.path.join(output_path, "models", "vgg16.npz")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    vgg = Vgg16Features(dtype)
    if os.path.exists(vgg_path):
        load_vgg_npz(vgg, vgg_path)
        print(f"perceptual loss on (weights: {vgg_path})")
    elif cfg.vgg_random_fallback:
        init_random_vgg(vgg, cfg.seed)
        print(f"WARNING: vgg_w={cfg.vgg_w} but no weights at {vgg_path}; "
              "using RANDOM-INIT VGG features (vgg_random_fallback). "
              "Build real weights with cli.convert_vgg for paper parity.")
    else:
        print(f"vgg_w={cfg.vgg_w} but no weights at {vgg_path}; "
              "perceptual loss off (build with cli.convert_vgg)")
        return None
    return make_vgg_loss_fn(vgg.to(device), stats=cfg.norm_stats,
                            arith=cfg.norm_compute)


def build_trainer(cfg: Config, device="cuda", seed=None, embed_table=None,
                  output_path: str = ".", axis=None):
    """(state, step_fn, vocab): everything one training iteration needs.
    `embed_table` ([vocab, embed_dim]) is the frozen word embedding;
    `output_path` is where the VGG16 weights are looked for when the
    config names none (`build_vgg_loss`); `axis`: the mesh of a parallel
    run (its model axis shards the state)."""
    dev = resolve_device(device)
    with span("setup.build_trainer"):
        torch.manual_seed(cfg.seed if seed is None else seed)  # anything not given state.rng
        vocab = Vocab(cfg.dataset)
        state = create_train_state(cfg, vocab.size, device=dev, seed=seed,
                                   embed_table=embed_table, axis=axis)
        step_fn = make_train_step(cfg, state.gen, state.dis, state.gen_opt,
                                  state.dis_opt,
                                  vgg_loss_fn=build_vgg_loss(cfg, dev, output_path),
                                  axis=axis)
        return state, step_fn, vocab


def synthetic_batches(cfg: Config, device, n: int = BATCH_POOL, seed: int = 0):
    """`n` seeded synthetic batches of `cfg.batch_size`, on `device`."""
    return [to_device(synthetic_batch(cfg.batch_size, cfg.image_size,
                                      cfg.gen.num_cls, cfg.max_text_len,
                                      seed=seed + i, dataset=cfg.dataset), device)
            for i in range(n)]


def load_pretrained_embeddings(path):
    """{word: vector} from a pickled dict, an `.npz` of one array per word
    or a pickled object `.npy` (`dwcgan_tpu/cli/train.py:65-85`); None when
    the file is missing or unreadable.  Unpickling runs code: give it only
    files you made (`cli/build_embeddings.py`)."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (pickle.UnpicklingError, EOFError, ValueError, TypeError):
        pass
    try:
        data = np.load(path, allow_pickle=True)
    except (OSError, ValueError, pickle.UnpicklingError):
        print(f"could not read pretrained embeddings at {path}; ignoring")
        return None
    if hasattr(data, "files"):  # NpzFile: {word: vector} arrays
        return {k: data[k] for k in data.files}
    if data.dtype == object:
        return data.item()
    print(f"unrecognized embedding format at {path}; ignoring")
    return None


class SyntheticDataset:
    """Map-style dataset of single synthetic items, item i from seed i
    (`dwcgan_tpu/cli/train.py:88-100`)."""

    def __init__(self, cfg: Config, size: int = 4096):
        self.cfg, self.size = cfg, size

    def __len__(self):
        return self.size

    def __getitem__(self, i):
        b = synthetic_batch(1, self.cfg.image_size, self.cfg.gen.num_cls,
                            self.cfg.max_text_len, seed=i, dataset=self.cfg.dataset)
        return (b.image[0], b.src_label[0], b.trg_label[0], b.txt[0], b.txt_len[0])


def make_datasets(cfg: Config, args):
    """(train, test) datasets of the run, as the JAX CLI chooses them."""
    if args.procedural_data:
        from dwcgan_tpu_torch.data.procedural import ProceduralFaceDataset
        kw = dict(image_size=cfg.image_size, max_text_len=cfg.max_text_len,
                  dataset=cfg.dataset)
        return (ProceduralFaceDataset(n_samples=args.procedural_size,
                                      seed=cfg.seed, mode="train", **kw),
                ProceduralFaceDataset(n_samples=max(cfg.display_size, 512),
                                      seed=cfg.seed + 777, mode="test", **kw))
    if args.synthetic_data or not os.path.exists(cfg.attr_path):
        if not args.synthetic_data:
            print(f"attr file {cfg.attr_path} not found -> synthetic data")
        ds = SyntheticDataset(cfg)
        return ds, ds
    from dwcgan_tpu_torch.data.celeba import CelebADataset
    kw = dict(crop_size=cfg.crop_size, image_size=cfg.image_size,
              max_text_len=cfg.max_text_len, seed=cfg.seed,
              test_split=cfg.test_split)
    return (CelebADataset(cfg.data_root, cfg.attr_path, mode="train", **kw),
            CelebADataset(cfg.data_root, cfg.attr_path, mode="test", **kw))


def display_batch(ds, n: int) -> Batch:
    """The first `n` items of `ds`, the fixed batch of a sample grid."""
    items = [ds[i] for i in range(n)]
    return Batch(*(np.stack([it[k] for it in items]) for k in range(5)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="DWC-GAN training (PyTorch/CUDA port): one card, or data "
        "and tensor parallel over N cards under python -m torch.distributed.run "
        "--nproc_per_node=N (--mesh_model M: an N/M x M mesh). FID/IS "
        "evaluation of its checkpoints: python -m dwcgan_tpu_torch.cli.evaluate.")
    p.add_argument("--config", default="configs/celeba_faces.yaml")
    p.add_argument("--output_path", default=".")
    p.add_argument("--resume", type=int, default=0,
                   help="1: continue from the newest checkpoint")
    p.add_argument("--use_pretrained_embed", type=int, default=1,
                   help="1: word embeddings from the config's "
                        "pretrained_embed file when it exists (frozen)")
    p.add_argument("--n_critic", type=int, default=None,
                   help="override config n_critic")
    p.add_argument("--max_steps", type=int, default=None,
                   help="override config max_iter")
    p.add_argument("--synthetic_data", action="store_true",
                   help="train on synthetic items (no CelebA needed)")
    p.add_argument("--procedural_data", action="store_true",
                   help="train on procedural label-controlled faces "
                        "(data/procedural.py)")
    p.add_argument("--procedural_size", type=int, default=20000,
                   help="procedural dataset size (train split)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steps 10-20 here")
    p.add_argument("--mesh_model", type=int, default=None,
                   help="override the tensor-parallel axis size (the ranks "
                        "of one model group shard the widest layers)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Train as the module docstring says; returns (state, last metrics)."""
    args = parse_args(argv)
    dev = maybe_initialize_distributed(args.device)
    try:
        return _train(args, dev)
    finally:
        destroy()


def _train(args, dev):
    cfg = load_config(args.config)
    if args.n_critic is not None:
        cfg.n_critic = max(1, args.n_critic)
    if args.max_steps is not None:
        cfg.max_iter = args.max_steps
    if args.mesh_model is not None:
        cfg.mesh_model = args.mesh_model
    axis = DataAxis.from_config(cfg)
    lead = axis.rank == 0   # the rank that writes and prints
    renders = axis.data_rank == 0   # rank 0's model group runs the grids
    if lead:
        print(f"mesh: {dict(data=axis.data, model=axis.model)} over {axis.mesh} "
              "devices")
    if axis.idle:
        # outside a mesh smaller than the world, as JAX leaves the devices
        # past `data * model` unused: no trainer, no feed, no file
        print(f"rank {axis.rank} of {axis.world}: outside the {axis.data}x"
              f"{axis.model} mesh, idle")
        return None, {}

    vocab = Vocab(cfg.dataset)
    embed_table = None
    if args.use_pretrained_embed:
        pre = load_pretrained_embeddings(cfg.pretrained_embed)
        if pre is not None:
            embed_table = build_embedding_matrix(vocab, cfg.gen.embed_dim, pre,
                                                 seed=cfg.seed)
            print(f"loaded pretrained embeddings for vocab of {vocab.size}")
    state, step_fn, _ = build_trainer(cfg, dev, embed_table=embed_table,
                                     output_path=args.output_path, axis=axis)
    n_gen, n_dis = full_numel(state.gen), full_numel(state.dis)
    if lead:
        print(f"device {dev}; The number of parameters in G: {n_gen}")
        print(f"The number of parameters in D: {n_dis}")
    sample_fn = make_sample_fn(cfg, state.ema_gen)

    model_name = os.path.splitext(os.path.basename(args.config))[0]
    out_dir = os.path.join(args.output_path, "outputs", model_name)
    img_dir = os.path.join(out_dir, "images")
    log_dir = os.path.join(args.output_path, "logs", model_name)
    if lead:
        os.makedirs(img_dir, exist_ok=True)
        shutil.copy(args.config, os.path.join(out_dir, "config.yaml"))
    ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints"),
                             max_to_keep=cfg.ckpt_keep,
                             header=checkpoint_header(cfg, vocab.size, model_name),
                             axis=axis)
    if cfg.use_pretrain and cfg.gen_pretrain:
        warm_start(state, cfg.gen_pretrain)
        print("Initial model loaded...")
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        if lead:
            print(f"Resume from iteration {state.step}")

    dataset, test_dataset = make_datasets(cfg, args)
    # one global batch per step, this rank's share of it: a resumed run
    # takes up the stream where it stopped
    pipe = DataPipeline(dataset, axis.local_batch, num_workers=cfg.num_workers,
                        seed=cfg.seed, process_index=axis.data_rank,
                        process_count=axis.data, start=state.step)
    if renders:
        disp = to_device(display_batch(test_dataset, cfg.display_size), dev)
        disp_train = to_device(display_batch(dataset, cfg.display_size), dev)

    def render(tag, step_i, train=False):
        # under a model axis the EMA generator's forward is a collective of
        # the model group: all of rank 0's group runs it, rank 0 writes
        if not renders:
            return
        att_on = cfg.gen.use_attention and step_i >= cfg.attention_warm_iter
        d = disp_train if train else disp
        g = torch.Generator(device=dev).manual_seed(step_i)
        rows = sample_fn(d.image, d.txt, d.txt_len, att_on, generator=g)
        if lead:
            save_image_grid([r.cpu().numpy() for r in rows], cfg.display_size,
                            os.path.join(img_dir, f"{tag}.jpg"))

    writer = MetricWriter(log_dir) if lead else None
    guard = FiniteGuard(every=cfg.guard_every or cfg.log_iter,
                        patience=cfg.guard_patience)
    watchdog = StallWatchdog(timeout_s=300.0)
    profiler = None
    timer = StepTimer()
    timer.lap()
    metrics, logged_at = {}, state.step
    # the step of the newest snapshot, kept on the host: every rank of a
    # data axis then takes the same decision at the end, whatever the
    # directory holds by the time it looks
    saved_at = ckpt.latest_step() or 0
    batches = iter(pipe)
    try:
        # the host runs at most about one step ahead of the card: the
        # launch queue of one step fills it, so no explicit throttle
        for batch in batches:
            if state.step >= cfg.max_iter:
                break
            if lead and args.profile_dir and state.step == PROFILE_STEPS[0]:
                profiler = start_profiler(dev)
            metrics = step_fn(state, to_device(batch, dev))
            step_i = state.step          # steps done
            if profiler is not None and step_i >= PROFILE_STEPS[1]:
                stop_profiler(profiler, args.profile_dir)
                profiler = None
            # NaN tripwire: reads the metrics only on its own cadence (the
            # ranks' averaged metrics: every rank stops at the same step)
            guard.check(step_i, metrics, checkpoint=ckpt, state=state)
            if lead and (step_i % cfg.log_iter == 0 or step_i == cfg.max_iter):
                dt = timer.lap(metrics["loss_gen_total"])
                sps = (step_i - logged_at) / dt if dt > 0 else 0.0
                logged_at = step_i
                writer.write(step_i, {**metrics, "steps_per_sec": sps,
                                      "images_per_sec": sps * cfg.batch_size})
                print(f"Iteration: {step_i:08d}/{cfg.max_iter:08d} "
                      f"gen {float(metrics['loss_gen_total']):.4f} "
                      f"dis {float(metrics['loss_dis_all']):.4f} "
                      f"lr {float(metrics['lr']):.6g} {sps:.2f} it/s", flush=True)
            if step_i % cfg.image_display_iter == 0:
                render("train_current", step_i - 1)
            if step_i % cfg.image_save_iter == 0:
                render(f"test_{step_i:08d}", step_i - 1)
                render(f"train_{step_i:08d}", step_i - 1, train=True)
                if lead:
                    write_html_gallery(os.path.join(out_dir, "index.html"),
                                       step_i, cfg.image_save_iter)
            if step_i % cfg.snapshot_save_iter == 0:
                ckpt.save(state)
                saved_at = step_i
            watchdog.beat(step_i)
        # a clean end only (a tripped guard's state is not saved): the
        # last step's snapshot, grid and gallery, where its cadence did not
        # already make them
        if saved_at < state.step:
            ckpt.save(state)
        if state.step % cfg.image_display_iter:
            render("train_current", state.step - 1)
        if lead:
            write_html_gallery(os.path.join(out_dir, "index.html"), state.step,
                               cfg.image_save_iter)
            print("Finish training")
    finally:
        batches.close()          # stops the pipeline's workers
        watchdog.stop()
        if profiler is not None:
            stop_profiler(profiler, args.profile_dir)
        if writer is not None:
            writer.close()
    return state, metrics


def start_profiler(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profiler(prof, out_dir: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


if __name__ == "__main__":
    main()
