#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`dwcgan_tpu_torch`).

    python3 chip_smoke.py          # from the root of a checkout, one H100

Phases (any failure exits non-zero; nothing is caught and carried on):

1. card: name and power limit from nvidia-smi; build the norm kernels from
   `dwcgan_tpu_torch/csrc/` with nvcc and print the build seconds;
2. kernels: each of the four hand-written kernels at every shape the
   serving path gives it (batch 32), in fp32 and bf16 and in both stats
   modes, against its plain PyTorch version on the card; kernel, plain and
   library (F.instance_norm, for IN and AdaIN) device times (20 calls in a
   CUDA graph, CUDA events, cold L2) beside the bytes bound, and the
   kernel's eager time (wrapper included); the reference LayerNorm has no
   library call, and logs the nearest one, F.group_norm(x, 1, gamma, beta),
   as `nearest_call_ms`; each (rows 1-4, one cluster kernel per call) also
   runs twice (bit-equal, y and the statistics), must be one CUDA kernel a
   call (the kernel nodes of a CUDA graph of one call), and logs its plan
   (blocks per sample, shared memory, resident share of a slab, clusters
   that fit);
3. the slice in fp32 on the card (kernels) against the CPU (plain
   versions), flagship width, 4 images, TF32 off: max abs diff <= 2e-3;
4. the slice at flagship width in bf16 (`configs/celeba_faces.yaml`, batch
   32, synthesized commands) through `translate_batch`: launch counts of
   exactly 11 IN, 4 AdaIN+ReLU, 4 AdaIN-residual and 2 LayerNorm per batch,
   finite output in [-1, 1], images/s and peak memory;
5. backward kernels: each of the three hand-written backward kernels (four
   counters: AdaIN's serves the residual form too) at every shape the
   flagship training step gives it, in fp32 and bf16 and both stats modes,
   against its plain PyTorch backward on the card (dx and the parameter
   gradients), run twice (bit-equal), after the forward kernel at the same
   shape against its plain forward with phase 2's tolerance (and timed
   there, as phase 2 times it: rows 1-4 per training step, with phase 2's
   checks of rows 1-4 as `fwd_*` keys); times and bound
   as in phase 2, the bound counting x and the incoming gradient read once
   and dx written once; the library time for the instance norm and AdaIN is
   the backward of `F.instance_norm` (no ReLU; AdaIN as one call on x
   viewed as [1, N*C, H, W]) through `torch.autograd.grad(...,
   retain_graph=True)`, timed eagerly, and the LayerNorm's nearest call
   the backward of F.group_norm(x, 1, gamma, beta), the same way; the CUDA
   kernels one call launches (the kernel nodes of a CUDA graph of one
   call: each backward must be one, its cluster kernel), with that
   kernel's plan (blocks per sample, shared memory, resident share of a
   slab, clusters that fit) and, at a ReLU site, the elements where the
   mask it recomputes from x differs from the forward's y > 0 (must be
   0);
6. one fp32 training step at flagship width (batch 2, VGG on, TF32 off,
   dropout off, the same weights and injected style draws) on the card
   against the CPU: every loss metric and both gradient norms within
   rtol 1e-3; prints the CPU step's seconds;
7. the flagship training step (bf16, batch 16, 1pass, VGG on) through
   `cli/train.py`'s `build_trainer`: exact launches per step (forward IN 24,
   AdaIN 8, AdaIN-residual 8, LayerNorm 4; backward 23 / 8 / 8 / 4), and
   per backward site how often the incoming gradient had to be copied into
   the kernels' layout; finite losses, parameters and EMA moved; 3 warm-up
   steps, then 12 steps timed by CUDA events: median, min and max ms per
   step, images/s, peak memory.

8. stem kernels: the fused 7x7 stem forward and backward at every stem
   site of the stem-on paths (content: IN + ReLU, style: ReLU; [32, 3, 128,
   128] serving, [16, ...] and [48, ...] training, C 64, reflect; the
   backward without dx at 16, with it at 48), fp32 and bf16, both stats
   modes where there is a norm, against the plain versions on the card (y
   as phase 2, dx / dW / db as phase 5, the ReLU mask from the kernel's own
   output), then the three pad types at one small ragged shape; kernel,
   eager, plain and library times (the library: cuDNN's `F.conv2d` with
   bias on the reflect-padded image and its backward, without the pad, the
   norm and the ReLU) beside the bound (bytes or operations); first it
   counts the HMMA (tensor-core) instructions in the SASS of the stem's
   bf16 kernels (cuobjdump: the conv tile that every forward pass and the
   backward's recompute passes run, dW and dX) and fails if one has none;
9. serving with `stem_pallas` on: fp32 card vs CPU as phase 3, then bf16 at
   batch 32 with exactly 2 stem, 10 IN, 4 AdaIN, 4 AdaIN-residual and 2
   LayerNorm launches per batch, timed as phase 4;
10. training with `stem_pallas` on: the fp32 step card vs CPU as phase 6,
   then the bf16 step at batch 16 with exact launches per step (forward
   stem 4, IN 22, AdaIN 8 / 8, LayerNorm 4; backward stem 4, IN 21, 8 / 8 /
   4), timed as phase 7; then the stem-on and stem-off figures of this run
   side by side;
11. the bf16 text encoder (`encode_txt`, batch 32) on the card against the
   CPU's, which rounds as the JAX scan does: within a quarter of the
   encoder's fp32-vs-bf16 gap; cuDNN's fused bf16 LSTM measured beside it;
12. the training CLI end to end: `cli/train.py`'s `main` in this process on
   the flagship config (a copy with `log_iter` 1, `image_display_iter` 3,
   `image_save_iter` 6, `snapshot_save_iter` 3) and `--procedural_data
   --procedural_size 512`, 6 steps: exact launches (each step phase 7's,
   and 4 sample grids of one encode and three decodes each), 6 finite
   metric rows, checkpoints 3 and 6, the `train_current`, `test_00000006`
   and `train_00000006` grids (5 rows of 8) and `index.html`; step 3's
   checkpoint restored into a fresh trainer bit-equal, tensor by tensor,
   to the run's state after step 3; steps 4-6 run again by `--resume 1`
   from that file, and the whole run once more: the resumed run's mean
   relative metric difference from the run (over every metric of steps
   4-6) no larger than the second run's (the card's reflect-pad backward
   adds with atomics); step 6's EMA generator served (batch 32, finite, in
   [-1, 1]) through `cli/translate.py`'s checkpoint loader, and its grid
   rows finite; the step's CUDA-event time with the real feed beside phase
   7's, the feed's host ms per batch, and the checkpoint's size and save
   and restore seconds;
13. evaluation (FID/IS) and the reference import on the flagship config in
   bf16: the port's seeded generator and discriminator state, with a
   nonzero LSTM `bias_hh`, written as the reference saves them (`{'a':
   ...}`, `{'b': ...}`), imported by `cli/import_reference.py` and the EMA
   generator loaded back by `cli/evaluate.py`'s loader: every tensor
   bit-equal to the folded state (`bias_ih + bias_hh`, `bias_hh` 0); 512
   procedural faces with synthesized commands through the harness's
   per-batch call (`harness.fake_batch`, batch 32): exactly 11 / 4 / 4 / 2
   launches of rows 1-4 in each batch and no other, fakes finite in [-1,
   1]; a random-init InceptionV3 (seed 0) at full width, 4 images card vs
   CPU within 1e-3 of the largest feature and logit (fp32, TF32 off), and
   the same weights through a torchvision-layout `.pth`,
   `convert_inception` and `load_converted` bit-equal on the card; FID
   and IS of real set A (512 faces) against the fakes and against a
   second real set B: finite, FID(A, B) < FID(A, fakes), IS in [1, 1000];
   generation and InceptionV3 images/s, the host seconds of the
   statistics, peak memory and the phase's wall time, each beside the
   card's name and power limit.  The card's machine has no PIL, so the
   phase feeds the harness arrays; the file-reading paths are the CPU
   tests'.
14. the block options and the legacy family: rows 1-2 (forward) and 5-6
   (backward) with `relu=False` at every flagship site where `activ:
   prelu` takes their fused ReLU away (fp32 and bf16, both stats modes,
   two runs bit-equal, phases 2 and 5's tolerances against the plain
   versions); the flagship config with `gen.activ: prelu`, `dis.activ:
   prelu` and `dis.norm: sn` as phase 6 (fp32, batch 2, card vs CPU,
   rtol 1e-3) and as phase 7 (bf16, batch 16: phase 7's exact launches,
   the PReLU slopes and spectral-norm kernels moved, 12 timed steps beside
   phase 7's median, and the spectral norm's calls per step with their
   eager and device ms); the penalties through a discriminator with a
   norm, as phase 6 (`dis.norm: in` with `gp_w 10`, `dis.norm: ln` with R1
   every step: the backward kernels' gradients differentiated again
   through the plain backward, a nonzero penalty on the card); the
   discriminator with `dis.norm: bn` at
   flagship width, fp32 card vs CPU on [16, 128, 128, 3] (each scale's
   outputs within 2e-3 of their largest); `AdaINGenV1` (dim 64, 2
   downsamples, 4 resblocks, mlp 256, style 8, LSTM 300 x 2) and `VAEGen`
   (dim 64, 2, 4) at 128 px: 4 images fp32 card vs CPU (phase 3's 2e-3),
   then bf16 at batch 32 with exactly 11 / 4 / 4 / 2 launches per batch
   and no other, finite output in [-1, 1], images/s (10 batches after 4)
   and peak memory; the phase's wall time.
15. data parallel (`parallel/mesh.py`): (a) a one-rank NCCL group in this
   process (`file://` rendezvous) and the flagship bf16 step at batch 16
   through `DataAxis` and `all_reduce_grads`, which run the collective
   because a group exists: in each of 3 steps the flat G and D gradient
   buffers bit-equal before and after it (a SUM over one rank divided by
   1), exactly phase 7's launches, the metrics' mean relative difference
   from a plain run within twice that of two plain runs (the card's
   reflect-pad backward adds with atomics), the all-reduces' CUDA-event ms
   per step and their fp32 bytes, 12 steps timed beside phase 7's median;
   (b) two gloo ranks on the one card (`chip_smoke.py --dp-worker RANK
   TMP`, `file://` rendezvous), the flagship config in fp32 (TF32 off),
   global batch 4, 2 steps with `state.rng`'s draws and dropout, against
   one process at batch 4 (run twice, its own spread logged): every
   metric within rtol 1e-4 (the second step's gradient norms 1e-3: they
   are taken at parameters that Adam's first step moved apart where a
   gradient is rounding noise), every parameter within rtol 1e-4 plus
   Adam's largest two updates each way (4.108 lr), the ranks bit-equal to
   each other (NCCL with two
   ranks needs two cards: not run, and said so); (c) `cli/train.py` under
   `torch.distributed.run --standalone --nproc_per_node 1` for 2 steps on
   phase 12's config: the mesh line, 2 finite metric rows, checkpoint 2.
16. `norm_compute: bf16`: rows 1-3 with `arith` on at every flagship
   serving site and rows 1-3 and 5-6 at every training site, both stats
   modes: y bit-equal to the plain bf16 chain at the kernel's own
   statistics (`norms.bf16_chain_plain`) and within BF16_ULPS of the plain
   bf16-arithmetic forward wherever both sides' statistics round alike,
   the backward within phase 5's bf16 tolerance of the plain one, two runs
   bit-equal, one CUDA kernel a call, the recomputed ReLU mask equal to y >
   0; each site's device ms (CUDA graph, cold L2, as phase 2) beside the
   same site with `arith` off; then the flagship step with `norm_compute:
   bf16` (phase 7's launches, every one of rows 1-3 and 5-6 in the bf16
   arithmetic, 12 steps beside phase 7's median) and serving at batch 32
   (11 / 4 / 4 / 2, images/s beside phase 4's).
17. tensor parallel (`parallel/rules.py`, `parallel/tensor.py`): gloo
   ranks on the one card (`chip_smoke.py --tp-worker RANK WORLD TMP`,
   `file://` rendezvous; every collective staged through host memory),
   all started together while this process runs the one-process
   references: (a) the 1 x 2 mesh, flagship fp32 (TF32 off), global batch
   4, 2 steps with `state.rng`'s draws and dropout, against one process
   (run twice, its own spread logged): step 1's metrics within
   `tests/test_tp_parity.py`'s rtol 2e-4 / atol 1e-5, step 2's too but
   for the gradient norms (phase 15's 1e-3), the gathered parameters
   within its rtol 2e-4 plus atol 2.5e-4 a step, `state.rng`, the
   replicated parameters and EMA copies bit-equal on both ranks, 46
   shards each; (b) the same two ranks, flagship bf16 at global batch 16:
   exactly phase 7's launches on each rank, finite losses, 25,446,414
   parameter elements held (34,341,710 less half of the 17,790,592
   sharded), the collectives of one step (calls, bytes), then, once the
   other processes have left the card, the peak memory and 12 steps
   (CUDA events) beside phase 7's; (c) the 2 x 2 mesh (four ranks), fp32,
   1 step, held to (a)'s bounds.  NCCL with two ranks needs two cards:
   not run, and said so.  Prints its seconds.
18. a mesh smaller than the world, and the host preprocessing library:
   (a) three gloo ranks on the one card with `mesh_data 1`, `mesh_model
   2`: ranks 0-1 form the 1 x 2 mesh and take phase 17 (a)'s 2 fp32 steps,
   held against phase 17 (a)'s 2-rank run at its bounds (bit-equality
   logged), `state.rng` and the replicated tensors bit-equal on both;
   rank 2 lies outside the mesh, writes nothing and exits 0; (b) the
   port's C++ host kernel (`dwcgan_tpu_torch/native/`, built by g++ on
   the card's host) against its NumPy oracle on 16 seeded uint8 images,
   218 x 178 -> crop 178 -> 128 with flips, within 1e-4 (the largest
   difference logged); host ms per batch of 16 for NumPy and the library
   on one OpenMP thread and on OpenMP's default, then from `num_workers`
   threads calling it per image at once, as `DataPipeline`'s workers do
   (no PIL on the card's machine: nothing is decoded).  Prints its
   seconds.
19. the quality protocol (`cli/quality_eval.py`): `cli/train.py`'s `main`
   on `configs/celeba_quality.yaml` (a copy with `snapshot_save_iter` 20)
   and `--procedural_data` at full width (128 px, bf16), 40 steps: finite
   metric rows, checkpoints 20 and 40; `quality_eval.main` over both on
   the card with `--n_eval 256`: exactly 11 / 4 / 4 / 2 launches of rows
   1-4 per translated batch (8 of the set, the no-change batch and the
   grid's, per checkpoint) and no other, finite rows, `quality_trend.json`
   holding them; then step 40's EMA generator in fp32 (TF32 off) on the
   first 128 held-out faces on the card and on the CPU with the same
   `init_random_inception(0)`: every per-bit accuracy within 1/128,
   `nochange_recon_l1` within rtol 1e-4, `fid_rel` within rtol 1e-3, the
   largest gaps printed, rows 1-4 launched on the card (5 batches' worth)
   and not on the CPU.  Prints the rows and the host seconds of training,
   evaluation and each side of the comparison.

The last lines are the `kernels` JSON (nine kernels: the four forward
ones, the instance-norm, AdaIN and LayerNorm backwards, then the stem
forward and backward; a forward kernel's times and `launches` are per
served batch, with `launches_train` its launches per training step and
`ms_train` / `bound_ms_train` its time and bound per step; the norm
kernels (rows 1-7, each one cluster kernel per call) with `kernels_per_call`
(rows 1-4 also `kernels_per_call_train`), `bit_equal_runs` and their
`plans` at the flagship sites, the LayerNorm's rows with `nearest_call_ms`;
the stem entries carry phase 8's HMMA counts of the kernels they run as
`hmma`; rows 1-7 carry phase 14's launches per block-options step as
`launches_block_options`, rows 1-4 per legacy batch as `launches_legacy`,
phase 15's per step of the NCCL data axis as `launches_data_parallel`
and phase 17 (b)'s per step on each tensor-parallel rank as
`launches_tensor_parallel`; rows 1-4 phase 19's over `quality_eval`'s
two checkpoints as `launches_quality_eval`;
rows 1-3 and 5-6 carry phase 16's `norm_compute_bf16`: the bf16
arithmetic's ms per batch / step beside the same sites' `arith`-off ms
of this run, its largest error and its launches),
the nvidia-smi line and `{"ok": true, "device": {...}}`.  Without
a card it exits 1 and prints no result.

Not run by `main`: `sweep_fwd_plans()` times rows 1-3 at every serving and
training site under each forward layout (blocks per SM x blocks per
sample), `sweep_ln_plans()` rows 4 and 7 at theirs under each LayerNorm
layout (the backward also with 12 and 16 blocks per sample, non-portable
clusters), and `trace_fwd_sites()` shows where one call of rows 1-4 spends
its time in its blocks (the card's clock at six points of the kernel).
"""

from __future__ import annotations

import copy
import ctypes
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dwcgan_tpu_torch.cli import (convert_inception, evaluate, import_reference,
                                  quality_eval)
from dwcgan_tpu_torch.cli import train as train_cli
from dwcgan_tpu_torch.cli.train import (build_trainer, build_vgg_loss,
                                        synthetic_batches)
from dwcgan_tpu_torch.cli.translate import (load_checkpoint, synthetic_requests,
                                            translate_batch)
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.data.pipeline import DataPipeline, to_device
from dwcgan_tpu_torch.data.procedural import ProceduralFaceDataset
from dwcgan_tpu_torch.eval import harness
from dwcgan_tpu_torch.eval.inception import (InceptionV3, fp32_precision,
                                             init_random_inception,
                                             preprocess_for_inception)
from dwcgan_tpu_torch.eval.metrics import feature_stats, fid_from_stats
from dwcgan_tpu_torch.models.discriminator import build_discriminator
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.models.legacy import build_legacy_generator
from dwcgan_tpu_torch.ops import blocks, norms, stem
from dwcgan_tpu_torch.ops.cuda import build, kernels
from dwcgan_tpu_torch.parallel import rules, tensor
from dwcgan_tpu_torch.parallel.mesh import DataAxis
from dwcgan_tpu_torch.text.synthesis import TextSynthesizer
from dwcgan_tpu_torch.text.vocab import Vocab, encode_commands
from dwcgan_tpu_torch.train.checkpoint import (CheckpointManager,
                                               checkpoint_header, checkpoint_steps)
from dwcgan_tpu_torch.train.sampler import make_infer_fn, make_sample_fn
from dwcgan_tpu_torch.train.sampling import blend_attention
from dwcgan_tpu_torch.train import step as step_module
from dwcgan_tpu_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "celeba_faces.yaml"
SEED = 0
BATCH = 32
# H100 SXM data sheet: HBM rate, fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP32_ATOL = 1e-4          # fp32: only the summation order differs
BF16_ULPS = 2             # bf16: ulps of the rounded fp32 plain result
SLICE_ATOL = 2e-3         # fp32 slice, card vs CPU
COLD_L2_BYTES = 128 << 20  # inputs rotated over copies this large (L2: 50 MB)
SERVE_BATCHES = 30        # timed served batches

# The norm call sites of one served batch (flagship: relu, 128 px, dim 64):
# (kernel, NCHW shape, fused relu, calls per batch)
SITES = (
    ("instance_norm", (BATCH, 64, 128, 128), True, 1),   # content stem
    ("instance_norm", (BATCH, 128, 64, 64), True, 1),    # downsample 1
    ("instance_norm", (BATCH, 256, 32, 32), True, 5),    # downsample 2, res conv 1
    ("instance_norm", (BATCH, 256, 32, 32), False, 4),   # res conv 2
    ("adain", (BATCH, 256, 32, 32), True, 4),            # AdaIN res conv 1
    ("adain_residual", (BATCH, 256, 32, 32), False, 4),  # AdaIN res conv 2 + skip
    ("layer_norm_ref", (BATCH, 128, 64, 64), False, 1),  # upsample stage 1
    ("layer_norm_ref", (BATCH, 64, 128, 128), False, 1),  # upsample stage 2
)
EXPECTED_LAUNCHES = {"instance_norm": 11, "adain": 4, "adain_residual": 4,
                     "layer_norm_ref": 2}
# serving launches no backward kernel
SERVE_LAUNCHES = {k: EXPECTED_LAUNCHES.get(k, 0) for k in kernels.LAUNCHES}
# with `stem_pallas` on, both stems are one stem call each and the content
# stem's instance norm moves into it
STEM_SERVE_LAUNCHES = {**SERVE_LAUNCHES, "stem_conv7": 2, "instance_norm": 10}
REPLACES = {
    "instance_norm": "dwcgan_tpu/ops/pallas/norm_kernels.py:106",
    "adain": "dwcgan_tpu/ops/pallas/norm_kernels.py:160",
    "adain_residual": "dwcgan_tpu/ops/pallas/norm_kernels.py:230",
    "layer_norm_ref": "dwcgan_tpu/ops/pallas/norm_kernels.py:273",
}
SOURCE = "dwcgan_tpu_torch/csrc/norm_kernels.cu"
# fp32 operations per element of the kernel's arithmetic ("1pass"; "2pass"
# adds the centred sum: subtract, multiply, add)
OPS_PER_ELEM = {"instance_norm": 6, "adain": 8, "adain_residual": 9,
                "layer_norm_ref": 8}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    """Every kernel's launch count (and its count in the bf16 arithmetic)
    to 0, just before a path is driven."""
    for counts in (kernels.LAUNCHES, kernels.ARITH_LAUNCHES):
        for k in counts:
            counts[k] = 0


def check_arith_launches(launches, norm_compute) -> None:
    """Under `norm_compute: bf16` every launch of rows 1-3 and 5-6 ran in
    the bf16 arithmetic; otherwise none did."""
    want = {k: launches[k] if norm_compute == "bf16" else 0
            for k in kernels.ARITH_LAUNCHES}
    if kernels.ARITH_LAUNCHES != want:
        raise AssertionError(f"launches in the bf16 arithmetic "
                             f"{kernels.ARITH_LAUNCHES} != {want}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `fn(i)` by CUDA events, after warm-up."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Mean device ms per call of `fn(i)`: `iters` calls captured in one CUDA
    graph, so no host time sits between the launches, replayed `reps` times
    between CUDA events after a warm-up on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    stop.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(stop) / (iters * reps)


# ---------------------------------------------------------------- phase 2

def site_inputs(kernel, shape, dtype, g):
    """Activations with per-channel offsets and spreads; fp32 parameters."""
    n, c, h, w = shape
    dev = "cuda"
    off = torch.randn(n, c, 1, 1, generator=g, device=dev)
    spread = 0.5 + torch.rand(n, c, 1, 1, generator=g, device=dev)

    def act():
        x = torch.randn(shape, generator=g, device=dev) * spread + off
        return x.to(dtype).contiguous(memory_format=torch.channels_last)

    if kernel == "instance_norm":
        return (act(),)
    if kernel == "adain":
        return (act(), 1 + 0.2 * torch.randn(n, c, generator=g, device=dev),
                0.2 * torch.randn(n, c, generator=g, device=dev))
    if kernel == "adain_residual":
        return (act(), act(), 1 + 0.2 * torch.randn(n, c, generator=g, device=dev),
                0.2 * torch.randn(n, c, generator=g, device=dev))
    return (act(), torch.rand(c, generator=g, device=dev),
            0.1 * torch.randn(c, generator=g, device=dev))


def cold_copies(args):
    """`args` and clones of its activations, enough to fill COLD_L2_BYTES."""
    in_bytes = sum(a.numel() * a.element_size() for a in args if a.dim() == 4)
    return [args] + [tuple(a.clone(memory_format=torch.preserve_format)
                           if a.dim() == 4 else a for a in args)
                     for _ in range(max(0, math.ceil(COLD_L2_BYTES / in_bytes) - 1))]


def run_kernel_stats(kernel, args, relu, stats, plan=None, arith=False):
    """The forward kernel: (output, saved statistics); `plan`: its layout
    if not `kernels.fwd_plan`'s (the plan sweeps); `arith`: rows 1-3 in the
    bf16 arithmetic (phase 16)."""
    two_pass = stats == "2pass"
    if kernel == "instance_norm":
        return kernels.instance_norm(*args, relu=relu, two_pass=two_pass, plan=plan,
                                     arith=arith)
    if kernel == "adain":
        return kernels.adain(*args, relu=relu, two_pass=two_pass, plan=plan,
                             arith=arith)
    if kernel == "adain_residual":
        return kernels.adain_residual(*args, two_pass=two_pass, plan=plan, arith=arith)
    return kernels.layer_norm_ref(*args, two_pass=two_pass, plan=plan)


def run_kernel(kernel, args, relu, stats, plan=None, arith=False):
    return run_kernel_stats(kernel, args, relu, stats, plan, arith)[0]


# the forwards, each one cluster kernel per call (rows 1-4): (op, residual)
# of `kernels.fwd_clusters`
CLUSTER_FWD = {"instance_norm": (0, False), "adain": (1, False),
               "adain_residual": (1, True), "layer_norm_ref": (2, False)}
ROWS_1_3 = ("instance_norm", "adain", "adain_residual")


def fwd_cluster_checks(kernel, args, relu, stats, label):
    """Rows 1-4: two runs bit-equal (y and the statistics), one CUDA kernel
    per call (the kernel nodes of a CUDA graph of one call), and the plan of
    the call: blocks per sample, shared memory of a block, the resident
    share of a slab, the clusters that fit on the card at once."""
    first = run_kernel_stats(kernel, args, relu, stats)
    again = run_kernel_stats(kernel, args, relu, stats)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{label}: two runs differ")
    per_call = kernels_per_call(lambda: run_kernel_stats(kernel, args, relu, stats))
    if per_call != 1:
        raise AssertionError(f"{label}: {per_call} kernels per call")
    x = args[1] if kernel == "adain_residual" else args[0]
    n, c, h, w = x.shape
    plan = kernels.fwd_plan(n, h * w, c, x.dtype)
    op, residual = CLUSTER_FWD[kernel]
    return dict(kernels_per_call=per_call, bit_equal_runs=True, k=plan.k,
                smem=plan.smem, resident_share=plan.resident / plan.rows,
                clusters=kernels.fwd_clusters(0, op, x.dtype, relu, residual, c, plan))


def run_plain(kernel, args, relu, stats):
    if kernel == "instance_norm":
        return norms.instance_norm_plain(*args, relu=relu, stats=stats)
    if kernel == "adain":
        return norms.adain_plain(*args, relu=relu, stats=stats)
    if kernel == "adain_residual":
        return norms.adain_residual_plain(*args, stats=stats)
    return norms.layer_norm_ref_plain(*args, stats=stats)


def bf16_ulp(r: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at each element of the bf16 tensor `r`."""
    _, e = torch.frexp(r.float().abs())
    ulp = torch.ldexp(torch.ones_like(r, dtype=torch.float32), (e - 8).float())
    return torch.where(r == 0, torch.zeros_like(ulp), ulp)


def site_bound(kernel, shape, dtype, stats):
    """(ms, 'bytes' | 'operations'): each input read once, the output
    written once, over the HBM rate; fp32 operations over the fp32 rate."""
    n, c, h, w = shape
    elems = n * c * h * w
    size = torch.finfo(dtype).bits // 8
    acts = {"instance_norm": 2, "adain": 2, "adain_residual": 3,
            "layer_norm_ref": 2}[kernel]
    params = {"instance_norm": 0, "adain": 2 * n * c, "adain_residual": 2 * n * c,
              "layer_norm_ref": 2 * c}[kernel]
    t_bytes = (acts * elems * size + 4 * params) / HBM_BYTES_PER_S
    ops = elems * (OPS_PER_ELEM[kernel] + (3 if stats == "2pass" else 0))
    t_ops = ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def adain_library_args(x, scale, bias):
    """AdaIN as one PyTorch call: F.instance_norm over x viewed as
    [1, N*C, H, W], with scale and bias flattened to its per-channel weight
    and bias (eps 1e-5).  x is given to it in its own layout, NCHW."""
    n, c, h, w = x.shape
    return x.contiguous().view(1, n * c, h, w), scale.flatten(), bias.flatten()


def library_call(kernel, args):
    """One PyTorch call computing the same function, where one exists:
    F.instance_norm for the instance norm (without the fused ReLU) and for
    AdaIN (without the ReLU; for the residual form, without the add); the
    reference LayerNorm (unbiased std, eps added to it) has none."""
    if kernel == "instance_norm":
        return lambda i: F.instance_norm(args[i % len(args)][0])
    if kernel == "layer_norm_ref":
        return None
    lib = [adain_library_args(*a[-3:]) for a in args]   # (x or y, scale, bias)

    def call(i):
        x, w, b = lib[i % len(lib)]
        return F.instance_norm(x, weight=w, bias=b)
    return call


def group_norm_args(x, gamma, beta):
    """The nearest PyTorch call to the reference LayerNorm,
    F.group_norm(x, 1, gamma, beta): the same bytes, but another function
    (biased variance, x - mean times rsqrt(var + eps)), so no library time.
    x is given to it in its own layout, NCHW, and gamma and beta in x's
    dtype."""
    return x.contiguous(), gamma.to(x.dtype), beta.to(x.dtype)


def nearest_call(kernel, args):
    """F.group_norm(x, 1, gamma, beta) for the LayerNorm, else None."""
    if kernel != "layer_norm_ref":
        return None
    gn = [group_norm_args(*a) for a in args]
    return lambda i: F.group_norm(gn[i % len(gn)][0], 1, *gn[i % len(gn)][1:])


def check_forward(kernel, shape, relu, dtype, stats, args, out):
    """The forward kernel's `out` against its plain version in fp32: max abs
    err, or AssertionError outside the tolerance."""
    args32 = tuple(a.float() for a in args)
    ref32 = run_plain(kernel, args32, relu, stats)
    extra = None
    if kernel == "adain_residual" and dtype == torch.bfloat16:
        # the reference adds AdaIN(y) already rounded to bf16; the kernel's
        # fp32 AdaIN(y), summed in another order, may round to the
        # neighbouring bf16 value: one ulp of it more
        t = norms.adain_plain(*args32[1:], stats=stats).to(dtype)
        ref32, extra = args32[0] + t.float(), bf16_ulp(t)
    return check_close(f"{kernel} {shape} {dtype} {stats} relu={relu}", out,
                       ref32, dtype, extra)


def check_close(label, out, ref32, dtype, extra=None):
    """`out` (in `dtype`) against the fp32 plain result `ref32`: fp32 within
    FP32_ATOL; bf16 within BF16_ULPS ulps of ref32 rounded to bf16, plus that
    atol, plus `extra` where given.  Returns the max abs err; AssertionError
    outside the tolerance."""
    if dtype == torch.float32:
        err = (out - ref32).abs()
        tol = torch.full_like(err, FP32_ATOL)
    else:
        ref = ref32.to(torch.bfloat16)
        err = (out.float() - ref.float()).abs()
        # BF16_ULPS ulps of the rounded result, plus the fp32 atol where the
        # summation order alone moves a value near zero by more than that
        tol = BF16_ULPS * bf16_ulp(ref) + FP32_ATOL
        if extra is not None:
            tol = tol + extra
    bad = int((err > tol).sum())
    max_err = float(err.max())
    if not torch.isfinite(out).all() or bad:
        raise AssertionError(f"{label}: {bad} elements outside tolerance, max "
                             f"abs err {max_err:.3e}")
    return max_err


def check_site(kernel, shape, relu, dtype, stats, g):
    args = site_inputs(kernel, shape, dtype, g)
    out = run_kernel(kernel, args, relu, stats)
    torch.cuda.synchronize()
    max_err = check_forward(kernel, shape, relu, dtype, stats, args, out)
    extra = {}
    if kernel in CLUSTER_FWD:
        extra = fwd_cluster_checks(kernel, args, relu, stats,
                                   f"{kernel} {shape} {dtype} {stats} relu={relu}")

    # timing: rotate over copies of the inputs so the L2 is cold, as on the
    # path, where each norm reads a fresh conv output
    copies = cold_copies(args)
    kern = lambda i: run_kernel(kernel, copies[i % len(copies)], relu, stats)
    ms = device_ms(kern)
    eager_ms = time_ms(kern)   # as the eager path calls it, wrapper included
    plain_ms = device_ms(lambda i: run_plain(kernel, copies[i % len(copies)],
                                             relu, stats))
    lib = library_call(kernel, copies)
    library_ms = device_ms(lib) if lib is not None else None
    near = nearest_call(kernel, copies)
    if near is not None:
        extra["nearest_call_ms"] = device_ms(near)
    bound_ms, bound_by = site_bound(kernel, shape, dtype, stats)
    return dict(kernel=kernel, shape=list(shape), relu=relu,
                dtype=str(dtype).replace("torch.", ""), stats=stats,
                max_abs_err=max_err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, **extra)


def phase_kernels():
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for kernel, shape, relu, calls in SITES:
        for dtype in (torch.float32, torch.bfloat16):
            for stats in ("2pass", "1pass"):
                row = check_site(kernel, shape, relu, dtype, stats, g)
                row["calls_per_batch"] = calls
                rows.append(row)
                log("kernel_check " + json.dumps(row))
    return rows


# ---------------------------------------------------------------- phase 5

TRAIN_BATCH = 16
# The norm backward call sites of one flagship training step (bf16, batch
# 16): (counter, the forward op at the site, NCHW shape, fused relu, backward
# calls, forward calls); the VGG's instance norm runs forward twice (the
# real image's features need no gradient)
BWD_SITES = tuple(
    ("instance_norm_bwd", "instance_norm", shape, relu, calls, calls)
    for b in (TRAIN_BATCH, 3 * TRAIN_BATCH)      # encode, re-encode at 3n
    for shape, relu, calls in (((b, 64, 128, 128), True, 1),
                               ((b, 128, 64, 64), True, 1),
                               ((b, 256, 32, 32), True, 5),
                               ((b, 256, 32, 32), False, 4))) + (
    ("instance_norm_bwd", "instance_norm", (TRAIN_BATCH, 512, 16, 16), False, 1, 2),  # VGG
) + tuple(
    site for b in (4 * TRAIN_BATCH, TRAIN_BATCH)  # decode at 4n, cycle at n
    for site in (("adain_bwd", "adain", (b, 256, 32, 32), True, 4, 4),
                 ("adain_residual_bwd", "adain_residual", (b, 256, 32, 32), False, 4, 4),
                 ("layer_norm_ref_bwd", "layer_norm_ref", (b, 128, 64, 64), False, 1, 1),
                 ("layer_norm_ref_bwd", "layer_norm_ref", (b, 64, 128, 128), False, 1, 1)))
# the backwards, each one cluster kernel per call (rows 5-7), by op code of
# `kernels.bwd_clusters`
CLUSTER_BWD = {"instance_norm_bwd": 0, "adain_bwd": 1, "adain_residual_bwd": 1,
               "layer_norm_ref_bwd": 2}
EXPECTED_TRAIN_LAUNCHES = {
    "instance_norm": 24, "adain": 8, "adain_residual": 8, "layer_norm_ref": 4,
    "instance_norm_bwd": 23, "adain_bwd": 8, "adain_residual_bwd": 8,
    "layer_norm_ref_bwd": 4, "stem_conv7": 0, "stem_conv7_bwd": 0}
# per step with `stem_pallas` on: the encoder runs at n and at 3n, two stems
# each; the content stem's instance norm, forward and backward, moves into
# the stem at both
STEM_TRAIN_LAUNCHES = {**EXPECTED_TRAIN_LAUNCHES, "stem_conv7": 4,
                       "stem_conv7_bwd": 4, "instance_norm": 22,
                       "instance_norm_bwd": 21}
BWD_REPLACES = {
    "instance_norm_bwd": "dwcgan_tpu/ops/pallas/norm_kernels.py:125",
    "adain_bwd": "dwcgan_tpu/ops/pallas/norm_kernels.py:186",
    "layer_norm_ref_bwd": "dwcgan_tpu/ops/pallas/norm_kernels.py:256",
}
# fp32 operations per element of the backward's arithmetic (sums: subtract,
# multiply, multiply, two adds; apply: subtract, three multiply-adds)
BWD_OPS_PER_ELEM = 11
BWD_FP32_REL = 1e-4   # fp32: of each gradient's largest magnitude
BWD_BF16_REL = 2e-2   # bf16: dx rounds to bf16 (2^-9 relative) on top
STEP_RTOL = 1e-3      # fp32 training step, card vs CPU
TIMED_STEPS = 12


def run_bwd(counter, x, gr, st, params, relu, plan=None, arith=False):
    """The backward kernel of a site (x: the normalised activation; params:
    its affine): the gradients of its inputs.  `plan`: the LayerNorm's
    layout if not `kernels.ln_bwd_plan`'s (the plan sweep); `arith`: rows
    5-6 in the bf16 arithmetic (phase 16)."""
    if counter == "instance_norm_bwd":
        return (kernels.instance_norm_bwd(x, gr, st, relu=relu, arith=arith),)
    if counter == "adain_bwd":
        return kernels.adain_bwd(x, gr, st, params[0], params[1], relu=relu,
                                 arith=arith)
    if counter == "adain_residual_bwd":
        return kernels.adain_bwd(x, gr, st, params[0], residual=True, arith=arith)
    return kernels.layer_norm_ref_bwd(x, gr, st, params[0], plan=plan)


def bwd_plan_of(counter, shape, dtype):
    n, c, h, w = shape
    plan = kernels.ln_bwd_plan if counter == "layer_norm_ref_bwd" else kernels.bwd_plan
    return plan(n, h * w, c, dtype)


def kernels_per_call(fn) -> int:
    """How many CUDA kernels one call of `fn` launches: the kernel nodes of
    a CUDA graph that captured one call (cuGraphGetNodes and
    cuGraphNodeGetType of libcuda)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]

    def check(err):
        if err:
            raise RuntimeError(f"CUDA error {err} while reading a graph")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)))
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)))
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
        kernels += kind.value == 0   # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def run_bwd_plain(counter, x, gr, out, params, relu, stats, residual_y=None):
    mask = out if relu else None
    if counter == "instance_norm_bwd":
        return (norms.instance_norm_bwd_plain(x, gr, mask, stats),)
    if counter == "adain_bwd":
        return norms.adain_bwd_plain(x, params[0], gr, mask, stats)
    if counter == "adain_residual_bwd":
        return norms.adain_bwd_plain(residual_y, params[0], gr, None, stats)
    return norms.layer_norm_ref_bwd_plain(x, params[0], gr, stats)


def bwd_bound(shape, dtype, stats):
    """(ms, by): x and the incoming gradient read once, dx written once."""
    n, c, h, w = shape
    elems = n * c * h * w
    size = torch.finfo(dtype).bits // 8
    t_bytes = 3 * elems * size / HBM_BYTES_PER_S
    t_ops = elems * BWD_OPS_PER_ELEM / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_bwd_close(label, got, want, dtype):
    """A backward kernel's gradients against the plain backward's: within
    BWD_FP32_REL (fp32) or BWD_BF16_REL (bf16) of each gradient's largest
    magnitude.  Returns (max abs err, max relative err)."""
    rel = BWD_FP32_REL if dtype == torch.float32 else BWD_BF16_REL
    max_err, max_rel = 0.0, 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: not finite")
        scale = float(b.abs().max())
        err = float((a.float() - b.float()).abs().max())
        max_err, max_rel = max(max_err, err), max(max_rel, err / max(scale, 1e-30))
        if err > rel * scale + 1e-6:
            raise AssertionError(f"{label}: max abs err {err:.3e} vs largest {scale:.3e}")
    return max_err, max_rel


def check_bwd_site(counter, fwd, shape, relu, dtype, stats, g):
    args = site_inputs(fwd, shape, dtype, g)
    # the normalised activation and the affine parameters of the site
    x = args[1] if fwd == "adain_residual" else args[0]
    params = args[2:] if fwd == "adain_residual" else args[1:]
    out, st = run_kernel_stats(fwd, args, relu, stats)
    torch.cuda.synchronize()
    # the forward at the training shape first: `out` is the plain
    # backward's mask; its time there is the forward's per-step cost
    fwd_err = check_forward(fwd, shape, relu, dtype, stats, args, out)
    fwd_extra = {} if fwd not in CLUSTER_FWD else {
        f"fwd_{k}": v for k, v in fwd_cluster_checks(
            fwd, args, relu, stats, f"{fwd} {shape} {dtype} {stats} relu={relu}").items()}
    fwd_copies = cold_copies(args)
    fwd_ms = device_ms(lambda i: run_kernel(fwd, fwd_copies[i % len(fwd_copies)],
                                            relu, stats))
    fwd_bound_ms = site_bound(fwd, shape, dtype, stats)[0]
    del fwd_copies
    gr = torch.randn(out.shape, generator=g, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last)
    got = run_bwd(counter, x, gr, st, params, relu)
    again = run_bwd(counter, x, gr, st, params, relu)
    torch.cuda.synchronize()
    label = f"{counter} {shape} {dtype} {stats} relu={relu}"
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two runs differ")
    want = run_bwd_plain(counter, x.float(), gr.float(), out.float(), params,
                         relu, stats, x.float())
    max_err, max_rel = check_bwd_close(label, got, want, dtype)
    del got, again, want
    # the one-launch backward: its plan, how many clusters fit, the kernels
    # one call launches (1), and its ReLU mask against the forward's y > 0
    extra = {"kernels_per_call": kernels_per_call(
        lambda: run_bwd(counter, x, gr, st, params, relu))}
    if counter in CLUSTER_BWD:
        c = shape[1]
        plan = bwd_plan_of(counter, shape, dtype)
        extra.update(k=plan.k, smem=plan.smem, resident_share=plan.resident / plan.rows,
                     clusters=kernels.bwd_clusters(0, CLUSTER_BWD[counter], dtype,
                                                   relu, False, c, plan))
        if extra["kernels_per_call"] != 1:
            raise AssertionError(f"{label}: {extra['kernels_per_call']} kernels per call")
        if relu:
            extra["mask_mismatches"] = kernels.relu_mask_mismatches(
                x, out, st, *(params if counter == "adain_bwd" else ()))
            if extra["mask_mismatches"]:
                raise AssertionError(f"{label}: the kernel's ReLU mask differs from "
                                     f"y > 0 at {extra['mask_mismatches']} elements")

    # timing on copies of the inputs (cold L2), as phase 2
    in_bytes = 2 * x.numel() * x.element_size()
    n_copies = max(1, math.ceil(COLD_L2_BYTES / in_bytes))
    copies = [(x, gr, st, out)] + [
        (x.clone(memory_format=torch.preserve_format),
         gr.clone(memory_format=torch.preserve_format), st.clone(),
         out.clone(memory_format=torch.preserve_format))
        for _ in range(n_copies - 1)]
    kern = lambda i: run_bwd(counter, copies[i % n_copies][0], copies[i % n_copies][1],
                             copies[i % n_copies][2], params, relu)
    ms = device_ms(kern)
    eager_ms = time_ms(kern)
    plain_ms = device_ms(lambda i: run_bwd_plain(
        counter, copies[i % n_copies][0], copies[i % n_copies][1],
        copies[i % n_copies][3], params, relu, stats, copies[i % n_copies][0]))
    library_ms = None
    if counter == "layer_norm_ref_bwd":
        # the nearest call's backward: F.group_norm's, dx, dgamma and dbeta
        graphs = []
        for cx, cg, _, _ in copies:
            xv, w, b = (t.detach().requires_grad_()
                        for t in group_norm_args(cx, *params))
            graphs.append((F.group_norm(xv, 1, w, b), (xv, w, b), cg.contiguous()))
        extra["nearest_call_ms"] = time_ms(lambda i: torch.autograd.grad(
            graphs[i % n_copies][0], graphs[i % n_copies][1],
            graphs[i % n_copies][2], retain_graph=True))
        del graphs
    else:
        # the backward of F.instance_norm (the ReLU left out): dx alone for
        # the instance norm, dx, dscale and dbias for AdaIN's form of it
        graphs = []
        for cx, cg, _, _ in copies:
            if counter == "instance_norm_bwd":
                xr = cx.detach().requires_grad_()
                graphs.append((F.instance_norm(xr), (xr,), cg))
                continue
            xv, w, b = (t.detach().requires_grad_()
                        for t in adain_library_args(cx, *params))
            graphs.append((F.instance_norm(xv, weight=w, bias=b), (xv, w, b),
                           cg.contiguous().view(xv.shape)))
        library_ms = time_ms(lambda i: torch.autograd.grad(
            graphs[i % n_copies][0], graphs[i % n_copies][1],
            graphs[i % n_copies][2], retain_graph=True))
        del graphs
    bound_ms, bound_by = bwd_bound(shape, dtype, stats)
    return dict(kernel=counter, shape=list(shape), relu=relu,
                dtype=str(dtype).replace("torch.", ""), stats=stats,
                max_abs_err=max_err, max_rel_err=max_rel, bit_equal_runs=True,
                fwd_max_abs_err=fwd_err, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, fwd=fwd, fwd_ms=fwd_ms, fwd_bound_ms=fwd_bound_ms,
                **fwd_extra, **extra)


def phase_backward():
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = []
    for counter, fwd, shape, relu, calls, fwd_calls in BWD_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            for stats in ("2pass", "1pass"):
                row = check_bwd_site(counter, fwd, shape, relu, dtype, stats, g)
                row["calls_per_step"] = calls
                row["fwd_calls_per_step"] = fwd_calls
                rows.append(row)
                log("bwd_check " + json.dumps(row))
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------- the forward plan sweep

SWEEP_PER_SM = (1, 2, 3)   # blocks per SM: a block's shared memory
SWEEP_K = (4, 6, 7, 8)     # blocks per sample


def fwd_sweep_sites(names=ROWS_1_3):
    """The sites of the forwards `names`: (kernel, NCHW shape, relu, calls
    per served batch, forward calls per training step), merged where a
    shape recurs."""
    sites = {}
    for kernel, shape, relu, calls in SITES:
        if kernel in names:
            sites.setdefault((kernel, shape, relu), [0, 0])[0] += calls
    for _, fwd, shape, relu, _, fwd_calls in BWD_SITES:
        if fwd in names:
            sites.setdefault((fwd, shape, relu), [0, 0])[1] += fwd_calls
    return [key + tuple(calls) for key, calls in sites.items()]


def sweep_fwd_site(kernel, shape, relu, copies, dtype, stats, plan):
    """One forward site under `plan`: checked against its plain version,
    device ms as phase 2 (a CUDA graph, cold L2), the plan's resident
    share and shared memory, and the clusters that fit."""
    out = run_kernel(kernel, copies[0], relu, stats, plan)
    torch.cuda.synchronize()
    err = check_forward(kernel, shape, relu, dtype, stats, copies[0], out)
    ms = device_ms(lambda i: run_kernel(kernel, copies[i % len(copies)], relu, stats, plan))
    op, residual = CLUSTER_FWD[kernel]
    return dict(kernel=kernel, shape=list(shape), relu=relu, ms=ms, max_abs_err=err,
                k=plan.k, resident_share=plan.resident / plan.rows, smem=plan.smem,
                clusters=kernels.fwd_clusters(0, op, dtype, relu, residual, shape[1], plan))


def sweep_fwd_plans(dtype=torch.bfloat16, stats="1pass"):
    """Rows 1-3 at every serving and training site under each plan (blocks
    per SM x blocks per sample), each checked against its plain version:
    device ms per site (as phase 2: a CUDA graph, cold L2), and per plan
    the sums per served batch and per training step.  First, per site, the device ms of a plain copy of the
    activation (`Tensor.clone`: the instance norm's least traffic, read
    once and written once) as a yardstick.  Prints one JSON line per plan
    and returns them.

        python -c "import chip_smoke as c; c.sweep_fwd_plans()"
    """
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    sites = fwd_sweep_sites()
    inputs = [cold_copies(site_inputs(kernel, shape, dtype, g))
              for kernel, shape, relu, _, _ in sites]
    copy_ms = [device_ms(lambda i: copies[i % len(copies)][0].clone(
        memory_format=torch.preserve_format)) for copies in inputs]
    log("fwd_sweep_copy " + json.dumps([dict(shape=list(site[1]), copy_ms=ms)
                                        for site, ms in zip(sites, copy_ms)]))
    results = []
    for per_sm in SWEEP_PER_SM:
        for k in SWEEP_K:
            row = dict(per_sm=per_sm, k=k, sites=[], ms_batch=0.0, ms_step=0.0)
            for (kernel, shape, relu, per_batch, per_step), copies in zip(sites, inputs):
                n, c, h, w = shape
                plan = kernels.fwd_plan(n, h * w, c, dtype, per_sm=per_sm, k=k)
                site = sweep_fwd_site(kernel, shape, relu, copies, dtype, stats, plan)
                row["sites"].append(dict(site, calls_per_batch=per_batch,
                                         calls_per_step=per_step))
                row["ms_batch"] += site["ms"] * per_batch
                row["ms_step"] += site["ms"] * per_step
            log("fwd_sweep " + json.dumps(row))
            results.append(row)
    return results


def trace_fwd_sites(dtype=torch.bfloat16, stats="1pass"):
    """Where a forward call of rows 1-4 spends its time, at each serving and
    training site with its default plan: `kernels.fwd_trace` on a cold
    copy, after a warm-up; per phase the median over the blocks of its
    duration (µs), the spread of the blocks' start times, and the span from
    the first start to the last end.  Prints one JSON line per site.

        python -c "import chip_smoke as c; c.trace_fwd_sites()"
    """
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    phases = ("sums", "block_sums", "exchange", "apply", "exit")
    rows = []
    for kernel, shape, relu, _, _ in fwd_sweep_sites(tuple(CLUSTER_FWD)):
        warm, cold = site_inputs(kernel, shape, dtype, g), site_inputs(kernel, shape, dtype, g)
        run_kernel(kernel, warm, relu, stats)
        x = cold[1] if kernel == "adain_residual" else cold[0]
        t = kernels.fwd_trace(lambda: run_kernel(kernel, cold, relu, stats), x).cpu()
        t = (t - t[..., 0].min()).double() / 1e3            # µs from the first start
        d = t[..., 1:] - t[..., :-1]
        row = dict(kernel=kernel, shape=list(shape), relu=relu,
                   start_spread_us=float(t[..., 0].max()),
                   span_us=float(t[..., 5].max()),
                   **{f"{p}_us": float(d[..., i].median()) for i, p in enumerate(phases)})
        log("fwd_trace " + json.dumps(row))
        rows.append(row)
    return rows


# ---------------------------------------------- the LayerNorm's plan sweep

LN_SWEEP_PER_SM = (1, 2)        # blocks per SM: a block's shared memory
LN_SWEEP_K = (4, 6, 8)          # blocks per sample, forward
LN_BWD_SWEEP_K = (4, 6, 8, 12, 16)   # and backward (12, 16: non-portable)


def sweep_ln_plans(dtype=torch.bfloat16, stats="1pass"):
    """Rows 4 and 7 (the LayerNorm forward and backward) at their serving
    and training sites under each plan (blocks per SM x blocks per sample),
    each checked against its plain version: device ms per site (as phases 2
    and 5: a CUDA graph, cold L2), and per plan the forward's sums per
    served batch and per training step, the backward's per step.  A plan
    of which no cluster fits on the card is logged with its error and no
    time.  Prints one JSON line per plan and returns them.

        python -c "import chip_smoke as c; c.sweep_ln_plans()"
    """
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    sites = fwd_sweep_sites(("layer_norm_ref",))
    inputs = [cold_copies(site_inputs(kernel, shape, dtype, g))
              for kernel, shape, relu, _, _ in sites]
    results = []
    for per_sm in LN_SWEEP_PER_SM:
        for k in LN_SWEEP_K:
            row = dict(row=4, per_sm=per_sm, k=k, sites=[], ms_batch=0.0, ms_step=0.0)
            for (kernel, shape, relu, per_batch, per_step), copies in zip(sites, inputs):
                n, c, h, w = shape
                plan = kernels.fwd_plan(n, h * w, c, dtype, per_sm=per_sm, k=k)
                site = sweep_fwd_site(kernel, shape, relu, copies, dtype, stats, plan)
                row["sites"].append(dict(site, calls_per_batch=per_batch,
                                         calls_per_step=per_step))
                row["ms_batch"] += site["ms"] * per_batch
                row["ms_step"] += site["ms"] * per_step
            log("ln_sweep " + json.dumps(row))
            results.append(row)
    del inputs

    counter = "layer_norm_ref_bwd"
    bsites = []
    for name, _, shape, _, calls, _ in BWD_SITES:
        if name != counter:
            continue
        x, gamma, beta = site_inputs("layer_norm_ref", shape, dtype, g)
        out, st = kernels.layer_norm_ref(x, gamma, beta, two_pass=stats == "2pass")
        gr = torch.randn(shape, generator=g, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last)
        want = run_bwd_plain(counter, x.float(), gr.float(), out.float(), (gamma, beta),
                             False, stats)
        bsites.append((shape, calls, cold_copies((x, gr, st, gamma)), want))
    for per_sm in LN_SWEEP_PER_SM:
        for k in LN_BWD_SWEEP_K:
            row = dict(row=7, per_sm=per_sm, k=k, sites=[], ms_step=0.0)
            for shape, calls, copies, want in bsites:
                n, c, h, w = shape
                plan = kernels.ln_bwd_plan(n, h * w, c, dtype, per_sm=per_sm, k=k)
                site = dict(shape=list(shape), k=plan.k, smem=plan.smem,
                            resident_share=plan.resident / plan.rows, calls_per_step=calls)
                try:
                    site["clusters"] = kernels.bwd_clusters(0, CLUSTER_BWD[counter], dtype,
                                                            False, False, c, plan)
                except RuntimeError as e:   # no cluster of this plan fits
                    row["sites"].append(dict(site, error=str(e)))
                    row["ms_step"] = None
                    continue
                x, gr, st, gamma = copies[0]
                got = run_bwd(counter, x, gr, st, (gamma,), False, plan)
                torch.cuda.synchronize()
                site["max_abs_err"], site["max_rel_err"] = check_bwd_close(
                    f"{counter} {shape} {plan}", got, want, dtype)
                site["ms"] = device_ms(lambda i: run_bwd(
                    counter, *copies[i % len(copies)][:3], (gamma,), False, plan))
                row["sites"].append(site)
                if row["ms_step"] is not None:
                    row["ms_step"] += site["ms"] * calls
            log("ln_bwd_sweep " + json.dumps(row))
            results.append(row)
    return results


# ------------------------------------------ parent-vs-change comparisons

NORM_ROWS = {1: ("instance_norm",), 2: ("adain",), 3: ("adain_residual",),
             4: ("layer_norm_ref",), 5: ("instance_norm_bwd",),
             6: ("adain_bwd", "adain_residual_bwd"), 7: ("layer_norm_ref_bwd",)}


def norm_row_times(log_path, dtype="bfloat16", stats="1pass"):
    """Rows 1-7 from the `kernel_check` and `bwd_check` lines that
    `phase_kernels()` and `phase_backward()` printed into `log_path` (any
    tree's, so a parent's too): per row the device ms per served batch
    (rows 1-4) and per training step, with the bound, the plain version's
    and the nearest call's time, summed over the sites times their calls.
    Prints and returns one JSON object.

        python -c "import chip_smoke as c; c.norm_row_times('out.txt')"
    """
    fwd, bwd = [], []
    for line in Path(log_path).read_text().splitlines():
        tag, _, body = line.partition(" ")
        if tag in ("kernel_check", "bwd_check"):
            r = json.loads(body)
            if r["dtype"] == dtype and r["stats"] == stats:
                (fwd if tag == "kernel_check" else bwd).append(r)
    out = {}
    for row, names in NORM_ROWS.items():
        t = {}
        if row <= 4:
            mine = [r for r in fwd if r["kernel"] in names]
            for key in ("ms", "bound_ms", "plain_ms", "nearest_call_ms"):
                if mine and key in mine[0]:
                    t[f"{key}_batch"] = sum(r[key] * r["calls_per_batch"] for r in mine)
            step = [r for r in bwd if r["fwd"] in names]
            t["ms_step"] = sum(r["fwd_ms"] * r["fwd_calls_per_step"] for r in step)
            t["bound_ms_step"] = sum(r["fwd_bound_ms"] * r["fwd_calls_per_step"]
                                     for r in step)
        else:
            mine = [r for r in bwd if r["kernel"] in names]
            for key in ("ms", "bound_ms", "plain_ms", "nearest_call_ms"):
                if mine and key in mine[0]:
                    t[f"{key}_step"] = sum(r[key] * r["calls_per_step"] for r in mine)
        out[f"row{row}"] = t
    log("norm_row_times " + json.dumps(out))
    return out


# ---------------------------------------------------------------- phase 8

STEM_C, STEM_HW = 64, 128     # flagship gen dim and image size
# The stem call sites of the stem-on paths: (encoder, batch, norm, act,
# calls per served batch, calls per training step, backward needs dx): the
# encoder runs at 32 when serving; when training at n (real images, no
# image gradient) and at 3n (generated images, dx needed)
STEM_SITES = (
    ("content", BATCH, "in", "relu", 1, 0, None),
    ("style", BATCH, "none", "relu", 1, 0, None),
    ("content", TRAIN_BATCH, "in", "relu", 0, 1, False),
    ("style", TRAIN_BATCH, "none", "relu", 0, 1, False),
    ("content", 3 * TRAIN_BATCH, "in", "relu", 0, 1, True),
    ("style", 3 * TRAIN_BATCH, "none", "relu", 0, 1, True),
)
STEM_PAD_SHAPE = (2, 3, 20, 44)   # the pad-type checks: ragged against 8 x 32 tiles
STEM_REPLACES = {
    "stem_conv7": "dwcgan_tpu/ops/pallas/stem_kernels.py:252",
    "stem_conv7_bwd": "dwcgan_tpu/ops/pallas/stem_kernels.py:154",
}
STEM_SOURCE = "dwcgan_tpu_torch/csrc/stem_kernels.cu"
# the stem's bf16 kernels on the tensor cores: the conv tile (the forward's
# passes and the backward's recompute passes), the backward's dW and dX
STEM_MMA_KERNELS = ("stem_tile_mma_kernel", "stem_dw_mma_kernel", "stem_dxp_mma_kernel")
BF16_OPS_PER_S = 989e12     # H100 SXM data sheet, dense tensor-core bf16


def stem_inputs(n, c, hw, dtype, g):
    """An image in [-1, 1] (NCHW, channels_last), kaiming-scaled fp32
    weights, a small bias, and an incoming gradient of the output's shape."""
    dev = "cuda"
    x = (2 * torch.rand(n, 3, hw, hw, generator=g, device=dev) - 1).to(dtype)
    w = torch.randn(c, 3, 7, 7, generator=g, device=dev) * math.sqrt(2 / 147)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    gr = torch.randn(n, c, hw, hw, generator=g, device=dev).to(dtype)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    return cl(x), w, b, cl(gr)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def stem_bound(shape, c, dtype, norm, relu, backward, need_dx):
    """(ms, by) of one stem call.  Bytes: the image (and, backward, the
    incoming gradient) read once, the output (y; backward dx) written once.
    Operations: 2 * 148 * C per output pixel for the conv; the backward
    recomputes it (the mask and x-hat need it) unless there is neither norm
    nor ReLU, and does 2 * 148 * C for dW and db and 2 * 147 * C for dX;
    over the bf16 tensor-core rate for bf16 data, the fp32 rate for fp32."""
    n, _, h, w = shape
    px = n * h * w
    size = torch.finfo(dtype).bits // 8
    if backward:
        nbytes = (3 + c) * px * size + (3 * px * size if need_dx else 0)
        ops = 2 * 148 * c * px * ((norm == "in" or relu) + 1) \
            + (2 * 147 * c * px if need_dx else 0) + 11 * c * px * (norm == "in")
    else:
        nbytes = (3 + c) * px * size
        ops = 2 * 148 * c * px + 8 * c * px * (norm == "in")
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_grads(label, got, want, dtype):
    """dx (or None), dw, db against the plain backward: within BWD_FP32_REL
    (fp32) or BWD_BF16_REL (bf16) of each gradient's largest magnitude; db,
    the last row of the one [148, C] weight gradient, against that
    matrix's.  Returns (max abs err, max relative err)."""
    rel = BWD_FP32_REL if dtype == torch.float32 else BWD_BF16_REL
    wscale = max(float(want[1].abs().max()), float(want[2].abs().max()))
    max_err = max_rel = 0.0
    for name, a, b in zip(("dx", "dw", "db"), got, want):
        if a is None and b is None:
            continue
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label} {name}: not finite")
        scale = float(b.abs().max()) if name == "dx" else wscale
        err = float((a.float() - b.float()).abs().max())
        max_err, max_rel = max(max_err, err), max(max_rel, err / max(scale, 1e-30))
        if err > rel * scale + 1e-6:
            raise AssertionError(f"{label} {name}: max abs err {err:.3e} vs "
                                 f"largest {scale:.3e}")
    return max_err, max_rel


def check_stem(shape, c, norm, act, pad, dtype, stats, g, need_dx):
    """The stem forward kernel against its plain version and, unless
    `need_dx` is None, the backward kernel too.  Returns the inputs, outputs
    and errors for the timing."""
    x, w, b, gr = stem_inputs(shape[0], c, shape[2], dtype, g)
    label = f"stem {shape} C{c} {norm}/{act} {pad} {dtype} {stats}"
    w2p = stem.pack_weights(w, b, dtype)
    y, st = kernels.stem_conv7(x, w2p, norm, act, pad, stats)
    torch.cuda.synchronize()
    ref = stem.stem_conv7_plain(nhwc(x), w, b, norm, act, pad, stats)
    fwd_err = check_close(label, nhwc(y), ref.float(), dtype)
    out = dict(x=x, w=w, b=b, gr=gr, w2p=w2p, y=y, st=st, fwd_err=fwd_err)
    if need_dx is None:
        return out
    got = kernels.stem_conv7_bwd(x, w2p, gr, st, norm, act, pad, need_dx)
    torch.cuda.synchronize()
    # the ReLU mask from the kernel's own output, as phase 5 does
    want = stem.stem_conv7_bwd_plain(nhwc(x), w, b, nhwc(gr), norm, act, pad,
                                     stats, need_dx, out=nhwc(y))
    got = (None if got[0] is None else nhwc(got[0]),) + tuple(got[1:])
    out["bwd_err"], out["bwd_rel"] = check_grads(label, got, want, dtype)
    return out


def time_stem(site, dtype, stats, t):
    """Kernel, eager, plain and library times of the forward (and at a
    training site the backward) on copies of the inputs (cold L2)."""
    name, n, norm, act, _, _, need_dx = site
    x, w, b, gr, w2p, y, st = (t[k] for k in ("x", "w", "b", "gr", "w2p", "y", "st"))
    shape = tuple(x.shape)
    relu = act == "relu"
    copies = max(1, math.ceil(COLD_L2_BYTES / (x.numel() * x.element_size())))
    xs = [x] + [x.clone(memory_format=torch.preserve_format) for _ in range(copies - 1)]
    pick = lambda i: xs[i % len(xs)]
    fwd = lambda i: kernels.stem_conv7(pick(i), w2p, norm, act, "reflect", stats)
    xp = [F.pad(xi.float(), (3,) * 4, mode="reflect").to(dtype).contiguous(
        memory_format=torch.channels_last) for xi in xs]
    wl, bl = w.to(dtype), b.to(dtype)
    rows = [dict(kernel="stem_conv7", site=name, shape=list(shape), c=STEM_C,
                 norm=norm, act=act, dtype=str(dtype).replace("torch.", ""),
                 stats=stats, max_abs_err=t["fwd_err"], ms=device_ms(fwd),
                 eager_ms=time_ms(fwd),
                 plain_ms=device_ms(lambda i: stem.stem_conv7_plain(
                     nhwc(pick(i)), w, b, norm, act, "reflect", stats)),
                 library_ms=device_ms(lambda i: F.conv2d(xp[i % len(xp)], wl, bl)),
                 **dict(zip(("bound_ms", "bound_by"), stem_bound(
                     shape, STEM_C, dtype, norm, relu, False, False))))]
    if need_dx is None:
        return rows
    in_bytes = (x.numel() + gr.numel()) * x.element_size()
    copies = max(1, math.ceil(COLD_L2_BYTES / in_bytes))
    cp = [(x, gr, y)] + [tuple(u.clone(memory_format=torch.preserve_format)
                               for u in (x, gr, y)) for _ in range(copies - 1)]
    bwd = lambda i: kernels.stem_conv7_bwd(cp[i % copies][0], w2p, cp[i % copies][1],
                                           st, norm, act, "reflect", need_dx)
    plain = lambda i: stem.stem_conv7_bwd_plain(
        nhwc(cp[i % copies][0]), w, b, nhwc(cp[i % copies][1]), norm, act,
        "reflect", stats, need_dx, out=nhwc(cp[i % copies][2]))
    # the library: cuDNN's conv backward on the padded image (dx of the
    # padded image when the path needs dx; dW and db always)
    graphs = []
    for i in range(copies):
        xr = xp[i % len(xp)].detach().requires_grad_(need_dx)
        wr, br = wl.detach().requires_grad_(), bl.detach().requires_grad_()
        graphs.append((F.conv2d(xr, wr, br), (xr, wr, br) if need_dx else (wr, br),
                       cp[i][1]))
    lib = lambda i: torch.autograd.grad(graphs[i % copies][0], graphs[i % copies][1],
                                        graphs[i % copies][2], retain_graph=True)
    rows.append(dict(
        kernel="stem_conv7_bwd", site=name, shape=list(shape), c=STEM_C, norm=norm,
        act=act, dtype=str(dtype).replace("torch.", ""), stats=stats,
        need_dx=need_dx, max_abs_err=t["bwd_err"], max_rel_err=t["bwd_rel"],
        ms=device_ms(bwd), eager_ms=time_ms(bwd), plain_ms=device_ms(plain),
        library_ms=time_ms(lib),
        **dict(zip(("bound_ms", "bound_by"), stem_bound(
            shape, STEM_C, dtype, norm, relu, True, need_dx)))))
    del graphs
    return rows


def phase_stem():
    """Phase 8: the HMMA count of each bf16 tensor-core kernel of the stem;
    both stem kernels at every stem site of the stem-on paths,
    fp32 and bf16, both stats modes where there is a norm; then the three
    pad types at one small shape.  TF32 off for the plain and library runs.
    Returns (rows, HMMA counts)."""
    hmma = build.hmma_counts(STEM_MMA_KERNELS)
    log("stem_sass: HMMA instructions in the SASS of the stem's bf16 kernels "
        + json.dumps(hmma))
    if not all(hmma[k] > 0 for k in STEM_MMA_KERNELS):
        raise AssertionError(f"a bf16 stem kernel has no HMMA: {hmma}")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    for site in STEM_SITES:
        name, n, norm, act, per_batch, per_step, need_dx = site
        for dtype in (torch.float32, torch.bfloat16):
            for stats in (("1pass", "2pass") if norm == "in" else ("1pass",)):
                t = check_stem((n, 3, STEM_HW, STEM_HW), STEM_C, norm, act,
                               "reflect", dtype, stats, g, need_dx)
                for row in time_stem(site, dtype, stats, t):
                    row["calls_per_batch"] = per_batch if row["kernel"] == "stem_conv7" else 0
                    row["calls_per_step"] = per_step
                    rows.append(row)
                    log("stem_check " + json.dumps(row))
                del t
        torch.cuda.empty_cache()
    for pad in ("reflect", "replicate", "zero"):
        for dtype in (torch.float32, torch.bfloat16):
            for norm, act in (("in", "relu"), ("none", "relu")):
                t = check_stem(STEM_PAD_SHAPE, STEM_C, norm, act, pad, dtype,
                               "1pass", g, True)
                log("stem_pad_check " + json.dumps(dict(
                    shape=list(STEM_PAD_SHAPE), c=STEM_C, pad=pad, norm=norm,
                    act=act, dtype=str(dtype).replace("torch.", ""),
                    fwd_max_abs_err=t["fwd_err"], bwd_max_abs_err=t["bwd_err"],
                    bwd_max_rel_err=t["bwd_rel"])))
    torch.backends.cudnn.allow_tf32 = True
    return rows, hmma


# ---------------------------------------------------------------- phases 6, 7

def _draws(cfg, n, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (n, cfg.gen.num_cls, cfg.c_dim)
    return {"style1": torch.randn(shape, generator=g),
            "style2": torch.randn(shape, generator=g),
            "gp_alpha": torch.rand((n, 1, 1, 1), generator=g)}


# phase 14: the penalties through a discriminator with a norm (ROADMAP
# F10): the instance norm's and the LayerNorm's second-order rule
PENALTIES = ({"norm": "in", "gp_w": 10.0}, {"norm": "ln", "use_r1": True})


def phase_step_fp32(stem=False, options=False, penalty=None):
    """One fp32 step on the card against the same step on the CPU.  Both
    trainers draw their weights from the same seed on the CPU's generator,
    so they start identical; dropout is off and the style draws (and GP's
    mixing weights) are given.  `stem`: the config's `stem_pallas` on
    (phase 10); `options`: the block options of phase 14
    (`block_options`); `penalty`: `dis.norm` and GP or R1 (every step), one
    of PENALTIES (phase 14)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(str(CONFIG))
    cfg.compute_dtype, cfg.batch_size, cfg.stem_pallas = "float32", 2, stem
    if options:
        block_options(cfg)
    if penalty:
        cfg.dis.norm = penalty["norm"]
        cfg.gp_w = penalty.get("gp_w", 0.0)
        cfg.use_r1, cfg.d_reg_every = penalty.get("use_r1", False), 1
    results, secs = [], []
    for dev in ("cpu", "cuda"):
        state, _, _ = build_trainer(cfg, dev, seed=SEED)
        step = make_train_step(cfg, state.gen, state.dis, state.gen_opt,
                               state.dis_opt, vgg_loss_fn=build_vgg_loss(cfg, dev),
                               _deterministic=True)
        batch = synthetic_batches(cfg, dev, n=1, seed=SEED + 7)[0]
        draws = {k: v.to(dev) for k, v in _draws(cfg, 2, SEED + 8).items()}
        t0 = time.perf_counter()
        m = step(state, batch, draws=draws)
        results.append({k: float(v) for k, v in m.items()})
        secs.append(time.perf_counter() - t0)
    torch.backends.cudnn.allow_tf32 = True
    cpu, gpu = results
    if penalty and not gpu["loss_gp" if cfg.gp_w else "loss_r1"] > 0:
        raise AssertionError(f"penalty {penalty}: no penalty on the card: {gpu}")
    worst = max(abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-6) for k in cpu)
    bad = {k: (cpu[k], gpu[k]) for k in cpu
           if abs(gpu[k] - cpu[k]) > STEP_RTOL * abs(cpu[k]) + 1e-6}
    log(f"step_fp32: stem_pallas {stem}, block options {options}, penalty "
        f"{penalty}, flagship width, batch 2, VGG on, "
        f"every metric card vs CPU: "
        f"worst relative diff {worst:.3e} (rtol {STEP_RTOL}); CPU step "
        f"{secs[0]:.1f} s, card step (first, cold) {secs[1]:.1f} s; metrics "
        + json.dumps({k: [cpu[k], gpu[k]] for k in sorted(cpu)}))
    if bad or not all(math.isfinite(v) for v in gpu.values()):
        raise AssertionError(f"fp32 step card vs CPU: {bad}")
    return worst


def phase_train_bf16(card, stem=False, options=False, norm_compute="fp32"):
    """The flagship step through cli/train.py's trainer (`stem`: with
    `stem_pallas` on, phase 10; `options`: with the block options, phase
    14, which also checks that the PReLU slopes and the spectral-norm
    kernels moved and times the spectral norm's share of a step;
    `norm_compute` "bf16": phase 16, every launch of rows 1-3 and 5-6 in
    the bf16 arithmetic).  Returns (launches per step, timing)."""
    cfg = load_config(str(CONFIG))
    cfg.stem_pallas, cfg.norm_compute = stem, norm_compute
    if options:
        block_options(cfg)
    expected = STEM_TRAIN_LAUNCHES if stem else EXPECTED_TRAIN_LAUNCHES
    dev = torch.device("cuda")
    state, step, _ = build_trainer(cfg, dev, seed=SEED)
    batches = synthetic_batches(cfg, dev, seed=SEED + 9)
    gen0 = [p.detach().clone() for p in state.gen.parameters()]
    opt0 = option_params(state) if options else None
    ema0 = [p.detach().clone() for p in state.ema_gen.parameters()]
    for i in range(3):
        step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    reset_launches()
    norms.GRAD_COPIES.clear()
    m = step(state, batches[3 % len(batches)])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_arith_launches(launches, norm_compute)
    metrics = {k: float(v) for k, v in m.items()}
    log(f"train_bf16: stem_pallas {stem}, {cfg.compute_dtype}, norm_stats "
        f"{cfg.norm_stats}, batch {cfg.batch_size}, vgg_w {cfg.vgg_w}, launches "
        f"per step {launches}; incoming gradients copied into the kernels' "
        "layout and dtype, per site [backward calls, copies]: "
        + json.dumps(norms.GRAD_COPIES))
    if launches != expected:
        raise AssertionError(f"launches {launches} != {expected}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    moved = lambda now, before: max(float((a.detach() - b).abs().max())
                                    for a, b in zip(now, before))
    d_gen, d_ema = moved(state.gen.parameters(), gen0), moved(state.ema_gen.parameters(), ema0)
    if not (d_gen > 0 and 0 < d_ema < d_gen):
        raise AssertionError(f"parameters moved {d_gen}, EMA {d_ema}")
    if options:
        option_params_moved(state, opt0)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batches[i % len(batches)])
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    peak = torch.cuda.max_memory_allocated()
    ev = sorted(times)
    med = ev[len(ev) // 2]
    timing = dict(median_ms=med, min_ms=ev[0], max_ms=ev[-1],
                  images_per_s=cfg.batch_size / (med / 1e3), peak_mib=peak / 2**20)
    if options:
        timing.update(spectral_norm_share(state, step, batches[0]))
    log(f"train_bf16: stem_pallas {stem}, block options {bool(options)}, "
        f"norm_compute {norm_compute}, {TIMED_STEPS} steps of batch "
        f"{cfg.batch_size} after 4: CUDA-event ms per step median {med:.3f}, "
        f"min {ev[0]:.3f}, max {ev[-1]:.3f} -> {timing['images_per_s']:.2f} "
        f"images/s at the median; peak memory {peak / 2**20:.0f} MiB; last "
        "metrics " + json.dumps({k: float(v) for k, v in m.items()})
        + f"; card {card}")
    return launches, timing


# ---------------------------------------------------------------- phase 11

TXT_GAP_SHARE = 0.25   # card vs CPU, of the encoder's own fp32-vs-bf16 gap


class _CudnnLSTM(torch.nn.Module):
    """cuDNN's fused LSTM in bf16 behind the port's LSTM interface: the
    route the text encoder does not take, run here only to measure it."""

    def __init__(self, lstm):
        super().__init__()
        self.lstm = torch.nn.LSTM(lstm.input_size, lstm.hidden_size,
                                  num_layers=lstm.num_layers, bidirectional=True,
                                  batch_first=True)
        self.lstm.load_state_dict(lstm.state_dict())
        self.lstm.to(next(lstm.parameters()).device, torch.bfloat16)
        self.lstm.flatten_parameters()

    def forward(self, x, lengths, rng=None, rows=None):
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, lengths.cpu(), batch_first=True, enforce_sorted=False)
        _, (h, c) = self.lstm(packed)
        shape = (self.lstm.num_layers, 2) + tuple(h.shape[1:])
        return None, h.reshape(shape), c.reshape(shape)


def phase_txt_bf16(vocab):
    """Phase 11: the bf16 text encoder on the card against the same encoder
    on the CPU, whose loop is bit-equal to the JAX bf16 scan there
    (tests/test_torch_txt_dtype.py): `encode_txt`'s mu and logvar within a
    quarter of the encoder's fp32-vs-bf16 gap on the same inputs.  cuDNN's
    fused bf16 LSTM on the same inputs is measured beside it."""
    cfg = load_config(str(CONFIG))
    cfg32 = load_config(str(CONFIG))
    cfg32.compute_dtype = "float32"
    cpu = build_generator(cfg, vocab.size, device="cpu", seed=SEED)
    cpu32 = build_generator(cfg32, vocab.size, device="cpu", seed=SEED)
    card = build_generator(cfg, vocab.size, device="cuda", seed=SEED)
    _, cmds = synthetic_requests(BATCH, cfg.image_size, SEED + 2)
    ids, lens = (torch.from_numpy(a) for a in encode_commands(cmds, vocab, cfg.max_text_len))
    style = torch.randn(BATCH, cfg.gen.style_dim, generator=torch.Generator().manual_seed(SEED + 13))
    with torch.inference_mode():
        ref = cpu.encode_txt(style, ids, lens)
        ref32 = cpu32.encode_txt(style, ids, lens)
        got = card.encode_txt(style.cuda(), ids.cuda(), lens)
        loop = card.enc_txt.lstm
        card.enc_txt.lstm = _CudnnLSTM(loop)
        fused = card.enc_txt(style.cuda(), ids.cuda(), lens)
        card.enc_txt.lstm = loop
    def diff(a, b):
        d = torch.cat([(x.float().cpu() - y.float().cpu()).abs().flatten()
                       for x, y in zip(a, b)])
        return float(d.max()), float(d.mean())

    gap, err, err_fused = diff(ref32, ref), diff(got, ref), diff(fused, ref)
    log(f"txt_bf16: batch {BATCH}, longest command {int(lens.max())} tokens; "
        f"encode_txt (mu, logvar) (max, mean) abs diff from the CPU bf16 "
        f"encoder: card {err}, cuDNN's fused bf16 LSTM {err_fused}; fp32 vs "
        f"bf16 on the CPU {gap} (tolerance on the mean: {TXT_GAP_SHARE} of it)")
    if not err[1] <= TXT_GAP_SHARE * gap[1]:
        raise AssertionError(f"bf16 text encoder card vs CPU: mean {err[1]} > "
                             f"{TXT_GAP_SHARE} * {gap[1]}")
    return err, err_fused, gap


# ---------------------------------------------------------------- phase 12

CLI_STEPS = 6
# the loop's cadences of the 6-step run, set in a copy of the config
CLI_CADENCE = {"log_iter": 1, "image_display_iter": 3, "image_save_iter": 6,
               "snapshot_save_iter": 3}
CLI_PROCEDURAL = 512          # --procedural_size
CLI_NAME = CONFIG.stem        # the run's name: outputs/<name>, logs/<name>
CLI_GRIDS = ("train_current", "test_00000006", "train_00000006")
CLI_RENDERS = 4               # train_current at steps 3 and 6, test and train at 6
# one grid's forward launches: one encode (the content encoder's 11 instance
# norms) and three decodes (4 + 4 AdaIN, 2 LayerNorms each)
RENDER_LAUNCHES = {**{k: 0 for k in kernels.LAUNCHES}, "instance_norm": 11,
                   "adain": 12, "adain_residual": 12, "layer_norm_ref": 6}
CLI_NOT_METRICS = {"step", "time", "steps_per_sec", "images_per_sec"}


def state_tensors(state) -> dict:
    """A copy of every tensor of a training state by name (the optimizers'
    by parameter position): the nets, the EMA copies, Adam's moments and
    counts, the step and the step's random generator."""
    out = {"step": torch.tensor(state.step), "rng": state.rng.get_state()}
    for name in ("gen", "dis", "ema_gen", "ema_dis"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v.detach().clone()
    for name in ("gen_opt", "dis_opt"):
        for i, st in getattr(state, name).state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}.{i}.{k}"] = v.detach().clone()
    return out


class StepProbe:
    """Wraps the training CLI's step (through its `make_train_step`): the
    kernel launches, CUDA-event times and host start time of each step, and
    a copy of the state after step `keep`."""

    def __init__(self, keep=None):
        self.keep, self.kept = keep, None
        self.launches, self.events, self.starts = [], [], []

    def __enter__(self):
        self._real = train_cli.make_train_step

        def make(*args, **kw):
            step = self._real(*args, **kw)

            def probed(state, batch, **kw2):
                before = dict(kernels.LAUNCHES)
                self.starts.append(time.perf_counter())
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                m = step(state, batch, **kw2)
                stop.record()
                self.events.append((start, stop))
                self.launches.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
                if state.step == self.keep:
                    self.kept = state_tensors(state)
                return m

            return probed

        train_cli.make_train_step = make
        return self

    def __exit__(self, *exc):
        train_cli.make_train_step = self._real

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def cli_config(tmp: Path) -> str:
    """A copy of the flagship config, under its own name, with the 6-step
    run's cadences."""
    text = CONFIG.read_text()
    for key, val in CLI_CADENCE.items():
        text, n = re.subn(rf"^{key}:.*$", f"{key}: {val}", text, flags=re.M)
        if n != 1:
            raise AssertionError(f"{key} is not set once in {CONFIG}")
    path = tmp / CONFIG.name
    path.write_text(text)
    return str(path)


def run_cli(cfg_path: str, out: Path, *extra, keep=None):
    """`cli/train.py`'s main in this process: procedural data, 6 steps.
    Returns (state, metric rows, probe, seconds)."""
    with StepProbe(keep) as probe:
        t0 = time.perf_counter()
        state, _ = train_cli.main(
            ["--config", cfg_path, "--procedural_data", "--procedural_size",
             str(CLI_PROCEDURAL), "--output_path", str(out), "--max_steps",
             str(CLI_STEPS), *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    with open(out / "logs" / CLI_NAME / "metrics.jsonl") as f:
        rows = [json.loads(ln) for ln in f]
    return state, rows, probe, secs


def metric_diff(rows_a, rows_b):
    """The relative differences of every logged metric (the step and the
    wall-clock fields aside) between two runs' rows of the same steps: (their mean, their
    largest, its metric and step).  The mean is what phase 12 compares: the
    largest is one noisy metric (the gradient norm's) at one step, and
    ranks two runs by chance."""
    if [r["step"] for r in rows_a] != [r["step"] for r in rows_b]:
        raise AssertionError(f"steps {[r['step'] for r in rows_a]} against "
                             f"{[r['step'] for r in rows_b]}")
    rel = [(abs(a[k] - b[k]) / max(abs(a[k]), 1e-6), k, a["step"])
           for a, b in zip(rows_a, rows_b) for k in a if k not in CLI_NOT_METRICS]
    return (sum(r[0] for r in rel) / len(rel), *max(rel))


def load_grid(images: Path, tag: str):
    """A saved grid: the `.jpg` where PIL wrote it, else the `.jpg.npy`."""
    npy = images / f"{tag}.jpg.npy"
    if npy.exists():
        return np.load(npy)
    from PIL import Image
    with Image.open(images / f"{tag}.jpg") as im:
        return np.asarray(im)


def feed_ms(cfg, dev, batches: int = 4):
    """Host ms per batch of the run's feed, on one thread: building a batch
    of fresh procedural faces (`DataPipeline._collate`, as a worker does)
    and `to_device` (pinned copy, non_blocking, then a sync)."""
    ds = ProceduralFaceDataset(n_samples=CLI_PROCEDURAL, image_size=cfg.image_size,
                               seed=cfg.seed, max_text_len=cfg.max_text_len,
                               dataset=cfg.dataset)
    pipe = DataPipeline(ds, cfg.batch_size, seed=cfg.seed)
    stream = pipe._index_stream()
    build_s, copy_s = [], []
    for _ in range(batches):
        epoch, idxs = next(stream)
        t0 = time.perf_counter()
        b = pipe._collate(idxs, epoch)
        t1 = time.perf_counter()
        to_device(b, dev)
        torch.cuda.synchronize()
        build_s.append(t1 - t0)
        copy_s.append(time.perf_counter() - t1)
    return 1e3 * sum(build_s) / batches, 1e3 * sum(copy_s) / batches


def phase_train_cli(card, train_off):
    """Phase 12: `cli/train.py` end to end on the card (module docstring).
    `train_off`: phase 7's timing, printed beside this run's."""
    dev = torch.device("cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        cfg_path = cli_config(tmp)
        cfg = load_config(cfg_path)
        vocab = Vocab(cfg.dataset)

        # the run, 6 steps, the state after step 3 kept in memory
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        state_a, rows_a, probe_a, secs_a = run_cli(cfg_path, tmp / "a", keep=3)
        launches = dict(kernels.LAUNCHES)
        want = {k: CLI_STEPS * EXPECTED_TRAIN_LAUNCHES[k] + CLI_RENDERS * RENDER_LAUNCHES[k]
                for k in kernels.LAUNCHES}
        if launches != want or any(l != EXPECTED_TRAIN_LAUNCHES for l in probe_a.launches):
            raise AssertionError(f"launches {launches} != {want}; per step "
                                 f"{probe_a.launches}")
        out = tmp / "a" / "outputs" / CLI_NAME
        if [r["step"] for r in rows_a] != list(range(1, CLI_STEPS + 1)) or not all(
                math.isfinite(v) for r in rows_a for v in r.values()):
            raise AssertionError(f"metric rows {rows_a}")
        if checkpoint_steps(str(out / "checkpoints")) != [3, 6]:
            raise AssertionError(f"checkpoints {os.listdir(out / 'checkpoints')}")
        grid_shape = (5 * cfg.image_size, cfg.display_size * cfg.image_size, 3)
        for tag in CLI_GRIDS:
            grid = load_grid(out / "images", tag)
            if tuple(grid.shape) != grid_shape or int(grid.max()) == int(grid.min()):
                raise AssertionError(f"grid {tag}: shape {tuple(grid.shape)}, "
                                     f"range {int(grid.min())}..{int(grid.max())}")
        if not (out / "index.html").exists():
            raise AssertionError("no index.html")
        step_ms = probe_a.step_ms()[1:]                    # steps 2-6
        loop_ms = [1e3 * (b - a) for a, b in zip(probe_a.starts, probe_a.starts[1:])]

        # (a) step 3's checkpoint restored into a fresh trainer: bit-equal
        fresh = build_trainer(cfg, dev)[0]
        mgr = CheckpointManager(str(out / "checkpoints"),
                                header=checkpoint_header(cfg, vocab.size, CLI_NAME))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore(fresh, step=3)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = state_tensors(fresh)
        bad = [k for k, v in probe_a.kept.items()
               if not (v.dtype == got[k].dtype and v.device == got[k].device
                       and torch.equal(v, got[k]))]
        if got.keys() != probe_a.kept.keys() or bad:
            raise AssertionError(f"restored state differs from step 3's: {bad[:8]}")
        n_tensors = len(got)
        del fresh, got
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = CheckpointManager(str(tmp / "timed")).save(state_a)
        save_s = time.perf_counter() - t0
        mib = os.path.getsize(saved) / 2**20
        os.remove(saved)
        del state_a

        # (b) steps 4-6 resumed from step 3's file; (c) the run again
        ckpts_b = tmp / "b" / "outputs" / CLI_NAME / "checkpoints"
        ckpts_b.mkdir(parents=True)
        shutil.copy(out / "checkpoints" / "ckpt_00000003.pt", ckpts_b)
        rows_b = run_cli(cfg_path, tmp / "b", "--resume", "1")[1]
        rows_c = run_cli(cfg_path, tmp / "c")[1]
        shutil.rmtree(tmp / "c")
        resumed, *resumed_max = metric_diff(rows_a[3:], rows_b)
        repeat, *repeat_max = metric_diff(rows_a[3:], rows_c[3:])
        if not resumed <= repeat:
            raise AssertionError(f"resumed run {resumed} from the run, beyond "
                                 f"the run's own repeat {repeat}")

        # serve the EMA generator of step 6's checkpoint
        gen = build_generator(cfg, vocab.size, device=dev)
        step = load_checkpoint(gen, cfg, vocab.size, str(out / "checkpoints"))
        imgs, cmds = synthetic_requests(BATCH, cfg.image_size, SEED + 3)
        y = translate_batch(make_infer_fn(cfg, gen), imgs, cmds, vocab,
                            cfg.max_text_len, dev)
        if step != CLI_STEPS or tuple(y.shape) != (BATCH, cfg.image_size, cfg.image_size, 3) \
                or not torch.isfinite(y).all() or float(y.abs().max()) > 1.0:
            raise AssertionError(f"served step {step}: shape {tuple(y.shape)}, "
                                 f"max |y| {float(y.abs().max())}")
        n = cfg.display_size
        ids, lens = encode_commands(cmds[:n], vocab, cfg.max_text_len)
        rows = make_sample_fn(cfg, gen)(
            torch.from_numpy(imgs[:n]).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(lens), True,
            generator=torch.Generator(dev).manual_seed(0))
        if len(rows) != 5 or not all(torch.isfinite(r).all() for r in rows):
            raise AssertionError("the grid's rows of the served checkpoint")
    build_ms, copy_ms = feed_ms(cfg, dev)
    med = lambda v: sorted(v)[len(v) // 2]
    result = dict(step_ms=med(step_ms), step_ms_min=min(step_ms),
                  step_ms_max=max(step_ms), phase7_step_ms=train_off["median_ms"],
                  loop_ms=med(loop_ms[1:]), run_s=secs_a, feed_build_ms=build_ms,
                  feed_to_device_ms=copy_ms, ckpt_mib=mib, ckpt_save_s=save_s,
                  ckpt_restore_s=restore_s, resumed_diff=resumed, repeat_diff=repeat)
    log(f"train_cli: {CLI_STEPS} steps of {cfg_path.split('/')[-1]} ({cfg.compute_dtype}, "
        f"batch {cfg.batch_size}, {cfg.image_size} px) through cli/train.py on "
        f"--procedural_data {CLI_PROCEDURAL}: launches {launches} (per step "
        f"{EXPECTED_TRAIN_LAUNCHES}, per grid {RENDER_LAUNCHES}); 6 metric rows, "
        f"checkpoints 3 and 6, grids {CLI_GRIDS} and index.html; step 3 restored "
        f"into a fresh trainer bit-equal in all {n_tensors} tensors; steps 4-6 "
        f"resumed vs the run: mean relative metric diff {resumed:.3e} (largest "
        f"{resumed_max[0]:.3e}, {resumed_max[1]} at step {resumed_max[2]}), a second "
        f"uninterrupted run vs the run {repeat:.3e} (largest {repeat_max[0]:.3e}, "
        f"{repeat_max[1]} at step {repeat_max[2]}); step {step}'s EMA generator "
        f"served {BATCH} images finite in [-1, 1]")
    log(f"train_cli: CUDA-event ms per step, steps 2-6 with the real feed: median "
        f"{result['step_ms']:.3f} (min {result['step_ms_min']:.3f}, max "
        f"{result['step_ms_max']:.3f}); phase 7 (batches already on the card) "
        f"{result['phase7_step_ms']:.3f}; host ms from one step's start to the "
        f"next's, steps 2-5 (step 3's grid and snapshot inside one), median "
        f"{result['loop_ms']:.3f}; "
        f"the run {secs_a:.1f} s with the model's build; feed host ms per batch "
        f"(one thread): build {build_ms:.3f}, to_device {copy_ms:.3f}; checkpoint "
        f"{mib:.1f} MiB, save {save_s:.3f} s, restore {restore_s:.3f} s; card {card}")
    return result


# ---------------------------------------------------------------- phase 13

EVAL_FACES = 512                # each of: the fakes' sources, real sets A and B
EVAL_SEEDS = {"sources": SEED + 30, "real_a": SEED + 31, "real_b": SEED + 32}
EVAL_STEP = 7                   # the imported checkpoint's step
IV3_CHECK = 4                   # images of the card-vs-CPU feature check
IV3_REL = 1e-3                  # card vs CPU, of the largest feature / logit


def procedural_faces(cfg, n: int, seed: int):
    """n procedural faces [n, H, W, 3] in [-1, 1], and for each a command
    synthesized from its labels to those of a random face of the set."""
    ds = ProceduralFaceDataset(n_samples=n, image_size=cfg.image_size, seed=seed,
                               max_text_len=cfg.max_text_len, dataset=cfg.dataset,
                               cache=False)
    rng = random.Random(seed)
    synth = TextSynthesizer(rng)
    cmds = [synth(ds.labels[i], ds.labels[rng.randrange(n)]) for i in range(n)]
    return np.stack([ds.render(i) for i in range(n)]), cmds


def host_state(module) -> dict:
    """A copy of a module's state on the host, as a checkpoint holds it."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def torchvision_inception_pth(model, path: Path) -> None:
    """`model`'s weights as torchvision ships them: its names, plus every
    BN's `num_batches_tracked` and the `AuxLogits` head's tensors."""
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    for k in [k for k in sd if k.endswith(".bn.running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["AuxLogits.conv0.bn.running_var"] = torch.ones(128)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    torch.save(sd, path)


FP32_FLOPS_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores (data sheet)


def conv_fc_flops(model, x) -> int:
    """Multiply-add operations (2 each) of `model`'s convolutions and
    Linear layers on `x`, counted from their output shapes by hooks."""
    total = [0]

    def count(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
        else:
            k = mod.in_features
        total[0] += 2 * k * out.numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def phase_eval(card):
    """Phase 13: the reference import and FID/IS evaluation on the card
    (module docstring)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = load_config(str(CONFIG))
    vocab = Vocab(cfg.dataset)
    torch.cuda.reset_peak_memory_stats()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # the reference import, then the evaluation loader
        gen_sd = host_state(build_generator(cfg, vocab.size, device=dev, seed=SEED))
        dis_sd = host_state(build_discriminator(cfg, device=dev, seed=SEED + 1))
        g = torch.Generator().manual_seed(SEED + 33)
        for k in [k for k in gen_sd if "bias_hh" in k]:   # zero in the port
            gen_sd[k] = 0.1 * torch.randn(gen_sd[k].shape, generator=g)
        torch.save({"a": gen_sd}, tmp / "gen.pt")
        torch.save({"b": dis_sd}, tmp / "dis.pt")
        ckpt = import_reference.main(
            ["--config", str(CONFIG), "--gen_pt", str(tmp / "gen.pt"), "--dis_pt",
             str(tmp / "dis.pt"), "--out", str(tmp / "ckpt"), "--step", str(EVAL_STEP)])
        gen, step = evaluate.load_generator(cfg, vocab.size, str(tmp / "ckpt"), True, dev)
        want = dict(gen_sd)                   # the fold: bias_ih + bias_hh, bias_hh 0
        for k in [k for k in gen_sd if "bias_hh" in k]:
            ih = k.replace("bias_hh", "bias_ih")
            want[ih], want[k] = gen_sd[ih] + gen_sd[k], torch.zeros_like(gen_sd[k])
        got = host_state(gen)
        saved_dis = torch.load(ckpt, map_location="cpu", weights_only=True)["ema_dis"]
        bad = [k for k in want if not (k in got and got[k].dtype == torch.float32
                                       and torch.equal(got[k], want[k]))]
        bad += [k for k in dis_sd if not torch.equal(saved_dis[k], dis_sd[k])]
        if step != EVAL_STEP or got.keys() != want.keys() or bad:
            raise AssertionError(f"imported step {step}, tensors that differ {bad[:8]}")
        n_gen_tensors = len(got)

        # the fakes: the harness's per-batch call, rows 1-4 on the card
        t0 = time.perf_counter()
        sources, cmds = procedural_faces(cfg, EVAL_FACES, EVAL_SEEDS["sources"])
        real_a = procedural_faces(cfg, EVAL_FACES, EVAL_SEEDS["real_a"])[0]
        real_b = procedural_faces(cfg, EVAL_FACES, EVAL_SEEDS["real_b"])[0]
        render_s = time.perf_counter() - t0
        infer = make_infer_fn(cfg, gen)
        fakes, per_batch, gen_s = [], [], []
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        for i in range(0, EVAL_FACES, BATCH):
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            fakes.append(harness.fake_batch(infer, sources[i: i + BATCH],
                                            cmds[i: i + BATCH], vocab,
                                            cfg.max_text_len, dev))
            gen_s.append(time.perf_counter() - t0)
            per_batch.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
        launches = dict(kernels.LAUNCHES)
        n_batches = EVAL_FACES // BATCH
        if any(b != SERVE_LAUNCHES for b in per_batch) or launches != {
                k: n_batches * v for k, v in SERVE_LAUNCHES.items()}:
            raise AssertionError(f"fake batches' launches {launches}, per batch {per_batch}")
        fake_all = np.concatenate(fakes)
        if fake_all.shape != sources.shape or not np.isfinite(fake_all).all() \
                or float(np.abs(fake_all).max()) > 1.0:
            raise AssertionError(f"fakes: shape {fake_all.shape}, max |x| "
                                 f"{float(np.abs(fake_all).max())}")
        del gen, infer

        # InceptionV3 at full width: card against the CPU, fp32, TF32 off
        iv3_cpu = init_random_inception(SEED)
        iv3 = copy.deepcopy(iv3_cpu).to(dev)
        check = real_a[:IV3_CHECK]
        f_card, l_card = harness.FeatureExtractor(iv3).run([check])
        f_cpu, l_cpu = harness.FeatureExtractor(iv3_cpu).run([check])
        f_rel = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
        l_rel = float(np.abs(l_card - l_cpu).max() / np.abs(l_cpu).max())
        if not (f_rel <= IV3_REL and l_rel <= IV3_REL):
            raise AssertionError(f"inception card vs CPU: features {f_rel}, logits {l_rel}")
        del iv3_cpu
        # ... and through a torchvision-layout file and the converter
        torchvision_inception_pth(iv3, tmp / "iv3.pth")
        convert_inception.convert(str(tmp / "iv3.pth"), str(tmp / "iv3.npz"))
        iv3_conv = convert_inception.load_converted(str(tmp / "iv3.npz"),
                                                    InceptionV3().to(dev))
        f_conv, l_conv = harness.FeatureExtractor(iv3_conv).run([check])
        if not (np.array_equal(f_conv, f_card) and np.array_equal(l_conv, l_card)):
            raise AssertionError("converted inception's features differ from the module's")
        del iv3_conv

    # the scores, then the timed parts
    batches = lambda a: (a[i: i + BATCH] for i in range(0, len(a), BATCH))
    vs_fakes = harness.compute_fid_is(batches(real_a), fakes, iv3)
    vs_real = harness.compute_fid_is(batches(real_a), batches(real_b), iv3)
    nums = [vs_fakes[k] for k in ("fid", "is_mean", "is_std")] + \
        [vs_real[k] for k in ("fid", "is_mean", "is_std")]
    if not all(math.isfinite(x) for x in nums) or not vs_real["fid"] < vs_fakes["fid"] \
            or not all(1.0 <= r["is_mean"] <= 1000.0 for r in (vs_fakes, vs_real)):
        raise AssertionError(f"scores: vs fakes {vs_fakes}, vs set B {vs_real}")
    ex = harness.FeatureExtractor(iv3)
    ex.run(batches(real_a[:BATCH]))                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats_a, _ = ex.run(batches(real_a))
    iv3_s = time.perf_counter() - t0
    feats_f, _ = ex.run(fakes)
    # the trunk alone on a batch already at 299 px, by CUDA events
    x299 = preprocess_for_inception(torch.from_numpy(real_a[:BATCH]).to(dev))
    with torch.inference_mode(), fp32_precision():
        trunk_ms = time_ms(lambda i: iv3(x299), iters=10)
    trunk_flop = conv_fc_flops(iv3, x299)
    t0 = time.perf_counter()
    fid_from_stats(*feature_stats(feats_a), *feature_stats(feats_f))
    stats_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t_phase
    gen_ips = (EVAL_FACES - BATCH) / sum(gen_s[1:])
    result = dict(vs_fakes=vs_fakes, vs_real_b=vs_real, gen_images_per_s=gen_ips,
                  gen_first_batch_s=gen_s[0], iv3_images_per_s=EVAL_FACES / iv3_s,
                  stats_host_s=stats_s, peak_mib=peak / 2**20, trunk_ms=trunk_ms,
                  trunk_tflop_per_s=trunk_flop / trunk_ms / 1e9,
                  phase_s=wall, render_s=render_s, iv3_card_vs_cpu=(f_rel, l_rel))
    log(f"eval: reference state dicts at flagship width imported at step {step} "
        f"(bias_hh folded into bias_ih) and loaded back through evaluate.load_generator: "
        f"all {n_gen_tensors} generator tensors bit-equal to the folded state, the "
        f"discriminator's EMA copy to its state; {EVAL_FACES} procedural faces through "
        f"harness.fake_batch at batch {BATCH} ({cfg.compute_dtype}, {cfg.norm_stats}): "
        f"launches {launches} ({SERVE_LAUNCHES} in each of {n_batches} batches, no "
        f"backward), fakes finite in [-1, 1]")
    log(f"eval: InceptionV3 (random init, seed {SEED}), {IV3_CHECK} images, fp32, TF32 "
        f"off: card vs CPU max diff / largest: features {f_rel:.3e}, logits {l_rel:.3e} "
        f"(tolerance {IV3_REL}); through a torchvision-layout .pth, convert_inception "
        f"and load_converted: features and logits bit-equal on the card")
    log(f"eval: scores, real set A ({EVAL_FACES}) vs the fakes: {json.dumps(vs_fakes)}; "
        f"A vs real set B ({EVAL_FACES}): {json.dumps(vs_real)}; card {card}")
    log(f"eval: generation {gen_ips:.1f} images/s (batches 2-{n_batches}, host images "
        f"in, fakes back on the host; the first batch {gen_s[0]:.3f} s); card {card}")
    log(f"eval: InceptionV3 {EVAL_FACES / iv3_s:.1f} images/s ({EVAL_FACES} images of "
        f"{cfg.image_size} px in batches of {BATCH}, the copy to the card and the resize "
        f"to 299 included); the trunk alone on a batch of {BATCH} at 299 px "
        f"(CUDA events, mean of 10): {trunk_ms:.3f} ms, {BATCH / trunk_ms * 1e3:.1f} "
        f"images/s, {trunk_flop / BATCH / 1e9:.3f} GFLOP an image of convolutions and "
        f"products, {trunk_flop / trunk_ms / 1e9:.2f} TFLOP/s = "
        f"{trunk_flop / trunk_ms / 1e-3 / FP32_FLOPS_PER_S:.3f} of the fp32 peak; "
        f"card {card}")
    log(f"eval: host seconds of feature_stats (twice, {EVAL_FACES} x 2048) and "
        f"fid_from_stats: {stats_s:.3f}; card {card}")
    log(f"eval: peak memory {peak / 2**20:.0f} MiB; card {card}")
    log(f"eval: phase wall time {wall:.1f} s (rendering the {3 * EVAL_FACES} faces "
        f"{render_s:.1f} s of it); card {card}")
    return result


# ---------------------------------------------------------------- phases 3, 4

# ---------------------------------------------------------------- phase 14

# the flagship sites whose fused ReLU `activ: prelu` takes away: the
# forwards of one served batch, and the forward / backward pairs of one
# training step
NORELU_FWD_SITES = tuple(dict.fromkeys((k, s) for k, s, relu, _ in SITES if relu))
NORELU_BWD_SITES = tuple(dict.fromkeys((c, f, s) for c, f, s, relu, _, _ in BWD_SITES
                                       if relu))
DIS_BN_REL = 2e-3        # bn discriminator card vs CPU, of each output's largest
LEGACY_DIMS = {
    "AdaINGenV1": dict(dim=64, n_downsample=2, n_res=4, mlp_dim=256, style_dim=8,
                       embed_dim=300, hidden_size=300, num_layers=2),
    "VAEGen": dict(dim=64, n_downsample=2, n_res=4),
}
LEGACY_BATCHES = 10      # timed legacy batches


def block_options(cfg):
    """The flagship config with every block option a user can set today
    that the flagship leaves off: PReLU in both nets, spectral norm in D."""
    cfg.gen.activ = cfg.dis.activ = "prelu"
    cfg.dis.norm = "sn"
    return cfg


def option_params(state) -> dict:
    """The PReLU slopes of both nets and D's spectral-norm kernels (every
    block but each tower's first), copied."""
    out = {f"gen.{n}": p for n, p in state.gen.named_parameters()
           if n.endswith("activation.weight")}
    out.update({f"dis.{n}": p for n, p in state.dis.named_parameters()
                if n.endswith("activation.weight")
                or (n.endswith(".conv.weight") and ".0.conv" not in n)})
    return {k: p.detach().clone() for k, p in out.items()}


def option_params_moved(state, before: dict) -> None:
    now = option_params(state)
    still = [k for k in before if torch.equal(now[k], before[k])]
    if still or not before:
        raise AssertionError(f"option parameters that did not move: {still}")


def spectral_norm_share(state, step, batch) -> dict:
    """How often one step computes a spectral norm (one more step, with
    `spectral_sigma` counting its calls), and those calls' time: each
    matrix's sigma (30 power iterations, then v . (W u)) timed alone, eager
    (as the step issues it) and on the device (CUDA graph), summed over
    the step's calls."""
    calls = []
    orig = blocks.spectral_sigma

    def counting(w_mat, n_iter=blocks.SN_ITERS):
        calls.append(tuple(w_mat.shape))
        return orig(w_mat, n_iter)

    blocks.spectral_sigma = counting
    try:
        step(state, batch)
    finally:
        blocks.spectral_sigma = orig
    torch.cuda.synchronize()
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    eager = device = 0.0
    shapes = {}
    for shape in calls:
        shapes[shape] = shapes.get(shape, 0) + 1
    for shape, n in shapes.items():
        w = torch.randn(shape, generator=g, device="cuda") * 0.02
        eager += n * time_ms(lambda i: orig(w))
        device += n * device_ms(lambda i: orig(w))
    return dict(sn_calls_per_step=len(calls), sn_eager_ms_per_step=eager,
                sn_device_ms_per_step=device,
                sn_shapes={str(list(k)): v for k, v in shapes.items()})


def check_norelu_sites() -> dict:
    """Rows 1-2 (forward) and 5-6 (backward) with `relu=False` at every
    flagship site where they fuse a ReLU, fp32 and bf16, both stats modes,
    two runs bit-equal, against the plain versions with phases 2 and 5's
    tolerances.  Returns the worst errors."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    worst = {"fwd": 0.0, "bwd_rel": 0.0, "checks": 0}
    for kernel, shape in NORELU_FWD_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            for stats in ("2pass", "1pass"):
                args = site_inputs(kernel, shape, dtype, g)
                out, again = (run_kernel(kernel, args, False, stats) for _ in range(2))
                if not torch.equal(out, again):
                    raise AssertionError(f"{kernel} {shape} relu=False: two runs differ")
                err = check_forward(kernel, shape, False, dtype, stats, args, out)
                worst["fwd"] = max(worst["fwd"], err)
                worst["checks"] += 1
    for counter, fwd, shape in NORELU_BWD_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            for stats in ("2pass", "1pass"):
                args = site_inputs(fwd, shape, dtype, g)
                x, params = args[0], args[1:]
                out, st = run_kernel_stats(fwd, args, False, stats)
                worst["fwd"] = max(worst["fwd"], check_forward(
                    fwd, shape, False, dtype, stats, args, out))
                gr = torch.randn(out.shape, generator=g, device="cuda").to(
                    dtype).contiguous(memory_format=torch.channels_last)
                got, again = (run_bwd(counter, x, gr, st, params, False)
                              for _ in range(2))
                label = f"{counter} {shape} {dtype} {stats} relu=False"
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label}: two runs differ")
                want = run_bwd_plain(counter, x.float(), gr.float(), out.float(),
                                     params, False, stats)
                worst["bwd_rel"] = max(worst["bwd_rel"],
                                       check_bwd_close(label, got, want, dtype)[1])
                worst["checks"] += 2
        torch.cuda.empty_cache()
    return worst


def phase_dis_bn() -> float:
    """The discriminator with `dis.norm: bn` at flagship width, fp32, TF32
    off: a forward on [16, 128, 128, 3] on the card against the CPU, every
    scale's outputs within DIS_BN_REL of their largest magnitude."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(str(CONFIG))
    cfg.compute_dtype, cfg.dis.norm = "float32", "bn"
    cpu = build_discriminator(cfg, device="cpu", seed=SEED)
    gpu = build_discriminator(cfg, device="cuda", seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(SEED + 42)
    x = torch.rand((16, cfg.image_size, cfg.image_size, 3), generator=g) * 2 - 1
    with torch.no_grad():
        want, got = cpu(x), gpu(x.cuda())
    torch.backends.cudnn.allow_tf32 = True
    worst = 0.0
    for pair, wpair in zip(got, want):
        for a, b in zip(pair, wpair):
            rel = float((a.cpu() - b).abs().max()) / float(b.abs().max())
            worst = max(worst, rel)
            if not torch.isfinite(a).all() or rel > DIS_BN_REL:
                raise AssertionError(f"bn discriminator card vs CPU: {rel:.3e}")
    log(f"dis_bn: flagship width, batch 16, fp32, every scale's outputs card vs "
        f"CPU within {worst:.3e} of their largest (bound {DIS_BN_REL})")
    return worst


def legacy_serve(kind, model, imgs, ids, lens, dev):
    """A legacy generator's serving path on host images: `AdaINGenV1`
    encodes, text-encodes the commands and decodes, blended by its
    attention as `translate_batch` blends; `VAEGen` runs its deterministic
    forward.  fp32 NHWC on the card."""
    x = torch.from_numpy(imgs).to(dev)
    with torch.inference_mode():
        if kind == "VAEGen":
            return model(x)[0].float()
        content, mu, _ = model.encode(x)
        mu_t, _ = model.encode_txt(mu, torch.from_numpy(ids).to(dev),
                                   torch.from_numpy(lens))
        img, att = model.decode(content, mu_t)
        return blend_attention(img, att, x)


def phase_legacy(vocab, card) -> dict:
    """The legacy generators at flagship width: fp32 card vs CPU on 4
    images (phase 3's tolerance), then bf16 at batch 32: exactly phase 4's
    launches per batch, finite output in [-1, 1], images/s and peak
    memory."""
    cfg = load_config(str(CONFIG))
    imgs, cmds = synthetic_requests(BATCH, cfg.image_size, SEED + 40)
    ids, lens = encode_commands(cmds, vocab, cfg.max_text_len)
    dev = torch.device("cuda")
    out = {}
    for kind, dims in LEGACY_DIMS.items():
        kw = dict(dims, vocab_size=vocab.size) if kind == "AdaINGenV1" else dims
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cpu = build_legacy_generator(kind, device="cpu", seed=SEED, **kw)
        gpu = build_legacy_generator(kind, device="cuda", seed=SEED, **kw)
        gpu.load_state_dict(cpu.state_dict())
        diff = float((legacy_serve(kind, gpu, imgs[:4], ids[:4], lens[:4], dev).cpu()
                      - legacy_serve(kind, cpu, imgs[:4], ids[:4], lens[:4],
                                     torch.device("cpu"))).abs().max())
        torch.backends.cudnn.allow_tf32 = True
        if diff > SLICE_ATOL:
            raise AssertionError(f"{kind} fp32 card vs CPU: {diff}")
        del cpu, gpu
        model = build_legacy_generator(kind, device=dev, seed=SEED,
                                       dtype=torch.bfloat16, stats=cfg.norm_stats, **kw)
        serve = lambda: legacy_serve(kind, model, imgs, ids, lens, dev).cpu()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        y = serve()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if launches != SERVE_LAUNCHES:
            raise AssertionError(f"{kind}: launches {launches} != {SERVE_LAUNCHES}")
        if tuple(y.shape) != imgs.shape or not torch.isfinite(y).all() \
                or float(y.abs().max()) > 1.0:
            raise AssertionError(f"{kind}: bad output {tuple(y.shape)}, "
                                 f"max |x| {float(y.abs().max())}")
        for _ in range(3):
            serve()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(LEGACY_BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            serve()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        ev = sorted(times)
        med = ev[len(ev) // 2]
        out[kind] = dict(fp32_max_abs_diff=diff, launches=launches, median_ms=med,
                         min_ms=ev[0], max_ms=ev[-1],
                         images_per_s=BATCH / (med / 1e3),
                         peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        log(f"legacy {kind}: fp32 card vs CPU max abs diff {diff:.3e} (bound "
            f"{SLICE_ATOL}); bf16 batch {BATCH}, norm_stats {cfg.norm_stats}, "
            f"launches per batch {launches}; {LEGACY_BATCHES} batches after 4: "
            f"CUDA-event ms median {med:.3f}, min {ev[0]:.3f}, max {ev[-1]:.3f} "
            f"-> {out[kind]['images_per_s']:.1f} images/s; peak memory "
            f"{out[kind]['peak_mib']:.0f} MiB; card {card}")
        del model
        torch.cuda.empty_cache()
    return out


def phase_block_options(vocab, card, train_off) -> dict:
    """Phase 14: the block options and the legacy family on the card."""
    t0 = time.perf_counter()
    norelu = check_norelu_sites()
    log("norelu_check: rows 1-2 forward and 5-6 backward with relu=False at "
        f"every flagship ReLU site: {json.dumps(norelu)}")
    step_worst = phase_step_fp32(options=True)
    penalty_worst = [phase_step_fp32(penalty=p) for p in PENALTIES]
    launches, timing = phase_train_bf16(card, options=True)
    dis_bn = phase_dis_bn()
    legacy = phase_legacy(vocab, card)
    wall = time.perf_counter() - t0
    result = dict(norelu=norelu, step_fp32_worst=step_worst,
                  penalty_step_fp32_worst=penalty_worst, launches=launches,
                  step=timing, phase7_median_ms=train_off["median_ms"],
                  dis_bn_worst=dis_bn, legacy=legacy, wall_s=wall)
    log("block_options: " + json.dumps(result) + f"; card {card}")
    return result


def phase_slice_fp32(vocab, stem=False):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(str(CONFIG))
    cfg.compute_dtype, cfg.stem_pallas = "float32", stem
    expected = STEM_SERVE_LAUNCHES if stem else SERVE_LAUNCHES
    gen_cpu = build_generator(cfg, vocab.size, device="cpu", seed=SEED)
    gen_gpu = build_generator(cfg, vocab.size, device="cuda", seed=SEED)
    gen_gpu.load_state_dict(gen_cpu.state_dict())
    imgs, cmds = synthetic_requests(4, cfg.image_size, SEED + 1)
    cpu = translate_batch(make_infer_fn(cfg, gen_cpu), imgs, cmds, vocab,
                          cfg.max_text_len, torch.device("cpu"))
    before = dict(kernels.LAUNCHES)
    gpu = translate_batch(make_infer_fn(cfg, gen_gpu), imgs, cmds, vocab,
                          cfg.max_text_len, torch.device("cuda")).cpu()
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    diff = float((gpu - cpu).abs().max())
    log(f"slice_fp32: stem_pallas {stem}, batch 4, norm_stats "
        f"{cfg.norm_stats}, launches {ran}, max abs diff card vs CPU "
        f"{diff:.3e} (tolerance {SLICE_ATOL})")
    if not torch.isfinite(gpu).all() or diff > SLICE_ATOL or ran != expected:
        raise AssertionError(f"fp32 slice: diff {diff}, launches {ran}")
    torch.backends.cudnn.allow_tf32 = True
    return diff


def phase_serve_bf16(vocab, card, stem=False, norm_compute="fp32"):
    """Serving at batch 32 in bf16 (`stem`: with `stem_pallas` on, phase 9;
    `norm_compute` "bf16": phase 16).  Returns (launches per batch,
    timing)."""
    cfg = load_config(str(CONFIG))
    cfg.stem_pallas, cfg.norm_compute = stem, norm_compute
    expected = STEM_SERVE_LAUNCHES if stem else SERVE_LAUNCHES
    dev = torch.device("cuda")
    gen = build_generator(cfg, vocab.size, device=dev, seed=SEED)
    infer = make_infer_fn(cfg, gen)
    imgs, cmds = synthetic_requests(BATCH, cfg.image_size, SEED + 2)

    reset_launches()
    out = translate_batch(infer, imgs, cmds, vocab, cfg.max_text_len, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_arith_launches(launches, norm_compute)
    log(f"serve_bf16: stem_pallas {stem}, {cfg.compute_dtype}, norm_stats "
        f"{cfg.norm_stats}, norm_compute {norm_compute}, batch {BATCH}, "
        f"launches per batch {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches} != {expected}")
    if tuple(out.shape) != (BATCH, cfg.image_size, cfg.image_size, 3) \
            or not torch.isfinite(out).all() or float(out.abs().max()) > 1.0:
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, "
                             f"max |x| {float(out.abs().max())}")

    # stage times inside one batch (CUDA events), then the served rate
    x = torch.from_numpy(imgs).to(dev)
    ids, lens = encode_commands(cmds, vocab, cfg.max_text_len)
    ids, lens = torch.from_numpy(ids).to(dev), torch.from_numpy(lens)
    with torch.inference_mode():
        enc = time_ms(lambda i: gen.encode(x), iters=10)
        content, mu, _ = gen.encode(x)
        style = mu.reshape(BATCH, -1)
        txt = time_ms(lambda i: gen.encode_txt(style, ids, lens), iters=10)
        mu_txt, _ = gen.encode_txt(style, ids, lens)
        dec = time_ms(lambda i: gen.decode(content, mu_txt.reshape(BATCH, -1)),
                      iters=10)
    # served batches one at a time, each from host images to edited images
    # back on the host (a closed loop of one client sending batches of 32)
    serve = lambda: translate_batch(infer, imgs, cmds, vocab, cfg.max_text_len,
                                    dev).cpu()
    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(SERVE_BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        serve()
        stop.record()
        stop.synchronize()
        times.append((start.elapsed_time(stop), (time.perf_counter() - t0) * 1e3))
    peak = torch.cuda.max_memory_allocated()
    ev = sorted(t for t, _ in times)
    wall = sorted(w for _, w in times)
    med = ev[len(ev) // 2]
    timing = dict(median_ms=med, images_per_s=BATCH / (med / 1e3),
                  peak_mib=peak / 2**20, encode_ms=enc, encode_txt_ms=txt,
                  decode_ms=dec)
    log(f"serve_bf16: stem_pallas {stem}, norm_compute {norm_compute}, "
        f"{SERVE_BATCHES} batches of {BATCH} after 3 warm-up: "
        f"CUDA-event ms per batch median {med:.3f}, min {ev[0]:.3f}, max "
        f"{ev[-1]:.3f} -> {BATCH / (med / 1e3):.1f} images/s at the median; "
        f"host wall ms median {wall[len(wall) // 2]:.3f}, max {wall[-1]:.3f}; "
        f"stages (CUDA events, mean of 10) encode {enc:.3f} ms, encode_txt "
        f"{txt:.3f} ms, decode {dec:.3f} ms; peak memory {peak / 2**20:.0f} "
        f"MiB; card {card}")
    return launches, timing


# ---------------------------------------------------------------- phase 15

DP_BATCH = TRAIN_BATCH    # (a): the flagship step, one NCCL rank
DP_CHECKED = 3            # (a): steps whose all-reduce is checked bit for bit
DP_WORLD = 2              # (b): gloo ranks on the one card
DP_GLOBAL = 4             # (b): the global batch, 2 a rank
DP_STEPS = 2
DP_RTOL = 1e-4            # (b): two ranks against one process, fp32, TF32 off
# (b): the gradient norms after the first step, taken at parameters that
# Adam's first step moved apart by up to 2 lr where a gradient is rounding
# noise (a conv bias in front of an instance norm; a few weights)
DP_LATER_NORM_RTOL = 1e-3
GRAD_NORMS = ("grad_gen_norm", "grad_dis_norm")
# the largest |m_hat / sqrt(v_hat)| of Adam's first and second steps at the
# flagship's betas (0.5, 0.999): 1, then 1.0539 (the second gradient twice
# the first); a parameter whose gradient is rounding noise can move that
# many lr a step one way on one side and the other way on the other
ADAM_STEP_MAX = (1.0, 1.054)
DP_SPREAD = 2.0           # (a): of two plain runs' mean relative metric spread
DP_TIMEOUT = 600          # (b), (c): seconds a subprocess may take


class AllReduceProbe:
    """Wraps `train/step.py`'s `all_reduce_grads`: CUDA events around each
    call (the flat copy in, the collective, the copy back), and, while
    `check` is on, every flat gradient buffer before and after, which must
    be bit-equal (a SUM over one rank divided by 1)."""

    def __init__(self):
        self.check, self.events, self.checked = False, [], 0

    def __enter__(self):
        self._real = step_module.all_reduce_grads

        def probed(params, axis):
            params = list(params)
            before = None
            if self.check:
                before = torch.cat([p.grad.reshape(-1).float() if p.grad is not None
                                    else torch.zeros(p.numel(), device=p.device)
                                    for p in params])
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            self._real(params, axis)
            stop.record()
            self.events.append((start, stop))
            if before is not None:
                after = torch.cat([p.grad.reshape(-1).float() for p in params])
                if not torch.equal(before, after):
                    raise AssertionError("the one-rank all-reduce changed a gradient")
                self.checked += 1

        step_module.all_reduce_grads = probed
        return self

    def __exit__(self, *exc):
        step_module.all_reduce_grads = self._real

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def step_metrics(step, state, batches, steps):
    """`steps` steps' metrics as rows of `metric_diff` (a "step" key each)."""
    return [{"step": i, **{k: float(v) for k, v in
                           step(state, batches[i % len(batches)]).items()}}
            for i in range(steps)]


def phase_dp_nccl(card, train_off) -> dict:
    """Phase 15 (a): the flagship bf16 step at batch 16 through `DataAxis`
    and `all_reduce_grads` with a one-rank NCCL group in this process."""
    cfg = load_config(str(CONFIG))
    cfg.batch_size = DP_BATCH
    dev = torch.device("cuda")
    batches = synthetic_batches(cfg, dev, seed=SEED + 9)
    # two plain runs (no group): the spread the card's own atomics give
    plain = []
    for _ in range(2):
        state, step, _ = build_trainer(cfg, dev, seed=SEED)
        plain.append(step_metrics(step, state, batches, DP_CHECKED))
    del state, step
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            axis = DataAxis.from_config(cfg)
            if not (axis.grouped and axis.world == 1 and axis.rows is not None):
                raise AssertionError(f"data axis {axis}")
            state, step, _ = build_trainer(cfg, dev, seed=SEED, axis=axis)
            n_bytes = 4 * sum(p.numel() for net in (state.gen, state.dis)
                              for p in net.parameters() if p.requires_grad)
            with AllReduceProbe() as probe:
                probe.check = True
                reset_launches()
                dp = step_metrics(step, state, batches, 1)
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
                dp += [dict(r, step=r["step"] + 1)
                       for r in step_metrics(step, state, batches[1:], DP_CHECKED - 1)]
                probe.check = False
                if probe.checked != 2 * DP_CHECKED:
                    raise AssertionError(f"{probe.checked} all-reduces checked")
                if launches != EXPECTED_TRAIN_LAUNCHES:
                    raise AssertionError(f"launches {launches} != {EXPECTED_TRAIN_LAUNCHES}")
                probe.events.clear()
                times = []
                for i in range(TIMED_STEPS):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    step(state, batches[i % len(batches)])
                    stop.record()
                    stop.synchronize()
                    times.append(start.elapsed_time(stop))
                ar = probe.ms()
        finally:
            dist.destroy_process_group()
    spread, got = metric_diff(plain[0], plain[1])[0], metric_diff(plain[0], dp)[0]
    if not all(math.isfinite(v) for r in dp for v in r.values()) \
            or got > DP_SPREAD * spread + 1e-6:
        raise AssertionError(f"NCCL step's metrics {got} from a plain run's, "
                             f"beyond {DP_SPREAD} x the plain runs' spread {spread}")
    per_step = [a + b for a, b in zip(ar[0::2], ar[1::2])]
    med = lambda v: sorted(v)[len(v) // 2]
    result = dict(checked_steps=DP_CHECKED, launches=launches,
                  metric_diff=got, plain_spread=spread, allreduce_bytes=n_bytes,
                  allreduce_ms=med(per_step), allreduce_ms_min=min(per_step),
                  allreduce_ms_max=max(per_step), step_ms=med(times),
                  step_ms_min=min(times), step_ms_max=max(times),
                  phase7_step_ms=train_off["median_ms"])
    log(f"dp_nccl: the flagship bf16 step at batch {DP_BATCH} through DataAxis and "
        f"all_reduce_grads in a one-rank NCCL group: the flat G and D gradient "
        f"buffers bit-equal before and after the collective in each of "
        f"{DP_CHECKED} steps; launches per step {launches} (phase 7's); mean "
        f"relative metric diff from a plain run {got:.3e} (two plain runs "
        f"{spread:.3e}); the two all-reduces per step (flat copy, NCCL "
        f"all_reduce of {n_bytes / 2**20:.1f} MiB fp32, copy back; CUDA events) "
        f"median {result['allreduce_ms']:.3f} ms (min "
        f"{result['allreduce_ms_min']:.3f}, max {result['allreduce_ms_max']:.3f}); "
        f"{TIMED_STEPS} steps: median {result['step_ms']:.3f} ms (min "
        f"{result['step_ms_min']:.3f}, max {result['step_ms_max']:.3f}), phase 7 "
        f"{train_off['median_ms']:.3f}; card {card}")
    return result


def dp_config():
    cfg = load_config(str(CONFIG))
    cfg.compute_dtype, cfg.batch_size = "float32", DP_GLOBAL
    return cfg


def dp_run(rank: int, world: int):
    """DP_STEPS fp32 steps of the flagship config on this rank's rows of
    the global batch of DP_GLOBAL (draws from `state.rng`, dropout on):
    (metrics per step, the nets' parameters on the host)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dp_config()
    axis = DataAxis.from_config(cfg)
    if (axis.rank, axis.world) != (rank, world):
        raise AssertionError(f"data axis {axis}, not rank {rank} of {world}")
    dev = torch.device("cuda")
    state, step, _ = build_trainer(cfg, dev, seed=SEED, axis=axis)
    n = DP_GLOBAL // world
    rows = lambda b: type(b)(*(t[rank * n:(rank + 1) * n] for t in b))
    batches = [rows(b) for b in synthetic_batches(cfg, dev, n=DP_STEPS, seed=SEED + 40)]
    metrics = step_metrics(step, state, batches, DP_STEPS)
    params = {f"{net}.{k}": v.detach().cpu() for net in ("gen", "dis")
              for k, v in getattr(state, net).state_dict().items()}
    return metrics, params


def dp_worker(rank: int, tmp: str) -> int:
    """One gloo rank of phase 15 (b), run as `chip_smoke.py --dp-worker
    RANK TMP` by `phase_dp_gloo`."""
    if not torch.cuda.is_available():
        return 1
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=DP_WORLD)
    try:
        metrics, params = dp_run(rank, DP_WORLD)
        torch.save({"metrics": metrics, "params": params}, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(cmds, env=None):
    """Start the commands together; fail with their output if one fails or
    outlives DP_TIMEOUT; stop every one of them."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        if p.returncode:
            raise AssertionError(f"{' '.join(p.args)} failed ({p.returncode}):\n"
                                 f"{out[-3000:]}")
    return outs


def phase_dp_gloo(card) -> dict:
    """Phase 15 (b): two gloo ranks on the one card against one process on
    the global batch, fp32, TF32 off."""
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        run_ranks([[sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker",
                    str(r), tmp] for r in range(DP_WORLD)])
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(DP_WORLD)]
    want_m, want_p = dp_run(0, 1)
    again_m = dp_run(0, 1)[0]   # the one process again: the card's own spread
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = dp_config().lr
    atol = 2 * lr * sum(ADAM_STEP_MAX[:DP_STEPS])
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-6)
    # per step, the largest relative difference of each metric: the ranks
    # against one process, and one process against itself
    dev = [{k: max(rel(r["metrics"][i][k], w) for r in ranks) for k, w in want.items()}
           for i, want in enumerate(want_m)]
    repeat = [{k: rel(again[k], w) for k, w in want.items()}
              for again, want in zip(again_m, want_m)]
    worst = lambda rows: [max(r.items(), key=lambda kv: kv[1]) for r in rows]
    log(f"dp_gloo: largest relative metric difference per step, two ranks vs one "
        f"process {worst(dev)}, one process run twice {worst(repeat)}; gradient "
        f"norms {[{k: r[k] for k in GRAD_NORMS} for r in dev]} and "
        f"{[{k: r[k] for k in GRAD_NORMS} for r in repeat]}")
    worst_p = 0.0
    for i, (d, want) in enumerate(zip(dev, want_m)):
        for k, w in want.items():
            rtol = DP_LATER_NORM_RTOL if i and k in GRAD_NORMS else DP_RTOL
            if d[k] * max(abs(w), 1e-6) > rtol * abs(w) + 1e-6:
                raise AssertionError(f"two ranks vs one process, step {i} {k}: "
                                     f"{d[k]:.3e} relative (rtol {rtol})")
    worst_m = max(max(d.values()) for d in dev)
    for r in ranks:
        for k, w in want_p.items():
            err = (r["params"][k] - w).abs()
            worst_p = max(worst_p, float((err / w.abs().clamp_min(1e-6)).max()))
            if not bool((err <= DP_RTOL * w.abs() + atol).all()):
                raise AssertionError(f"two ranks vs one process, parameter {k}: "
                                     f"max abs diff {float(err.max()):.3e}")
    bad = [k for k, v in ranks[0]["params"].items() if not torch.equal(v, ranks[1]["params"][k])]
    if bad:
        raise AssertionError(f"the ranks' parameters differ: {bad[:8]}")
    result = dict(world=DP_WORLD, global_batch=DP_GLOBAL, steps=DP_STEPS,
                  worst_metric_rel=worst_m, worst_per_step=worst(dev),
                  repeat_per_step=worst(repeat), worst_param_rel=worst_p,
                  params_atol=atol, ranks_bit_equal=True, ranks_s=ranks_s)
    log(f"dp_gloo: {DP_WORLD} gloo ranks on one card (cuda:0 each), flagship fp32 "
        f"(TF32 off), global batch {DP_GLOBAL}, {DP_STEPS} steps with state.rng's "
        f"draws and dropout: every metric within rtol {DP_RTOL} of one process on "
        f"the global batch (the later steps' gradient norms {DP_LATER_NORM_RTOL}; "
        f"worst {worst_m:.3e}), every parameter within rtol "
        f"{DP_RTOL} + atol {atol:.1e}, the ranks' parameters bit-equal; "
        f"{ranks_s:.1f} s for the ranks' processes.  NCCL with two ranks needs "
        f"two cards; this machine has {torch.cuda.device_count()}: not run; card {card}")
    return result


def phase_dp_launcher(card) -> dict:
    """Phase 15 (c): `cli/train.py` under `torch.distributed.run
    --nproc_per_node 1` for 2 steps, on phase 12's config."""
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        cfg_path = cli_config(tmp)
        t0 = time.perf_counter()
        out = run_ranks([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "1", "-m", "dwcgan_tpu_torch.cli.train",
                          "--config", cfg_path, "--procedural_data",
                          "--procedural_size", str(CLI_PROCEDURAL), "--max_steps", "2",
                          "--output_path", str(tmp / "run")]])[0]
        secs = time.perf_counter() - t0
        with open(tmp / "run" / "logs" / CLI_NAME / "metrics.jsonl") as f:
            rows = [json.loads(ln) for ln in f]
        ckpts = checkpoint_steps(str(tmp / "run" / "outputs" / CLI_NAME / "checkpoints"))
    if "mesh: {'data': 1, 'model': 1} over 1 devices" not in out \
            or "Finish training" not in out or [r["step"] for r in rows] != [1, 2] \
            or ckpts != [2] or not all(math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"the launcher run: rows {rows}, checkpoints {ckpts}:\n"
                             f"{out[-3000:]}")
    log(f"dp_launcher: python -m torch.distributed.run --standalone "
        f"--nproc_per_node 1 -m dwcgan_tpu_torch.cli.train, 2 steps: the mesh line, "
        f"2 finite metric rows, checkpoint 2; {secs:.1f} s; card {card}")
    return dict(seconds=secs)


def phase_data_parallel(card, train_off) -> dict:
    """Phase 15: data parallel (module docstring)."""
    return dict(nccl=phase_dp_nccl(card, train_off), gloo=phase_dp_gloo(card),
                launcher=phase_dp_launcher(card))


# ---------------------------------------------------------------- phase 16

ARITH_ROWS = ROWS_1_3
ARITH_BWD = ("instance_norm_bwd", "adain_bwd", "adain_residual_bwd")


def arith_plain(kernel, args, relu, stats):
    if kernel == "instance_norm":
        return norms.instance_norm_plain(args[0], relu, stats, "bf16")
    if kernel == "adain":
        return norms.adain_plain(*args, relu=relu, stats=stats, arith="bf16")
    return norms.adain_residual_plain(*args, stats=stats, arith="bf16")


def check_arith_forward(kernel, args, relu, stats, label):
    """Rows 1-3 with arith on against the plain bf16 arithmetic on the card:
    bit-equal to the plain chain at the kernel's own statistics, within
    BF16_ULPS of the plain forward wherever both sides' statistics round to
    the same bf16 values (returns how many (n, c) do not), two runs
    bit-equal, one CUDA kernel per call."""
    y, st = run_kernel_stats(kernel, args, relu, stats, arith=True)
    again = run_kernel_stats(kernel, args, relu, stats, arith=True)
    torch.cuda.synchronize()
    if not (torch.equal(y, again[0]) and torch.equal(st, again[1])):
        raise AssertionError(f"{label}: two runs differ")
    per_call = kernels_per_call(lambda: run_kernel_stats(kernel, args, relu, stats,
                                                         arith=True))
    if per_call != 1:
        raise AssertionError(f"{label}: {per_call} kernels per call")
    x = args[1] if kernel == "adain_residual" else args[0]
    affine = tuple(args[-2:]) if kernel != "instance_norm" else (None, None)
    res = args[0] if kernel == "adain_residual" else None
    if not torch.equal(y, norms.bf16_chain_plain(x, st, *affine, relu=relu, residual=res)):
        raise AssertionError(f"{label}: not the bf16 chain at its own statistics")
    mean, var = norms._moments_hw(x.float(), stats)
    bf = lambda t: t.flatten(1).to(torch.bfloat16)
    same = (bf(st[:, 0]) == bf(mean)) & (bf(st[:, 1]) == bf(torch.rsqrt(var + norms.EPS)))
    plain = arith_plain(kernel, args, relu, stats)
    keep = same[:, :, None, None].expand_as(y)
    err = (y.float() - plain.float()).abs()[keep]
    tol = (BF16_ULPS * bf16_ulp(plain) + FP32_ATOL)[keep]
    if not bool((err <= tol).all()):
        raise AssertionError(f"{label}: beyond {BF16_ULPS} ulps of the plain bf16 "
                             f"arithmetic, max {float((err - tol).max()):.3e}")
    return y, st, float(err.max()) if err.numel() else 0.0, int((~same).sum())


def check_arith_site(kernel, shape, relu, stats, g, counter=None):
    """Phase 16 at one site (`counter`: its backward too, a training site)."""
    label = f"{kernel} {shape} bf16-arith {stats} relu={relu}"
    args = site_inputs(kernel, shape, torch.bfloat16, g)
    out, st, err, flips = check_arith_forward(kernel, args, relu, stats, label)
    copies = cold_copies(args)
    row = dict(kernel=kernel, shape=list(shape), relu=relu, stats=stats,
               max_abs_err=err, stat_flips=flips,
               ms=device_ms(lambda i: run_kernel(kernel, copies[i % len(copies)], relu,
                                                 stats, arith=True)),
               ms_fp32_arith=device_ms(lambda i: run_kernel(
                   kernel, copies[i % len(copies)], relu, stats)))
    del copies
    if counter is None:
        return row
    x = args[1] if kernel == "adain_residual" else args[0]
    params = args[2:] if kernel == "adain_residual" else args[1:]
    gr = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    blabel = f"{counter} {shape} bf16-arith {stats} relu={relu}"
    got = run_bwd(counter, x, gr, st, params, relu, arith=True)
    again = run_bwd(counter, x, gr, st, params, relu, arith=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{blabel}: two runs differ")
    mask = out if relu else None
    if counter == "instance_norm_bwd":
        want = (norms.instance_norm_bwd_plain(x, gr, mask, stats, "bf16"),)
    else:
        want = norms.adain_bwd_plain(x, params[0], gr, mask, stats, "bf16")
    bwd_err, bwd_rel = check_bwd_close(blabel, got, want, torch.bfloat16)
    per_call = kernels_per_call(lambda: run_bwd(counter, x, gr, st, params, relu,
                                                arith=True))
    if per_call != 1:
        raise AssertionError(f"{blabel}: {per_call} kernels per call")
    mism = 0
    if relu:
        affine = params if counter == "adain_bwd" else ()
        mism = kernels.relu_mask_mismatches(x, out, st, *affine, arith=True)
        if mism:
            raise AssertionError(f"{blabel}: the mask differs from y > 0 at {mism}")
    n_copies = max(1, math.ceil(COLD_L2_BYTES / (2 * x.numel() * x.element_size())))
    copies = [(x, gr)] + [(x.clone(memory_format=torch.preserve_format),
                           gr.clone(memory_format=torch.preserve_format))
                          for _ in range(n_copies - 1)]
    bwd = lambda arith: lambda i: run_bwd(counter, *copies[i % n_copies], st, params,
                                          relu, arith=arith)
    row.update(bwd=counter, bwd_max_abs_err=bwd_err, bwd_max_rel_err=bwd_rel,
               bwd_mask_mismatches=mism, bwd_ms=device_ms(bwd(True)),
               bwd_ms_fp32_arith=device_ms(bwd(False)))
    return row


def phase_arith_kernels():
    """Phase 16's kernel checks and times: rows 1-3 at every serving site,
    rows 1-3 and 5-6 at every training site, both stats modes."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    rows = []
    for kernel, shape, relu, calls in SITES:
        if kernel not in ARITH_ROWS:
            continue
        for stats in ("2pass", "1pass"):
            row = check_arith_site(kernel, shape, relu, stats, g)
            row.update(calls_per_batch=calls, site="serve")
            rows.append(row)
            log("arith_check " + json.dumps(row))
    for counter, fwd, shape, relu, calls, fwd_calls in BWD_SITES:
        if counter not in ARITH_BWD:
            continue
        for stats in ("2pass", "1pass"):
            row = check_arith_site(fwd, shape, relu, stats, g, counter)
            row.update(calls_per_step=calls, fwd_calls_per_step=fwd_calls, site="train")
            rows.append(row)
            log("arith_check " + json.dumps(row))
        torch.cuda.empty_cache()
    return rows


def phase_norm_compute(vocab, card, serve_off, train_off) -> dict:
    """Phase 16: `norm_compute: bf16` on the card."""
    rows = phase_arith_kernels()
    step_launches, step = phase_train_bf16(card, norm_compute="bf16")
    serve_launches, serve = phase_serve_bf16(vocab, card, norm_compute="bf16")
    result = dict(rows=rows, step_launches=step_launches, step=step,
                  phase7_median_ms=train_off["median_ms"], serve_launches=serve_launches,
                  serve=serve, phase4_images_per_s=serve_off["images_per_s"])
    log(f"norm_compute_bf16: step median {step['median_ms']:.3f} ms (phase 7 "
        f"{train_off['median_ms']:.3f}), served {serve['images_per_s']:.1f} images/s "
        f"(phase 4 {serve_off['images_per_s']:.1f}); card {card}")
    return result


def arith_summary(rows, name, flagship_stats):
    """Phase 16's figures for the `kernels` line: rows 1-3 per served batch
    and per training step, rows 5-6 per step (bf16, the flagship's stats)."""
    fwd = [r for r in rows if r["kernel"] == name and r["stats"] == flagship_stats]
    if fwd:
        serve = [r for r in fwd if r["site"] == "serve"]
        train = [r for r in fwd if r["site"] == "train"]
        tot = lambda rs, key, per: sum(r[key] * r[per] for r in rs)
        return dict(ms=tot(serve, "ms", "calls_per_batch"),
                    ms_fp32_arith=tot(serve, "ms_fp32_arith", "calls_per_batch"),
                    ms_train=tot(train, "ms", "fwd_calls_per_step"),
                    ms_train_fp32_arith=tot(train, "ms_fp32_arith", "fwd_calls_per_step"),
                    max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
                    stat_flips=sum(r["stat_flips"] for r in rows if r["kernel"] == name))
    counters = ("adain_bwd", "adain_residual_bwd") if name == "adain_bwd" else (name,)
    bwd = [r for r in rows if r.get("bwd") in counters and r["stats"] == flagship_stats]
    return dict(ms=sum(r["bwd_ms"] * r["calls_per_step"] for r in bwd),
                ms_fp32_arith=sum(r["bwd_ms_fp32_arith"] * r["calls_per_step"] for r in bwd),
                max_rel_err=max(r["bwd_max_rel_err"] for r in rows if r.get("bwd") in counters))


# ---------------------------------------------------------------- phase 17

TP_MODEL = 2              # the model axis of every mesh below
TP_GLOBAL = DP_GLOBAL     # (a), (c): the fp32 global batch
TP_STEPS = 2              # (a)
TP_BOTH = 4               # (c): gloo ranks of the 2 x 2 mesh
TP_RTOL, TP_ATOL = 2e-4, 1e-5                  # tests/test_tp_parity.py's metrics
TP_PARAM_RTOL, TP_PARAM_ATOL = 2e-4, 2.5e-4    # and its parameters, a step
TP_WARMUP = 3             # (b): steps before the launch check and the timing
FLAGSHIP_ELEMS = 20_356_044 + 13_985_666       # G (bias_hh's zeros included), D
FLAGSHIP_SHARDED = 17_790_592                  # the 46 tensors of parallel/rules.py
TP_RANK_ELEMS = FLAGSHIP_ELEMS - FLAGSHIP_SHARDED // TP_MODEL


def tp_config(model, dtype="float32", batch=TP_GLOBAL):
    cfg = load_config(str(CONFIG))
    cfg.compute_dtype, cfg.batch_size, cfg.mesh_model = dtype, batch, model
    return cfg


def tp_rows(axis, batches):
    """This rank's rows of each global batch (every rank of a model group
    takes the same)."""
    n, o = axis.local_batch, axis.data_rank * axis.local_batch
    return [type(b)(*(t[o:o + n] for t in b)) for b in batches]


def tp_fp32_run(model: int, steps: int, mesh_data: int = -1) -> dict:
    """`steps` fp32 steps (TF32 off) of the flagship on this rank's rows of
    the global batch of TP_GLOBAL, draws from `state.rng`, dropout on; in
    one process (no group) the whole batch.  Per step its metrics and the
    full parameters on the host (gathered over the model group); at the
    end this rank's replicated parameters and EMA copies and `state.rng`.
    None on a rank outside the mesh (`mesh_data` x `model` below the
    world), which builds nothing."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tp_config(model)
    cfg.mesh_data = mesh_data
    axis = DataAxis.from_config(cfg)
    if axis.idle:
        return None
    dev = torch.device("cuda")
    state, step, _ = build_trainer(cfg, dev, seed=SEED, axis=axis)
    batches = synthetic_batches(cfg, dev, n=steps, seed=SEED + 40)
    if axis.grouped:
        batches = tp_rows(axis, batches)
    metrics, params = [], []
    for b in batches:
        metrics.append({k: float(v) for k, v in step(state, b).items()})
        params.append({f"{net}.{k}": v.detach().to("cpu", copy=True)
                       for net in ("gen", "dis")
                       for k, v in rules.full_state_dict(getattr(state, net)).items()})
    replicated = {f"{net}.{k}": v.detach().to("cpu", copy=True)
                  for net in ("gen", "dis", "ema_gen", "ema_dis")
                  for k, v in getattr(state, net).state_dict().items()
                  if k not in rules.shards(getattr(state, net))}
    return dict(metrics=metrics, params=params, replicated=replicated,
                rng=state.rng.get_state(),
                shards=len(rules.shards(state.gen)) + len(rules.shards(state.dis)))


def tp_bf16_run(card_quiet: Path) -> dict:
    """Phase 17 (b) on this rank: the flagship bf16 step at global batch 16
    on the 1 x 2 mesh; phase 7's launches, the elements held, the
    collectives of one step, then (once `card_quiet` exists: the other
    phases' processes have left the card) the peak memory and 12 timed
    steps."""
    cfg = tp_config(TP_MODEL, "bfloat16", TRAIN_BATCH)
    axis = DataAxis.from_config(cfg)
    dev = torch.device("cuda")
    state, step, _ = build_trainer(cfg, dev, seed=SEED, axis=axis)
    batches = tp_rows(axis, synthetic_batches(cfg, dev, seed=SEED + 9))
    held = sum(p.numel() for net in (state.gen, state.dis) for p in net.parameters())
    for i in range(TP_WARMUP):
        step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    reset_launches()
    tensor.reset_collectives()
    m = step(state, batches[TP_WARMUP % len(batches)])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    collectives = copy.deepcopy(tensor.COLLECTIVES)
    metrics = {k: float(v) for k, v in m.items()}
    deadline = time.perf_counter() + DP_TIMEOUT
    while not card_quiet.exists():
        if time.perf_counter() > deadline:
            raise AssertionError("the other phase 17 processes did not finish")
        time.sleep(0.2)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batches[i % len(batches)])
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return dict(launches=launches, metrics=metrics, held=held, collectives=collectives,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20, times=times)


def tp_worker(rank: int, world: int, tmp: str) -> int:
    """One gloo rank of phase 17 on the one card, run as `chip_smoke.py
    --tp-worker RANK WORLD TMP` by `phase_tensor_parallel`: on the 1 x 2
    mesh (a) then (b), on the 2 x 2 mesh (c)."""
    if not torch.cuda.is_available():
        return 1
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
                            world_size=world)
    try:
        if world == TP_MODEL:
            out = dict(a=tp_fp32_run(TP_MODEL, TP_STEPS), b=tp_bf16_run(Path(tmp) / "quiet"))
        elif world == SUB_WORLD:   # phase 18 (a): the 1 x 2 mesh on ranks 0-1
            out = tp_fp32_run(TP_MODEL, TP_STEPS, mesh_data=1)
            if out is None:        # the idle rank writes nothing
                return 0
            out = dict(a=out)
        else:
            out = dict(c=tp_fp32_run(TP_MODEL, 1))
        torch.save(out, Path(tmp) / f"tp{world}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def tp_check(label, ranks, want, again, model):
    """Each rank's steps against one process (`want`; `again`: the same
    process run again, the card's own spread): step 1 every metric within
    TP_RTOL / TP_ATOL, later steps too but for the gradient norms
    (phase 15's DP_LATER_NORM_RTOL: Adam's first step moved the
    rounding-noise parameters apart), the gathered parameters within
    TP_PARAM_RTOL plus TP_PARAM_ATOL a step; `state.rng` and every
    replicated parameter and EMA copy bit-equal on the ranks of a model
    group.  Returns the worst relative differences per step, the ranks'
    and the repeat's."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-6)
    steps = len(ranks[0]["metrics"])
    dev = [{k: max(rel(r["metrics"][i][k], w) for r in ranks) for k, w in want["metrics"][i].items()}
           for i in range(steps)]
    repeat = [{k: rel(again["metrics"][i][k], w) for k, w in want["metrics"][i].items()}
              for i in range(steps)]
    for i in range(steps):
        for k, w in want["metrics"][i].items():
            rtol = DP_LATER_NORM_RTOL if i and k in GRAD_NORMS else TP_RTOL
            if dev[i][k] * max(abs(w), 1e-6) > rtol * abs(w) + TP_ATOL:
                raise AssertionError(f"{label}: step {i + 1} {k} {dev[i][k]:.3e} relative "
                                     f"from one process (rtol {rtol}; the process run "
                                     f"again {repeat[i][k]:.3e})")
    worst_p = 0.0
    for r in ranks:
        for i in range(steps):
            for k, w in want["params"][i].items():
                err = (r["params"][i][k] - w).abs()
                worst_p = max(worst_p, float(err.max()))
                if not bool((err <= TP_PARAM_RTOL * w.abs() + TP_PARAM_ATOL * (i + 1)).all()):
                    raise AssertionError(f"{label}: step {i + 1} parameter {k}: max abs "
                                         f"diff {float(err.max()):.3e}")
    for r, mine in enumerate(ranks):
        lead = ranks[r - r % model]
        bad = [k for k, v in lead["replicated"].items()
               if not torch.equal(v, mine["replicated"][k])]
        if bad or not torch.equal(lead["rng"], mine["rng"]):
            raise AssertionError(f"{label}: rank {r} differs from rank {r - r % model} "
                                 f"of its model group: {bad[:8]}, rng "
                                 f"{torch.equal(lead['rng'], mine['rng'])}")
        if mine["shards"] != 46:
            raise AssertionError(f"{label}: rank {r} holds {mine['shards']} shards, not 46")
    worst = lambda rows: [max(row.items(), key=lambda kv: kv[1]) for row in rows]
    return dict(worst_per_step=worst(dev), repeat_per_step=worst(repeat),
                worst_param_abs=worst_p)


def phase_tensor_parallel(card, train_off) -> dict:
    """Phase 17: tensor parallelism (module docstring)."""
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ranks = [(w, r) for w in (TP_MODEL, TP_BOTH) for r in range(w)]
        logs = [Path(tmp) / f"log{w}_{r}" for w, r in ranks]
        files = [open(path, "w") for path in logs]
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--tp-worker", str(r), str(w), tmp], cwd=ROOT,
                                  stdout=f, stderr=subprocess.STDOUT)
                 for (w, r), f in zip(ranks, files)]
        try:
            # the one process, twice (the card's own spread), while the ranks start
            want = tp_fp32_run(1, TP_STEPS)
            again = tp_fp32_run(1, TP_STEPS)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = False
            for p in procs[TP_MODEL:]:
                p.wait(timeout=DP_TIMEOUT)
            (Path(tmp) / "quiet").touch()
            for p in procs[:TP_MODEL]:
                p.wait(timeout=DP_TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in files:
                f.close()
        for p, path in zip(procs, logs):
            if p.returncode:
                raise AssertionError(f"{' '.join(p.args)} failed ({p.returncode}):\n"
                                     f"{path.read_text()[-3000:]}")
        pair = [torch.load(Path(tmp) / f"tp{TP_MODEL}_rank{r}.pt") for r in range(TP_MODEL)]
        both = [torch.load(Path(tmp) / f"tp{TP_BOTH}_rank{r}.pt") for r in range(TP_BOTH)]
    a = tp_check("tp (a) 1x2", [r["a"] for r in pair], want, again, TP_MODEL)
    first = lambda run: dict(run, metrics=run["metrics"][:1], params=run["params"][:1])
    c = tp_check("tp (c) 2x2", [r["c"] for r in both], first(want), first(again), TP_MODEL)
    b = [r["b"] for r in pair]
    for r, run in enumerate(b):
        if run["launches"] != EXPECTED_TRAIN_LAUNCHES:
            raise AssertionError(f"tp (b) rank {r}: launches {run['launches']} != "
                                 f"{EXPECTED_TRAIN_LAUNCHES}")
        if not all(math.isfinite(v) for v in run["metrics"].values()):
            raise AssertionError(f"tp (b) rank {r}: non-finite metrics {run['metrics']}")
        if run["held"] != TP_RANK_ELEMS:
            raise AssertionError(f"tp (b) rank {r} holds {run['held']} parameter "
                                 f"elements, not {TP_RANK_ELEMS}")
    med = lambda v: sorted(v)[len(v) // 2]
    secs = time.perf_counter() - t0
    result = dict(
        a=a, c=c, seconds=secs, pair=[r["a"] for r in pair], one=want,
        b=[dict(launches=run["launches"], held=run["held"], collectives=run["collectives"],
                peak_mib=run["peak_mib"], step_ms=med(run["times"]),
                step_ms_min=min(run["times"]), step_ms_max=max(run["times"]))
           for run in b],
        phase7_peak_mib=train_off["peak_mib"], phase7_step_ms=train_off["median_ms"])
    log(f"tp_fp32: (a) mesh 1x2 ({TP_MODEL} gloo ranks on cuda:0), flagship fp32 (TF32 "
        f"off), global batch {TP_GLOBAL}, {TP_STEPS} steps with state.rng's draws and "
        f"dropout against one process: worst relative metric difference per step "
        f"{a['worst_per_step']} (the one process run again {a['repeat_per_step']}), "
        f"gathered parameters max abs diff {a['worst_param_abs']:.3e} (rtol "
        f"{TP_PARAM_RTOL} + atol {TP_PARAM_ATOL} a step), state.rng and the replicated "
        f"parameters and EMA copies bit-equal on both ranks, 46 shards each; (c) mesh "
        f"2x2 ({TP_BOTH} gloo ranks), 1 step: {c['worst_per_step']} (again "
        f"{c['repeat_per_step']}), parameters {c['worst_param_abs']:.3e}; card {card}")
    for r, run in enumerate(result["b"]):
        log(f"tp_bf16: (b) rank {r} of the 1x2 mesh, flagship bf16, global batch "
            f"{TRAIN_BATCH}: launches per step {run['launches']} (phase 7's); parameter "
            f"elements held {run['held']} of {FLAGSHIP_ELEMS} ({FLAGSHIP_SHARDED} "
            f"sharded in halves); collectives per step (calls, bytes this rank sends) "
            + json.dumps(run["collectives"])
            + f"; peak memory {run['peak_mib']:.0f} MiB (one process, phase 7: "
            f"{train_off['peak_mib']:.0f} MiB); {TIMED_STEPS} steps after "
            f"{TP_WARMUP + 1}, CUDA events, over gloo staged through host memory (the "
            f"transport of two ranks on one card, not NCCL's): median "
            f"{run['step_ms']:.3f} ms (min {run['step_ms_min']:.3f}, max "
            f"{run['step_ms_max']:.3f}; phase 7's one process {train_off['median_ms']:.3f}); "
            f"card {card}")
    log(f"tensor_parallel: NCCL tensor parallelism was not run: NCCL refuses two ranks "
        f"on one card (duplicate GPU) and this machine has {torch.cuda.device_count()} "
        f"card(s); phase 17 took {secs:.1f} s")
    return result


# ---------------------------------------------------------------- phase 18

SUB_WORLD = 3             # (a): gloo ranks, the 1 x 2 mesh on the first two
NATIVE_N, NATIVE_H, NATIVE_W = 16, 218, 178    # (b): a CelebA batch of 16
NATIVE_CROP, NATIVE_OUT = 178, 128
NATIVE_ATOL = 1e-4        # tests/test_native.py's, library against NumPy
NATIVE_REPS = 15


def phase_mesh_subset(card, tp) -> dict:
    """Phase 18 (a): the 1 x 2 mesh on the first two of three gloo ranks
    against phase 17 (a)'s two ranks (`tp`: its result)."""
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        outs = run_ranks([[sys.executable, str(ROOT / "chip_smoke.py"), "--tp-worker",
                           str(r), str(SUB_WORLD), tmp] for r in range(SUB_WORLD)])
        # the rendezvous file aside, only the mesh's ranks wrote
        written = sorted(p.name for p in Path(tmp).iterdir()
                         if not p.name.startswith("store"))
        want = [f"tp{SUB_WORLD}_rank{r}.pt" for r in range(TP_MODEL)]
        if written != want:
            raise AssertionError(f"mesh subset: the ranks wrote {written}, not {want}")
        ranks = [torch.load(Path(tmp) / f"tp{SUB_WORLD}_rank{r}.pt")["a"]
                 for r in range(TP_MODEL)]
    idle = outs[-1]
    checked = tp_check("mesh subset 1x2 of 3", ranks, tp["pair"][0], tp["one"], TP_MODEL)
    same = lambda a, b: a["metrics"] == b["metrics"] and all(
        torch.equal(v, q[k]) for p, q in zip(a["params"], b["params"]) for k, v in p.items())
    bit_equal = all(same(r, q) for r, q in zip(ranks, tp["pair"]))
    secs = time.perf_counter() - t0
    log(f"mesh_subset: (a) {SUB_WORLD} gloo ranks on cuda:0, mesh_data 1 x mesh_model "
        f"{TP_MODEL}: ranks 0-1 against phase 17 (a)'s 2-rank run, flagship fp32 (TF32 "
        f"off), global batch {TP_GLOBAL}, {TP_STEPS} steps: worst relative metric "
        f"difference per step {checked['worst_per_step']} (phase 17's one process "
        f"against its pair {checked['repeat_per_step']}), gathered parameters max abs "
        f"diff {checked['worst_param_abs']:.3e}, bit-equal to the pair: {bit_equal}; "
        f"state.rng and the replicated tensors bit-equal on both ranks; rank 2 exited 0 "
        f"and wrote nothing ({len(idle)} bytes of output); {secs:.1f} s; card {card}")
    return dict(checked, bit_equal=bit_equal, seconds=secs)


def _omp_set_threads(n: int) -> None:
    """OpenMP's thread count for this thread's next parallel regions (the
    library's OpenMP runtime, loaded with it)."""
    ctypes.CDLL("libgomp.so.1").omp_set_num_threads(n)


def _host_ms(fn, reps: int = NATIVE_REPS) -> float:
    """Median host ms of `fn()` (host work only: no device)."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_native(card) -> dict:
    """Phase 18 (b): the host preprocessing library on the card's host."""
    from concurrent.futures import ThreadPoolExecutor
    from dwcgan_tpu_torch import native
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (NATIVE_N, NATIVE_H, NATIVE_W, 3), dtype=np.uint8)
    flips = rng.integers(0, 2, NATIVE_N).astype(np.int32)
    args = (NATIVE_CROP, NATIVE_OUT)
    got = native.preprocess_batch(images, *args, flips)
    want = native.preprocess_batch(images, *args, flips, force_fallback=True)
    err = np.abs(got - want)
    if not np.isfinite(got).all() or err.max() > NATIVE_ATOL:
        raise AssertionError(f"native: library vs NumPy max abs {err.max():.3e} "
                             f"(bound {NATIVE_ATOL})")
    default = native.omp_threads()
    numpy_ms = _host_ms(lambda: native.preprocess_batch(images, *args, flips,
                                                        force_fallback=True))
    omp_ms = _host_ms(lambda: native.preprocess_batch(images, *args, flips))
    _omp_set_threads(1)
    try:
        if native.omp_threads() != 1:
            raise AssertionError("native: OpenMP did not take one thread")
        one_ms = _host_ms(lambda: native.preprocess_batch(images, *args, flips))
    finally:
        _omp_set_threads(default)
    workers = load_config(str(CONFIG)).num_workers
    with ThreadPoolExecutor(workers) as pool:
        def per_image(fallback):
            list(pool.map(lambda i: native.preprocess_batch(
                images[i:i + 1], *args, flips[i:i + 1], force_fallback=fallback),
                range(NATIVE_N)))
        threads = dict(numpy=_host_ms(lambda: per_image(True)),
                       native=_host_ms(lambda: per_image(False)))
    result = dict(max_abs_err=float(err.max()), differ=float((err > 0).mean()),
                  build_s=build_s, omp_default=default, numpy_ms=numpy_ms,
                  native_one_thread_ms=one_ms, native_omp_ms=omp_ms, workers=workers,
                  workers_numpy_ms=threads["numpy"], workers_native_ms=threads["native"],
                  host_cores=os.cpu_count())
    log(f"native: (b) {lib.name} built by g++ in {build_s:.1f} s; {NATIVE_N} seeded "
        f"uint8 images {NATIVE_H}x{NATIVE_W} -> crop {NATIVE_CROP} -> {NATIVE_OUT}, "
        f"flips: library vs NumPy oracle max abs {err.max():.3e} (bound {NATIVE_ATOL}), "
        f"{(err > 0).mean():.1%} of the elements differ; host ms per batch of "
        f"{NATIVE_N} (median of {NATIVE_REPS}): NumPy {numpy_ms:.3f}, library one "
        f"OpenMP thread {one_ms:.3f}, library OpenMP default ({default} threads) "
        f"{omp_ms:.3f}; {workers} threads calling per image at once: NumPy "
        f"{threads['numpy']:.3f}, library {threads['native']:.3f}; host cores "
        f"{os.cpu_count()}; card {card}")
    return result


# ---------------------------------------------------------------- phase 19

QUALITY_CONFIG = ROOT / "configs" / "celeba_quality.yaml"
QUALITY_NAME = QUALITY_CONFIG.stem
QUALITY_STEPS = 40            # the run's steps
QUALITY_SNAPSHOT = 20         # snapshot_save_iter: checkpoints 20 and 40
QUALITY_N_EVAL = 256          # quality_eval's --n_eval on the card
QUALITY_CMP = 128             # faces of the fp32 card-vs-CPU comparison
QUALITY_BIT_TOL = 1 / QUALITY_CMP    # a per-bit accuracy: one face either way
QUALITY_RECON_RTOL = 1e-4
QUALITY_FID_RTOL = 1e-3


def quality_config(tmp: Path) -> str:
    """A copy of `configs/celeba_quality.yaml`, under its own name, with
    checkpoints every QUALITY_SNAPSHOT steps."""
    text, n = re.subn(r"^snapshot_save_iter:.*$", f"snapshot_save_iter: {QUALITY_SNAPSHOT}",
                      QUALITY_CONFIG.read_text(), flags=re.M)
    if n != 1:
        raise AssertionError(f"snapshot_save_iter is not set once in {QUALITY_CONFIG}")
    path = tmp / QUALITY_CONFIG.name
    path.write_text(text)
    return str(path)


def quality_row_fp32(cfg, ckpt, held, dev):
    """The unrounded row of `ckpt`'s EMA generator over `held` on `dev`, the
    generator and InceptionV3 (`init_random_inception(0)`) in fp32 with
    TF32 off; the norm kernels' launches during it."""
    vocab = Vocab(cfg.dataset)
    gen = build_generator(cfg, vocab.size, device=dev)
    gen.load_state_dict(ckpt["ema_gen"])
    iv3 = init_random_inception(0, device=dev)
    reset_launches()
    with fp32_precision():
        row = quality_eval.evaluate(make_infer_fn(cfg, gen), iv3, held, rounded=False)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return row, dict(kernels.LAUNCHES)


def phase_quality(card) -> dict:
    """Phase 19: the quality protocol on the card (module docstring)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        cfg_path = quality_config(tmp)
        cfg = load_config(cfg_path)
        t = time.perf_counter()
        train_cli.main(["--config", cfg_path, "--procedural_data", "--output_path",
                        str(tmp / "run"), "--max_steps", str(QUALITY_STEPS)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        ckpt_dir = tmp / "run" / "outputs" / QUALITY_NAME / "checkpoints"
        steps = checkpoint_steps(str(ckpt_dir))
        if steps != [QUALITY_SNAPSHOT, QUALITY_STEPS]:
            raise AssertionError(f"checkpoints {steps}")
        with open(tmp / "run" / "logs" / QUALITY_NAME / "metrics.jsonl") as f:
            logged = [json.loads(ln) for ln in f]
        if not logged or logged[-1]["step"] != QUALITY_STEPS or not all(
                math.isfinite(v) for r in logged for v in r.values()):
            raise AssertionError(f"the run's metric rows: {logged[-1:]}")

        # the protocol on both checkpoints, on the card, as users run it
        reset_launches()
        t = time.perf_counter()
        rows = quality_eval.main(["--run_dir", str(tmp / "run"), "--config", cfg_path,
                                  "--n_eval", str(QUALITY_N_EVAL), "--out",
                                  str(tmp / "quality")])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        # per checkpoint: the batches of the set, the no-change batch, the grid's
        calls = len(steps) * (math.ceil(QUALITY_N_EVAL / BATCH) + 2)
        want = {k: calls * EXPECTED_LAUNCHES.get(k, 0) for k in kernels.LAUNCHES}
        if launches != want:
            raise AssertionError(f"quality_eval launches {launches} != {want}")
        if [r["step"] for r in rows] != steps or not all(
                math.isfinite(r[k]) for r in rows for k in
                ("fid_rel", "is_mean", "attr_transfer_acc", "nochange_recon_l1")):
            raise AssertionError(f"quality rows {rows}")
        trend = json.loads((tmp / "quality" / "quality_trend.json").read_text())
        if trend["results"] != rows or trend["n_eval"] != QUALITY_N_EVAL:
            raise AssertionError("quality_trend.json does not hold the rows")

        # step 40's EMA generator in fp32 on the card and on the CPU
        cfg32 = load_config(cfg_path)
        cfg32.compute_dtype = "float32"
        held = quality_eval.held_out_set(cfg32, QUALITY_CMP, BATCH)
        ckpt = torch.load(ckpt_dir / f"ckpt_{QUALITY_STEPS:08d}.pt", map_location="cpu",
                          weights_only=True)
        t = time.perf_counter()
        card_row, card_launches = quality_row_fp32(cfg32, ckpt, held, dev)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu_row, cpu_launches = quality_row_fp32(cfg32, ckpt, held, torch.device("cpu"))
        cpu_s = time.perf_counter() - t
    calls = math.ceil(QUALITY_CMP / BATCH) + 1
    want = {k: calls * EXPECTED_LAUNCHES.get(k, 0) for k in kernels.LAUNCHES}
    if card_launches != want or any(cpu_launches.values()):
        raise AssertionError(f"fp32 launches: card {card_launches} (want {want}), "
                             f"CPU {cpu_launches}")
    bit_gap = max(abs(a - b) for a, b in zip(card_row["attr_acc_per_bit"],
                                             cpu_row["attr_acc_per_bit"]))
    rel = lambda k: abs(card_row[k] - cpu_row[k]) / abs(cpu_row[k])
    gaps = {"attr_acc_per_bit": bit_gap, "nochange_recon_l1": rel("nochange_recon_l1"),
            "fid_rel": rel("fid_rel"), "is_mean": rel("is_mean")}
    log(f"quality: fp32 card vs CPU, step {QUALITY_STEPS}'s EMA generator on "
        f"{QUALITY_CMP} faces: card {json.dumps(card_row)}; CPU {json.dumps(cpu_row)}; "
        f"largest gaps: per-bit accuracy {bit_gap:.6f} (bound {QUALITY_BIT_TOL:.6f}), "
        f"recon L1 {gaps['nochange_recon_l1']:.3e} relative (bound "
        f"{QUALITY_RECON_RTOL}), fid_rel {gaps['fid_rel']:.3e} relative (bound "
        f"{QUALITY_FID_RTOL}), is_mean {gaps['is_mean']:.3e} relative (not bound); "
        f"host s card {card_s:.1f}, CPU {cpu_s:.1f}; card {card}")
    if bit_gap > QUALITY_BIT_TOL + 1e-12 or gaps["nochange_recon_l1"] > QUALITY_RECON_RTOL \
            or gaps["fid_rel"] > QUALITY_FID_RTOL:
        raise AssertionError(f"quality rows card vs CPU apart: {gaps}")
    wall = time.perf_counter() - t_phase
    log(f"quality: {QUALITY_STEPS} steps of {QUALITY_NAME} (128 px, bf16, procedural "
        f"faces) in {train_s:.1f} s, the last logged {logged[-1]['steps_per_sec']:.3f} "
        f"steps/s; quality_eval over checkpoints {steps} (n_eval {QUALITY_N_EVAL}) in "
        f"{eval_s:.1f} s on the host, launches {json.dumps(launches)}; rows "
        f"{json.dumps(rows)}; phase wall time {wall:.1f} s; card {card}")
    return {"launches": launches, "rows": rows, "gaps": gaps}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = build.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    rows = phase_kernels()
    vocab = Vocab(load_config(str(CONFIG)).dataset)
    phase_slice_fp32(vocab)
    serve_launches, serve_off = phase_serve_bf16(vocab, card)
    bwd_rows = phase_backward()
    phase_step_fp32()
    train_launches, train_off = phase_train_bf16(card)

    stem_rows, hmma = phase_stem()
    phase_slice_fp32(vocab, stem=True)
    stem_serve_launches, serve_on = phase_serve_bf16(vocab, card, stem=True)
    phase_step_fp32(stem=True)
    stem_train_launches, train_on = phase_train_bf16(card, stem=True)
    phase_txt_bf16(vocab)
    phase_train_cli(card, train_off)
    phase_eval(card)
    options = phase_block_options(vocab, card, train_off)
    data_parallel = phase_data_parallel(card, train_off)
    arith = phase_norm_compute(vocab, card, serve_off, train_off)
    tensor_parallel = phase_tensor_parallel(card, train_off)
    phase_mesh_subset(card, tensor_parallel)
    phase_native(card)
    quality = phase_quality(card)
    log("stem_on_vs_off (phases 9-10 against 4 and 7 of this run): serving "
        + json.dumps({"on": serve_on, "off": serve_off}) + "; training "
        + json.dumps({"on": train_on, "off": train_off}))

    # per kernel, the flagship setting (bf16, norm_stats 1pass): forward
    # times summed over the call sites of one served batch, backward times
    # over those of one training step
    cfg = load_config(str(CONFIG))
    summary = []

    def entry(name, replaces, mine, per_key, per, launches, extra):
        flag = [r for r in mine if r["dtype"] == "bfloat16"
                and r["stats"] == cfg.norm_stats and r[per_key]]
        tot = lambda key: sum(r[key] * r[per_key] for r in flag)
        lib = None if flag[0]["library_ms"] is None else tot("library_ms")
        if "k" in flag[0]:
            # a cluster kernel's checks and plan at each flagship site
            extra = dict(extra, bit_equal_runs=all(r["bit_equal_runs"] for r in mine),
                         plans=[{key: r[key] for key in ("shape", "k", "smem",
                                                         "resident_share", "clusters")}
                                for r in flag])
        if "nearest_call_ms" in flag[0]:
            extra = dict(extra, nearest_call_ms=tot("nearest_call_ms"))
        return dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in mine if r["dtype"] == "float32"),
            max_abs_err_bf16=max(r["max_abs_err"] for r in mine
                                 if r["dtype"] == "bfloat16"),
            ms=tot("ms"), eager_ms=tot("eager_ms"), plain_ms=tot("plain_ms"),
            bound_ms=tot("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in flag)
            else "operations", library_ms=lib, per=per, **extra)

    for name in EXPECTED_LAUNCHES:
        # its time per training step: phase 5's forward at each training
        # site times the site's forward calls
        train = [r for r in bwd_rows if r["fwd"] == name and r["dtype"] == "bfloat16"
                 and r["stats"] == cfg.norm_stats]
        if sum(r["fwd_calls_per_step"] for r in train) != train_launches[name]:
            raise AssertionError(f"{name}: the training sites do not add up to "
                                 f"its {train_launches[name]} launches per step")
        mine = [r for r in rows if r["kernel"] == name]
        extra = {"launches_train": train_launches[name],
                 "ms_train": sum(r["fwd_ms"] * r["fwd_calls_per_step"] for r in train),
                 "bound_ms_train": sum(r["fwd_bound_ms"] * r["fwd_calls_per_step"]
                                       for r in train)}
        # phase 14: per step with the block options, per batch of each
        # legacy generator
        extra["launches_block_options"] = options["launches"][name]
        extra["launches_legacy"] = {k: v["launches"][name]
                                    for k, v in options["legacy"].items()}
        # phases 15 and 16: per step of the NCCL data axis, and under
        # norm_compute bf16 per step and per served batch with the bf16
        # arithmetic's times
        extra["launches_data_parallel"] = data_parallel["nccl"]["launches"][name]
        extra["launches_tensor_parallel"] = [r["launches"][name]
                                             for r in tensor_parallel["b"]]
        # phase 19: over quality_eval's two checkpoints
        extra["launches_quality_eval"] = quality["launches"][name]
        if name in ARITH_ROWS:
            extra["norm_compute_bf16"] = dict(
                arith_summary(arith["rows"], name, cfg.norm_stats),
                launches=arith["serve_launches"][name],
                launches_train=arith["step_launches"][name])
        if name in CLUSTER_FWD:
            # rows 1-4: CUDA kernels per call, at the serving and training sites
            extra["kernels_per_call"] = max(r["kernels_per_call"] for r in mine)
            extra["kernels_per_call_train"] = max(
                r["fwd_kernels_per_call"] for r in bwd_rows if r["fwd"] == name)
        summary.append(entry(
            name, REPLACES[name], mine, "calls_per_batch",
            "served batch of 32, bf16, " + cfg.norm_stats, serve_launches[name], extra))
    for name, counters in (("instance_norm_bwd", ("instance_norm_bwd",)),
                           ("adain_bwd", ("adain_bwd", "adain_residual_bwd")),
                           ("layer_norm_ref_bwd", ("layer_norm_ref_bwd",))):
        mine = [r for r in bwd_rows if r["kernel"] in counters]
        summary.append(entry(
            name, BWD_REPLACES[name], mine,
            "calls_per_step", "training step of 16, bf16, " + cfg.norm_stats,
            sum(train_launches[c] for c in counters),
            {"launches_by_counter": {c: train_launches[c] for c in counters},
             "launches_block_options": sum(options["launches"][c] for c in counters),
             "launches_data_parallel": sum(data_parallel["nccl"]["launches"][c]
                                           for c in counters),
             "launches_tensor_parallel": [sum(r["launches"][c] for c in counters)
                                          for r in tensor_parallel["b"]],
             "kernels_per_call": max(r["kernels_per_call"] for r in mine),
             "mask_mismatches": sum(r.get("mask_mismatches", 0) for r in mine),
             **({} if name == "layer_norm_ref_bwd" else {"norm_compute_bf16": dict(
                 arith_summary(arith["rows"], name, cfg.norm_stats),
                 launches=sum(arith["step_launches"][c] for c in counters))})}))
    stem_entry = lambda name, per_key, per, launches, extra: entry(
        name, STEM_REPLACES[name], [r for r in stem_rows if r["kernel"] == name],
        per_key, per, launches, extra)
    summary.append(dict(stem_entry(
        "stem_conv7", "calls_per_batch", "served batch of 32 with stem_pallas on, "
        "bf16, 1pass", stem_serve_launches["stem_conv7"],
        {"launches_train": stem_train_launches["stem_conv7"],
         "hmma": {"stem_tile_mma_kernel": hmma["stem_tile_mma_kernel"]}}),
        source=STEM_SOURCE))
    summary.append(dict(stem_entry(
        "stem_conv7_bwd", "calls_per_step", "training step of 16 with stem_pallas "
        "on, bf16, 1pass", stem_train_launches["stem_conv7_bwd"], {"hmma": hmma}),
        source=STEM_SOURCE))
    if any(k["launches"] == 0 or k.get("launches_train") == 0 for k in summary):
        raise AssertionError("a kernel of the serving or training path never launched")
    print(json.dumps({"kernels": summary}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-worker":   # phase 15 (b)
        sys.exit(dp_worker(int(sys.argv[2]), sys.argv[3]))
    if len(sys.argv) == 5 and sys.argv[1] == "--tp-worker":   # phases 17, 18 (a)
        sys.exit(tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
