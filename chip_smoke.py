#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`dwcgan_tpu_torch`).

    python3 chip_smoke.py          # from the root of a checkout, one H100

Phases (any failure exits non-zero; nothing is caught and carried on):

1. card: name and power limit from nvidia-smi; build the norm kernels from
   `dwcgan_tpu_torch/csrc/` with nvcc and print the build seconds;
2. kernels: each of the four hand-written kernels at every shape the
   serving path gives it (batch 32), in fp32 and bf16 and in both stats
   modes, against its plain PyTorch version on the card; kernel, plain and
   library device times (20 calls in a CUDA graph, CUDA events, cold L2)
   beside the bytes bound, and the kernel's eager time (wrapper included);
3. the slice in fp32 on the card (kernels) against the CPU (plain
   versions), flagship width, 4 images, TF32 off: max abs diff <= 2e-3;
4. the slice at flagship width in bf16 (`configs/celeba_faces.yaml`, batch
   32, synthesized commands) through `translate_batch`: launch counts of
   exactly 11 IN, 4 AdaIN+ReLU, 4 AdaIN-residual and 2 LayerNorm per batch,
   finite output in [-1, 1], images/s and peak memory.

The last lines are the `kernels` JSON, the nvidia-smi line and
`{"ok": true, "device": {...}}`.  Without a card it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from dwcgan_tpu_torch.cli.translate import synthetic_requests, translate_batch
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.ops import norms
from dwcgan_tpu_torch.ops.cuda import build, kernels
from dwcgan_tpu_torch.text.vocab import Vocab, encode_commands
from dwcgan_tpu_torch.train.sampler import make_infer_fn

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


def run_kernel(kernel, args, relu, stats):
    two_pass = stats == "2pass"
    if kernel == "instance_norm":
        return kernels.instance_norm(*args, relu=relu, two_pass=two_pass)
    if kernel == "adain":
        return kernels.adain(*args, relu=relu, two_pass=two_pass)
    if kernel == "adain_residual":
        return kernels.adain_residual(*args, two_pass=two_pass)
    return kernels.layer_norm_ref(*args, two_pass=two_pass)


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


def library_call(kernel, args):
    """One PyTorch call computing the same function, where one exists:
    F.instance_norm for the instance norm (without the fused ReLU);
    AdaIN, its residual form and the reference LayerNorm have none."""
    if kernel == "instance_norm":
        return lambda i: F.instance_norm(args[i % len(args)][0])
    return None


def check_site(kernel, shape, relu, dtype, stats, g):
    args = site_inputs(kernel, shape, dtype, g)
    out = run_kernel(kernel, args, relu, stats)
    torch.cuda.synchronize()
    ref32 = run_plain(kernel, tuple(a.float() for a in args), relu, stats)
    if dtype == torch.float32:
        err = (out - ref32).abs()
        tol = torch.full_like(err, FP32_ATOL)
    else:
        ref = ref32.to(torch.bfloat16)
        err = (out.float() - ref.float()).abs()
        # BF16_ULPS ulps of the rounded result, plus the fp32 atol where the
        # summation order alone moves a value near zero by more than that
        tol = BF16_ULPS * bf16_ulp(ref) + FP32_ATOL
    bad = int((err > tol).sum())
    max_err = float(err.max())
    if not torch.isfinite(out).all() or bad:
        raise AssertionError(
            f"{kernel} {shape} {dtype} {stats} relu={relu}: {bad} elements "
            f"outside tolerance, max abs err {max_err:.3e}")

    # timing: rotate over copies of the inputs so the L2 is cold, as on the
    # path, where each norm reads a fresh conv output
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    copies = [args] + [tuple(a.clone(memory_format=torch.preserve_format)
                             if a.dim() == 4 else a for a in args)
                       for _ in range(max(0, math.ceil(COLD_L2_BYTES / in_bytes) - 1))]
    kern = lambda i: run_kernel(kernel, copies[i % len(copies)], relu, stats)
    ms = device_ms(kern)
    eager_ms = time_ms(kern)   # as the eager path calls it, wrapper included
    plain_ms = device_ms(lambda i: run_plain(kernel, copies[i % len(copies)],
                                             relu, stats))
    lib = library_call(kernel, copies)
    library_ms = device_ms(lib) if lib is not None else None
    bound_ms, bound_by = site_bound(kernel, shape, dtype, stats)
    return dict(kernel=kernel, shape=list(shape), relu=relu,
                dtype=str(dtype).replace("torch.", ""), stats=stats,
                max_abs_err=max_err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


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


# ---------------------------------------------------------------- phases 3, 4

def phase_slice_fp32(vocab):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(str(CONFIG))
    cfg.compute_dtype = "float32"
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
    log(f"slice_fp32: batch 4, norm_stats {cfg.norm_stats}, launches {ran}, "
        f"max abs diff card vs CPU {diff:.3e} (tolerance {SLICE_ATOL})")
    if not torch.isfinite(gpu).all() or diff > SLICE_ATOL or ran != EXPECTED_LAUNCHES:
        raise AssertionError(f"fp32 slice: diff {diff}, launches {ran}")
    torch.backends.cudnn.allow_tf32 = True
    return diff


def phase_serve_bf16(vocab, card):
    cfg = load_config(str(CONFIG))
    dev = torch.device("cuda")
    gen = build_generator(cfg, vocab.size, device=dev, seed=SEED)
    infer = make_infer_fn(cfg, gen)
    imgs, cmds = synthetic_requests(BATCH, cfg.image_size, SEED + 2)

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    out = translate_batch(infer, imgs, cmds, vocab, cfg.max_text_len, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"serve_bf16: {cfg.compute_dtype}, norm_stats {cfg.norm_stats}, "
        f"batch {BATCH}, launches per batch {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launches {launches} != {EXPECTED_LAUNCHES}")
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
    log(f"serve_bf16: {SERVE_BATCHES} batches of {BATCH} after 3 warm-up: "
        f"CUDA-event ms per batch median {med:.3f}, min {ev[0]:.3f}, max "
        f"{ev[-1]:.3f} -> {BATCH / (med / 1e3):.1f} images/s at the median; "
        f"host wall ms median {wall[len(wall) // 2]:.3f}, max {wall[-1]:.3f}; "
        f"stages (CUDA events, mean of 10) encode {enc:.3f} ms, encode_txt "
        f"{txt:.3f} ms, decode {dec:.3f} ms; peak memory {peak / 2**20:.0f} "
        f"MiB; card {card}")
    return launches


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
    launches = phase_serve_bf16(vocab, card)

    # per kernel, the flagship setting (bf16, norm_stats 1pass): times summed
    # over the call sites of one served batch
    cfg = load_config(str(CONFIG))
    summary = []
    for name in EXPECTED_LAUNCHES:
        mine = [r for r in rows if r["kernel"] == name]
        flag = [r for r in mine if r["dtype"] == "bfloat16"
                and r["stats"] == cfg.norm_stats]
        tot = lambda key: sum(r[key] * r["calls_per_batch"] for r in flag)
        lib = None if flag[0]["library_ms"] is None else tot("library_ms")
        summary.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine
                            if r["dtype"] == "float32"),
            max_abs_err_bf16=max(r["max_abs_err"] for r in mine
                                 if r["dtype"] == "bfloat16"),
            ms=tot("ms"), eager_ms=tot("eager_ms"), plain_ms=tot("plain_ms"),
            bound_ms=tot("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in flag)
            else "operations",
            library_ms=lib, per="served batch of 32, bf16, " + cfg.norm_stats))
    print(json.dumps({"kernels": summary}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
