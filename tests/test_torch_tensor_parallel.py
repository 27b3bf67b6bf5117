"""Tensor parallelism in the port (the model axis of `parallel/mesh.py`,
`parallel/rules.py`, `parallel/tensor.py`) on the CPU, one thread a
process.

The step config is `tests/test_tp_parity.py`'s with `dis.n_layer` raised
from 3 to 5, so that both discriminator rules (`Conv2dBlock_3` and `_4`)
engage, and the image from 32 to 64 px, the smallest that two scales of
five stride-2 layers take; batch 8.  Ranks are processes of this file
(`python <this file> MODE RANK WORLD TMP ARG`), joined over gloo by a
`FileStore` in the test's directory; every wait on them has a 300 s
timeout.

1. `param_shards` against JAX's `param_shardings` (JAX leaves named as the
   port's by `interop/jax_params.py`): at flagship shapes (`jax.eval_shape`
   of `create_train_state`, no compute; the port's nets on the meta
   device) JAX's 18 tensors are the port's 46, sharded on the
   corresponding dims, 17,790,592 elements; at the test config both
   discriminator rules engage; with a model axis of 3 what does not divide
   stays replicated on both sides.
2. Each conjugate pair (`copy`, `reduce`, `gather`, `split`) on 2 ranks
   against the unsharded op: forward, backward and double backward (a
   column- then row-parallel MLP, and a column-parallel conv gathered on
   its channels), within 1e-5 relative (fp32 summation order).  Without a
   group each is the identity and issues no collective.
3. One fp32 step on 1 x 2 and on 2 x 2 with JAX's parameters and draws,
   dropout off, against one process of the port and against JAX's
   `make_train_step(..., _deterministic=True)` on one device: every metric
   within `test_tp_parity.py`'s rtol 2e-4 / atol 1e-5, the gathered
   parameters within its rtol 2e-4 plus atol 2.5e-4 (2 lr: Adam's first
   step moves a parameter whose gradient is rounding noise by lr one way
   or the other).  One bf16 step on 1 x 2 against JAX bf16, every metric
   within `test_step_metrics_match_jax_bf16`'s rtol 2.5e-3.  A step with
   `state.rng`'s draws and dropout on each mesh against one process, the
   same tolerances; and on 1 x 2 one with PReLU in G and D, a LayerNorm
   discriminator and R1 every step (GP is on in the others: the double
   backward through the sharded convs), against one process.
4. After those steps `state.rng` and every replicated parameter and EMA
   copy are bit-equal on the ranks of a model group, and each rank holds
   only its shards.
5. `check_mesh` accepts what JAX's `create_mesh` accepts, with JAX's data
   axis (a mesh smaller than the world included, on the first ranks), and
   rejects what it rejects with its messages (JAX's assert on a model axis
   that does not divide the devices has none).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = str(ROOT / "configs" / "celeba_faces.yaml")
VOCAB, BATCH = 102, 8
TIMEOUT = 300
RTOL, ATOL = 2e-4, 1e-5                  # test_tp_parity.py's metrics
PARAM_RTOL, PARAM_ATOL = 2e-4, 2.5e-4    # and its parameters
BF16_RTOL = 2.5e-3                       # test_step_metrics_match_jax_bf16
PAIR_RTOL = 1e-5
FLAGSHIP_SHARDED = 17_790_592
RAW = {
    "batch_size": BATCH, "image_size": 64, "crop_size": 80,
    "compute_dtype": "float32", "gp_w": 1.0,
    "gen": {"dim": 8, "mlp_dim": 16, "style_downsample": 3,
            "content_downsample": 2, "n_res": 2, "embed_dim": 12,
            "hidden_size": 12, "num_layers": 2},
    "dis": {"dim": 8, "n_layer": 5, "num_scales": 2, "image_size": 64},
}
# the block options through the sharded layers (a LayerNorm and a PReLU
# after the gathered convs, PReLU slopes in the sharded MLP), and R1 every
# step through them
OPTIONS = {"use_r1": True, "d_reg_every": 1, "gen": {"activ": "prelu"},
           "dis": {"activ": "prelu", "norm": "ln"}}
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}   # name: (world, model)

torch.set_num_threads(1)


def _raw(over=None, dtype="float32"):
    raw = {**RAW, "compute_dtype": dtype, "gen": dict(RAW["gen"]),
           "dis": dict(RAW["dis"])}
    for k, v in (over or {}).items():
        if isinstance(v, dict):
            raw[k] = {**raw[k], **v}
        else:
            raw[k] = v
    return raw


def _cfg(over=None, dtype="float32", model=1):
    from dwcgan_tpu_torch.config import config_from_dict
    cfg = config_from_dict(_raw(over, dtype))
    cfg.mesh_model = model
    return cfg


def _batch(cfg):
    from dwcgan_tpu_torch.data.pipeline import synthetic_batch
    return synthetic_batch(BATCH, cfg.image_size, 8, cfg.max_text_len, seed=5)


def _port_step(cfg, axis=None, draws=None):
    """One step of the port at seed 0 on this rank's rows: (metrics, full
    parameters and EMA copies, the state)."""
    from dwcgan_tpu_torch.data.pipeline import Batch, to_device
    from dwcgan_tpu_torch.parallel.rules import full_state_dict
    from dwcgan_tpu_torch.train.state import create_train_state
    from dwcgan_tpu_torch.train.step import make_train_step
    state = create_train_state(cfg, VOCAB, device="cpu", seed=0, axis=axis)
    step = make_train_step(cfg, state.gen, state.dis, state.gen_opt, state.dis_opt,
                           _deterministic=draws is not None, axis=axis)
    rows = slice(0, BATCH)
    if axis is not None and axis.grouped:
        rows = slice(axis.data_rank * axis.local_batch,
                     (axis.data_rank + 1) * axis.local_batch)
    batch = Batch(*(np.asarray(a)[rows] for a in _batch(cfg)))
    mine = None if draws is None else {k: torch.from_numpy(v[rows]) for k, v in draws.items()}
    m = step(state, to_device(batch, "cpu"), draws=mine)
    full = {f"{net}.{k}": v.clone() for net in ("gen", "dis", "ema_gen", "ema_dis")
            for k, v in full_state_dict(getattr(state, net)).items()}
    return {k: float(v) for k, v in m.items()}, full, state


# ------------------------------------------------------- the rank processes

def _pairs(rank, world):
    """Three compositions of the pairs, sharded over the 2 ranks and whole
    in this process: their outputs and the gradients of a loss and of a
    gradient penalty on them (each parameter's slice of this rank)."""
    import torch.nn.functional as F
    from dwcgan_tpu_torch.parallel import tensor as tp
    from dwcgan_tpu_torch.parallel.mesh import mesh_groups
    mg = mesh_groups(rank, world, world, 1)[1]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, generator=g, dtype=torch.float64)
    w1 = torch.randn(6, 4, generator=g, dtype=torch.float64)
    b1 = torch.randn(6, generator=g, dtype=torch.float64)
    w2 = torch.randn(5, 6, generator=g, dtype=torch.float64)
    img = torch.randn(2, 3, 5, 5, generator=g, dtype=torch.float64)
    wc = torch.randn(4, 3, 3, 3, generator=g, dtype=torch.float64)
    half = lambda t, d: tp.shard_of(t, d, mg).clone()

    def mlp(x, w1, b1, w2, sharded, via_gather):
        if not sharded:
            return torch.tanh(F.linear(x, w1, b1)) @ w2.t()
        h = torch.tanh(F.linear(tp.copy(x, mg), w1, tp.split(b1, 0, mg)))
        if via_gather:
            h = tp.split(tp.gather(h, -1, mg), -1, mg)
        return tp.reduce(h @ w2.t(), mg)

    def conv(x, w, sharded):
        if not sharded:
            return F.conv2d(x, w, padding=1).sin()
        y = F.conv2d(tp.copy(x, mg), w, padding=1)
        return tp.gather(y.contiguous(memory_format=torch.channels_last), 1, mg).sin()

    out = {}
    for name in ("copy_reduce", "gather_split", "conv_gather"):
        for sharded in (False, True):
            if name == "conv_gather":
                leaves = [img, half(wc, 0) if sharded else wc]
                f = lambda a, w: conv(a, w, sharded)
            else:
                leaves = [x, half(w1, 0) if sharded else w1, b1,
                          half(w2, 1) if sharded else w2]
                f = lambda a, *p: mlp(a, *p, sharded, name == "gather_split")
            leaves = [t.clone().requires_grad_(True) for t in leaves]
            y = f(*leaves)
            loss = (y ** 2).sum()
            dx, = torch.autograd.grad(loss, leaves[0], create_graph=True)
            grads = torch.autograd.grad(loss, leaves[1:], retain_graph=True)
            penalty = (dx ** 2).sum()
            second = torch.autograd.grad(penalty, leaves)
            res = {"y": y.detach(), "dx": dx.detach(), "penalty": penalty.detach(),
                   **{f"g{i}": t for i, t in enumerate(grads)},
                   **{f"gg{i}": t for i, t in enumerate(second)}}
            if not sharded:   # the whole op's weight gradients, cut to this rank
                cut = {"g0": 0, "gg1": 0} if name == "conv_gather" else \
                    {"g0": 0, "g2": 1, "gg1": 0, "gg3": 1}
                for k, d in cut.items():
                    res[k] = half(res[k], d)
            out[(name, sharded)] = res
    return out


def _worker(mode, rank, world, tmp, arg):
    import torch.distributed as dist
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    try:
        if mode == "pairs":
            torch.save(_pairs(rank, world), tmp / f"rank{rank}.pt")
            return
        from dwcgan_tpu_torch.parallel.mesh import DataAxis
        from dwcgan_tpu_torch.parallel.rules import shards
        model = MESHES[arg][1]
        draws = torch.load(tmp / "draws.pt", weights_only=False)
        runs = {"jax": (None, "float32", draws["float32"]), "rng": (None, "float32", None)}
        if arg == "1x2":
            runs.update(bf16=(None, "bfloat16", draws["bfloat16"]),
                        options=(OPTIONS, "float32", None))
        res = {}
        for name, (over, dtype, d) in runs.items():
            cfg = _cfg(over, dtype, model)
            axis = DataAxis.from_config(cfg)
            assert (axis.rank, axis.model, axis.data_rank, axis.model_rank) == \
                (rank, model, rank // model, rank % model)
            metrics, full, state = _port_step(cfg, axis, d)
            local = {f"{net}.{k}": v for net in ("gen", "dis", "ema_gen", "ema_dis")
                     for k, v in getattr(state, net).state_dict().items()}
            res[name] = dict(metrics=metrics, full=full, local=local,
                             rng=state.rng.get_state(),
                             shards={net: shards(getattr(state, net))
                                     for net in ("gen", "dis", "ema_gen", "ema_dis")},
                             held=sum(p.numel() for net in (state.gen, state.dis)
                                      for p in net.parameters()),
                             moments_fit=all(
                                 opt.state[p][k].shape == p.shape
                                 for opt in (state.gen_opt, state.dis_opt)
                                 for p in opt.param_groups[0]["params"]
                                 for k in ("exp_avg", "exp_avg_sq")))
        torch.save(res, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _launch(mode, tmp, world, arg=""):
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(world),
                               str(tmp), arg], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------- 1. the rules

def _marked(jax_params, shardings):
    """Each JAX leaf filled with its index along its sharded dim, or -1
    where it is replicated."""
    import jax

    def mark(leaf, sh):
        spec = tuple(sh.spec)
        dims = [d for d, a in enumerate(spec) if a == "model"]
        if not dims:
            return np.full(leaf.shape, -1.0, np.float32)
        shape = [1] * len(leaf.shape)
        shape[dims[0]] = leaf.shape[dims[0]]
        idx = np.arange(leaf.shape[dims[0]], dtype=np.float32).reshape(shape)
        return np.broadcast_to(idx, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map(mark, jax_params, shardings)


def _compare_rules(jcfg, tcfg, model, gen_shapes, dis_shapes):
    """JAX's shardings mapped to port names against `param_shards`: the
    port names with the dim along which JAX's marks vary; returns (JAX's
    sharded leaves, the port's {name: dim} of G and D)."""
    import jax
    from dwcgan_tpu.parallel.mesh import create_mesh, param_shardings
    from dwcgan_tpu_torch.interop.jax_params import (jax_dis_to_state_dict,
                                                     jax_to_state_dict)
    from dwcgan_tpu_torch.models.discriminator import MsImageDis
    from dwcgan_tpu_torch.models.generator import Generator
    from dwcgan_tpu_torch.parallel.rules import param_shards
    mesh = create_mesh(data=jax.device_count() // model, model=model,
                       devices=jax.devices()[:(jax.device_count() // model) * model])
    n_jax, port = 0, {}
    with torch.device("meta"):
        nets = {"gen": Generator(tcfg.gen, tcfg.input_dim, VOCAB),
                "dis": MsImageDis(tcfg.dis)}
    for net, shapes, to_sd, sub in (("gen", gen_shapes, jax_to_state_dict, jcfg.gen),
                                    ("dis", dis_shapes, jax_dis_to_state_dict, jcfg.dis)):
        sh = param_shardings(mesh, shapes)
        n_jax += sum("model" in tuple(s.spec)
                     for s in jax.tree_util.tree_leaves(sh))
        sd = to_sd(_marked(shapes, sh), sub)
        module = nets[net]
        assert sorted(sd) == sorted(n for n, _ in module.named_parameters())
        want = {}
        for name, arr in sd.items():
            vary = [ax for ax in range(arr.ndim) if arr.shape[ax] > 1
                    and np.ptp(arr, axis=ax).max() > 0]
            assert len(vary) <= 1, (name, vary)
            if vary:
                want[name] = vary[0]
        got = param_shards(module, model)
        assert got == want, (net, model, set(got.items()) ^ set(want.items()))
        port[net] = got
    return n_jax, port, nets


@pytest.fixture(scope="module")
def jax_cfgs():
    from dwcgan_tpu.config import config_from_dict as jax_config_from_dict
    from dwcgan_tpu.config import load_config as jax_load_config
    from dwcgan_tpu_torch.config import load_config
    return {"flagship": (jax_load_config(FLAGSHIP), load_config(FLAGSHIP)),
            "test": (jax_config_from_dict(_raw()), _cfg())}


def _jax_shapes(jcfg):
    import jax
    from dwcgan_tpu.train.state import create_train_state
    st = jax.eval_shape(lambda k: create_train_state(jcfg, k, VOCAB),
                        jax.random.PRNGKey(0))
    return st.gen_params, st.dis_params


@pytest.mark.parametrize("which", ["flagship", "test"])
def test_param_shards_are_jaxs_param_shardings(jax_cfgs, which):
    jcfg, tcfg = jax_cfgs[which]
    gen_shapes, dis_shapes = _jax_shapes(jcfg)
    n_jax, port, nets = _compare_rules(jcfg, tcfg, 2, gen_shapes, dis_shapes)
    numel = lambda net: sum(dict(nets[net].named_parameters())[n].numel()
                            for n in port[net])
    if which == "flagship":
        assert n_jax == 18
        assert len(port["gen"]) + len(port["dis"]) == 46
        assert numel("gen") + numel("dis") == FLAGSHIP_SHARDED
        assert numel("gen") == 5_207_680 and numel("dis") == 12_582_912
        assert sum(n.startswith("enc_style.") for n in port["gen"]) == 16
    else:   # both discriminator rules engage at the test config
        assert sorted(port["dis"]) == [f"cnns_feat.{s}.{j}.conv.weight"
                                       for s in range(2) for j in (3, 4)]
        assert {"mlp.model.1.fc.weight", "mlp.model.2.fc.weight"} <= set(port["gen"])
    # a model axis of 3: what does not divide stays replicated on both sides
    _, port3, _ = _compare_rules(jcfg, tcfg, 3, gen_shapes, dis_shapes)
    if which == "flagship":   # 2400 and 1200 divide by 3; 256 and 512 do not
        assert sorted({n.split(".")[0] for n in port3["gen"]}) == ["enc_txt"]
        assert port3["dis"] == {}
    assert all(port3[net].keys() <= port[net].keys() for net in port)


def test_spectral_norm_blocks_stay_replicated():
    from dwcgan_tpu_torch.models.discriminator import MsImageDis
    from dwcgan_tpu_torch.parallel.rules import param_shards
    cfg = _cfg({"dis": {"norm": "sn"}})
    with torch.device("meta"):
        assert param_shards(MsImageDis(cfg.dis), 2) == {}
        assert param_shards(MsImageDis(_cfg().dis), 1) == {}


# ------------------------------------------------------------- 2. the pairs

def test_conjugate_pairs_match_the_unsharded_ops(tmp_path):
    ranks = _launch("pairs", tmp_path, 2)
    for r in ranks:
        for name in ("copy_reduce", "gather_split", "conv_gather"):
            whole, part = r[(name, False)], r[(name, True)]
            assert whole.keys() == part.keys()
            for k, want in whole.items():
                np.testing.assert_allclose(part[k].numpy(), want.numpy(),
                                           rtol=PAIR_RTOL, atol=1e-12,
                                           err_msg=f"{name} {k}")


def test_pairs_without_a_group_are_the_identity():
    from dwcgan_tpu_torch.parallel import tensor as tp
    tp.reset_collectives()
    x = torch.randn(3, 4, requires_grad=True)
    for f in (lambda t: tp.copy(t, None), lambda t: tp.reduce(t, None),
              lambda t: tp.gather(t, -1, None), lambda t: tp.split(t, 0, None)):
        assert f(x) is x
    assert tp.COLLECTIVES == {}


# ------------------------------------------------------ 3-4. the TP steps

@pytest.fixture(scope="module")
def jax_steps():
    """The JAX step on one device from the port's seed-0 parameters, fp32
    and bf16 (dropout off, compiled once each): its metrics and the draws
    the port is given."""
    import jax
    from dwcgan_tpu.config import config_from_dict as jax_config_from_dict
    from dwcgan_tpu.data.pipeline import Batch as JaxBatch
    from dwcgan_tpu.interop.torch_import import (convert_reference_discriminator,
                                                 convert_reference_generator)
    from dwcgan_tpu.ops import norms as jnorms
    from dwcgan_tpu.train.state import TrainState, build_models, make_optimizer
    from dwcgan_tpu.train.step import make_train_step as jax_make_train_step
    from dwcgan_tpu_torch.train.state import create_train_state
    ts = create_train_state(_cfg(), VOCAB, device="cpu", seed=0)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = jax_config_from_dict(_raw(dtype=dtype))
        gp = convert_reference_generator(ts.gen.state_dict(), jcfg.gen, VOCAB)["params"]
        dp = convert_reference_discriminator(ts.dis.state_dict(), jcfg.dis)["params"]
        gen, dis = build_models(jcfg, VOCAB)
        gen_tx, dis_tx = make_optimizer(jcfg, gp), make_optimizer(jcfg, dp)
        copy = lambda t: jax.tree_util.tree_map(np.array, t)
        state = TrainState(step=np.zeros((), np.int32), gen_params=gp, dis_params=dp,
                           ema_gen_params=copy(gp), ema_dis_params=copy(dp),
                           gen_opt_state=gen_tx.init(gp), dis_opt_state=dis_tx.init(dp),
                           rng=jax.random.PRNGKey(2))
        k_d, k_g = jax.random.split(jax.random.fold_in(state.rng, 0))
        keys = jax.random.split(k_g, 8)
        normal = lambda kk: np.array(jax.random.normal(kk, (BATCH, 8, jcfg.c_dim)))
        draws = {"style1": normal(keys[3]), "style2": normal(keys[4]),
                 "gp_alpha": np.array(jax.random.uniform(jax.random.split(k_d, 4)[3],
                                                         (BATCH, 1, 1, 1)))}
        try:
            fn = jax.jit(jax_make_train_step(jcfg, gen, dis, gen_tx, dis_tx,
                                             _deterministic=True))
            batch = JaxBatch(*_batch(jcfg))
            fn = fn.lower(state, batch).compile({"xla_backend_optimization_level": 0})
            _, m = fn(state, batch)
        finally:
            jnorms.set_stats_mode("2pass")
        out[dtype] = ({k: float(v) for k, v in m.items()}, draws)
    return out


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory, jax_steps):
    """Each mesh's ranks and one process of the port on the same runs."""
    draws = {k: v[1] for k, v in jax_steps.items()}
    runs = {}
    for mesh, (world, _) in MESHES.items():
        tmp = tmp_path_factory.mktemp(mesh)
        torch.save(draws, tmp / "draws.pt")
        runs[mesh] = _launch("step", tmp, world, mesh)
    one = {"jax": _port_step(_cfg(), draws=draws["float32"]),
           "rng": _port_step(_cfg()), "options": _port_step(_cfg(OPTIONS))}
    return runs, one


def _close_metrics(got, want, rtol, atol, label):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{label} {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_step_matches_one_process_and_jax(tp_runs, jax_steps, mesh):
    ranks, one = tp_runs[0][mesh], tp_runs[1]
    for rank, r in enumerate(ranks):
        names = ("jax", "rng") + (("options",) if mesh == "1x2" else ())
        for name in names:
            got = r[name]
            want_m, want_p, _ = one[name]
            _close_metrics(got["metrics"], want_m, RTOL, ATOL, f"{mesh} r{rank} {name}")
            assert got["full"].keys() == want_p.keys()
            for k, w in want_p.items():
                np.testing.assert_allclose(got["full"][k].numpy(), w.numpy(),
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=f"{mesh} r{rank} {name} {k}")
        _close_metrics(r["jax"]["metrics"], jax_steps["float32"][0], RTOL, ATOL,
                       f"{mesh} r{rank} vs JAX")
        if mesh == "1x2":
            want = jax_steps["bfloat16"][0]
            got = r["bf16"]["metrics"]
            assert sorted(got) == sorted(want)
            for k in want:
                assert abs(got[k] - want[k]) <= BF16_RTOL * abs(want[k]) + 1e-7, \
                    (k, got[k], want[k])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rng_and_replicated_params_bit_equal_across_the_model_axis(tp_runs, mesh):
    ranks = tp_runs[0][mesh]
    world, model = MESHES[mesh]
    for name in ranks[0]:
        for r in range(world):
            a, b = ranks[r - r % model][name], ranks[r][name]
            assert torch.equal(a["rng"], b["rng"]), (name, r)
            sh = a["shards"]
            assert sh["ema_gen"] == sh["gen"] and sh["ema_dis"] == sh["dis"]
            for k, v in a["local"].items():
                net, pname = k.split(".", 1)
                if pname in sh[net]:
                    full = a["full"][k]
                    assert v.shape[sh[net][pname]] * model == full.shape[sh[net][pname]]
                    assert torch.equal(b["local"][k], full.narrow(
                        sh[net][pname], (r % model) * v.shape[sh[net][pname]],
                        v.shape[sh[net][pname]])), (name, k)
                else:
                    assert torch.equal(v, b["local"][k]), (name, r, k)
        # every rank holds only its shards, in its parameters and moments
        r0 = ranks[0][name]
        nets = [k.split(".", 1) for k in r0["full"] if k.split(".")[0] in ("gen", "dis")]
        full = sum(r0["full"][f"{n}.{k}"].numel() for n, k in nets)
        sharded = sum(r0["full"][f"{n}.{k}"].numel() for n, k in nets
                      if k in r0["shards"][n])
        assert sharded > 0 and r0["held"] == full - sharded + sharded // model
        assert all(r[name]["moments_fit"] for r in ranks)


# ------------------------------------------------------------- 5. the mesh

@pytest.mark.parametrize("world,data,model,batch", [
    (4, -1, 1, 8), (4, -1, 2, 8), (4, -1, 4, 8), (4, 2, 2, 8), (4, 4, 1, 8),
    (4, 1, 4, 8), (4, -1, 3, 8), (4, 2, 3, 8), (4, 1, 2, 8), (4, -1, 2, 5),
    (2, -1, 2, 3), (8, -1, 2, 12), (8, 2, 4, 6)])
def test_check_mesh_accepts_and_rejects_as_jax(world, data, model, batch):
    import jax
    from dwcgan_tpu.parallel.mesh import create_mesh
    from dwcgan_tpu_torch.parallel.mesh import check_mesh
    cfg = _cfg()
    cfg.mesh_data, cfg.mesh_model, cfg.batch_size = data, model, batch
    try:
        mesh = create_mesh(data, model, devices=jax.devices()[:world])
        jax_err = None
        d = mesh.shape["data"]
        if batch % d:   # dwcgan_tpu/cli/train.py:130-132
            jax_err = (f"batch_size {batch} must be divisible by the data mesh "
                       f"axis ({d}); set batch_size or mesh_data accordingly")
    except AssertionError as e:
        jax_err, d = str(e), None
    if jax_err is None:
        # a mesh smaller than the world included: JAX builds it on the
        # first devices, the port on the first ranks
        assert check_mesh(cfg, world) == d
    elif jax_err == "":   # `assert len(devices) % model == 0`: no message
        with pytest.raises(ValueError, match=f"mesh_model {model} does not divide"):
            check_mesh(cfg, world)
    else:
        with pytest.raises(ValueError) as e:
            check_mesh(cfg, world)
        assert str(e.value) == jax_err


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5] if len(sys.argv) > 5 else "")
