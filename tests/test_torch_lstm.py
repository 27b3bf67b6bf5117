"""The port's packed bi-LSTM against the JAX masked-scan `MaskedBiLSTM`.

Same weights (JAX `w_x [D, 4H]`, `w_h [H, 4H]`, `b [4H]` -> torch
`weight_ih`, `weight_hh`, `bias_ih = b`, `bias_hh = 0`), same numpy inputs,
ragged lengths including 1 and the full width; fp32 on the CPU, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.ops.lstm import MaskedBiLSTM as JaxLSTM
from dwcgan_tpu_torch.ops.cuda import kernels
from dwcgan_tpu_torch.ops.lstm import MaskedBiLSTM, recurrence_plain

torch.set_num_threads(1)

B, T, D, HID = 4, 7, 5, 6


def _load_from_jax(lstm: MaskedBiLSTM, params, num_layers: int) -> None:
    sd = {}
    for layer in range(num_layers):
        p = params[f"l{layer}"]
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            sd[f"weight_ih_l{layer}{suf}"] = np.asarray(p[f"{d}_w_x"]).T
            sd[f"weight_hh_l{layer}{suf}"] = np.asarray(p[f"{d}_w_h"]).T
            sd[f"bias_ih_l{layer}{suf}"] = np.asarray(p[f"{d}_b"])
            sd[f"bias_hh_l{layer}{suf}"] = np.zeros(4 * HID, np.float32)
    lstm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})


@pytest.mark.parametrize("lengths", [[5, 1, 3, 7], [7, 7, 2, 4]])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_masked_bilstm_matches_jax(num_layers, lengths):
    rng = np.random.default_rng(num_layers)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jl = JaxLSTM(HID, num_layers)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens))["params"]
    j_out, j_h, j_c = jl.apply({"params": params}, jnp.asarray(x), jnp.asarray(lens))

    tl = MaskedBiLSTM(D, HID, num_layers).eval()
    _load_from_jax(tl, params, num_layers)
    with torch.no_grad():
        out, h, c = tl(torch.from_numpy(x), torch.from_numpy(lens))
    assert out.shape == (B, T, 2 * HID) and h.shape == (num_layers, 2, B, HID)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(j_h), atol=1e-5, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(j_c), atol=1e-5, rtol=0)
    # outputs past each length are zero, as the masked scan leaves them
    for b, n in enumerate(lengths):
        assert not out[b, n:].any()


def _bf16_case():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lens = np.asarray([5, 1, 3, 7], np.int32)
    out = {}
    params = None
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jl = JaxLSTM(HID, 2, dtype=dt)
        if params is None:
            params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens))["params"]
        out[name] = [np.asarray(a, np.float32) for a in
                     jl.apply({"params": params}, jnp.asarray(x, dt), jnp.asarray(lens))]
    tl = MaskedBiLSTM(D, HID, 2).eval()
    _load_from_jax(tl, params, 2)
    return x, lens, out, tl


def test_bf16_recurrence_rounds_where_the_jax_scan_rounds():
    """In bf16 the port's loop computes the JAX scan's function: its
    outputs and final states sit far closer to the JAX bf16 scan than the
    JAX fp32 scan does (bit-equal on the CPU the tests were written on)."""
    x, lens, out, tl = _bf16_case()
    with torch.no_grad():
        got = tl(torch.from_numpy(x).bfloat16(), torch.from_numpy(lens))
    for g, want, ref32 in zip(got, out["bf16"], out["f32"]):
        assert g.dtype == torch.bfloat16
        gap = float(np.abs(ref32 - want).max())
        assert gap > 0
        assert float(np.abs(g.float().numpy() - want).max()) <= gap / 8


def test_fused_bf16_cell_is_not_the_jax_function():
    """Why the recurrence is a loop of ops: `nn.LSTM` in bf16 (its fused
    cell) rounds at other places than the JAX scan, and its final states are
    not the JAX bf16 ones."""
    x, lens, out, tl = _bf16_case()
    fused = torch.nn.LSTM(D, HID, num_layers=2, bidirectional=True,
                          batch_first=True).bfloat16().eval()
    fused.load_state_dict({k: v.bfloat16() for k, v in tl.state_dict().items()})
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(lens).long(),
        batch_first=True, enforce_sorted=False)
    with torch.no_grad():
        _, (h, _) = fused(packed)
    h = h.float().numpy().reshape(2, 2, B, HID)
    assert float(np.abs(h - out["bf16"][1]).max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[5, 1, 3, 6], [2, 2, 2, 2]])
def test_steps_at_the_full_width_match_the_host_lengths(monkeypatch, dtype, lengths):
    """Lengths where the input is, on the kernel route (as the graphed
    training step holds them on the card; here the kernels' plain versions
    in their place): no length is read on the host, every step of the
    width runs, masked throughout, and the outputs, final h and c are
    bit-identical to the loop's over the longest length read on the host,
    the outputs zero past each length.  Two layers with the inter-layer
    dropout on, its mask drawn at the full width either way."""
    def no_read(*args, **kw):
        raise AssertionError("the lengths were read on the host")
    torch.manual_seed(3)
    m = MaskedBiLSTM(D, HID, 2, dropout=0.3).train()
    x = torch.randn(B, T, D).to(dtype)
    lens = torch.tensor(lengths)
    want = m(x, lens, torch.Generator().manual_seed(1))
    monkeypatch.setattr(kernels, "lstm", recurrence_plain)
    monkeypatch.setattr(m, "kernel_route", lambda device: True)
    monkeypatch.setattr(torch.Tensor, "cpu", no_read)
    got = m(x, lens, torch.Generator().manual_seed(1))
    monkeypatch.undo()
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    for b, n in enumerate(lengths):
        assert not got[0][b, n:].any()
