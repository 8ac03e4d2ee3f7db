"""Kernel B2 (`hanabi_sad_tpu_torch.ops.lstm_seq.LstmSeqDiff`), the
differentiable sequence LSTM, against the JAX package: `jax.vjp` of
`hanabi_sad_tpu.models.lstm.lstm_seq` and `pallas_lstm.lstm_seq_pallas_diff`
(its forward in interpret mode, as tests/test_ops.py runs it); and against
autograd of the port's plain LSTM in float64.

On the CPU, B2's forward is the plain version keeping its gates
(`lstm_seq_plain(save=True)`) and its backward is `lstm_seq_bwd_plain`, the
BPTT algorithm of the backward kernel written in plain PyTorch over those
saved gates: these tests hold that algorithm (and the Function's plumbing:
argument order, the grads of xs, h0, c0 and every weight, unused outputs and
inputs that want no grad) against JAX. Inputs are made with numpy from a
seed: T=6, B=5, H=32, L=2. Tolerances: 1e-5 abs on values and 1e-4 abs on
grads against JAX (float32 sums over 6 steps in another order); 1e-10 of the
largest grad against float64 autograd (the same derivatives, rounded in
another order). The kernels on the card are in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.models import lstm as jlstm
from hanabi_sad_tpu.ops.experimental import pallas_lstm
from hanabi_sad_tpu_torch.models import lstm as tlstm
from hanabi_sad_tpu_torch.models import r2d2_net as tnet
from hanabi_sad_tpu_torch.ops.lstm_seq import LstmSeqDiff, lstm_seq_diff, lstm_seq_plain

T, B, H, L = 6, 5, 32, 2


def make(seed):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(H)
    params = [
        {
            "w_ih": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
            "b": rng.uniform(-2 * k, 2 * k, (4 * H,)).astype(np.float32),
        }
        for _ in range(L)
    ]
    xs = rng.randn(T, B, H).astype(np.float32)
    h0 = (0.5 * rng.randn(L, B, H)).astype(np.float32)
    c0 = (0.5 * rng.randn(L, B, H)).astype(np.float32)
    g_out = rng.randn(T, B, H).astype(np.float32)
    g_h = rng.randn(L, B, H).astype(np.float32)
    return params, xs, h0, c0, g_out, g_h


def torch_leaves(params, xs, h0, c0):
    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in params]
    return tp, torch.tensor(xs, requires_grad=True), torch.tensor(h0, requires_grad=True), torch.tensor(c0, requires_grad=True)


def torch_objective(fn, params, xs, h0, c0, g_out, g_h):
    """sum(outs * g_out) + sum(hT * g_h), and its grads in the order
    (xs, h0, c0, then every layer's w_ih, w_hh, b)."""
    tp, txs, th0, tc0 = torch_leaves(params, xs, h0, c0)
    outs, (h_t, _) = fn(tp, txs, (th0, tc0))
    obj = (outs * torch.from_numpy(g_out)).sum() + (h_t * torch.from_numpy(g_h)).sum()
    leaves = [txs, th0, tc0] + [p[k] for p in tp for k in ("w_ih", "w_hh", "b")]
    return obj, torch.autograd.grad(obj, leaves)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the custom-vjp forward through interpret mode, as test_ops does."""
    orig = pallas_lstm.lstm_seq_pallas
    monkeypatch.setattr(
        pallas_lstm, "lstm_seq_pallas",
        lambda p, x, h, block_b=256: orig(p, x, h, block_b=B, interpret=True),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_b2_matches_jax_grad_through_pallas_diff(pallas_interpret, seed):
    params, xs, h0, c0, g_out, g_h = make(seed)

    def jax_objective(p, x, h, c):
        outs, (h_t, _) = pallas_lstm.lstm_seq_pallas_diff(p, x, (h, c))
        return (outs * g_out).sum() + (h_t * g_h).sum()

    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    j_obj, (g_p, g_x, g_h0, g_c0) = jax.value_and_grad(jax_objective, argnums=(0, 1, 2, 3))(
        jp, jnp.asarray(xs), jnp.asarray(h0), jnp.asarray(c0)
    )
    t_obj, t_grads = torch_objective(lstm_seq_diff, params, xs, h0, c0, g_out, g_h)
    np.testing.assert_allclose(float(t_obj.detach()), float(j_obj), rtol=1e-5)
    j_grads = [g_x, g_h0, g_c0] + [p[k] for p in g_p for k in ("w_ih", "w_hh", "b")]
    for t, j in zip(t_grads, j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)


def test_b2_forward_keeping_its_gates_matches_jax_scan():
    """The forward that keeps the gates gives the JAX scan's outputs, and the
    plain version's bit for bit."""
    params, xs, h0, c0, _, _ = make(5)
    tp, txs, th0, tc0 = torch_leaves(params, xs, h0, c0)
    outs, (h_t, c_t) = lstm_seq_diff(tp, txs, (th0, tc0))
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    j_outs, (j_h, j_c) = jlstm.lstm_seq(jp, jnp.asarray(xs), (jnp.asarray(h0), jnp.asarray(c0)))
    with torch.no_grad():
        ref = lstm_seq_plain(tp, txs, (th0, tc0))
    for t, j, r in ((outs, j_outs, ref[0]), (h_t, j_h, ref[1][0]), (c_t, j_c, ref[1][1])):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5, rtol=0)
        assert torch.equal(t.detach(), r)


# Which inputs want a grad and which outputs' grads are given; None is an
# output that the objective does not use.
VJP_CASES = {
    "all": (("xs", "h0", "c0", "w"), ("outs", "hT", "cT")),
    "no_g_h": (("xs", "h0", "c0", "w"), ("outs", "cT")),
    "no_g_c": (("xs", "h0", "c0", "w"), ("outs", "hT")),
    "outs_only": (("xs", "h0", "c0", "w"), ("outs",)),
    "weights_only": (("w",), ("outs", "hT", "cT")),
    "xs_and_c0": (("xs", "c0"), ("hT", "cT")),
}


@pytest.mark.parametrize("case", list(VJP_CASES))
def test_b2_bwd_plain_matches_jax_vjp(case):
    wanted, given = VJP_CASES[case]
    params, xs, h0, c0, g_out, g_h = make(6)
    g_c = np.random.RandomState(60).randn(L, B, H).astype(np.float32)
    cot = {"outs": g_out, "hT": g_h, "cT": g_c}
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    _, vjp = jax.vjp(jlstm.lstm_seq, jp, jnp.asarray(xs), (jnp.asarray(h0), jnp.asarray(c0)))
    jcot = {n: jnp.asarray(a if n in given else np.zeros_like(a)) for n, a in cot.items()}
    j_p, j_x, (j_h0, j_c0) = vjp((jcot["outs"], (jcot["hT"], jcot["cT"])))
    j_grads = {"xs": j_x, "h0": j_h0, "c0": j_c0}
    for layer, p in enumerate(j_p):
        for k in ("w_ih", "w_hh", "b"):
            j_grads[f"{k}{layer}"] = p[k]

    tp = [{k: torch.tensor(v, requires_grad="w" in wanted) for k, v in p.items()} for p in params]
    t_in = {n: torch.tensor(a, requires_grad=n in wanted) for n, a in (("xs", xs), ("h0", h0), ("c0", c0))}
    calls = LstmSeqDiff.calls
    outs, (h_t, c_t) = lstm_seq_diff(tp, t_in["xs"], (t_in["h0"], t_in["c0"]))
    assert LstmSeqDiff.calls == calls + 1
    ys = {"outs": outs, "hT": h_t, "cT": c_t}
    leaves = {n: t for n, t in t_in.items() if n in wanted}
    if "w" in wanted:
        leaves.update({f"{k}{layer}": p[k] for layer, p in enumerate(tp) for k in ("w_ih", "w_hh", "b")})
    grads = torch.autograd.grad([ys[n] for n in given], list(leaves.values()),
                                [torch.from_numpy(cot[n]) for n in given])
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[name]), atol=1e-4, rtol=0, err_msg=name)


def test_b2_equals_autograd_of_the_plain_version():
    """In float64, B2's backward (the BPTT of lstm_seq_bwd_plain over the
    saved gates) gives autograd's grads of the plain version within 1e-10 of
    each tensor's largest grad."""
    params, xs, h0, c0, g_out, g_h = make(2)
    params = [{k: v.astype(np.float64) for k, v in p.items()} for p in params]
    xs, h0, c0, g_out, g_h = (a.astype(np.float64) for a in (xs, h0, c0, g_out, g_h))
    calls = LstmSeqDiff.calls
    obj, grads = torch_objective(lstm_seq_diff, params, xs, h0, c0, g_out, g_h)
    ref_obj, ref_grads = torch_objective(lstm_seq_plain, params, xs, h0, c0, g_out, g_h)
    assert LstmSeqDiff.calls == calls + 1
    assert grads[0].dtype == torch.float64
    np.testing.assert_allclose(float(obj.detach()), float(ref_obj.detach()), rtol=1e-12)
    for g, r in zip(grads, ref_grads):
        assert float((g - r).abs().max()) <= 1e-10 * float(r.abs().max())


def test_b2_grads_only_what_is_asked_and_unused_outputs_count_as_zero():
    """Only w_hh wants a grad and only cT is used: B2 gives w_hh's grads of
    both layers as JAX's vjp with zero cotangents for outs and hT does, and
    the other weights none."""
    params, xs, h0, c0, _, _ = make(3)
    tp = [{k: torch.tensor(v, requires_grad=(k == "w_hh")) for k, v in p.items()} for p in params]
    txs, th0, tc0 = (torch.from_numpy(a) for a in (xs, h0, c0))
    outs, (h_t, c_t) = lstm_seq_diff(tp, txs, (th0, tc0))
    assert outs.requires_grad and h_t.requires_grad
    w_hh = [p["w_hh"] for p in tp]
    grads = torch.autograd.grad(c_t.sum(), w_hh)  # outs and hT unused
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    _, vjp = jax.vjp(jlstm.lstm_seq, jp, jnp.asarray(xs), (jnp.asarray(h0), jnp.asarray(c0)))
    j_p, _, _ = vjp((jnp.zeros((T, B, H)), (jnp.zeros((L, B, H)), jnp.ones((L, B, H)))))
    for g, j in zip(grads, j_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(j["w_hh"]), atol=1e-4, rtol=0)
        assert float(g.abs().max()) > 0
    assert all(p["w_ih"].grad is None and p["b"].grad is None for p in tp)


def test_cpu_routing_takes_the_plain_version_with_grad():
    params, xs, h0, c0, g_out, g_h = make(4)
    calls = LstmSeqDiff.calls
    obj, grads = torch_objective(tlstm.lstm_seq, params, xs, h0, c0, g_out, g_h)
    ref_obj, ref_grads = torch_objective(lstm_seq_plain, params, xs, h0, c0, g_out, g_h)
    assert LstmSeqDiff.calls == calls  # B2 is for CUDA tensors only
    assert torch.equal(obj, ref_obj) and all(torch.equal(g, r) for g, r in zip(grads, ref_grads))


def test_forward_gives_gradients_to_trunk_and_lstm():
    cfg = tnet.NetConfig(in_dim=24, hid_dim=H, out_dim=7, num_lstm_layer=L, hand_size=2)
    params = tnet.init_r2d2_net(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    leaves = {
        "trunk": params.net[0]["w"], "lstm0": params.lstm[0]["w_ih"], "lstm1": params.lstm[1]["w_hh"],
        "fc_a": params.fc_a["w"], "fc_v": params.fc_v["w"],
    }
    for t in leaves.values():
        t.requires_grad_(True)
    rng = np.random.RandomState(5)
    priv_s = torch.from_numpy((rng.rand(T, B, 24) < 0.3).astype(np.float32))
    legal = torch.ones(T, B, 7)
    action = torch.from_numpy(rng.randint(0, 7, (T, B)))
    qa, greedy, q, o = tnet.forward(params, cfg, priv_s, legal, action)
    grads = torch.autograd.grad(qa.sum(), list(leaves.values()))
    for name, g in zip(leaves, grads):
        assert float(g.abs().max()) > 0, name
    assert not greedy.requires_grad and q.shape == (T, B, 7) and o.shape == (T, B, H)
