"""bfloat16 compute in the port against the JAX package's, on the CPU.

The port takes `pallas_lstm.py`'s bfloat16 semantics for the LSTM (products
of bfloat16 values summed in float32, the cell in float32, h and c rounded to
bfloat16 at every step); the JAX package's production LSTM, `lax.scan` over
`models/lstm.py:_cell`, also rounds the gate sums to bfloat16. So the port's
LSTM is held against the Pallas kernel (interpret mode) within 2 bfloat16
ulps, and the net against the JAX net at the bounds of `tests/test_bf16.py`
(q within 0.1, greedy agreement above 0.9). Inputs are made with numpy from a
seed: T=12, B=8, H=32, L=2. Each tolerance is stated at its test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.models import lstm as jlstm
from hanabi_sad_tpu.models import r2d2_net as jnet
from hanabi_sad_tpu.ops.experimental import pallas_lstm
from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu.train import learner as jlearner
from hanabi_sad_tpu_torch.models import r2d2_net as tnet
from hanabi_sad_tpu_torch.ops.lstm_seq import LstmSeqDiff, lstm_seq_diff, lstm_seq_plain
from hanabi_sad_tpu_torch.train import checkpoint as ckpt
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train import selfplay
from hanabi_sad_tpu_torch.train.checkpoint import from_jax_params
from test_torch_learner import fill_replays
from torch_parity import jax_net, np_net, torch_net

T, B, H, L = 12, 8, 32, 2
BF = jnp.bfloat16


def lstm_case(seed):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(H)
    params = [{"w_ih": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
               "w_hh": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
               "b": rng.uniform(-2 * k, 2 * k, (4 * H,)).astype(np.float32)} for _ in range(L)]
    xs = rng.randn(T, B, H).astype(np.float32)
    h0 = (0.5 * rng.randn(L, B, H)).astype(np.float32)
    c0 = (0.5 * rng.randn(L, B, H)).astype(np.float32)
    cot = [rng.randn(T, B, H).astype(np.float32), rng.randn(L, B, H).astype(np.float32),
           rng.randn(L, B, H).astype(np.float32)]
    return params, xs, h0, c0, cot


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def as_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def jax_inputs(params, xs, h0, c0):
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    return jp, jnp.asarray(xs).astype(BF), (jnp.asarray(h0).astype(BF), jnp.asarray(c0).astype(BF))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_bf16_lstm_matches_pallas_interpret(seed):
    """The plain bf16 LSTM against `lstm_seq_pallas(interpret=True)` on the
    same bfloat16 inputs: every output within 2 bfloat16 ulps of Pallas's at
    the scale of that output (its largest value): float32 sums in another
    order can move a rounding by one ulp, and the next steps carry that
    absolute error into smaller elements. Against the JAX scan, which also rounds the gate sums
    to bfloat16, within 0.03 (a probe of the two JAX versions put their gap
    at 3e-3)."""
    params, xs, h0, c0, _ = lstm_case(seed)
    jp, jxs, jhid = jax_inputs(params, xs, h0, c0)
    j_out, (j_h, j_c) = pallas_lstm.lstm_seq_pallas(jp, jxs, jhid, block_b=B, interpret=True)
    s_out, (s_h, s_c) = jlstm.lstm_seq(jp, jxs, jhid)
    tp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]
    t_out, (t_h, t_c) = lstm_seq_plain(tp, torch.from_numpy(xs).bfloat16(),
                                       (torch.from_numpy(h0).bfloat16(), torch.from_numpy(c0).bfloat16()))
    assert t_out.dtype == t_h.dtype == t_c.dtype == torch.bfloat16
    for name, t, j, s in (("outs", t_out, j_out, s_out), ("hT", t_h, j_h, s_h), ("cT", t_c, j_c, s_c)):
        t, j, s = t.float().numpy(), as_np(j), as_np(s)
        assert np.abs(t - j).max() <= 2 * bf16_ulp(np.abs(j).max()), (name, np.abs(t - j).max())
        assert np.abs(t - s).max() <= 0.03, (name, np.abs(t - s).max())


def test_plain_lstm_keeps_its_float32_bits():
    """For float32 inputs the plain version computes what it computed before
    it took bfloat16: the same formula, bit for bit."""
    params, xs, h0, c0, _ = lstm_case(3)
    tp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]
    x, h, c = torch.from_numpy(xs), list(torch.from_numpy(h0)), list(torch.from_numpy(c0))
    outs = []
    for xt in x:
        for layer, p in enumerate(tp):
            gates = xt @ p["w_ih"] + h[layer] @ p["w_hh"] + p["b"]
            i, f, g, o = gates.chunk(4, dim=-1)
            c[layer] = torch.sigmoid(f) * c[layer] + torch.sigmoid(i) * torch.tanh(g)
            h[layer] = torch.sigmoid(o) * torch.tanh(c[layer])
            xt = h[layer]
        outs.append(xt)
    t_out, (t_h, t_c) = lstm_seq_plain(tp, x, (torch.from_numpy(h0), torch.from_numpy(c0)))
    assert torch.equal(t_out, torch.stack(outs))
    assert torch.equal(t_h, torch.stack(h)) and torch.equal(t_c, torch.stack(c))


@pytest.mark.parametrize("seed", [0, 1])
def test_b2_bf16_grads_match_jax_vjp_of_pallas_diff(seed, monkeypatch):
    """B2 (`lstm_seq_diff`, its float32 backward over the saved gates) on
    bfloat16 copies of float32 weights, against `jax.vjp` of
    `lstm_seq_pallas_diff` in bfloat16 (forward in interpret mode, backward
    the scan's VJP, every grad rounded to bfloat16 as it goes): each grad
    within 3% of that grad's largest value (1.4% at most in seeds 10-11),
    the outputs within 2 ulps at
    their scale (as `test_plain_bf16_lstm_matches_pallas_interpret`). The
    grads come back in the inputs' dtypes (bfloat16 for xs, h0, c0; float32
    for the params, through autograd of the casts)."""
    orig = pallas_lstm.lstm_seq_pallas
    monkeypatch.setattr(pallas_lstm, "lstm_seq_pallas",
                        lambda p, x, h, block_b=256: orig(p, x, h, block_b=B, interpret=True))
    params, xs, h0, c0, cot = lstm_case(10 + seed)
    jp, jxs, (jh0, jc0) = jax_inputs(params, xs, h0, c0)
    (j_out, (j_h, j_c)), vjp = jax.vjp(lambda p, x, h, c: pallas_lstm.lstm_seq_pallas_diff(p, x, (h, c)),
                                      jp, jxs, jh0, jc0)
    g_p, g_x, g_h0, g_c0 = vjp(tuple(jnp.asarray(g).astype(BF) for g in cot[:1]) + (
        (jnp.asarray(cot[1]).astype(BF), jnp.asarray(cot[2]).astype(BF)),))
    j_grads = [g_x, g_h0, g_c0] + [p[k] for p in g_p for k in ("w_ih", "w_hh", "b")]

    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in params]
    ts = [torch.tensor(a).bfloat16().requires_grad_(True) for a in (xs, h0, c0)]
    calls = LstmSeqDiff.calls
    outs, (h_t, c_t) = lstm_seq_diff([{k: v.bfloat16() for k, v in p.items()} for p in tp], ts[0], (ts[1], ts[2]))
    assert LstmSeqDiff.calls == calls + 1
    leaves = ts + [p[k] for p in tp for k in ("w_ih", "w_hh", "b")]
    grads = torch.autograd.grad((outs, h_t, c_t), leaves, [torch.from_numpy(g).bfloat16() for g in cot])
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32] * 3 * L
    for t, j in ((outs, j_out), (h_t, j_h), (c_t, j_c)):
        j = as_np(j)
        assert np.abs(t.detach().float().numpy() - j).max() <= 2 * bf16_ulp(np.abs(j).max())
    for i, (g, j) in enumerate(zip(grads, j_grads)):
        g, j = g.float().numpy(), as_np(j)
        assert np.abs(g - j).max() <= 0.03 * np.abs(j).max(), (i, np.abs(g - j).max() / np.abs(j).max())


def test_b2_bf16_backward_is_float32_autograd_of_the_plain_forward():
    """B2's bf16 backward is the float32 derivative of the function its
    forward computed: against float64 autograd of the plain bf16 forward's
    own steps (the same rounded h and c fed in), every grad of the float32
    params within 4e-3 of its largest value: the grads of the bfloat16
    weight copies are rounded to bfloat16 (2^-9 relative) before autograd
    of the casts makes them float32, plus float32 sums."""
    params, xs, h0, c0, cot = lstm_case(20)
    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in params]
    ts = [torch.tensor(a).bfloat16().requires_grad_(True) for a in (xs, h0, c0)]
    outs, (h_t, c_t) = lstm_seq_diff([{k: v.bfloat16() for k, v in p.items()} for p in tp], ts[0], (ts[1], ts[2]))
    leaves = [p[k] for p in tp for k in ("w_ih", "w_hh", "b")]
    grads = torch.autograd.grad((outs, h_t, c_t), leaves, [torch.from_numpy(g).bfloat16() for g in cot])

    # float64 reference: the same cell on the rounded values, no rounding in
    # the derivative (straight-through for the roundings of h and c).
    p64 = [{k: torch.tensor(v).bfloat16().double().requires_grad_(True) for k, v in p.items()} for p in params]
    rnd = lambda t: t + (t.bfloat16().double() - t).detach()
    h = [rnd(t) for t in torch.tensor(h0, dtype=torch.float64)]
    c = [rnd(t) for t in torch.tensor(c0, dtype=torch.float64)]
    ys = []
    for xt in torch.tensor(xs).bfloat16().double():
        for layer, p in enumerate(p64):
            gates = xt @ p["w_ih"] + h[layer] @ p["w_hh"] + p["b"]
            i, f, g, o = gates.chunk(4, dim=-1)
            c[layer] = rnd(torch.sigmoid(f) * c[layer] + torch.sigmoid(i) * torch.tanh(g))
            h[layer] = rnd(torch.sigmoid(o) * torch.tanh(c[layer]))
            xt = h[layer]
        ys.append(xt)
    ref = torch.autograd.grad((torch.stack(ys), torch.stack(h), torch.stack(c)),
                              [p[k] for p in p64 for k in ("w_ih", "w_hh", "b")],
                              [torch.from_numpy(g).bfloat16().double() for g in cot])
    for g, r in zip(grads, ref):
        assert float((g.double() - r).abs().max()) <= 4e-3 * float(r.abs().max())


def net_case(seed, in_dim=40, out_dim=11, hand=2):
    rng = np.random.RandomState(seed)
    p = np_net(in_dim, H, out_dim, hand, L, seed)
    priv = (rng.rand(T, B, in_dim) < 0.3).astype(np.float32)
    legal = (rng.rand(T, B, out_dim) < 0.5).astype(np.float32)
    legal[..., -1] = 1.0
    action = rng.randint(0, out_dim, (T, B)).astype(np.int32)
    cfg = dict(in_dim=in_dim, hid_dim=H, out_dim=out_dim, num_lstm_layer=L, hand_size=hand,
               compute_dtype="bfloat16")
    return p, priv, legal, action, cfg


@pytest.mark.parametrize("seed", [0, 1])
def test_net_forward_and_act_bf16_match_jax(seed):
    """The net in bfloat16 against the JAX net in bfloat16 (its scan path):
    q within 0.1 and greedy agreement above 0.9 (tests/test_bf16.py's bounds
    between bf16 and f32); q, the LSTM output and the advantage are float32,
    and `act` carries a float32 hidden."""
    p, priv, legal, action, cfg = net_case(seed)
    jcfg, tcfg = jnet.NetConfig(**cfg), tnet.NetConfig(**cfg)
    assert tcfg.cdtype == torch.bfloat16
    _, jg, jq, jo = jnet.forward(jax_net(p), jcfg, jnp.asarray(priv), jnp.asarray(legal), jnp.asarray(action))
    _, tg, tq, to = tnet.forward(torch_net(p), tcfg, torch.from_numpy(priv), torch.from_numpy(legal),
                                 torch.from_numpy(action))
    assert tq.dtype == to.dtype == torch.float32
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=0.1, rtol=0)
    assert (tg.numpy() == np.asarray(jg)).mean() > 0.9

    hid = {"h0": np.zeros((B, L, H), np.float32), "c0": np.zeros((B, L, H), np.float32)}
    jhid = {k: jnp.asarray(v) for k, v in hid.items()}
    thid = {k: torch.from_numpy(v) for k, v in hid.items()}
    for t in range(3):
        ja, jhid = jnet.act(jax_net(p), jcfg, jnp.asarray(priv[t]), jhid)
        ta, thid = tnet.act(torch_net(p), tcfg, torch.from_numpy(priv[t]), thid)
        assert ta.dtype == thid["h0"].dtype == thid["c0"].dtype == torch.float32
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=0.1, rtol=0)
        np.testing.assert_allclose(thid["c0"].numpy(), np.asarray(jhid["c0"]), atol=0.1, rtol=0)
    a, v, hid2 = tnet.act_with_v(torch_net(p), tcfg, torch.from_numpy(priv[0]),
                                 {k: torch.from_numpy(x) for k, x in hid.items()})
    assert a.dtype == v.dtype == hid2["h0"].dtype == torch.float32


SMALL = dict(pred_weight=0.25, rnn_hid_dim=64, max_len=12, replay_buffer_size=128, batchsize=8, num_envs=4,
             compute_dtype="bfloat16")


def test_bf16_sgd_update_matches_jax():
    """One bfloat16 sgd_update (flagship preset at a small width) against the
    JAX learner's from the same params, replay and presampled batch: loss and
    grad_norm within 2% relative and the new replay weights within 0.02
    (the two LSTMs round at other places, see the module docstring); params,
    Adam moments and the target stay float32."""
    jsetup = jlearner.make_setup(jconfig.make_config("sad_2p", **SMALL))
    tsetup = tlearner.make_setup(tconfig.make_config("sad_2p", **SMALL))
    assert tsetup.agent.net.compute_dtype == "bfloat16" and tsetup.eval_agent.net.compute_dtype == "float32"
    jstate = jlearner.init_train_state(jsetup, jax.random.PRNGKey(0))
    tstate = tlearner.init_train_state(tsetup, 0, "cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate = tstate._replace(params=type(tstate.params)(
        online=from_jax_params(np_params.online, "cpu"), target=from_jax_params(np_params.target, "cpu")))
    jstate, tstate = fill_replays(jsetup, tsetup, jstate, tstate)
    idx = np.asarray([3, 3, 17, 0], np.int32)
    is_w = np.asarray([0.5, 0.5, 1.0, 0.25], np.float32)
    jopt = jlearner.make_optimizer(jsetup.train)
    jstate2, jm = jax.jit(lambda s, pre: jlearner.sgd_update(jsetup, jopt, s, presampled=pre))(
        jstate, (jrep.gather_rows(jstate.replay, jnp.asarray(idx)), jnp.asarray(is_w), jnp.asarray(idx)))
    tstate2, tm = tlearner.sgd_update(
        tsetup, tlearner.make_optimizer(tsetup.train), tstate,
        presampled=(torch.from_numpy(is_w), torch.from_numpy(idx).long()))
    for k in ("loss", "grad_norm", "rl_loss", "aux1"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0.02, err_msg=k)
    np.testing.assert_allclose(tstate2.replay.weight.numpy(), np.asarray(jstate2.replay.weight), atol=0.02, rtol=0)
    leaves = tlearner.param_leaves(tstate2.params.online) + tlearner.param_leaves(tstate2.params.target)
    assert all(t.dtype == torch.float32 for t in leaves + tstate2.opt_state.mu + tstate2.opt_state.nu)


def test_bf16_selfplay_trains_two_chunks_on_the_cpu(tmp_path):
    """`--compute_dtype bfloat16` through `selfplay.train`: two chunks, finite
    metrics, float32 params in the saved payloads."""
    cfg, device = selfplay.parse_args([
        "--preset", "sad_2p", "--pred_weight", "0.25", "--compute_dtype", "bfloat16", "--device", "cpu",
        "--num_envs", "8", "--batchsize", "8", "--burn_in_frames", "16", "--replay_buffer_size", "64",
        "--epoch_len", "4", "--num_update_per_chunk", "2", "--num_epoch", "2", "--num_eval_game", "4",
        "--max_len", "16", "--rnn_hid_dim", "32", "--num_eps", "4", "--save_dir", str(tmp_path)])
    assert cfg.compute_dtype == "bfloat16"
    out = selfplay.train(cfg, max_chunks=2, device=device)
    assert out["num_update"] == 4 and all(np.isfinite(v) for v in out["metrics"].values())
    payload = ckpt.load(str(tmp_path / "latest.pkl"))
    assert payload["config"]["compute_dtype"] == "bfloat16"
    assert payload["params"].online.lstm[0]["w_hh"].dtype == np.float32
