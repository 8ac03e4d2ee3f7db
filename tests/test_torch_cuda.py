"""Tests of the port that need a CUDA card (marker `cuda`); they skip without
one. This file imports neither jax nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentParams, clone_params
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.state import shuffled_decks
from hanabi_sad_tpu_torch.models import lstm as tlstm
from hanabi_sad_tpu_torch.models import r2d2_net as tnet
from hanabi_sad_tpu_torch.ops import gather_unpack as gu
from hanabi_sad_tpu_torch.ops.lstm_seq import (
    LstmSeqDiff, lstm_bwd_kernel, lstm_seq_diff, lstm_seq_kernel, lstm_seq_plain)
from hanabi_sad_tpu_torch.replay import prioritized as trep
from hanabi_sad_tpu_torch.tools import loaders
from hanabi_sad_tpu_torch.train import learner, selfplay
from hanabi_sad_tpu_torch.train.config import make_config
from hanabi_sad_tpu_torch.train.evaluate import evaluate
from hanabi_sad_tpu_torch.train.optim import AdamState

FLAGSHIP = str(Path(__file__).resolve().parents[1] / "docs/runs/sad_aux_r4_soup10.pkl")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def lstm_inputs(T, B, H, L, seed, device):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(H)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    params = [
        {
            "w_ih": as_t(rng.uniform(-k, k, (H, 4 * H))),
            "w_hh": as_t(rng.uniform(-k, k, (H, 4 * H))),
            "b": as_t(rng.uniform(-2 * k, 2 * k, (4 * H,))),
        }
        for _ in range(L)
    ]
    return params, as_t(rng.randn(T, B, H)), as_t(0.5 * rng.randn(L, B, H)), as_t(0.5 * rng.randn(L, B, H))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(1, 1000), (80, 128), (1, 13)])
def test_kernel_matches_plain_on_card(card, T, B):
    """B1 against its plain version at the eval shape, the learner shape and a
    ragged batch, H=512, L=2. Tolerance 1e-4: float32 sums in another order
    over K = 1024, state bounded by tanh."""
    params, xs, h0, c0 = lstm_inputs(T, B, 512, 2, seed=5, device=card)
    launches = lstm_seq_kernel.launches
    out, (h, c) = tlstm.lstm_seq(params, xs, (h0, c0))
    ref, (rh, rc) = lstm_seq_plain(params, xs, (h0, c0))
    torch.cuda.synchronize()
    assert lstm_seq_kernel.launches == launches + (len(params) if T == 1 else 2 * len(params))
    for a, b in ((out, ref), (h, rh), (c, rc)):
        assert float((a - b).detach().abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    params, xs, h0, c0 = lstm_inputs(1, 4, 512, 2, seed=6, device=card)
    with pytest.raises(ValueError, match="float32"):
        lstm_seq_kernel(params, xs.double(), (h0, c0))
    strided = torch.empty(1, 512, 4, device=card).transpose(1, 2)  # [1, 4, 512], not contiguous
    strided.copy_(xs)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_seq_kernel(params, strided, (h0, c0))
    with pytest.raises(ValueError, match="hidden"):
        lstm_seq_kernel(params, xs, (h0[:1], c0[:1]))
    narrow = [{k: v[..., :-4] if k != "b" else v for k, v in p.items()} for p in params]
    with pytest.raises(ValueError):
        lstm_seq_kernel([{k: v.contiguous() for k, v in p.items()} for p in narrow], xs, (h0, c0))


@pytest.mark.cuda
def test_eval_on_card_matches_cpu(card):
    """The same 16 decks through B1 on the card and the plain LSTM on the CPU:
    the per-game scores agree."""
    decks = shuffled_decks(GameConfig(players=2), 16, torch.Generator().manual_seed(5))
    cpu_pol = loaders.load_native_checkpoint(FLAGSHIP, device="cpu")
    card_pol = loaders.load_native_checkpoint(FLAGSHIP, device=card)
    _, _, cpu_scores, _ = evaluate([cpu_pol, cpu_pol], 16, seed=0, decks=decks, device="cpu")
    launches = lstm_seq_kernel.launches
    _, _, card_scores, _ = evaluate([card_pol, card_pol], 16, seed=0, decks=decks, device=card)
    assert lstm_seq_kernel.launches > launches
    assert card_scores == cpu_scores


@pytest.mark.cuda
def test_gather_unpack_kernel_equals_plain_on_card(card):
    """B3 at the flagship episode shape [80, 2, 110], duplicate and
    out-of-range indices: exactly equal (0/1 floats)."""
    gen = torch.Generator().manual_seed(0)
    packed = torch.randint(0, 256, (300, 80, 2, 110), dtype=torch.uint8, generator=gen).to(card)
    for idx in ([5, 299, 5, 0, 17, 17, -1, 300], list(range(64))):
        i = torch.tensor(idx, device=card)
        launches = gu.gather_unpack_kernel.launches
        out = gu.gather_unpack(packed, i)
        ref = gu.gather_unpack_plain(packed, i)
        torch.cuda.synchronize()
        assert gu.gather_unpack_kernel.launches == launches + 1
        assert out.shape == (len(idx), 80, 2, 880) and torch.equal(out, ref)
    with pytest.raises(ValueError, match="int64"):
        gu.gather_unpack_kernel(packed, i.int())
    with pytest.raises(ValueError, match="uint8"):
        gu.gather_unpack_kernel(packed.float(), i)
    with pytest.raises(ValueError, match="CUDA"):
        gu.gather_unpack_kernel(packed, i.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(3, 1000), (5, 13)])
def test_b1_recurrence_over_many_or_ragged_rows_on_card(card, T, B):
    """B = 1000 is more row tiles than fit on the card at once (each block
    takes several a step); B = 13 is one ragged tile."""
    params, xs, h0, c0 = lstm_inputs(T, B, 512, 2, seed=8, device=card)
    out, (h, c) = lstm_seq_kernel(params, xs, (h0, c0))
    ref, (rh, rc) = lstm_seq_plain(params, xs, (h0, c0))
    torch.cuda.synchronize()
    for a, b in ((out, ref), (h, rh), (c, rc)):
        assert float((a - b).abs().max()) <= 1e-4


def flagship_lstm(card):
    return loaders.load_native_checkpoint(FLAGSHIP, device=card).params.online.lstm


def f64_gaps(params, seed, card):
    """For one input at [80, 128, 512]: the largest distance of B1's, B2's
    and the plain float32 version's outputs to float64, and of B2's and plain
    float32 autograd's grads to float64 autograd, each grad relative to its
    largest float64 value. Also whether B2's forward equals B1's."""
    rng = np.random.RandomState(seed)
    L, (T, B, H) = len(params), (80, 128, 512)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    xs, h0, c0 = as_t(rng.randn(T, B, H)), as_t(0.5 * rng.randn(L, B, H)), as_t(0.5 * rng.randn(L, B, H))
    cot = [as_t(rng.randn(T, B, H)), as_t(rng.randn(L, B, H)), as_t(rng.randn(L, B, H))]

    def run(fn, dtype):
        ps = [{k: v.to(dtype).clone().requires_grad_(True) for k, v in p.items()} for p in params]
        ts = [t.to(dtype).clone().requires_grad_(True) for t in (xs, h0, c0)]
        outs, (h, c) = fn(ps, ts[0], (ts[1], ts[2]))
        leaves = ts + [p[k] for p in ps for k in ("w_ih", "w_hh", "b")]
        grads = torch.autograd.grad((outs, h, c), leaves, [g.to(dtype) for g in cot])
        return [y.detach() for y in (outs, h, c)], grads

    with torch.no_grad():
        b1 = lstm_seq_kernel(params, xs, (h0, c0))
        b1 = [b1[0], *b1[1]]
    b2_y, b2_g = run(lstm_seq_diff, torch.float32)
    p_y, p_g = run(lstm_seq_plain, torch.float32)
    r_y, r_g = run(lstm_seq_plain, torch.float64)
    gap = lambda a, r: float((a.double() - r).abs().max())
    rel = lambda a, r: gap(a, r) / float(r.abs().max())
    return {
        "B1": [gap(a, r) for a, r in zip(b1, r_y)], "B2": [gap(a, r) for a, r in zip(b2_y, r_y)],
        "plain": [gap(a, r) for a, r in zip(p_y, r_y)],
        "B2_grad": [rel(a, r) for a, r in zip(b2_g, r_g)], "plain_grad": [rel(a, r) for a, r in zip(p_g, r_g)],
        "b2_is_b1": all(torch.equal(a, b) for a, b in zip(b2_y, b1)),
    }


@pytest.mark.cuda
def test_b1_and_b2_against_float64_on_card(card):
    """At the learner shape on the flagship's LSTM weights, over 8 inputs:
    the largest distance to float64 of B1's outputs (over outs, hT and cT),
    of B2's outputs, and of each of B2's grads is at most twice the plain
    float32 version's (plain autograd's for the grads). Rounding amplified
    over 80 steps depends on the input, so the bound is relative to the plain
    version's own distance, not absolute."""
    params = flagship_lstm(card)
    worst = {}
    for seed in range(8):
        reading = f64_gaps(params, seed, card)
        assert reading.pop("b2_is_b1")
        for k, v in reading.items():
            worst[k] = np.maximum(worst.get(k, 0.0), v)
    for who in ("B1", "B2"):
        assert worst[who].max() <= 2.0 * worst["plain"].max(), (who, worst[who], worst["plain"])
    assert np.all(worst["B2_grad"] <= 2.0 * worst["plain_grad"]), worst["B2_grad"] / worst["plain_grad"]


@pytest.mark.cuda
def test_b1_and_b2_give_the_same_bits_twice_on_card(card):
    params, xs, h0, c0 = lstm_inputs(80, 128, 512, 2, seed=9, device=card)
    for T in (1, 80):
        a = lstm_seq_kernel(params, xs[:T], (h0, c0))
        b = lstm_seq_kernel(params, xs[:T], (h0, c0))
        assert all(torch.equal(x, y) for x, y in zip((a[0], *a[1]), (b[0], *b[1])))

    def grads():
        ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params]
        ts = [t.clone().requires_grad_(True) for t in (xs, h0, c0)]
        outs, (h, c) = lstm_seq_diff(ps, ts[0], (ts[1], ts[2]))
        leaves = ts + [p[k] for p in ps for k in ("w_ih", "w_hh", "b")]
        return torch.autograd.grad((outs ** 2).sum() + h.sum() + c.sum(), leaves)

    assert all(torch.equal(x, y) for x, y in zip(grads(), grads()))


@pytest.mark.cuda
def test_gather_unpack_kernel_indexes_like_jax_on_card(card):
    """Indices in [-cap, -1] count from the end, the rest is clamped: the
    rows JAX's `packed[idx]` reads."""
    gen = torch.Generator().manual_seed(1)
    cap = 50
    packed = torch.randint(0, 256, (cap, 80, 2, 110), dtype=torch.uint8, generator=gen).to(card)
    idx = torch.tensor([-cap - 2, -cap, -1, 0, cap - 1, cap, cap + 3], device=card)
    rows = torch.tensor([0, 0, cap - 1, 0, cap - 1, cap - 1, cap - 1], device=card)
    out = gu.gather_unpack_kernel(packed, idx)
    assert torch.equal(out, gu.gather_unpack_plain(packed, idx))
    assert torch.equal(out, gu.gather_unpack_plain(packed, rows))


@pytest.mark.cuda
def test_b2_one_step_on_card(card):
    """B2 at T = 1 keeps its gates through the gates kernel's epilogue (not
    the recurrence): outputs and grads against plain autograd, ragged B."""
    params, xs, h0, c0 = lstm_inputs(1, 13, 512, 2, seed=10, device=card)

    def run(fn):
        ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params]
        ts = [t.clone().requires_grad_(True) for t in (xs, h0, c0)]
        outs, (h, c) = fn(ps, ts[0], (ts[1], ts[2]))
        leaves = ts + [p[k] for p in ps for k in ("w_ih", "w_hh", "b")]
        return (outs, h, c), torch.autograd.grad((outs ** 2).sum() + h.sum() + (c ** 2).sum(), leaves)

    bwd = lstm_bwd_kernel.launches
    ys, grads = run(lstm_seq_diff)
    ref_ys, ref_grads = run(lstm_seq_plain)
    torch.cuda.synchronize()
    assert lstm_bwd_kernel.launches == bwd + 2
    for a, b in zip(ys, ref_ys):
        assert float((a - b).detach().abs().max()) <= 1e-5
    for g, r in zip(grads, ref_grads):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.cuda
def test_b2_grads_equal_plain_autograd_on_card(card):
    """B2 (B1's forward keeping its gates, the backward kernel) against
    autograd of the plain version: outputs within 1e-4 (B1's summation order
    over 6 steps), grads within 1e-4 of the largest reference grad."""
    params, xs, h0, c0 = lstm_inputs(6, 24, 512, 2, seed=7, device=card)

    def run(fn):
        ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params]
        ts = [t.clone().requires_grad_(True) for t in (xs, h0, c0)]
        outs, (h, c) = fn(ps, ts[0], (ts[1], ts[2]))
        leaves = ts + [p[k] for p in ps for k in ("w_ih", "w_hh", "b")]
        return (outs, h), torch.autograd.grad((outs ** 2).sum() + h.sum(), leaves)

    calls = LstmSeqDiff.calls
    ys, grads = run(lstm_seq_diff)
    ref_ys, ref_grads = run(lstm_seq_plain)
    torch.cuda.synchronize()
    assert LstmSeqDiff.calls == calls + 1
    for a, b in zip(ys, ref_ys):
        assert float((a - b).detach().abs().max()) <= 1e-4
    for g, r in zip(grads, ref_grads):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.cuda
def test_forward_gives_trunk_and_lstm_gradients_on_card(card):
    """The learner's loss reaches the trunk and the LSTM through B2 on the
    card (before B2, the kernel's outputs had no grad_fn there)."""
    cfg = tnet.NetConfig(in_dim=838, hid_dim=64)
    params = tnet.init_r2d2_net(cfg, generator=torch.Generator().manual_seed(0), device=card)
    leaves = [params.net[0]["w"], params.lstm[0]["w_ih"], params.lstm[1]["w_hh"], params.lstm[0]["b"]]
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.RandomState(1)
    priv_s = torch.from_numpy((rng.rand(10, 6, 838) < 0.1).astype(np.float32)).to(card)
    legal = torch.ones(10, 6, 21, device=card)
    action = torch.from_numpy(rng.randint(0, 21, (10, 6))).to(card)
    calls, launches, bwd = LstmSeqDiff.calls, lstm_seq_kernel.launches, lstm_bwd_kernel.launches
    qa, _, _, _ = tnet.forward(params, cfg, priv_s, legal, action)
    grads = torch.autograd.grad(qa.sum(), leaves)
    # T = 10: per layer the input projection and one persistent recurrence,
    # then one backward launch per layer
    assert LstmSeqDiff.calls == calls + 1 and lstm_seq_kernel.launches == launches + 2 * 2
    assert lstm_bwd_kernel.launches == bwd + 2
    assert all(float(g.abs().max()) > 0 for g in grads)


def small_trainer(card, **kw):
    cfg = make_config("sad_2p", pred_weight=0.25, num_envs=32, batchsize=16, burn_in_frames=64,
                      replay_buffer_size=256, max_len=24, rnn_hid_dim=64, num_update_per_chunk=2, **kw)
    setup = learner.make_setup(cfg)
    return setup, learner.init_train_state(setup, 0, card)


@pytest.mark.cuda
def test_sgd_update_through_kernels_equals_plain_on_card(card, monkeypatch):
    setup, state = small_trainer(card)
    state, _ = learner.collect_only(setup, state)
    idx, is_w = trep.sample_indices(state.replay, setup.replay, setup.train.batchsize,
                                    generator=torch.Generator(device=card).manual_seed(0))
    rows = trep.gather_rows(state.replay, idx)
    optimizer = learner.make_optimizer(setup.train)

    def fresh_copy():
        return state._replace(
            params=AgentParams(clone_params(state.params.online), clone_params(state.params.target)),
            opt_state=AdamState([m.clone() for m in state.opt_state.mu],
                                [v.clone() for v in state.opt_state.nu], state.opt_state.count),
            replay=state.replay._replace(weight=state.replay.weight.clone()),
        )

    counts = (lstm_seq_kernel.launches, LstmSeqDiff.calls, gu.gather_unpack_kernel.launches)
    s_k, m_k = learner.sgd_update(setup, optimizer, fresh_copy(), presampled=(rows, is_w, idx))
    assert lstm_seq_kernel.launches > counts[0] and LstmSeqDiff.calls == counts[1] + 1
    assert gu.gather_unpack_kernel.launches == counts[2] + 1
    monkeypatch.setattr(tlstm, "lstm_seq", lstm_seq_plain)
    monkeypatch.setattr(gu, "gather_unpack", gu.gather_unpack_plain)
    s_p, m_p = learner.sgd_update(setup, optimizer, fresh_copy(), presampled=(rows, is_w, idx))
    for k in ("loss", "grad_norm", "rl_loss", "aux1"):
        assert abs(float(m_k[k]) - float(m_p[k])) <= 1e-4 * abs(float(m_p[k])), k
    assert float((s_k.replay.weight - s_p.replay.weight).abs().max()) <= 1e-4
    # one Adam step moves a param by at most lr / eps = 4.2 times its grad's gap
    for a, b in zip(learner.param_leaves(s_k.params.online), learner.param_leaves(s_p.params.online)):
        assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_selfplay_trains_on_card(card):
    cfg = make_config("sad_2p", pred_weight=0.25, num_envs=32, batchsize=16, burn_in_frames=64,
                      replay_buffer_size=256, max_len=24, rnn_hid_dim=64, num_update_per_chunk=2,
                      epoch_len=2, num_epoch=2, num_eval_game=16, num_eps=4)
    launches = gu.gather_unpack_kernel.launches
    out = selfplay.train(cfg, max_chunks=2, device=card)
    assert out["num_update"] == 4 and np.isfinite(out["metrics"]["loss"])
    assert gu.gather_unpack_kernel.launches == launches + 4
