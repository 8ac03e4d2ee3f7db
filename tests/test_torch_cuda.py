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
from hanabi_sad_tpu_torch.ops import sample_batch as sb
from hanabi_sad_tpu_torch.ops.lstm_seq import (
    LstmSeqDiff, lstm_bwd_kernel, lstm_bwd_recurrence_plain, lstm_seq_diff, lstm_seq_kernel, lstm_seq_plain)
from hanabi_sad_tpu_torch.replay import prioritized as trep
from hanabi_sad_tpu_torch.tools import loaders
from hanabi_sad_tpu_torch.train import learner, selfplay
from hanabi_sad_tpu_torch.train.config import make_config
from hanabi_sad_tpu_torch.train.evaluate import evaluate

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


FLAGSHIP_SIZES = dict(obs_dim=838, num_actions=21, hand_size=5)


def replay_fields(cap, T, Pi, NB, seed, device):
    """Random replay fields: packed bytes, actions, rewards, bootstraps and
    lengths in [1, T]."""
    gen = torch.Generator().manual_seed(seed)
    fields = (
        torch.randint(0, 256, (cap, T, Pi, NB), dtype=torch.uint8, generator=gen),
        torch.randint(0, 21, (cap, T, Pi), generator=gen),
        torch.randn(cap, T, generator=gen),
        torch.rand(cap, T, generator=gen),
        torch.randint(1, T + 1, (cap,), generator=gen).float(),
    )
    return tuple(t.to(device) for t in fields)


def assert_same_batch(out, ref):
    for name, a, b in zip(out._fields, out, ref):
        assert a.is_contiguous(), name
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.cuda
def test_sample_batch_kernel_equals_plain_on_card(card):
    """B3 at the flagship episode shape [80, 2, 110], duplicate and
    out-of-range indices, a batch that is no multiple of the kernel's 4
    entries a block: every field exactly equal and contiguous."""
    fields = replay_fields(300, 80, 2, 110, seed=0, device=card)
    for idx in ([5, 299, 5, 0, 17, 17, -1, 300], list(range(64)), [7, 3, 250, 9, 9, 1, 0]):
        i = torch.tensor(idx, device=card)
        launches = sb.sample_batch_kernel.launches
        out = sb.sample_batch(*fields, i, **FLAGSHIP_SIZES)
        ref = sb.sample_batch_plain(*fields, i, **FLAGSHIP_SIZES)
        torch.cuda.synchronize()
        assert sb.sample_batch_kernel.launches == launches + 1
        assert out.priv_s.shape == (80, len(idx), 2, 838)
        assert_same_batch(out, ref)
    with pytest.raises(ValueError, match="int64"):
        sb.sample_batch_kernel(*fields, i.int(), **FLAGSHIP_SIZES)
    with pytest.raises(ValueError, match="uint8"):
        sb.sample_batch_kernel(fields[0].float(), *fields[1:], i, **FLAGSHIP_SIZES)
    with pytest.raises(ValueError, match="CUDA"):
        sb.sample_batch_kernel(*fields, i.cpu(), **FLAGSHIP_SIZES)


@pytest.mark.cuda
@pytest.mark.parametrize("T,Pi,NB,F,A,h", [(3, 1, 5, 20, 7, 3), (7, 3, 6, 29, 5, 4)])
def test_sample_batch_kernel_at_odd_shapes_on_card(card, T, Pi, NB, F, A, h):
    """Rows of a byte count that is no multiple of 4 (byte loads) and field
    widths that cut the 16-byte stores anywhere."""
    fields = replay_fields(11, T, Pi, NB, seed=T, device=card)
    sizes = dict(obs_dim=F, num_actions=A, hand_size=h)
    for idx in ([0, 10, 3, 3, -2], [4]):
        i = torch.tensor(idx, device=card)
        assert_same_batch(sb.sample_batch(*fields, i, **sizes), sb.sample_batch_plain(*fields, i, **sizes))


@pytest.mark.cuda
def test_sample_batch_kernel_indexes_like_jax_on_card(card):
    """Indices in [-cap, -1] count from the end, the rest is clamped: the
    rows JAX's `x[idx]` reads."""
    cap = 50
    fields = replay_fields(cap, 80, 2, 110, seed=1, device=card)
    idx = torch.tensor([-cap - 2, -cap, -1, 0, cap - 1, cap, cap + 3], device=card)
    rows = torch.tensor([0, 0, cap - 1, 0, cap - 1, cap - 1, cap - 1], device=card)
    out = sb.sample_batch_kernel(*fields, idx, **FLAGSHIP_SIZES)
    assert_same_batch(out, sb.sample_batch_plain(*fields, idx, **FLAGSHIP_SIZES))
    assert_same_batch(out, sb.sample_batch_plain(*fields, rows, **FLAGSHIP_SIZES))


@pytest.mark.cuda
def test_learner_reshapes_of_the_batch_are_views_on_card(card, monkeypatch):
    """td_error's [T, B * Pi, ...] reshapes of priv_s and legal_move, and
    loss's own_hand reshape, read B3's output in place."""
    setup, state = small_trainer(card)
    state, _ = learner.collect_only(setup, state)
    batch, _, _ = trep.sample(state.replay, setup.replay, setup.train.batchsize,
                              generator=torch.Generator(device=card).manual_seed(0))
    seen = {}
    forward, pred_loss = tnet.forward, tnet.pred_loss_1st

    def recording_forward(params, cfg, priv_s, legal, action):
        seen.setdefault("priv_s", priv_s.data_ptr())
        seen.setdefault("legal_move", legal.data_ptr())
        return forward(params, cfg, priv_s, legal, action)

    def recording_pred_loss(params, lstm_o, own_hand, *args):
        seen["own_hand"] = own_hand.data_ptr()
        return pred_loss(params, lstm_o, own_hand, *args)

    monkeypatch.setattr(tnet, "forward", recording_forward)
    monkeypatch.setattr(tnet, "pred_loss_1st", recording_pred_loss)
    from hanabi_sad_tpu_torch.agent import r2d2_agent

    r2d2_agent.loss(state.params, setup.agent, batch, 0.25)
    assert seen == {k: getattr(batch, k).data_ptr() for k in ("priv_s", "legal_move", "own_hand")}


@pytest.mark.cuda
def test_replay_sampling_gives_the_same_bits_twice_on_card(card):
    """The sampler's prefix sum is a fixed-order scan on the card (a 1-D
    torch.cumsum there sums in an order that changes from run to run): the
    same indices and IS weights on every call, and the prefix sum within
    float32 rounding of float64's."""
    w = torch.rand(65536, generator=torch.Generator().manual_seed(3)).to(card)
    cums = [trep.blocked_cumsum(w) for _ in range(20)]
    assert all(torch.equal(c, cums[0]) for c in cums)
    ref = torch.cumsum(w.double(), 0)
    assert float((cums[0].double() - ref).abs().max()) <= 1e-6 * float(ref[-1])
    setup, state = small_trainer(card)
    state, _ = learner.collect_only(setup, state)
    draws = [trep.sample_indices(state.replay, setup.replay, 16, generator=torch.Generator(device=card).manual_seed(0))
             for _ in range(5)]
    assert all(torch.equal(i, draws[0][0]) and torch.equal(w, draws[0][1]) for i, w in draws)


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
            opt_state=state.opt_state._replace(mu=[m.clone() for m in state.opt_state.mu],
                                               nu=[v.clone() for v in state.opt_state.nu]),
            replay=state.replay._replace(weight=state.replay.weight.clone()),
        )

    counts = (lstm_seq_kernel.launches, LstmSeqDiff.calls, sb.sample_batch_kernel.launches)
    s_k, m_k = learner.sgd_update(setup, optimizer, fresh_copy(), presampled=(rows, is_w, idx))
    assert lstm_seq_kernel.launches > counts[0] and LstmSeqDiff.calls == counts[1] + 1
    assert sb.sample_batch_kernel.launches == counts[2] + 1
    monkeypatch.setattr(tlstm, "lstm_seq", lstm_seq_plain)
    monkeypatch.setattr(sb, "sample_batch", sb.sample_batch_plain)
    s_p, m_p = learner.sgd_update(setup, optimizer, fresh_copy(), presampled=(rows, is_w, idx))
    for k in ("loss", "grad_norm", "rl_loss", "aux1"):
        assert abs(float(m_k[k]) - float(m_p[k])) <= 1e-4 * abs(float(m_p[k])), k
    assert float((s_k.replay.weight - s_p.replay.weight).abs().max()) <= 1e-4
    # one Adam step moves a param by at most lr / eps = 4.2 times its grad's gap
    for a, b in zip(learner.param_leaves(s_k.params.online), learner.param_leaves(s_p.params.online)):
        assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_selfplay_trains_on_card(card, tmp_path):
    cfg = make_config("sad_2p", pred_weight=0.25, num_envs=32, batchsize=16, burn_in_frames=64,
                      replay_buffer_size=256, max_len=24, rnn_hid_dim=64, num_update_per_chunk=2,
                      epoch_len=2, num_epoch=2, num_eval_game=16, num_eps=4, save_dir=str(tmp_path))
    launches = sb.sample_batch_kernel.launches
    out = selfplay.train(cfg, max_chunks=2, device=card)
    assert out["num_update"] == 4 and np.isfinite(out["metrics"]["loss"])
    assert sb.sample_batch_kernel.launches == launches + 4


# --- bfloat16 (B1 and B2's bf16 entry points) and IQL ----------------------

IQL_3P = str(Path(__file__).resolve().parents[1] / "docs/runs/iql_3p_r5_model4.pkl")


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(1, 2048), (1, 3072), (1, 13), (1, 1000)])
def test_b1_bf16_matches_plain_at_one_step_on_card(card, T, B):
    """B1's bf16 entry points at the rollout shapes (2 and 3 players) and
    batches that are no multiple of the 32-row tiles (13, the eval's 1000)
    against the plain bf16 version: every output within 1
    bfloat16 ulp at its scale (one rounding of float32 sums taken in another
    order), through `models/lstm.py` from float32 weights and hidden, whose
    dtype the result keeps."""
    params, xs, h0, c0 = lstm_inputs(T, B, 512, 2, seed=11, device=card)
    xs = xs.bfloat16()
    launches = dict(lstm_seq_kernel.launches_by_dtype)
    out, (h, c) = tlstm.lstm_seq(params, xs, (h0, c0))
    ref, (rh, rc) = lstm_seq_plain(params, xs, (h0, c0))
    torch.cuda.synchronize()
    assert lstm_seq_kernel.launches_by_dtype["bf16"] == launches["bf16"] + 2
    assert lstm_seq_kernel.launches_by_dtype["f32"] == launches["f32"]
    assert out.dtype == torch.bfloat16 and h.dtype == c.dtype == torch.float32
    for a, b in ((out, ref), (h, rh), (c, rc)):
        assert float((a.float() - b.float()).abs().max()) <= bf16_ulp(float(b.float().abs().max()))


def step_gaps(params, xs, hidden, saved):
    """Largest distance of a saved trajectory's stored activations, h and c
    from a float64 step taken from the stored previous h and c."""
    gaps = {"act": 0.0, "h": 0.0, "c": 0.0}
    x = xs
    for layer, p in enumerate(params):
        p64 = {k: v.double() for k, v in p.items()}
        hseq, cseq = saved.hseq[layer], saved.cseq[layer]
        h_prev = torch.cat([hidden[0][layer][None], hseq[:-1]]).double()
        c_prev = torch.cat([hidden[1][layer][None].to(cseq.dtype), cseq[:-1]]).double()
        i, f, g, o = (x.double() @ p64["w_ih"] + h_prev @ p64["w_hh"] + p64["b"]).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c_prev + i * g
        for name, stored, ref in (("act", saved.act[layer], torch.cat([i, f, g, o], dim=-1)),
                                  ("h", hseq, o * torch.tanh(c)), ("c", cseq, c)):
            gaps[name] = max(gaps[name], float((stored.double() - ref).abs().max()))
        x = hseq
    return gaps


def bwd_gaps(params, hidden, saved, cot):
    """Per layer from the top: the largest distance of B2's backward kernel's
    dG, dh0, dc0 (bf16 entry point) and the plain float32 recurrence's from
    float64 over the same saved trajectory, relative to the largest float64
    value; every layer gets the float64 reference's dout."""
    gaps = {"B2": [], "plain": []}
    dout = cot[0].double()
    for layer in reversed(range(len(params))):
        p = params[layer]
        args32 = (dout.float().contiguous(), cot[1][layer].float().contiguous(), cot[2][layer].float().contiguous(),
                  saved.act[layer], saved.cseq[layer], hidden[1][layer], p["w_hh"])
        ref = lstm_bwd_recurrence_plain(dout, cot[1][layer].double(), cot[2][layer].double(),
                                        saved.act[layer].double(), saved.cseq[layer].double(),
                                        hidden[1][layer].double(), p["w_hh"].double())
        for who, got in (("B2", lstm_bwd_kernel(*args32)), ("plain", lstm_bwd_recurrence_plain(*args32))):
            gaps[who] += [float((a.double() - r).abs().max() / r.abs().max()) for a, r in zip(got, ref)]
        dout = ref[0] @ p["w_ih"].double().t()
    return np.array(gaps["B2"]), np.array(gaps["plain"])


def f64_gaps_bf16(params, seed, card):
    """For one bf16 input at [80, 128, 512] (chip_smoke.py's BF16_RULES):
    (a) the largest distance of B1's, B2's and the plain bf16 version's
    outputs to float64 on the rounded inputs and weights without the
    roundings of h and c; (b) of every step's stored activations, h and c to
    a float64 step from its own stored previous state (B1's trajectory, the
    plain version's own); (c) of B2's backward kernel's dG, dh0, dc0 and the
    plain float32 recurrence's, over B1's saved trajectory, to float64 BPTT
    over the same tensors (`bwd_gaps`). Also whether B2's forward equals
    B1's."""
    rng = np.random.RandomState(seed)
    L, (T, B, H) = len(params), (80, 128, 512)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(card).bfloat16()
    xs, h0, c0 = bf(rng.randn(T, B, H)), bf(0.5 * rng.randn(L, B, H)), bf(0.5 * rng.randn(L, B, H))
    cot = [bf(rng.randn(T, B, H)), bf(rng.randn(L, B, H)), bf(rng.randn(L, B, H))]
    pb = [{k: v.bfloat16() for k, v in p.items()} for p in params]
    gap = lambda a, r: float((a.double() - r).abs().max())
    with torch.no_grad():
        k_out, (k_h, k_c), saved = lstm_seq_kernel(pb, xs, (h0, c0), save=True)
        p_out, (p_h, p_c), p_saved = lstm_seq_plain(pb, xs, (h0, c0), save=True)
        r_out, (r_h, r_c) = lstm_seq_plain([{k: v.double() for k, v in p.items()} for p in pb], xs.double(),
                                           (h0.double(), c0.double()))
        bwd_k, bwd_p = bwd_gaps(pb, (h0, c0), saved, cot)
    ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in pb]
    ts = [t.clone().requires_grad_(True) for t in (xs, h0, c0)]
    d_out, (d_h, d_c) = lstm_seq_diff(ps, ts[0], (ts[1], ts[2]))
    ref = (r_out, r_h, r_c)
    return {
        "B1": max(gap(a, r) for a, r in zip((k_out, k_h, k_c), ref)),
        "B2": max(gap(a.detach(), r) for a, r in zip((d_out, d_h, d_c), ref)),
        "plain": max(gap(a, r) for a, r in zip((p_out, p_h, p_c), ref)),
        "step_B1": step_gaps(pb, xs, (h0, c0), saved), "step_plain": step_gaps(pb, xs, (h0, c0), p_saved),
        "B2_bwd": bwd_k, "plain_bwd": bwd_p,
        "b2_is_b1": all(torch.equal(a.detach(), b) for a, b in zip((d_out, d_h, d_c), (k_out, k_h, k_c))),
    }


@pytest.mark.cuda
def test_b1_and_b2_bf16_against_float64_on_card(card):
    """The float32 rule carried over to bfloat16 (chip_smoke.py's
    BF16_RULES): at the learner shape on the flagship's LSTM weights, over 8
    inputs, B1's and B2's outputs, every stored step of B1, and B2's
    backward kernel lie no further from their float64 references than twice
    the plain bf16 version (the plain float32 recurrence for the backward)."""
    params = flagship_lstm(card)
    worst = {}
    for seed in range(8):
        reading = f64_gaps_bf16(params, seed, card)
        assert reading.pop("b2_is_b1")
        for who in ("step_B1", "step_plain"):
            for k, v in reading.pop(who).items():
                worst[f"{who}.{k}"] = max(worst.get(f"{who}.{k}", 0.0), v)
        for k, v in reading.items():
            worst[k] = np.maximum(worst.get(k, 0.0), v)
    for who in ("B1", "B2"):
        assert worst[who] <= 2.0 * worst["plain"], (who, worst[who], worst["plain"])
    for part in ("act", "h", "c"):
        assert worst[f"step_B1.{part}"] <= 2.0 * worst[f"step_plain.{part}"], (part, worst)
    assert np.all(worst["B2_bwd"] <= 2.0 * worst["plain_bwd"]), worst["B2_bwd"] / worst["plain_bwd"]


@pytest.mark.cuda
def test_b1_and_b2_bf16_give_the_same_bits_twice_on_card(card):
    params, xs, h0, c0 = lstm_inputs(80, 128, 512, 2, seed=12, device=card)
    pb = [{k: v.bfloat16() for k, v in p.items()} for p in params]
    xs, h0, c0 = xs.bfloat16(), h0.bfloat16(), c0.bfloat16()
    for T in (1, 80):
        a = lstm_seq_kernel(pb, xs[:T], (h0, c0))
        b = lstm_seq_kernel(pb, xs[:T], (h0, c0))
        assert all(torch.equal(x, y) for x, y in zip((a[0], *a[1]), (b[0], *b[1])))

    def grads():
        ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params]
        ts = [t.clone().requires_grad_(True) for t in (xs, h0, c0)]
        outs, (h, c) = tlstm.lstm_seq(ps, ts[0], (ts[1], ts[2]))
        leaves = ts + [p[k] for p in ps for k in ("w_ih", "w_hh", "b")]
        return torch.autograd.grad((outs.float() ** 2).sum() + h.float().sum() + c.float().sum(), leaves)

    bwd = lstm_bwd_kernel.launches_by_dtype["bf16"]
    first = grads()
    assert lstm_bwd_kernel.launches_by_dtype["bf16"] == bwd + 2
    assert all(torch.equal(x, y) for x, y in zip(first, grads()))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(3, 1000), (5, 13), (5, 45)])
def test_b1_and_b2_bf16_over_many_or_ragged_rows_on_card(card, T, B):
    """The bf16 kernels where B is more row tiles than the card holds at once
    (1000) or no multiple of them (13, 45): every step of B1's saved
    trajectory no further from a float64 step than twice the plain bf16
    version's (chip_smoke.py's rule (b)), and B2's backward kernel over that
    trajectory within 1e-5 of float64 BPTT relative to its largest value
    (rounding over 5 steps is about 1e-7; a row or unit read wrong would be
    O(1))."""
    params, xs, h0, c0 = lstm_inputs(T, B, 512, 2, seed=13, device=card)
    pb = [{k: v.bfloat16() for k, v in p.items()} for p in params]
    xs, h0, c0 = xs.bfloat16(), h0.bfloat16(), c0.bfloat16()
    with torch.no_grad():
        saved = lstm_seq_kernel(pb, xs, (h0, c0), save=True)[2]
        p_saved = lstm_seq_plain(pb, xs, (h0, c0), save=True)[2]
    k_gaps, p_gaps = step_gaps(pb, xs, (h0, c0), saved), step_gaps(pb, xs, (h0, c0), p_saved)
    for part in ("act", "h", "c"):
        assert k_gaps[part] <= 2.0 * p_gaps[part], (part, k_gaps, p_gaps)
    rng = np.random.RandomState(14)
    cot = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(card)
           for shape in ((T, B, 512), (2, B, 512), (2, B, 512))]
    launches = lstm_bwd_kernel.launches_by_dtype["bf16"]
    gaps, _ = bwd_gaps(pb, (h0, c0), saved, cot)
    assert lstm_bwd_kernel.launches_by_dtype["bf16"] == launches + 2
    assert np.all(gaps <= 1e-5), gaps


@pytest.mark.cuda
def test_bf16_kernels_refuse_what_they_do_not_take(card):
    """The bf16 kernels take H a multiple of 64 up to 512 and 16-byte aligned
    tensors; the wrappers raise a ValueError that names the condition, for
    shapes the float32 kernels take (H = 96)."""
    for H, match in ((96, "H % 64 == 0"), (1024, "H <= 512")):
        params, xs, h0, c0 = lstm_inputs(1, 4, H, 1, seed=15, device=card)
        if H == 96:
            lstm_seq_kernel(params, xs, (h0, c0))  # float32 takes it
        pb = [{k: v.bfloat16() for k, v in p.items()} for p in params]
        with pytest.raises(ValueError, match=match):
            lstm_seq_kernel(pb, xs.bfloat16(), (h0.bfloat16(), c0.bfloat16()))
        f32 = lambda *shape: torch.zeros(*shape, device=card)
        with pytest.raises(ValueError, match=match):
            lstm_bwd_kernel(f32(2, 4, H), None, None, f32(2, 4, 4 * H), f32(2, 4, H), c0[0].bfloat16().contiguous(),
                            pb[0]["w_hh"])
    params, xs, h0, c0 = lstm_inputs(1, 4, 512, 1, seed=16, device=card)
    pb = [{k: v.bfloat16() for k, v in p.items()} for p in params]
    shifted = torch.empty(xs.numel() + 1, dtype=torch.bfloat16, device=card)[1:].view(xs.shape)
    shifted.copy_(xs)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lstm_seq_kernel(pb, shifted, (h0.bfloat16(), c0.bfloat16()))


def kernels_vs_plain_update(setup, state, card, monkeypatch):
    """One sgd_update through the kernels and one through the plain versions
    from copies of `state` on one presampled batch; returns both metrics."""
    idx, is_w = trep.sample_indices(state.replay, setup.replay, setup.train.batchsize,
                                    generator=torch.Generator(device=card).manual_seed(0))
    rows = trep.gather_rows(state.replay, idx)
    optimizer = learner.make_optimizer(setup.train)

    def fresh_copy():
        return state._replace(
            params=AgentParams(clone_params(state.params.online), clone_params(state.params.target)),
            opt_state=state.opt_state._replace(mu=[m.clone() for m in state.opt_state.mu],
                                               nu=[v.clone() for v in state.opt_state.nu]),
            replay=state.replay._replace(weight=state.replay.weight.clone()),
        )

    _, m_k = learner.sgd_update(setup, optimizer, fresh_copy(), presampled=(rows, is_w, idx))
    with monkeypatch.context() as m:
        m.setattr(tlstm, "lstm_seq", lstm_seq_plain)
        m.setattr(sb, "sample_batch", sb.sample_batch_plain)
        _, m_p = learner.sgd_update(setup, optimizer, fresh_copy(), presampled=(rows, is_w, idx))
    return m_k, m_p


@pytest.mark.cuda
def test_bf16_sgd_update_through_kernels_near_plain_on_card(card, monkeypatch):
    """A bf16 sgd_update through B1/B2's bf16 routes and B3 against the plain
    versions: loss and grad_norm within 2% relative (bfloat16 roundings of h
    and c flip where float32 sums differ in order, and the flips carry over
    24 steps); every param stays float32."""
    setup, state = small_trainer(card, compute_dtype="bfloat16")
    state, _ = learner.collect_only(setup, state)
    bf16 = (lstm_seq_kernel.launches_by_dtype["bf16"], lstm_bwd_kernel.launches_by_dtype["bf16"])
    m_k, m_p = kernels_vs_plain_update(setup, state, card, monkeypatch)
    assert lstm_seq_kernel.launches_by_dtype["bf16"] > bf16[0]
    assert lstm_bwd_kernel.launches_by_dtype["bf16"] == bf16[1] + 2
    for k in ("loss", "grad_norm", "rl_loss", "aux1"):
        assert abs(float(m_k[k]) - float(m_p[k])) <= 2e-2 * abs(float(m_p[k])), k
    assert all(t.dtype == torch.float32 for t in learner.param_leaves(state.params.online))


@pytest.mark.cuda
def test_iql_sgd_update_through_kernels_equals_plain_on_card(card, monkeypatch):
    """IQL (3 players, one item per player, B3 at Pi = 1) in float32: one
    sgd_update through the kernels against the plain versions within the
    float32 test's 1e-4 relative."""
    cfg = make_config("iql_2p", num_player=3, num_envs=16, batchsize=16, burn_in_frames=48,
                      replay_buffer_size=256, max_len=24, rnn_hid_dim=64, num_update_per_chunk=2)
    setup = learner.make_setup(cfg)
    state = learner.init_train_state(setup, 0, card)
    state, _ = learner.collect_only(setup, state)
    assert setup.replay.num_player == 1 and int(state.replay.size) >= 48
    m_k, m_p = kernels_vs_plain_update(setup, state, card, monkeypatch)
    for k in ("loss", "grad_norm", "rl_loss"):
        assert abs(float(m_k[k]) - float(m_p[k])) <= 1e-4 * abs(float(m_p[k])), k


@pytest.mark.cuda
def test_iql_3p_eval_on_card_matches_cpu(card):
    """The 3-player IQL checkpoint on the same 50 decks through B1 on the card
    and the plain LSTM on the CPU: at least 49 of 50 games score the same (a
    float32 near-tie may break the other way), means within 0.5."""
    decks = shuffled_decks(GameConfig(players=3), 50, torch.Generator().manual_seed(6))
    cpu_pol = loaders.load_any(IQL_3P, device="cpu")
    card_pol = loaders.load_any(IQL_3P, device=card)
    cpu_mean, _, cpu_scores, _ = evaluate([cpu_pol] * 3, 50, seed=0, decks=decks, device="cpu")
    launches = lstm_seq_kernel.launches
    card_mean, _, card_scores, _ = evaluate([card_pol] * 3, 50, seed=0, decks=decks, device=card)
    assert lstm_seq_kernel.launches > launches
    assert sum(a == b for a, b in zip(card_scores, cpu_scores)) >= 49
    assert abs(card_mean - cpu_mean) <= 0.5
