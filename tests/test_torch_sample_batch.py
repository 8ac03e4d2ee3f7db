"""Kernel B3's plain version (`ops.sample_batch.sample_batch_plain`) and the
replay paths through it, against the JAX package, on the same numpy-made
replay.

Small sizes: capacity 64, T = 12, Pi = 2, obs_dim 40 (76 bits, 10 bytes a
step). The Batch from the plain version, from `rows_to_batch` and from
`sample` must equal the JAX package's `rows_to_batch(cfg, gather_rows(state,
idx))` and `sample` exactly (a gather and a bit unpack, no arithmetic), with
every field contiguous, so that the learner's reshapes are views. The
fixed-order prefix sum that the card's sampler uses equals `torch.cumsum`
exactly on integer weights (every partial sum is exact in float32) and
within 4 float32 roundings of the total on random ones. One `sgd_update`
through this path equals the JAX one at the tolerances of
tests/test_torch_learner.py. The kernel itself runs only on a CUDA card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu.train import learner as jlearner
from hanabi_sad_tpu_torch.agent import r2d2_agent as tagent
from hanabi_sad_tpu_torch.models import r2d2_net as tnet
from hanabi_sad_tpu_torch.ops import sample_batch as sb
from hanabi_sad_tpu_torch.replay import prioritized as trep
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train.checkpoint import from_jax_params
from test_torch_learner import SMALL, fill_replays
from test_torch_replay import CAP, JCFG, TCFG, filled

SIZES = dict(obs_dim=TCFG.obs_dim, num_actions=TCFG.num_actions, hand_size=TCFG.hand_size)
INDEX_SETS = {
    "in range": [5, 17, 0, 63, 40, 22],
    "duplicates": [5, 5, 0, 63, 17, 5, 40, 40],
    "out of range, both ends": [-CAP - 2, -CAP, -1, 0, CAP - 1, CAP, CAP + 3],
    "one": [9],
}


def assert_batch_equals_jax(tbatch, jbatch):
    for f in jbatch._fields:
        t, j = getattr(tbatch, f), np.asarray(getattr(jbatch, f))
        assert t.is_contiguous(), f
        assert tuple(t.shape) == j.shape, f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)


@pytest.mark.parametrize("case", sorted(INDEX_SETS))
def test_sample_batch_plain_equals_jax_rows_to_batch(case):
    jstate, tstate = filled()
    idx = np.asarray(INDEX_SETS[case], np.int64)
    jbatch = jrep.rows_to_batch(JCFG, jrep.gather_rows(jstate, jnp.asarray(idx)))
    fields = (tstate.packed, tstate.action, tstate.reward, tstate.bootstrap, tstate.seq_len)
    tbatch = sb.sample_batch_plain(*fields, torch.from_numpy(idx), **SIZES)
    assert_batch_equals_jax(tbatch, jbatch)
    assert tbatch.action.dtype == torch.int64


@pytest.mark.parametrize("case", sorted(INDEX_SETS))
def test_rows_to_batch_equals_jax(case):
    jstate, tstate = filled()
    idx = np.asarray(INDEX_SETS[case], np.int64)
    # The invalid items of the last add all land on the slot at write_ptr,
    # in an order neither package fixes (test_add_packed_matches_jax); no
    # index set reads it.
    assert int(tstate.write_ptr) not in set(trep.gather_unpack_op.jax_index(torch.from_numpy(idx), CAP).tolist())
    jbatch = jrep.rows_to_batch(JCFG, jrep.gather_rows(jstate, jnp.asarray(idx)))
    tbatch = trep.rows_to_batch(TCFG, trep.gather_rows(tstate, torch.from_numpy(idx)))
    assert_batch_equals_jax(tbatch, jbatch)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_equals_jax_with_its_uniforms(seed):
    jstate, tstate = filled(seed=seed)
    key = jax.random.PRNGKey(seed)
    jbatch, j_isw, j_idx = jrep.sample(jstate, JCFG, key, 16)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (16,))))
    tbatch, t_isw, t_idx = trep.sample(tstate, TCFG, 16, uniforms=u)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_isw.numpy(), np.asarray(j_isw), rtol=1e-6, atol=0)
    assert_batch_equals_jax(tbatch, jbatch)


def test_sample_batch_refuses_what_it_does_not_take():
    _, tstate = filled()
    fields = (tstate.packed, tstate.action, tstate.reward, tstate.bootstrap, tstate.seq_len)
    idx = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="int64"):
        sb.sample_batch(*fields, idx.int(), **SIZES)
    with pytest.raises(ValueError, match="action"):
        sb.sample_batch(fields[0], fields[1].int(), *fields[2:], idx, **SIZES)
    with pytest.raises(ValueError, match="fit"):
        sb.sample_batch(*fields, idx, obs_dim=70, num_actions=21, hand_size=5)


def test_learner_reshapes_of_the_batch_are_views(monkeypatch):
    """td_error reshapes priv_s and legal_move to [T, B * Pi, ...] and loss
    reshapes own_hand to [T, B, Pi, hand, 3]: on contiguous fields these
    read the Batch in place."""
    setup = tlearner.make_setup(tconfig.make_config("sad_2p", **SMALL))
    state = tlearner.init_train_state(setup, 0, "cpu")
    cfg = setup.replay
    rng = np.random.RandomState(4)
    fields = (torch.from_numpy(rng.randint(0, 256, (6, cfg.seq_len, cfg.num_player, cfg.bytes_per_step)).astype(np.uint8)),
              torch.from_numpy(rng.randint(0, cfg.num_actions, (6, cfg.seq_len, cfg.num_player))),
              torch.randn(6, cfg.seq_len), torch.rand(6, cfg.seq_len), torch.full((6,), float(cfg.seq_len)))
    batch = sb.sample_batch(*fields, torch.tensor([3, 3, 5, 0]), obs_dim=cfg.obs_dim,
                            num_actions=cfg.num_actions, hand_size=cfg.hand_size)
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
    tagent.loss(state.params, setup.agent, batch, 0.25)
    assert seen == {k: getattr(batch, k).data_ptr() for k in ("priv_s", "legal_move", "own_hand")}


def test_sgd_update_through_sample_batch_matches_jax():
    """One update on a presampled batch whose indices repeat a row and count
    one from the end: loss, grad_norm and the stats to 1e-5
    relative, the new params to 1e-7 absolute (one Adam step of lr
    6.25e-5), the new replay weights to 1e-5 absolute."""
    jsetup = jlearner.make_setup(jconfig.make_config("sad_2p", **SMALL))
    tsetup = tlearner.make_setup(tconfig.make_config("sad_2p", **SMALL))
    jstate = jlearner.init_train_state(jsetup, jax.random.PRNGKey(1))
    tstate = tlearner.init_train_state(tsetup, 0, "cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate = tstate._replace(params=type(tstate.params)(
        online=from_jax_params(np_params.online, "cpu"), target=from_jax_params(np_params.target, "cpu")))
    jstate, tstate = fill_replays(jsetup, tsetup, jstate, tstate, seed=2)
    idx = np.asarray([7, 7, -1, 30], np.int32)
    is_w = np.asarray([1.0, 1.0, 0.5, 0.75], np.float32)
    j_rows = jrep.gather_rows(jstate.replay, jnp.asarray(idx))
    jopt = jlearner.make_optimizer(jsetup.train)
    jstate2, jm = jax.jit(lambda s, p: jlearner.sgd_update(jsetup, jopt, s, presampled=p))(
        jstate, (j_rows, jnp.asarray(is_w), jnp.asarray(idx)))
    tstate2, tm = tlearner.sgd_update(tsetup, tlearner.make_optimizer(tsetup.train), tstate,
                                      presampled=(torch.from_numpy(is_w), torch.from_numpy(idx).long()))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for t, j in zip(tlearner.param_leaves(tstate2.params.online), jax.tree_util.tree_leaves(jstate2.params.online)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-7, rtol=0)
    np.testing.assert_allclose(tstate2.replay.weight.numpy(), np.asarray(jstate2.replay.weight), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [1, 1000, 1024, 4097, 65536])
def test_blocked_cumsum_is_a_prefix_sum(n):
    rng = np.random.RandomState(n)
    ints = torch.from_numpy(rng.randint(0, 8, n).astype(np.float32))
    assert torch.equal(trep.blocked_cumsum(ints), torch.cumsum(ints, 0))
    w = torch.from_numpy(rng.uniform(0.01, 2.0, n).astype(np.float32))
    ref = np.cumsum(w.double().numpy())
    np.testing.assert_allclose(trep.blocked_cumsum(w).double().numpy(), ref, rtol=0,
                               atol=4 * np.finfo(np.float32).eps * ref[-1])
