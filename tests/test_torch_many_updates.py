"""24 learner updates of the port against 24 of the JAX package.

The one-update test (`test_torch_learner.py`) cannot see an error that only
builds up over updates: the Adam count and bias correction, the lr schedule
and its end, the target sync. Here both packages start from the same params
and the same filled replay (the `SMALL` config: hidden 64, T = 12, 4
episodes x 2 players, pred_weight 0.25) and take 24 `sgd_update`s on one
shared sequence of presampled indices and IS weights, with
`num_update_between_sync=10` (syncs at updates 0, 10 and 20) and the lr
decaying from 6.25e-5 to 1e-5 over 16 updates (the schedule ends at update
16 and holds for the last 8).

Tolerances: the one-update test's, not widened. The metrics within rtol
1e-5, the online and target params within atol 1e-7, the Adam moments
within rtol 1e-5 / atol 1e-7, the replay weights within atol 1e-5. The two
packages' float32 sums in another order drift by less over 24 updates: on
this test's inputs the largest gaps are 4.8e-7 relative on a metric,
1.5e-8 on a param, 6e-8 on a first moment, 2.4e-7 on a replay weight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.agent import r2d2_agent as jagent
from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu.train import learner as jlearner
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train.checkpoint import from_jax_params
from test_torch_learner import SMALL, fill_replays

UPDATES = 24
SYNC = 10
DECAY = 16
MANY = dict(SMALL, num_update_between_sync=SYNC, lr_final=1e-5, lr_decay_updates=DECAY)
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-7
MOMENT_RTOL, MOMENT_ATOL = 1e-5, 1e-7
WEIGHT_ATOL = 1e-5
FILLED = 20  # episodes in the replay


def numpy_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def torch_leaves(params):
    return [t.detach().numpy().copy() for t in tlearner.param_leaves(params)]


def jax_state(setup):
    """`jlearner.init_train_state` without the continuous actor, which
    sgd_update never reads (its eager env reset is most of the set-up time)."""
    k_net, k_env, k_sample = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jagent.init_agent(k_net, setup.agent)
    return jlearner.TrainState(
        params=params, opt_state=jlearner.make_optimizer(setup.train).init(params.online),
        replay=jrep.init_replay(setup.replay), num_update=jnp.asarray(0, jnp.int32),
        env_key=k_env, sample_key=k_sample, actor=None)


@pytest.fixture(scope="module")
def runs():
    """Both packages' 24 updates: per-update metrics, the online params
    before each update, the target params after each, and the end states."""
    jsetup = jlearner.make_setup(jconfig.make_config("sad_2p", **MANY))
    tsetup = tlearner.make_setup(tconfig.make_config("sad_2p", **MANY))
    jstate = jax_state(jsetup)
    tstate = tlearner.init_train_state(tsetup, 0, "cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate = tstate._replace(params=type(tstate.params)(
        online=from_jax_params(np_params.online, "cpu"), target=from_jax_params(np_params.target, "cpu")))
    jstate, tstate = fill_replays(jsetup, tsetup, jstate, tstate, M=FILLED)

    rng = np.random.RandomState(7)
    B = tsetup.train.batchsize
    idx = rng.randint(0, FILLED, (UPDATES, B)).astype(np.int32)
    idx[::5, 1] = idx[::5, 0]  # a duplicate row every fifth update
    is_w = rng.uniform(0.2, 1.0, (UPDATES, B)).astype(np.float32)

    jopt = jlearner.make_optimizer(jsetup.train)
    j_update = jax.jit(lambda s, p: jlearner.sgd_update(jsetup, jopt, s, presampled=p))
    topt = tlearner.make_optimizer(tsetup.train)
    out = {"j": {"metrics": [], "online_before": [], "target_after": []},
           "t": {"metrics": [], "online_before": [], "target_after": []}}
    for u in range(UPDATES):
        rows = jrep.gather_rows(jstate.replay, jnp.asarray(idx[u]))
        out["j"]["online_before"].append(numpy_leaves(jstate.params.online))
        jstate, jm = j_update(jstate, (rows, jnp.asarray(is_w[u]), jnp.asarray(idx[u])))
        out["j"]["metrics"].append({k: float(v) for k, v in jm.items()})
        out["j"]["target_after"].append(numpy_leaves(jstate.params.target))

        out["t"]["online_before"].append(torch_leaves(tstate.params.online))
        tstate, tm = tlearner.sgd_update(
            tsetup, topt, tstate, presampled=(torch.from_numpy(is_w[u]), torch.from_numpy(idx[u]).long()))
        out["t"]["metrics"].append({k: float(v) for k, v in tm.items()})
        out["t"]["target_after"].append(torch_leaves(tstate.params.target))
    out["j"]["state"], out["t"]["state"] = jstate, tstate
    return out


def test_each_of_24_updates_metrics_match_jax(runs):
    for u, (tm, jm) in enumerate(zip(runs["t"]["metrics"], runs["j"]["metrics"])):
        assert tm.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL, err_msg=f"update {u}: {k}")


@pytest.mark.parametrize("who", ["t", "j"])
def test_target_syncs_at_0_10_and_20_and_holds_between(runs, who):
    """After update u the target holds the online params from before update
    SYNC * (u // SYNC), bit for bit, in each package."""
    run = runs[who]
    for u in range(UPDATES):
        synced = run["online_before"][SYNC * (u // SYNC)]
        for a, b in zip(run["target_after"][u], synced):
            np.testing.assert_array_equal(a, b, err_msg=f"{who}: update {u}")
    assert not all(np.array_equal(a, b) for a, b in zip(run["target_after"][SYNC - 1], run["target_after"][SYNC]))


def test_online_and_target_params_after_24_updates_match_jax(runs):
    jstate, tstate = runs["j"]["state"], runs["t"]["state"]
    for name in ("online", "target"):
        t_leaves = torch_leaves(getattr(tstate.params, name))
        j_leaves = numpy_leaves(getattr(jstate.params, name))
        assert len(t_leaves) == len(j_leaves)
        for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
            np.testing.assert_allclose(t, j, atol=PARAM_ATOL, rtol=0, err_msg=f"{name} leaf {i}")
    assert tstate.num_update == int(jstate.num_update) == UPDATES


def test_adam_moments_counts_and_schedule_after_24_updates_match_jax(runs):
    jstate, tstate = runs["j"]["state"], runs["t"]["state"]
    adam, schedule = jstate.opt_state[1][0], jstate.opt_state[1][1]
    assert tstate.opt_state.count == int(adam.count) == UPDATES
    assert tstate.opt_state.lr_count == int(schedule.count) == UPDATES
    for t, j in zip(tstate.opt_state.mu + tstate.opt_state.nu, numpy_leaves(adam.mu) + numpy_leaves(adam.nu)):
        np.testing.assert_allclose(t.numpy(), j, rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
    topt = tlearner.make_optimizer(tlearner.make_setup(tconfig.make_config("sad_2p", **MANY)).train)
    assert topt.lr(0) == pytest.approx(6.25e-5) and topt.lr(DECAY) == topt.lr(UPDATES) == pytest.approx(1e-5)


def test_replay_weights_after_24_updates_match_jax(runs):
    jstate, tstate = runs["j"]["state"], runs["t"]["state"]
    np.testing.assert_allclose(tstate.replay.weight.numpy(), np.asarray(jstate.replay.weight),
                               atol=WEIGHT_ATOL, rtol=0)
