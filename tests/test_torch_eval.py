"""The slice as a whole: greedy eval of the flagship SAD-AUX checkpoint through
the port (`hanabi_sad_tpu_torch.rollout.runner.eval_rollout`) against the JAX
package's eval_rollout, at full width on the CPU.

The JAX rollout deals its games from PRNG keys; the port is handed the same 8
decks, taken from those keys. Per-game scores must be equal. Per-step actions
must be equal, except at steps where JAX's top two legal advantages lie within
1e-4 of each other (float32 sums in another order may break such a tie the
other way); the test counts those steps and prints the count."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.game import env as jenv
from hanabi_sad_tpu.game.config import GameConfig as JGameConfig
from hanabi_sad_tpu.models import r2d2_net as jnet
from hanabi_sad_tpu.rollout import runner as jrunner
from hanabi_sad_tpu.tools import loaders as jloaders
from hanabi_sad_tpu_torch.agent import r2d2_agent as tagent
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.env import EnvConfig
from hanabi_sad_tpu_torch.rollout import runner as trunner
from hanabi_sad_tpu_torch.tools import eval_model as teval_model
from hanabi_sad_tpu_torch.tools import loaders as tloaders
from hanabi_sad_tpu_torch.train.evaluate import evaluate

FLAGSHIP = str(Path(__file__).resolve().parents[1] / "docs/runs/sad_aux_r4_soup10.pkl")
N, STEPS = 8, 128
TIE = 1e-4


@pytest.fixture(scope="module")
def policies():
    return jloaders.load_native_checkpoint(FLAGSHIP), tloaders.load_native_checkpoint(FLAGSHIP, device="cpu")


def test_eval_rollout_matches_jax(policies):
    jpol, tpol = policies
    jcfg = jenv.EnvConfig(game=JGameConfig(players=2), eps_list=(0.0,), max_len=-1, sad=True)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(jnp.arange(N))
    decks = np.asarray(jax.vmap(lambda k: jenv.reset_state(jcfg, k).game.deck)(keys))

    run = jax.jit(functools.partial(
        jrunner.eval_rollout, agent_cfgs=[jpol.agent_cfg] * 2, env_cfg=jcfg,
        num_steps=STEPS, return_actions=True,
    ))
    j_scores, j_done, j_applied, j_was_done = (
        np.asarray(x) for x in run(params_per_player=[jpol.params] * 2, keys=keys)
    )

    seen = []  # (priv_s, legal) of every act call, in call order: step-major, seat-minor

    def recording_act(params, cfg, obs, hidden, generator):
        seen.append((obs["priv_s"][:, 0].numpy(), obs["legal_move"][:, 0].numpy()))
        return tagent.act(params, cfg, obs, hidden, generator)

    tcfg = EnvConfig(game=GameConfig(players=2), eps_list=(0.0,), max_len=-1, sad=True)
    t_scores, t_done, t_applied, t_was_done = (
        x.numpy() for x in trunner.eval_rollout(
            [tpol.params] * 2, [tpol.agent_cfg] * 2, tcfg, torch.from_numpy(decks.copy()).long(),
            num_steps=STEPS, act_fns=[recording_act] * 2, return_actions=True,
        )
    )
    assert j_done.all() and t_done.all()
    np.testing.assert_array_equal(t_scores, j_scores)
    np.testing.assert_array_equal(t_was_done, j_was_done)

    # JAX advantages along the trajectory, per seat, from the observations the
    # port saw (identical to JAX's up to a game's first differing action).
    act = jax.jit(lambda p, x, h: jnet.act(p, jpol.agent_cfg.net, x, h))
    hid = [{"h0": jnp.zeros((N, 2, 512)), "c0": jnp.zeros((N, 2, 512))} for _ in range(2)]
    near_tie = np.zeros((STEPS, N), bool)
    for t in range(STEPS):
        advs = []
        for p in range(2):
            priv_s, legal = seen[2 * t + p]
            adv, hid[p] = act(jpol.params.online, jnp.asarray(priv_s), hid[p])
            advs.append(np.where(legal > 0, np.asarray(adv), -np.inf))
        cur = np.asarray(t % 2 == 1, int)  # 2 players alternate from seat 0
        top2 = -np.sort(-np.stack(advs, 1)[np.arange(N), np.full(N, cur)], axis=1)[:, :2]
        near_tie[t] = np.isfinite(top2[:, 1]) & (top2[:, 0] - top2[:, 1] < TIE)

    live = ~j_was_done
    num_near = int((near_tie & live).sum())
    print(f"near-tie steps: {num_near} of {int(live.sum())} live steps")
    for i in range(N):
        for t in np.where(live[:, i])[0]:
            if t_applied[t, i] != j_applied[t, i]:
                assert near_tie[t, i], f"game {i} step {t}: {t_applied[t, i]} vs {j_applied[t, i]}"
                break  # the games part ways here


def test_evaluate_and_its_guard(policies):
    _, tpol = policies
    mean, perfect, scores, num_perfect = evaluate([tpol, tpol], 4, seed=3, device="cpu")
    assert len(scores) == 4 and all(0 <= s <= 25 for s in scores)
    assert mean == pytest.approx(np.mean(scores)) and perfect == num_perfect / 4
    with pytest.raises(RuntimeError, match="did not finish"):
        evaluate([tpol, tpol], 4, seed=3, num_steps=10, device="cpu")


def test_eval_model_cli_on_cpu(capsys):
    mean, sem, perfect = teval_model.main(
        ["--weight", FLAGSHIP, "--num_game", "4", "--device", "cpu"]
    )
    assert 0 <= mean <= 25 and sem >= 0 and 0 <= perfect <= 1
    assert "score: " in capsys.readouterr().out

