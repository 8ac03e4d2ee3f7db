"""The slice as a whole: greedy eval of the flagship SAD-AUX checkpoint (and
of the 3-player IQL checkpoint, without SAD) through the port
(`hanabi_sad_tpu_torch.rollout.runner.eval_rollout`) against the JAX
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
from torch_parity import check_actions_up_to_near_ties, near_tie_steps

FLAGSHIP = str(Path(__file__).resolve().parents[1] / "docs/runs/sad_aux_r4_soup10.pkl")
IQL_3P = str(Path(__file__).resolve().parents[1] / "docs/runs/iql_3p_r5_model4.pkl")
N, STEPS = 8, 128
TIE = 1e-4


@pytest.fixture(scope="module")
def policies():
    return jloaders.load_native_checkpoint(FLAGSHIP), tloaders.load_native_checkpoint(FLAGSHIP, device="cpu")


def test_eval_rollout_matches_jax(policies):
    eval_parity(*policies, players=2, sad=True, seed=7)


def test_iql_3p_eval_rollout_matches_jax():
    """tools/eval_model's 3-player IQL checkpoint (no SAD, 31 actions, input
    1081), as the flagship test holds its checkpoint."""
    jpol, tpol = jloaders.load_native_checkpoint(IQL_3P), tloaders.load_any(IQL_3P, device="cpu")
    assert (tpol.sad, tpol.agent_cfg.net.in_dim, tpol.agent_cfg.net.out_dim) == (False, 1081, 31)
    eval_parity(jpol, tpol, players=3, sad=False, seed=8)


def eval_parity(jpol, tpol, players, sad, seed):
    """N games on the same decks in both packages: equal scores, and equal
    actions up to a near tie of JAX's advantages."""
    P = players
    jcfg = jenv.EnvConfig(game=JGameConfig(players=P), eps_list=(0.0,), max_len=-1, sad=sad)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(jnp.arange(N))
    decks = np.asarray(jax.vmap(lambda k: jenv.reset_state(jcfg, k).game.deck)(keys))

    run = jax.jit(functools.partial(
        jrunner.eval_rollout, agent_cfgs=[jpol.agent_cfg] * P, env_cfg=jcfg,
        num_steps=STEPS, return_actions=True,
    ))
    j_scores, j_done, j_applied, j_was_done = (
        np.asarray(x) for x in run(params_per_player=[jpol.params] * P, keys=keys)
    )

    seen = []  # (priv_s, legal) of every act call, in call order: step-major, seat-minor

    def recording_act(params, cfg, obs, hidden, generator):
        seen.append((obs["priv_s"][:, 0].numpy(), obs["legal_move"][:, 0].numpy()))
        return tagent.act(params, cfg, obs, hidden, generator)

    tcfg = EnvConfig(game=GameConfig(players=P), eps_list=(0.0,), max_len=-1, sad=sad)
    t_scores, t_done, t_applied, t_was_done = (
        x.numpy() for x in trunner.eval_rollout(
            [tpol.params] * P, [tpol.agent_cfg] * P, tcfg, torch.from_numpy(decks.copy()).long(),
            num_steps=STEPS, act_fns=[recording_act] * P, return_actions=True,
        )
    )
    assert j_done.all() and t_done.all()
    np.testing.assert_array_equal(t_scores, j_scores)
    np.testing.assert_array_equal(t_was_done, j_was_done)

    # JAX advantages along the trajectory, per seat, from the observations the
    # port saw (identical to JAX's up to a game's first differing action).
    act = jax.jit(lambda x, h: jnet.act(jpol.params.online, jpol.agent_cfg.net, x, h))
    hid = [{"h0": jnp.zeros((N, 2, 512)), "c0": jnp.zeros((N, 2, 512))} for _ in range(P)]
    near_tie = near_tie_steps(act, seen, hid, STEPS, TIE)
    num_near, _ = check_actions_up_to_near_ties(t_applied, j_applied, j_was_done, near_tie)
    print(f"near-tie steps: {num_near} of {int((~j_was_done).sum())} live steps")


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



def test_eval_model_cli_evaluates_the_3p_iql_checkpoint(capsys):
    mean, sem, perfect = teval_model.main(
        ["--weight", IQL_3P, "--num_game", "4", "--num_player", "3", "--device", "cpu"]
    )
    assert 0 <= mean <= 25 and sem >= 0 and 0 <= perfect <= 1
    assert "score: " in capsys.readouterr().out
