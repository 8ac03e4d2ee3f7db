"""OBL's public-LSTM net in the port (`hanabi_sad_tpu_torch.models.
public_lstm`, `tools.loaders.load_obl_model`, `tools.eval_model --paper obl`)
against the JAX package's, on the same state dicts made with numpy from a
seed, through the plain LSTM on the CPU.

  * `forward` against the JAX `forward` and against a torch net of the
    reference architecture: q within 1e-5 (float32 sums in another order);
  * `act`, one step from a non-zero hidden, against JAX's `act`: advantages
    and hidden within 1e-5;
  * `sad_slice`, `load_obl_pthw` dropping OBL_STRIP_KEYS, the state dict
    round trip;
  * at OBL's published widths (658 / 533 / 512): 8 greedy games on the decks
    JAX deals from its keys. Scores equal; actions equal except where a
    game's first difference lies at a near tie of JAX's advantages
    (<= 1e-4), counted and printed;
  * `eval_model --paper obl --device cpu`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.game import env as jenv
from hanabi_sad_tpu.game.config import GameConfig as JGameConfig
from hanabi_sad_tpu.models import public_lstm as jpub
from hanabi_sad_tpu.rollout import runner as jrunner
from hanabi_sad_tpu.tools import loaders as jloaders
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.env import EnvConfig
from hanabi_sad_tpu_torch.models import public_lstm as tpub
from hanabi_sad_tpu_torch.rollout import runner as trunner
from hanabi_sad_tpu_torch.tools import eval_model as teval_model
from hanabi_sad_tpu_torch.tools import loaders as tloaders
from torch_parity import check_actions_up_to_near_ties, near_tie_steps

TOL = 1e-5
TIE = 1e-4
N, STEPS = 8, 128


def np_obl_state_dict(seed, priv=658, publ=533, hid=512, out=21, layers=2, n_priv=3, strip=False):
    """A reference PublicLSTMNet state dict with torch's default init
    ranges, drawn with numpy; with `strip`, also OBL's extra heads."""
    rng = np.random.RandomState(seed)
    sd = {}

    def lin(name, d_in, d_out):
        k = 1 / np.sqrt(d_in)
        sd[f"{name}.weight"] = torch.from_numpy(rng.uniform(-k, k, (d_out, d_in)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.uniform(-k, k, (d_out,)).astype(np.float32))

    for i in range(n_priv):
        lin(f"priv_net.{2 * i}", priv if i == 0 else hid, hid)
    lin("publ_net.0", publ, hid)
    k = 1 / np.sqrt(hid)
    for layer in range(layers):
        for name in ("weight_ih", "weight_hh"):
            sd[f"lstm.{name}_l{layer}"] = torch.from_numpy(rng.uniform(-k, k, (4 * hid, hid)).astype(np.float32))
        for name in ("bias_ih", "bias_hh"):
            sd[f"lstm.{name}_l{layer}"] = torch.from_numpy(rng.uniform(-k, k, (4 * hid,)).astype(np.float32))
    lin("fc_v", hid, 1)
    lin("fc_a", hid, out)
    lin("pred_1st", hid, 15)
    if strip:
        for key in tpub.OBL_STRIP_KEYS:
            sd[key] = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
    return sd


def dataclasses_equal(tcfg, jcfg):
    return {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__} == {
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}


class TorchPub(torch.nn.Module):
    """The reference architecture in torch modules."""

    def __init__(self, priv_dim, publ_dim, hid, out):
        super().__init__()
        self.priv_net = torch.nn.Sequential(
            torch.nn.Linear(priv_dim, hid), torch.nn.ReLU(),
            torch.nn.Linear(hid, hid), torch.nn.ReLU(),
            torch.nn.Linear(hid, hid), torch.nn.ReLU(),
        )
        self.publ_net = torch.nn.Sequential(torch.nn.Linear(publ_dim, hid), torch.nn.ReLU())
        self.lstm = torch.nn.LSTM(hid, hid, num_layers=2)
        self.fc_v = torch.nn.Linear(hid, 1)
        self.fc_a = torch.nn.Linear(hid, out)
        self.pred_1st = torch.nn.Linear(hid, 15)

    def forward(self, priv, publ, legal):
        publ_o, _ = self.lstm(self.publ_net(publ))
        o = self.priv_net(priv) * publ_o
        a, v = self.fc_a(o), self.fc_v(o)
        legal_a = a * legal
        return v + legal_a - legal_a.mean(2, keepdim=True)


def test_forward_matches_jax_and_the_reference_architecture():
    hid, out, priv_dim, publ_dim, T, B = 24, 9, 30, 20, 5, 3
    sd = np_obl_state_dict(0, priv_dim, publ_dim, hid, out)
    ref = TorchPub(priv_dim, publ_dim, hid, out)
    ref.load_state_dict(sd)
    tparams, tcfg = tpub.from_torch_state_dict(sd, device="cpu")
    jparams, jcfg = jpub.from_torch_state_dict(sd)
    assert dataclasses_equal(tcfg, jcfg)
    rng = np.random.RandomState(1)
    priv = rng.randn(T, B, priv_dim).astype(np.float32)
    publ = rng.randn(T, B, publ_dim).astype(np.float32)
    legal = (rng.rand(T, B, out) > 0.3).astype(np.float32)
    action = rng.randint(0, out, (T, B))
    with torch.no_grad():
        ref_q = ref(*(torch.from_numpy(x) for x in (priv, publ, legal))).numpy()
        tqa, tgreedy, tq, to = tpub.forward(tparams, tcfg, *(torch.from_numpy(x) for x in (priv, publ, legal, action)))
    jqa, jgreedy, jq, jo = jpub.forward(jparams, jcfg, *(jnp.asarray(x) for x in (priv, publ, legal, action)))
    assert np.abs(tq.numpy() - ref_q).max() <= TOL
    assert np.abs(tq.numpy() - np.asarray(jq)).max() <= TOL
    assert np.abs(tqa.numpy() - np.asarray(jqa)).max() <= TOL
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= TOL
    np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))


def test_act_from_a_nonzero_hidden_matches_jax():
    hid, B = 32, 6
    sd = np_obl_state_dict(2, hid=hid)
    tparams, tcfg = tpub.from_torch_state_dict(sd, device="cpu")
    jparams, jcfg = jpub.from_torch_state_dict(sd)
    rng = np.random.RandomState(3)
    s = (rng.rand(B, 838) < 0.2).astype(np.float32)
    h0 = (0.5 * rng.randn(B, 2, hid)).astype(np.float32)
    c0 = (0.5 * rng.randn(B, 2, hid)).astype(np.float32)
    ta, thid = tpub.act(tparams, tcfg, *tpub.sad_slice(torch.from_numpy(s)),
                        {"h0": torch.from_numpy(h0), "c0": torch.from_numpy(c0)})
    ja, jhid = jpub.act(jparams, jcfg, *jpub.sad_slice(jnp.asarray(s)), {"h0": jnp.asarray(h0), "c0": jnp.asarray(c0)})
    assert np.abs(ta.numpy() - np.asarray(ja)).max() <= TOL
    for k in ("h0", "c0"):
        assert thid[k].shape == (B, 2, hid)
        assert np.abs(thid[k].numpy() - np.asarray(jhid[k])).max() <= TOL


def test_sad_slice_matches_jax():
    s = np.arange(2 * 838, dtype=np.float32).reshape(2, 838)
    tpriv, tpubl = tpub.sad_slice(torch.from_numpy(s))
    jpriv, jpubl = jpub.sad_slice(jnp.asarray(s))
    assert tpriv.shape[-1] == 658 and tpubl.shape[-1] == 533
    np.testing.assert_array_equal(tpriv.numpy(), np.asarray(jpriv))
    np.testing.assert_array_equal(tpubl.numpy(), np.asarray(jpubl))


def test_load_obl_pthw_drops_the_strip_keys_as_jax(tmp_path):
    path = str(tmp_path / "obl.pthw")
    sd = np_obl_state_dict(4, hid=16, strip=True)
    torch.save(sd, path)
    tparams, tcfg = tpub.load_obl_pthw(path, device="cpu")
    jparams, jcfg = jpub.load_obl_pthw(path)
    assert dataclasses_equal(tcfg, jcfg) and tcfg.hid_dim == 16 and tcfg.num_priv_layer == 3
    tleaves, jleaves = jax.tree_util.tree_leaves(list(tparams)), jax.tree_util.tree_leaves(list(jparams))
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert t.is_contiguous() and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the state dict round trip keeps every tensor's bits, without the strip keys
    back = tpub.to_torch_state_dict(tparams)
    kept = {k: v for k, v in sd.items() if k not in tpub.OBL_STRIP_KEYS}
    assert sorted(back) == sorted(kept)
    for k in back:
        if k.startswith("lstm.bias"):
            assert torch.equal(back[k] * 2, kept[k.replace("_hh", "_ih")] + kept[k.replace("_ih", "_hh")])
        else:
            assert torch.equal(back[k], kept[k])


def test_full_width_obl_games_match_jax(tmp_path, capsys):
    """8 greedy games at OBL's published widths on JAX's decks: the same
    scores, and the same actions up to near ties of JAX's advantages."""
    path = str(tmp_path / "obl.pthw")
    torch.save(np_obl_state_dict(5, strip=True), path)
    jpol, tpol = jloaders.load_obl_model(path), tloaders.load_obl_model(path, device="cpu")
    P = 2
    jcfg = jenv.EnvConfig(game=JGameConfig(players=P), eps_list=(0.0,), max_len=-1, sad=True)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(11), i))(jnp.arange(N))
    decks = np.asarray(jax.vmap(lambda k: jenv.reset_state(jcfg, k).game.deck)(keys))
    run = jax.jit(functools.partial(
        jrunner.eval_rollout, agent_cfgs=[jpol.agent_cfg] * P, env_cfg=jcfg, num_steps=STEPS,
        act_fns=[jpol.act_fn] * P, return_actions=True,
    ))
    j_scores, j_done, j_applied, j_was_done = (np.asarray(x) for x in run(params_per_player=[jpol.params] * P,
                                                                           keys=keys))
    seen = []

    def recording_act(params, cfg, obs, hidden, generator):
        seen.append((obs["priv_s"][:, 0].numpy(), obs["legal_move"][:, 0].numpy()))
        return tpol.act_fn(params, cfg, obs, hidden, generator)

    tcfg = EnvConfig(game=GameConfig(players=P), eps_list=(0.0,), max_len=-1, sad=True)
    t_scores, t_done, t_applied, t_was_done = (x.numpy() for x in trunner.eval_rollout(
        [tpol.params] * P, [tpol.agent_cfg] * P, tcfg, torch.from_numpy(decks.copy()).long(), num_steps=STEPS,
        act_fns=[recording_act] * P, return_actions=True))
    assert j_done.all() and t_done.all()
    np.testing.assert_array_equal(t_scores, j_scores)
    np.testing.assert_array_equal(t_was_done, j_was_done)

    jparams, jnet_cfg = jpub.load_obl_pthw(path)
    act = jax.jit(lambda s, h: jpub.act(jparams, jnet_cfg, *jpub.sad_slice(s), h))
    hid = [{"h0": jnp.zeros((N, 2, 512)), "c0": jnp.zeros((N, 2, 512))} for _ in range(P)]
    near = near_tie_steps(act, seen, hid, STEPS, TIE)
    num_near, parted = check_actions_up_to_near_ties(t_applied, j_applied, j_was_done, near)
    with capsys.disabled():
        print(f"\nOBL near-tie steps: {num_near} of {int((~j_was_done).sum())} live steps; {parted} games parted")


def test_eval_model_cli_evaluates_an_obl_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "obl.pthw")
    torch.save(np_obl_state_dict(6, hid=32, strip=True), path)
    mean, sem, perfect = teval_model.main(["--paper", "obl", "--obl_path", path, "--num_game", "4",
                                           "--device", "cpu"])
    assert 0 <= mean <= 25 and sem >= 0 and 0 <= perfect <= 1
    assert "score: " in capsys.readouterr().out
    with pytest.raises(SystemExit):
        teval_model.main(["--paper", "obl", "--device", "cpu"])
