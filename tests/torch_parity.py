"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: the same inputs, made with numpy from a seed, in both packages'
types."""

import jax.numpy as jnp
import numpy as np
import torch

from hanabi_sad_tpu.agent import r2d2_agent as jagent
from hanabi_sad_tpu.models import r2d2_net as jnet
from hanabi_sad_tpu_torch.agent import r2d2_agent as tagent
from hanabi_sad_tpu_torch.game import env as tenv
from hanabi_sad_tpu_torch.game import state as tstate
from hanabi_sad_tpu_torch.models import r2d2_net as tnet


def np_net(in_dim, hid, out_dim, hand_size, layers, seed):
    """R2D2 net params as numpy arrays (Linear w [in, out], one LSTM bias)."""
    rng = np.random.RandomState(seed)

    def lin(d_in, d_out):
        k = 1 / np.sqrt(d_in)
        return {"w": rng.uniform(-k, k, (d_in, d_out)).astype(np.float32),
                "b": rng.uniform(-k, k, (d_out,)).astype(np.float32)}

    k = 1 / np.sqrt(hid)
    lstm = [
        {"w_ih": rng.uniform(-k, k, (hid, 4 * hid)).astype(np.float32),
         "w_hh": rng.uniform(-k, k, (hid, 4 * hid)).astype(np.float32),
         "b": rng.uniform(-2 * k, 2 * k, (4 * hid,)).astype(np.float32)}
        for _ in range(layers)
    ]
    return {"net": [lin(in_dim, hid)], "lstm": lstm, "fc_v": lin(hid, 1),
            "fc_a": lin(hid, out_dim), "pred": lin(hid, hand_size * 3)}


def jax_net(p):
    conv = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    return jnet.R2D2NetParams(net=[conv(l) for l in p["net"]], lstm=[conv(l) for l in p["lstm"]],
                              fc_v=conv(p["fc_v"]), fc_a=conv(p["fc_a"]), pred=conv(p["pred"]))


def torch_net(p):
    conv = lambda d: {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in d.items()}
    return tnet.R2D2NetParams(net=[conv(l) for l in p["net"]], lstm=[conv(l) for l in p["lstm"]],
                              fc_v=conv(p["fc_v"]), fc_a=conv(p["fc_a"]), pred=conv(p["pred"]))


def agent_params(online, target):
    """(JAX AgentParams, port AgentParams) from two numpy nets."""
    return (jagent.AgentParams(online=jax_net(online), target=jax_net(target)),
            tagent.AgentParams(online=torch_net(online), target=torch_net(target)))


def np_batch(T, B, Pi, F, A, hand_size, seed):
    """A learner Batch as a dict of numpy arrays, time-major."""
    rng = np.random.RandomState(seed)
    legal = (rng.rand(T, B, Pi, A) < 0.4).astype(np.float32)
    legal[..., A - 1] = 1.0
    action = np.zeros((T, B, Pi), np.int32)
    for idx in np.ndindex(T, B, Pi):
        action[idx] = rng.choice(np.flatnonzero(legal[idx]))
    slot = rng.randint(0, 4, (T, B, Pi, hand_size))  # 3 = empty slot
    own_hand = (slot[..., None] == np.arange(3)).astype(np.float32).reshape(T, B, Pi, hand_size * 3)
    seq_len = rng.randint(2, T + 1, (B,)).astype(np.float32)
    t = np.arange(T)[:, None]
    return {
        "priv_s": (rng.rand(T, B, Pi, F) < 0.2).astype(np.float32),
        "legal_move": legal,
        "action": action,
        "own_hand": own_hand,
        "reward": rng.randn(T, B).astype(np.float32),
        "terminal": (t >= seq_len[None] - 1).astype(np.float32),
        "bootstrap": (t < seq_len[None] - 3).astype(np.float32),
        "seq_len": seq_len,
    }


def batches(b):
    """(JAX Batch, port Batch) from np_batch's dict."""
    jb = jagent.Batch(**{k: jnp.asarray(v) for k, v in b.items()})
    tb = tagent.Batch(**{k: torch.from_numpy(v.astype(np.int64) if k == "action" else v) for k, v in b.items()})
    return jb, tb


def to_torch_tree(x, template):
    """A JAX NamedTuple of arrays onto the port's NamedTuple type with the
    same field names (extra JAX fields dropped): bools stay bool, ints become
    int64, floats float32."""
    if hasattr(template, "_fields"):
        return template(**{f: to_torch_tree(getattr(x, f), _field_type(template, f)) for f in template._fields})
    a = np.asarray(x)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.astype(np.float32))


_NESTED = {
    (tenv.EnvState, "game"): tstate.GameState,
    (tenv.EnvState, "sad_record"): tstate.LastAction,
    (tstate.GameState, "last"): tstate.LastAction,
}


def _field_type(template, field):
    return _NESTED.get((template, field))


def port_env_state(jstate):
    """A batched JAX EnvState as the port's EnvState."""
    return to_torch_tree(jstate, tenv.EnvState)


def near_tie_steps(adv_fn, seen, hids, steps, tie):
    """[steps, N] bool: where the acting seat's top two legal advantages lie
    within `tie` of each other (float32 sums in another order may break such
    a tie the other way). `seen` holds the (priv_s, legal) of every act call
    of a greedy eval, step-major and seat-minor; `adv_fn(priv_s, hid) ->
    (adv, hid)` is the JAX net's act, run from `hids` (one per seat) along
    those observations. The players move in turn from seat 0."""
    P = len(hids)
    N = seen[0][0].shape[0]
    near = np.zeros((steps, N), bool)
    for t in range(steps):
        advs = []
        for p in range(P):
            priv_s, legal = seen[P * t + p]
            adv, hids[p] = adv_fn(jnp.asarray(priv_s), hids[p])
            advs.append(np.where(legal > 0, np.asarray(adv), -np.inf))
        top2 = -np.sort(-advs[t % P], axis=1)[:, :2]
        near[t] = np.isfinite(top2[:, 1]) & (top2[:, 0] - top2[:, 1] < tie)
    return near


def check_actions_up_to_near_ties(t_applied, j_applied, j_was_done, near):
    """Each game's applied actions [T, N] equal JAX's over its live steps up
    to its first difference, which must lie at a near tie (the games part
    ways there). Returns (live near-tie steps, games that parted)."""
    live = ~j_was_done
    parted = 0
    for i in range(live.shape[1]):
        for t in np.where(live[:, i])[0]:
            if t_applied[t, i] != j_applied[t, i]:
                assert near[t, i], f"game {i} step {t}: {t_applied[t, i]} vs {j_applied[t, i]}"
                parted += 1
                break
    return int((near & live).sum()), parted
