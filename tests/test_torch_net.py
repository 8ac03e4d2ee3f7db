"""The port's checkpoint loader and R2D2 net (`hanabi_sad_tpu_torch.train.checkpoint`,
`models.r2d2_net`) against the JAX package, on the flagship SAD-AUX weights.

Both packages get the same weights: the JAX package's loader and
`from_jax_params` of the port's loader. Inputs are made with numpy from a
seed. Tolerance 1e-4 abs on advantages and Q: float32 products over
K = 838 and 1024 summed in another order."""

import collections
import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.models import r2d2_net as jnet
from hanabi_sad_tpu.train import checkpoint as jckpt
from hanabi_sad_tpu_torch.models import r2d2_net as tnet
from hanabi_sad_tpu_torch.train import checkpoint as tckpt

FLAGSHIP = str(Path(__file__).resolve().parents[1] / "docs/runs/sad_aux_r4_soup10.pkl")
TOL = 1e-4
JCFG = jnet.NetConfig(in_dim=838)
TCFG = tnet.NetConfig(in_dim=838)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_tree(jckpt.load(FLAGSHIP)["params"])
    tparams = tckpt.from_jax_params(tckpt.load(FLAGSHIP)["params"], device="cpu")
    return jparams, tparams


def jax_tree(p):
    conv = lambda t: {k: jnp.asarray(v) for k, v in t.items()}
    return jnet.R2D2NetParams(
        net=[conv(l) for l in p.net], lstm=[conv(l) for l in p.lstm],
        fc_v=conv(p.fc_v), fc_a=conv(p.fc_a), pred=conv(p.pred),
    )


def inputs(B, seed, T=None):
    rng = np.random.RandomState(seed)
    lead = (B,) if T is None else (T, B)
    priv_s = (rng.rand(*lead, 838) < 0.1).astype(np.float32)
    legal = (rng.rand(*lead, 21) < 0.4).astype(np.float32)
    legal[..., 20] = 1.0
    h0 = (0.5 * rng.randn(B, 2, 512)).astype(np.float32)
    c0 = (0.5 * rng.randn(B, 2, 512)).astype(np.float32)
    return priv_s, legal, h0, c0


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def test_load_equals_numpy_original():
    ours, theirs = tckpt.load(FLAGSHIP), jckpt.load(FLAGSHIP)
    assert type(ours["params"]).__module__ == "hanabi_sad_tpu_torch.models.r2d2_net"
    assert ours["config"] == theirs["config"]
    for field in tnet.R2D2NetParams._fields:
        a, b = getattr(ours["params"], field), getattr(theirs["params"], field)
        for la, lb in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            assert la.keys() == lb.keys()
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k])


def test_load_refuses_foreign_classes(tmp_path):
    path = tmp_path / "foreign.pkl"
    path.write_bytes(pickle.dumps({"kind": "train_state", "opt_state": collections.OrderedDict()}))
    with pytest.raises(pickle.UnpicklingError, match="train_state payloads"):
        tckpt.load(str(path))


@pytest.mark.parametrize("B", [1, 7])
def test_trunk_and_act(weights, B):
    jp, tp = weights
    priv_s, legal, h0, c0 = inputs(B, seed=B)
    close(tnet.trunk(tp, torch.from_numpy(priv_s)), jnet.trunk(jp, jnp.asarray(priv_s)))
    j_adv, j_hid = jnet.act(jp, JCFG, jnp.asarray(priv_s), {"h0": jnp.asarray(h0), "c0": jnp.asarray(c0)})
    t_adv, t_hid = tnet.act(tp, TCFG, torch.from_numpy(priv_s), {"h0": torch.from_numpy(h0), "c0": torch.from_numpy(c0)})
    close(t_adv, j_adv)
    close(t_hid["h0"], j_hid["h0"])
    close(t_hid["c0"], j_hid["c0"])
    j_a, j_v, _ = jnet.act_with_v(jp, JCFG, jnp.asarray(priv_s), {"h0": jnp.asarray(h0), "c0": jnp.asarray(c0)})
    t_a, t_v, _ = tnet.act_with_v(tp, TCFG, torch.from_numpy(priv_s), {"h0": torch.from_numpy(h0), "c0": torch.from_numpy(c0)})
    close(t_a, j_a)
    close(t_v, j_v)
    j_g, _ = jnet.greedy_act(jp, JCFG, jnp.asarray(priv_s), jnp.asarray(legal), {"h0": jnp.asarray(h0), "c0": jnp.asarray(c0)})
    t_g, _ = tnet.greedy_act(tp, TCFG, torch.from_numpy(priv_s), torch.from_numpy(legal), {"h0": torch.from_numpy(h0), "c0": torch.from_numpy(c0)})
    np.testing.assert_array_equal(t_g.numpy(), np.asarray(j_g))


def test_duel_keeps_mean_over_all_actions():
    rng = np.random.RandomState(0)
    v, a = rng.randn(4, 1).astype(np.float32), rng.randn(4, 21).astype(np.float32)
    legal = (rng.rand(4, 21) < 0.5).astype(np.float32)
    out = tnet.duel(torch.from_numpy(v), torch.from_numpy(a), torch.from_numpy(legal))
    close(out, jnet.duel(jnp.asarray(v), jnp.asarray(a), jnp.asarray(legal)), tol=1e-6)
    np.testing.assert_allclose(out.numpy(), v + a * legal - (a * legal).sum(-1, keepdims=True) / 21, atol=1e-6)


@pytest.mark.parametrize("with_hid", [False, True])
def test_forward(weights, with_hid):
    jp, tp = weights
    T, B = 5, 3
    priv_s, legal, h0, c0 = inputs(B, seed=11, T=T)
    action = np.random.RandomState(12).randint(0, 21, (T, B))
    jhid = thid = None
    if with_hid:
        jhid = {"h0": jnp.asarray(h0.transpose(1, 0, 2)), "c0": jnp.asarray(c0.transpose(1, 0, 2))}
        thid = {"h0": torch.from_numpy(h0.transpose(1, 0, 2).copy()), "c0": torch.from_numpy(c0.transpose(1, 0, 2).copy())}
    j_qa, j_g, j_q, j_o = jnet.forward(jp, JCFG, jnp.asarray(priv_s), jnp.asarray(legal), jnp.asarray(action), jhid)
    t_qa, t_g, t_q, t_o = tnet.forward(
        tp, TCFG, torch.from_numpy(priv_s), torch.from_numpy(legal), torch.from_numpy(action), thid
    )
    close(t_q, j_q)
    close(t_qa, j_qa)
    close(t_o, j_o)
    np.testing.assert_array_equal(t_g.numpy(), np.asarray(j_g))


@pytest.mark.parametrize("dtype,cdtype", [("float32", torch.float32), ("bfloat16", torch.bfloat16)])
def test_compute_dtype_names_the_torch_dtype(dtype, cdtype):
    assert tnet.NetConfig(in_dim=838, compute_dtype=dtype).cdtype == cdtype


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        tnet.NetConfig(in_dim=838, compute_dtype="float16")
