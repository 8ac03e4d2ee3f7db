"""Tests of the port that need a CUDA card (marker `cuda`); they skip without
one. This file imports neither jax nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.state import shuffled_decks
from hanabi_sad_tpu_torch.models import lstm as tlstm
from hanabi_sad_tpu_torch.ops.lstm_seq import lstm_seq_kernel, lstm_seq_plain
from hanabi_sad_tpu_torch.tools import loaders
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
    assert lstm_seq_kernel.launches == launches + T * len(params)
    for a, b in ((out, ref), (h, rh), (c, rc)):
        assert float((a - b).abs().max()) <= 1e-4


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
