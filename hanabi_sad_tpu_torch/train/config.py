"""Training configuration (counterpart of `hanabi_sad_tpu/train/config.py`).

`TrainConfig`, `derived`, `generate_explore_eps`, `PRESETS` and `make_config`
are the JAX package's, field for field, so a flag line or a saved config
means the same in both packages. The port trains every mode of the JAX
trainer: VDN or IQL at 2-5 players in the continuous or the aligned rollout,
with Other-Play (`shuffle_color`) and shuffled observations, initial
priorities fused into the rollout, from a separate target forward or
online-online, `stacked_td` and `snapshot_sampling`, in float32 or bfloat16
compute, with `profile_chunks`, on one card or, with `multihost`, on W
data-parallel ranks: one process per GPU under torchrun, joined over
torch.distributed (`parallel/mesh.py`), which compute what one process
computes. num_envs, the derived batchsize and num_eval_game must then divide
by W.

The loop alternates a rollout chunk (num_envs envs, max_len steps) with
`num_update_per_chunk` gradient updates. The replay ratio, train frames per
generated frame, is num_update_per_chunk * batchsize / (num_envs *
players_per_item).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    save_dir: str = "exps/exp1"
    method: str = "vdn"  # "vdn" | "iql"
    shuffle_obs: bool = False
    shuffle_color: bool = False  # Other-Play
    pred_weight: float = 0.0  # aux own-hand loss weight (SAD-AUX)
    num_eps: int = 80

    load_model: str = ""

    seed: int = 10001
    gamma: float = 0.99
    eta: float = 0.9
    train_bomb: int = 0
    eval_bomb: int = 0
    sad: bool = False
    num_player: int = 2
    hand_size: int = 5

    lr: float = 6.25e-5
    # lr_final > 0 decays the lr linearly from lr to lr_final over
    # lr_decay_updates gradient steps (0 = the whole run), then holds it.
    lr_final: float = 0.0
    lr_decay_updates: int = 0
    adam_eps: float = 1.5e-4
    grad_clip: float = 50.0
    num_lstm_layer: int = 2
    rnn_hid_dim: int = 512
    num_fc_layer: int = 1
    skip_connect: bool = False
    compute_dtype: str = "float32"

    batchsize: int = 128
    num_epoch: int = 5000
    epoch_len: int = 1000
    num_update_between_sync: int = 2500

    multi_step: int = 3

    burn_in_frames: int = 80000
    replay_buffer_size: int = 2 ** 20
    priority_exponent: float = 0.6  # alpha
    priority_weight: float = 0.4  # beta
    max_len: int = 80

    act_base_eps: float = 0.4
    act_eps_alpha: float = 7.0

    num_envs: int = 1024  # parallel games per rollout chunk
    num_update_per_chunk: int = 16  # gradient steps between chunks
    # "continuous": envs auto-reset mid-chunk and episodes are re-assembled
    # from the step stream. "aligned": all envs reset per chunk and play one
    # padded episode (the JAX package's semantics reference).
    rollout_mode: str = "continuous"
    slots_per_env: int = 4  # continuous mode: completed-episode slots/env/chunk
    # Initial priorities from the online-target TD error (the reference's
    # compute_priority) ...
    continuous_exact_priority: bool = True
    # ... computed from a target-net step fused into the rollout
    # (r2d2_agent.act_with_target) rather than a separate sequence forward.
    exact_priority_in_rollout: bool = True
    # The learner's online and target forwards as full-q forwards read at
    # the taken and the greedy action (one stacked scan in the JAX package,
    # two calls in the port; the same numbers).
    stacked_td: bool = False
    # Draw a chunk's batches from the priorities as the collect left them.
    snapshot_sampling: bool = False
    # Loop unroll factors of the JAX package's compiled scans; they change no
    # number, and the port's eager loops ignore them.
    rollout_unroll: int = 1
    net_seq_unroll: int = 1
    num_eval_game: int = 1000
    eval_max_steps: int = 128  # > longest possible game; eval has no forced cap
    eval_freq_epochs: int = 1
    profile_chunks: int = 0
    multihost: bool = False

    def __post_init__(self):
        if self.method not in ("vdn", "iql"):
            raise ValueError(f"method must be 'vdn' or 'iql', got {self.method!r}")
        if self.rollout_mode not in ("aligned", "continuous"):
            raise ValueError(f"rollout_mode must be 'aligned' or 'continuous', got {self.rollout_mode!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {self.compute_dtype!r}")

    @property
    def vdn(self) -> bool:
        return self.method == "vdn"

    def derived(self) -> "TrainConfig":
        """VDN divides batch/buffer/burn-in by num_player (selfplay.py:103-106)."""
        if not self.vdn:
            return self
        return dataclasses.replace(
            self,
            batchsize=int(round(self.batchsize / self.num_player)),
            replay_buffer_size=self.replay_buffer_size // self.num_player,
            burn_in_frames=self.burn_in_frames // self.num_player,
        )


def generate_explore_eps(base_eps: float, alpha: float, num_env: int) -> Tuple[float, ...]:
    """eps_i = base ** (1 + i/(n-1) * alpha), zero-clamped (utils.py:367-379)."""
    if num_env == 1:
        return (0.0 if base_eps < 1e-6 else base_eps,)
    out = []
    for i in range(num_env):
        eps = base_eps ** (1 + i / (num_env - 1) * alpha)
        out.append(0.0 if eps < 1e-6 else eps)
    return tuple(out)


# Shell-preset hyperparameters of the reference launch scripts
# (pyhanabi/tools/*.sh). Common to all: lr 6.25e-5, adam eps 1.5e-5, grad
# clip 5, gamma .999, eps menu base .1 alpha 7, prioritized alpha .9 beta .6,
# buffer 2^17, batch 128.
_COMMON = dict(
    rollout_mode="continuous",
    act_base_eps=0.1,
    act_eps_alpha=7.0,
    lr=6.25e-5,
    adam_eps=1.5e-5,
    grad_clip=5.0,
    gamma=0.999,
    batchsize=128,
    replay_buffer_size=2 ** 17,
    burn_in_frames=10000,
    priority_exponent=0.9,
    priority_weight=0.6,
    epoch_len=1000,
    num_player=2,
    rnn_hid_dim=512,
    multi_step=3,
)

PRESETS: Dict[str, Dict] = {
    # tools/dev.sh: small smoke-test run (iql + sad + shuffle_color)
    "dev": dict(
        _COMMON,
        method="iql",
        sad=True,
        shuffle_color=True,
        burn_in_frames=5000,
        epoch_len=400,
        num_epoch=10,
        seed=1,
        num_envs=256,
        num_update_per_chunk=8,
        num_eval_game=200,
    ),
    # tools/iql_2player.sh
    "iql_2p": dict(_COMMON, method="iql", seed=9),
    # tools/vdn_2player.sh
    "vdn_2p": dict(_COMMON, method="vdn", seed=9),
    # tools/sad_2player.sh: the headline SAD config
    "sad_2p": dict(_COMMON, method="vdn", sad=True, seed=9),
    # tools/op_2player.sh: Other-Play VDN
    "op_2p": dict(_COMMON, method="vdn", shuffle_color=True, seed=9),
    # SAD + aux + Other-Play
    "sad_aux_op_2p": dict(
        _COMMON, method="vdn", sad=True, shuffle_color=True, pred_weight=0.25, seed=9
    ),
}


def make_config(preset: Optional[str] = None, **overrides) -> TrainConfig:
    base = dict(PRESETS[preset]) if preset else {}
    base.update(overrides)
    return TrainConfig(**base)


def parse_overrides(items) -> Dict[str, object]:
    """["key=value", ...] -> {key: value}, each value read as its
    TrainConfig field's type (a bool from 0/1/true/false). The fields are
    the JAX package's, so a script of either package can read its flags."""
    defaults, out = TrainConfig(), {}
    for item in items or []:
        key, value = item.split("=", 1)
        kind = type(getattr(defaults, key))
        out[key] = value.lower() in ("1", "true") if kind is bool else kind(value)
    return out
