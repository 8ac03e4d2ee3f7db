"""Whether one learner update of the PyTorch port gives the same bits twice
on the card, and which of its ops PyTorch names as nondeterministic.

    python scripts/torch_update_determinism.py

Warm-starts the flagship SAD-AUX preset (`sad_2p`, `pred_weight 0.25`,
float32, 1024 envs) from docs/runs/sad_aux_r4_soup10.pkl, as chip_smoke.py's
train phase does, collects one chunk and presamples one batch. Then it runs
`learner.sgd_update` three times from copies of that one state on that one
batch: twice as it is, and once under
`torch.use_deterministic_algorithms(True, warn_only=True)`, whose warnings
name each op of the update that has no deterministic CUDA implementation
(the port's own kernels are not PyTorch ops and are not named). It prints
one JSON line: the loss and grad_norm of each run, whether each updated
parameter tensor of the two plain runs is equal bit for bit, and the
warnings. Needs a CUDA card.
"""

import json
import subprocess
import warnings

import torch

from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentParams, clone_params
from hanabi_sad_tpu_torch.replay import prioritized as replay_mod
from hanabi_sad_tpu_torch.train import learner, selfplay
from hanabi_sad_tpu_torch.train.config import make_config
from hanabi_sad_tpu_torch.train.optim import AdamState

FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()
    dev = torch.device("cuda")
    setup = learner.make_setup(make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048))
    state = learner.init_train_state(setup, setup.train.seed, dev)
    state = state._replace(params=selfplay.load_model(FLAGSHIP, dev))
    optimizer = learner.make_optimizer(setup.train)
    state, _ = learner.collect_only(setup, state)
    idx, is_w = replay_mod.sample_indices(state.replay, setup.replay, setup.train.batchsize,
                                          generator=torch.Generator(device=dev).manual_seed(4))
    rows = replay_mod.gather_rows(state.replay, idx)

    def update():
        opt = state.opt_state
        copy = state._replace(
            params=AgentParams(online=clone_params(state.params.online), target=clone_params(state.params.target)),
            opt_state=AdamState(mu=[m.clone() for m in opt.mu], nu=[v.clone() for v in opt.nu], count=opt.count),
            replay=state.replay._replace(weight=state.replay.weight.clone()),
        )
        new, metrics = learner.sgd_update(setup, optimizer, copy, presampled=(rows, is_w, idx))
        torch.cuda.synchronize()
        return learner.param_leaves(new.params.online), {k: float(metrics[k]) for k in ("loss", "grad_norm")}

    first, m1 = update()
    second, m2 = update()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, m3 = update()
    torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split("\n")[0][:200] for w in caught})
    print(json.dumps({
        "metrics": [m1, m2, m3],
        "params_equal": [bool(torch.equal(a, b)) for a, b in zip(first, second)],
        "params_max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(first, second)),
        "nondeterministic_ops": named,
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
