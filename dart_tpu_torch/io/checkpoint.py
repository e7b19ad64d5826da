"""PPO policy checkpoints (port of `dart_tpu.io.checkpoint`): the
reference's torch scheme, `best_agent.pth` / `latest_agent.pth`
(`rlmpc2.py:917-922`). `save_agent` writes `<dir>/<name>.pt`, a
`torch.save` of {"model": the ActorCritic's state_dict, "optimizer": its
optimizer's state_dict, "episode", "return"}. Latest is saved at every
episode boundary and best on return improvement; evaluation loads best
and falls back to training when it is absent (`rlmpc2.py:574-578`).

JAX writes Orbax directories (`<dir>/best_agent/`), so both packages can
share one checkpoint directory; `tests/test_torch_ppo.py` converts the
committed Orbax tuners to `.pt` files beside them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def _path(d: str, name: str) -> str:
    return os.path.join(os.path.abspath(d), f"{name}.pt")


def save_agent(checkpoint_dir: str, name: str, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer, episode: int,
               episode_return: float):
    """Save {model, optimizer, episode, return} (the reference's dict)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "episode": int(episode), "return": float(episode_return)},
               _path(checkpoint_dir, name))


class CheckpointManager:
    """best/latest tracking (`rlmpc2.py:917-922`)."""

    def __init__(self, checkpoint_dir: str):
        self.dir = checkpoint_dir
        self.best_return = -float("inf")

    def on_episode_end(self, model, optimizer, episode: int,
                       episode_return: float):
        if episode_return > self.best_return:
            self.best_return = episode_return
            save_agent(self.dir, "best_agent", model, optimizer, episode,
                       episode_return)
        save_agent(self.dir, "latest_agent", model, optimizer, episode,
                   episode_return)


def load_agent(checkpoint_dir: str,
               name: str = "best_agent") -> Optional[dict]:
    """The saved dict (tensors on the CPU), or None if absent (eval falls
    back to training mode, `rlmpc2.py:574-578`)."""
    path = _path(checkpoint_dir, name)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)
