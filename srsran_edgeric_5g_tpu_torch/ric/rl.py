"""muApp2's policy network — the serving half.

Port of the serving half of ``srsran_edgeric_5g_tpu/ric/rl.py``: the
Gaussian MLP policy with ``select_action`` (edgeric-v2 models/mlp_policy.py,
the exact torch API muApp1 loads checkpoints against, muApp1:238), which
``ric.muapp.TorchWeightPolicy`` serves.  The training half (the digital
twin ``EdgeRicSimEnv``, ``ppo_train``, ``build_value``,
``estimate_advantages``, ``evaluate``) is not ported yet.

A policy trained by the JAX package crosses over through
``convert.policy_from_reference`` (its state dict, not its pickle).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


class Policy(nn.Module):
    """Gaussian MLP policy exposing the muApp1 checkpoint API:
    forward -> (mean, log_std, std); select_action(x) samples.  Module-level
    so torch.save/load round-trips whole-object checkpoints the way muApp1
    consumes model_demo.pt (muApp1:238)."""

    def __init__(self, state_dim: int, action_dim: int, hidden=(64, 64),
                 log_std: float = 0.0):
        super().__init__()
        self.is_disc_action = False
        layers, last = [], state_dim
        for nh in hidden:
            layers.append(nn.Linear(last, nh))
            last = nh
        self.affine_layers = nn.ModuleList(layers)
        self.action_mean = nn.Linear(last, action_dim)
        self.action_mean.weight.data.mul_(0.1)
        self.action_mean.bias.data.mul_(0.0)
        self.action_log_std = nn.Parameter(
            torch.ones(1, action_dim) * log_std)

    def forward(self, x):
        for affine in self.affine_layers:
            x = torch.tanh(affine(x))
        mean = self.action_mean(x)
        log_std = self.action_log_std.expand_as(mean)
        return mean, log_std, torch.exp(log_std)

    def select_action(self, x, deterministic: bool = False,
                      generator: torch.Generator | None = None):
        """A sampled action (the mean when ``deterministic``), squashed to
        [0, 1].  ``generator`` draws the sample (the reference draws from
        torch's global generator, which None keeps)."""
        mean, _, std = self.forward(x)
        a = mean if deterministic else torch.normal(mean, std,
                                                    generator=generator)
        # weights live in [0,1]; the sigmoid squash keeps muApp1's
        # "action / sum(action)" normalization meaningful
        return torch.sigmoid(a)

    def get_log_prob(self, x, actions):
        mean, log_std, std = self.forward(x)
        # invert the sigmoid squash for the pre-squash sample (the squash
        # jacobian depends only on the action, so it cancels in PPO ratios)
        z = torch.logit(actions.clamp(1e-6, 1 - 1e-6))
        var = std.pow(2)
        lp = (-(z - mean).pow(2) / (2 * var) - 0.5 * np.log(2 * np.pi)
              - log_std)
        return lp.sum(dim=1, keepdim=True)


def build_policy(state_dim: int, action_dim: int, hidden=(64, 64),
                 log_std: float = 0.0) -> Policy:
    return Policy(state_dim, action_dim, hidden, log_std)
