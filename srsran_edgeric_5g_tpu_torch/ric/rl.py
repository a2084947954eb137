"""muApp2 — RL training of the DL scheduling policy on a digital twin.

Port of ``srsran_edgeric_5g_tpu/ric/rl.py``, the counterpart of
edgeric-v2's training stack: the ``EdgeRIC`` gym env (stream_rl/envs/
edge_ric.py:19-114: [BL, CQI, MB] x UE observations, per-UE weight
actions, state/action delay deques, backlog + CQI dynamics, reward = bytes
transferred), the Gaussian MLP policy with ``select_action``
(models/mlp_policy.py, the exact torch API muApp1 loads checkpoints
against, muApp1:238), which ``ric.muapp.TorchWeightPolicy`` serves, and the
PPO update (core/ppo.py ``ppo_step``: clipped surrogate + value fit).

The twin's service model is the port's MAC math: a weight w becomes
``round(w * nof_prb)`` PRBs and drains ``TBS(n_prb, MCS(CQI))/8`` bytes.

``ppo_train`` runs its networks on ``device`` (the card by default) and
draws from its own generators, seeded as the reference seeds torch's
global one: on the CPU, with the same seed, its draws and its trained
weights are the reference's.  A trained policy saves with
``torch.save(policy, path)``, the checkpoint ``TorchWeightPolicy`` loads.
A policy trained by the JAX package crosses over through
``convert.policy_from_reference`` (its state dict, not its pickle).
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque

import numpy as np
import torch
import torch.nn as nn

from ..device import resolve_device
from ..mac.scheduler import mcs_from_cqi
from ..ran import tbs as tbs_mod


@functools.lru_cache(maxsize=None)
def _bytes_per_tti(n_prb: int, cqi: int) -> int:
    """Service capacity of an (n_prb, CQI) grant in bytes (12-symbol PDSCH,
    2 full DM-RS symbols, the PHY layout of this package)."""
    if n_prb <= 0:
        return 0
    m = mcs_from_cqi(cqi)
    if m is None:
        return 0
    return tbs_mod.tbs_for_alloc(n_prb, 12, 24, tbs_mod.mcs_config(m)) // 8


@dataclasses.dataclass
class EnvConfig:
    num_ues: int = 2
    nof_prb: int = 52
    horizon: int = 64                   # T (episode TTIs)
    max_len_backlog: int = 300_000      # bytes
    # per-UE Poisson arrival mean (bytes/TTI); scalar broadcasts
    arrival_bytes: tuple = (12_000, 12_000)
    # per-UE CQI random walk: (lo, hi) band each UE wanders in
    cqi_bands: tuple = ((3, 15), (3, 15))
    delay_state: int = 1                # observation delay (TTIs)
    delay_action: int = 1               # action delay (TTIs)
    media_bytes: float = 300_000.0      # the MB obs placeholder (muApp1)
    seed: int = 0


class EdgeRicSimEnv:
    """Digital twin of the EdgeRIC-scheduled cell (gym API, no gym dep).

    obs  = [BL_1, CQI_1, MB_1, ..., BL_n, CQI_n, MB_n]  (delayed)
    act  = per-UE weights in [0, 1] (normalized internally)
    rew  = total bytes transferred this TTI / 1e5
    The env draws from its own numpy generator, ``default_rng(cfg.seed)``.
    """

    def __init__(self, cfg: EnvConfig):
        # Broadcast scalar / short per-UE parameters to num_ues so the
        # 2-UE defaults work for any UE count.
        n = cfg.num_ues
        arr = np.broadcast_to(np.asarray(cfg.arrival_bytes).ravel()[:1]
                              if np.ndim(cfg.arrival_bytes) == 0
                              or len(np.atleast_1d(cfg.arrival_bytes)) != n
                              else cfg.arrival_bytes, (n,))
        bands = cfg.cqi_bands
        if len(bands) != n:
            bands = tuple(bands[i % len(bands)] for i in range(n))
        cfg = dataclasses.replace(cfg, arrival_bytes=tuple(int(a) for a in arr),
                                  cqi_bands=bands)
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.obs_dim = 3 * cfg.num_ues
        self.act_dim = cfg.num_ues
        self.t = 0
        self.backlogs = np.zeros(cfg.num_ues)
        self.cqis = np.ones(cfg.num_ues, dtype=int)
        self._state_hist: deque = deque(maxlen=cfg.delay_state + 1)
        self._action_hist: deque = deque(maxlen=cfg.delay_action + 1)

    def _obs(self) -> np.ndarray:
        return np.array([v for u in range(self.cfg.num_ues)
                         for v in (self.backlogs[u], self.cqis[u],
                                   self.cfg.media_bytes)], dtype=np.float32)

    def reset(self) -> np.ndarray:
        c = self.cfg
        self.t = 0
        self.backlogs = np.zeros(c.num_ues)
        self.cqis = np.array([self.rng.integers(lo, hi + 1)
                              for lo, hi in c.cqi_bands])
        self._state_hist.clear()
        self._action_hist.clear()
        for _ in range(c.delay_state + 1):
            self._state_hist.append(self._obs())
        for _ in range(c.delay_action + 1):
            self._action_hist.append(np.full(c.num_ues, 1.0 / c.num_ues))
        return self._state_hist[0]

    def step(self, action: np.ndarray):
        c = self.cfg
        # Action delay: the RAN applies the policy computed delay_action
        # TTIs ago (edge_ric.py action_history deque).
        self._action_hist.append(np.asarray(action, dtype=float))
        w = np.clip(self._action_hist[0], 1e-8, 1.0)
        w = w / w.sum()
        self.t += 1

        # Arrivals, then service by the allocation law.
        arr = self.rng.poisson(np.broadcast_to(c.arrival_bytes, (c.num_ues,)))
        self.backlogs = np.minimum(self.backlogs + arr, c.max_len_backlog)
        served = 0.0
        for u in range(c.num_ues):
            cap = _bytes_per_tti(int(round(w[u] * c.nof_prb)),
                                 int(self.cqis[u]))
            tx = min(cap, self.backlogs[u])
            self.backlogs[u] -= tx
            served += tx

        # CQI random walk inside each UE's band.
        for u, (lo, hi) in enumerate(c.cqi_bands):
            self.cqis[u] = int(np.clip(self.cqis[u]
                                       + self.rng.integers(-1, 2), lo, hi))

        reward = served / 1e5
        self._state_hist.append(self._obs())
        done = self.t >= c.horizon
        return self._state_hist[0], reward, done, {"served_bytes": served}


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


def build_value(state_dim: int, hidden=(64, 64)) -> nn.Sequential:
    mods: list = []
    last = state_dim
    for nh in hidden:
        mods += [nn.Linear(last, nh), nn.Tanh()]
        last = nh
    mods.append(nn.Linear(last, 1))
    return nn.Sequential(*mods)


def estimate_advantages(rewards, masks, values, gamma=0.99, tau=0.95):
    """GAE (core/common.py estimate_advantages)."""
    adv = torch.zeros_like(rewards)
    prev_value = prev_adv = 0.0
    for i in reversed(range(rewards.shape[0])):
        delta = rewards[i] + gamma * prev_value * masks[i] - values[i]
        adv[i] = delta + gamma * tau * prev_adv * masks[i]
        prev_value, prev_adv = values[i], adv[i]
    returns = adv + values
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    return adv, returns


def seeded_init(seed: int, build, dev: torch.device):
    """``build()``'s modules initialised as after ``torch.manual_seed(seed)``
    (the reference's global seeding), without touching the global
    generator, and moved to ``dev``; with a generator on ``dev`` that
    continues the seeded CPU stream when ``dev`` is the CPU (seeded with
    ``seed`` on a card)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = build()
        state = torch.get_rng_state()
    gen = torch.Generator(device=dev)
    if dev.type == "cpu":
        gen.set_state(state)
    else:
        gen.manual_seed(seed)
    return [n.to(dev) for n in nets], gen


def ppo_train(env: EdgeRicSimEnv, iterations: int = 30,
              batch_steps: int = 1024, clip_eps: float = 0.2,
              lr: float = 1e-3, value_iters: int = 3,
              policy_epochs: int = 8, seed: int = 0,
              device: str | torch.device = "cuda"):
    """Collect-update PPO loop (muApp2's agent.collect_samples ->
    ppo_step) with its networks on ``device``.  Returns (policy,
    per-iteration mean episode rewards); the policy carries its observation
    scale as ``obs_scale``."""
    dev = resolve_device(device)
    (policy, value), gen = seeded_init(
        seed, lambda: (build_policy(env.obs_dim, env.act_dim),
                       build_value(env.obs_dim)), dev)
    opt_p = torch.optim.Adam(policy.parameters(), lr=lr)
    opt_v = torch.optim.Adam(value.parameters(), lr=lr)
    obs_scale = np.array([1e-5, 1 / 15.0, 1e-6] * env.cfg.num_ues,
                         dtype=np.float32)
    # The checkpoint carries the per-feature [BL, CQI, MB] normalisation:
    # TorchWeightPolicy applies it, so serving sees the training features.
    policy.obs_scale = obs_scale[:3].copy()
    history = []
    for _ in range(iterations):
        S, A, R, M = [], [], [], []
        ep_rewards, ep_sum = [], 0.0
        s = env.reset() * obs_scale
        for _ in range(batch_steps):
            st = torch.as_tensor(s, device=dev).unsqueeze(0)
            with torch.no_grad():
                a = policy.select_action(st, generator=gen)[0].cpu().numpy()
            s2, r, done, _ = env.step(a)
            S.append(s)
            A.append(a)
            R.append(r)
            M.append(0.0 if done else 1.0)
            ep_sum += r
            s = (env.reset() if done else s2) * obs_scale
            if done:
                ep_rewards.append(ep_sum)
                ep_sum = 0.0
        history.append(float(np.mean(ep_rewards)) if ep_rewards else ep_sum)
        states = torch.as_tensor(np.array(S), device=dev)
        actions = torch.as_tensor(np.array(A, dtype=np.float32), device=dev)
        rewards = torch.as_tensor(np.array(R, dtype=np.float32), device=dev).unsqueeze(1)
        masks = torch.as_tensor(np.array(M, dtype=np.float32), device=dev).unsqueeze(1)
        with torch.no_grad():
            values = value(states)
            fixed_lp = policy.get_log_prob(states, actions)
        adv, returns = estimate_advantages(rewards, masks, values)
        # ppo_step: the value fit, then clipped policy epochs over the batch.
        for _ in range(value_iters):
            v_loss = (value(states) - returns).pow(2).mean()
            opt_v.zero_grad()
            v_loss.backward()
            opt_v.step()
        for _ in range(policy_epochs):
            lp = policy.get_log_prob(states, actions)
            ratio = torch.exp(lp - fixed_lp)
            surr = -torch.min(ratio * adv,
                              torch.clamp(ratio, 1 - clip_eps,
                                          1 + clip_eps) * adv).mean()
            opt_p.zero_grad()
            surr.backward()
            torch.nn.utils.clip_grad_norm_(policy.parameters(), 40)
            opt_p.step()
    return policy, history


def evaluate(env: EdgeRicSimEnv, weight_fn, episodes: int = 10) -> float:
    """Mean episode reward of a {obs -> weights ndarray} policy."""
    total = 0.0
    for _ in range(episodes):
        s = env.reset()
        done = False
        while not done:
            s, r, done, _ = env.step(weight_fn(s))
            total += r
    return total / episodes
