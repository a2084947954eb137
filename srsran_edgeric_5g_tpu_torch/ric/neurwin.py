"""muApp4 — NeurWIN: neural Whittle-index scheduling (restless bandits).

Port of ``srsran_edgeric_5g_tpu/ric/neurwin.py`` (edgeric-v2/muApp4
neurwin.py, the NEURWIN trainer, and windex_demo_muapp.py):

  * Each UE is one restless arm with state [backlog, CQI]; an index network
    maps the normalized state to a scalar Whittle index.
  * ``neurwin_train`` follows the reference's algorithm (neurwin.py:215-245
    takeAction, :320-378 gradient batching): per mini-batch, freeze the
    index of a random state as the activation cost lambda; act with
    probability sigmoid(m * (index - lambda)); accumulate d log pi per
    episode; charge the activation cost (reward -= action * lambda / 1000);
    weight each episode's gradient by its negated discounted return minus
    the batch mean, clip to 100 and Adam-step.  The network lives on
    ``device`` (the card by default), its initialisation is seeded as the
    reference seeds torch's global generator, and the actions draw from
    ``np.random.RandomState(seed)``: on the CPU the trained weights are the
    reference's.
  * ``WhittleIndexPolicy`` is the windex demo's muApp loop: per-UE index
    from the live metrics (empty backlog -> -100), highest index gets the
    2-share, second the 1-share, the rest 0, mapped to muApp1 scheduling
    weights.

Checkpoints are ``save_checkpoint``'s dict of tensors, so one written by
the JAX package loads here.  The arm environment reuses the digital twin's
service model (``ric.rl._bytes_per_tti``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .rl import _bytes_per_tti, seeded_init

OBS_SCALE = np.array([1e-5, 1 / 15.0], dtype=np.float32)  # [backlog, cqi]


@dataclasses.dataclass
class ArmConfig:
    """One restless arm (single UE offered the whole band when active)."""

    nof_prb: int = 52
    horizon: int = 24                  # episode TTIs
    arrival_bytes: int = 8_000         # Poisson mean per TTI
    max_len_backlog: int = 300_000
    cqi_band: tuple = (3, 15)
    seed: int = 0


class ArmEnv:
    """gym-style single-arm env: action 1 = schedule this UE this TTI."""

    def __init__(self, cfg: ArmConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.state_size = 2
        self.t = 0
        self.backlog = 0.0
        self.cqi = cfg.cqi_band[0]

    def _obs(self) -> np.ndarray:
        return (np.array([self.backlog, self.cqi], dtype=np.float32)
                * OBS_SCALE)

    def reset(self) -> np.ndarray:
        c = self.cfg
        self.t = 0
        self.backlog = float(self.rng.integers(0, c.max_len_backlog // 3))
        self.cqi = int(self.rng.integers(c.cqi_band[0], c.cqi_band[1] + 1))
        return self._obs()

    def random_state(self) -> np.ndarray:
        """A uniformly random normalized state (the reference's
        observation_space.sample() / env.normalizer, neurwin.py:200-207)."""
        c = self.cfg
        bl = float(self.rng.integers(0, c.max_len_backlog + 1))
        cqi = float(self.rng.integers(c.cqi_band[0], c.cqi_band[1] + 1))
        return np.array([bl, cqi], dtype=np.float32) * OBS_SCALE

    def step(self, action: int):
        c = self.cfg
        self.t += 1
        self.backlog = min(self.backlog + self.rng.poisson(c.arrival_bytes),
                           c.max_len_backlog)
        served = 0.0
        if action:
            cap = _bytes_per_tti(c.nof_prb, int(self.cqi))
            served = min(cap, self.backlog)
            self.backlog -= served
        self.cqi = int(np.clip(self.cqi + self.rng.integers(-1, 2),
                               c.cqi_band[0], c.cqi_band[1]))
        reward = served / 1e5
        return self._obs(), reward, self.t >= c.horizon, {"served": served}


class IndexNet(nn.Module):
    """The reference fcnn (neurwin.py:21-52): state -> scalar index,
    32/8/1 ReLU MLP."""

    def __init__(self, state_size: int = 2):
        super().__init__()
        self.linear1 = nn.Linear(state_size, 32, bias=True)
        self.linear2 = nn.Linear(32, 8)
        self.linear3 = nn.Linear(8, 1, bias=True)

    def forward(self, x):
        if not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x, dtype=np.float32),
                                device=self.linear1.weight.device)
        x = F.relu(self.linear1(x))
        x = F.relu(self.linear2(x))
        return self.linear3(x)


def neurwin_train(env: ArmEnv, episodes: int = 600, batch_size: int = 10,
                  lr: float = 1e-3, sigmoid_param: float = 5.0,
                  gamma: float = 0.99, seed: int = 0,
                  device: str | torch.device = "cuda") -> tuple[IndexNet, list]:
    """The NEURWIN.learn() loop on ``device``.  Returns (net, per-episode
    rewards)."""
    dev = resolve_device(device)
    (net,), _ = seeded_init(seed, lambda: (IndexNet(env.state_size),), dev)
    g = np.random.RandomState(seed)
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    params = list(net.parameters())
    opt.zero_grad(set_to_none=False)

    ep_grads: list[list[torch.Tensor]] = []
    disc_returns: list[float] = []
    history: list[float] = []
    cost = 0.0

    for ep in range(episodes):
        if ep % batch_size == 0:
            # New mini-batch: freeze the activation cost at the net's index
            # of a random state (newMiniBatchReset).
            with torch.no_grad():
                cost = float(net.forward(env.random_state())[0])
        s = env.reset()
        rewards = []
        done = False
        while not done:
            index = net.forward(s)
            prob_one = torch.sigmoid(sigmoid_param * (index - cost))
            p1 = float(prob_one.detach()[0])
            action = int(g.choice([1, 0], p=[p1, 1.0 - p1]))
            logp = torch.log(prob_one if action else 1.0 - prob_one)
            logp.backward()          # accumulates into .grad (takeAction)
            s, r, done, _ = env.step(action)
            rewards.append(r - action * cost / 1000.0)
        history.append(float(np.sum(rewards)))
        # Negated discounted return (the reference's _discountRewards).
        disc_returns.append(-float(np.sum(
            [gamma ** i * r for i, r in enumerate(rewards)])))
        ep_grads.append([p.grad.clone() for p in params])
        opt.zero_grad(set_to_none=False)

        if len(ep_grads) == batch_size:
            mean_r = float(np.mean(disc_returns))
            for gr, dr in zip(ep_grads, disc_returns):
                for p, gi in zip(params, gr):
                    p.grad += (dr - mean_r) * gi
            torch.nn.utils.clip_grad_norm_(net.parameters(), 100)
            opt.step()
            opt.zero_grad(set_to_none=False)
            ep_grads, disc_returns = [], []
    return net, history


def save_checkpoint(net: IndexNet, path: str) -> None:
    torch.save({"state_dict": net.state_dict(),
                "state_size": net.linear1.in_features,
                "obs_scale": OBS_SCALE}, path)


def load_checkpoint(path: str) -> IndexNet:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    net = IndexNet(ckpt["state_size"])
    net.load_state_dict(ckpt["state_dict"])
    net.eval()
    return net


class WhittleIndexPolicy:
    """muApp1-pluggable policy: per-UE Whittle indices -> weights.

    Index ranking maps to the windex demo's 2/1/0 action shares
    (get_whittle_action), converted to scheduling weights by normalizing
    (share + 0.1): top UE ~0.55, runner-up ~0.29, rest split the floor.
    UEs with empty DL backlog get index -100 (windex_demo:237).
    """

    def __init__(self, model_path_or_net, buffer_key: str = "ul_buffer"):
        self.net = (model_path_or_net if isinstance(model_path_or_net,
                                                    IndexNet)
                    else load_checkpoint(model_path_or_net))
        self.buffer_key = buffer_key

    def indices(self, ue_data) -> dict[int, float]:
        out = {}
        with torch.no_grad():
            for r, d in ue_data.items():
                if d[self.buffer_key] <= 0:
                    out[r] = -100.0
                    continue
                s = np.array([d[self.buffer_key], d["cqi"]],
                             dtype=np.float32) * OBS_SCALE
                out[r] = float(self.net.forward(s)[0])
        return out

    def __call__(self, ue_data) -> dict[int, float]:
        idx = self.indices(ue_data)
        order = sorted(idx, key=idx.get, reverse=True)
        shares = {r: 0.0 for r in idx}
        if order:
            shares[order[0]] = 2.0
        if len(order) > 1:
            shares[order[1]] = 1.0
        w = np.array([shares[r] + 0.1 for r in ue_data], dtype=float)
        w = w / w.sum()
        return dict(zip(ue_data, w))
