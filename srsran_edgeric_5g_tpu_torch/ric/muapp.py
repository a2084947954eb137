"""muApp1 — per-TTI DL scheduling-weight policies.

Port of ``srsran_edgeric_5g_tpu/ric/muapp.py``.

Counterpart of edgeric-v2/muApp1/muApp1_run_DL_scheduling.py:79-275: each
policy maps the latest UE metrics to {rnti: weight}; the RAN turns a weight
into ``n_prbs = w * unused_crbs`` (ue_cell_grid_allocator.cpp:296-305).

All policies are pure functions of ``ue_data`` ({rnti: {cqi, ul_buffer,
...}}, the messenger's dict form) plus explicit carried state where the
reference uses globals (prop-fair's averaged CQIs, round-robin's counter).
They reproduce the reference's exact shapes: the 0.1/"1 - (n-1)*0.1"
high/low split, the CQI*backlog max-weight product, the gamma=0.1 CQI
EWMA, and the all-equal fallback whenever any CQI is 0.

The reference switches the live algorithm through a redis key
(muApp1:300); ``MuAppScheduler.algorithm`` is that knob (redis itself is
external infrastructure, deliberately not required here).
"""

from __future__ import annotations

import numpy as np

from .messenger import RicMessenger


def _equal(ue_data) -> dict[int, float]:
    n = max(len(ue_data), 1)
    return {r: 1.0 / n for r in ue_data}


def fixed_weights(ue_data) -> dict[int, float]:
    """0.3 / 0.7 for the first two UEs (muApp1 fixed_weights)."""
    out = {}
    for i, r in enumerate(ue_data):
        out[r] = 0.3 if i == 0 else 0.7 if i == 1 else 1.0 / len(ue_data)
    return out


def max_cqi_weights(ue_data) -> dict[int, float]:
    """Best-CQI UE gets 1-(n-1)*0.1, the rest 0.1 (algo1_maxCQI_multi)."""
    cqis = [d["cqi"] for d in ue_data.values()]
    if not cqis or min(cqis) <= 0:
        return _equal(ue_data)
    n = len(ue_data)
    best = int(np.argmax(cqis))
    high, low = 1 - (n - 1) * 0.1, 0.1
    return {r: (high if i == best else low)
            for i, r in enumerate(ue_data)}


def max_weight_weights(ue_data) -> dict[int, float]:
    """w_i ∝ (CQI_i/ΣCQI)·(BL_i/ΣBL) — backlog×channel MaxWeight
    (algo2_maxWeight_multi; BL = ul_buffer per the reference)."""
    cqis = np.array([d["cqi"] for d in ue_data.values()], dtype=float)
    bls = np.array([d["ul_buffer"] for d in ue_data.values()], dtype=float)
    if len(cqis) == 0 or cqis.min() <= 0:
        return _equal(ue_data)
    w = cqis / cqis.sum()
    if bls.sum() > 0:
        w = w * (bls / bls.sum())
    return dict(zip(ue_data, w))


def prop_fair_weights(ue_data, avg_cqis: dict[int, float],
                      gamma: float = 0.1):
    """w_i ∝ CQI_i / EWMA(CQI_i); returns (weights, updated avg_cqis)
    (algo3_propFair_multi)."""
    cqis = {r: float(d["cqi"]) for r, d in ue_data.items()}
    if not cqis or min(cqis.values()) <= 0:
        return _equal(ue_data), avg_cqis
    new_avg = {r: (1 - gamma) * avg_cqis.get(r, c) + gamma * c
               for r, c in cqis.items()}
    temp = {r: cqis[r] / max(new_avg[r], 1e-9) for r in cqis}
    s = sum(temp.values())
    return {r: round(v / s, 2) for r, v in temp.items()}, new_avg


def round_robin_weights(ue_data, rr_cnt: int):
    """High weight rotates over UEs; returns (weights, rr_cnt+1)
    (algo4_roundrobin_multi)."""
    n = len(ue_data)
    if n == 0:
        return {}, rr_cnt
    cqis = [d["cqi"] for d in ue_data.values()]
    idx = rr_cnt % n
    rr_cnt += 1
    if min(cqis) <= 0:
        return _equal(ue_data), rr_cnt
    high, low = 1 - (n - 1) * 0.1, 0.1
    return {r: (high if i == idx else low)
            for i, r in enumerate(ue_data)}, rr_cnt


class TorchWeightPolicy:
    """RL-policy weights from a torch checkpoint (muApp1 eval_loop_model:
    obs = [BL, CQI, MB]×UE, action -> per-UE RBG percentage).

    The checkpoint is a whole pickled module: one written by this package's
    ``ric.rl`` (``torch.save(policy, path)``).  A policy of the JAX package
    crosses over through ``convert.policy_from_reference`` first, since its
    pickle names the JAX package's class."""

    def __init__(self, model_path: str, media_bytes: float = 300000.0):
        import torch
        self._torch = torch
        self.model = torch.load(model_path, map_location="cpu",
                                weights_only=False)
        self.model.eval()
        self.media_bytes = media_bytes

    def __call__(self, ue_data) -> dict[int, float]:
        torch = self._torch
        obs = np.array([v for d in ue_data.values()
                        for v in (d["ul_buffer"], d["cqi"],
                                  self.media_bytes)], dtype=np.float32)
        # ppo_train checkpoints carry their per-feature [BL, CQI, MB]
        # normalization; apply it so deployment matches training (foreign
        # checkpoints without the attribute get raw features, like muApp1).
        scale = getattr(self.model, "obs_scale", None)
        if scale is not None:
            obs = obs * np.tile(np.asarray(scale, dtype=np.float32),
                                len(ue_data))
        with torch.no_grad():
            action = self.model.select_action(
                torch.from_numpy(obs).unsqueeze(0))
            action = torch.squeeze(action).numpy().reshape(-1)
        s = float(action.sum()) or 1.0
        return {r: float(a) / s for r, a in zip(ue_data, action)}


ALGORITHMS = ("fixed", "max_cqi", "max_weight", "prop_fair", "round_robin")


class MuAppScheduler:
    """The muApp1 main loop: get_metrics -> policy -> send weights.

    One ``step()`` per RAN TTI; ``algorithm`` is live-switchable (the
    reference's redis 'scheduling_algorithm' key, muApp1:296-334).
    """

    def __init__(self, messenger: RicMessenger, algorithm: str = "max_cqi",
                 torch_policy: TorchWeightPolicy | None = None,
                 switch=None, whittle_policy=None):
        self.msgr = messenger
        self.algorithm = algorithm
        self.torch_policy = torch_policy
        # muApp4 NeurWIN index policy (ric.neurwin.WhittleIndexPolicy).
        self.whittle_policy = whittle_policy
        # Live switching source (ric.switchboard.AlgorithmSwitch /
        # RedisSwitch) — polled every TTI like the reference's redis key
        # (muApp1_run_DL_scheduling.py:300).
        self.switch = switch
        self._avg_cqis: dict[int, float] = {}
        self._rr_cnt = 0
        self.total_brate: list[float] = []

    def step(self, blocking: bool = True, timeout_ms: int = 1000) -> bool:
        if self.switch is not None:
            self.algorithm = self.switch.get()
        ran_tti, ue_data = self.msgr.get_metrics(blocking, timeout_ms)
        if not ue_data:
            return False
        self.total_brate.append(sum(d["tx_bytes"]
                                    for d in ue_data.values()))
        a = self.algorithm
        if a == "fixed":
            w = fixed_weights(ue_data)
        elif a == "max_cqi":
            w = max_cqi_weights(ue_data)
        elif a == "max_weight":
            w = max_weight_weights(ue_data)
        elif a == "prop_fair":
            w, self._avg_cqis = prop_fair_weights(ue_data, self._avg_cqis)
        elif a == "round_robin":
            w, self._rr_cnt = round_robin_weights(ue_data, self._rr_cnt)
        elif a == "rl":
            assert self.torch_policy is not None, "rl needs a torch_policy"
            w = self.torch_policy(ue_data)
        elif a == "whittle":
            assert self.whittle_policy is not None, \
                "whittle needs a whittle_policy (ric.neurwin)"
            w = self.whittle_policy(ue_data)
        else:
            raise ValueError(f"unknown algorithm {a!r}")
        self.msgr.send_scheduling_weight(ran_tti, w)
        return True
