"""muApp4 — NeurWIN Whittle-index scheduling, the serving half.

Port of the serving half of ``srsran_edgeric_5g_tpu/ric/neurwin.py``
(edgeric-v2/muApp4 windex_demo_muapp.py): each UE is one restless arm with
state [backlog, CQI]; an index network maps the normalized state to a
scalar Whittle index, and ``WhittleIndexPolicy`` turns the per-UE indices
into muApp1 scheduling weights.  Checkpoints are ``save_checkpoint``'s dict
of tensors, so one written by the JAX package loads here.  The training
half (``ArmEnv``, ``neurwin_train``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

OBS_SCALE = np.array([1e-5, 1 / 15.0], dtype=np.float32)  # [backlog, cqi]


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
            x = torch.as_tensor(np.asarray(x, dtype=np.float32))
        x = F.relu(self.linear1(x))
        x = F.relu(self.linear2(x))
        return self.linear3(x)


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
