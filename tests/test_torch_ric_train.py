"""The RIC's training half of the port (``ric/rl.py``: the digital twin,
GAE, PPO; ``ric/neurwin.py``: the arm env, NEURWIN) against the JAX
package's, on the CPU with the same seeds.

  * Env traces (observations, rewards, done flags, served bytes) and the
    service table: exactly equal.
  * ``estimate_advantages``: equal within 1e-6 (the same float32 ops).
  * ``ppo_train`` (2 iterations x 128 steps) and ``neurwin_train`` (10
    episodes): per-iteration rewards equal, trained weights within 1e-5;
    the reference's trained networks carried across by ``convert`` serve
    the same weights as the port's through ``TorchWeightPolicy`` and
    ``WhittleIndexPolicy``.
"""

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ric import neurwin as jnw
from srsran_edgeric_5g_tpu.ric import rl as jrl
from srsran_edgeric_5g_tpu_torch import convert
from srsran_edgeric_5g_tpu_torch.ric import muapp as tmuapp
from srsran_edgeric_5g_tpu_torch.ric import neurwin as tnw
from srsran_edgeric_5g_tpu_torch.ric import rl as trl

torch.set_num_threads(2)
UE_DATA = {0x4601: {"cqi": 12, "ul_buffer": 40_000, "tx_bytes": 0},
           0x4602: {"cqi": 5, "ul_buffer": 9_000, "tx_bytes": 0},
           0x4603: {"cqi": 9, "ul_buffer": 0, "tx_bytes": 0}}


def test_bytes_per_tti_equal():
    for n_prb in (0, 1, 7, 26, 52, 106):
        for cqi in range(0, 16):
            assert trl._bytes_per_tti(n_prb, cqi) == jrl._bytes_per_tti(n_prb, cqi)


def test_env_trace_equal():
    """200 steps of the twin (3 episodes at horizon 64) with the same
    actions: every observation, reward, done flag and served count."""
    kw = dict(num_ues=3, arrival_bytes=9_000, cqi_bands=((3, 15), (1, 9)), seed=4)
    envs = trl.EdgeRicSimEnv(trl.EnvConfig(**kw)), jrl.EdgeRicSimEnv(jrl.EnvConfig(**kw))
    assert envs[0].cfg.arrival_bytes == envs[1].cfg.arrival_bytes
    acts = np.random.default_rng(1).random((200, 3))
    obs = [e.reset() for e in envs]
    np.testing.assert_array_equal(*obs)
    for a in acts:
        (ot, rt, dt, it), (oj, rj, dj, ij) = (e.step(a) for e in envs)
        np.testing.assert_array_equal(ot, oj)
        assert (rt, dt, it) == (rj, dj, ij)
        if dt:
            np.testing.assert_array_equal(envs[0].reset(), envs[1].reset())
    pol = lambda s: np.clip(s[0::3] * 1e-5, 0.1, 1.0)  # noqa: E731
    assert trl.evaluate(envs[0], pol, 2) == jrl.evaluate(envs[1], pol, 2)


def test_arm_env_trace_equal():
    envs = tnw.ArmEnv(tnw.ArmConfig(seed=2)), jnw.ArmEnv(jnw.ArmConfig(seed=2))
    np.testing.assert_array_equal(envs[0].random_state(), envs[1].random_state())
    for ep in range(3):
        np.testing.assert_array_equal(*(e.reset() for e in envs))
        for t in range(24):
            (ot, rt, dt, it), (oj, rj, dj, ij) = (e.step((t + ep) % 3 != 0) for e in envs)
            np.testing.assert_array_equal(ot, oj)
            assert (rt, dt, it) == (rj, dj, ij)


def test_estimate_advantages_equal():
    g = torch.Generator().manual_seed(0)
    rewards = torch.rand((97, 1), generator=g)
    values = torch.randn((97, 1), generator=g)
    masks = (torch.rand((97, 1), generator=g) > 0.1).to(torch.float32)
    for a, b in zip(trl.estimate_advantages(rewards, masks, values),
                    jrl.estimate_advantages(rewards, masks, values)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def trained():
    """Both packages' PPO (2 iterations x 128 steps) and NEURWIN (10
    episodes) from seed 3."""
    cfg = dict(horizon=32, seed=3)
    jp, jh = jrl.ppo_train(jrl.EdgeRicSimEnv(jrl.EnvConfig(**cfg)), iterations=2,
                           batch_steps=128, seed=3)
    tp, th = trl.ppo_train(trl.EdgeRicSimEnv(trl.EnvConfig(**cfg)), iterations=2,
                           batch_steps=128, seed=3, device="cpu")
    jn, jnh = jnw.neurwin_train(jnw.ArmEnv(jnw.ArmConfig(seed=3)), episodes=10, seed=3)
    tn, tnh = tnw.neurwin_train(tnw.ArmEnv(tnw.ArmConfig(seed=3)), episodes=10, seed=3,
                                device="cpu")
    return dict(jp=jp, jh=jh, tp=tp, th=th, jn=jn, jnh=jnh, tn=tn, tnh=tnh)


def _assert_weights_close(t_net, j_net):
    sd_t, sd_j = t_net.state_dict(), j_net.state_dict()
    assert sd_t.keys() == sd_j.keys()
    for k in sd_j:
        np.testing.assert_allclose(sd_t[k].numpy(), sd_j[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_ppo_train_equal(trained):
    assert trained["th"] == trained["jh"] and len(trained["th"]) == 2
    _assert_weights_close(trained["tp"], trained["jp"])
    np.testing.assert_array_equal(trained["tp"].obs_scale, trained["jp"].obs_scale)
    (start,), _ = trl.seeded_init(3, lambda: (trl.build_policy(6, 2),), torch.device("cpu"))
    assert not all(torch.equal(p, q) for p, q in zip(trained["tp"].parameters(),
                                                     start.parameters()))


def test_neurwin_train_equal(trained):
    assert trained["tnh"] == trained["jnh"] and len(trained["tnh"]) == 10
    _assert_weights_close(trained["tn"], trained["jn"])


def test_trained_networks_carried_across(trained, tmp_path):
    """The reference's trained networks through convert serve what the
    port's trained networks serve: the policy from a checkpoint through
    TorchWeightPolicy (its obs_scale carried), the index net through
    WhittleIndexPolicy."""
    jp = trained["jp"]
    carried = convert.policy_from_reference(jp.state_dict(), 6, 2,
                                            obs_scale=jp.obs_scale)
    _assert_weights_close(carried, trained["jp"])
    ue2 = dict(list(UE_DATA.items())[:2])
    weights = []
    for i, net in enumerate((carried, trained["tp"])):
        torch.save(net, tmp_path / f"p{i}.pt")
        torch.manual_seed(0)          # TorchWeightPolicy samples its action
        weights.append(tmuapp.TorchWeightPolicy(str(tmp_path / f"p{i}.pt"))(ue2))
    assert weights[0].keys() == ue2.keys() == weights[1].keys()
    for r in ue2:
        assert abs(weights[0][r] - weights[1][r]) <= 1e-5
    idx = [tnw.WhittleIndexPolicy(n).indices(UE_DATA)
           for n in (convert.index_net_from_reference(trained["jn"].state_dict()),
                     trained["tn"])]
    assert idx[0].keys() == idx[1].keys() and idx[0][0x4603] == -100.0
    for r in idx[0]:
        assert abs(idx[0][r] - idx[1][r]) <= 1e-5


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        trl.ppo_train(trl.EdgeRicSimEnv(trl.EnvConfig()), iterations=1, batch_steps=4)
    with pytest.raises(RuntimeError):
        tnw.neurwin_train(tnw.ArmEnv(tnw.ArmConfig()), episodes=1)
