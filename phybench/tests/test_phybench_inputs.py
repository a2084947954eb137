"""The inputs that each configuration's cells draw from a seed: the same
bits in the same order from the one generator as before the reference came
to state their shapes (``reference/inputs.py``), drawn in the shapes that it
states; and a configuration key that no ``FullCellConfig`` field takes is
refused on both sides, never dropped."""

import hashlib
import json

import pytest
import torch

import phybench.reference.inputs
from phybench.chain import META, Chain, draw_inputs, full_cell_config
from phybench.reference.parallel import full_cell as rfc
from phybench.spec import ROOT, load_benchmark, load_cell

S = 10          # every occasion (SSB, CSI, CSI-RS, SRS, PRACH) once
SEED = 2 ** 31 + 77
BITS = ("pay_n", "pay_s", "dci", "pbch", "pay_u", "ack", "csi", "ones")
# sha256 of each configuration's bit inputs at S = 10 from SEED, taken with
# the harness as it drew them before ``inputs.shapes``: each name, shape,
# type and value, in draw order, so also the generator's state before the
# noise is drawn.  Integer draws: exact on any host.
DIGESTS = {
    "nr20_siso_4ue": "fc8aa67ca72dc0add080a8a040f590841577c25473e7e5556bba6d2451eb9e44",
    "nr20_mimo2x2_4ue": "530c72fe4b58cb49fd4aa90bb678b558512203f6243d90730fe339894f23322f",
}
CONFIGS = {c["name"]: c["file"] for c in load_benchmark()["configs"]}
CELL_OF = {w["config"]: w["name"] for w in load_benchmark()["workloads"]}


def digest(x: dict) -> str:
    h = hashlib.sha256()
    for k in BITS:
        t = x[k].contiguous()
        h.update(f"{k} {tuple(t.shape)} {t.dtype}\n".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(DIGESTS))
def test_each_configuration_draws_the_inputs_it_drew(config):
    c = load_cell(CELL_OF[config])
    x = draw_inputs(c.config, S, c.traffic["snr_db"], SEED, torch.device("cpu"))
    assert set(x) == set(BITS) | {"ul", "noise"}
    assert digest(x) == DIGESTS[config]


def test_the_inputs_follow_the_shapes_that_the_reference_states(monkeypatch):
    """A reference whose UL runs on every second slot gets UL payloads, ACK
    bits and ``new_data`` for those slots alone, and the step counts their
    TBs, not S times the UEs."""
    def half_ul(fc, s):
        u = fc.nof_ue
        return {"pay_n": (s, u, 16), "pay_s": (0, u, 16), "dci": (s, 2 * u, 40),
                "pbch": (0, 24), "pay_u": (s // 2, u, 32), "ack": (s // 2, u, 2),
                "csi": (0, u, 8)}

    def ue_ul(pay_u, ack, csi, fc, s, device=None):
        assert pay_u.shape[0] == ack.shape[0] == s // 2
        return torch.ones((s, 64), dtype=torch.complex64, device=device)

    monkeypatch.setattr(phybench.reference.inputs, "shapes", half_ul)
    monkeypatch.setattr(rfc, "ue_ul_slot_batch", ue_ul)
    c = load_cell(CELL_OF["nr20_siso_4ue"])
    dev = torch.device("cpu")
    x = draw_inputs(c.config, S, c.traffic["snr_db"], SEED, dev)
    drawn = {k: tuple(v.shape) for k, v in x.items() if k in BITS[:-1]}
    assert list(drawn.items()) == list(half_ul(rfc.FullCellConfig(), S).items())
    assert tuple(x["ones"].shape) == (S // 2, 4)
    assert Chain(rfc, c.config, x, S, dev).tbs_per_step == S // 2 * 4


@pytest.mark.parametrize("side", ["port", "reference"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_a_key_that_no_field_takes_is_refused(config, side):
    if side == "port":
        from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
    else:
        fcm = rfc
    cfg = json.loads((ROOT / CONFIGS[config]).read_text())
    fc = full_cell_config(fcm.FullCellConfig, cfg)
    assert {k: getattr(fc, k) for k in cfg if k not in META} == {
        k: v for k, v in cfg.items() if k not in META}
    with pytest.raises(ValueError, match="tdd_pattern"):
        full_cell_config(fcm.FullCellConfig, dict(cfg, tdd_pattern="DDDSU"))
