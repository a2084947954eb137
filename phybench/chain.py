"""The cell's inputs drawn from the seed, and the chained full-slot step
that the window drives.

The inputs are made once at set-up on the run's device: the DL payloads
of the normal and the SSB slots, the DCIs, the MIBs, the UL payloads, the
ACK and CSI bits, from one ``torch.Generator`` seeded with ``--seed``, in
the names, shapes and order that the reference states
(``reference/inputs.py``); the UE side's UL samples from the reference's
own UE transmitter (through the configuration's static LxL channel at more
than one layer); and the AWGN from the same generator.  The same tensors go
to the measured package and to the reference.

The AWGN is drawn over every air slot of the step, at the traffic's SNR
against the mean power of the UL slots' samples (``ul_slots`` of the
reference's configuration): under a TDD slot pattern the UE is silent on
the others, and a mean over them would lift the UL slots' SNR above the
one stated.  In paired spectrum every slot is a UL slot, and the mean is
taken over the whole tensor, as it always was.

The step chains the measured package's public full-slot entry points as
its bench chains them: the DL payload XORed with ``eps``, the AWGN sign
flipped every step, the int8 HARQ carry fed back with ``new_data`` = 1,
and the DL power reduced into the next ``eps`` (always 0), so every step
depends on the one before.  The step also adds its TBs that fail CRC or
carry another payload than the one sent into a device counter, read once
after the window.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.profiler import record_function

# The keys of a configuration file that describe it or the check, and are
# no field of ``FullCellConfig``.
META = ("source", "deployment", "assumed", "reduced", "limits", "channel")


def full_cell_config(cls, config: dict):
    """A ``FullCellConfig`` (of the measured package or of the reference)
    from a configuration file's fields; a key that is neither one of them
    nor in ``META`` is refused, so no setting is dropped on either side."""
    names = {f.name for f in dataclasses.fields(cls)}
    stray = sorted(set(config) - names - set(META))
    if stray:
        raise ValueError(f"{cls.__module__}.{cls.__name__} has no field {stray}")
    return cls(**{k: v for k, v in config.items() if k in names})


def channel_matrix(config: dict, dev: torch.device) -> torch.Tensor | None:
    """The configuration's static LxL channel (``channel``: rows of [re, im]
    pairs), or None for one layer."""
    rows = config.get("channel")
    if not rows:
        return None
    re = torch.tensor([[c[0] for c in r] for r in rows], dtype=torch.float32)
    im = torch.tensor([[c[1] for c in r] for r in rows], dtype=torch.float32)
    return torch.complex(re, im).to(dev)


def draw_inputs(config: dict, s: int, snr_db: float, seed: int,
                dev: torch.device) -> dict:
    """Every input of the cell at ``s`` air slots per step, from ``seed``."""
    from .reference import inputs
    from .reference.parallel import full_cell as rfc

    fc = full_cell_config(rfc.FullCellConfig, config)
    mimo = fc.n_layers > 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    x = {name: torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.int8)
         for name, shape in inputs.shapes(fc, s).items()}
    if mimo:
        ue = rfc.ue_ul_slot_batch_mimo(x["pay_u"], x["ack"], x["csi"], fc, s,
                                       device=dev)
        ul = torch.einsum("pl,slt->spt", channel_matrix(config, dev), ue)
    else:
        ul = rfc.ue_ul_slot_batch(x["pay_u"], x["ack"], x["csi"], fc, s, device=dev)
    on = ul if not fc.tdd_period else ul[torch.as_tensor(fc.ul_slots(s), device=dev)]
    sig_pow = (on.real * on.real + on.imag * on.imag).mean()
    sigma = torch.sqrt(sig_pow * 10.0 ** (-snr_db / 10.0) / 2.0)
    n = torch.randn(tuple(ul.shape) + (2,), generator=gen, device=dev) * sigma
    x.update(ul=ul, noise=torch.complex(n[..., 0], n[..., 1]),
             ones=torch.ones(x["pay_u"].shape[:2], device=dev))
    return x


class Chain:
    """The full-slot step of the measured package, chained; ``res`` and
    ``td`` are the last step's results and ``flip`` the noise sign that the
    next step takes (the last step took ``-flip``)."""

    def __init__(self, fcm, config: dict, x: dict, s: int, dev: torch.device):
        self.fc = full_cell_config(fcm.FullCellConfig, config)
        self.x, self.s, self.dev = x, s, dev
        mimo = self.fc.n_layers > 1
        self.gnb_dl = fcm.gnb_dl_slot_batch_mimo if mimo else fcm.gnb_dl_slot_batch
        self.gnb_ul = fcm.gnb_ul_slot_batch_mimo if mimo else fcm.gnb_ul_slot_batch
        self.eps = torch.zeros((), dtype=torch.int8, device=dev)
        self.flip = torch.ones((), device=dev)
        self.soft = None        # the first step has no carry yet
        self.res, self.td = None, None
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.steps = 0

    def __call__(self) -> dict:
        x, fc, s, dev = self.x, self.fc, self.s, self.dev
        with record_function("step"):
            with record_function("gnb_dl"):
                td = self.gnb_dl(x["pay_n"] ^ self.eps, x["pay_s"], x["dci"],
                                 x["pbch"], fc, s, device=dev)
            dl_pow = (td.real ** 2 + td.imag ** 2).mean()
            rx = x["ul"] + x["noise"] * self.flip
            with record_function("gnb_ul"):
                res = self.gnb_ul(rx, fc, s, soft_in=self.soft,
                                  new_data=x["ones"], soft_flat=True, device=dev)
            self.eps = (res["payload"][0, 0, 0] & 0) | (dl_pow > 1e30).to(torch.int8)
            self.bad += (~res["tb_ok"] | (res["payload"] != x["pay_u"]).any(-1)).sum()
        self.flip = -self.flip
        self.soft, self.res, self.td = res["soft"], res, td
        self.steps += 1
        return res

    def reset_counts(self) -> None:
        """Start the window's counts: no steps, no failed TBs."""
        self.bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.steps = 0

    def last_flip(self) -> float:
        """The noise sign of the last step (host read: after the window)."""
        return float(-self.flip)

    @property
    def tbs_per_step(self) -> int:
        """The UL TBs of one step: those of the UL payloads drawn."""
        return math.prod(self.x["pay_u"].shape[:2])
