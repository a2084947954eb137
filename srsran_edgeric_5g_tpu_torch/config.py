"""YAML -> dataclass configuration with derivation and validation.

Port of ``srsran_edgeric_5g_tpu/config.py`` (plain Python; the port keeps its
own copy).  ``PhyConfig.cell_config()`` returns this package's
``parallel.slot_pipeline.CellConfig`` and ``timing`` this package's
``ran.numerology.slot_timing``; the validation messages are the reference's,
word for word.  Counterpart of the reference's CLI11+YAML config machinery
(srsRAN-5G-ER/apps/gnb/gnb_appconfig_cli11_schema.cpp, autoderivation
callbacks gnb.cpp:246-266, validators gnb_appconfig_validators.cpp) reduced
to the PHY scope: one `PhyConfig` describing cell + UEs + IO, with the same
derivation rules the reference applies (sample rate from bandwidth/SCS, FFT
size, band defaults) and validation errors that name the offending field.

YAML parsing uses a tiny built-in reader (flat two-level maps) so no external
dependency is required; `from_dict` is the programmatic path.
"""

from __future__ import annotations

import dataclasses
import pathlib

from .ran.numerology import slot_timing

# bandwidth MHz -> (nof_prb @15kHz, canonical nfft) per the reference's
# zmq-mode configs (11.52 / 23.04 Msps).
BW_TABLE_15KHZ = {
    5: (25, 384),
    10: (52, 768),
    15: (79, 1152),
    20: (106, 1536),
}


@dataclasses.dataclass(frozen=True)
class UeConfig:
    rnti: int
    prb_per_ue: int | None = None   # None: equal split


@dataclasses.dataclass(frozen=True)
class PhyConfig:
    bandwidth_mhz: int = 10
    scs_khz: int = 15
    pci: int = 1
    center_freq_hz: float = 1.8425e9      # band 3 default like the reference
    nof_ue: int = 2
    modulation: str = "qam16"
    target_rate: float = 0.5
    rnti_base: int = 0x4601
    tx_address: str = "tcp://*:2101"      # gNB TX sample server
    rx_address: str = "tcp://localhost:2100"  # gNB RX sample puller
    # UL estimator: 0 disables smoothing; > 0 enables the TA + frequency-
    # smoothing chain assuming this delay spread (microseconds).
    delay_spread_us: float = 0.0

    def __post_init__(self):
        if self.scs_khz != 15:
            raise ValueError(f"scs {self.scs_khz} kHz: only 15 kHz cells are "
                             "modeled (reference zmq configs)")
        if self.bandwidth_mhz not in BW_TABLE_15KHZ:
            raise ValueError(f"bandwidth {self.bandwidth_mhz} MHz not in "
                             f"{sorted(BW_TABLE_15KHZ)}")
        if not (0 <= self.pci < 1008):
            raise ValueError(f"pci {self.pci} out of range [0, 1008)")
        if self.nof_ue < 1:
            raise ValueError("nof_ue must be >= 1")
        if self.nof_prb // self.nof_ue < 4:
            raise ValueError(f"{self.nof_ue} UEs do not fit in "
                             f"{self.nof_prb} PRBs (>=4 PRB each)")
        if not (0.0 <= self.delay_spread_us <= 10.0):
            raise ValueError(f"delay_spread_us {self.delay_spread_us} out of "
                             "range [0, 10] (must stay well inside the CP)")

    @property
    def nof_prb(self) -> int:
        return BW_TABLE_15KHZ[self.bandwidth_mhz][0]

    @property
    def nfft(self) -> int:
        return BW_TABLE_15KHZ[self.bandwidth_mhz][1]

    @property
    def srate(self) -> int:
        return self.timing.srate

    @property
    def timing(self):
        return slot_timing(nof_prb=self.nof_prb, nfft=self.nfft, mu=0)

    def cell_config(self):
        from .parallel.slot_pipeline import CellConfig
        return CellConfig(nof_prb=self.nof_prb, nfft=self.nfft,
                          nof_ue=self.nof_ue,
                          prb_per_ue=self.nof_prb // self.nof_ue,
                          modulation=self.modulation,
                          target_rate=self.target_rate,
                          n_id=self.pci % 1024,
                          delay_spread_us=self.delay_spread_us)


def _parse_scalar(s: str):
    s = s.strip()
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s.strip("'\"")


def load_yaml(path: str | pathlib.Path) -> dict:
    """Minimal YAML subset reader: nested maps by indentation, scalars."""
    root: dict = {}
    stack: list[tuple[int, dict]] = [(-1, root)]
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        while stack and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if val.strip():
            parent[key] = _parse_scalar(val)
        else:
            child: dict = {}
            parent[key] = child
            stack.append((indent, child))
    return root


def from_dict(d: dict) -> PhyConfig:
    cell = d.get("cell", d)
    fields = {f.name for f in dataclasses.fields(PhyConfig)}
    kwargs = {k: v for k, v in cell.items() if k in fields}
    unknown = set(cell) - fields - {"cell"}
    if unknown and "cell" not in d:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return PhyConfig(**kwargs)


def load(path: str | pathlib.Path) -> PhyConfig:
    return from_dict(load_yaml(path))
