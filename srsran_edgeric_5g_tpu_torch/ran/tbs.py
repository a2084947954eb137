"""TBS determination and MCS tables (TS 38.214 §5.1.3).

Port of ``srsran_edgeric_5g_tpu/ran/tbs.py``.  The Table 5.1.3.2-1 TBS values
and the three MCS index tables are packed spec data in this package's own
``data/ldpc_graphs.npz``.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib

import numpy as np

from ..utils.tracing import cached_build

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "ldpc_graphs.npz"

NRE_PER_PRB_LIMIT = 156  # min(156, N'_RE) cap, §5.1.3.2 step 1


@cached_build
def _tables():
    d = np.load(_DATA)
    return (d["tbs_table"],
            {"qam64": d["mcs_table_qam64"],
             "qam256": d["mcs_table_qam256"],
             "qam64lowse": d["mcs_table_qam64lowse"]})


@dataclasses.dataclass(frozen=True)
class McsConfig:
    qm: int             # modulation order
    target_rate: float  # R (spectral efficiency numerator / 1024)

    @property
    def modulation(self) -> str:
        return {1: "bpsk", 2: "qpsk", 4: "qam16", 6: "qam64", 8: "qam256"}[self.qm]


def mcs_config(index: int, table: str = "qam64") -> McsConfig:
    """MCS index -> (Qm, R/1024) per TS 38.214 Tables 5.1.3.1-1/-2/-3.

    Reserved entries (rate 0) raise ValueError.
    """
    qm, r = _tables()[1][table][index]
    if r == 0:
        raise ValueError(f"MCS {index} in table {table} is reserved (retx only)")
    return McsConfig(qm=int(qm), target_rate=float(r) / 1024.0)


def nof_re(nof_prb: int, nof_symbols: int, nof_dmrs_re_per_prb: int,
           nof_oh_re_per_prb: int = 0) -> int:
    """N_RE per §5.1.3.2 step 1: min(156, N'_RE) * n_PRB."""
    nre_prime = 12 * nof_symbols - nof_dmrs_re_per_prb - nof_oh_re_per_prb
    return min(NRE_PER_PRB_LIMIT, nre_prime) * nof_prb


def tbs(nof_re_total: int, target_rate: float, qm: int,
        nof_layers: int = 1) -> int:
    """TS 38.214 §5.1.3.2 steps 2-4: the standard TBS quantisation."""
    ninfo = nof_re_total * target_rate * qm * nof_layers
    if ninfo <= 3824:
        n = max(3, int(math.floor(math.log2(max(ninfo, 1)))) - 6)
        ninfo_p = max(24, (1 << n) * int(ninfo) // (1 << n))
        table = _tables()[0]
        idx = min(int(np.searchsorted(table, ninfo_p)), len(table) - 1)
        return int(table[idx])
    n = int(math.floor(math.log2(ninfo - 24))) - 5
    ninfo_p = max(3840, (1 << n) * round((ninfo - 24) / (1 << n)))
    if target_rate <= 0.25:
        c = math.ceil((ninfo_p + 24) / 3816)
        return 8 * c * math.ceil((ninfo_p + 24) / (8 * c)) - 24
    if ninfo_p > 8424:
        c = math.ceil((ninfo_p + 24) / 8424)
        return 8 * c * math.ceil((ninfo_p + 24) / (8 * c)) - 24
    return 8 * math.ceil((ninfo_p + 24) / 8) - 24


def tbs_for_alloc(nof_prb: int, nof_symbols: int, nof_dmrs_re_per_prb: int,
                  mcs: McsConfig, nof_layers: int = 1) -> int:
    """TBS of an allocation of ``nof_prb`` PRBs over ``nof_symbols`` symbols
    at ``mcs`` (the scheduler's sizing call)."""
    return tbs(nof_re(nof_prb, nof_symbols, nof_dmrs_re_per_prb),
               mcs.target_rate, mcs.qm, nof_layers)
