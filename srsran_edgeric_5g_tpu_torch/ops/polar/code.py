"""Polar code construction (TS 38.212 §5.3.1 + §5.4.1.1 pre-freezing).

Port of ``srsran_edgeric_5g_tpu/ops/polar/code.py`` (host-side numpy): the
static description the encoder and the rate matcher consume — mother code
size N, frozen / information sets after rate-matching pre-freezing, the
sub-block interleaver and the DCI input interleaver.  The spec constants
(reliability sequence, interleaver pattern) come from this package's
``data/ldpc_graphs.npz``.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib

import numpy as np

from ...utils.tracing import cached_build

_DATA = pathlib.Path(__file__).resolve().parents[2] / "data" / "ldpc_graphs.npz"

# TS 38.212 Table 5.4.1.1-1: sub-block interleaver pattern P(i).
SUBBLOCK_PATTERN = np.array(
    [0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19, 12, 20, 13, 21,
     14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31], dtype=np.int64)

NMAX_DL = 9   # PDCCH/PBCH
NMAX_UL = 10  # UCI


@cached_build
def _tables():
    d = np.load(_DATA)
    return (d["polar_sequence_1024"].astype(np.int64),
            d["polar_dci_interleaver_pattern"].astype(np.int64))


@dataclasses.dataclass(frozen=True, eq=False)
class PolarCode:
    """A constructed code.  Equality and hashing are by identity (the arrays
    have no scalar ``==``); ``construct`` is cached, so one (K, E, ...) gives
    one object."""

    k: int                    # info bits (incl. CRC), excl. PC bits
    e: int                    # rate-matched bits
    n: int                    # log2(N)
    nof_bits: int             # N
    rm_mode: str              # 'puncture' | 'shorten' | 'repeat'
    info_set: np.ndarray      # (K,) ascending u-domain data positions
    frozen_set: np.ndarray    # frozen positions (excl. PC)
    subblock_perm: np.ndarray  # (N,) J(i): y[i] = x[J(i)]
    dci_interleave: np.ndarray | None  # (K,) input interleaver (i_IL=1)
    pc_set: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))  # parity-check bits
    i_bil: bool = False       # coded-bit triangular interleaver (UCI, §5.4.1.3)

    @property
    def n_pc(self) -> int:
        return len(self.pc_set)


def subblock_permutation(n_bits: int) -> np.ndarray:
    i = np.arange(n_bits)
    return SUBBLOCK_PATTERN[(32 * i) // n_bits] * (n_bits // 32) + i % (n_bits // 32)


def dci_interleaver(k: int) -> np.ndarray:
    """TS 38.212 §5.3.1.1 (i_IL = 1): c'(m) = c(pi(m)) from the 164-pattern."""
    _, pattern = _tables()
    k_max = 164
    out = []
    for m in range(k_max):
        if pattern[m] >= k_max - k:
            out.append(pattern[m] - (k_max - k))
    pi = np.asarray(out, dtype=np.int64)
    assert len(pi) == k
    return pi


@cached_build
def construct(k: int, e: int, nmax: int = NMAX_DL,
              i_il: bool = True, n_pc: int = 0,
              i_bil: bool = False) -> PolarCode:
    """Build the (K, E) polar code per TS 38.212 §5.3.1/§5.4.1.1.

    ``n_pc``: number of parity-check bits (UCI with 12 <= K <= 19 uses
    n_pc = 3 with n_pc_wm = 1 when E - K + 3 > 192, §6.3.1.3.1); the code
    then reserves K + n_pc reliable positions and marks the PC subset.
    ``i_bil``: apply the triangular coded-bit channel interleaver in rate
    matching (§5.4.1.3; UCI paths — polar_rate_matcher_impl.cpp:101-105).
    """
    seq, _ = _tables()
    # Mother code size (§5.3.1).
    cl2e = math.ceil(math.log2(e))
    if e <= (9 / 8) * 2 ** (cl2e - 1) and k / e < 9 / 16:
        n1 = cl2e - 1
    else:
        n1 = cl2e
    r_min = 1 / 8
    n2 = math.ceil(math.log2(k / r_min))
    n = max(min(min(n1, n2), nmax), 5)
    nb = 1 << n

    if e >= nb:
        rm_mode = "repeat"
    elif k / e <= 7 / 16:
        rm_mode = "puncture"
    else:
        rm_mode = "shorten"

    jn = subblock_permutation(nb)

    # Pre-frozen positions from rate matching (§5.4.1.1 / §5.3.1.2).
    prefrozen = np.zeros(nb, dtype=bool)
    if rm_mode == "puncture":
        prefrozen[jn[:nb - e]] = True
        if e >= 3 * nb / 4:
            prefrozen[:math.ceil(3 * nb / 4 - e / 2)] = True
        else:
            prefrozen[:math.ceil(9 * nb / 16 - e / 4)] = True
    elif rm_mode == "shorten":
        prefrozen[jn[e:]] = True

    rel = seq[seq < nb]  # ascending reliability order
    usable = rel[~prefrozen[rel]]
    assert len(usable) >= k + n_pc, (k, e, nb, rm_mode, n_pc)
    chosen = usable[-(k + n_pc):]        # ascending reliability

    pc = np.empty(0, dtype=np.int64)
    if n_pc:
        # §5.3.1.2: n_pc_wm of the PC bits go to the minimum-row-weight
        # position among the most reliable |chosen| - n_pc positions (highest
        # reliability on ties); the rest take the least reliable positions.
        n_wm = 1 if (e - k + n_pc > 192) else 0
        least_reliable = chosen[:n_pc - n_wm]
        pc = list(least_reliable)
        if n_wm:
            top = chosen[n_pc - n_wm:]
            weights = np.array([bin(int(i)).count("1") for i in top])
            wmin = weights.min()
            # candidates with min row weight; pick the most reliable (last).
            cand = top[weights == wmin]
            pc.append(int(cand[-1]))
        pc = np.sort(np.asarray(pc, dtype=np.int64))

    info = np.sort(np.asarray([p for p in chosen if p not in set(pc.tolist())],
                              dtype=np.int64))
    assert len(info) == k
    frozen_mask = np.ones(nb, dtype=bool)
    frozen_mask[info] = False
    frozen_mask[pc] = False
    frozen = np.nonzero(frozen_mask)[0]

    return PolarCode(k=k, e=e, n=n, nof_bits=nb, rm_mode=rm_mode,
                     info_set=info.astype(np.int64),
                     frozen_set=frozen.astype(np.int64),
                     subblock_perm=jn.astype(np.int64),
                     dci_interleave=dci_interleaver(k) if i_il else None,
                     pc_set=pc, i_bil=i_bil)
