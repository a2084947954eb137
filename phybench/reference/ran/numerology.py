"""OFDM numerology per TS 38.211 §4.2-4.3 and §5.3.1.

Plain Python parameter math, evaluated when a plan is built.  Copy of
``srsran_edgeric_5g_tpu/ran/numerology.py`` (which imports no JAX) so that
the port never loads the JAX package.

Conventions:
  * `mu` is the numerology index: SCS = 15 kHz * 2**mu.
  * `nfft` is the DFT size; the sample rate is `nfft * scs` (nfft=768 @
    11.52 Msps for 10 MHz / 52 PRB and nfft=1536 @ 23.04 Msps for 20 MHz /
    106 PRB, both mu=0).
  * CP lengths follow TS 38.211 §5.3.1 scaled by nfft/2048: the first symbol
    of each half-subframe gets the 16*kappa extension.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

N_SC_PER_PRB = 12
NSYMB_PER_SLOT_NORMAL = 14
NSYMB_PER_SLOT_EXTENDED = 12
NRE = N_SC_PER_PRB  # resource elements per PRB per symbol


def scs_hz(mu: int) -> int:
    """Subcarrier spacing in Hz for numerology ``mu`` (TS 38.211 Table 4.2-1)."""
    return 15_000 * (1 << mu)


def sample_rate(nfft: int, mu: int) -> int:
    """Baseband sample rate in Hz for DFT size ``nfft`` at numerology ``mu``."""
    return nfft * scs_hz(mu)


def symbols_per_slot(extended_cp: bool = False) -> int:
    return NSYMB_PER_SLOT_EXTENDED if extended_cp else NSYMB_PER_SLOT_NORMAL


def slots_per_subframe(mu: int) -> int:
    return 1 << mu


def slots_per_frame(mu: int) -> int:
    return 10 * (1 << mu)


def cp_lengths(nfft: int, mu: int, slot_in_subframe: int = 0,
               extended_cp: bool = False) -> tuple[int, ...]:
    """Per-symbol cyclic-prefix lengths in samples for one slot.

    Short CP = 144*nfft/2048 samples at every mu; the long-CP extension of
    symbols l = 0 and l = 7*2**mu of the subframe is 16*nfft*2**mu/2048.
    Extended CP: 512*nfft/2048.
    """
    if extended_cp:
        base = Fraction(512 * nfft, 2048)
        if base.denominator != 1:
            raise ValueError(f"extended CP not integral for nfft={nfft}, mu={mu}")
        return tuple([int(base)] * NSYMB_PER_SLOT_EXTENDED)

    base = Fraction(144 * nfft, 2048)
    extra = Fraction(16 * nfft * (1 << mu), 2048)
    if base.denominator != 1 or extra.denominator != 1:
        raise ValueError(f"CP lengths not integral for nfft={nfft}, mu={mu}")
    base, extra = int(base), int(extra)

    nsym = NSYMB_PER_SLOT_NORMAL
    first_sym = slot_in_subframe * nsym
    out = []
    for l_in_slot in range(nsym):
        l_sf = first_sym + l_in_slot
        long_cp = l_sf == 0 or l_sf == 7 * (1 << mu)
        out.append(base + extra if long_cp else base)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CyclicPrefixTiming:
    """CP layout of one slot: per-symbol CP lengths and symbol boundaries."""

    nfft: int
    cp: tuple[int, ...]           # CP samples per symbol
    starts: tuple[int, ...]       # start sample (incl. CP) of each symbol
    data_starts: tuple[int, ...]  # start sample of the useful (post-CP) part
    total: int                    # total samples in the slot


@dataclasses.dataclass(frozen=True)
class SlotTiming:
    """Static timing/shape description of one slot for a cell config."""

    mu: int
    nfft: int
    nof_prb: int
    nof_subc: int
    nsymb: int
    srate: int
    cp: CyclicPrefixTiming


def cp_timing(nfft: int, mu: int, slot_in_subframe: int = 0,
              extended_cp: bool = False) -> CyclicPrefixTiming:
    cps = cp_lengths(nfft, mu, slot_in_subframe, extended_cp)
    starts, data_starts = [], []
    t = 0
    for c in cps:
        starts.append(t)
        data_starts.append(t + c)
        t += c + nfft
    return CyclicPrefixTiming(nfft=nfft, cp=cps, starts=tuple(starts),
                              data_starts=tuple(data_starts), total=t)


def slot_timing(nof_prb: int, nfft: int, mu: int = 0, slot_in_subframe: int = 0,
                extended_cp: bool = False) -> SlotTiming:
    nof_subc = nof_prb * N_SC_PER_PRB
    if nof_subc > nfft:
        raise ValueError(f"{nof_prb} PRB ({nof_subc} subcarriers) > nfft={nfft}")
    return SlotTiming(
        mu=mu,
        nfft=nfft,
        nof_prb=nof_prb,
        nof_subc=nof_subc,
        nsymb=symbols_per_slot(extended_cp),
        srate=sample_rate(nfft, mu),
        cp=cp_timing(nfft, mu, slot_in_subframe, extended_cp),
    )


# The reference's cell configurations (its zmq multi-UE config): 10 MHz /
# 52 PRB at 11.52 Msps and 20 MHz / 106 PRB at 23.04 Msps, both 15 kHz SCS.
CELL_10MHZ = dict(nof_prb=52, nfft=768, mu=0)
CELL_20MHZ = dict(nof_prb=106, nfft=1536, mu=0)
