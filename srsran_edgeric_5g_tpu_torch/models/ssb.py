"""SS/PBCH block tables (TS 38.211 §7.4.3, TS 38.212 §7.1).

Port of ``srsran_edgeric_5g_tpu/models/ssb.py``: the PBCH constants and
polar code, the PBCH data / DM-RS positions, the DM-RS sequence, the payload
interleaving with its timing bits and first scrambling, the second
(modulator) scrambling, and the single-block chain: ``pbch_encode`` (TS
38.212 §7.1.1-§7.1.5), ``process`` (MIB -> grid with PSS, SSS, PBCH and its
DM-RS) and the clean-channel receive ``decode`` (SC polar decode).  The full
cell batches the same tables over occasions
(``parallel.full_cell.ssb_blocks``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import modulation, sequences, sync_signals
from ..ops.crc import crc_attach, crc_check
from ..ops.polar import code as pcode, decoder as pdec, encoder as penc
from ..ops.polar import rate_match as prm

PBCH_PAYLOAD = 24  # higher-layer payload bits (A_hat)
PBCH_A = 32        # after timing-bit insertion
PBCH_K = 56        # A + CRC24C
PBCH_E = 864

# TS 38.212 Table 7.1.1-1: PBCH payload interleaver pattern G(j).
PBCH_G = np.array([16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4,
                   9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28,
                   29, 31])


@dataclasses.dataclass(frozen=True)
class SsbConfig:
    pci: int
    ssb_index: int = 0
    first_symbol: int = 0
    first_subcarrier: int = 0
    l_max: int = 8       # SSB candidates per burst (4, 8 or 64)
    hrf: bool = False    # odd half frame
    sfn: int = 0         # system frame number (timing bits in the payload)
    k_ssb: int = 0       # subcarrier offset (MSB carried in the payload)

    @property
    def dmrs_v(self) -> int:
        return self.pci % 4


def _polar():
    return pcode.construct(PBCH_K, PBCH_E, nmax=pcode.NMAX_DL, i_il=True)


def _pbch_positions(cfg: SsbConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(all, data, DM-RS) (symbol, subcarrier) pairs of the PBCH within the
    SSB: symbol 1 sc 0..239, symbol 2 sc 0..47 and 192..239, symbol 3
    0..239; DM-RS on 4k + v."""
    sym, sc = [], []
    for l, ranges in ((1, [(0, 240)]), (2, [(0, 48), (192, 240)]),
                      (3, [(0, 240)])):
        for a, b in ranges:
            sym += [l] * (b - a)
            sc += range(a, b)
    sym, sc = np.asarray(sym), np.asarray(sc)
    is_dmrs = (sc % 4) == cfg.dmrs_v
    return (np.stack([sym, sc], 1), np.stack([sym[~is_dmrs], sc[~is_dmrs]], 1),
            np.stack([sym[is_dmrs], sc[is_dmrs]], 1))


def _dmrs_sequence(cfg: SsbConfig, npil: int) -> np.ndarray:
    """PBCH DM-RS r(m) (§7.4.1.4.1): L_max = 4 uses i_bar = 2 LSBs of the
    SSB index + 4*hrf, else its 3 LSBs."""
    if cfg.l_max == 4:
        ibar = (cfg.ssb_index & 0x3) + (4 if cfg.hrf else 0)
    else:
        ibar = cfg.ssb_index & 0x7
    cinit = ((1 << 11) * (ibar + 1) * (cfg.pci // 4 + 1)
             + (1 << 6) * (ibar + 1) + cfg.pci % 4) % (1 << 31)
    c = sequences.np_gold_sequence(cinit, 2 * npil)
    return (((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
            ).astype(np.complex64)


def _payload_maps(cfg: SsbConfig):
    """§7.1.1 statics: (payload -> a positions, extra-bit positions, their
    values, the 1st-scrambling sequence over the (32,) a)."""
    g = PBCH_G
    pos = np.empty(PBCH_PAYLOAD, np.int64)
    j_sfn, j_other = 0, 14
    for i in range(PBCH_PAYLOAD):
        if 1 <= i < 7:          # the 6 SFN MSBs inside the payload
            pos[i] = g[j_sfn]
            j_sfn += 1
        else:
            pos[i] = g[j_other]
            j_other += 1
    extra_pos = [g[6 + k] for k in range(4)] + [g[10]]
    extra_val = [(cfg.sfn >> 3) & 1, (cfg.sfn >> 2) & 1, (cfg.sfn >> 1) & 1,
                 cfg.sfn & 1, 1 if cfg.hrf else 0]
    if cfg.l_max == 64:
        extra_pos += [g[11], g[12], g[13]]
        extra_val += [(cfg.ssb_index >> 5) & 1, (cfg.ssb_index >> 4) & 1,
                      (cfg.ssb_index >> 3) & 1]
    else:
        extra_pos += [g[11], g[12], g[13]]
        extra_val += [(cfg.k_ssb >> 4) & 1, 0, 0]

    # 1st scrambling: Gold(N_id) advanced by M*v; the timing bits (HRF, SFN
    # 2nd/3rd LSBs, and the SSB-index bits when L_max = 64) are not scrambled
    # and consume no sequence bits.
    m = PBCH_A - (6 if cfg.l_max == 64 else 3)
    v = 2 * ((cfg.sfn >> 2) & 1) + ((cfg.sfn >> 1) & 1)
    exempt = {int(g[10]), int(g[7]), int(g[8])}
    if cfg.l_max == 64:
        exempt |= {int(g[11]), int(g[12]), int(g[13])}
    c = sequences.np_gold_sequence(cfg.pci, m * v + PBCH_A)[m * v:]
    seq = np.zeros(PBCH_A, np.int8)
    j = 0
    for i in range(PBCH_A):
        if i not in exempt:
            seq[i] = c[j]
            j += 1
    return (pos, np.asarray(extra_pos, np.int64), np.asarray(extra_val, np.int8),
            seq)


def _seq2(cfg: SsbConfig) -> np.ndarray:
    """PBCH modulator scrambling (§7.3.3.1): Gold(N_id) advanced by
    (ssb_idx & 7) * E."""
    adv = (cfg.ssb_index & 0x7) * PBCH_E
    return sequences.np_gold_sequence(cfg.pci, adv + PBCH_E)[adv:].astype(np.int8)


def pbch_encode(payload: torch.Tensor, cfg: SsbConfig) -> torch.Tensor:
    """(1, 24) higher-layer payload -> (1, E=864) encoder-stage bits (TS
    38.212 §7.1.1-§7.1.5; the modulator's 2nd scrambling is applied by
    ``process``, as the reference splits pbch_encoder / pbch_modulator)."""
    pos, epos, eval_, seq1 = _payload_maps(cfg)
    dev = payload.device
    a = torch.zeros((payload.shape[0], PBCH_A), dtype=torch.int8, device=dev)
    a[:, torch.as_tensor(pos, device=dev)] = payload.to(torch.int8)
    a[:, torch.as_tensor(epos, device=dev)] = torch.as_tensor(eval_, device=dev)
    a = a ^ torch.as_tensor(seq1, device=dev)
    cw = penc.encode(crc_attach(a, "crc24c"), _polar())
    return prm.rate_match(cw, _polar())


def _positions_on(pos: np.ndarray, cfg: SsbConfig, device: torch.device):
    return (torch.as_tensor(pos[:, 0] + cfg.first_symbol, device=device),
            torch.as_tensor(pos[:, 1] + cfg.first_subcarrier, device=device))


def process(payload: torch.Tensor, cfg: SsbConfig, nsymb: int, nsubc: int,
            amplitude: float = 1.0) -> torch.Tensor:
    """(1, 24) MIB payload -> (nsymb, nsubc) grid with the full SSB."""
    dev = payload.device
    amp = float(np.float32(amplitude))
    grid = torch.zeros((nsymb, nsubc), dtype=torch.complex64, device=dev)
    grid = sync_signals.map_ssb_sync(grid, cfg.pci, cfg.first_symbol,
                                     cfg.first_subcarrier, amplitude)
    bits = pbch_encode(payload, cfg) ^ torch.as_tensor(_seq2(cfg), device=dev)
    syms = modulation.modulate(bits, "qpsk")[0] * amp
    _, data_pos, dmrs_pos = _pbch_positions(cfg)
    grid[_positions_on(data_pos, cfg, dev)] = syms.to(torch.complex64)
    pil = torch.as_tensor(_dmrs_sequence(cfg, len(dmrs_pos)), device=dev)
    grid[_positions_on(dmrs_pos, cfg, dev)] = pil * amp
    return grid


def decode(rx_grid: torch.Tensor, cfg: SsbConfig
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Clean-channel PBCH receive: ((1, 24) payload, (1,) CRC ok).

    The timing hypothesis (SSB index LSBs for the 2nd descrambling, SFN
    parity for the 1st) comes from ``cfg``; the UE-side blind search over
    hypotheses is out of scope, as in the reference."""
    dev = rx_grid.device
    _, data_pos, _ = _pbch_positions(cfg)
    syms = rx_grid[_positions_on(data_pos, cfg, dev)]
    llr = modulation.demodulate_soft(syms[None], torch.tensor(0.1, device=dev),
                                     "qpsk", quantize=False)
    llr = llr * torch.as_tensor(1.0 - 2.0 * _seq2(cfg), dtype=torch.float32,
                                device=dev)[None]
    decoded = pdec.decode(prm.rate_dematch(llr, _polar()), _polar())
    ok = crc_check(decoded, "crc24c")
    pos, _, _, seq1 = _payload_maps(cfg)
    a = decoded[:, :PBCH_A].to(torch.int8) ^ torch.as_tensor(seq1, device=dev)
    return a[:, torch.as_tensor(pos, device=dev)], ok
