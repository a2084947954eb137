"""EVM from equalised symbols and hard decisions.

Port of ``srsran_edgeric_5g_tpu/ops/evm.py``: re-modulate the hard-decided
bits and measure the RMS error vector against the equalised symbols; and
the SINR-from-EVM conversion used in PUSCH CSI reporting.
"""

from __future__ import annotations

import torch

from .modulation import hard_decision, modulate


def evm(eq_symbols: torch.Tensor, llrs: torch.Tensor,
        modulation_name: str) -> torch.Tensor:
    """RMS EVM over the last axis: ||y - remod(harddec(llr))|| / sqrt(E_s)."""
    ref = modulate(hard_decision(llrs), modulation_name)
    return torch.sqrt(torch.mean(torch.abs(eq_symbols - ref) ** 2, dim=-1))


def sinr_from_evm(evm_value: torch.Tensor) -> torch.Tensor:
    """Post-equalisation SINR (dB) = -20 log10(EVM)."""
    return -20.0 * torch.log10(torch.clamp(evm_value, min=1e-9))
