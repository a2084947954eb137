"""TX amplitude control: scaling / clipping with power metrics.

Port of ``srsran_edgeric_5g_tpu/ops/amplitude.py`` (the reference's lower-PHY
amplitude_controller_{scaling,clipping}_impl): a fixed gain, an optional hard
clip of the complex magnitude, and the metrics the lower PHY logs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class AmplitudeMetrics:
    avg_power: torch.Tensor      # mean |y|^2
    peak_power: torch.Tensor     # max |y|^2
    papr: torch.Tensor           # peak / avg
    clipped_ratio: torch.Tensor  # fraction of samples clipped

    def papr_db(self) -> float:
        return float(10.0 * np.log10(max(float(self.papr), 1e-30)))


def scale(samples: torch.Tensor, gain: float
          ) -> tuple[torch.Tensor, AmplitudeMetrics]:
    y = samples * float(np.float32(gain))
    return y, _metrics(y, torch.zeros((), device=y.device))


def clip(samples: torch.Tensor, gain: float, ceiling: float
         ) -> tuple[torch.Tensor, AmplitudeMetrics]:
    """y = gain*x, magnitude hard-clipped to ``ceiling`` (phase kept)."""
    x = samples * float(np.float32(gain))
    mag = x.abs()
    over = mag > ceiling
    scale_dn = torch.where(over, ceiling / torch.clamp(mag, min=1e-30), 1.0)
    y = x * scale_dn
    return y, _metrics(y, over.to(torch.float32).mean())


def _metrics(y: torch.Tensor, clipped_ratio: torch.Tensor) -> AmplitudeMetrics:
    p = y.real ** 2 + y.imag ** 2
    avg, peak = p.mean(), p.max()
    return AmplitudeMetrics(avg_power=avg, peak_power=peak,
                            papr=peak / torch.clamp(avg, min=1e-30),
                            clipped_ratio=clipped_ratio)
