"""The app's scheduled loop on the card (``-m cuda``; skips on a host
without a CUDA device): ``loopback_app.run_scheduled`` for 6 slots at the
default PhyConfig on ``cuda`` and on ``cpu``, each from ``default_rng(0)``
with the same numpy radio (the app's AWGN, drawn from the run's
generator), gives the same grants in every slot, the same CRC outcome per
TB and the same bytes served.  No JAX here: the CPU run is the port's own,
which tests/test_torch_sched_app.py holds to the JAX app.
"""

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch import config, cuda_build, loopback_app
from srsran_edgeric_5g_tpu_torch.mac import scheduler as mac
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda
from srsran_edgeric_5g_tpu_torch.runtime.events import RadioEventNotifier
from test_torch_sched_app import NumpyRadio, recording

torch.set_num_threads(2)


def _run(device, argv):
    cfg = config.PhyConfig()
    rng = np.random.default_rng(0)
    args = loopback_app._parser().parse_args(argv)
    notifier = RadioEventNotifier()
    with recording(mac) as rec:
        res = loopback_app.run_scheduled(args, cfg, cfg.cell_config(), NumpyRadio(rng),
                                         None, notifier, rng, device=device,
                                         log=lambda s: None)
    assert notifier.events.total() == 0
    return res, rec


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [["--sched", "pf", "--slots", "6"],
                                  ["--sched", "rr", "--slots", "6", "--dl-fade", "2",
                                   "--dl-fade-snr", "4"]])
def test_scheduled_loop_card_equals_cpu(argv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decoder kernel has no CPU mode)")
    cuda_build.reset_launches()
    card, card_rec = _run("cuda", argv)
    launches = cuda_build.LAUNCHES.get(decoder_cuda.KERNEL, 0)
    cpu, cpu_rec = _run("cpu", argv)
    assert card.code == cpu.code == 0
    assert card_rec == cpu_rec                    # grants per slot, ACK per TB
    assert card.bytes_served == cpu.bytes_served
    assert (card.tb_count, card.ok_count, card.dl_retx_ok) == \
        (cpu.tb_count, cpu.ok_count, cpu.dl_retx_ok)
    assert launches == card.tb_count > 0          # K1 once per UE-side decode
