"""Host-side runtime: native IQ bridge (ZMQ radio), slot clock, radio events.

Port of ``srsran_edgeric_5g_tpu/runtime/__init__.py``.  The compute path is
PyTorch on the card; the runtime around it — sample IO to the zmq loopback
peers, ring buffers, capture/replay — is native C++ (native/iqbridge) bound
via ctypes, mirroring the reference's lib/radio/zmq layer and its
executor-fed circular buffers.
"""

from .iqbridge import IqRing, IqTxServer, IqRxClient, iq_file_read, iq_file_write  # noqa: F401
from .events import (RadioEvents, RadioEventNotifier, SlotClock,  # noqa: F401
                     SlotDeadline, fail_open)
