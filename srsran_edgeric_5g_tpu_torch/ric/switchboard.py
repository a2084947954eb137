"""Live scheduling-algorithm switching — the redis key, without redis.

Port of ``srsran_edgeric_5g_tpu/ric/switchboard.py`` (a copy).

The reference switches the running muApp1 policy through the redis key
'scheduling_algorithm' read every loop iteration
(edgeric-v2/muApp1/muApp1_run_DL_scheduling.py:294-300), and muApp3 titles
its dashboard with the same key.  redis is external infrastructure this
environment doesn't ship, so the control plane here is a file key with the
same contract: any process writes the algorithm name, every consumer sees
it on its next TTI.  If a redis server IS reachable and the redis package
importable, ``RedisSwitch`` speaks the reference's exact key.
"""

from __future__ import annotations

import os
import tempfile

DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "edgeric_algorithm")
KEY = "scheduling_algorithm"   # the reference's redis key name


class AlgorithmSwitch:
    """File-backed live algorithm key (mtime-cached reads: one stat per
    get, a read only when the file changed)."""

    def __init__(self, path: str = DEFAULT_PATH, default: str = "max_cqi"):
        self.path = path
        self.default = default
        self._mtime = None
        self._value = default

    def set(self, algorithm: str) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(algorithm.strip())
        os.replace(tmp, self.path)   # atomic vs concurrent readers

    def get(self) -> str:
        try:
            m = os.stat(self.path).st_mtime_ns
        except OSError:
            return self._value
        if m != self._mtime:
            self._mtime = m
            with open(self.path) as f:
                v = f.read().strip()
            if v:
                self._value = v
        return self._value

    def clear(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass
        self._mtime = None
        self._value = self.default


class RedisSwitch:
    """The reference's actual control plane, when redis is available."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 default: str = "max_cqi"):
        import redis  # optional dependency, not shipped here
        self._db = redis.Redis(host=host, port=port, db=0,
                               decode_responses=True)
        self.default = default

    def set(self, algorithm: str) -> None:
        self._db.set(KEY, algorithm)

    def get(self) -> str:
        return self._db.get(KEY) or self.default
