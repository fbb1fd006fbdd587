"""SignalMonitor: touch-file polling for an orderly stop during training.

When the file at ``signal_path`` appears, ``should_stop`` consumes it and
returns True; the trainer then saves and stops. The trainer polls once per
log interval.
"""

from __future__ import annotations

import os
from typing import Optional


class SignalMonitor:
    def __init__(self, signal_path: Optional[str] = None):
        self.signal_path = signal_path

    def should_stop(self) -> bool:
        if not self.signal_path or not os.path.exists(self.signal_path):
            return False
        try:
            os.remove(self.signal_path)  # consume the signal
        except OSError:
            pass
        return True
