"""The trainers' metric tracker.

Counterpart of ``showo_tpu/utils/logging.py::Tracker`` as far as the
port's trainers use it: with ``wandb_enabled: false`` (the configs'
default) it keeps the logged metrics in ``history``; wandb itself is not
ported (``enabled=True`` raises NotImplementedError).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Tracker:
    def __init__(self, project: Optional[str] = None,
                 name: Optional[str] = None, enabled: bool = False, **_):
        if enabled:
            raise NotImplementedError(
                "wandb logging is not ported; set wandb_enabled: false")
        self.project, self.name = project, name
        self.history: list = []

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        self.history.append((step, dict(metrics)))

    def finish(self):
        pass
