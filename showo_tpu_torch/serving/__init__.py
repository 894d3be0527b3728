"""Continuous-batching serving (counterpart of ``showo_tpu.serving``)."""

from showo_tpu_torch.serving.engine import (ContinuousBatchingEngine, Request,
                                            Showo2MMUServer, ShowoMMUServer)

__all__ = ["ContinuousBatchingEngine", "Request", "Showo2MMUServer",
           "ShowoMMUServer"]
