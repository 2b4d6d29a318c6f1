"""The serving engine and its HTTP server (counterpart of
kosmosx_tpu/serve)."""

from kosmosx_torch.serve.engine import Request, ServeConfig, ServeEngine
from kosmosx_torch.serve.server import ServeServer

__all__ = ["Request", "ServeConfig", "ServeEngine", "ServeServer"]
