"""The weight bridge from JAX parameter trees, W8 quantization, device
timing, checkpoint converters and parameter counts."""

from kosmosx_torch.utils.pytree import param_bytes, param_count

__all__ = ["param_count", "param_bytes"]
