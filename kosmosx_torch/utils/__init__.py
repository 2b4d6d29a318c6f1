"""The weight bridge from JAX parameter trees, W8 quantization, and device
timing."""
