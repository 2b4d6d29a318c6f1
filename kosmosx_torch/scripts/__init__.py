"""Command-line entry points (``python -m kosmosx_torch.scripts.<name>``)."""
