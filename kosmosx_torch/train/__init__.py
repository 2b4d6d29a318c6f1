"""Training: losses, optimizers, synthetic data, checkpoints and the
``Trainer`` (counterpart of kosmosx_tpu/train, one device)."""
