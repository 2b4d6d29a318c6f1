"""Attention, decoder, vision, resampler and multiway modules."""
