"""Attention, decoder, vision, resampler and multiway modules, and the
modality zoo: audio (framed and wav2vec2), video (lean and r3d18) and the
unified trunk."""
