"""Studies that measure one question on the card (counterparts of the
JAX package's ``benchmarks/`` studies that carry a kernel of their own)."""
