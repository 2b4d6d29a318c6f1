"""Image-embedding splicing."""
