"""KV-cache generation and sampling."""
