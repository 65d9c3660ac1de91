"""Contrib APIs (port of ``paddle_tpu/contrib``): static AMP only."""
