"""Contrib APIs (port of ``paddle_tpu/contrib``): static AMP
(``mixed_precision``) and slim quantisation (``slim``: QAT, PTQ and the
int8 deployment convert)."""
