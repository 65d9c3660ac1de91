"""Distributed training (port of ``paddle_tpu/distributed``): only the
AMP meta-optimizer of ``fleet/meta_optimizers.py`` so far."""
