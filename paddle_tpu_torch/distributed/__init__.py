"""Distributed (port of ``paddle_tpu/distributed``): the AMP
meta-optimizer of ``fleet/meta_optimizers.py`` and the scale policy
(``scaler``)."""
