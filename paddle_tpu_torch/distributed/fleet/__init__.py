"""Fleet (port of ``paddle_tpu/distributed/fleet``): the AMP
meta-optimizer only."""
