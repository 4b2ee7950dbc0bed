"""Pipeline stages of the port (``python -m
roadsurf_tpu_torch.pipeline.<stage> <config.yaml>``)."""
