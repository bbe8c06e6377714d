"""The benchmark of dynibar_tpu_torch (see run.py)."""
