"""The benchmark of ``lbm_tpu_torch`` on one NVIDIA H100: see ``run.py``."""
