"""The benchmark harness of sepi_tpu_torch (see benchmark/run.py)."""
