"""The benchmark of ``sarlacc_tpu_torch``: one cell a run (``run.py``)."""
