"""The benchmark of smore_tpu_torch (``python3 perfbench/run.py``)."""
