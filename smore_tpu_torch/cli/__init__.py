"""The command line: ``python -m smore_tpu_torch <model> ...``."""
