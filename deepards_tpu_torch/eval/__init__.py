"""Metrics and results (counterpart of ``deepards_tpu/eval``)."""
