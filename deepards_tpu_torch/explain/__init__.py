"""Explainability (counterpart of ``deepards_tpu/explain``)."""
