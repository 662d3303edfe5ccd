"""Utilities (counterpart of ``deepards_tpu/utils``)."""
