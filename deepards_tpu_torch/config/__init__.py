"""Run configuration (counterpart of ``deepards_tpu/config``)."""
