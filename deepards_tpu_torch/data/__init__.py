"""Data: cohort ETL, window cache, splits and the normalization
pipeline (counterpart of ``deepards_tpu/data``)."""
