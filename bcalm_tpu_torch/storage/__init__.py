"""The checkpoint store (copy of bcalm_tpu/storage)."""
