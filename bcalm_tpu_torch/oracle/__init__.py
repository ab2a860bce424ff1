"""Brute-force oracle (copy of bcalm_tpu/oracle/brute.py)."""
