"""Host utilities (copies of bcalm_tpu/utils): options, timing, DNA
helpers, the block prefetcher."""
