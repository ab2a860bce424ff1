"""bcalm_tpu_torch: the PyTorch + CUDA port of bcalm-tpu.

A second package beside ``bcalm_tpu`` (the JAX reference).  It mirrors the
reference's module names (engine, cli, models/lanes, ops/*, io/fasta_writer)
and runs the single-device build on an NVIDIA GPU with hand-written CUDA
kernels (csrc/), or on the CPU with their plain PyTorch versions.  It
imports torch and never jax.
"""
