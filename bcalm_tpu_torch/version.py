"""Version info for bcalm-tpu.

Mirrors the reference's VERSION/git-SHA banner machinery
(reference/CMakeLists.txt:21-40, reference/src/main.cpp:30-37).

Copy of ``bcalm_tpu/version.py`` with the imports pointed at this package
(and the reference's paths given from its root):
the port imports nothing of the JAX package.
"""

__version__ = "0.1.0"
COMPATIBLE_REFERENCE = "BCALM v2.2.3"


def version_string() -> str:
    return f"bcalm-tpu {__version__} (capability target: {COMPATIBLE_REFERENCE})"
