"""The port's measurement tools, run as modules: ``quality_bench`` and
``scaling_bench`` (the counterparts of the repository's
``tools/quality_bench.py`` and ``tools/scaling_bench.py``, which run the
JAX package)."""
