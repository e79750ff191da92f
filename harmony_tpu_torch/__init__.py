"""harmony_tpu_torch: Harmony single-cell integration in PyTorch and CUDA.

The PyTorch/CUDA port of ``harmony_tpu``. Plain tensor code is PyTorch;
the hot E-step round and the single-covariate M-step contractions are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use. Entry points run on the card unless given ``device="cpu"``.
This package imports neither JAX nor ``harmony_tpu``.
"""

from .api import HarmonyResult, run_harmony
from .config import HarmonyConfigError, HarmonyOptions, harmony_options
from .runtime import DivergenceError

__all__ = [
    "run_harmony",
    "HarmonyResult",
    "harmony_options",
    "HarmonyOptions",
    "HarmonyConfigError",
    "DivergenceError",
]
