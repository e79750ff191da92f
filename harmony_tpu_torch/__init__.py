"""harmony_tpu_torch: Harmony single-cell integration in PyTorch and CUDA.

The PyTorch/CUDA port of ``harmony_tpu``. Plain tensor code is PyTorch;
the hot E-step round and the single-covariate M-step contractions are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use. Entry points (``run_harmony``, the adapters, ``bench`` and
the ``harmony-torch`` command) run on the card unless given
``device="cpu"``. Around the engine: checkpoint and resume
(:mod:`.checkpoint`), streamed ingest, abort and tracing (:mod:`.runtime`),
the bundled datasets (:mod:`.datasets`), ``scale_data`` with its native
helper, and a convergence plot. Runs on several devices shard the cells
over ``torch.distributed`` ranks (:mod:`.sharding`, ``run_harmony(mesh=)``).
This package imports neither JAX nor ``harmony_tpu``.
"""

from .api import HarmonyResult, run_harmony
from .config import HarmonyConfigError, HarmonyOptions, harmony_options
from .runtime import AbortFlag, DivergenceError
from .scale import scale_data

__all__ = [
    "run_harmony",
    "HarmonyResult",
    "harmony_options",
    "HarmonyOptions",
    "HarmonyConfigError",
    "DivergenceError",
    "AbortFlag",
    "scale_data",
]
