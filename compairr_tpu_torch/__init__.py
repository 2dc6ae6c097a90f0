"""compairr_tpu_torch — the PyTorch/CUDA port of compairr_tpu.

The same CompAIRR commands (--matrix, --existence, --cluster,
--deduplicate) over the same host routes, with the device engine in
PyTorch and its kernels written by hand in CUDA C++ for Hopper
(ops/kernels.py, csrc/). The package imports neither jax nor
compairr_tpu: every host module it needs is its own copy.
"""

__version__ = "0.1.0"

PROG_CMD = "compairr_tpu_torch"
PROG_NAME = "CompAIRR-TPU-Torch"
PROG_BRIEF = "Comparison of Adaptive Immune Receptor Repertoires on GPU"
