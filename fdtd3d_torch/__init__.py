"""fdtd3d_torch: the PyTorch/CUDA port of the fdtd3d_tpu FDTD solver.

A second package beside the JAX reference ``fdtd3d_tpu``: the same
configurations, command files and outputs, run with PyTorch on one
NVIDIA H100, with each TPU kernel of the reference replaced by a CUDA
kernel written by hand for Hopper (``fdtd3d_torch/csrc``). The port
imports nothing of the reference package.
"""

from fdtd3d_torch.config import SimConfig
from fdtd3d_torch.sim import Simulation

__all__ = ["SimConfig", "Simulation"]
