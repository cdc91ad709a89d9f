"""PyTorch / CUDA port of the MPPI framework in ``mppi_tf_tpu``.

The solve runs as plain PyTorch on any device, or, for the point-mass
model with the static quadratic cost, through hand-written CUDA kernels
for Hopper (``kernels/pm_mppi.py``, ``csrc/pm_mppi.cu``). Importing the
package needs neither CUDA nor ``nvcc``: the kernels are built at their
first launch.
"""

__version__ = "0.1.0"
