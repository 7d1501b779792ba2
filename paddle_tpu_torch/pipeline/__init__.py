"""The input pipeline's device stage: `DeviceLoader` stages the next
batches into device memory on a side CUDA stream while the current step
runs (the reference's buffered_reader.cc double buffering; the JAX
package's pipeline/). The JAX package's `compile_counter` counts XLA
compiles and has no counterpart here: the port runs eagerly and compiles
no program."""
from .device_loader import DeviceLoader, default_placement  # noqa: F401

__all__ = ["DeviceLoader", "default_placement"]
