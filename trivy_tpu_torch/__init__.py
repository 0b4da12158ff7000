"""trivy_tpu_torch: the PyTorch/CUDA port of trivy_tpu's secret engine.

A package of its own beside `trivy_tpu/` (the JAX reference it is held
against).  It imports torch and numpy, never jax and never any `trivy_tpu`
module: the jax-free pieces it needs (rule model, regex translation, probe
and gram compilation, the oracle, packing) are copies kept here.

Every entry point takes `device` and defaults to "cuda"; asking for CUDA on
a host without a card raises (see `device.resolve_device`).  The CPU is used
only when the caller asks for it, as the tests do.
"""

from trivy_tpu_torch.device import resolve_device  # noqa: F401
