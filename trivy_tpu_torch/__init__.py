"""trivy_tpu_torch: the PyTorch/CUDA port of trivy_tpu's secret engine.

A package of its own beside `trivy_tpu/` (the JAX reference it is held
against).  It imports torch and numpy, never jax and never any `trivy_tpu`
module: the jax-free pieces it needs (rule model, regex translation, probe
and gram compilation, the oracle, packing) are copies kept here.

Every entry point takes `device` and defaults to "cuda"; asking for CUDA on
a host without a card raises (see `device.resolve_device`).  The CPU is used
only when the caller asks for it, as the tests do.

`__version__` is the distribution's version (`pyproject.toml`), the same
string as `trivy_tpu.__version__`: the compiled-rules registry's manifest
pins it as `trivy_tpu_version`, and both packages read and write one
artifact (`registry/store.py`).  Each pins its framework beside it
(`torch_version` here, `jax_version` there) and checks that pin only when
the manifest carries it, so an artifact either package writes loads
through the other in strict mode.
"""

__version__ = "0.1.0"

from trivy_tpu_torch.device import resolve_device  # noqa: F401
