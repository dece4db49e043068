"""ratio_guided_multimodal_fm_tpu_torch — the PyTorch / CUDA port.

The JAX package `ratio_guided_multimodal_fm_tpu` is the reference; this
package re-implements it for an NVIDIA Hopper GPU (H100). It imports
`torch` and numpy only — never `jax` and nothing of the JAX package — and
mirrors the JAX package's layout (`models/`, `ops/`, `flow/`, `sample/`,
`cli/`, ...), so `x/y.py` here ports `x/y.py` there.

Conventions:
* Public sampler functions take and return NHWC tensors like the JAX ones;
  the networks themselves are NCHW `nn.Module`s whose state-dict keys are
  the reference torch layout (`interop/from_jax.py` converts flax trees).
* Entry points run on `cuda` unless the caller asks for `cpu`
  (`core/device.py`); they never fall back to the CPU silently.
* Every Pallas kernel of the JAX package on the ported path has a
  hand-written Hopper counterpart in `ops/` (CUDA C++ sources in `csrc/`),
  each beside its plain PyTorch version. A kernel
  wrapper runs the plain version only for CPU tensors.
"""

__version__ = "0.1.0"

from ratio_guided_multimodal_fm_tpu_torch.core.prng import set_seed  # noqa: E402,F401
