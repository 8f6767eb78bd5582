"""polyp_tpu_torch — the PyTorch/CUDA port of polyp_tpu for NVIDIA Hopper.

Each module is the twin of the `polyp_tpu` module of the same name; the
JAX package stays the reference that the port's tests hold it against.
Plain tensor code is PyTorch (NCHW convolutions, `nn.Module`s whose
`state_dict` keys are diffusers'/transformers' keys); every Pallas kernel of
the ported path is a CUDA C++ kernel written by hand for `sm_90a`
(`csrc/`, built at first use by `_build.py`).

This package imports `torch` and never `jax`, `flax` or `polyp_tpu`.
"""

__version__ = "0.1.0"
