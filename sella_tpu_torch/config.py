"""Global configuration for sella_tpu_torch.

The optimizer state is float64, as in the JAX package: the trust-region
and Davidson machinery relies on tolerances down to 1e-15, and guards
such as the ``1e-300`` floors in ``_rfo_secular`` and
``pinv_shift_apply`` flush to zero in float32. Nothing here changes
PyTorch's global default dtype: every tensor the package creates takes
its dtype from an input tensor or from :func:`default_dtype`.
"""
from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64


def default_dtype() -> torch.dtype:
    """The floating dtype of optimizer state (float64)."""
    return DEFAULT_DTYPE
