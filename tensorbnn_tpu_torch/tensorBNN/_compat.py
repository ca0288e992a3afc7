"""Shared shim helpers: dtype translation and warm-start plumbing."""

from __future__ import annotations

import numpy as np
import torch


def to_torch_dtype(dtype):
    """Maps TF dtype objects / numpy dtypes / strings to a torch dtype, as
    the JAX shim's ``to_jnp_dtype`` maps them to jnp ones: float64 becomes
    float32 (the JAX shim's default, so both shims compute the same
    thing), bfloat16 stays bfloat16, everything else is float32."""
    if dtype is None:
        return torch.float32
    name = getattr(dtype, "name", None) or str(dtype)
    if "float64" in name:
        return torch.float32
    if "float16" in name or "bfloat16" in name:
        return torch.bfloat16 if "b" in name else torch.float32
    return torch.float32


def ref_dense_warm_start(weights, biases):
    """Converts reference-layout (W: (out, in), b: (out, 1)) starts into the
    framework's params override dict."""
    out = {}
    if weights is not None:
        out["w"] = np.asarray(weights).T
    if biases is not None:
        out["b"] = np.asarray(biases).reshape(-1)
    return out or None
