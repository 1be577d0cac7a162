"""Where the public drivers run, and at which float32 precision.

The drivers (solve_pgo, rtr_solve_auto and the SPMD engine's) run on the
CUDA card unless the caller names another device; there is no silent
fallback to the CPU. Inner helpers take a keyword-only `device` with no
default instead.
"""

from __future__ import annotations

import dataclasses
import functools

import torch


def resolve(device, caller: str) -> torch.device:
    """`device` as a torch.device; None means the CUDA card, and raises
    where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{caller} runs on the CUDA card by default and there is "
                f"none; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def move(obj, device):
    """obj with every tensor on `device`: a tensor, or a dataclass or tuple
    (named or not) holding tensors, nested. Other values pass through."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: move(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        vals = [move(v, device) for v in obj]
        return obj._make(vals) if hasattr(obj, "_make") else tuple(vals)
    return obj


def highest(fn):
    """Run `fn` with float32 matrix products in full float32 (TF32 off),
    whatever the process-wide setting: the counterpart of the JAX package's
    Precision.HIGHEST, for the functions where it passes that. A caller that
    turned TF32 on for its own work does not change their numbers."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not torch.backends.cuda.matmul.allow_tf32:
            return fn(*args, **kwargs)
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = True

    return wrapped
