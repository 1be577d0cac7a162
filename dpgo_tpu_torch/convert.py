"""Build the port's problem objects from the JAX package's arrays.

The JAX package's LocalProblem, QuadraticData, SPMDProblem and SPMDState
are pytrees of arrays; pass their data fields as numpy arrays
({name: np.asarray(value)}) and their meta fields (n, d, num_band,
band_offsets; for an SPMDProblem also num_agents, n_max, r) as a dict, and
get the port's object with the same values in the same edge order (the band
ordering that plan_bands chose included). That hands both packages the
identical problem. This module imports neither jax nor dpgo_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from dpgo_tpu_torch.parallel.spmd import SPMDProblem, SPMDState
from dpgo_tpu_torch.quadratic import LocalProblem, QuadraticData

_INDEX_FIELDS = (
    "priv_i", "priv_j", "priv_lane", "shared_idx", "shared_nbr_slot",
    "prior_idx", "off_i", "off_j", "shared_nbr_robot", "pub_idx", "it",
)
_BOOL_FIELDS = (
    "shared_outgoing", "priv_fixed_weight", "shared_fixed_weight",
    "robot_active", "do_restart",
)
_META_FIELDS = {"n", "d", "num_band", "band_offsets", "csr", "num_agents",
                "n_max", "r", "btf", "block_rows"}


def _tensor(name: str, value, device, dtype) -> torch.Tensor:
    a = np.array(value)  # a writable copy: JAX hands out read-only views
    if name in _INDEX_FIELDS:
        dt = torch.int64
    elif name in _BOOL_FIELDS:
        dt = torch.bool
    else:
        dt = dtype
    return torch.as_tensor(a, device=device).to(dt)


def _data_fields(cls, fields: Mapping[str, np.ndarray], device, dtype) -> dict:
    fields = {k: v for k, v in fields.items() if v is not None}
    names = {f.name for f in dataclasses.fields(cls)}
    names -= _META_FIELDS
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: no ported fields {sorted(unknown)}")
    return {k: _tensor(k, v, device, dtype) for k, v in fields.items()}


def local_problem_from_numpy(
    fields: Mapping[str, np.ndarray], meta: Mapping, device,
    dtype=torch.float64,
) -> LocalProblem:
    """The port's LocalProblem from a JAX LocalProblem's arrays."""
    return LocalProblem(
        n=int(meta["n"]), d=int(meta["d"]),
        num_band=int(meta.get("num_band", 0)),
        band_offsets=tuple(int(o) for o in meta.get("band_offsets", ())),
        **_data_fields(LocalProblem, fields, device, dtype),
    )


def quadratic_data_from_numpy(
    fields: Mapping[str, np.ndarray], meta: Mapping, device,
    dtype=torch.float64,
) -> QuadraticData:
    """The port's QuadraticData from a JAX QuadraticData's arrays (Jacobi
    form: diag, off_i, off_j, off_E, G, precond_inv and optionally band_E).
    CSR plans are not taken over: attach them with
    quadratic.attach_csr_plans."""
    return QuadraticData(
        n=int(meta["n"]), d=int(meta["d"]),
        band_offsets=tuple(int(o) for o in meta.get("band_offsets", ())),
        **_data_fields(QuadraticData, fields, device, dtype),
    )


def spmd_problem_from_numpy(
    fields: Mapping[str, np.ndarray], meta: Mapping, device,
    dtype=torch.float64,
) -> SPMDProblem:
    """The port's SPMDProblem from a JAX SPMDProblem's arrays."""
    return SPMDProblem(
        num_agents=int(meta["num_agents"]), n_max=int(meta["n_max"]),
        d=int(meta["d"]), r=int(meta["r"]), num_band=int(meta["num_band"]),
        band_offsets=tuple(int(o) for o in meta["band_offsets"]),
        **_data_fields(SPMDProblem, fields, device, dtype),
    )


def spmd_state_from_numpy(
    fields: Mapping[str, np.ndarray], device, dtype=torch.float64,
) -> SPMDState:
    """The port's SPMDState from a JAX SPMDState's arrays (X, Y, V, gamma,
    it, cost_X, do_restart)."""
    return SPMDState(**{k: _tensor(k, v, device, dtype)
                        for k, v in fields.items()})
