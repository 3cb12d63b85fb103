"""User-facing parameter dict (counterpart of ``paddle_tpu/parameters.py``).

Reference: python/paddle/v2/parameters.py:44 — a numpy-backed dict mirroring
GradientMachine parameters, with to_tar/from_tar serialization. Here the
backing store is a dict of tensors on one device; numpy views are produced
on access. Non-trainable state (batch-norm stats) lives alongside in
``.state``.

``to_tar`` pickles plain numpy arrays, as the JAX package does, so a file
written by either package loads into the other bit for bit: this is how
weights carry across.
"""

import pickle
from typing import Dict, List

import numpy as np
import torch

from paddle_tpu_torch.core import place
from paddle_tpu_torch.core.param import ParamSpec, init_params
from paddle_tpu_torch.topology import Topology


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)


class Parameters:
    def __init__(self, specs: List[ParamSpec], values: Dict = None,
                 state_specs: List[ParamSpec] = (), state: Dict = None,
                 device=None):
        self.specs = {s.name: s for s in specs}
        self.state_specs = {s.name: s for s in state_specs}
        self.values: Dict = values or {}
        self.state: Dict = state or {}
        self.device = place.resolve_device(device)

    # -- dict-ish API (reference: parameters.py __getitem__/__setitem__) ----
    def names(self):
        return list(self.specs)

    def keys(self):
        return self.names()

    def __contains__(self, name):
        return name in self.specs

    def __getitem__(self, name) -> np.ndarray:
        return _to_numpy(self.values[name])

    def __setitem__(self, name, arr):
        spec = self.specs[name]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {spec.shape}")
        self.values[name] = _to_tensor(arr, self.device,
                                       spec.resolved_dtype())

    def get_shape(self, name):
        return tuple(self.specs[name].shape)

    # -- (de)serialisation (replaces to_tar/from_tar, v2 parameters.py) -----
    def to_tar(self, f):
        payload = {
            "values": {k: _to_numpy(v) for k, v in self.values.items()},
            "state": {k: _to_numpy(v) for k, v in self.state.items()},
        }
        pickle.dump(payload, f, protocol=4)

    def from_tar_into(self, f):
        payload = pickle.load(f)
        for k, v in payload["values"].items():
            if k in self.specs:
                self.values[k] = _to_tensor(v, self.device)
        for k, v in payload.get("state", {}).items():
            self.state[k] = _to_tensor(v, self.device)
        return self

    @staticmethod
    def from_tar(f, topology=None, device=None):
        payload = pickle.load(f)
        return Parameters.from_numpy(payload["values"],
                                     payload.get("state", {}), device)

    @staticmethod
    def from_numpy(values: Dict, state: Dict = None, device=None):
        """Parameters holding ``values`` / ``state`` (name -> array), on
        ``device`` (default: the card)."""
        specs = [ParamSpec(k, tuple(np.shape(v))) for k, v in values.items()]
        p = Parameters(specs, device=device)
        p.values = {k: _to_tensor(v, p.device) for k, v in values.items()}
        p.state = {k: _to_tensor(v, p.device)
                   for k, v in (state or {}).items()}
        return p


def create(output_or_topology, key_source=None, device=None) -> Parameters:
    """paddle.parameters.create(cost) (reference: v2 parameters.py create),
    initialised on ``device`` (default: the card)."""
    topo = output_or_topology if isinstance(output_or_topology, Topology) \
        else Topology(output_or_topology)
    specs = topo.param_specs()
    state_specs = topo.state_specs()
    p = Parameters(specs, state_specs=state_specs, device=device)
    p.values = init_params(specs, key_source, p.device)
    p.state = init_params(state_specs, key_source, p.device)
    return p
