"""Host-side batch assembly: python samples → device Values (counterpart
of ``paddle_tpu/data_feeder.py``, with the same length buckets).

Reference: python/paddle/v2/data_feeder.py:28 (DataFeeder → Arguments) and
py_paddle/dataprovider_converter.py — converts per-slot python data
(dense / sparse / index, with optional sequence nesting per
PyDataProvider2.py:109-250) into the engine's input structures.

Everything becomes padded/bucketed arrays, so batch shapes come from a
small fixed set:
- DENSE           -> [b, dim] float32
- INDEX           -> [b] int32
- DENSE seq       -> [b, T] + lengths (T bucketed)
- INDEX seq       -> [b, T] int32 + lengths
- SPARSE_*        -> indices [b, K] + weights [b, K] (K bucketed nonzeros)
- SPARSE_* seq    -> indices [b, T, K] + weights [b, T, K] + lengths
The tensors land on ``device`` (default: the card).
"""

from typing import Dict, List, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import place
from paddle_tpu_torch.core.ragged import (DEFAULT_BUCKETS, SequenceBatch,
                                          bucket_length, sub_lengths_matrix)
from paddle_tpu_torch.data_type import InputType, Kind, SeqLevel
from paddle_tpu_torch.topology import Value
from paddle_tpu_torch.utils import enforce


class DataFeeder:
    def __init__(self, data_types: Dict[str, InputType],
                 feeding: Dict[str, int] = None, buckets=DEFAULT_BUCKETS,
                 device=None):
        """data_types: layer name -> InputType; feeding: name -> index in the
        sample tuple (defaults to declaration order)."""
        self.data_types = data_types
        names = list(data_types)
        self.feeding = feeding or {n: i for i, n in enumerate(names)}
        self.buckets = buckets
        self.device = place.resolve_device(device)

    def __call__(self, batch: Sequence) -> Dict[str, Value]:
        return self.feed(batch)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _is_prebatched(self, batch) -> bool:
        """True for a tuple of whole-column ndarrays (one per slot, same
        leading batch dim, dense slots with an explicit batch axis)."""
        if not (isinstance(batch, tuple) and batch
                and len(batch) == len(self.data_types)
                and all(isinstance(c, np.ndarray) for c in batch)):
            return False
        lead = set()
        for name, itype in self.data_types.items():
            idx = self.feeding[name]
            if idx >= len(batch):
                return False
            c = batch[idx]
            need = 2 if itype.kind == Kind.DENSE and itype.dim > 1 else 1
            if c.ndim < need:
                return False
            lead.add(c.shape[0])
        return len(lead) == 1

    def feed(self, batch: Sequence) -> Dict[str, Value]:
        feeds = {}
        if self._is_prebatched(batch):
            # pre-batched column arrays: one ndarray per slot, consistent
            # leading batch dim — skip per-sample assembly entirely
            for name, itype in self.data_types.items():
                col = batch[self.feeding[name]]
                enforce.enforce(
                    itype.kind in (Kind.DENSE, Kind.INDEX)
                    and itype.seq == SeqLevel.NO_SEQUENCE,
                    f"pre-batched feed supports dense/index slots only "
                    f"(slot {name!r})")
                if itype.kind == Kind.INDEX:
                    arr = np.ascontiguousarray(col, dtype=np.int32).reshape(-1)
                    self._check_index_range(arr, itype.dim, name)
                else:
                    arr = np.ascontiguousarray(col, dtype=np.float32)
                feeds[name] = Value(self._t(arr))
            return feeds
        for name, itype in self.data_types.items():
            col = [sample[self.feeding[name]] for sample in batch]
            feeds[name] = self._convert(col, itype, name)
        return feeds

    @staticmethod
    def _check_index_range(arr: np.ndarray, dim: int, name: str):
        """Out-of-range ids would surface as silent garbage many layers
        later — fail here with the slot named instead."""
        if not arr.size:
            return
        mn, mx = int(arr.min()), int(arr.max())
        if mn < 0 or mx >= dim:
            raise ValueError(
                f"input '{name}': index {mn if mn < 0 else mx} out of "
                f"range for dimension {dim}")

    def _convert(self, col: List, itype: InputType, name: str = "?") -> Value:
        dev = self.device
        if itype.seq == SeqLevel.NO_SEQUENCE:
            if itype.kind == Kind.DENSE:
                return Value(self._t(np.asarray(col, np.float32)))
            if itype.kind == Kind.INDEX:
                arr = np.asarray(col, np.int32)
                self._check_index_range(arr, itype.dim, name)
                return Value(self._t(arr))
            return self._sparse(col, itype, name)
        if itype.seq == SeqLevel.SUB_SEQUENCE:
            if itype.kind in (Kind.SPARSE_BINARY, Kind.SPARSE_FLOAT):
                # flatten sub-sequences on the time axis and record the split
                flat = [[ts for sub in subs for ts in sub] for subs in col]
                subl = sub_lengths_matrix(col)
                return self._sparse_seq(flat, itype, name,
                                        sub_lengths=self._t(subl))
            if itype.kind == Kind.INDEX:
                nested = [[np.asarray(s, np.int32) for s in subs]
                          for subs in col]
                for subs in nested:
                    for a in subs:
                        self._check_index_range(a, itype.dim, name)
                sb = SequenceBatch.from_nested_list(nested, self.buckets,
                                                    device=dev)
            else:
                sb = SequenceBatch.from_nested_list(
                    [[np.asarray(s, np.float32) for s in subs] for subs in col],
                    self.buckets, device=dev)
            return Value(sb.data, sb.lengths, sb.sub_lengths)
        # SEQUENCE
        if itype.kind == Kind.INDEX:
            seqs = [np.asarray(s, np.int32) for s in col]
            for a in seqs:
                self._check_index_range(a, itype.dim, name)
            sb = SequenceBatch.from_list(seqs, self.buckets, device=dev)
        elif itype.kind == Kind.DENSE:
            sb = SequenceBatch.from_list([np.asarray(s, np.float32) for s in col],
                                         self.buckets, device=dev)
        else:
            return self._sparse_seq(col, itype, name)
        return Value(sb.data, sb.lengths)

    def _sparse_seq(self, col, itype, name: str = "?",
                    sub_lengths=None) -> Value:
        """Per-timestep sparse rows: each sample is a list over timesteps,
        each timestep a list of indices (binary) or (index, value) pairs.
        Both the time axis and the per-timestep nonzero count are bucketed."""
        T = bucket_length(max((len(s) for s in col), default=1),
                          self.buckets)
        K = bucket_length(
            max((len(ts) for s in col for ts in s), default=1),
            self.buckets)
        ids = np.zeros((len(col), T, K), np.int32)
        w = np.zeros((len(col), T, K), np.float32)
        lengths = np.zeros((len(col),), np.int32)
        for i, s in enumerate(col):
            lengths[i] = len(s)
            for t, ts in enumerate(s):
                if itype.kind == Kind.SPARSE_BINARY:
                    idx = list(ts)
                    vals = [1.0] * len(idx)
                else:
                    idx = [p[0] for p in ts]
                    vals = [p[1] for p in ts]
                ids[i, t, : len(idx)] = idx
                w[i, t, : len(vals)] = vals
        self._check_index_range(ids, itype.dim, name)
        return Value(self._t(ids), self._t(lengths), sub_lengths,
                     weights=self._t(w))

    def _sparse(self, col, itype, name: str = "?") -> Value:
        """sparse_binary_vector: sample is a list of indices;
        sparse_float_vector: list of (index, value)."""
        k = bucket_length(max((len(s) for s in col), default=1), self.buckets)
        ids = np.zeros((len(col), k), np.int32)
        w = np.zeros((len(col), k), np.float32)
        for i, s in enumerate(col):
            if itype.kind == Kind.SPARSE_BINARY:
                idx = list(s)
                vals = [1.0] * len(idx)
            else:
                idx = [p[0] for p in s]
                vals = [p[1] for p in s]
            ids[i, : len(idx)] = idx
            w[i, : len(vals)] = vals
        self._check_index_range(ids, itype.dim, name)
        return Value(self._t(ids), weights=self._t(w))
