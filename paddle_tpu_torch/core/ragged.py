"""Variable-length sequence batches (counterpart of
``paddle_tpu/core/ragged.py``).

Sequences are padded to a bucketed max length with an explicit
``lengths`` vector, ``[batch, time, ...]``, as in the JAX package, so
sequence ops and the layer API take the same layout. Bucketing bounds
the number of distinct shapes a caller meets.
"""

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import place

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def sub_lengths_matrix(nested: List[List]) -> np.ndarray:
    """[batch, max_subseqs] int32 lengths of each sample's sub-sequences
    (level-2 LoD split record) — shared by every level-2 ingestion path."""
    max_subs = max((len(subs) for subs in nested), default=1)
    subl = np.zeros((len(nested), max_subs), np.int32)
    for i, subs in enumerate(nested):
        for j, s in enumerate(subs):
            subl[i, j] = len(s)
    return subl


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; beyond the last bucket, round up to a
    multiple of it."""
    for b in buckets:
        if n <= b:
            return int(b)
    last = int(buckets[-1])
    return ((int(n) + last - 1) // last) * last


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` with the JAX package's 32-bit dtypes
    (``jnp.asarray`` without x64 turns int64 into int32 and float64 into
    float32)."""
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class SequenceBatch:
    """A batch of variable-length sequences, padded + masked.

    data:    [batch, time, ...] padded values
    lengths: [batch] int32 true lengths
    sub_lengths: optional [batch, max_subseqs] int32 — lengths of the
        sub-sequences making up each sequence (level-2 LoD); sum over
        valid entries equals ``lengths``.
    """
    data: torch.Tensor
    lengths: torch.Tensor
    sub_lengths: Optional[torch.Tensor] = None

    def to(self, device) -> "SequenceBatch":
        sub = None if self.sub_lengths is None else self.sub_lengths.to(device)
        return SequenceBatch(self.data.to(device), self.lengths.to(device),
                             sub)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_list(cls, seqs: List[np.ndarray], buckets=DEFAULT_BUCKETS,
                  dtype=None, pad_value=0, device=None):
        """Build from a python list of per-sequence arrays ([len, ...]
        each), on ``device`` (default: the card)."""
        device = place.resolve_device(device)
        seqs = [np.asarray(s) for s in seqs]
        max_len = bucket_length(max((len(s) for s in seqs), default=1),
                                buckets)
        feat = seqs[0].shape[1:] if seqs else ()
        dtype = dtype or (seqs[0].dtype if seqs else np.float32)
        data = np.full((len(seqs), max_len) + feat, pad_value, dtype=dtype)
        lengths = np.zeros((len(seqs),), np.int32)
        for i, s in enumerate(seqs):
            data[i, : len(s)] = s
            lengths[i] = len(s)
        return cls(_to_tensor(data, device), _to_tensor(lengths, device))

    @classmethod
    def from_nested_list(cls, nested: List[List[np.ndarray]],
                         buckets=DEFAULT_BUCKETS, dtype=None, pad_value=0,
                         device=None):
        """Level-2: each element is a list of sub-sequences; they are
        concatenated on the time axis and sub_lengths records the split."""
        device = place.resolve_device(device)
        # infer feat/dtype from real data so empty entries don't poison them
        proto = next((np.asarray(s) for subs in nested for s in subs), None)
        empty = (np.zeros((0,) + proto.shape[1:], proto.dtype)
                 if proto is not None else np.zeros((0,), np.float32))
        flat = [np.concatenate([np.asarray(s) for s in subs], axis=0) if subs
                else empty for subs in nested]
        out = cls.from_list(flat, buckets, dtype, pad_value, device=device)
        return cls(out.data, out.lengths,
                   _to_tensor(sub_lengths_matrix(nested), device))

    # -- views -------------------------------------------------------------
    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """[batch, time] validity mask."""
        t = torch.arange(self.max_len, dtype=torch.int32,
                         device=self.lengths.device)
        return (t[None, :] < self.lengths[:, None]).to(dtype)

    def segment_ids(self) -> torch.Tensor:
        """Flattened [batch*time] segment ids; padding slots get id=batch
        (one-past-last), so a segment sum over ``batch`` segments drops
        them."""
        valid = self.mask(torch.bool)
        ids = torch.arange(self.batch_size, dtype=torch.int32,
                           device=valid.device)[:, None].expand(
                               self.batch_size, self.max_len)
        ids = torch.where(valid, ids, self.batch_size)
        return ids.reshape(-1)

    def flat_data(self) -> torch.Tensor:
        """[batch*time, ...] flattened values (padding rows included)."""
        return self.data.reshape((-1,) + tuple(self.data.shape[2:]))

    def with_data(self, data: torch.Tensor) -> "SequenceBatch":
        return SequenceBatch(data, self.lengths, self.sub_lengths)

    def sub_segment_mask(self) -> torch.Tensor:
        """[batch, time] int32 sub-sequence index of each timestep
        (level-2); requires sub_lengths. Padding gets the one-past-last
        sub index."""
        if self.sub_lengths is None:
            raise ValueError("no sub_lengths on this SequenceBatch")
        # timestep t belongs to the first sub whose cumulative end exceeds t
        ends = torch.cumsum(self.sub_lengths, dim=1)               # [b, S]
        t = torch.arange(self.max_len, dtype=torch.int32,
                         device=ends.device)                       # [T]
        return (t[None, :, None] >= ends[:, None, :]).sum(-1).to(torch.int32)
