"""Sparse / embedding ops (counterpart of ``paddle_tpu/ops/sparse.py``).

An embedding lookup is a gather; its gradient with respect to the table
is autograd's scatter-add of the output rows (duplicate ids accumulate),
so no row-sparse gradient type is needed.
"""

import numpy as np
import torch

from paddle_tpu_torch.core import place


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     padding_idx: int = None) -> torch.Tensor:
    """table: [vocab, dim]; ids: int[...]. Returns [..., dim]."""
    out = torch.nn.functional.embedding(ids.long(), table)
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


def one_hot(ids: torch.Tensor, depth: int, dtype=torch.float32
            ) -> torch.Tensor:
    """[..., depth]; an id outside [0, depth) gives a zero row, as
    ``jax.nn.one_hot``."""
    return (ids[..., None] == torch.arange(depth, device=ids.device)).to(dtype)


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """table[ids] += rows (duplicate ids accumulate), out of place."""
    return table.index_add(0, ids.long(), rows.to(table.dtype))


def sparse_vector_to_dense(indices, values, dim, batch_offsets=None):
    """Host-side helper for sparse_vector inputs: a numpy [n, dim] array."""
    n = len(batch_offsets) - 1 if batch_offsets is not None else 1
    out = np.zeros((n, dim), np.float32)
    if batch_offsets is None:
        out[0, indices] = values if values is not None else 1.0
        return out
    for i in range(n):
        lo, hi = batch_offsets[i], batch_offsets[i + 1]
        out[i, indices[lo:hi]] = values[lo:hi] if values is not None else 1.0
    return out


def _tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


class CSRMatrix:
    """Compressed-sparse-row matrix with a static nnz: indptr [rows+1],
    indices [nnz], data [nnz]; padding entries (beyond a row's true nnz)
    carry index 0 / data 0, so every product is a masked gather and a
    segment sum with no host read. Tensors live on ``device`` (default:
    ``data``'s device when it is a tensor, else the card)."""

    def __init__(self, indptr, indices, data, shape, device=None):
        if device is None and isinstance(data, torch.Tensor):
            device = data.device
        device = place.resolve_device(device)
        self.indptr = _tensor(indptr, torch.int32, device)
        self.indices = _tensor(indices, torch.int32, device)
        self.data = (data.to(device) if isinstance(data, torch.Tensor)
                     else torch.from_numpy(np.asarray(data)).to(device))
        self.shape = tuple(shape)

    @classmethod
    def from_dense(cls, dense, device=None):
        if isinstance(dense, torch.Tensor):
            device = dense.device if device is None else device
            dense = dense.cpu().numpy()
        d = np.asarray(dense)
        rows, cols = d.shape
        indptr = [0]
        indices, data = [], []
        for r in range(rows):
            nz = np.nonzero(d[r])[0]
            indices.extend(nz.tolist())
            data.extend(d[r, nz].tolist())
            indptr.append(len(indices))
        return cls(np.asarray(indptr), np.asarray(indices, np.int64),
                   np.asarray(data, d.dtype), (rows, cols), device=device)

    def _row_of(self) -> torch.Tensor:
        """Row of each stored entry (padding entries: ``rows``)."""
        entry = torch.arange(self.indices.shape[0], dtype=torch.int32,
                             device=self.indices.device)
        return torch.searchsorted(self.indptr[1:].contiguous(), entry,
                                  right=True)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.shape[0] + 1, self.shape[1]),
                          dtype=self.data.dtype, device=self.data.device)
        out.index_put_((self._row_of(), self.indices.long()), self.data,
                       accumulate=True)
        return out[:self.shape[0]]

    @property
    def nnz(self):
        return int(self.indptr[-1])

    def matmul_dense(self, b: torch.Tensor) -> torch.Tensor:
        """CSR @ dense via gather + segment sum (static nnz)."""
        contrib = self.data[:, None] * b[self.indices.long()]  # [nnz, cols]
        out = torch.zeros((self.shape[0] + 1, b.shape[1]), dtype=contrib.dtype,
                          device=contrib.device)
        # padding entries' row is ``rows``: the extra row drops them
        return out.index_add_(0, self._row_of(), contrib)[:self.shape[0]]

    def transpose_matmul_dense(self, b: torch.Tensor) -> torch.Tensor:
        """CSR^T @ dense — scatter-add into the column space."""
        row_of = torch.clamp(self._row_of(), max=self.shape[0] - 1)
        contrib = self.data[:, None] * b[row_of]                # [nnz, cols]
        out = torch.zeros((self.shape[1], b.shape[1]), dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add_(0, self.indices.long(), contrib)
