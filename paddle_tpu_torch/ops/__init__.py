"""Operators (counterpart of ``paddle_tpu/ops``): plain functions on
tensors, each on the device of its inputs, and the hand-written Hopper
kernels under ``ops/kernels``. Importing this package builds and loads
no CUDA kernel: the kernels are built at their first launch."""

from paddle_tpu_torch.ops import math
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops import conv
from paddle_tpu_torch.ops import pool
from paddle_tpu_torch.ops import norm
from paddle_tpu_torch.ops import loss
from paddle_tpu_torch.ops import sequence
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops import sparse
from paddle_tpu_torch.ops import topk
from paddle_tpu_torch.ops import crf
from paddle_tpu_torch.ops import ctc

from paddle_tpu_torch.ops.math import matmul, linear
from paddle_tpu_torch.ops.sparse import embedding_lookup
