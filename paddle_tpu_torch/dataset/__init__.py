"""The port's copy of ``paddle_tpu/dataset/__init__.py``.

Datasets (reference: python/paddle/v2/dataset/ — mnist, cifar, imdb,
imikolov, movielens, conll05, uci_housing, wmt14, ...).

Nothing downloads: each dataset module follows the reference's
download-cache protocol (common.py:62) over files placed under
``common.DATA_HOME`` (``PADDLE_TPU_DATA_HOME``, default
~/.cache/paddle_tpu/dataset, the JAX package's too) and falls back to a
deterministic synthetic generator with identical sample schema when no
cache is present, so training plumbing, shapes and convergence behaviour
stay testable without the corpora.
"""

from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.dataset import cifar
from paddle_tpu_torch.dataset import uci_housing
from paddle_tpu_torch.dataset import imdb
from paddle_tpu_torch.dataset import imikolov
from paddle_tpu_torch.dataset import movielens
from paddle_tpu_torch.dataset import conll05
from paddle_tpu_torch.dataset import wmt14
from paddle_tpu_torch.dataset import sentiment
from paddle_tpu_torch.dataset import voc2012
from paddle_tpu_torch.dataset import flowers
from paddle_tpu_torch.dataset import mq2007
from paddle_tpu_torch.dataset import synthetic
