"""The port's copy of ``paddle_tpu/dataset/uci_housing.py``.

UCI housing regression (reference: python/paddle/v2/dataset/uci_housing.py
— 13 features normalized, float target)."""

import numpy as np

from paddle_tpu_torch.dataset import common, synthetic

FEATURE_DIM = 13


def _file_reader(path, start, end):
    def reader():
        data = np.loadtxt(path).astype(np.float32)
        feats = data[:, :-1]
        feats = (feats - feats.mean(0)) / np.maximum(feats.std(0), 1e-6)
        for row, target in zip(feats[start:end], data[start:end, -1]):
            yield row, np.array([target], np.float32)
    return reader


def train():
    p = common.cached_file("uci_housing", "housing.data")
    if p:
        return common.real_data(_file_reader(p, 0, 404))
    return common.synthetic_fallback(
        "uci_housing", "train", synthetic.regression(404, FEATURE_DIM,
                                                     seed=3))


def test():
    p = common.cached_file("uci_housing", "housing.data")
    if p:
        return common.real_data(_file_reader(p, 404, 506))
    return common.synthetic_fallback(
        "uci_housing", "test", synthetic.regression(102, FEATURE_DIM,
                                                    seed=33))


def convert(path, line_count=1024):
    """Write the dataset as recordio chunks (reference: the
    per-module convert() feeding cloud training)."""
    out = []
    out += common.convert(path, train(), line_count, 'uci_housing_train')
    out += common.convert(path, test(), line_count, 'uci_housing_test')
    return out
