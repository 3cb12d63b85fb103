"""The port's copy of ``paddle_tpu/dataset/cifar.py``.

CIFAR-10/100 (reference: python/paddle/v2/dataset/cifar.py — pickled
batches of (3072-float [0,1] CHW, int label))."""

import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common, synthetic

CIFAR10 = "cifar-10-python.tar.gz"
CIFAR100 = "cifar-100-python.tar.gz"


def _tar_reader(path, sub_name, label_key):
    def reader():
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if sub_name not in member.name:
                    continue
                batch = pickle.load(tf.extractfile(member), encoding="latin1")
                for x, y in zip(batch["data"], batch[label_key]):
                    yield (x / 255.0).astype(np.float32), int(y)
    return reader


def train10():
    p = common.cached_file("cifar", CIFAR10)
    if p:
        return common.real_data(_tar_reader(p, "data_batch", "labels"))
    return common.synthetic_fallback(
        "cifar", "train10",
        synthetic.classification(8192, 3072, 10, seed=11, noise=0.5))


def test10():
    p = common.cached_file("cifar", CIFAR10)
    if p:
        return common.real_data(_tar_reader(p, "test_batch", "labels"))
    return common.synthetic_fallback(
        "cifar", "test10",
        synthetic.classification(1024, 3072, 10, seed=111, noise=0.5))


def train100():
    p = common.cached_file("cifar", CIFAR100)
    if p:
        return common.real_data(_tar_reader(p, "train", "fine_labels"))
    return common.synthetic_fallback(
        "cifar", "train100",
        synthetic.classification(8192, 3072, 100, seed=13, noise=0.5))


def test100():
    p = common.cached_file("cifar", CIFAR100)
    if p:
        return common.real_data(_tar_reader(p, "test", "fine_labels"))
    return common.synthetic_fallback(
        "cifar", "test100",
        synthetic.classification(1024, 3072, 100, seed=131, noise=0.5))


def convert(path, line_count=1024):
    """Write the dataset as recordio chunks (reference: the
    per-module convert() feeding cloud training)."""
    out = []
    out += common.convert(path, train10(), line_count, 'cifar_train10')
    out += common.convert(path, test10(), line_count, 'cifar_test10')
    out += common.convert(path, train100(), line_count, 'cifar_train100')
    out += common.convert(path, test100(), line_count, 'cifar_test100')
    return out
