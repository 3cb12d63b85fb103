"""Input type declarations for data layers and the feeder.

Reference: python/paddle/trainer/PyDataProvider2.py:109-250 — dense_vector,
sparse_binary_vector, sparse_float_vector, integer_value, each with
(no-)sequence / sub-sequence variants; carried into v2 as paddle.data_type.
"""

import dataclasses
from enum import Enum


class SeqLevel(Enum):
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class Kind(Enum):
    DENSE = 0
    SPARSE_BINARY = 1
    SPARSE_FLOAT = 2
    INDEX = 3


@dataclasses.dataclass(frozen=True)
class InputType:
    dim: int
    kind: Kind
    seq: SeqLevel = SeqLevel.NO_SEQUENCE


def dense_vector(dim):
    return InputType(dim, Kind.DENSE)


def dense_array(dim):  # alias used by some v2 configs
    return InputType(dim, Kind.DENSE)


def sparse_binary_vector(dim):
    return InputType(dim, Kind.SPARSE_BINARY)


def sparse_float_vector(dim):
    return InputType(dim, Kind.SPARSE_FLOAT)


def integer_value(value_range):
    return InputType(value_range, Kind.INDEX)


def dense_vector_sequence(dim):
    return InputType(dim, Kind.DENSE, SeqLevel.SEQUENCE)


def sparse_binary_vector_sequence(dim):
    return InputType(dim, Kind.SPARSE_BINARY, SeqLevel.SEQUENCE)


def sparse_float_vector_sequence(dim):
    return InputType(dim, Kind.SPARSE_FLOAT, SeqLevel.SEQUENCE)


def integer_value_sequence(value_range):
    return InputType(value_range, Kind.INDEX, SeqLevel.SEQUENCE)


def dense_vector_sub_sequence(dim):
    return InputType(dim, Kind.DENSE, SeqLevel.SUB_SEQUENCE)


def sparse_binary_vector_sub_sequence(dim):
    return InputType(dim, Kind.SPARSE_BINARY, SeqLevel.SUB_SEQUENCE)


def sparse_float_vector_sub_sequence(dim):
    return InputType(dim, Kind.SPARSE_FLOAT, SeqLevel.SUB_SEQUENCE)


def integer_value_sub_sequence(value_range):
    return InputType(value_range, Kind.INDEX, SeqLevel.SUB_SEQUENCE)
