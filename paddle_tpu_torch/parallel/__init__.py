"""Distribution layer: meshes, shardings and collectives (counterpart of
``paddle_tpu/parallel/``).

Replaces the reference's distribution stack — MultiGradientMachine
thread-ring data parallelism, the C++ and Go parameter servers and the
NCCL ops — with explicit collectives over ``torch.distributed`` process
groups, one process per rank, on ``DeviceMesh``es."""

from paddle_tpu_torch.core.place import (AXIS_DATA, AXIS_EXPERT, AXIS_MODEL,
                                         AXIS_SEQ, AXIS_STAGE, default_mesh,
                                         make_mesh)
from paddle_tpu_torch.parallel.spmd import (DistConfig, data_model_parallel,
                                            data_parallel,
                                            embedding_vocab_rule,
                                            fc_column_rule, fc_row_rule,
                                            zero_constrained_update)
