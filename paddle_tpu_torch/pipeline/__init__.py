"""The asynchronous, checkpointable input pipeline (counterpart of
``paddle_tpu/pipeline/``).

The staged data-feeding subsystem (reference slot: the v1
PyDataProvider2 async pool + the Go master's chunk dispatch): a
resumable :class:`Source` flows through parallel transform workers, a
streaming shuffle, and a batcher into a bounded host staging ring; a
device stage converts and transfers batches ahead of the training step.
``Pipeline.state_dict()`` captures the exact stream position (source
cursor, in-flight transform samples, shuffle RNG + buffer, batch
counter) and rides inside checkpoints, so preemption recovery resumes
on the exact next batch.

Typical wiring::

    from paddle_tpu_torch import pipeline

    pipe = pipeline.Pipeline(
        pipeline.ShardSource(["part-00000", "part-00001"], seed=7),
        transform=decode_fn, transform_workers=4,
        shuffle_size=4096, batch_size=128, prefetch=4)
    trainer.train(reader=pipe, num_passes=10,
                  checkpoint_dir="ckpts")      # state saved + restored

or, for any existing batch reader, just ``trainer.train(reader=...,
prefetch=4)`` — the trainer wraps it in a pipeline with replay-skip
resume.
"""

from paddle_tpu_torch.pipeline.core import (  # noqa: F401
    Pipeline, PipelineClosed)
from paddle_tpu_torch.pipeline.source import (  # noqa: F401
    MasterSource, ReaderSource, ShardSource, Source, as_source)
from paddle_tpu_torch.pipeline.stages import (  # noqa: F401
    BatchStage, ShuffleStage, TransformStage)
