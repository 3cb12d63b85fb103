"""Checkpoints and model artifacts (counterpart of ``paddle_tpu/io/``;
reference: trainer/ParamUtil.cpp per-pass save dirs, v2
parameters.to_tar, trainer/MergeModel.cpp): ``checkpoint``, the merged
inference model (``merged``) and the serving artifact
(``lm_serving``)."""

from paddle_tpu_torch.io.checkpoint import (  # noqa: F401
    latest_checkpoint, load_checkpoint, save_checkpoint)
