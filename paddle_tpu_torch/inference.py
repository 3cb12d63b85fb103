"""Inference API (counterpart of ``paddle_tpu/inference.py``; reference:
python/paddle/v2/inference.py:10,111 — Inference prunes the topology to
the output layer and runs forward-only; paddle.infer is the one-call
surface). The JAX package jits the forward; the port runs it eagerly under
``torch.inference_mode()`` on the parameters' device, batches assembled by
``DataFeeder`` on that device."""

import numpy as np
import torch

from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology


class Inference:
    def __init__(self, output_layer, parameters: Parameters):
        outputs = output_layer if isinstance(output_layer, (list, tuple)) \
            else [output_layer]
        self.topology = Topology(list(outputs))
        self._forward = self.topology.compile()
        self.parameters = parameters

    def iter_infer(self, input, feeding=None, batch_size=None):
        dtypes = {l.name: l.data_spec for l in self.topology.data_layers}
        feeder = DataFeeder(dtypes, feeding, device=self.parameters.device)
        batch_size = batch_size or len(input)
        for i in range(0, len(input), batch_size):
            feeds = feeder.feed(input[i:i + batch_size])
            with torch.inference_mode():
                outs, _ = self._forward(self.parameters.values,
                                        self.parameters.state, feeds,
                                        is_training=False)
            yield [outs[o.name].array.float().cpu().numpy()
                   if outs[o.name].array.dtype == torch.bfloat16
                   else outs[o.name].array.cpu().numpy()
                   for o in self.topology.outputs]

    def infer(self, input, field="value", feeding=None, batch_size=None):
        chunks = list(self.iter_infer(input, feeding, batch_size))
        n_out = len(self.topology.outputs)
        results = [np.concatenate([c[i] for c in chunks], axis=0)
                   for i in range(n_out)]
        return results[0] if n_out == 1 else results


def infer(output_layer, parameters, input, feeding=None, field="value",
          batch_size=None):
    """paddle.infer (reference: inference.py:111)."""
    return Inference(output_layer, parameters).infer(
        input, field=field, feeding=feeding, batch_size=batch_size)
