"""A deterministic elastic training worker for the port — the gang member
that ``tests/test_torch_elastic.py`` and ``chip_smoke.py``'s ``gang:``
phase run under ``paddle_tpu_torch/runtime/supervisor.py``. It is the
counterpart of ``demos/elastic_worker.py``: the same ``ELASTIC_*`` knobs,
the same network, seed and batch stream, and the same output files.

Each worker is one rank of a real data-parallel gang. It joins the
process group of the PADDLE_* contract (``distributed.init``: gloo on
the CPU when ``PADDLE_PLATFORM=cpu``, else NCCL on the card) and trains
``SGD(parallel=data_parallel(mesh, zero=ELASTIC_ZERO))`` over a ``data``
mesh of all the ranks: every rank reads the same global stream, takes
its rows of each batch, and the gradient collectives are real. The
elastic contract runs for real: ``SGD.train`` heartbeats to the
supervisor, checkpoints through the fenced crash-consistent commit into
one directory the gang shares (``<ELASTIC_OUT>/ckpt``, each rank writing
its shards), resumes from the latest intact checkpoint with the input
pipeline's stream position, and reshards the ZeRO layout when the gang
size changed across a restart.

Env knobs (beyond the supervisor's PADDLE_* contract):
  ELASTIC_OUT        output dir (losses/params per rank+epoch; ckpt/)
  ELASTIC_NB         batches per pass              (default 8)
  ELASTIC_BS         global batch size             (default 8)
  ELASTIC_HIDDEN     hidden width of the MLP       (default 16)
  ELASTIC_ZERO       ZeRO stage for the data mesh  (default 1)
  ELASTIC_STEP_SLEEP extra seconds per step (lets the supervisor catch
                     a gang mid-run instead of racing it to the finish)
  ELASTIC_SYNC_SAVES "1": each step waits until the save the previous
                     step handed to the checkpoint writer is on disk, so
                     a kill at step k finds the save of step k - 1 (a
                     large model's async write can outlast a few steps)
  ELASTIC_MODEL      "mlp" (default: the JAX worker's network) or
                     "resnet50" (ResNet-50 at full width: 3x224x224 fed
                     flat CHW, 1000 classes, the space-to-depth stem)
  PADDLE_TPU_CHECKPOINT_PERIOD  flag: batches between async saves

Outputs: ``losses_rank<r>_epoch<e>.jsonl`` (one line per step, written
as its handler returns: step, loss, wall_s, and t, the wall clock then,
just before the next batch and its chaos site),
``final_rank<r>_epoch<e>.npz`` (the whole parameters after training) and
``done_rank<r>_epoch<e>.json`` (step, nprocs, the group's backend, the
rank's device and the checkpoint writer's seconds per save).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

os.environ.setdefault("PADDLE_TPU_SEED", "42")
os.environ.setdefault("PADDLE_TPU_COMPUTE_DTYPE", "float32")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import distributed, layer, parallel  # noqa: E402
from paddle_tpu_torch.core import place  # noqa: E402
from paddle_tpu_torch.parallel import spmd  # noqa: E402
from paddle_tpu_torch.pipeline import Pipeline  # noqa: E402
from paddle_tpu_torch.utils.rng import KeySource  # noqa: E402


def mlp_cost(hidden):
    x = layer.data("ew_x", paddle.data_type.dense_vector(8))
    lbl = layer.data("ew_l", paddle.data_type.integer_value(2))
    h = layer.fc(x, hidden, act=paddle.activation.Relu(), name="ew_h")
    o = layer.fc(h, 2, act=paddle.activation.Softmax(), name="ew_o")
    return layer.classification_cost(o, lbl, name="ew_cost")


def mlp_sample(rs):
    y = int(rs.randint(2))
    return (rs.randn(8) + 2.0 * y).astype(np.float32), y


def resnet50_cost():
    from paddle_tpu_torch.models import resnet
    img = layer.data("image", paddle.data_type.dense_vector(3 * 224 * 224))
    lbl = layer.data("label", paddle.data_type.integer_value(1000))
    out = resnet.resnet_imagenet(img, depth=50, class_num=1000,
                                 stem_space_to_depth=True)
    return layer.classification_cost(out, lbl, name="cost")


def resnet_sample(rs):
    return (rs.rand(3 * 224 * 224).astype(np.float32),
            int(rs.randint(1000)))


def main():
    distributed.init()
    rank = distributed.process_index()
    nprocs = distributed.process_count()
    epoch = int(os.environ.get("PADDLE_ELASTIC_EPOCH", "0"))
    nb = int(os.environ.get("ELASTIC_NB", "8"))
    bs = int(os.environ.get("ELASTIC_BS", "8"))
    hidden = int(os.environ.get("ELASTIC_HIDDEN", "16"))
    zero = int(os.environ.get("ELASTIC_ZERO", "1"))
    sleep_s = float(os.environ.get("ELASTIC_STEP_SLEEP", "0"))
    sync_saves = os.environ.get("ELASTIC_SYNC_SAVES") == "1"
    model = os.environ.get("ELASTIC_MODEL", "mlp")
    out = os.environ.get("ELASTIC_OUT", ".")
    os.makedirs(out, exist_ok=True)
    on_cpu = os.environ.get("PADDLE_PLATFORM") == "cpu"
    device = (torch.device("cpu") if on_cpu
              else torch.device("cuda", torch.cuda.current_device()))

    if model == "resnet50":
        cost, sample = resnet50_cost(), resnet_sample
        opt = paddle.optimizer.Momentum(momentum=0.9, learning_rate=0.01)
    elif model == "mlp":
        cost, sample = mlp_cost(hidden), mlp_sample
        opt = paddle.optimizer.Momentum(learning_rate=0.1)
    else:
        raise ValueError(f"ELASTIC_MODEL={model!r}: mlp or resnet50")
    params = paddle.parameters.create(cost, KeySource(5), device=device)
    mesh = place.make_mesh((nprocs,), (place.AXIS_DATA,))
    tr = paddle.trainer.SGD(
        cost=cost, parameters=params, update_equation=opt,
        parallel=parallel.data_parallel(mesh, zero=zero))

    def reader():
        # batch b is a pure function of b: every pass, every rank, and
        # every incarnation sees the identical stream — resume
        # correctness shows up as exact trajectory equality
        for b in range(nb):
            rs = np.random.RandomState(1000 + b)
            for _ in range(bs):
                yield sample(rs)

    pipe = Pipeline(reader, batch_size=bs, prefetch=2, track_state=True)
    losses = open(os.path.join(out, f"losses_rank{rank}_epoch{epoch}.jsonl"),
                  "w")

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            if sync_saves:
                tr.last_checkpointer.wait()
            if sleep_s:
                time.sleep(sleep_s)
            losses.write(json.dumps({
                "step": tr._step - 1, "loss": float(e.cost),
                "wall_s": float(e.wall_time_s or 0.0),
                "t": time.time()}) + "\n")
            losses.flush()

    try:
        tr.train(reader=pipe, num_passes=1, event_handler=handler,
                 checkpoint_dir=os.path.join(out, "ckpt"))
    finally:
        pipe.close()
        losses.close()

    backend = distributed.backend()
    final = spmd.full_tree(tr.parameters.values)
    np.savez(os.path.join(out, f"final_rank{rank}_epoch{epoch}.npz"),
             **{k: v.detach().float().cpu().numpy() for k, v in final.items()})
    with open(os.path.join(out, f"done_rank{rank}_epoch{epoch}.json"),
              "w") as f:
        json.dump({"step": tr._step, "nprocs": nprocs, "backend": backend,
                   "device": str(device),
                   "checkpoint_write_s": tr.last_checkpointer.write_seconds},
                  f)
    distributed.shutdown()
    print(f"elastic worker rank {rank} epoch {epoch}: done at step "
          f"{tr._step} over {backend}", flush=True)


if __name__ == "__main__":
    main()
