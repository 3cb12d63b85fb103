#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one card.

    python3 chip_smoke.py

Drives ``paddle_tpu_torch``'s serving and training paths on the first
CUDA card and exits non-zero on any failure (there is no CPU path). In
order it:

1. prints the environment (torch, CUDA, capability, nvcc, Triton,
   CUTLASS headers, the card's name and power limit);
2. builds the Hopper kernels from ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc (one process per source, in parallel) and prints the build
   time;
3. prints the ``-Xptxas -v`` registers and spills of the paged
   attention kernels, the attention forward and backward, the sampler
   and the span write (``ptxas:`` line),
   then holds each kernel, the int8
   and int4 branches of kernels 1, 3 and 4, the fp32-query branches of
   kernels 1 and 3, and both branches of kernels 5 and 6 (bf16 on the
   tensor cores; fp32 on the tensor cores with three-term operands)
   against its plain
   PyTorch version on the card, at its slice's shapes and at one GQA
   shape, and
   times kernel, plain version and a PyTorch library call that computes
   the same function (a yardstick only: the port never calls it; SDPA
   over gathered, dequantized K/V for a quantized pool), beside the
   least time the card could take (the bytes stored and moved over
   3.35 TB/s or FLOPs over the peak for the input type, whichever is
   larger); every kernel also times its C entry alone (``entry_ms``,
   outputs allocated beforehand), and kernels 1–4, kernel 5 and kernel
   6's fp32 branch their execution on the device alone (``device_ms``,
   from the profiler's device activity, which a slow host's launch work
   cannot inflate); the sampler runs on
   both its streams (hashed: the decode tail, B=8; threefry: the
   prefill tail, B=1) and is held bitwise over B in {1, 8, 64} and V in
   {64, 1000, 50257} (``check sample:`` line); the span write is held
   byte for byte; decode is also checked at G=8, Dh=128 over 16384
   positions and, per slot, alone against its batch of 8 (bitwise);
   fp32-query prefill over 65 536 context positions and over an int8
   pool, kernel 5's fp32 branch at the GQA D=128 shape (its largest
   shared-memory plan), and kernel 6's fp32 branch on a block fed
   lse = +1e30 (the flash ring's masked block: exactly 0);
   kernels 1, 3, 5 and 6 are launched twice on the same inputs, which
   must give bitwise the same outputs; kernels 5 and 6 are timed at the
   training slice's shape in both dtypes and at the GQA D=128 shape in
   bf16;
4. holds the serving step functions on the card against the CPU on a
   small fp32 model, with an fp32 pool (the launches of the fp32-query
   paged kernels) and again with an int8 pool and int8 weights;
5. holds a small fp32 LM's training on the card against the CPU (one
   step's loss and gradients, then five Adam steps' losses), and runs
   the same three steps twice on the card: losses and weights must be
   bitwise equal (the attention backward uses no atomics). The card's
   five steps are the fp32 attention branch's path: their launch counts
   are that branch's ``launches`` (no bf16 kernel may launch there);
6. checks the engine's step programs (``check graphs:``): at GPT-2
   small widths over bf16, int8 and int4 pools, each CUDA graph
   replayed (prefill: a cold chunk and a chunk with context; decode: 8
   rows, greedy and sampled, two inactive) gives bitwise the ids and
   every pool byte of the raw step function on the same inputs, across
   new seeds and after a page-table remap;
7. serves 16 seeded requests with a GPT-2-small-width engine (random
   weights from a seed) in a fresh engine, so every CUDA graph capture
   falls in the timed window (``captures``, ``capture_s``), then a
   second trace drawn the same way (``warm``); reads each serving
   kernel's launch count for the first run — every count must be > 0 —
   checks that the graphs captured are the trace's distinct (chunk
   bucket, page-vector length) keys plus one for decode, that a
   prefix-cache hit gives the same greedy tokens as the same prompt
   served cold in a fresh engine, and profiles a third trace
   (``engine_profile:``: the ten device kernels with the most time, the
   device's busy share); then does the same over quantized pools: (b)
   an int4 pool with the bf16 weights, and (a) an int8 pool with
   ``quantize_lm_params`` int8 weights of the same seed-0 fp32 draws
   (the bf16 weights freed first, so its peak memory holds the int8
   tree alone), each run launching every quantized branch of its
   storage (``engine_int4_profile:``, ``engine_int8_profile:``). Between
   the two, decode logits off int8 and int4 pools must lie within
   ``kv_rel_l2_budget`` of the bf16 pool's on one prompt, and a
   latency-tier burst preempts batch-tier work in a pool of 8 blocks
   (``preempt:``): both resume modes occur, every request completes,
   each victim's greedy ids equal its run alone; after the prefix
   phase, the fleet's data plane (``fleet:`` line, ``fleet_phase``):
   the bf16 trace through two ``EngineReplica``s behind the port's
   ``Router`` (greedy ids equal the single engine's), a prefill and a
   decode replica (P/D: ids equal, blocks adopted), a replica killed
   mid-trace (every request completes, requeues counted, ``/healthz``
   names it), a ``ReplicaServer`` stepping a third engine on its serve
   thread behind a ``SocketReplica`` (ids equal over TCP; the router's
   four routes answer) and ``LMServer.serve`` over a v4 artifact;
   kernels 1–4 count the fleet's launches too; then the fleet's control
   plane (``autoscale:`` line, ``autoscale_phase``): in process, a
   ``FleetController`` heals a killed replica and re-warms it from the
   survivor, scales one replica up under queue pressure and drains it
   when idle; two ``serve --port`` replica processes on the card from a
   v4 artifact serve the trace, one is SIGKILLed and healed; the
   ``route --autoscale`` CLI serves 4 requests, renders a ``top`` frame
   and drains on SIGTERM; the native recordio codec round-trips a file
   byte for byte against the pure-Python path; every greedy id equals
   the single engine's, nothing is lost, and the in-process gate's
   launches join the kernel line;
8. speculative decoding (``spec:`` line, ``spec_phase``): the repo's
   draft-friendly pair at GPT-2 small widths (a 2-layer draft that is
   the target's first layers, the later layers' residual outputs scaled
   by 0.05), k = 4: a verify window against sequential raw decode steps
   over bf16, int8 and int4 pools (whether it is bitwise) and on an
   fp32 model within 1e-4; kernel 1 at the verify's 40 rows and
   ``fused_spec_verify`` at [8, 5, 50257] against their plain versions;
   the engine trace cold and warm through the target-only engine and the
   spec engine (captures, launches, acceptance), 4 requests through an
   unrelated draft; every greedy id equal to the target-only engine's
   (or, if the window is not bitwise, diverging only below the window's
   logit difference); a remap and a replay preemption of spec victims;
   the port's v5 artifact of the pair saved, loaded and served; the spec
   programs' replays bitwise their raw steps; a profiled third trace
   (``spec_profile:``);
9. the row-arena slot engine and the lockstep paths (``slots:``,
   ``slots_profile:`` and ``lockstep:`` lines): the slot engine
   (batch 8, an arena of 1024 positions, buckets 16..512) serves the
   engine trace with prompts clipped to 512 tokens, cold (every capture
   in its window: one per bucket met, one for decode) and warm, beside
   the paged engine on the same traces; every greedy request equals
   ``generate`` at B = 1 or diverges only where the lockstep step's
   top-2 margin is below the slot path's max |logit difference| from
   it; kernel 5 at the slot prefill's shapes (T = 16, 32, 200, 512,
   B*H = 12, bf16, causal) within 2 bf16 ulps of its plain version,
   timed at T = 16 and 512 against SDPA; the slot step programs'
   replays bitwise their raw steps (a prefill bucket replayed with two
   seeds), ``decode_step_slots`` bitwise ``decode_step`` at equal
   positions; the arena attention's share of a warm decode step; a
   profiled third trace; then ``generate`` (B = 4, 128-token prompts,
   64 new, greedy and sampled), ``beam_search`` (B = 2, K = 4, 16 new)
   and the port's v1 and v3 artifacts saved, loaded and served with
   the in-process ids;
10. the op layer of the v2 framework (``ops:`` line, ``ops_phase``), each
   group held against the CPU (the port's same function on the same
   inputs, TF32 off) and timed on the card (CUDA events, median of 10
   calls after a warm-up): ResNet-50 at batch 128, bf16 compute (the
   space-to-depth stem against the direct 7x7/s2 conv, its 3x3/s2 SAME
   max pool, the first bottleneck block of each stage through
   ``conv_bn_train`` forward and backward with ``save8`` off and on,
   ``global_avg_pool2d``, ``conv_bn_infer``; parity on 8 images); the
   LSTM text classifier (batch 64, T = 100, a 30000 x 128 embedding and
   its scatter-add gradient, ``lstm`` and ``gru`` at hidden 256 and 1280
   forward and reverse, the sequence pools, ``context_projection`` and
   ``row_conv`` at D = 512, ``torch.nn.LSTM`` timed as a yardstick);
   CRF, CTC and ``lambda_rank``; SSD300's priors, matching, box codec,
   ``nms`` over 8732 boxes and ``roi_pool`` of 128 ROIs with its peak
   memory; ``beam_search`` and ``greedy_search`` over a GRU decoder
   (tokens equal to the CPU's except at near-ties, ``beam_gate``);
11. the v2 layer API (``layers:`` line, ``layers_phase``): three
   networks built with the port's ``layer`` / ``networks`` calls (the
   calls of ``models/text.py`` and ``models/seq2seq.py``), parameters
   from ``parameters.create``, batches through ``DataFeeder``, each held
   against the CPU (the port's same graph, parameters and rows: outputs,
   new state and every parameter's gradient) and timed on the card: the
   LSTM text classifier (batch 64, T = 100, vocab 30000, emb 128, hidden
   256, bf16; parity and the evaluators' counts on 16 rows, 5 Adam
   steps whose loss must fall, forward + backward + update ms), VGG-16
   (3x224x224 flat CHW, 1000 classes, batch 64, bf16, dropout on;
   parity on 2 images with every dropout mask bit equal, one Momentum
   step, forward + backward ms, peak memory) and the attention seq2seq
   (dictionaries 30000, word vectors and both RNNs 512, batch 32,
   lengths 20..50, fp32; parity on 4 rows, forward + backward ms; beam
   search, beam 3, max_length 50, batch 16, tokens against the CPU's on
   4 rows with ``beam_gate``); then both the classifier and the
   generator saved with ``save_inference_model`` plain and
   ``weights_int8``, each reloaded in a fresh process on the card that
   imports no model code (same ids, probabilities within 1e-6), the
   classifier's ``aot_compile`` + ``call_exported`` bitwise its eager
   forward, the generator's capture refused (``GraphCaptureError``);
12. the models and the single-card trainer (``trainer:`` line,
   ``trainer_phase``): ResNet-50 at full width
   (``benchmarks/configs/resnet50.py``'s graph through the port's
   ``models.resnet``: 3x224x224, 1000 classes, batch 128, the s2d stem,
   bf16, Momentum) timed by ``cli.measure_time`` (3 warm-up, 20 timed
   batches: ms/batch, images/s, the counted FLOPs per image, MFU against
   989 TFLOP/s, peak memory), trained by ``SGD.train`` for 6 batches (the
   step monitor's feed / dispatch / sync split), two identical steps
   compared bitwise, the trainer's step against the hand-composed one,
   one more step under the profiler (the device's busy share), and one
   fp32 step at batch 4 against the CPU (``TRAINER_*`` tolerances: the
   loss, the model state and the head's gradients whole, every
   convolution and batch norm layer by layer against float64 within
   fp32's rounding bound, ``hold_ops``); the LSTM classifier through ``SGD.train`` and
   ``SGD.test`` (the loss must fall); CTR wide&deep at its benchmark
   widths (one fp32 step against the CPU, then 6 Adam steps); GAN and VAE
   at their config defaults against the CPU; the CLI's ``time``,
   ``train`` and ``checkgrad`` as processes on the card. No port kernel
   launches here (their counts are read around the phase);
13. the trainer's input pipeline and checkpoints (``input:`` line,
   ``input_phase``): recordio shards of 2048 uint8 images 256x256x3
   from a seeded generator, read back by the native ``PrefetchLoader``
   byte for byte as ``read_records`` reads them (``native_loader``);
   ResNet-50 (batch 128, bf16) trained through a ``Pipeline`` (seeded
   chunk order, a random 224 crop, flip and normalize on 4 workers, a
   512-sample shuffle, ``prefetch=3``; on the card its device stage
   copies each batch on a side stream) and through the same stream at
   ``prefetch=0``: images/s of 20 batches after 3 warm-up, the step
   monitor's feed / dispatch / sync medians, the ring depths, one more
   pipelined step under the profiler; the same run with checkpoints
   every 5 batches: bytes, the stall inside the step per save, the
   writer thread's seconds, a device-to-host bandwidth and the stall's
   bound from it; the resume gates, an MLP and ResNet-50 trained 12
   steps, crashed at step 7 (``crash@step``) and resumed from the
   checkpoint and the pipeline state, bitwise equal in state and batch
   ids (ResNet-50's gate holds where two uninterrupted runs are
   bitwise, ``resnet_repeat_bitwise``); a torn multi-process save
   (``crash@checkpoint:phase=mid_commit``) leaving the previous
   checkpoint latest and loadable onto the card. No port kernel
   launches here;
14. the v2 book chapters (``book:`` line, ``book_phase``): the nine
   chapters of ``tests/test_book.py`` as ``tests/torch_book_chapters.py``
   builds them (fit-a-line, word2vec, the recommender, the LSTM
   sentiment classifier, ResNet-32 on CIFAR-10 shapes, SRL with a CRF,
   the attention seq2seq at wmt14's 30000-word dictionaries and 512
   wide, learn-to-rank, quick-start's bag of words) each read
   from ``paddle_tpu_torch.dataset.<set>`` (synthetic fallbacks), batched
   by ``paddle_tpu_torch.batch`` and trained 20 batches by ``SGD.train``
   on the card, fp32: step ms p50 (min, max), examples/s, first and last
   cost, peak memory; the first step's gradients (relative L2) and the
   first 2 batches' costs (the second after one Adam update) against the
   port's same steps on the CPU from the same weights (within 1e-4
   relative), the cost of the chapter's first 4 batches falling between
   before and after
   training; ``dataset.cifar.convert`` to recordio and
   ``reader.creator.recordio`` over it equal to the in-memory readers
   (MB/s of both); ``python -m paddle_tpu_torch stats --metrics_file``
   over the sentiment chapter's JSONL (rc 0, its 20 steps counted) and
   ``stats --trace``. No port kernel launches here;
15. the single-card parallel tier (``q8:``, ``remat:`` and ``moe:``
   lines, ``a9_phase``): each q8 block (the entry, conv_q8 at stride 1
   and 2 with and without its input ReLU, add_q8, the exit) at batch 4,
   fp32, against the same Function on the CPU from the same operands
   (stash codes equal but for counted one-step flips after a
   convolution, everything else within ``OPS_F32_REL``); ResNet-50 as
   the ``trainer:`` phase builds it under ``fused_bn`` off, "q8",
   "defer" and "q8sr" (``cli.measure_time``, 2 warm-up and 10 timed
   batches; ``SGD.train`` over one batch repeated, whose cost must fall
   and whose ``q_scale`` state must move; one profiled step); the
   ``train:`` recipe under ``remat`` "none", "bf16" and "q8" (the first
   loss bitwise "none"'s, the gradients within 0.02 / 0.08 of its, the
   forward + backward peaks ordered q8 < bf16 < none, 3 timed steps,
   kernel 5 twice a layer a step under remat and kernel 6 once); GPT-2
   small with every FFN a Switch layer of 8 experts (top-1, capacity
   1.25, aux 0.01): 2 + 5 Adam steps (the loss falls, aux > 0), the
   engine trace through a fresh ``PagedDecodeEngine`` (kernels 1-4 each
   launched, the prefix hit against the prompt cold under the near-tie
   rule), a v4 artifact saved, loaded and serving the in-process ids,
   and two small fp32 MoE models (top-1, top-2) card vs CPU within 1e-4;
   their launches join the kernel line;
16. the multi-rank tier at world 1 (``parallel:`` line,
   ``parallel_phase``; ~25 s): ``distributed.init()`` from the env
   contract (NCCL on ``cuda:0``, a (data, seq, model) = (1, 1, 1) mesh,
   barrier times, one NCCL all-reduce); ResNet-50 as the ``trainer:`` phase builds it (batch
   128, bf16) through ``SGD(parallel=data_parallel(mesh, zero=z))`` for
   z in {0, 3} against ``parallel=None`` from the same parameters (2
   warm-up and 5 timed batches each; costs and final parameters bitwise,
   no collective issued over the mesh's axes of one rank, the step
   records' opt-state bytes); GPT-2 small under ``param_shardings`` (the
   ``train:`` recipe, 3 Adam steps) bitwise its unsharded step, with no
   collective either; ``mesh_paths`` (``parallel_mesh_paths``, ROADMAP
   A10c): the transformer's other mesh paths, each bitwise its unsharded
   call with no collective: ``lm_loss`` with dropout 0.1 at B = 8,
   T = 1024 (loss and gradients from one generator seed),
   ``prefill(mesh=)`` at B = 4, Tp = 128 (logits and arena), greedy
   ``generate(mesh=)`` with 32 new tokens (ids), ``beam_search(mesh=)``
   at B = 2, K = 4, 16 new (ids and scores) and
   ``prefill_into_slot(mesh=)`` of a 200-token prompt in the 256 bucket
   (logits and the whole arena), kernels 5 and 6 counted over the mesh
   calls into rows 5 and 6; a ``seq`` axis of more than one rank
   cannot exist on one card, so the seq paths (ring, all-to-all, and
   the gathered sequence without ring attention) run on the CPU's gloo
   ranks only (``tests/test_torch_mesh_paths.py``); the flash ring's
   schedule at P = 4 and 8 virtual ranks (B = 2, H = 12, D = 64,
   T = 4096, bf16, causal) against kernels 5/6 over the whole sequence and against their plain versions in the
   same schedule, the masked blocks' backward exactly 0 in both, the
   int8 hop's
   codes against the CPU's, kernels 5/6 at the all-to-all layout, the
   launches (P² of each), and rows 5r / 6r (kernels 5/6 at the ring's
   off-diagonal block, timed beside SDPA);
17. the elastic gang at world 1 (``gang:`` line, ``gang_phase``; ~45 s):
   ``runtime/supervisor.Supervisor`` runs ``tests/torch_elastic_worker.py``
   (``cluster=True``, ``PADDLE_PLATFORM`` cleared: NCCL on ``cuda:0``,
   both asserted) training ResNet-50 as the ``trainer:`` phase builds it
   (bf16) at batch 32 for 8 steps through ``SGD.train``'s elastic
   contract (heartbeats, the epoch fence, a checkpoint every 2 steps),
   one gang uninterrupted and, beside it, one whose rank is SIGKILLed at
   step 5 of its first incarnation (``kill@step:step=5:epoch=1``): the
   supervisor judges it (``worker_exit:-9``), tears it down and relaunches
   it as epoch 2, which restores the latest intact checkpoint; the final
   parameters and the re-executed losses are held bitwise to the
   uninterrupted gang's where two uninterrupted gangs are bitwise (a third
   gang is run to decide only when the resumed one is not), else within
   ``TRAINER_RESNET_REL``, and the line says which held; it prints the
   restarts, epochs, the failure reason, the seconds from the killed
   rank's last step to the detection, ``restart_gap``,
   ``recovery_seconds``, each epoch's startup, the goodput fraction, each
   incarnation's wall time, the writer's seconds per save and the
   script's time so far. No port kernel launches here;
18. trains the GPT-2-small-width LM (bf16, flash attention, batch 8 x
   1024 tokens, Adam at 1e-4, one seeded batch: the repo's
   ``benchmarks/transformer_bench.py`` recipe) for 2 warm-up and 10
   timed steps, and reads each attention kernel's launch count for the
   timed steps — 12 layers x 10 steps of each bf16 kernel, none of the
   fp32 ones; then profiles one more step (``train_profile:`` line: the
   ten device kernels with the most time, the device's busy share);
19. prints the card line, a ``{"kernels": [...]}`` line (20 entries: the
   17 kernels and branches, ``fused_spec_verify``, kernel 2 at the
   spec trace's verify rows, and kernels 5/6 at the ring's block shape,
   ``flash_attention_{fwd,bwd}.ring``; kernel 2's two streams and kernel 5's bf16
   forward count the slot trace's and the lockstep calls' launches too)
   and, last, the ``{"ok": true, ...}`` line.

TF32 is switched off for matmuls and cuDNN, so fp32 products are full
fp32 on the card as on the CPU.
"""

import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# dense tensor-core rates. fp32: an fp32-accurate product runs on the
# bf16 tensor cores as six passes over operands split into three bf16
# terms (csrc/flash_tc.cuh), so the least time the card needs for fp32
# work is its FLOPs at 989 / 6 TFLOP/s, not at the CUDA cores' 67
PEAK_FLOPS = {"bfloat16": 989e12,
              "float32": 989e12 / 6}
REPEATS = 30
L2_FLUSH_BYTES = 64 << 20          # > the 50 MB L2: every launch cold


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def sh(cmd) -> str:
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (done.stdout or done.stderr).strip()


class Timer:
    """Median device time of a function over ``REPEATS`` launches, each
    after a write that evicts L2 (the serving path reads each layer's
    pool slice cold), with CUDA events around the launch alone."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPEATS):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def device_ms(self, fn, kernel: str):
        """(median execution time on the device, records) of the CUDA
        kernels whose name holds ``kernel`` over ``REPEATS`` launches of
        ``fn`` (each after the L2-evicting write), from
        ``torch.profiler``'s device activity: the kernel alone, without
        the host's launch work. The profiler drops records now and then
        on the card's machine: the median is over those it kept, a
        window with none is tried once more, and then the time is None
        (not measured)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        fn()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(REPEATS):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            us = [ev.time_range.end - ev.time_range.start
                  for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA and kernel in ev.name]
            if us:
                return float(np.median(us)) / 1e3, len(us)
        return None, 0


def ptxas_summary(build_dir, stems) -> dict:
    """{source: [[kernel, registers, spill store bytes, spill load
    bytes], ...]} from the ``-Xptxas -v`` logs the build keeps beside
    its objects (kernel names demangled by ``c++filt`` when there is
    one, template arguments kept, parameters dropped)."""
    out = {}
    for stem in stems:
        log = Path(build_dir, stem + ".log")
        fns, name, spill = [], None, (0, 0)
        for line in log.read_text().splitlines() if log.exists() else ():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name, spill = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                fns.append([name, int(m.group(1)), *spill])
                name = None
        try:
            names = subprocess.run(
                ["c++filt"], input="\n".join(f[0] for f in fns),
                capture_output=True, text=True, timeout=60).stdout.split("\n")
        except OSError:
            names = []
        for f, d in zip(fns, names):
            f[0] = re.sub(r"\(.*$", "",
                          d.replace("(anonymous namespace)::", "")) or f[0]
        out[stem] = fns
    return out


def bound(nbytes: float, flops: float, dtype_name: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate for the input type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def quant_pool(torch, q8, shape, kvd, dev, dtype=None):
    """Rows [..., M, Dh] drawn on the card in ``dtype`` (bf16 by
    default), stored as ``kvd`` ("none": those rows; "int8"/"int4":
    codes and fp32 row scales from ``ops/q8.quantize_kv``). Returns
    (values, scales or None)."""
    x = torch.randn(*shape, device=dev).to(dtype or torch.bfloat16)
    if kvd == "none":
        return x, None
    return q8.quantize_kv(x, kvd)


def stored_row_bytes(kvd: str, Dh: int, elt: int = 2) -> int:
    """Bytes one pool row occupies: ``elt``-byte values, or int8 /
    packed int4 codes plus the row's fp32 scale."""
    return {"none": elt * Dh, "int8": Dh + 4, "int4": Dh // 2 + 4}[kvd]


def decode_entry(torch, kd, build, q, k, v, pages, pos, kw):
    """The decode C entry alone on the wrapper's operands, its output,
    partials and counters allocated once beforehand: a callable that
    launches it and returns the output tensor it writes."""
    B, Hkv, G, Dh = q.shape
    bs, kv = kw["block_size"], kw["kv_dtype"]
    P, M = pages.shape[1], k.shape[1]
    _, smem, part = kd.decode_split_layout(G, Dh, P, bs, q.dtype, kv)
    buf = torch.empty(B * Hkv * (G * Dh + part), dtype=torch.float32,
                      device=q.device)
    counters = kd.arrival_counters(q.device, build.stream(q.device),
                                   B * Hkv)
    ptr = build.ptr
    args = [ptr(q), ptr(k), ptr(v), ptr(kw.get("k_scale")),
            ptr(kw.get("v_scale")), ptr(pages), ptr(pos), ptr(buf),
            build.ptr(buf[B * Hkv * G * Dh:]), ptr(counters), B, Hkv, G, Dh,
            M, P, bs, Dh ** 0.5, build.DTYPE_CODES[q.dtype],
            build.KV_CODES[kv], smem, build.stream(q.device)]
    lib = build.library()
    out = buf[:B * Hkv * G * Dh].view(B, Hkv, G, Dh)

    def run():
        build.check(lib.pk_decode_attention(*args), "flash_decode_attention")
        return out
    return run


def prefill_entry(torch, kp, build, q, kck, vck, k, v, pages, kw):
    """The chunk-prefill C entry alone, as ``decode_entry``."""
    C, Hkv, G, Dh = q.shape
    bs, kv = kw["block_size"], kw["kv_dtype"]
    P_ctx, M = pages.shape[0], k.shape[1]
    rows, smem = kp.prefill_layout(C, G, Dh, P_ctx * bs, q.dtype,
                                   kv if P_ctx else "none")
    n_out = C * Hkv * G * Dh
    row_tiles, _, part = kp.prefill_tc_splits(C, G, Dh, P_ctx * bs)
    part *= Hkv
    counters = kp.arrival_counters(q.device, build.stream(q.device),
                                   Hkv * row_tiles)
    buf = torch.empty(n_out + part, dtype=torch.float32, device=q.device)
    out = buf[:n_out].view(C, Hkv, G, Dh)
    ptr = build.ptr
    args = [ptr(q), ptr(kck), ptr(vck), ptr(k), ptr(v),
            ptr(kw.get("k_scale")), ptr(kw.get("v_scale")), ptr(pages),
            ptr(out), build.ptr(buf[n_out:]), ptr(counters), C, Hkv, G, Dh,
            M, P_ctx, bs, rows, Dh ** 0.5,
            build.DTYPE_CODES[q.dtype], build.KV_CODES[kv], smem,
            build.stream(q.device)]
    lib = build.library()

    def run():
        build.check(lib.pk_chunk_prefill(*args), "flash_chunk_prefill")
        return out
    return run


def widened(q8, x, scale, kvd, dtype):
    """Gathered pool rows as the library call's operand: dequantized
    through ``ops/q8.dequantize_kv`` and cast to the query dtype."""
    return x if kvd == "none" else q8.dequantize_kv(x, scale, kvd).to(dtype)


def check_decode(torch, timer, kd, q8, build, dev, rng, Hkv, G, Dh, timed,
                 kvd="none", dt=None, window=1):
    """Decode at one shape against its plain version: (max abs error,
    times or None). Timed: kernel through the wrapper, the C entry alone
    (``entry_ms``), the plain version and SDPA over gathered K/V; the C
    entry's output must equal the wrapper's bitwise (two launches).
    ``window`` > 1 is the verify step's shape: 8 slots of ``window``
    rows each, a slot's rows sharing its page-table row at consecutive
    positions (the library call: SDPA with ``window`` queries a slot)."""
    S, bs, P, nblocks = 8, 16, 64, 512
    B = S * window
    dt = dt or torch.bfloat16
    q = torch.randn(B, Hkv, G, Dh, device=dev).to(dt)
    k, ks = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev, dt)
    v, vs = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev, dt)
    kw = dict(block_size=bs, kv_dtype=kvd)
    if kvd != "none":
        kw.update(k_scale=ks, v_scale=vs)
    slot_pages = np.stack([rng.permutation(nblocks)[:P]
                           for _ in range(S)]).astype(np.int32)
    pages = torch.from_numpy(np.repeat(slot_pages, window, axis=0)).to(dev)
    pos_np = (rng.randint(32, 765 - (window - 1), S)[:, None]
              + np.arange(window)).reshape(B).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    args = (q, k, v, pages, pos)
    got = kd.flash_decode_attention(*args, **kw)
    want = kd.flash_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not timed:
        return err, None
    entry = decode_entry(torch, kd, build, *args, kw)
    if not torch.equal(entry(), got):
        fail(f"flash_decode_attention ({kvd}, {dt}): the C entry and the "
             f"wrapper differ on the same inputs")
    e = q.element_size()
    # each slot's rows read once (a window's rows share them); every
    # query row does its own products
    rows = int((pos_np.reshape(S, window).max(1) + 1).sum())
    nbytes = (q.numel() * e + rows * Hkv * stored_row_bytes(kvd, Dh, e) * 2
              + pages.numel() * 4 + B * 4 + got.numel() * 4)
    flops = int((pos_np + 1).sum()) * Hkv * G * Dh * 2 * 2
    # library yardstick: SDPA over K/V already gathered per slot (and
    # dequantized, for a quantized pool)
    T = P * bs
    gidx = (torch.from_numpy(slot_pages).to(dev).long()[:, :, None] * bs
            + torch.arange(bs, device=dev)).reshape(S, T)
    kt = widened(q8, k[:, gidx], None if ks is None else ks[:, gidx], kvd, dt)
    vt = widened(q8, v[:, gidx], None if vs is None else vs[:, gidx], kvd, dt)
    kt = kt.permute(1, 0, 2, 3).repeat_interleave(G, dim=1)
    vt = vt.permute(1, 0, 2, 3).repeat_interleave(G, dim=1)
    qh = q.reshape(S, window, Hkv * G, Dh).transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None, None, :]
            <= pos.reshape(S, window)[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {
        "ms": timer.ms(lambda: kd.flash_decode_attention(*args, **kw)),
        "plain_ms": timer.ms(lambda: kd.flash_decode_attention_plain(
            *args, **kw)),
        "library_ms": timer.ms(lambda: sdpa(qh, kt, vt, attn_mask=mask)),
        "entry_ms": timer.ms(entry),
    }
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "decode_split_kernel")
    times["bound_ms"], times["bound_by"] = bound(
        nbytes, flops, str(dt).replace("torch.", ""))
    return err, times


def decode_invariance(torch, kd, q8, dev, kvd):
    """The serving slice's decode (B=8, Hkv=12, G=1, Dh=64, 64 pages of
    16) at positions on both sides of the split edges: (each slot decoded
    alone bitwise equal to its row of the batch, a second launch of the
    batch bitwise equal to the first)."""
    rng = np.random.RandomState(3)
    B, Hkv, G, Dh, P, bs, nblocks = 8, 12, 1, 64, 64, 16, 512
    q = torch.randn(B, Hkv, G, Dh, device=dev).to(torch.bfloat16)
    k, ks = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev)
    v, vs = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev)
    kw = dict(block_size=bs, kv_dtype=kvd, k_scale=ks, v_scale=vs)
    pages = torch.from_numpy(np.stack(
        [rng.permutation(nblocks)[:P] for _ in range(B)]).astype(np.int32)
    ).to(dev)
    pos = torch.tensor([700, 3, 63, 64, 1023, 129, 0, 511],
                       dtype=torch.int32, device=dev)
    batch = kd.flash_decode_attention(q, k, v, pages, pos, **kw)
    again = kd.flash_decode_attention(q, k, v, pages, pos, **kw)
    alone = all(torch.equal(kd.flash_decode_attention(
        q[b:b + 1].contiguous(), k, v, pages[b:b + 1].contiguous(),
        pos[b:b + 1].contiguous(), **kw)[0], batch[b]) for b in range(B))
    return alone, torch.equal(batch, again)


def decode_long(torch, kd, q8, dev, kvd):
    """Max abs error of decode at G=8, Dh=128 over T=16384 positions
    (256 splits; B=2, Hkv=2, one slot at the last position, one at 9000)
    against the plain version."""
    rng = np.random.RandomState(4)
    B, Hkv, G, Dh, P, bs = 2, 2, 8, 128, 1024, 16
    q = torch.randn(B, Hkv, G, Dh, device=dev).to(torch.bfloat16)
    k, ks = quant_pool(torch, q8, (Hkv, P * bs, Dh), kvd, dev)
    v, vs = quant_pool(torch, q8, (Hkv, P * bs, Dh), kvd, dev)
    kw = dict(block_size=bs, kv_dtype=kvd, k_scale=ks, v_scale=vs)
    pages = torch.from_numpy(np.stack(
        [rng.permutation(P) for _ in range(B)]).astype(np.int32)).to(dev)
    pos = torch.tensor([P * bs - 1, 9000], dtype=torch.int32, device=dev)
    got = kd.flash_decode_attention(q, k, v, pages, pos, **kw)
    want = kd.flash_decode_attention_plain(q, k, v, pages, pos, **kw)
    torch.cuda.synchronize()
    return (got - want).abs().max().item()


def prefill_long(torch, kp, dev):
    """Max abs error of chunk prefill with fp32 queries over an fp32
    pool at the slice's widths (C=256, Hkv=12, G=1, Dh=64) over
    S=65536 context positions (4096 pages of 16), against the plain
    version: the kernel keeps no score row, so its shared memory does
    not grow with S."""
    rng = np.random.RandomState(5)
    C, Hkv, G, Dh, P, bs = 256, 12, 1, 64, 4096, 16
    q = torch.randn(C, Hkv, G, Dh, device=dev)
    kck, vck = (torch.randn(C, Hkv, Dh, device=dev) for _ in range(2))
    k, v = (torch.randn(Hkv, P * bs, Dh, device=dev) for _ in range(2))
    pages = torch.from_numpy(rng.permutation(P).astype(np.int32)).to(dev)
    args = (q, kck, vck, k, v, pages)
    got = kp.flash_chunk_prefill(*args, block_size=bs)
    want = kp.flash_chunk_prefill_plain(*args, block_size=bs)
    torch.cuda.synchronize()
    return (got - want).abs().max().item()


def check_sample(torch, timer, kd, build, dev, rng, stream):
    """The sampler on one stream at its main-path shape (the hashed
    stream: the decode tail, B=8; threefry: the prefill tail, B=1;
    V=50257, temperature 0.8 and top_k 50 on sampled rows): bitwise
    against its plain version, then timed through the wrapper, as the C
    entry alone (``entry_ms``) and on the device (``device_ms``), beside
    the plain version and topk + softmax + multinomial."""
    B, V = (8, 50257) if stream == "hash" else (1, 50257)
    x = torch.from_numpy((3.0 * rng.randn(B, V)).astype(np.float32)).to(dev)
    temp = torch.tensor([0.0, 0.8] * 4, device=dev)[-B:]
    topk = torch.tensor([0, 50] * 4, dtype=torch.int32, device=dev)[-B:]
    seed = torch.tensor(1234, dtype=torch.int32, device=dev)
    got = kd.fused_sample(x, seed, temp, topk, stream)
    want = kd.fused_sample_plain(x, seed, temp, topk, stream)
    torch.cuda.synchronize()
    err = float((got.long() - want.long()).abs().max().item())

    def library():
        vals, idx = torch.topk(x, 50, dim=-1)
        probs = torch.softmax(vals / 0.8, dim=-1)
        return idx.gather(-1, torch.multinomial(probs, 1))

    out = torch.empty(B, dtype=torch.int32, device=dev)
    lib, ptr = build.library(), build.ptr
    args = [ptr(x), ptr(temp), ptr(topk), ptr(out), B, V, ptr(seed),
            kd.STREAMS.index(stream), build.stream(dev)]

    def entry():
        build.check(lib.pk_fused_sample(*args), "fused_sample")
        return out

    if not torch.equal(entry(), got):
        fail(f"fused_sample ({stream}): the C entry and the wrapper differ "
             f"on the same inputs")
    times = {
        "ms": timer.ms(lambda: kd.fused_sample(x, seed, temp, topk, stream)),
        "plain_ms": timer.ms(lambda: kd.fused_sample_plain(x, seed, temp,
                                                           topk, stream)),
        "library_ms": timer.ms(library),
        "entry_ms": timer.ms(entry),
    }
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "fused_sample")
    # one read of every logit; the work per logit is a few compares
    times["bound_ms"], times["bound_by"] = bound(
        x.numel() * 4 + B * 12, x.numel() * 4, "float32")
    return err, times


def sample_sweep(torch, kd, dev):
    """Both streams at B in {1, 8, 64} and V in {64, 1000, 50257}, rows
    cycling through greedy and top_k 0, 1, 50, V//4, V-1, V, every third
    row with ties at its 50th value: bitwise the plain version, two launches
    equal, row 0 and every greedy row alone equal to their rows of the
    batch; and seed 33137's uniform of 1.0 (row 0, lane 219) on a lane
    the top-k filter drops, which must not win. Returns the number of
    cases checked."""
    cases = 0
    seed = torch.tensor(4321, dtype=torch.int32, device=dev)
    for stream in kd.STREAMS:
        for B in (1, 8, 64):
            for V in (64, 1000, 50257):
                rng = np.random.RandomState(B * 7 + V)
                x = (3.0 * rng.randn(B, V)).astype(np.float32)
                for b in range(0, B, 3):
                    order = np.argsort(-x[b])
                    x[b, order[48:53]] = x[b, order[min(49, V - 1)]]
                ks = [0, 1, 50, V // 4, V - 1, V]
                topk = torch.tensor([ks[b % 6] for b in range(B)],
                                    dtype=torch.int32, device=dev)
                temp = torch.tensor([0.0 if b % 4 == 3 else 0.6 + 0.1 * (b % 7)
                                     for b in range(B)], device=dev)
                xs = torch.from_numpy(x).to(dev)
                got = kd.fused_sample(xs, seed, temp, topk, stream)
                again = kd.fused_sample(xs, seed, temp, topk, stream)
                want = kd.fused_sample_plain(xs, seed, temp, topk, stream)
                alone = all(
                    int(kd.fused_sample(xs[b:b + 1].contiguous(), seed,
                                        temp[b:b + 1].contiguous(),
                                        topk[b:b + 1].contiguous(),
                                        stream)[0]) == int(got[b])
                    for b in [0] + [b for b in range(B) if temp[b] <= 0])
                if not (torch.equal(got, want) and torch.equal(got, again)
                        and alone):
                    fail(f"fused_sample ({stream}, B={B}, V={V}): plain "
                         f"{torch.equal(got, want)}, repeat "
                         f"{torch.equal(got, again)}, alone {alone}")
                cases += 1
    V = 50257
    x = np.random.RandomState(6).randn(1, V).astype(np.float32)
    x[0, 219] = x.min() - 1.0
    one = torch.ones(1, device=dev)
    top5 = torch.full((1,), 5, dtype=torch.int32, device=dev)
    seed = torch.tensor(33137, dtype=torch.int32, device=dev)
    got = kd.fused_sample(torch.from_numpy(x).to(dev), seed, one, top5)
    want = kd.fused_sample_plain(torch.from_numpy(x).to(dev), seed, one,
                                 top5)
    if not (torch.equal(got, want) and int(got[0]) in np.argsort(-x[0])[:5]):
        fail(f"fused_sample: the uniform of 1.0 on a filtered lane won "
             f"({int(got[0])})")
    return cases + 1


def check_prefill(torch, timer, kp, q8, build, dev, rng, Hkv, G, Dh, P_ctx,
                  timed, kvd="none", dt=None):
    """Chunk prefill at one shape against its plain version, as
    ``check_decode``; every call also checks that a second launch is
    bitwise equal to the first."""
    C, bs, nblocks = 256, 16, 512
    dt = dt or torch.bfloat16
    q = torch.randn(C, Hkv, G, Dh, device=dev).to(dt)
    kck = torch.randn(C, Hkv, Dh, device=dev).to(dt)
    vck = torch.randn(C, Hkv, Dh, device=dev).to(dt)
    k, ks = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev, dt)
    v, vs = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev, dt)
    kw = dict(block_size=bs, kv_dtype=kvd)
    if kvd != "none":
        kw.update(k_scale=ks, v_scale=vs)
    pages = torch.from_numpy(
        rng.permutation(nblocks)[:P_ctx].astype(np.int32)).to(dev)
    args = (q, kck, vck, k, v, pages)
    got = kp.flash_chunk_prefill(*args, **kw)
    want = kp.flash_chunk_prefill_plain(*args, **kw)
    if not torch.equal(got, kp.flash_chunk_prefill(*args, **kw)):
        fail(f"flash_chunk_prefill ({kvd}, {dt}, P_ctx={P_ctx}): two "
             f"launches on the same inputs differ")
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not timed:
        return err, None
    entry = prefill_entry(torch, kp, build, *args, kw)
    if not torch.equal(entry(), got):
        fail(f"flash_chunk_prefill ({kvd}, {dt}): the C entry and the "
             f"wrapper differ on the same inputs")
    S = P_ctx * bs
    e = q.element_size()
    nbytes = (q.numel() * e + 2 * kck.numel() * e
              + 2 * S * Hkv * stored_row_bytes(kvd, Dh, e) + P_ctx * 4
              + got.numel() * 4)
    visible = C * S + C * (C + 1) // 2          # (row, column) pairs seen
    flops = visible * Hkv * G * Dh * 2 * 2
    gidx = (pages.long()[:, None] * bs
            + torch.arange(bs, device=dev)).reshape(S)
    kctx = widened(q8, k[:, gidx], None if ks is None else ks[:, gidx], kvd,
                   dt)
    vctx = widened(q8, v[:, gidx], None if vs is None else vs[:, gidx], kvd,
                   dt)
    kall = torch.cat([kctx, kck.transpose(0, 1)], 1)
    vall = torch.cat([vctx, vck.transpose(0, 1)], 1)
    kall = kall.repeat_interleave(G, dim=0)[None]
    vall = vall.repeat_interleave(G, dim=0)[None]
    qh = q.reshape(C, Hkv * G, Dh).transpose(0, 1)[None]
    mask = torch.cat([torch.ones(C, S, dtype=torch.bool, device=dev),
                      torch.ones(C, C, dtype=torch.bool,
                                 device=dev).tril()], 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {
        "ms": timer.ms(lambda: kp.flash_chunk_prefill(*args, **kw)),
        "plain_ms": timer.ms(lambda: kp.flash_chunk_prefill_plain(
            *args, **kw)),
        "library_ms": timer.ms(lambda: sdpa(qh, kall, vall,
                                            attn_mask=mask)),
        "entry_ms": timer.ms(entry),
    }
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "chunk_prefill")
    times["bound_ms"], times["bound_by"] = bound(
        nbytes, flops, str(dt).replace("torch.", ""))
    return err, times


def check_span_write(torch, timer, kp, q8, build, dev, rng, Hkv, Dh, timed,
                     kvd="none"):
    """Max abs difference of every array (exact: 0 expected); bf16 rows,
    or int8 / int4 codes with their fp32 scale tables."""
    L, bs, pc, nblocks, n_valid = 12, 16, 16, 512, 200
    names = kp.span_names(kvd)
    pool, spans = {}, {}
    for n in ("k", "v"):
        pool[n], ps = quant_pool(torch, q8, (L, Hkv, nblocks * bs, Dh), kvd,
                                 dev)
        spans[n], ss = quant_pool(torch, q8, (L, Hkv, pc * bs, Dh), kvd, dev)
        if kvd != "none":
            pool[n + "_scale"], spans[n + "_scale"] = ps, ss
    pages = torch.from_numpy(
        rng.permutation(nblocks)[:pc].astype(np.int32)).to(dev)
    valid = torch.arange(pc * bs, device=dev) < n_valid
    kw = dict(block_size=bs, kv_dtype=kvd)
    ref = {n: t.clone() for n, t in pool.items()}
    kp.paged_span_write(pool, spans, pages, valid, **kw)
    kp.paged_span_write_plain(ref, spans, pages, valid, **kw)
    torch.cuda.synchronize()
    err = max((pool[n].float() - ref[n].float()).abs().max().item()
              for n in names)
    if not all(torch.equal(pool[n].view(torch.uint8), ref[n].view(torch.uint8))
               for n in names):
        fail(f"paged_span_write ({kvd}, Hkv={Hkv}, Dh={Dh}): not byte for "
             f"byte the plain version")
    if not timed:
        return err, None
    row_bytes = {n: pool[n][0, 0, 0].numel() * pool[n].element_size()
                 for n in names}
    nbytes = (2 * n_valid * L * Hkv * sum(row_bytes.values()) + pc * 4
              + pc * bs)
    rows = (pages.long()[:, None] * bs
            + torch.arange(bs, device=dev)).reshape(-1)[:n_valid]
    flat = {n: pool[n].view(L * Hkv, nblocks * bs, -1) for n in names}
    src = {n: spans[n].reshape(L * Hkv, pc * bs, -1)[:, :n_valid]
           .contiguous() for n in names}

    def library():
        for n in names:
            flat[n].index_copy_(1, rows, src[n])

    times = {
        "ms": timer.ms(lambda: kp.paged_span_write(pool, spans, pages,
                                                   valid, **kw)),
        "plain_ms": timer.ms(lambda: kp.paged_span_write_plain(
            pool, spans, pages, valid, **kw)),
        "library_ms": timer.ms(library),
    }
    # the C entry alone on the wrapper's operands
    lib, ptr = build.library(), build.ptr
    pad = 4 - len(names)
    args = ([ptr(pool[n]) for n in names] + [None] * pad
            + [ptr(spans[n]) for n in names] + [None] * pad
            + [row_bytes[n] for n in names] + [0] * pad
            + [len(names), ptr(pages), ptr(valid), L * Hkv, pc,
               nblocks * bs, bs, build.stream(dev)])

    def entry():
        build.check(lib.pk_span_write(*args), "paged_span_write")

    times["entry_ms"] = timer.ms(entry)
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "span_write")
    # the same launch with no valid row: the kernel's fixed cost
    no_rows = torch.zeros_like(valid)
    args[-6] = ptr(no_rows)
    times["empty_device_ms"], _ = timer.device_ms(entry, "span_write")
    times["bound_ms"], times["bound_by"] = bound(nbytes, 0.0, "bfloat16")
    return err, times


def check_flash(torch, timer, ka, build, dev, B, T, H, Hkv, D, dtype,
                causal, timed):
    """Kernels 5 and 6 (flash attention forward and backward) against
    their plain versions at one shape, through the same GQA expansion
    and [B*H, T, D] layout as ``flash_attention``. Returns the errors
    {fwd: (out, lse), bwd: (dq, dk, dv)} as max abs and, for bf16, in
    bf16 ulps; whether a second launch of each kernel on the same inputs
    gave bitwise the same outputs; and, when ``timed``, the times. Beside
    the wrapper's time (``ms``) stands ``entry_ms``: the C entry alone,
    its outputs allocated beforehand, so the difference is the wrapper's
    host work (checks, allocation, the ctypes call) before the launch;
    the forward's and the fp32 backward's rows also hold ``device_ms``,
    the profiler's time of their kernels."""
    g = torch.Generator(device=dev).manual_seed(T + H)

    def rand(heads):
        return torch.randn(B, T, heads, D, generator=g, device=dev).to(dtype)

    def rows(x):
        return (ka.expand_kv_heads(x, H).transpose(1, 2)
                .reshape(B * H, T, D).contiguous())

    q, k, v, do = rows(rand(H)), rows(rand(Hkv)), rows(rand(Hkv)), rows(
        rand(H))
    kw = dict(sm_scale=D ** -0.5, causal=causal)
    out, lse = ka.flash_attention_fwd(q, k, v, **kw)
    grads = ka.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    out2, lse2 = ka.flash_attention_fwd(q, k, v, **kw)
    grads2 = ka.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want_out, want_lse = ka.flash_attention_fwd_plain(q, k, v, **kw)
    want = ka.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    repeat = (torch.equal(out, out2) and torch.equal(lse, lse2)
              and all(torch.equal(a, b) for a, b in zip(grads, grads2)))

    def abs_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    errs = {"fwd": (abs_err(out, want_out), abs_err(lse, want_lse)),
            "bwd": tuple(abs_err(a, b) for a, b in zip(grads, want))}
    ulps = None
    if dtype == torch.bfloat16:
        ulps = {"fwd": ka.bf16_ulps(out, want_out),
                "bwd": max(ka.bf16_ulps(a, b)
                           for a, b in zip(grads, want))}
    else:
        # kernel and plain version against the plain version in float64:
        # which of the two fp32 results strays from the exact one
        f64 = [t.double() for t in (q, k, v, out, lse, do)]
        exact = {"fwd": ka.flash_attention_fwd_plain(*f64[:3], **kw)[:1],
                 "bwd": ka.flash_attention_bwd_plain(*f64, **kw)}
        got = {"fwd": (out,), "bwd": grads}
        plain = {"fwd": (want_out,), "bwd": want}

        def err64(xs, ys):
            return max((x.double() - y).abs().max().item()
                       for x, y in zip(xs, ys))
        for part in ("fwd", "bwd"):
            errs[part + "_f64"] = (err64(got[part], exact[part]),
                                   err64(plain[part], exact[part]))
        del f64, exact
    if not timed:
        return errs, ulps, repeat, None
    e = q.element_size()
    n = q.numel()
    pairs = (T * (T + 1) // 2 if causal else T * T) * B * H
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (t.view(B, H, T, D) for t in (q, k, v, do))
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    o_lib = sdpa(qs, ks, vs, is_causal=causal)
    times = {
        "fwd": {
            "ms": timer.ms(lambda: ka.flash_attention_fwd(q, k, v, **kw)),
            "plain_ms": timer.ms(lambda: ka.flash_attention_fwd_plain(
                q, k, v, **kw)),
            "library_ms": timer.ms(lambda: sdpa(q4, k4, v4,
                                                is_causal=causal))},
        "bwd": {
            "ms": timer.ms(lambda: ka.flash_attention_bwd(
                q, k, v, out, lse, do, **kw)),
            "plain_ms": timer.ms(lambda: ka.flash_attention_bwd_plain(
                q, k, v, out, lse, do, **kw)),
            "library_ms": timer.ms(lambda: torch.autograd.grad(
                o_lib, (qs, ks, vs), do4, retain_graph=True))},
    }
    lib, ptr = build.library(), build.ptr
    delta = (do.float() * out.float()).sum(dim=-1)
    spare = [torch.empty_like(t) for t in (out, lse, q, k, v)]
    flags = (kw["sm_scale"], int(causal), build.DTYPE_CODES[dtype],
             build.stream(dev))
    fwd_args = [ptr(t) for t in (q, k, v, *spare[:2])] + [B * H, T, D]
    bwd_args = [ptr(t) for t in (q, k, v, do, lse, delta, *spare[2:])] + [
        B * H, T, D]
    for name, entry, args in (("fwd", lib.pk_flash_attn_fwd, fwd_args),
                              ("bwd", lib.pk_flash_attn_bwd, bwd_args)):
        build.check(entry(*args, *flags), f"flash_attention_{name}")
        times[name]["entry_ms"] = timer.ms(lambda: entry(*args, *flags))
    # the forward's kernel on the device, from the profiler
    times["fwd"]["device_ms"], _ = timer.device_ms(
        lambda: lib.pk_flash_attn_fwd(*fwd_args, *flags), "flash_fwd_tc")
    if dtype == torch.float32:
        # the backward's two kernels on the device, each from the profiler
        def bwd_entry():
            return lib.pk_flash_attn_bwd(*bwd_args, *flags)
        parts = [timer.device_ms(bwd_entry, k)[0] for k in ("dkdv", "bwd_dq")]
        times["bwd"]["dkdv_device_ms"], times["bwd"]["dq_device_ms"] = parts
        times["bwd"]["device_ms"] = (None if None in parts
                                     else parts[0] + parts[1])
    dname = str(dtype).replace("torch.", "")
    # forward: q, k, v read, out written, lse written; q.k and p.v
    times["fwd"]["bound_ms"], times["fwd"]["bound_by"] = bound(
        4 * n * e + lse.numel() * 4, 4 * D * pairs, dname)
    # backward: q, k, v, out, do, lse read, dq, dk, dv written; five
    # products (q.k, do.v, p^T do, ds k, ds^T q)
    times["bwd"]["bound_ms"], times["bwd"]["bound_by"] = bound(
        8 * n * e + lse.numel() * 4, 10 * D * pairs, dname)
    return errs, ulps, repeat, times


def masked_block_fp32(torch, ka, dev) -> bool:
    """Kernel 6's fp32 branch through ``flash_block_bwd`` on a block
    wholly in the future as the flash ring feeds it (``ring.masked_lse``:
    lse = +1e30) at the ring's block shape ([24, 1024, 64], non-causal):
    dq, dk and dv exactly 0, on the card and in the plain version."""
    g = torch.Generator(device=dev).manual_seed(30)
    q, k, v, out, do = (torch.randn(24, 1024, 64, generator=g, device=dev)
                        for _ in range(5))
    lse = torch.full((24, 1024), 1e30, device=dev)
    card = ka.flash_block_bwd(q, k, v, out, lse, do, 0.125, False)
    plain = ka.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         sm_scale=0.125, causal=False)
    torch.cuda.synchronize()
    return all(bool((t == 0).all()) for t in card + plain)


def flash_fwd_fp32_gqa(torch, ka, dev):
    """Kernel 5's fp32 branch, untimed, at the GQA wide-head shape (B=1,
    H=32, Hkv=8, D=128, T=2048, causal: the largest shared-memory plan,
    three term tiles each of q, K, V and the raw K/V rows), through the
    same expansion and layout as ``flash_attention``. Returns the max
    abs errors of out and lse against the plain version, whether two
    launches gave bitwise the same outputs, and the kernel's and plain
    version's max abs errors of out against the plain version in
    float64."""
    B, T, H, Hkv, D = 1, 2048, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(T + H + 1)

    def rows(heads):
        x = torch.randn(B, T, heads, D, generator=g, device=dev)
        return (ka.expand_kv_heads(x, H).transpose(1, 2)
                .reshape(B * H, T, D).contiguous())

    q, k, v = rows(H), rows(Hkv), rows(Hkv)
    kw = dict(sm_scale=D ** -0.5, causal=True)
    out, lse = ka.flash_attention_fwd(q, k, v, **kw)
    out2, lse2 = ka.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = ka.flash_attention_fwd_plain(q, k, v, **kw)
    exact = ka.flash_attention_fwd_plain(q.double(), k.double(),
                                         v.double(), **kw)[0]
    torch.cuda.synchronize()
    repeat = torch.equal(out, out2) and torch.equal(lse, lse2)
    errs = ((out - want_out).abs().max().item(),
            (lse - want_lse).abs().max().item())
    f64 = ((out.double() - exact).abs().max().item(),
           (want_out.double() - exact).abs().max().item())
    return errs, repeat, f64


FLASH_FP32_TOL = 1e-4        # fp32 out, lse and grads: sums in another order
FLASH_BF16_ULPS = 2          # bf16 out and grads: one rounding each side
FLASH_LSE_TOL = 1e-4         # lse is fp32 for either input type


def flash_phase(torch, ka, build):
    """Kernels 5 and 6, both branches, every product on the tensor
    cores. bf16: the training slice's shape (B=8, T=1024, H=12, D=64,
    causal) and a GQA wide-head shape (H=32, Hkv=8, D=128, T=2048,
    causal), both timed. fp32 (three-term operands): the slice's shape,
    timed, and an uneven non-causal shape (B=2, T=1000, H=12, D=64); the
    fp32 forward also at the GQA shape (``flash_fwd_fp32_gqa``), the
    fp32 backward on a block fed lse = +1e30 (``masked_block_fp32``:
    exactly 0). Every shape also checks that a second launch on the same
    inputs is bitwise equal. Tolerances: fp32 out,
    lse and gradients within 1e-4 absolute (fp32 sums in another order);
    bf16 out and gradients within 2 bf16 ulps (both versions accumulate
    in fp32 and round once, so a sum near a rounding boundary may round
    the other way), lse within 1e-4."""
    dev = torch.device("cuda:0")
    timer = Timer(torch)
    bf16, f32 = torch.bfloat16, torch.float32
    sl_err, sl_ulps, sl_rep, sl_times = check_flash(
        torch, timer, ka, build, dev, 8, 1024, 12, 12, 64, bf16, True, True)
    gqa_err, gqa_ulps, gqa_rep, gqa_times = check_flash(
        torch, timer, ka, build, dev, 1, 2048, 32, 8, 128, bf16, True, True)
    f32_err, _, f32_rep, f32_times = check_flash(
        torch, timer, ka, build, dev, 8, 1024, 12, 12, 64, f32, True, True)
    odd_err, _, odd_rep, _ = check_flash(torch, timer, ka, build, dev, 2,
                                         1000, 12, 12, 64, f32, False, False)
    wide_err, wide_rep, wide_f64 = flash_fwd_fp32_gqa(torch, ka, dev)
    print(f"check flash_attention_fwd.fp32: GQA H=32 Hkv=8 D=128 T=2048 "
          f"causal out, lse max_abs_err={wide_err!r} tol={FLASH_FP32_TOL!r} "
          f"bitwise_repeat={wide_rep} f64 kernel, plain={wide_f64!r}")
    if not (max(wide_err) <= FLASH_FP32_TOL and wide_rep):
        fail("flash_attention_fwd.fp32 at the GQA D=128 shape disagrees "
             "with its plain version or does not repeat")
    masked_zero = masked_block_fp32(torch, ka, dev)
    print(f"check flash_attention_bwd.fp32: lse=+1e30 block gradients "
          f"exactly 0 on the card and in the plain version={masked_zero}")
    if not masked_zero:
        fail("flash_attention_bwd.fp32: a block fed lse = +1e30 gave "
             "nonzero gradients")
    rows = {}
    for part in ("fwd", "bwd"):
        name = f"flash_attention_{part}"
        gqa = {f"gqa_{'kernel_ms' if k == 'ms' else k}": v
               for k, v in gqa_times[part].items()}
        bf16_row = (max(sl_err[part]), {
            "bf16_ulps": sl_ulps[part],
            "gqa_max_abs_err": max(gqa_err[part]),
            "gqa_bf16_ulps": gqa_ulps[part], **gqa,
            "bitwise_repeat": sl_rep and gqa_rep}, sl_times[part])
        f32_row = (max(f32_err[part]), {
            "uneven_max_abs_err": max(odd_err[part]),
            **({"gqa_max_abs_err": max(wide_err),
                "gqa_f64_max_abs_err": wide_f64[0],
                "gqa_plain_f64_max_abs_err": wide_f64[1]}
               if part == "fwd" else {}),
            "f64_max_abs_err": f32_err[part + "_f64"][0],
            "plain_f64_max_abs_err": f32_err[part + "_f64"][1],
            "bitwise_repeat": f32_rep and odd_rep and (
                wide_rep or part == "bwd"),
            **({"masked_block_zero": masked_zero} if part == "bwd"
               else {})}, f32_times[part])
        lse_ok = part == "bwd" or max(sl_err[part][1], gqa_err[part][1],
                                      f32_err[part][1],
                                      odd_err[part][1]) <= FLASH_LSE_TOL
        for row_name, (err, extra, times) in ((name, bf16_row),
                                              (name + ".fp32", f32_row)):
            print(f"kernel {row_name}: max_abs_err={err!r} "
                  + " ".join(f"{k}={v!r}" for k, v in extra.items())
                  + f" tol=({FLASH_FP32_TOL!r} fp32, {FLASH_BF16_ULPS} "
                  f"bf16 ulps) "
                  + " ".join(f"{'kernel_ms' if k == 'ms' else k}={v!r}"
                             for k, v in times.items()))
            rows[row_name] = (err, extra, times)
        f32_max = max(f32_err[part] + odd_err[part])
        if not (lse_ok and f32_max <= FLASH_FP32_TOL
                and max(sl_ulps[part], gqa_ulps[part]) <= FLASH_BF16_ULPS):
            fail(f"{name} disagrees with its plain version")
        if not (sl_rep and gqa_rep and f32_rep and odd_rep):
            fail(f"{name}: two launches on the same inputs differ")
    return rows


def kernel_phase(torch, kd, kp, q8, build):
    """Each kernel and each quantized branch against its plain version
    at the slice's shapes (GPT-2 small: Hkv=12, G=1, Dh=64, bf16
    queries; the prefill both cold and with 512 context positions; int8
    and int4 pools for kernels 1, 3 and 4) and at a GQA shape (G=4,
    Dh=128), with its tolerance; timed at the slice's shapes. Decode
    and prefill also run with fp32 queries over an fp32 pool (rows 1f
    and 3f: the fp32 instantiations of the decode and the tensor-core
    prefill kernels), the prefill also over an int8 pool and over 65536
    context positions, and each decode branch at G=8, Dh=128 over 16384
    positions and, at the slice, alone against its batch (bitwise). The
    sampler has no head layout, so it has no GQA shape."""
    dev = torch.device("cuda:0")
    timer = Timer(torch)
    rows = {}
    for kvd in ("none", "int8", "int4"):
        # the same pages and positions for every storage
        rng = np.random.RandomState(0)
        sfx = "" if kvd == "none" else f".{kvd}"
        e1, t1 = check_decode(torch, timer, kd, q8, build, dev, rng, 12, 1,
                              64, True, kvd)
        e1g, _ = check_decode(torch, timer, kd, q8, build, dev, rng, 4, 4,
                              128, False, kvd)
        long_err = decode_long(torch, kd, q8, dev, kvd)
        alone, repeat = decode_invariance(torch, kd, q8, dev, kvd)
        print(f"check decode{sfx}: G=8 Dh=128 T=16384 max_abs_err="
              f"{long_err!r} tol=1e-4; B=1 vs B=8 bitwise={alone}; two "
              f"launches bitwise={repeat}")
        if not (long_err <= 1e-4 and alone and repeat):
            fail(f"flash_decode_attention{sfx}: long context, batch "
                 f"invariance or repeatability failed")
        rows["flash_decode_attention" + sfx] = (e1, e1g, 1e-4, t1, {
            "long_context_max_abs_err": long_err,
            "batch_invariant": alone, "bitwise_repeat": repeat})
        if kvd == "none":
            for stream in kd.STREAMS:
                e2, t2 = check_sample(torch, timer, kd, build, dev, rng,
                                      stream)
                rows["fused_sample" + ("" if stream == "hash"
                                       else ".threefry")] = (e2, None, 0.0,
                                                             t2, {})
            print(f"check sample: {sample_sweep(torch, kd, dev)} cases, both "
                  f"streams bitwise the plain version, repeatable, rows "
                  f"alone equal to their batch rows")
        e3, t3 = check_prefill(torch, timer, kp, q8, build, dev, rng, 12, 1,
                               64, 32, True, kvd)
        if kvd == "none":
            e3c, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 12,
                                   1, 64, 0, False)
            e3 = max(e3, e3c)
        e3g, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 4, 4,
                               128, 32, False, kvd)
        rows["flash_chunk_prefill" + sfx] = (e3, e3g, 1e-4, t3,
                                             {"bitwise_repeat": True})
        e4, t4 = check_span_write(torch, timer, kp, q8, build, dev, rng, 12,
                                  64, True, kvd)
        e4g, _ = check_span_write(torch, timer, kp, q8, build, dev, rng, 4,
                                  128, False, kvd)
        rows["paged_span_write" + sfx] = (e4, e4g, 0.0, t4, {})
    # fp32 queries over an fp32 pool
    rng = np.random.RandomState(0)
    f32 = torch.float32
    e1, t1 = check_decode(torch, timer, kd, q8, build, dev, rng, 12, 1, 64,
                          True, dt=f32)
    e1g, _ = check_decode(torch, timer, kd, q8, build, dev, rng, 4, 4, 128,
                          False, dt=f32)
    rows["flash_decode_attention.fp32"] = (e1, e1g, 1e-4, t1, {})
    e3, t3 = check_prefill(torch, timer, kp, q8, build, dev, rng, 12, 1, 64,
                           32, True, dt=f32)
    e3c, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 12, 1, 64,
                           0, False, dt=f32)
    e3g, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 4, 4, 128,
                           32, False, dt=f32)
    e3q, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 12, 1, 64,
                           32, False, "int8", dt=f32)
    e3l = prefill_long(torch, kp, dev)
    print(f"check prefill.fp32: int8 pool max_abs_err={e3q!r}, S=65536 "
          f"max_abs_err={e3l!r} tol=1e-4")
    if not (e3q <= 1e-4 and e3l <= 1e-4):
        fail("flash_chunk_prefill.fp32: the int8 pool or the long context "
             "disagrees with the plain version")
    rows["flash_chunk_prefill.fp32"] = (max(e3, e3c), e3g, 1e-4, t3, {
        "bitwise_repeat": True, "int8_max_abs_err": e3q,
        "long_context_max_abs_err": e3l})
    for name, (err, gqa_err, tol, times, extra) in rows.items():
        shown = {("kernel_ms" if k == "ms" else k): v
                 for k, v in times.items()}
        print(f"kernel {name}: max_abs_err={err!r} gqa_max_abs_err="
              f"{gqa_err!r} tol={tol!r} "
              + " ".join(f"{k}={v!r}" for k, v in shown.items()))
        if not (err <= tol and (gqa_err is None or gqa_err <= tol)):
            fail(f"{name} disagrees with its plain version: "
                 f"{err}, {gqa_err} > {tol}")
    return {name: (err, {"gqa_max_abs_err": gqa_err, **extra}, times)
            for name, (err, gqa_err, _, times, extra) in rows.items()}


# ---------------------------------------------------------------------------
# step functions on the card against the CPU, small fp32 model
# ---------------------------------------------------------------------------


def step_parity(torch, tt):
    """Two prefill chunks and a decode step of a small fp32 model on the
    card against the CPU, logits and pool within 1e-4. When they part, the
    walk runs again on both sides (does either side repeat itself?) and
    the pool's per-(layer, page) differences are printed before the
    failure (``steps diag:`` line)."""
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    bs, nb = 16, 16
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, 256, 40).astype(np.int32)
    pages = np.asarray([3, 9, 4, 0], np.int32)       # 0: unmapped tail

    def walk(d):
        """(logits of the three steps on the CPU, the pool) on ``d``."""
        params = tt.init_params(cfg, torch.Generator().manual_seed(5), d)
        pool = tt.init_block_pool(cfg, nb, bs, device=d)
        out = []
        for off, c in ((0, 32), (32, 8)):
            bucket = 32 if c > 16 else 16
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :c] = prompt[off:off + c]
            pv = pages[:off // bs + bucket // bs]
            lg, _ = tt.prefill_into_blocks(
                params, pool, torch.from_numpy(padded).to(d), c,
                torch.from_numpy(pv.copy()).to(d), cfg, block_size=bs)
            out.append(lg.cpu())
        tok = torch.tensor([int(out[-1].argmax()), 5], dtype=torch.int32)
        lg, _ = tt.decode_step_paged(
            params, pool, tok.to(d),
            torch.tensor([40, 3], dtype=torch.int32).to(d),
            torch.tensor([True, False]).to(d),
            torch.from_numpy(np.stack([pages, pages])).to(d), cfg,
            block_size=bs)
        out.append(lg.cpu())
        return out, {n: t.cpu() for n, t in pool.items()}

    def diffs(a, b):
        """(per-step logits errors, pool error) between two walks."""
        return ([(x - y).abs().max().item() for x, y in zip(a[0], b[0])],
                max((a[1][n] - b[1][n]).abs().max().item()
                    for n in ("k", "v")))

    cpu, card = walk("cpu"), walk("cuda")
    if not all(torch.isfinite(x).all() for x in card[0]):
        fail("non-finite logits on the card")
    errs, pool_err = diffs(cpu, card)
    err = max(errs)
    print(f"steps: prefill(2 chunks)+decode on the card vs the CPU, fp32, "
          f"logits max_abs_err={err!r} (per step {errs}) pool "
          f"max_abs_err={pool_err!r} tol=1e-4")
    if not (err <= 1e-4 and pool_err <= 1e-4):
        cpu2, card2 = walk("cpu"), walk("cuda")
        per_page = {n: [[(cpu[1][n][li, :, p * bs:(p + 1) * bs]
                          - card[1][n][li, :, p * bs:(p + 1) * bs])
                         .abs().max().item() for p in (3, 9, 4)]
                        for li in range(cfg.n_layers)] for n in ("k", "v")}
        print("steps diag: " + json.dumps({
            "cpu_again": diffs(cpu, cpu2), "card_again": diffs(card, card2),
            "cpu_again_vs_card_again": diffs(cpu2, card2),
            "pool_by_layer_and_page_3_9_4": per_page,
            "threads": torch.get_num_threads()}))
        fail("step functions on the card disagree with the CPU")


def pools_close(torch, q8, a, b, kvd):
    """(max code difference, share of equal codes, max relative scale
    difference) of two quantized pools; int4 compared nibble by
    nibble."""
    dmax, equal, srel = 0, 1.0, 0.0
    for n in ("k", "v"):
        x, y = a[n].cpu(), b[n].cpu()
        if kvd == "int4":
            x, y = q8.unpack_int4(x), q8.unpack_int4(y)
        d = (x.int() - y.int()).abs()
        dmax = max(dmax, int(d.max()))
        equal = min(equal, float((d == 0).float().mean()))
        sa, sb = a[n + "_scale"].cpu(), b[n + "_scale"].cpu()
        rel = ((sa - sb).abs() / sb.abs().clamp_min(1e-30)).max().item()
        srel = max(srel, rel)
    return dmax, equal, srel


def step_parity_quant(torch, tt, tlm, q8):
    """The step_parity walk with an int8 pool and int8 weights
    (``quantize_lm_params`` of the seed-5 fp32 draws), card vs CPU:
    logits within 1e-4 (fp32, sums in another order); pool codes within
    1 and equal on >= 99.9 % of elements (a projection an ulp off can
    cross a rounding boundary); scales within 1e-5 relative (a scale is
    a row's absmax over 127, and the k/v rows themselves differ by fp32
    sums of 128 products taken in another order: ~1e-6 relative, 8e-7
    observed on an H100)."""
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    bs, nb = 16, 16
    fp32 = tt.init_train_params(cfg, torch.Generator().manual_seed(5), "cpu")
    params = {d: tlm.quantize_lm_params(fp32, device=d)
              for d in ("cpu", "cuda")}
    pools = {d: tt.init_block_pool(cfg, nb, bs, kv_dtype="int8", device=d)
             for d in ("cpu", "cuda")}
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, 256, 40).astype(np.int32)
    pages = np.asarray([3, 9, 4, 0], np.int32)       # 0: unmapped tail
    logits = {}
    for d in ("cpu", "cuda"):
        out = []
        for off, c in ((0, 32), (32, 8)):
            bucket = 32 if c > 16 else 16
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :c] = prompt[off:off + c]
            pv = pages[:off // bs + bucket // bs]
            lg, _ = tt.prefill_into_blocks(
                params[d], pools[d], torch.from_numpy(padded).to(d), c,
                torch.from_numpy(pv.copy()).to(d), cfg, block_size=bs)
            out.append(lg.cpu())
        tok = torch.tensor([int(out[-1].argmax()), 5], dtype=torch.int32)
        lg, _ = tt.decode_step_paged(
            params[d], pools[d], tok.to(d),
            torch.tensor([40, 3], dtype=torch.int32).to(d),
            torch.tensor([True, False]).to(d),
            torch.from_numpy(np.stack([pages, pages])).to(d), cfg,
            block_size=bs)
        out.append(lg.cpu())
        logits[d] = out
    err = 0.0
    for a, b in zip(logits["cpu"], logits["cuda"]):
        if not torch.isfinite(b).all():
            fail("non-finite logits on the card (int8 pool, int8 weights)")
        err = max(err, (a - b).abs().max().item())
    dmax, equal, srel = pools_close(torch, q8, pools["cuda"], pools["cpu"],
                                    "int8")
    print(f"steps int8: prefill(2 chunks)+decode on the card vs the CPU, "
          f"fp32, int8 pool and int8 weights, logits max_abs_err={err!r} "
          f"tol=1e-4; pool codes max_diff={dmax} equal_share={equal!r} "
          f"(tol 1, 0.999); scales max_rel_err={srel!r} tol=1e-5")
    if not (err <= 1e-4 and dmax <= 1 and equal >= 0.999 and srel <= 1e-5):
        fail("quantized step functions on the card disagree with the CPU")


# ---------------------------------------------------------------------------
# training on the card against the CPU, small fp32 model
# ---------------------------------------------------------------------------


def _train_run(torch, tt, topt, cfg, batches, device):
    """Adam (lr 1e-3) steps from seeded weights, one batch per step:
    (losses, first step's gradients on the CPU, final params)."""
    params = tt.init_train_params(cfg, torch.Generator().manual_seed(5),
                                  device)
    adam = topt.Adam(learning_rate=1e-3)
    state = adam.tree_init_state(params)
    losses, first = [], None
    for i, toks in enumerate(batches):
        toks = torch.from_numpy(toks).to(device)
        loss = tt.lm_loss(params, toks, toks.roll(-1, 1), cfg)
        loss.backward()
        grads = topt.take_grads(params)
        if first is None:
            first = {n: g.cpu() for n, g in topt.tree_leaves(grads)}
        params, state = adam.tree_update(i, grads, params, state)
        losses.append(loss.item())
    return losses, first, params


def train_parity(torch, tt, topt, kernels):
    """The step_parity model with flash attention, T=96 (one full and
    one ragged 64-row tile): card vs CPU within 1e-4 (fp32 throughout,
    sums in other orders through two layers, the vocab head and up to
    five Adam steps), then the same three steps twice on the card,
    bitwise. The card's five steps are the fp32 attention branch's path:
    its launch counts are read around them (every fp32 kernel launched,
    no bf16 one). Returns those counts."""
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    rng = np.random.RandomState(8)
    batches = [rng.randint(0, 256, (2, 96)).astype(np.int32)
               for _ in range(5)]
    cpu = _train_run(torch, tt, topt, cfg, batches, "cpu")
    kernels.reset_launches()                 # counts of the fp32 path
    gpu = _train_run(torch, tt, topt, cfg, batches, "cuda")
    launches = kernels.launch_counts()
    loss_err = max(abs(a - b) for a, b in zip(cpu[0], gpu[0]))
    grad_err = max((cpu[1][n] - gpu[1][n]).abs().max().item()
                   for n in cpu[1])
    runs = [_train_run(torch, tt, topt, cfg, batches[:3], "cuda")
            for _ in range(2)]
    same_loss = runs[0][0] == runs[1][0]
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        topt.tree_leaves(runs[0][2]), topt.tree_leaves(runs[1][2])))
    print(f"train parity: 5 Adam steps card vs CPU, fp32, losses "
          f"{gpu[0]!r}, loss max_abs_err={loss_err!r} step-1 grads "
          f"max_abs_err={grad_err!r} tol=1e-4; 3 steps twice on the card: "
          f"losses bitwise={same_loss} params bitwise={same_params}")
    if not all(np.isfinite(gpu[0])):
        fail("non-finite training loss on the card")
    if not (loss_err <= 1e-4 and grad_err <= 1e-4):
        fail("training on the card disagrees with the CPU")
    if not (same_loss and same_params):
        fail("two identical training runs on the card differ")
    n = cfg.n_layers * len(batches)
    print(f"train parity launches: "
          + " ".join(f"{k}={launches[k]}" for k in TRAINING_KERNELS
                     + FP32_BRANCHES))
    if not (all(launches[k] == n for k in FP32_BRANCHES)
            and all(launches[k] == 0 for k in TRAINING_KERNELS)):
        fail(f"fp32 training launched other attention kernels than the "
             f"fp32 branch {n} times each: {launches}")
    return launches


# ---------------------------------------------------------------------------
# engine phase
# ---------------------------------------------------------------------------


def gpt2_small(tt):
    """GPT-2 small widths (Radford et al. 2019; Hugging Face ``gpt2``)."""
    return tt.TransformerConfig(vocab=50257, d_model=768, n_heads=12,
                                n_layers=12, d_ff=3072, max_len=1024,
                                use_rope=False, dtype="bf16")


ENGINE_KW = dict(batch=8, cache_len=1024, block_size=16, chunk_tokens=256,
                 seed=0)


def trace(rng, vocab):
    """16 requests: prompts of 32..700 tokens, the first two sharing a
    256-token prefix (the second is the greedy prefix hit), max_new
    32..64, half greedy and half at temperature 0.8 with top_k 50."""
    prefix = rng.randint(0, vocab, 256)
    reqs = [(np.concatenate([prefix, rng.randint(0, vocab, 100)]), 48, 0.8),
            (np.concatenate([prefix, rng.randint(0, vocab, 180)]), 40, 0.0)]
    lens = list(rng.randint(32, 701, 13)) + [700]
    for i, n in enumerate(lens):
        reqs.append((rng.randint(0, vocab, n), int(rng.randint(32, 65)),
                     0.0 if i % 2 == 0 else 0.8))
    return reqs


def submit(eng, prompt, max_new, temp):
    return eng.submit(prompt, max_new, temperature=temp,
                      top_k=50 if temp > 0 else 0)


def chunk_keys(reqs, chunk_tokens, block_size, buckets) -> set:
    """The (chunk bucket, page-vector length) keys the scheduler's chunk
    walk reaches for ``reqs``: each prompt from its prefix hit (whole
    chunks at the front) in chunks of ``chunk_tokens``, the tail padded
    to the smallest covering bucket."""
    keys = set()
    for r in reqs:
        off, n = r.prefix_hit_tokens, r.prompt.size
        while off < n:
            c = min(n - off, chunk_tokens)
            b = min(x for x in buckets if x >= c)
            keys.add((b, off // block_size + -(-b // block_size)))
            off += c
    return keys


def serve_trace(torch, eng, reqs_in):
    """Submit ``reqs_in`` at once and drain: (requests, wall seconds,
    graphs captured in the window, capture seconds in the window)."""
    before = eng.compile_counts()
    secs = eng.health()["compile_seconds"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(eng, *r) for r in reqs_in]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = eng.compile_counts()
    secs2 = eng.health()["compile_seconds"]
    captures = {k: after[k] - before[k] for k in after}
    return reqs, wall, captures, sum(secs2.values()) - sum(secs.values())


def served_doc(reqs, wall) -> dict:
    """Tokens/s and TTFT quantiles of requests served in ``wall`` s."""
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = np.asarray([r.ttft_s for r in reqs])
    return {"requests": len(reqs), "generated_tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99))}


def trace_doc(reqs, wall, captures, capture_s) -> dict:
    return dict(served_doc(reqs, wall),
                prefix_hit_tokens=reqs[1].prefix_hit_tokens,
                captures=captures, capture_s=capture_s)


def check_served(label, reqs, reqs_in, vocab):
    for r, (p, max_new, _) in zip(reqs, reqs_in):
        ids = np.asarray(r.tokens)
        if (r.status != "done" or len(ids) != max_new
                or ids.min() < 0 or ids.max() >= vocab):
            fail(f"{label} request {r.rid}: status {r.status}, {len(ids)} "
                 f"of {max_new} tokens, ids in [{ids.min()}, {ids.max()}]")


def engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev, params,
                 kv_dtype, label, branch):
    """Serve the 16-request trace with ``params`` over a ``kv_dtype``
    pool in a fresh engine; print the ``<label>:`` line, whose timed
    window holds every CUDA graph capture of the trace (``captures``,
    ``capture_s``), and its ``warm`` block: a second trace drawn the same
    way from seed 1, served next by the same engine. Check every
    request, the launch of each serving kernel of the ``branch`` ("" for
    the model-dtype pool, ".int8"/".int4"), that the graphs captured are
    the trace's distinct (bucket, page-vector length) keys plus one for
    decode, and that the prefix hit equals the cold run in a fresh
    engine; then serve a third trace (seed 2) under the profiler
    (``<label>_profile:`` line). Returns the timed run's launch counts
    and each request's ids (trace order)."""
    kw = dict(ENGINE_KW, kv_dtype=kv_dtype)
    # first-use costs of the process (cuBLAS handles, the allocator)
    # stay out of the timing: a throwaway engine serves one request, so
    # every capture of the timed engine falls inside its window
    warm_eng = PagedDecodeEngine.from_params(params, cfg, device=dev, **kw)
    warm = submit(warm_eng, np.arange(40) % cfg.vocab, 4, 0.0)
    warm_eng.run_until_idle()
    if len(warm.tokens) != 4:
        fail("warm-up request did not finish")
    del warm_eng
    eng = PagedDecodeEngine.from_params(params, cfg, device=dev, **kw)
    reqs_in = trace(np.random.RandomState(0), cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                 # counts of the main path only
    reqs, wall, captures, capture_s = serve_trace(torch, eng, reqs_in)
    launches = kernels.launch_counts()
    observed = observe_check(eng, reqs) if label == "engine" else None
    health = eng.health()
    doc = trace_doc(reqs, wall, captures, capture_s)
    doc.update({"decode_mfu": eng.decode_mfu(),
                "decode_steps": health["decode_steps"],
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated(),
                "kv_dtype": health["kv_dtype"],
                "kv_bytes_per_token": health["kv_bytes_per_token"],
                "pool_bytes": eng.pool_bytes, "launches": launches})
    keys = chunk_keys(reqs, eng.chunk_tokens, eng.block_size, eng.buckets)
    warm_in = trace(np.random.RandomState(1), cfg.vocab)
    wreqs, wwall, wcaptures, wcapture_s = serve_trace(torch, eng, warm_in)
    doc["warm"] = trace_doc(wreqs, wwall, wcaptures, wcapture_s)
    print(f"{label}: " + json.dumps(doc))
    check_served(label, reqs, reqs_in, cfg.vocab)
    check_served(f"{label} warm", wreqs, warm_in, cfg.vocab)
    if not eng.pool.idle:
        fail(f"{label}: blocks still held after the engine drained")
    path = [k + (branch if k != "fused_sample" else "")
            for k in SERVING_KERNELS] + ["fused_sample.threefry"]
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        fail(f"{label}: kernels never launched on the main path: {missing}")
    wkeys = chunk_keys(wreqs, eng.chunk_tokens, eng.block_size, eng.buckets)
    want = {"prefill": len(keys), "decode": 1}
    wwant = {"prefill": len(wkeys - keys), "decode": 0}
    print(f"check {label} graphs: captured {captures} in the trace, "
          f"{wcaptures} in the warm trace; distinct (bucket, pages) keys "
          f"{len(keys)} and {len(wkeys - keys)} new + one decode graph")
    if captures != want or wcaptures != wwant:
        fail(f"{label}: captured {captures} / {wcaptures}, expected "
             f"{want} / {wwant}")
    if reqs[1].prefix_hit_tokens != 256:
        fail(f"{label}: the shared-prefix request hit "
             f"{reqs[1].prefix_hit_tokens} tokens, expected 256")
    # the hit replays a cold prefill: same greedy tokens in a fresh engine
    cold_eng = PagedDecodeEngine.from_params(params, cfg, device=dev, **kw)
    cold = submit(cold_eng, *reqs_in[1])
    cold_eng.run_until_idle()
    same = cold.tokens == reqs[1].tokens
    print(f"check {label}: prefix-hit request (hit "
          f"{reqs[1].prefix_hit_tokens} tokens) vs the same prompt cold in "
          f"a fresh engine (hit {cold.prefix_hit_tokens}): "
          f"{len(cold.tokens)} greedy tokens, identical={same}")
    if not same:
        fail(f"{label}: prefix hit and cold prefill gave different greedy "
             f"tokens")
    if observed is not None:
        observed["abort"] = abort_check(cold_eng, cfg.vocab)
        print("observe: " + json.dumps(observed))
    del cold_eng
    # where the serving time goes once the engine is warm: a third trace
    # under the profiler (its few new keys capture inside the window)
    prof_in = trace(np.random.RandomState(2), cfg.vocab)

    def serve():
        for r in prof_in:
            submit(eng, *r)
        eng.run_until_idle()
        torch.cuda.synchronize()
    before = eng.compile_counts()
    profile = profile_window(torch, serve)
    after = eng.compile_counts()
    profile["captures"] = {k: after[k] - before[k] for k in after}
    print(f"{label}_profile: " + json.dumps(profile))
    return launches, [list(r.tokens) for r in reqs]


def track_balance(trace_id) -> list:
    """The (name, phase) lifecycle events of one request track in the
    span ring, and whether its b/e slices balance (never more e than b,
    none open at the end)."""
    from paddle_tpu_torch.observe import chrome_trace
    evs = [(s[0], s[5]) for s in chrome_trace.default_buffer().spans()
           if s[6] == trace_id and s[7] == "request"]
    depth, ok = 0, True
    for _, ph in evs:
        depth += {"b": 1, "e": -1}.get(ph, 0)
        ok = ok and depth >= 0
    return evs, ok and depth == 0


def http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def observe_check(eng, reqs) -> dict:
    """The ``observe:`` line's checks, right after the bf16 engine's
    first trace: every request's track in the chrome-trace export holds
    balanced ``b``/``e`` slices and the lifecycle's events, the request
    log holds the 16 records, ``health()``'s window counts 16 requests,
    and the engine's HealthServer on 127.0.0.1 answers ``/healthz``,
    ``/metrics`` and ``/requests`` with 200 (each GET timed)."""
    from paddle_tpu_torch.observe import chrome_trace
    t0 = time.perf_counter()
    export = chrome_trace.trace_export()
    export_s = time.perf_counter() - t0
    ids = {r.trace_id for r in reqs}
    events = sum(1 for e in export["traceEvents"] if e.get("id") in ids)
    unbalanced = [r.rid for r in reqs if not track_balance(r.trace_id)[1]]
    need = {"request", "queued", "admitted", "prefill", "prefill_chunk",
            "first_token", "finished"}
    incomplete = [r.rid for r in reqs
                  if not need <= {n for n, _ in track_balance(r.trace_id)[0]}]
    doc_req = eng.requests_doc()
    window = eng.health()["window"]
    srv = eng.serve()
    codes, get_ms = {}, {}
    try:
        for route in ("/healthz", "/metrics", "/requests"):
            t0 = time.perf_counter()
            codes[route], body = http_get(srv.url + route)
            get_ms[route] = 1e3 * (time.perf_counter() - t0)
            if route == "/requests":
                served_count = json.loads(body)["count"]
    finally:
        srv.close()
    doc = {"events": events, "tracks": len(ids),
           "unbalanced_tracks": unbalanced,
           "incomplete_tracks": incomplete,
           "trace_export_ms": 1e3 * export_s,
           "request_records": doc_req["count"],
           "by_reason": doc_req["by_reason"],
           "window_requests": window["requests"],
           "window_ttft_p50_s": window["ttft_p50_s"],
           "window_ttft_p99_s": window["ttft_p99_s"],
           "http": codes, "http_ms": get_ms,
           "http_requests_count": served_count}
    if (unbalanced or incomplete or doc_req["count"] != len(reqs)
            or window["requests"] != len(reqs) or served_count != len(reqs)
            or any(c != 200 for c in codes.values())):
        print("observe: " + json.dumps(doc))
        fail(f"observe: tracks unbalanced {unbalanced}, incomplete "
             f"{incomplete}, {doc_req['count']} records, window "
             f"{window['requests']} requests, HTTP {codes}")
    return doc


def abort_check(eng, vocab) -> dict:
    """``abort_requests`` on a loaded engine (12 requests: 8 in slots
    after 3 steps, the rest queued): it returns the live count and
    leaves every track balanced. The engine is not used again."""
    rng = np.random.RandomState(41)
    reqs = [submit(eng, rng.randint(0, vocab, int(rng.randint(32, 400))),
                   32, 0.0) for _ in range(12)]
    for _ in range(3):
        eng.step()
    live = sum(1 for r in reqs if r.status != "done")
    n = eng.abort_requests()
    unbalanced = [r.rid for r in reqs if not track_balance(r.trace_id)[1]]
    doc = {"live": live, "aborted": n, "unbalanced_tracks": unbalanced,
           "statuses": sorted({r.status for r in reqs})}
    if n != live or unbalanced or doc["statuses"] != ["aborted"]:
        fail(f"abort_requests: {doc}")
    return doc


def rows_equal(torch, a, b, ba: int, bb: int, bs: int) -> bool:
    """Block ``ba`` of pool ``a`` and block ``bb`` of pool ``b``, byte for
    byte over every leaf."""
    return all(torch.equal(
        a[n][:, :, ba * bs:(ba + 1) * bs].contiguous().view(torch.uint8),
        b[n][:, :, bb * bs:(bb + 1) * bs].contiguous().view(torch.uint8))
        for n in a)


def prefix_phase(torch, kernels, PagedDecodeEngine, cfg, dev, params):
    """The ``prefix:`` line, at the engine phase's configuration (bf16
    weights).

    Transfer, for bf16, int8 and int4 pools: engine A serves a 300-token
    prompt with ``max_new=1`` and exports its 16 chunk-aligned prefix
    blocks (``export_prefix``, timed over 5 exports); a fresh engine B,
    warmed by another 300-token prompt (its graphs captured), imports
    them (``import_prefix``, timed; then the chain's deserialize and
    in-place write repeated 5 times). Every pool leaf of B keeps its
    ``data_ptr`` and B's captures do not change; B's adopted rows equal
    A's byte for byte; B then serves the prompt greedily with a
    256-token hit (16 blocks x 16) and its ids equal the same prompt
    served cold in a third fresh engine, launching each serving kernel
    of its storage.

    Tiers (bf16 pool of 24 blocks of 16, so other prompts evict the
    prompt's cached blocks): a DRAM pass and a disk pass
    (``dram_bytes=0``, a temporary directory) each serve the prompt,
    evict it with three other prompts and serve it again: the second
    run's tier hits are > 0 in the expected tier and its greedy ids are
    the cold run's. The disk pass then evicts it once more, corrupts the
    first block's file and serves it a third time: a quarantined miss,
    the ids still the cold run's. Each demotion (``pool.on_evict``) is
    timed."""
    from paddle_tpu_torch.serving import transfer
    bs = ENGINE_KW["block_size"]
    rng = np.random.RandomState(51)
    prompt = rng.randint(0, cfg.vocab, 300)
    other = rng.randint(0, cfg.vocab, 300)
    max_new = 32
    doc = {"max_new": max_new}

    def serve(eng, p, n=max_new):
        r = eng.submit(p, n)
        eng.run_until_idle()
        if r.status != "done" or len(r.tokens) != n:
            fail(f"prefix: request {r.rid} {r.status}, {len(r.tokens)} of "
                 f"{n} tokens")
        return r

    def fresh(kvd, **kw):
        return PagedDecodeEngine.from_params(
            params, cfg, device=dev, **dict(ENGINE_KW, kv_dtype=kvd, **kw))

    want = None
    for kvd in (None, "int8", "int4"):
        name = kvd or "bf16"
        cold = serve(fresh(kvd), prompt).tokens
        if kvd is None:
            want = cold
        a = fresh(kvd)
        serve(a, prompt, 1)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = a.export_prefix(prompt)
            times.append(time.perf_counter() - t0)
        digests = a.prefix_digests(prompt)
        b = fresh(kvd)
        serve(b, other)
        ptrs = {n: t.data_ptr() for n, t in b.cache.items()}
        captures = b.compile_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adopted = b.import_prefix(payload)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        same_ptrs = {n: t.data_ptr() for n, t in b.cache.items()} == ptrs
        same_captures = b.compile_counts() == captures
        rows = all(rows_equal(torch, a.cache, b.cache, a.pool.lookup(h),
                              b.pool.lookup(h), bs) for h in digests)
        rewrite = []
        meta, items = transfer.deserialize_blocks(payload)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meta, items = transfer.deserialize_blocks(payload)
            transfer.write_blocks(b.cache, [(b.pool.lookup(h), arr)
                                            for h, arr in items], bs)
            torch.cuda.synchronize()
            rewrite.append(time.perf_counter() - t0)
        kernels.reset_launches()
        r = serve(b, prompt)
        launched = kernels.launch_counts()
        branch = "" if kvd is None else f".{kvd}"
        path = [k + (branch if k != "fused_sample" else "")
                for k in SERVING_KERNELS]
        entry = {"blocks": len(digests), "adopted": adopted,
                 "payload_bytes_per_block": len(payload) / len(digests),
                 "export_ms_per_block": 1e3 * float(np.median(times))
                 / len(digests),
                 "import_ms_per_block": 1e3 * import_s / len(digests),
                 "rewrite_ms_per_block": 1e3 * float(np.median(rewrite))
                 / len(digests),
                 "prefix_hit_tokens": r.prefix_hit_tokens,
                 "ids_equal_cold": r.tokens == cold,
                 "rows_equal": rows, "data_ptrs_kept": same_ptrs,
                 "captures_kept": same_captures,
                 "captures_after_serve": b.compile_counts(),
                 "launches": {k: launched[k] for k in path}}
        doc[name] = entry
        if not (adopted == len(digests) == 16 and rows and same_ptrs
                and same_captures and r.tokens == cold
                and r.prefix_hit_tokens == 16 * bs
                and all(launched[k] > 0 for k in path)):
            print("prefix: " + json.dumps(doc))
            fail(f"prefix transfer ({name}): {entry}")
        del a, b

    kw = dict(num_blocks=24)
    for tier, tiers in (("dram", {"dram_bytes": 1 << 30}),
                        ("disk", {"dram_bytes": 0, "disk_bytes": 1 << 30})):
        with tempfile.TemporaryDirectory() as tmp:
            if tier == "disk":
                tiers = dict(tiers, disk_dir=tmp)
            eng = fresh(None, tiers=tiers, **kw)
            demote = []
            hook = eng.pool.on_evict

            def timed(block, digest, hook=hook, demote=demote):
                t0 = time.perf_counter()
                hook(block, digest)
                demote.append(time.perf_counter() - t0)
            eng.pool.on_evict = timed

            def evict(seed):
                g = np.random.RandomState(seed)
                for _ in range(3):
                    serve(eng, g.randint(0, cfg.vocab, 300), 16)
            runs = [serve(eng, prompt).tokens]
            evict(61)
            r = serve(eng, prompt)
            runs.append(r.tokens)
            hits = eng.metrics.get("engine_prefix_tier_hit_blocks_total")
            miss = eng.metrics.get("engine_prefix_tier_miss_blocks_total")
            entry = {"promoted_hit_tokens": r.prefix_hit_tokens}
            corrupt_ok = True
            if tier == "disk":
                evict(62)
                path = Path(tmp) / (eng.prefix_digests(prompt)[0].hex()
                                    + ".kv")
                raw = bytearray(path.read_bytes())
                raw[len(raw) // 2] ^= 0x40
                path.write_bytes(bytes(raw))
                r = serve(eng, prompt)
                runs.append(r.tokens)
                corrupt = int(eng.metrics.get(
                    "engine_tier_corrupt_total").value())
                corrupt_ok = (corrupt == 1 and r.prefix_hit_tokens == 0
                              and Path(str(path) + ".corrupt").exists())
                entry["corrupt"] = corrupt
            entry.update({
                "demotions": len(demote),
                "demote_ms_per_block": 1e3 * float(np.median(demote))
                if demote else None,
                "demote_ms_max": 1e3 * max(demote) if demote else None,
                "hits": {t: int(hits.value(tier=t))
                         for t in ("hbm", "dram", "disk")},
                "misses": {t: int(miss.value(tier=t))
                           for t in ("hbm", "dram", "disk")},
                "ids_equal_cold": [x == want for x in runs],
                "tiers": {k: v for k, v in eng.health()["tiers"].items()
                          if k != "digests"}})
            doc[f"tier_{tier}"] = entry
            if not (all(entry["ids_equal_cold"]) and entry["hits"][tier] > 0
                    and corrupt_ok and eng.pool.idle):
                print("prefix: " + json.dumps(doc))
                fail(f"prefix tiers ({tier}): {entry}")
            del eng
    print("prefix: " + json.dumps(doc))


def random_pool(torch, tt, cfg, nb, bs, kvd, dev, seed):
    """A pool of ``nb`` blocks in the storage ``kvd`` holding random
    values (bf16 values ~N(0, 0.25), int8/int4 codes over their range,
    fp32 scales in [0.001, 0.021)), drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    pool = tt.init_block_pool(cfg, nb, bs, kv_dtype=kvd, device="cpu")
    for name, t in pool.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
        elif name.endswith("_scale"):
            t.copy_(torch.rand(t.shape, generator=gen) * 0.02 + 0.001)
        else:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    return {n: t.to(dev) for n, t in pool.items()}


def same_pool(torch, a, b) -> bool:
    return all(torch.equal(a[n].view(torch.uint8), b[n].view(torch.uint8))
               for n in a)


def graph_phase(torch, tt, sampling, cfg, params, dev):
    """``check graphs:``: the engine's step programs against their raw
    functions on the same inputs, over bf16, int8 and int4 pools at the
    serving shapes (GPT-2 small widths, bf16 weights). Each program
    captures at its first call and replays after; its raw function runs
    eagerly on a copy of the pool. After every call the ids and every
    byte of the two pools must be equal. Prefill: a cold chunk (200
    tokens, bucket 256), a chunk with 256 tokens of context (150 tokens),
    then the cold chunk's graph replayed greedy and sampled with new
    seeds; decode: 8 rows (6 active, half of them sampled; 2 inactive
    with all-zero page tables), replayed with a second seed (whose
    sampled ids must differ somewhere, so a frozen seed shows) and after
    a remap of one row's page table."""
    bs, B = ENGINE_KW["block_size"], ENGINE_KW["batch"]
    P = ENGINE_KW["cache_len"] // bs
    nb = 460
    rng = np.random.RandomState(21)
    blocks = rng.permutation(np.arange(1, nb)).astype(np.int32)
    doc = {}

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    for kvd in (None, "int8", "int4"):
        prefill, decode = sampling.paged_step_fns(cfg, bs)
        pool_g = random_pool(torch, tt, cfg, nb, bs, kvd, dev, 9)
        pool_r = {n: t.clone() for n, t in pool_g.items()}
        calls = 0

        def check(what, got, want):
            nonlocal calls
            calls += 1
            if not (torch.equal(got, want) and same_pool(torch, pool_g,
                                                         pool_r)):
                fail(f"graphs ({kvd or 'bf16'}): {what}: replay ids "
                     f"{got.tolist()} vs raw {want.tolist()}, pools equal "
                     f"{same_pool(torch, pool_g, pool_r)}")

        slot = blocks[:32]
        for what, off, c, temp, seed in (
                ("prefill cold", 0, 200, 0.8, 11),
                ("prefill with context", 256, 150, 0.8, 12),
                ("prefill cold greedy", 0, 200, 0.0, 13),
                ("prefill cold, new seed", 0, 200, 0.8, 14)):
            toks = rng.randint(0, cfg.vocab, (1, 256)).astype(np.int32)
            toks[0, c:] = 0
            pages = slot[:off // bs + 256 // bs]
            args = (np.asarray([temp], np.float32),
                    np.asarray([50], np.int32))
            got, _ = prefill(params, pool_g, toks, np.int32(c), pages,
                             *args, np.int32(seed))
            got = got.clone()
            want, _ = prefill.raw(params, pool_r, T(toks), scalar(c),
                                  T(pages), *map(T, args), scalar(seed))
            check(what, got, want)
        table = np.zeros((B, P), np.int32)
        for b in range(6):
            table[b, :60] = blocks[32 + 60 * b:32 + 60 * (b + 1)]
        pages_dev = T(table)
        pos = np.concatenate([rng.randint(300, 950, 6),
                              [5, 700]]).astype(np.int32)
        active = np.asarray([True] * 6 + [False] * 2)
        temp = np.asarray([0.0, 0.8] * 4, np.float32)
        topk = np.asarray([0, 50] * 4, np.int32)
        sampled = {}
        for what, seed in (("decode", 21), ("decode, new seed", 22),
                           ("decode after a remap", 23)):
            if what.endswith("remap"):
                table[1, :60] = blocks[32 + 360:32 + 420]
                pages_dev.copy_(T(table))
            toks = rng.randint(0, cfg.vocab, B).astype(np.int32)
            got, _ = decode(params, pool_g, toks, pos, active, pages_dev,
                            temp, topk, np.int32(seed))
            got = got.clone()
            want, _ = decode.raw(params, pool_r, T(toks), T(pos), T(active),
                                 pages_dev, T(temp), T(topk), scalar(seed))
            check(what, got, want)
            if what != "decode after a remap":
                sampled[seed] = (toks, got[1::2].tolist())
        if sampled[21][0][1::2].tolist() == sampled[22][0][1::2].tolist() \
                and sampled[21][1] == sampled[22][1]:
            fail(f"graphs ({kvd or 'bf16'}): two seeds drew the same ids")
        graphs = {"prefill": prefill.graphs, "decode": decode.graphs}
        if graphs != {"prefill": 2, "decode": 1}:
            fail(f"graphs ({kvd or 'bf16'}): captured {graphs}")
        doc[kvd or "bf16"] = {"graphs": graphs, "calls": calls,
                              "capture_s": prefill.tracker.compile_seconds()}
        del pool_g, pool_r
    print("check graphs: replayed step programs vs their raw functions, "
          "ids and every pool byte equal: " + json.dumps(doc))


def preempt_run(make, vocab, label) -> dict:
    """Two preemptions of a batch-tier victim in engines from ``make()``
    (2 slots, a pool of 8 blocks of 16): a latency-tier arrival whose
    reservation does not fit preempts it to blocks, and since the
    arrival's allocations come from free blocks the victim's own stay
    cached and it resumes by ``remap``; then a second victim and a
    latency burst whose first request's worst case is the whole pool:
    its allocations evict the victim's parked blocks and it resumes by
    ``replay``. Each victim is running when its arrival comes. Every
    request completes, each victim's greedy ids equal the same request
    served alone in a fresh engine, and the pool is idle at the end.
    Returns the ``<label>`` document."""
    rng = np.random.RandomState(31)
    eng = make()
    t0 = time.perf_counter()
    victims, others = [], []
    for lat_lens in ([(48, 16)], [(64, 64), (32, 16)]):
        v = eng.submit(rng.randint(0, vocab, 48), 64, tier="batch")
        victims.append(v)
        while len(v.tokens) < 3:
            eng.step()
        if v.status != "running":
            fail(f"{label}: the victim is {v.status} when the latency "
                 f"requests arrive")
        others += [eng.submit(rng.randint(0, vocab, n), m,
                              tier="latency") for n, m in lat_lens]
        eng.run_until_idle()
    wall = time.perf_counter() - t0
    resumes = eng.metrics.get("engine_resumes_total")
    doc = {"requests": len(victims) + len(others),
           "preemptions": int(eng.metrics.get(
               "engine_preemptions_total").value()),
           "resumes": {m: int(resumes.value(mode=m))
                       for m in ("remap", "replay")},
           "victim_preemptions": [v.preemptions for v in victims],
           "wall_s": wall, "captures": eng.compile_counts()}
    alone = []
    for v in victims:
        # the same engine shapes: cuBLAS may round otherwise at another
        # batch size
        solo = make()
        r = solo.submit(v.prompt, v.max_new)
        solo.run_until_idle()
        alone.append(r.tokens == v.tokens)
    doc["equal_to_alone"] = alone
    print(f"{label}: " + json.dumps(doc))
    done = all(r.status == "done" and len(r.tokens) == r.max_new
               for r in victims + others)
    if not (done and eng.pool.idle and all(alone)
            and doc["resumes"] == {"remap": 1, "replay": 1}
            and doc["victim_preemptions"] == [1, 1]):
        fail(f"{label}: every request done {done}, pool idle "
             f"{eng.pool.idle}, resumes {doc['resumes']}, victims equal to "
             f"their runs alone {alone}")
    return doc


def preempt_phase(torch, PagedDecodeEngine, cfg, dev, params):
    """``preempt:``: ``preempt_run`` at GPT-2 small widths, bf16."""
    kw = dict(ENGINE_KW, batch=2, num_blocks=8)
    preempt_run(lambda: PagedDecodeEngine.from_params(params, cfg,
                                                      device=dev, **kw),
                cfg.vocab, "preempt")


def quant_logits_phase(torch, tt, cfg, params, dev):
    """Decode logits off int8 and int4 pools against the bf16 pool at
    the slice's widths, on one 300-token prompt (chunks of 256 and 44,
    then one decode step, the same bf16 weights): the global relative L2
    distance must stay under ``kv_rel_l2_budget``."""
    bs = ENGINE_KW["block_size"]
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, cfg.vocab, 300).astype(np.int32)
    pages = np.arange(1, 21, dtype=np.int32)         # 20 pages of 16
    logits = {}
    for kvd in (None, "int8", "int4"):
        pool = tt.init_block_pool(cfg, 24, bs, kv_dtype=kvd, device=dev)
        for off, c in ((0, 256), (256, 44)):
            padded = np.zeros((1, 256 if c > 64 else 64), np.int32)
            padded[0, :c] = prompt[off:off + c]
            pv = pages[:off // bs + padded.shape[1] // bs]
            lg, _ = tt.prefill_into_blocks(
                params, pool, torch.from_numpy(padded).to(dev), c,
                torch.from_numpy(pv.copy()).to(dev), cfg, block_size=bs)
        tok = lg.argmax(-1).to(torch.int32)
        lg, _ = tt.decode_step_paged(
            params, pool, tok, torch.tensor([300], dtype=torch.int32,
                                            device=dev),
            torch.ones(1, dtype=torch.bool, device=dev),
            torch.from_numpy(pages[None].copy()).to(dev), cfg,
            block_size=bs)
        logits[kvd] = lg.float()
    out = {}
    for kvd in ("int8", "int4"):
        rel = ((logits[kvd] - logits[None]).norm()
               / logits[None].norm()).item()
        budget = tt.kv_rel_l2_budget(cfg, kvd)
        out[kvd] = (rel, budget)
        print(f"check quant logits {kvd}: decode logits off the {kvd} pool "
              f"vs the bf16 pool, rel_l2={rel!r} budget={budget!r}")
        if not (np.isfinite(rel) and 0 < rel < budget):
            fail(f"{kvd} pool logits outside kv_rel_l2_budget: {rel} vs "
                 f"{budget}")
    return out


# ---------------------------------------------------------------------------
# speculative decoding phase
# ---------------------------------------------------------------------------

# benchmarks/serving_bench.py::build_draft_pair's recipe, at k = 4
SPEC_K, SPEC_DRAFT_LAYERS, SPEC_ALPHA = 4, 2, 0.05


def draft_pair(torch, tt, cfg, params):
    """The repo's draft-friendly pair on the port's weights: the target
    is ``params`` with ``attn_out`` and ``mlp_out`` of every layer past
    the first ``SPEC_DRAFT_LAYERS`` scaled by ``SPEC_ALPHA`` (its cost is
    unchanged, its logits land near the draft's); the draft IS the
    target's first ``SPEC_DRAFT_LAYERS`` layers with the shared
    embedding, position table, head and final norm. Returns (target
    params, draft config, draft params)."""
    blocks = dict(params["blocks"])
    for leaf in ("attn_out", "mlp_out"):
        w = blocks[leaf].clone()
        w[SPEC_DRAFT_LAYERS:] *= SPEC_ALPHA
        blocks[leaf] = w
    target = dict(params, blocks=blocks)
    dcfg = tt.TransformerConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=SPEC_DRAFT_LAYERS, d_ff=cfg.d_ff, max_len=cfg.max_len,
        use_rope=cfg.use_rope, dtype=cfg.dtype)
    draft = dict(target, blocks={k: v[:SPEC_DRAFT_LAYERS].contiguous()
                                 for k, v in blocks.items()})
    return target, dcfg, draft


def window_check(torch, tt, cfg, params, dev, kvd, P, lo, hi):
    """One verify window (W = SPEC_K + 1) against W sequential raw decode
    steps from the same pool state: 8 slots on disjoint pages (P a
    slot), 6 active at positions in [lo, hi) and 2 inactive, a random
    pool in the storage ``kvd``; the window's tokens are the sequential
    steps' greedy ids. Returns (the window's logits and pool, the
    sequential ones, the active rows' mask)."""
    bs, B, W = ENGINE_KW["block_size"], 8, SPEC_K + 1
    nb = B * P + 1
    rng = np.random.RandomState(41)
    pool_s = random_pool(torch, tt, cfg, nb, bs, kvd, dev, 19)
    pool_v = {n: t.clone() for n, t in pool_s.items()}
    blocks = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = blocks.reshape(B, P).copy()
    table[6:] = 0
    act = np.asarray([True] * 6 + [False] * 2)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pages, active = T(table), T(act)
    pos = T(np.concatenate([rng.randint(lo, hi, 6), [5, hi // 2]])
            .astype(np.int32))
    tok = T(rng.randint(0, cfg.vocab, B).astype(np.int32))
    seq, window = [], [tok]
    for j in range(W):
        lg, _ = tt.decode_step_paged(params, pool_s, tok, pos + j, active,
                                     pages, cfg, block_size=bs)
        seq.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        if j < W - 1:
            window.append(tok)
    valid = torch.full((B,), W, dtype=torch.int32, device=dev)
    vlg, _ = tt.verify_step_paged(params, pool_v, torch.stack(window, 1),
                                  pos, valid, active, pages, cfg,
                                  block_size=bs)
    return vlg, pool_v, torch.stack(seq, 1), pool_s, active


def window_numbers(torch, vlg, pool_v, seq, pool_s, active) -> dict:
    """The window check's reading over the active slots: max |logit
    difference|, whether logits, written pool and greedy ids are equal."""
    a, b = vlg[active].float(), seq[active].float()
    return {"max_abs_dlogit": (a - b).abs().max().item(),
            "logits_bitwise": torch.equal(a, b),
            "pool_bitwise": same_pool(torch, pool_v, pool_s),
            "greedy_equal": torch.equal(a.argmax(-1), b.argmax(-1))}


def check_spec_verify(torch, timer, kd, sampling, build, dev):
    """``fused_spec_verify`` at the spec engine's shape, [8, 5, 50257]
    fp32 logits: every slot its own temperature and top_k (a tiled
    repeat of the controls would give rows other ones), drafts that
    match the greedy rows for a slot-dependent run, valid rows 1..5:
    sampled ids and accepted counts exactly the plain version's (the
    plain sampler over the flattened rows and ``spec_accept``). Timed
    through the wrapper, its kernel launch as the C entry alone
    (``entry_ms``) and on the device (``device_ms``), the plain version,
    and topk + softmax + multinomial over the [40, V] rows."""
    B, W, V = 8, SPEC_K + 1, 50257
    rng = np.random.RandomState(45)
    x = torch.from_numpy((3.0 * rng.randn(B, W, V)).astype(np.float32)
                         ).to(dev)
    draft = x.argmax(-1)[:, :W - 1].to(torch.int32).clone()
    for b in range(B):
        if b % W < W - 1:
            draft[b, b % W] = (draft[b, b % W] + 1) % V
    temp = torch.tensor([0.0, 0.8, 0.0, 1.1, 0.0, 0.6, 0.7, 0.9],
                        device=dev)
    topk = torch.tensor([0, 50, 0, 20, 7, 5, 0, 100], dtype=torch.int32,
                        device=dev)
    valid = torch.tensor([5, 5, 3, 5, 1, 4, 2, 5], dtype=torch.int32,
                         device=dev)
    seed = torch.tensor(4321, dtype=torch.int32, device=dev)
    flat = x.reshape(B * W, V)
    temp_r = sampling.window_rows(temp, W)
    topk_r = sampling.window_rows(topk, W)

    def plain():
        ids = kd.fused_sample_plain(flat, seed, temp_r, topk_r).reshape(B, W)
        return ids, sampling.spec_accept(ids, draft, valid)

    ids, n = kd.fused_spec_verify(x, draft, seed, temp, topk, valid)
    want_ids, want_n = plain()
    torch.cuda.synchronize()
    err = float(max((ids.long() - want_ids.long()).abs().max().item(),
                    (n.long() - want_n.long()).abs().max().item()))

    def library():
        vals, idx = torch.topk(flat, 50, dim=-1)
        probs = torch.softmax(vals / 0.8, dim=-1)
        return idx.gather(-1, torch.multinomial(probs, 1))

    out = torch.empty(B * W, dtype=torch.int32, device=dev)
    lib, ptr = build.library(), build.ptr
    args = [ptr(flat), ptr(temp_r), ptr(topk_r), ptr(out), B * W, V,
            ptr(seed), kd.STREAMS.index("hash"), build.stream(dev)]

    def entry():
        build.check(lib.pk_fused_sample(*args), "fused_sample")
        return out

    if not torch.equal(entry().reshape(B, W), ids):
        fail("fused_spec_verify: the C entry and the wrapper differ on the "
             "same inputs")
    times = {
        "ms": timer.ms(lambda: kd.fused_spec_verify(x, draft, seed, temp,
                                                    topk, valid)),
        "plain_ms": timer.ms(plain),
        "library_ms": timer.ms(library),
        "entry_ms": timer.ms(entry),
    }
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "fused_sample")
    # one read of every logit (and the small per-slot vectors), the ids
    # and counts written; a few compares per logit
    times["bound_ms"], times["bound_by"] = bound(
        x.numel() * 4 + B * (W - 1) * 4 + B * 12 + B * W * 4 + B * 4,
        x.numel() * 4, "float32")
    return err, times


def target_margin(torch, tt, cfg, params, dev, buckets, prompt, ids, i):
    """The top-2 logit margin of the target-only engine's step that chose
    ``ids[i]`` for ``prompt``, recomputed with the raw steps at the
    engine's shapes: the prompt in chunks of ``chunk_tokens`` padded to
    the engine's buckets, then decode at B = 8 rows (row 0 active) fed
    ``ids[:i]``."""
    bs, C, B = (ENGINE_KW["block_size"], ENGINE_KW["chunk_tokens"],
                ENGINE_KW["batch"])
    P = ENGINE_KW["cache_len"] // bs
    pool = tt.init_block_pool(cfg, P + 1, bs, device=dev)
    pages = np.arange(1, P + 1, dtype=np.int32)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    off, n = 0, len(prompt)
    while off < n:
        c = min(n - off, C)
        b = min(x for x in buckets if x >= c)
        padded = np.zeros((1, b), np.int32)
        padded[0, :c] = prompt[off:off + c]
        lg, _ = tt.prefill_into_blocks(
            params, pool, T(padded), c, T(pages[:off // bs + -(-b // bs)]),
            cfg, block_size=bs)
        off += c
    table = np.zeros((B, P), np.int32)
    table[0] = pages
    active = np.zeros(B, bool)
    active[0] = True
    for j in range(i):
        toks, pos = np.zeros(B, np.int32), np.zeros(B, np.int32)
        toks[0], pos[0] = ids[j], n + j
        lg, _ = tt.decode_step_paged(params, pool, T(toks), T(pos),
                                     T(active), T(table), cfg,
                                     block_size=bs)
    top = lg[0].float().topk(2).values
    return (top[0] - top[1]).item()


def greedy_gate(pairs, dmax, margin, label, against,
                bitwise=False) -> list:
    """Every greedy request's ids against ``against``'s ids for the same
    prompt (``pairs``: (request, reference ids)). A divergence passes
    only where the two paths are not bitwise and ``margin(request, ids,
    i)``, the reference step's top-2 logit margin at the first differing
    token ``i``, is below ``dmax``, the paths' max |logit difference|;
    each one is printed with its margin. Returns the divergences."""
    out = []
    for req, want in pairs:
        got, want = list(req.tokens), list(want)
        if got == want:
            continue
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        m = margin(req, want, i)
        div = {"rid": req.rid, "token": i, "margin": m,
               "max_abs_dlogit": dmax}
        print(f"{label} greedy divergence: " + json.dumps(div))
        out.append(div)
        if bitwise or not m < dmax:
            fail(f"{label}: greedy request {req.rid} diverges from "
                 f"{against} at token {i} (margin {m} vs {dmax}, bitwise "
                 f"{bitwise})")
    return out


def spec_graph_check(torch, tt, sampling, cfg, target, dcfg, draft, dev):
    """The spec programs (``sampling.paged_spec_fns``) against their raw
    functions on the same inputs at the spec phase's shapes: propose,
    verify (greedy and sampled slots, per-slot valid rows, two inactive
    slots) and draft_verify (the replay rows), each captured at its first
    call and replayed with new inputs and after a page-table remap: ids,
    counts and every byte of both pools equal. Returns the graphs."""
    bs, B, W = ENGINE_KW["block_size"], 8, SPEC_K + 1
    P = 64
    nb = (B + 1) * P + 1
    spec = sampling.paged_spec_fns(cfg, dcfg, bs, SPEC_K)
    pools = {"g": random_pool(torch, tt, cfg, nb, bs, None, dev, 29),
             "dg": random_pool(torch, tt, dcfg, nb, bs, None, dev, 31)}
    pools["r"] = {n: t.clone() for n, t in pools["g"].items()}
    pools["dr"] = {n: t.clone() for n, t in pools["dg"].items()}
    rng = np.random.RandomState(47)
    blocks = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = blocks[:B * P].reshape(B, P).copy()
    table[6:] = 0

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pages_dev = T(table)
    active = np.asarray([True] * 6 + [False] * 2)
    forced = np.asarray([False, True] * 4) & active
    temp = np.asarray([0.0, 0.8] * 4, np.float32)
    topk = np.asarray([0, 50] * 4, np.int32)
    for what, seed in (("first", 51), ("new inputs", 52),
                       ("after a remap", 53)):
        if what == "after a remap":
            table[1] = blocks[B * P:(B + 1) * P]
            pages_dev.copy_(T(table))
        last = rng.randint(0, cfg.vocab, B).astype(np.int32)
        pos = np.concatenate([rng.randint(300, 950, 6), [5, 700]]
                             ).astype(np.int32)
        valid = np.asarray([5, 4, 5, 2, 5, 1, 5, 5], np.int32)
        props, _ = spec["propose"](draft, pools["dg"], last, pos, active,
                                   valid, pages_dev)
        props = props.clone()
        want, _ = spec["propose"].raw(draft, pools["dr"], T(last), T(pos),
                                      T(active), T(valid), pages_dev)
        window = np.concatenate([last[:, None], props.cpu().numpy()], 1)
        X, n, _ = spec["verify"](target, pools["g"], window, pos, valid,
                                 active, pages_dev, temp, topk,
                                 np.int32(seed))
        X, n = X.clone(), n.clone()
        wX, wn, _ = spec["verify"].raw(
            target, pools["r"], T(window), T(pos), T(valid), T(active),
            pages_dev, T(temp), T(topk),
            torch.tensor(seed, dtype=torch.int32, device=dev))
        spec["draft_verify"](draft, pools["dg"], window, pos, valid, forced,
                             pages_dev)
        spec["draft_verify"].raw(draft, pools["dr"], T(window), T(pos),
                                 T(valid), T(forced), pages_dev)
        ok = (torch.equal(props, want) and torch.equal(X, wX)
              and torch.equal(n, wn)
              and same_pool(torch, pools["g"], pools["r"])
              and same_pool(torch, pools["dg"], pools["dr"]))
        if not ok:
            fail(f"spec graphs ({what}): a replay differs from its raw "
                 f"step")
    graphs = {k: spec[k].graphs for k in ("propose", "verify",
                                          "draft_verify")}
    if graphs != {"propose": 1, "verify": 1, "draft_verify": 1}:
        fail(f"spec graphs: captured {graphs}")
    return graphs


def spec_preempt(SpecDecodeEngine, cfg, target, dcfg, draft, dev):
    """``preempt_run`` with spec-engine victims (``spec_preempt:`` line):
    on the replay resume ``draft_verify`` writes the forced windows into
    the draft pool, so its graph must have been captured."""
    kw = dict(ENGINE_KW, batch=2, num_blocks=8, spec_k=SPEC_K)
    doc = preempt_run(lambda: SpecDecodeEngine.from_params(
        target, cfg, draft, dcfg, device=dev, **kw), cfg.vocab,
        "spec_preempt")
    if doc["captures"]["draft_verify"] < 1:
        fail(f"spec_preempt: draft_verify never ran: {doc['captures']}")
    return doc


def spec_phase(torch, tt, tlm, kd, q8, build, kernels, sampling,
               PagedDecodeEngine, SpecDecodeEngine, cfg, dev, params):
    """The ``spec:`` line: speculative decoding at GPT-2 small widths, on
    the repo's draft-friendly pair (``draft_pair``), k = 4.

    1. window check: one verify window of 5 rows against 5 sequential raw
       decode steps from the same pool state, on bf16, int8 and int4
       target pools (max |logit difference|, whether logits and written
       pool rows are bitwise equal); and on the fp32 step-parity model
       within 1e-4, window against steps and card against the CPU;
    2. kernel 1 at the verify's 40 rows (5 a slot sharing its page-table
       row) within 1e-4 of its plain version, and ``fused_spec_verify``
       at [8, 5, 50257] exactly (ids and accepted counts), both timed;
    3. the engine trace's 16 requests cold and then the seed-1 trace
       warm through a target-only ``PagedDecodeEngine`` and through a
       ``SpecDecodeEngine``, both on the scaled target; the spec cold
       run's launch counts are the phase's main-path counts (every
       kernel of the path and ``fused_spec_verify`` > 0); captures:
       propose 1, verify 1, draft_prefill = the target-only prefill's,
       decode 0; then 4 requests through an unrelated 2-layer draft
       (seed 1): low acceptance, rejections and rewinds at full width;
    4. greedy gate (``greedy_gate``) for both spec runs;
    5. a remap and a replay preemption of spec victims (``spec_preempt``,
       its own line);
    6. the port's v5 artifact of the pair saved, loaded and served (4
       greedy requests equal to the in-process spec engine's);
    7. the spec programs' replays bitwise their raw steps
       (``spec_graph_check``);
    8. a third trace (seed 2) through the warm spec engine under the
       profiler (``spec_profile:`` line).
    Returns (the spec trace's launch counts, the ``fused_spec_verify``
    kernel row)."""
    t_phase = time.perf_counter()
    W = SPEC_K + 1
    target, dcfg, draft = draft_pair(torch, tt, cfg, params)
    doc = {"k": SPEC_K, "draft_layers": SPEC_DRAFT_LAYERS,
           "alpha": SPEC_ALPHA}
    # 1. window check
    windows = {}
    for kvd in (None, "int8", "int4"):
        windows[kvd or "bf16"] = window_numbers(torch, *window_check(
            torch, tt, cfg, target, dev, kvd, 64, 300, 950))
    c32 = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    runs = {d: window_check(torch, tt, c32, tt.init_params(
        c32, torch.Generator().manual_seed(5), d), d, None, 8, 40, 100)
        for d in ("cpu", dev)}
    w32 = window_numbers(torch, *runs[dev])
    vlg_c, pool_c = runs["cpu"][0], runs["cpu"][1]
    vlg_g, pool_g = runs[dev][0].cpu(), {n: t.cpu()
                                         for n, t in runs[dev][1].items()}
    w32["card_vs_cpu_logits"] = (vlg_g - vlg_c).abs().max().item()
    w32["card_vs_cpu_pool"] = max((pool_g[n] - pool_c[n]).abs().max().item()
                                  for n in pool_c)
    windows["fp32_step_parity"] = w32
    print("check spec window: verify window of 5 vs 5 sequential decode "
          "steps: " + json.dumps(windows))
    if not (w32["max_abs_dlogit"] <= 1e-4 and w32["card_vs_cpu_logits"]
            <= 1e-4 and w32["card_vs_cpu_pool"] <= 1e-4):
        fail(f"spec window (fp32): {w32} outside 1e-4")
    if not all(np.isfinite(w["max_abs_dlogit"]) for w in windows.values()):
        fail(f"spec window: non-finite logits {windows}")
    doc["window_check"] = windows
    dmax = windows["bf16"]["max_abs_dlogit"]
    bitwise = windows["bf16"]["logits_bitwise"]
    # 2. the kernels at the verify's shapes
    timer = Timer(torch)
    err1, t1 = check_decode(torch, timer, kd, q8, build, dev,
                            np.random.RandomState(43), 12, 1, 64, True,
                            window=W)
    err2, t2 = check_spec_verify(torch, timer, kd, sampling, build, dev)
    for name, err, tol, t in (
            ("flash_decode_attention (40 window rows)", err1, 1e-4, t1),
            ("fused_spec_verify", err2, 0.0, t2)):
        print(f"kernel {name}: max_abs_err={err!r} tol={tol!r} "
              + " ".join(f"{'kernel_ms' if k == 'ms' else k}={v!r}"
                         for k, v in t.items()))
        if not err <= tol:
            fail(f"{name} disagrees with its plain version: {err} > {tol}")
    doc["window_kernel"] = {"rows": 8 * W, "max_abs_err": err1, **t1}
    # 3. the engines, each timed from a fresh engine after a throwaway
    # one served a request (first-use costs stay out of the window)
    def make(draft_params=None):
        if draft_params is None:
            return PagedDecodeEngine.from_params(target, cfg, device=dev,
                                                 **ENGINE_KW)
        return SpecDecodeEngine.from_params(target, cfg, draft_params, dcfg,
                                            spec_k=SPEC_K, device=dev,
                                            **ENGINE_KW)

    reqs_in = trace(np.random.RandomState(0), cfg.vocab)
    warm_in = trace(np.random.RandomState(1), cfg.vocab)
    served = {}
    for kind, dp in (("target_only", None), ("spec", draft)):
        throwaway = make(dp)
        submit(throwaway, np.arange(40) % cfg.vocab, 4, 0.0)
        throwaway.run_until_idle()
        del throwaway
        eng = make(dp)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()             # counts of the main path only
        reqs, wall, captures, capture_s = serve_trace(torch, eng, reqs_in)
        launches = {**kernels.launch_counts(), **kernels.entry_counts()}
        health = eng.health()
        d = trace_doc(reqs, wall, captures, capture_s)
        d.update({"decode_steps": health["decode_steps"],
                  "decode_mfu": eng.decode_mfu(),
                  "max_memory_allocated_bytes":
                      torch.cuda.max_memory_allocated(),
                  "launches": {k: v for k, v in launches.items() if v}})
        if dp is not None:
            d["spec"] = health["spec"]
        wreqs, wwall, wcaptures, wcapture_s = serve_trace(torch, eng,
                                                          warm_in)
        d["warm"] = trace_doc(wreqs, wwall, wcaptures, wcapture_s)
        if dp is not None:
            d["warm"]["spec_lifetime"] = eng.health()["spec"]
        check_served(f"spec {kind}", reqs, reqs_in, cfg.vocab)
        check_served(f"spec {kind} warm", wreqs, warm_in, cfg.vocab)
        if not eng.pool.idle:
            fail(f"spec {kind}: blocks still held after the engine drained")
        served[kind] = (eng, reqs, wreqs, d, launches)
    doc["target_only"] = served["target_only"][3]
    doc["spec"] = served["spec"][3]
    t_eng, t_reqs, t_wreqs = served["target_only"][:3]
    s_eng, s_reqs, s_wreqs, _, launches = served["spec"]
    del t_eng
    captures = doc["spec"]["captures"]
    want = {"prefill": doc["target_only"]["captures"]["prefill"],
            "decode": 0, "draft_prefill":
                doc["target_only"]["captures"]["prefill"],
            "propose": 1, "verify": 1, "draft_verify": 0}
    if captures != want:
        fail(f"spec: captured {captures}, expected {want}")
    path = list(SERVING_KERNELS) + ["fused_sample.threefry",
                                    "fused_spec_verify"]
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        fail(f"spec: kernels never launched on the main path: {missing}")
    # 4. greedy gate, and an unrelated draft: rejections and rewinds
    pairs = ([(r, t.tokens) for r, t, (_, _, temp) in
              zip(s_reqs, t_reqs, reqs_in) if temp == 0]
             + [(r, t.tokens) for r, t, (_, _, temp) in
                zip(s_wreqs, t_wreqs, warm_in) if temp == 0])
    unrelated = tt.init_params(dcfg, torch.Generator().manual_seed(1), dev)
    u_eng = make(unrelated)
    u_in = reqs_in[:4]
    u_reqs, u_wall, _, _ = serve_trace(torch, u_eng, u_in)
    check_served("spec unrelated", u_reqs, u_in, cfg.vocab)
    doc["unrelated_draft"] = {"requests": len(u_reqs), "wall_s": u_wall,
                              "spec": u_eng.health()["spec"]}
    del u_eng, unrelated
    pairs += [(r, t.tokens) for r, t, (_, _, temp) in
              zip(u_reqs, t_reqs, u_in) if temp == 0]
    divergences = greedy_gate(
        pairs, dmax, lambda req, ids, i: target_margin(
            torch, tt, cfg, target, dev, s_eng.buckets, req.prompt, ids, i),
        "spec", "the target-only engine", bitwise)
    doc["greedy_gate"] = {"greedy_requests": len(pairs),
                          "divergences": divergences}
    print(f"check spec greedy: {len(pairs)} greedy requests (cold, warm, "
          f"unrelated draft) vs the target-only engine, "
          f"{len(divergences)} divergences, window bitwise {bitwise}")
    # 5. preemption
    doc["preempt"] = spec_preempt(SpecDecodeEngine, cfg, target, dcfg,
                                  draft, dev)
    # 6. the artifact
    greedy = [i for i, (_, _, temp) in enumerate(reqs_in) if temp == 0][:4]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tlm.save_lm_artifact(
            f"{tmp}/pair.tar", target, cfg, batch=ENGINE_KW["batch"],
            prompt_len=ENGINE_KW["chunk_tokens"],
            cache_len=ENGINE_KW["cache_len"], engine_buckets=s_eng.buckets,
            engine_paged=True, engine_block_size=ENGINE_KW["block_size"],
            engine_draft_params=draft, engine_draft_config=dcfg,
            engine_spec_k=SPEC_K)
        save_s = time.perf_counter() - t0
        srv = tlm.load_lm_artifact(f"{tmp}/pair.tar")
        a_eng = srv.engine(seed=0, device=dev)
        load_s = time.perf_counter() - t0 - save_s
    a_in = [reqs_in[i] for i in greedy]
    a_reqs, _, _, _ = serve_trace(torch, a_eng, a_in)
    a_equal = [a.tokens == s_reqs[i].tokens for a, i in zip(a_reqs, greedy)]
    doc["artifact"] = {"format_version": srv.meta["format_version"],
                       "engine": type(a_eng).__name__, "save_s": save_s,
                       "load_s": load_s, "ids_equal_in_process": a_equal}
    del a_eng, srv
    if not (all(a_equal) and doc["artifact"]["engine"] == "SpecDecodeEngine"
            and doc["artifact"]["format_version"] == 5):
        fail(f"spec artifact: {doc['artifact']}")
    # 7. replays against raw steps
    doc["graphs"] = spec_graph_check(torch, tt, sampling, cfg, target, dcfg,
                                     draft, dev)
    # 8. where a warm spec trace's time goes
    prof_in = trace(np.random.RandomState(2), cfg.vocab)

    def serve():
        for r in prof_in:
            submit(s_eng, *r)
        s_eng.run_until_idle()
        torch.cuda.synchronize()
    profile = profile_window(torch, serve)
    doc["phase_s"] = time.perf_counter() - t_phase
    print("spec: " + json.dumps(doc))
    print("spec_profile: " + json.dumps(profile))
    del s_eng
    row = (err2, {"rows": 8 * W}, t2)
    return launches, row


# ---------------------------------------------------------------------------
# slot engine and lockstep phase
# ---------------------------------------------------------------------------

SLOT_KW = dict(batch=8, cache_len=1024, buckets=(16, 32, 64, 128, 256, 512),
               seed=0)
LOCKSTEP_B, LOCKSTEP_TP, LOCKSTEP_NEW = 4, 128, 64
SLOT_FLASH_TIMED = (16, 512)            # row 5s: B = 1, the end buckets


def slot_trace(rng, vocab):
    """The engine trace with every prompt clipped to its first 512
    tokens (the slot engine's largest bucket): 32..512 tokens."""
    top = SLOT_KW["buckets"][-1]
    return [(p[:top], m, t) for p, m, t in trace(rng, vocab)]


def slot_flash(torch, ka, build, ragged) -> dict:
    """Kernel 5 at every shape the slot and lockstep paths give it (12
    heads, D = 64, bf16, causal): B = 1 at each slot bucket (16..512) and
    at the ``ragged`` prompt lengths that ``generate`` prefills at B = 1
    in the greedy gate; B = 4, T = 128 (``generate`` and
    ``LMServer.generate`` in ``lockstep:``) and B = 2, T = 128
    (``beam_search``). Each against its plain version within 2 bf16 ulps
    (lse 1e-4), two launches bitwise equal; timed at B = 1, T = 16 and
    512 against SDPA ``is_causal``, with its bound (row 5s)."""
    dev = torch.device("cuda:0")
    timer = Timer(torch)
    shapes = ([(1, T) for T in SLOT_KW["buckets"]]
              + [(1, T) for T in ragged]
              + [(LOCKSTEP_B, LOCKSTEP_TP), (2, LOCKSTEP_TP)])
    doc = {}
    for B, T in shapes:
        errs, ulps, rep, times = check_flash(
            torch, timer, ka, build, dev, B, T, 12, 12, 64, torch.bfloat16,
            True, B == 1 and T in SLOT_FLASH_TIMED)
        row = {"max_abs_err": errs["fwd"][0], "bf16_ulps": ulps["fwd"],
               "lse_err": errs["fwd"][1], "bitwise_repeat": rep}
        if times is not None:
            row.update(times["fwd"])
        doc[f"B={B},T={T}"] = row
        if not (ulps["fwd"] <= FLASH_BF16_ULPS
                and errs["fwd"][1] <= FLASH_LSE_TOL and rep):
            fail(f"flash_attention_fwd at the slot/lockstep B={B}, T={T}: "
                 f"{row}")
    print("kernel flash_attention_fwd (slot and lockstep paths, H=12, D=64, "
          "bf16, causal): " + json.dumps(doc))
    return doc


def slot_graph_check(torch, tt, sampling, cfg, params, dev) -> dict:
    """The slot engine's step programs (``sampling.engine_step_fns``)
    against their raw functions on a random arena at the engine's
    shapes: prefill at bucket 64 into slot 3 (sampled), the same bucket's
    graph replayed into slot 5 greedy and twice more sampled with two
    seeds (each replay must give the raw step's id for its own seed, and
    the two seeds must draw different ids), a prefill at bucket 512;
    decode at 8 rows (6 active, half sampled), replayed with a new seed.
    After each call the ids and every arena byte equal. Then
    ``decode_step_slots`` at 8 equal positions against ``decode_step``:
    logits and arena bitwise."""
    B, L = SLOT_KW["batch"], SLOT_KW["cache_len"]
    prefill, decode = sampling.engine_step_fns(cfg)
    gen = torch.Generator(device=dev).manual_seed(31)
    arena_g = tt.init_cache(cfg, B, L, device=dev)
    for t in arena_g.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    arena_r = {n: t.clone() for n, t in arena_g.items()}
    rng = np.random.RandomState(32)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def same():
        return all(torch.equal(arena_g[n].view(torch.int16),
                               arena_r[n].view(torch.int16)) for n in arena_g)

    calls, drawn = 0, {}
    for what, bucket, n, slot, temp, seed in (
            ("prefill", 64, 50, 3, 0.8, 41), ("prefill greedy", 64, 40, 5,
                                               0.0, 42),
            ("prefill seed a", 64, 50, 3, 5.0, 43),
            ("prefill seed b", 64, 50, 3, 5.0, 44),
            ("prefill 512", 512, 300, 6, 0.8, 45)):
        toks = np.zeros((1, bucket), np.int32)
        if what != "prefill seed b":
            prompt = rng.randint(0, cfg.vocab, n)
        toks[0, :n] = prompt
        ctl = (np.asarray([temp], np.float32), np.asarray([50], np.int32))
        got, _ = prefill(params, arena_g, toks, np.int32(n), np.int32(slot),
                         *ctl, np.int32(seed))
        got = got.clone()
        want, _ = prefill.raw(params, arena_r, T(toks), scalar(n),
                              scalar(slot), *map(T, ctl), scalar(seed))
        calls += 1
        if not (torch.equal(got, want) and same()):
            fail(f"slot graphs: {what}: replay {got.tolist()} vs raw "
                 f"{want.tolist()}, arenas equal {same()}")
        drawn[seed] = int(got[0])
    pos = np.concatenate([rng.randint(100, 1000, 6), [5, 1023]]).astype(
        np.int32)
    active = np.asarray([True] * 6 + [False] * 2)
    temp = np.asarray([0.0, 0.8] * 4, np.float32)
    topk = np.asarray([0, 50] * 4, np.int32)
    for what, seed in (("decode", 51), ("decode, new seed", 52)):
        toks = rng.randint(0, cfg.vocab, B).astype(np.int32)
        got, _ = decode(params, arena_g, toks, pos, active, temp, topk,
                        np.int32(seed))
        got = got.clone()
        want, _ = decode.raw(params, arena_r, T(toks), T(pos), T(active),
                             T(temp), T(topk), scalar(seed))
        calls += 1
        if not (torch.equal(got, want) and same()):
            fail(f"slot graphs: {what}: replay {got.tolist()} vs raw "
                 f"{want.tolist()}, arenas equal {same()}")
    if drawn[43] == drawn[44]:
        fail(f"slot graphs: seeds 43 and 44 drew the same id {drawn[43]}: "
             f"the replay may have frozen its seed")
    graphs = {"prefill": prefill.graphs, "decode": decode.graphs}
    if graphs != {"prefill": 2, "decode": 1}:
        fail(f"slot graphs: captured {graphs}")
    # the slot step at equal positions is the lockstep step, bitwise
    toks = T(rng.randint(0, cfg.vocab, B).astype(np.int32))
    c1 = {n: t.clone() for n, t in arena_r.items()}
    c2 = {n: t.clone() for n, t in arena_r.items()}
    l1, c1 = tt.decode_step(params, c1, toks, 700, cfg)
    l2, c2 = tt.decode_step_slots(params, c2, toks,
                                  torch.full((B,), 700, dtype=torch.int32,
                                             device=dev),
                                  torch.ones(B, dtype=torch.bool, device=dev),
                                  cfg)
    lock_bitwise = torch.equal(l1, l2) and all(
        torch.equal(c1[n].view(torch.int16), c2[n].view(torch.int16))
        for n in c1)
    if not lock_bitwise:
        fail("decode_step_slots at equal positions is not bitwise "
             "decode_step on the card")
    return {"graphs": graphs, "calls": calls,
            "two_seed_ids": [drawn[43], drawn[44]],
            "slots_vs_lockstep_bitwise": lock_bitwise}


def lockstep_margin(torch, tt, cfg, params, dev, prompt, ids, i):
    """The top-2 logit margin of the lockstep step that chose ``ids[i]``
    for ``prompt`` (``generate``'s arithmetic at B = 1 and its cache
    length), fed ``ids[:i]``."""
    lg, cache = tt.prefill(params, torch.from_numpy(prompt[None]).to(dev),
                           cfg, len(prompt) + len(ids))
    for j in range(i):
        lg, cache = tt.decode_step(
            params, cache, torch.tensor([ids[j]], dtype=torch.int32,
                                        device=dev), len(prompt) + j, cfg)
    top = lg[0].float().topk(2).values
    return (top[0] - top[1]).item()


def slot_dlogit(torch, tt, cfg, params, dev) -> float:
    """Max |logit difference| between the slot path (the prompt padded to
    its bucket in row 3 of an 8-row arena of 1024, then decode steps at 8
    rows, only row 3 active) and the lockstep path at B = 1
    (``generate``'s), over the 16 greedy steps of one 300-token prompt:
    what cuBLAS at other row counts, kernel 5 at the padded length and
    the arena's length move. The greedy gate's near-tie bound."""
    prompt = np.random.RandomState(33).randint(0, cfg.vocab, 300)
    steps = 16
    arena = tt.init_cache(cfg, 8, SLOT_KW["cache_len"], device=dev)
    padded = np.zeros((1, 512), np.int32)
    padded[0, :300] = prompt
    slot_lg, arena = tt.prefill_into_slot(
        params, arena, torch.from_numpy(padded).to(dev),
        torch.tensor(300, dtype=torch.int32, device=dev),
        torch.tensor(3, dtype=torch.int32, device=dev), cfg)
    lock_lg, cache = tt.prefill(params, torch.from_numpy(prompt[None]).to(
        dev), cfg, 300 + steps)
    dmax = (slot_lg[0] - lock_lg[0]).abs().max().item()
    active = torch.zeros(8, dtype=torch.bool, device=dev)
    active[3] = True
    for j in range(steps - 1):
        tok = int(lock_lg[0].argmax())
        toks = torch.zeros(8, dtype=torch.int32, device=dev)
        toks[3] = tok
        pos = torch.zeros(8, dtype=torch.int32, device=dev)
        pos[3] = 300 + j
        slot_lg, arena = tt.decode_step_slots(params, arena, toks, pos,
                                              active, cfg)
        lock_lg, cache = tt.decode_step(params, cache, toks[3:4], 300 + j,
                                        cfg)
        dmax = max(dmax, (slot_lg[3] - lock_lg[0]).abs().max().item())
    return dmax


def arena_attention_ms(torch, tt, cfg, dev) -> float:
    """Device time of one layer's arena attention at the slot engine's
    decode shape (8 rows over 1024 positions, 12 heads, Dh 64, bf16
    arena), as the decode graph runs it: captured into a CUDA graph of
    its own (so no host launch gap is timed) and replayed, CUDA events
    around the replay, median of ``REPEATS``, each after the L2-evicting
    write (a step's 12 layers read 25 MB of arena each)."""
    B, L = SLOT_KW["batch"], SLOT_KW["cache_len"]
    g = torch.Generator(device=dev).manual_seed(34)
    q = torch.randn(B, 12, 1, 64, generator=g, device=dev).to(cfg.dtype)
    kc, vc = (torch.randn(B, L, 12, 64, generator=g, device=dev)
              .to(cfg.dtype) for _ in range(2))
    attend = torch.arange(L, device=dev)[None, :] <= torch.randint(
        0, L, (B, 1), generator=g, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        tt.arena_attention(q, kc, vc, attend)       # warm-up
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tt.arena_attention(q, kc, vc, attend)
    return Timer(torch).ms(graph.replay)


def slots_phase(torch, tt, kernels, sampling, ka, build, DecodeEngine,
                PagedDecodeEngine, cfg, dev, params) -> dict:
    """The ``slots:`` line: the row-arena slot engine at GPT-2 small widths
    (batch 8, an arena of 1024 positions, buckets 16..512) on the engine
    trace clipped to 512-token prompts, cold in a fresh engine (every
    capture in its window) and then warm (seed 1); the paged engine's
    figures on the same two clipped traces beside it. Checks every
    request, each kernel of the path launched (kernel 5 in the slot
    prefills, kernel 2 on both streams), captures = buckets met + 1, and
    every greedy request against ``generate`` at B = 1 (divergences only
    at near-ties: ``greedy_gate``); prints kernel 5 at the shapes the
    slot and lockstep paths give it, the step programs' replays against their raw
    steps, the arena attention's share of a decode step and a profiled
    third trace (``slots_profile:``). Returns the cold run's launch
    counts."""
    from paddle_tpu_torch.core import ragged
    t_phase = time.perf_counter()
    warm_eng = DecodeEngine.from_params(params, cfg, device=dev, **SLOT_KW)
    warm = submit(warm_eng, np.arange(40) % cfg.vocab, 4, 0.0)
    warm_eng.run_until_idle()
    if len(warm.tokens) != 4:
        fail("slots: warm-up request did not finish")
    del warm_eng
    eng = DecodeEngine.from_params(params, cfg, device=dev, **SLOT_KW)
    reqs_in = slot_trace(np.random.RandomState(0), cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                 # counts of the main path only
    reqs, wall, captures, capture_s = serve_trace(torch, eng, reqs_in)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    health = eng.health()
    doc = trace_doc(reqs, wall, captures, capture_s)
    doc.pop("prefix_hit_tokens")
    step = eng.metrics.get("engine_decode_step_seconds").snapshot()
    doc.update({"decode_mfu": eng.decode_mfu(),
                "decode_steps": health["decode_steps"],
                "decode_step_ms_mean": 1e3 * step["avg"],
                "prefill_ms_mean": 1e3 * eng.metrics.get(
                    "engine_prefill_seconds").snapshot()["avg"],
                "max_memory_allocated_bytes": peak,
                "arena_bytes": sum(t.numel() * t.element_size()
                                   for t in eng.cache.values()),
                "launches": {k: v for k, v in launches.items() if v}})
    check_served("slots", reqs, reqs_in, cfg.vocab)
    path = ("fused_sample", "fused_sample.threefry", "flash_attention_fwd")
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        fail(f"slots: kernels never launched on the main path: {missing}")
    met = {ragged.bucket_length(len(p), eng.buckets) for p, _, _ in reqs_in}
    if captures != {"prefill": len(met), "decode": 1}:
        fail(f"slots: captured {captures}, expected {len(met)} prefill "
             f"graphs (buckets met {sorted(met)}) + 1 decode")
    doc["buckets_met"] = sorted(met)
    warm_in = slot_trace(np.random.RandomState(1), cfg.vocab)
    wreqs, wwall, wcaptures, wcapture_s = serve_trace(torch, eng, warm_in)
    step_w = eng.metrics.get("engine_decode_step_seconds").snapshot()
    check_served("slots warm", wreqs, warm_in, cfg.vocab)
    wmet = {ragged.bucket_length(len(p), eng.buckets) for p, _, _ in warm_in}
    if wcaptures != {"prefill": len(wmet - met), "decode": 0}:
        fail(f"slots warm: captured {wcaptures}")
    doc["warm"] = trace_doc(wreqs, wwall, wcaptures, wcapture_s)
    doc["warm"].pop("prefix_hit_tokens")
    doc["warm"]["decode_step_ms_mean"] = 1e3 * (
        (step_w["sum"] - step["sum"]) / (step_w["count"] - step["count"]))
    # the paged engine on the same clipped traces
    p_eng = PagedDecodeEngine.from_params(params, cfg, device=dev,
                                          **ENGINE_KW)
    preqs, pwall, pcapt, pcap_s = serve_trace(torch, p_eng, reqs_in)
    pwreqs, pwwall, pwcapt, pwcap_s = serve_trace(torch, p_eng, warm_in)
    doc["paged"] = {**trace_doc(preqs, pwall, pcapt, pcap_s),
                    "decode_mfu": p_eng.decode_mfu(),
                    "warm": trace_doc(pwreqs, pwwall, pwcapt, pwcap_s)}
    del p_eng
    # the greedy gate against generate at B = 1
    dmax = slot_dlogit(torch, tt, cfg, params, dev)
    pairs = [(req, tt.generate(params, torch.from_numpy(p[None]).to(dev),
                               cfg, max_new=m)[0, len(p):].tolist())
             for req, (p, m, t) in zip(reqs + wreqs, reqs_in + warm_in)
             if t == 0]
    divs = greedy_gate(
        pairs, dmax, lambda req, ids, i: lockstep_margin(
            torch, tt, cfg, params, dev, req.prompt, ids, i),
        "slots", "generate")
    n_greedy = len(pairs)
    doc["greedy_gate"] = {"requests": int(n_greedy),
                          "divergences": len(divs),
                          "max_abs_dlogit_slot_vs_lockstep": dmax}
    print(f"check slots greedy: {n_greedy} greedy requests against "
          f"generate at B=1, {len(divs)} divergences (each at a near-tie), "
          f"max |dlogit| slot vs lockstep {dmax!r}")
    # kernel 5 at every shape this phase and ``lockstep:`` launch it at;
    # 300 is ``slot_dlogit``'s prompt
    ragged = sorted({len(p) for p, _, t in reqs_in + warm_in if t == 0}
                    | {300})
    doc["flash_slot_prefill"] = slot_flash(torch, ka, build, ragged)
    doc["graphs"] = slot_graph_check(torch, tt, sampling, cfg, params, dev)
    # where a warm decode step's time goes: the arena attention alone,
    # 12 layers of it, against the warm trace's mean step (replay, ids
    # copy and host work included)
    attn_ms = arena_attention_ms(torch, tt, cfg, dev)
    doc["arena_attention_ms_per_layer"] = attn_ms
    doc["arena_attention_share_of_warm_step"] = (
        cfg.n_layers * attn_ms / doc["warm"]["decode_step_ms_mean"])
    prof_in = slot_trace(np.random.RandomState(2), cfg.vocab)

    def serve():
        for r in prof_in:
            submit(eng, *r)
        eng.run_until_idle()
        torch.cuda.synchronize()
    profile = profile_window(torch, serve)
    # whether the arena attention leads a warm step (ROADMAP B's test)
    profile["arena_attention_share_of_warm_step"] = \
        doc["arena_attention_share_of_warm_step"]
    doc["phase_s"] = time.perf_counter() - t_phase
    print("slots: " + json.dumps(doc))
    print("slots_profile: " + json.dumps(profile))
    del eng
    return launches


def lockstep_phase(torch, tt, tlm, prng, DecodeEngine, cfg, dev, params):
    """The ``lockstep:`` line: ``generate`` at B = 4, 128-token prompts,
    64 new tokens, greedy and sampled (temperature 0.8, key 0), each
    timed after a warm-up call, twice greedy (bitwise the same ids);
    ``beam_search`` at B = 2, K = 4, 16 new tokens (scores finite, best
    first); then the port's v1 and v3 artifacts of the same weights
    (batch 4, prompt length 128, 192 positions, v3's buckets 64 and
    128), saved and loaded: ``LMServer.generate`` gives ``generate``'s
    greedy ids, and the v3 engine serves the four prompts with the ids
    of an in-process slot engine of the same geometry."""
    t_phase = time.perf_counter()
    B, Tp, new = LOCKSTEP_B, LOCKSTEP_TP, LOCKSTEP_NEW
    prompt = np.random.RandomState(35).randint(0, cfg.vocab, (B, Tp)).astype(
        np.int32)
    pt = torch.from_numpy(prompt).to(dev)
    doc = {}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    greedy, g_s = timed(lambda: tt.generate(params, pt, cfg, max_new=new))
    sampled, s_s = timed(lambda: tt.generate(
        params, pt, cfg, max_new=new, temperature=0.8,
        key=prng.prng_key(0)))
    again = tt.generate(params, pt, cfg, max_new=new)
    for name, ids in (("greedy", greedy), ("sampled", sampled)):
        if (ids.shape != (B, Tp + new) or not torch.equal(ids[:, :Tp], pt)
                or ids.min() < 0 or ids.max() >= cfg.vocab):
            fail(f"lockstep generate ({name}): shape {tuple(ids.shape)}, "
                 f"ids in [{ids.min()}, {ids.max()}]")
    if not torch.equal(greedy, again) or torch.equal(greedy, sampled):
        fail("lockstep generate: greedy not repeatable, or sampling gave "
             "the greedy ids")
    doc["generate"] = {"batch": B, "prompt_len": Tp, "max_new": new,
                       "greedy_s": g_s, "greedy_tokens_per_s": B * new / g_s,
                       "sampled_s": s_s,
                       "sampled_tokens_per_s": B * new / s_s}
    (toks, scores), b_s = timed(lambda: tt.beam_search(
        params, pt[:2], cfg, max_new=16, beam_size=4))
    sc = scores.float()
    if (toks.shape != (2, 4, Tp + 16) or not torch.isfinite(sc).all()
            or (sc[:, 1:] > sc[:, :-1]).any()):
        fail(f"beam_search: shape {tuple(toks.shape)}, scores "
             f"{sc.tolist()}")
    doc["beam_search"] = {"batch": 2, "beam": 4, "max_new": 16, "s": b_s,
                          "scores": sc.tolist()}
    art = {}
    kw = dict(batch=B, prompt_len=Tp, cache_len=Tp + new)
    with tempfile.TemporaryDirectory() as tmp:
        for version, extra in (("v1", {}),
                               ("v3", {"engine_buckets": (64, 128)})):
            t0 = time.perf_counter()
            tlm.save_lm_artifact(f"{tmp}/{version}.tar", params, cfg, **kw,
                                 **extra)
            save_s = time.perf_counter() - t0
            srv = tlm.load_lm_artifact(f"{tmp}/{version}.tar")
            load_s = time.perf_counter() - t0 - save_s
            ids = srv.generate(prompt, new, device=dev)
            row = {"format_version": srv.meta["format_version"],
                   "save_s": save_s, "load_s": load_s,
                   "generate_ids_equal": bool(np.array_equal(
                       ids, greedy.cpu().numpy()))}
            if version == "v3":
                a_eng = srv.engine(seed=0, device=dev)
                ref = DecodeEngine.from_params(
                    params, cfg, batch=B, cache_len=Tp + new,
                    buckets=(64, 128), seed=0, device=dev)
                got = [submit(a_eng, p, new, 0.0) for p in prompt]
                want = [submit(ref, p, new, 0.0) for p in prompt]
                a_eng.run_until_idle()
                ref.run_until_idle()
                row["engine"] = type(a_eng).__name__
                row["engine_ids_equal"] = [a.tokens == b.tokens
                                           for a, b in zip(got, want)]
                del a_eng, ref
            art[version] = row
            del srv
    doc["artifacts"] = art
    doc["phase_s"] = time.perf_counter() - t_phase
    print("lockstep: " + json.dumps(doc))
    if not (art["v1"]["generate_ids_equal"] and art["v3"]["generate_ids_equal"]
            and art["v1"]["format_version"] == 1
            and art["v3"]["format_version"] == 3
            and art["v3"]["engine"] == "DecodeEngine"
            and all(art["v3"]["engine_ids_equal"])):
        fail(f"lockstep artifacts: {art}")


# ---------------------------------------------------------------------------
# the fleet's data plane
# ---------------------------------------------------------------------------

FLEET_TCP_REQUESTS = 4          # greedy requests of the trace sent over TCP


def timed_calls(obj, name, acc: list):
    """Wrap ``obj.name`` so each call appends its wall seconds to
    ``acc``."""
    orig = getattr(obj, name)

    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kw)
        finally:
            acc.append(time.perf_counter() - t0)
    setattr(obj, name, call)


def drive_router(router, reps, deadline_s=300.0) -> dict:
    """``router.step()`` until idle, timing every step and every engine
    step inside it (each handle's ``pump``): the host ms a router step
    adds around its replicas' engine steps."""
    pumps: list = []
    for rep in reps:
        timed_calls(rep, "pump", pumps)
    steps, engine, done = [], [], []
    t_end = time.perf_counter() + deadline_s
    while not router.idle:
        if time.perf_counter() > t_end:
            fail(f"fleet: router did not drain in {deadline_s} s "
                 f"(states {router.replica_states()})")
        n = len(pumps)
        t0 = time.perf_counter()
        done += router.step()
        steps.append(time.perf_counter() - t0)
        engine.append(sum(pumps[n:]))
    over = [s - e for s, e in zip(steps, engine)]
    return {"router_steps": len(steps),
            "router_step_ms_p50": 1e3 * float(np.median(steps)),
            "engine_steps_ms_p50": 1e3 * float(np.median(engine)),
            "router_overhead_ms_p50": 1e3 * float(np.median(over)),
            "finished": len(done)}


def fleet_check(label, reqs, reqs_in, single, vocab) -> list:
    """Every request finished with its ``max_new`` ids in the vocabulary;
    returns the greedy requests whose ids differ from the single engine
    run's (``single``, by trace index)."""
    bad = []
    for i, (r, (_, max_new, temp)) in enumerate(zip(reqs, reqs_in)):
        ids = np.asarray(r.tokens)
        if (r.status != "done" or len(ids) != max_new or ids.min() < 0
                or ids.max() >= vocab):
            fail(f"fleet {label}: request {i}: status {r.status}, "
                 f"{len(ids)} of {max_new} tokens")
        if temp == 0.0 and list(r.tokens) != single[i]:
            bad.append(i)
    return bad


def fleet_phase(torch, kernels, tlm, PagedDecodeEngine, cfg, dev, params,
                single):
    """The ``fleet:`` line: the port's fleet data plane over engines of
    the engine phase's configuration, all sharing the one weight dict on
    the card (one pool each), serving the engine phase's trace (seed 0):

    1. colocated: two ``EngineReplica``s behind a ``Router`` — tokens/s,
       TTFT, placement hit rate, where the shared-prefix pair landed,
       the median router step beside the engine steps inside it; every
       greedy request's ids equal the single engine's (``single``);
    2. P/D: a prefill replica and a decode replica (``prefill=["pf"]``):
       greedy ids equal, the decode engine imported and hit blocks, the
       router counted exports; host ms per block exported and imported;
    3. kill and requeue: ``EngineReplica.kill()`` on the replica holding
       the most work after 4 router steps; every request completes,
       greedy ids equal, requeues counted, the router's ``/healthz``
       names the dead replica;
    4. TCP: a ``ReplicaServer`` on 127.0.0.1 steps a third engine on its
       serve thread (its CUDA graphs captured and replayed there) behind
       a ``SocketReplica`` whose ``health_url`` is that engine's
       ``serve()``: greedy requests over the wire give the single
       engine's ids; the router's ``serve()`` answers ``/metrics``,
       ``/healthz``, ``/requests`` and ``/alerts``;
    5. ``LMServer.serve``: a v4 artifact of the port saved, loaded and
       served answers ``/healthz`` and ``/metrics``.

    Returns the kernels' launch counts over gates 1–4 and gate 1's
    figures."""
    import threading
    from paddle_tpu_torch.serving import (EngineReplica, ReplicaServer,
                                          Router, SocketReplica)
    from paddle_tpu_torch.serving.router import fleet_keying
    t_phase = time.perf_counter()
    reqs_in = trace(np.random.RandomState(0), cfg.vocab)
    greedy = [i for i, (_, _, temp) in enumerate(reqs_in) if temp == 0.0]
    bs, chunk = ENGINE_KW["block_size"], ENGINE_KW["chunk_tokens"]

    def make():
        return PagedDecodeEngine.from_params(params, cfg, device=dev,
                                             **ENGINE_KW)
    doc = {"replica_config": dict(ENGINE_KW)}
    kernels.reset_launches()                # counts of the fleet path
    # 1. colocated
    reps = [EngineReplica(make(), f"r{i}") for i in range(2)]
    router = Router(reps, block_size=bs, chunk_tokens=chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(router, *r) for r in reqs_in]
    steps = drive_router(router, reps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    colo = served_doc(reqs, wall)
    colo.update(steps)
    colo.update({"placement_hit_rate": router.placement_hit_rate(),
                 "shared_prefix_replicas": [reqs[0].replica,
                                            reqs[1].replica],
                 "prefix_scores": [r.prefix_score for r in reqs],
                 "per_replica": {st.name: sum(1 for r in reqs
                                              if r.replica == st.name)
                                 for st in router._all},
                 "captures": {rep.name: sum(rep.eng.compile_counts()
                                            .values()) for rep in reps}})
    colo["greedy_mismatch"] = fleet_check("colocated", reqs, reqs_in,
                                          single, cfg.vocab)
    colocated = {i: list(r.tokens) for i, r in enumerate(reqs)}
    doc["colocated"] = colo
    router.close()
    del reps, router
    # 2. P/D disaggregation
    pf, dc = EngineReplica(make(), "pf"), EngineReplica(make(), "dc")
    exp_s, imp_s = [], []
    timed_calls(pf.eng, "export_prefix", exp_s)
    timed_calls(dc.eng, "import_prefix", imp_s)
    router = Router([pf, dc], block_size=bs, chunk_tokens=chunk,
                    prefill=["pf"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(router, *r) for r in reqs_in]
    steps = drive_router(router, [pf, dc])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pd = served_doc(reqs, wall)
    pd.update(steps)
    exported = pf.eng.metrics.get("engine_kv_blocks_exported_total").value()
    imported = dc.eng.metrics.get("engine_kv_blocks_imported_total").value()
    hit = dc.eng.metrics.get("engine_prefix_cache_hit_blocks_total").value()
    pd.update({"pd_exports": router._m_pd_exports.value(),
               "pd_blocks_shipped": router._m_pd_blocks.value(),
               "pd_errors": sum(c.value for c in
                                router._m_pd_errors.series().values()),
               "exported_blocks": exported, "imported_blocks": imported,
               "decode_hit_blocks": hit,
               "export_ms_per_block": 1e3 * sum(exp_s) / max(exported, 1),
               "import_ms_per_block": 1e3 * sum(imp_s) / max(imported, 1),
               "via_prefill": sum(1 for r in reqs
                                  if r.prefill_replica == "pf")})
    pd["greedy_mismatch_vs_colocated"] = [
        i for i in greedy if list(reqs[i].tokens) != colocated[i]]
    fleet_check("pd", reqs, reqs_in, single, cfg.vocab)
    doc["pd"] = pd
    router.close()
    del pf, dc, router
    # 3. kill and requeue
    reps = [EngineReplica(make(), f"k{i}") for i in range(2)]
    router = Router(reps, block_size=bs, chunk_tokens=chunk)
    reqs = [submit(router, *r) for r in reqs_in]
    for _ in range(4):
        router.step()
    victim = max(router._all, key=lambda st: st.in_flight)
    held = victim.in_flight
    victim.handle.kill()
    drive_router(router, reps)
    srv = router.serve()
    try:
        code, body = http_get(srv.url + "/healthz")
    finally:
        srv.close()
    health = json.loads(body)
    kill = {"victim": victim.name, "in_flight_at_kill": held,
            "requeued": router._m_requeued.value(),
            "requeued_requests": sum(1 for r in reqs if r.requeues),
            "states": router.replica_states(),
            "healthz": {"http": code, "status": health.get("status"),
                        "victim_state": health["replicas"][victim.name]
                        ["state"]},
            "alerts_firing": [a["rule"] for a in router.alerts.firing()]}
    kill["greedy_mismatch"] = fleet_check("kill", reqs, reqs_in, single,
                                          cfg.vocab)
    doc["kill"] = kill
    router.close()
    del reps, router
    # 4. TCP
    eng = make()
    health_srv = eng.serve()
    server = ReplicaServer(eng, host="127.0.0.1", port=0)
    rc = []
    serve_thread = threading.Thread(
        target=lambda: rc.append(server.serve_forever()), daemon=True,
        name="fleet-replica-serve")
    serve_thread.start()
    sock = SocketReplica("tcp0", ("127.0.0.1", server.port),
                         health_url=health_srv.url)
    try:
        keying = fleet_keying([sock])
        router = Router([sock], block_size=keying[0], chunk_tokens=keying[1])
        picked = greedy[:FLEET_TCP_REQUESTS]
        t0 = time.perf_counter()
        reqs = [submit(router, *reqs_in[i]) for i in picked]
        t_end = time.perf_counter() + 300
        while not router.idle:
            if time.perf_counter() > t_end:
                fail(f"fleet tcp: no drain in 300 s ({router.health()})")
            router.step()
            time.sleep(0.001)
        wall = time.perf_counter() - t0
        router._scrape()                # the aggregator's last round
        srv = router.serve()
        codes, bodies = {}, {}
        try:
            for route in ("/metrics", "/healthz", "/requests", "/alerts"):
                codes[route], bodies[route] = http_get(srv.url + route)
        finally:
            srv.close()
        tcp = served_doc(reqs, wall)
        tcp.update({"keying": list(keying), "http": codes,
                    "ids_equal": [list(r.tokens) == single[i]
                                  for r, i in zip(reqs, picked)],
                    "fleet_series": "fleet_engine_requests_total"
                    in bodies["/metrics"].decode(),
                    "alerts_rules": len(json.loads(bodies["/alerts"])
                                        ["rules"]),
                    "serve_thread_captures": sum(
                        eng.compile_counts().values())})
        router.close()
    finally:
        server.drain()
        serve_thread.join(timeout=120)
        sock.close()
        health_srv.close()
    tcp["serve_forever_rc"] = rc
    doc["tcp"] = tcp
    launches = kernels.launch_counts()
    del eng, server
    # 5. LMServer.serve
    with tempfile.TemporaryDirectory() as tmp:
        tlm.save_lm_artifact(
            f"{tmp}/v4.tar", params, cfg, batch=ENGINE_KW["batch"],
            prompt_len=chunk, cache_len=ENGINE_KW["cache_len"],
            engine_buckets=(chunk,), engine_paged=True,
            engine_block_size=bs)
        lm = tlm.load_lm_artifact(f"{tmp}/v4.tar")
    hs = lm.serve()
    try:
        h_code, h_body = http_get(hs.url + "/healthz")
        m_code, m_body = http_get(hs.url + "/metrics")
    finally:
        hs.close()
    lm_health = json.loads(h_body)
    doc["lm_server"] = {"format_version": lm.meta["format_version"],
                        "http": {"/healthz": h_code, "/metrics": m_code},
                        "healthz": lm_health,
                        "metrics_lines": len(m_body.splitlines())}
    doc["launches"] = launches
    doc["phase_s"] = time.perf_counter() - t_phase
    print("fleet: " + json.dumps(doc))
    problems = []
    if colo["greedy_mismatch"] or colo["finished"] != len(reqs_in):
        problems.append("colocated greedy ids or completions")
    if (pd["greedy_mismatch_vs_colocated"] or pd["pd_exports"] < 1
            or imported <= 0 or hit <= 0 or pd["pd_errors"]):
        problems.append("P/D adoption or ids")
    if (kill["greedy_mismatch"] or kill["requeued"] <= 0
            or kill["states"][victim.name] != "dead"
            or kill["healthz"]["victim_state"] != "dead"
            or kill["healthz"]["http"] != 200):
        problems.append("kill and requeue")
    if (not all(tcp["ids_equal"]) or rc != [0]
            or any(c != 200 for c in codes.values())
            or not tcp["fleet_series"]):
        problems.append("TCP transport or router endpoints")
    if (h_code, m_code) != (200, 200) or lm_health.get("batch") != \
            ENGINE_KW["batch"] or lm.meta["format_version"] != 4:
        problems.append("LMServer.serve")
    path = [k for k in SERVING_KERNELS] + ["fused_sample.threefry"]
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        problems.append(f"kernels never launched: {missing}")
    if problems:
        fail(f"fleet: {problems}")
    return launches, colo


# ---------------------------------------------------------------------------
# the fleet's control plane and its replica processes
# ---------------------------------------------------------------------------

AUTOSCALE_CLI_REQUESTS = 4      # greedy requests fed to the route CLI


def controlled(router, ctrl, label, done, deadline_s=600.0):
    """``router.step()`` and ``ctrl.step()`` in turns until ``done()``;
    fails past the deadline."""
    t_end = time.perf_counter() + deadline_s
    while not done():
        if time.perf_counter() > t_end:
            fail(f"autoscale {label}: no end in {deadline_s} s "
                 f"(states {router.replica_states()})")
        router.step()
        ctrl.step()


def recorded(flight, since: int) -> list:
    """The controller's decisions the flight recorder holds past its
    first ``since`` records, without their wall times."""
    return [{k: v for k, v in rec.items() if k != "t"}
            for rec in flight.default_flight_recorder().records()[since:]
            if rec.get("actor") == "fleet_controller"]


def fleet_lost(reqs) -> int:
    return sum(1 for r in reqs if r.status != "done")


def recordio_check() -> dict:
    """The native record codec: built from the checkout's copy, loaded,
    and writing (and reading) a file byte for byte as the pure-Python
    path does."""
    from paddle_tpu_torch.runtime import native, recordio
    lib = native.get()
    if lib is None:
        fail("autoscale: the native recordio codec did not build or load")
    recs = [{"i": i, "x": list(range(i % 7))} for i in range(500)]
    with tempfile.TemporaryDirectory() as tmp:
        recordio.write_records(f"{tmp}/n.rio", recs, chunk_records=64)
        native._lib = None                  # the pure-Python path
        try:
            recordio.write_records(f"{tmp}/p.rio", recs, chunk_records=64)
            py_read = list(recordio.read_records(f"{tmp}/n.rio"))
            py_offsets = recordio.chunk_offsets(f"{tmp}/n.rio")
        finally:
            native._lib = lib
        a, b = (Path(f"{tmp}/{n}.rio").read_bytes() for n in ("n", "p"))
        doc = {"loaded": str(native.lib_path()), "bytes": len(a),
               "byte_equal": a == b,
               "native_read_equal": list(recordio.read_records(
                   f"{tmp}/p.rio")) == recs,
               "python_read_equal": py_read == recs,
               "offsets_equal": recordio.chunk_offsets(f"{tmp}/p.rio")
               == py_offsets}
    return doc


def cli_route_gate(model, reqs_in, single, picked) -> dict:
    """``python -m paddle_tpu_torch route --model=... --replicas=2
    --autoscale --health_port=0`` as a process: ``picked`` greedy
    requests of the trace on its stdin carry back the single engine's
    ids, one ``top`` frame renders the fleet, and SIGTERM drains it to
    exit 0."""
    import queue as _queue
    import signal
    import threading
    root = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "route",
         f"--model={model}", "--replicas=2", "--autoscale",
         "--health_port=0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=root)
    err_lines, out_q = _queue.Queue(), _queue.Queue()
    threading.Thread(target=lambda: [err_lines.put(x) for x in proc.stderr],
                     daemon=True).start()
    threading.Thread(target=lambda: [out_q.put(x) for x in proc.stdout],
                     daemon=True).start()
    doc = {}
    try:
        url, t_end = None, time.perf_counter() + 600
        while url is None:
            try:
                line = err_lines.get(timeout=1.0)
            except _queue.Empty:
                if proc.poll() is not None or time.perf_counter() > t_end:
                    fail(f"autoscale cli: route never announced its "
                         f"endpoint (rc {proc.poll()})")
                continue
            m = re.search(r"(http://[\d.:]+)/metrics", line)
            url = m and m.group(1)
        doc["route_ready_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        for i in picked:
            prompt, max_new, _ = reqs_in[i]
            proc.stdin.write(json.dumps({"prompt": prompt.tolist(),
                                         "max_new": max_new}) + "\n")
        proc.stdin.flush()
        results = []
        while len(results) < len(picked):
            try:
                results.append(json.loads(out_q.get(timeout=600)))
            except _queue.Empty:
                fail(f"autoscale cli: {len(results)} of {len(picked)} "
                     f"results")
        doc["requests_s"] = time.perf_counter() - t1
        by_id = {r["id"]: r for r in results}
        doc["ids_equal"] = [by_id.get(n, {}).get("tokens") == single[i]
                            for n, i in enumerate(picked)]
        doc["replicas_used"] = sorted({r.get("replica") for r in results})
        top = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "top",
             f"--url={url}", "--top_iterations=1"],
            capture_output=True, text=True, timeout=120, cwd=root)
        frame = top.stdout
        doc["top"] = {"rc": top.returncode,
                      "fleet_line": frame.splitlines()[0] if frame else "",
                      "replica_rows": sum(1 for ln in frame.splitlines()
                                          if ln.startswith("replica")),
                      "controller_line": "controller: live 2" in frame}
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        doc["sigterm_rc"] = proc.wait(timeout=300)
        doc["sigterm_exit_s"] = time.perf_counter() - t2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return doc


def autoscale_phase(torch, kernels, tlm, PagedDecodeEngine, cfg, dev, params,
                    single, colocated, t_script):
    """The ``autoscale:`` line: the fleet's control plane over engines of
    the engine phase's configuration serving its trace (seed 0), in
    three gates, every greedy id held to the single engine's
    (``single``):

    1. in process: an ``InProcessFleet`` of engines on the card (one
       shared weight dict, one pool each), a ``Router`` and a
       ``FleetController``:
       - heal: the router (in-flight cap 1 and always-fetch, so the
         trace's shared-prefix pair lands on both replicas) loses the
         prefix's home (``EngineReplica.kill()``) mid-trace; the controller
         respawns it under its name after its backoff (0.05-0.1 s) and
         re-warms it from the survivor over the PTKV wire: ``heal_s`` from the
         death the router sees to the replacement registered,
         ``rewarm_blocks`` and host ms per block exported and imported,
         ``requeued``, ``lost`` (0);
       - scale up: one replica, ``scale_up_queue=1`` held over a 0.25 s
         hysteresis, ``max_replicas=2``: the second spawns; seconds
         from the spawn to its first token;
       - scale down: the idle fleet drains its newest replica down to
         ``min_replicas=1``; seconds from the controller's
         ``scale_down`` decision to its ``drained`` one (the replica
         removed), from the flight recorder's stamps;
       the kernels' launch counts of this gate are the phase's (the
       other gates launch inside replica processes, where this process
       cannot count);
    2. process fleet: ``ServingFleet`` of two ``python -m
       paddle_tpu_torch serve`` replicas over a v4 artifact of the same
       weights, each its own process on the card, behind
       ``fleet.router()`` and a ``FleetController``: ``replica_ready_s``
       per process, the trace's tokens/s and TTFT beside the ``fleet:``
       colocated figure (``colocated``), then the trace again with one
       replica SIGKILLed after 4 router steps: seconds from SIGKILL to
       the replacement's ready line, ``requeued``, ``lost`` (0);
    3. CLI: ``route --model --replicas=2 --autoscale`` as a process
       (``cli_route_gate``).

    Also checks the native record codec (``recordio_check``). Returns
    gate 1's launch counts."""
    from paddle_tpu_torch.observe import flight
    from paddle_tpu_torch.runtime.master import ServingFleet
    from paddle_tpu_torch.serving import Router
    from paddle_tpu_torch.serving.autoscale import (FleetController,
                                                    InProcessFleet)
    from paddle_tpu_torch.serving.engine import default_chunk_buckets
    t_phase = time.perf_counter()
    engine_kw = ENGINE_KW
    reqs_in = trace(np.random.RandomState(0), cfg.vocab)
    greedy = [i for i, (_, _, temp) in enumerate(reqs_in) if temp == 0.0]
    bs, chunk = engine_kw["block_size"], engine_kw["chunk_tokens"]
    doc = {"recordio": recordio_check()}
    exp_s, imp_s, engines = [], [], []

    def make(name):
        eng = PagedDecodeEngine.from_params(params, cfg, device=dev,
                                            **engine_kw)
        timed_calls(eng, "export_prefix", exp_s)
        timed_calls(eng, "import_prefix", imp_s)
        engines.append(eng)
        return eng

    def blocks(what):
        """Blocks every engine of this gate has exported or imported."""
        return sum(e.metrics.get(f"engine_kv_blocks_{what}_total").value()
                   for e in engines)

    kernels.reset_launches()                # counts of gate 1
    # 1a. heal
    fleet = InProcessFleet(make)
    for name in ("a0", "a1"):
        fleet.spawn(name)
    router = Router([fleet.handle("a0"), fleet.handle("a1")],
                    block_size=bs, chunk_tokens=chunk, max_in_flight=1,
                    fetch_flops_per_byte=0.0)
    # a short backoff: the survivor must still hold the prefix warm
    # when the replacement asks for it
    ctrl = FleetController(router, fleet, scale_up_queue=0,
                           scale_down_idle_s=1e9, backoff_base=0.05,
                           backoff_cap=0.1)
    since = len(flight.default_flight_recorder().records())
    t_dead, t_healed, rewarmed = [], [], []
    orig_mark, orig_replace = router._mark_dead, router.replace_replica
    orig_rewarm = router._on_rewarm

    def mark_dead(st):
        t_dead.append(time.perf_counter())
        return orig_mark(st)

    def replace(name, handle):
        t_healed.append(time.perf_counter())
        return orig_replace(name, handle)

    def on_rewarm(src, ticket, doc):
        if doc.get("payload"):
            rewarmed.append(int(doc.get("blocks") or 0))
        return orig_rewarm(src, ticket, doc)
    router._mark_dead, router.replace_replica = mark_dead, replace
    router._on_rewarm = on_rewarm
    # the shared prefix's pair first: the first request on its home, the
    # second (the home at its cap, its fetch empty) on the other replica,
    # which holds the prefix too once it has prefilled it (its first
    # token); then the rest of the trace, and the home dies
    reqs = [submit(router, *r) for r in reqs_in[:2]]
    controlled(router, ctrl, "heal",
               lambda: reqs[1].replica not in (None, reqs[0].replica))
    other = fleet.handle(reqs[1].replica).eng
    controlled(router, ctrl, "heal",
               lambda: other.metrics.get("engine_tokens_total").value() > 0)
    reqs += [submit(router, *r) for r in reqs_in[2:]]
    victim = reqs[0].replica
    held = next(st.in_flight for st in router._all if st.name == victim)
    exp_s.clear()
    imp_s.clear()
    exported0, imported0 = blocks("exported"), blocks("imported")
    fleet.kill_name(victim)
    controlled(router, ctrl, "heal",
               lambda: router.idle and router.replica_states()[victim]
               == "ok" and not any(st.outstanding for st in router._all))
    # every PTKV hop after the death (the re-warm, and directory fetches
    # of the requeued shared-prefix request) prices the host's ms a block
    exported = blocks("exported") - exported0
    imported = blocks("imported") - imported0
    decisions = recorded(flight, since)
    heal = {"victim": victim, "in_flight_at_kill": held,
            "heal_s": t_healed[0] - t_dead[0] if t_dead and t_healed
            else None,
            "backoff_s": next((d.get("delay_s") for d in decisions
                               if d["action"] == "heal_scheduled"), None),
            "rewarm_exports": next((d.get("rewarm_exports")
                                    for d in decisions
                                    if d["action"] == "healed"), None),
            "rewarm_blocks": sum(rewarmed),
            "wire_exported_blocks": exported,
            "wire_imported_blocks": imported,
            "export_ms_per_block": 1e3 * sum(exp_s) / max(exported, 1),
            "import_ms_per_block": 1e3 * sum(imp_s) / max(imported, 1),
            "rewarm": {"/".join(v for _, v in k): c.value for k, c in
                       router._m_rewarm.series().items()},
            "requeued": router._m_requeued.value(),
            "lost": fleet_lost(reqs),
            "decisions": [d["action"] for d in decisions]}
    heal["greedy_mismatch"] = fleet_check("autoscale heal", reqs, reqs_in,
                                          single, cfg.vocab)
    doc["heal"] = heal
    router.close()
    del fleet, router, ctrl
    engines.clear()
    # 1b. scale up, then 1c. scale down
    spawns = []
    fleet = InProcessFleet(make)
    fleet.spawn("s0")
    spawn = fleet.spawn

    def timed_spawn(name=None):
        t0 = time.perf_counter()
        ep = spawn(name)
        spawns.append((ep["name"], t0, time.perf_counter()))
        return ep
    fleet.spawn = timed_spawn
    router = Router([fleet.handle("s0")], block_size=bs, chunk_tokens=chunk)
    ctrl = FleetController(router, fleet, min_replicas=1, max_replicas=2,
                           scale_up_queue=1, hysteresis_s=0.25,
                           scale_down_idle_s=1e9)
    since = len(flight.default_flight_recorder().records())
    t0 = time.perf_counter()
    reqs = [submit(router, *r) for r in reqs_in]
    controlled(router, ctrl, "scale up", lambda: router.idle)
    wall = time.perf_counter() - t0
    up = served_doc(reqs, wall)
    new = [n for n, _, _ in spawns]
    firsts = [r.placed_t + r.replica_ttft_ms / 1e3 for r in reqs
              if new and r.replica == new[0]]
    up.update({"spawned": new,
               "spawn_s": [b - a for _, a, b in spawns],
               "trigger_to_first_token_s": min(firsts) - spawns[0][1]
               if firsts else None,
               "requests_on_new": len(firsts),
               "replicas": sorted(router.replica_states()),
               "lost": fleet_lost(reqs)})
    up["greedy_mismatch"] = fleet_check("autoscale scale up", reqs, reqs_in,
                                        single, cfg.vocab)
    ctrl.scale_down_idle_s = 0.5
    controlled(router, ctrl, "scale down", lambda: len(router._all) == 1)
    stamps = {rec["action"]: rec["t"] for rec in
              flight.default_flight_recorder().records()[since:]
              if rec.get("actor") == "fleet_controller"}
    down = {"decision_to_removed_s": stamps["drained"] - stamps["scale_down"]
            if {"drained", "scale_down"} <= set(stamps) else None,
            "replicas": sorted(router.replica_states()),
            "summary": ctrl.summary()}
    decisions = recorded(flight, since)
    up["decisions"] = [d["action"] for d in decisions]
    down["drained"] = [d["replica"] for d in decisions
                       if d["action"] == "drained"]
    doc["scale_up"], doc["scale_down"] = up, down
    launches = kernels.launch_counts()
    router.close()
    del fleet, router, ctrl
    # 2. process fleet, and 3. the CLI, over a v4 artifact of the weights
    with tempfile.TemporaryDirectory() as tmp:
        # the artifact stamps the engines' chunk buckets: a replica
        # pads a tail chunk as the single engine does, so its GEMMs run
        # at the same shapes and its greedy ids are the same bits
        model = f"{tmp}/v4.tar"
        tlm.save_lm_artifact(
            model, params, cfg, batch=engine_kw["batch"], prompt_len=chunk,
            cache_len=engine_kw["cache_len"],
            engine_buckets=default_chunk_buckets(chunk), engine_paged=True,
            engine_block_size=bs)
        pf = ServingFleet(model, replicas=2, startup_timeout_s=600)
        launched, ready = {}, []
        launch, await_ready = pf._launch, pf._await_ready

        def timed_launch(name):
            launched[name] = time.perf_counter()
            return launch(name)

        def timed_ready(name, proc, deadline, close_fleet=False):
            ep = await_ready(name, proc, deadline, close_fleet)
            ready.append((name, time.perf_counter(),
                          time.perf_counter() - launched[name]))
            return ep
        pf._launch, pf._await_ready = timed_launch, timed_ready
        router = None
        try:
            pf.start()
            router = pf.router()
            ctrl = FleetController(router, pf, scale_up_queue=0,
                                   scale_down_idle_s=1e9)
            t0 = time.perf_counter()
            reqs = [submit(router, *r) for r in reqs_in]
            controlled(router, ctrl, "process fleet", lambda: router.idle)
            proc = served_doc(reqs, time.perf_counter() - t0)
            proc.update({"replica_ready_s": {n: s for n, _, s in ready},
                         "colocated_tokens_per_s":
                         colocated.get("tokens_per_s"),
                         "per_replica": {n: sum(1 for r in reqs
                                                if r.replica == n)
                                         for n in router.replica_states()},
                         "lost": fleet_lost(reqs)})
            proc["greedy_mismatch"] = fleet_check(
                "autoscale process fleet", reqs, reqs_in, single, cfg.vocab)
            requeued0 = router._m_requeued.value()
            reqs = [submit(router, *r) for r in reqs_in]
            for _ in range(4):
                router.step()
            i_victim = max(range(len(router._all)),
                           key=lambda i: router._all[i].in_flight)
            victim = router._all[i_victim].name
            held = router._all[i_victim].in_flight
            n_ready = len(ready)
            t_kill = time.perf_counter()
            pf.kill(i_victim)
            controlled(router, ctrl, "process kill",
                       lambda: router.idle and router.replica_states()
                       [victim] == "ok")
            respawned = ready[n_ready:]
            kill = {"victim": victim, "in_flight_at_kill": held,
                    "sigkill_to_ready_s": respawned[0][1] - t_kill
                    if respawned else None,
                    "replacement_ready_s": respawned[0][2]
                    if respawned else None,
                    "wall_s": time.perf_counter() - t_kill,
                    "requeued": router._m_requeued.value() - requeued0,
                    "heals": ctrl._m_heals.value(result="healed"),
                    "lost": fleet_lost(reqs),
                    "states": router.replica_states()}
            kill["greedy_mismatch"] = fleet_check(
                "autoscale process kill", reqs, reqs_in, single, cfg.vocab)
            proc["kill"] = kill
        finally:
            procs = list(pf.procs)
            if router is not None:
                router.close()
            pf.close()
        proc["stopped"] = all(p.poll() is not None for p in procs)
        doc["process_fleet"] = proc
        doc["cli"] = cli_route_gate(model, reqs_in, single,
                                    greedy[:AUTOSCALE_CLI_REQUESTS])
    doc["launches"] = launches
    doc["phase_s"] = time.perf_counter() - t_phase
    doc["script_s"] = time.perf_counter() - t_script
    print("autoscale: " + json.dumps(doc))
    problems = []
    rio = doc["recordio"]
    if not all(rio[k] for k in ("byte_equal", "native_read_equal",
                                "python_read_equal", "offsets_equal")):
        problems.append("native recordio codec")
    if (heal["greedy_mismatch"] or heal["lost"] or heal["heal_s"] is None
            or heal["requeued"] <= 0 or heal["rewarm_blocks"] <= 0
            or "healed" not in heal["decisions"]):
        problems.append("in-process heal")
    if (up["greedy_mismatch"] or up["lost"] or len(up["spawned"]) != 1
            or not up["requests_on_new"]
            or "scale_up" not in up["decisions"]):
        problems.append("in-process scale up")
    if down["replicas"] != ["s0"] or down["drained"] != up["spawned"]:
        problems.append("in-process scale down")
    if (proc["greedy_mismatch"] or proc["lost"] or kill["lost"]
            or kill["greedy_mismatch"] or kill["sigkill_to_ready_s"] is None
            or kill["heals"] != 1 or kill["requeued"] <= 0
            or set(kill["states"].values()) != {"ok"}
            or not proc["stopped"]):
        problems.append("process fleet")
    cli = doc["cli"]
    if (not all(cli["ids_equal"]) or cli["top"]["rc"] != 0
            or cli["top"]["replica_rows"] != 2
            or not cli["top"]["controller_line"] or cli["sigterm_rc"] != 0):
        problems.append("route / top / SIGTERM")
    if dev.type == "cuda":
        path = list(SERVING_KERNELS) + ["fused_sample.threefry"]
        missing = [k for k in path if launches[k] <= 0]
        if missing:
            problems.append(f"kernels never launched: {missing}")
    if problems:
        fail(f"autoscale: {problems}")
    return launches


# ---------------------------------------------------------------------------
# op layer phase (the v2 framework's ops)
# ---------------------------------------------------------------------------

# Card-vs-CPU tolerances of the ``ops:`` phase, fixed before its first run:
# max |card - CPU| over max |CPU|. fp32 paths sum in another order over
# recursions of up to 400 steps; bf16-compute paths (conv blocks, the
# recurrent scans) round operands to bf16 at every product, so a value
# that lands near a rounding boundary rounds the other way and the
# difference travels through the block or the scan. One bf16 rounding
# (a conv alone, the pools) is held to 2 bf16 ulps of max(|CPU|, 2^-6).
# A ResNet block's gradients are held op by op (each conv_bn_train on its
# own inputs), its forward as a whole: at ReLU's kink a rounding-level
# difference flips an element of the gradient mask, which no rounding
# tolerance covers.
OPS_F32_REL = 1e-4
OPS_BF16_REL = 2.0 ** -5
OPS_ULPS = 2
OPS_CALLS = 10


def ops_ms(torch, fn, n=OPS_CALLS) -> float:
    """Median ms per call of ``fn`` over ``n`` calls after a warm-up call,
    with CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def flat_tensors(out) -> list:
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in flat_tensors(o)]
    return [out]


def rel_err(torch, got, want) -> float:
    """max |got - want| / max |want| in float64 on the CPU (0 if equal)."""
    g, w = got.double(), want.double()
    if torch.equal(g, w):
        return 0.0
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def bf16_ulps(torch, got, want) -> float:
    """max |got - want| in bf16 ulps of max(|want|, 2^-6)."""
    g, w = got.double(), want.double()
    mag = w.abs().clamp_min(2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def run_on(torch, fn, arrays, device, wrt=()):
    """``fn(device, *tensors)`` on tensors made on ``device`` from
    ``arrays`` (numpy arrays; other values pass through). Returns (outputs,
    gradients) as CPU tensors: the gradients of sum(out_i * cot_i) over
    the outputs that carry one, for cotangents drawn from a seed, with
    respect to the arguments at ``wrt``."""
    ts = [torch.from_numpy(a).to(device).requires_grad_(i in wrt)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(arrays)]
    outs = flat_tensors(fn(device, *ts))
    grads = []
    if wrt:
        rng = np.random.RandomState(1)
        loss = sum((o.float() * torch.from_numpy(rng.randn(*o.shape).astype(
            np.float32)).to(device)).sum() for o in outs if o.requires_grad)
        grads = torch.autograd.grad(loss, [ts[i] for i in wrt])
    return ([o.detach().cpu() for o in outs],
            [g.detach().cpu() for g in grads])


def held(torch, label, fn, arrays, dev, wrt=(), rel=OPS_F32_REL, ulps=None):
    """Run ``fn`` on the CPU and on the card from the same arrays and fail
    unless every floating output and gradient is within ``rel`` (or
    ``ulps`` bf16 ulps) and every integer output is equal. Returns the
    largest error and the card's outputs."""
    cpu = run_on(torch, fn, arrays, "cpu", wrt)
    card = run_on(torch, fn, arrays, dev, wrt)
    worst = 0.0
    for i, (a, b) in enumerate(zip(card[0] + card[1], cpu[0] + cpu[1])):
        if not b.is_floating_point():
            if not torch.equal(a, b):
                fail(f"ops {label}: integer output {i} differs between the "
                     f"card and the CPU")
            continue
        if not torch.isfinite(a.float()).all():
            fail(f"ops {label}: non-finite values on the card (output {i})")
        err = (bf16_ulps(torch, a, b) if ulps is not None
               else rel_err(torch, a, b))
        if not err <= (ulps if ulps is not None else rel):
            fail(f"ops {label}: output {i} card vs CPU error {err!r} > "
                 f"{ulps if ulps is not None else rel!r}"
                 f"{' ulps' if ulps is not None else ' (relative)'}")
        worst = max(worst, err)
    return worst, card[0]


def _he(rng, *shape):
    fan_in = int(np.prod(shape[:-1]))
    return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)


# (ch_in, ch_mid, spatial size in, stride) of each stage's first block
RESNET_STAGES = ((64, 64, 56, 1), (256, 128, 56, 2), (512, 256, 28, 2),
                 (1024, 512, 14, 2))
RESNET_BATCH, RESNET_PARITY = 128, 8


def bottleneck_params(rng, cin, mid):
    """{name: [w, gamma, beta]} of a bottleneck block with its projection
    (ResNet-50 widths: out = 4 x mid)."""
    out = 4 * mid
    shapes = {"a": (1, 1, cin, mid), "b": (3, 3, mid, mid),
              "c": (1, 1, mid, out), "proj": (1, 1, cin, out)}
    return {n: [_he(rng, *s), (1.0 + 0.1 * rng.randn(s[-1])).astype(
        np.float32), (0.1 * rng.randn(s[-1])).astype(np.float32)]
        for n, s in shapes.items()}


def bottleneck(torch, cb, x, flat_params, stride, save8):
    """The first block of a ResNet-50 stage through ``conv_bn_train``:
    1x1, 3x3 (carrying the stage's stride), 1x1, and the 1x1 projection
    shortcut, ReLUs between; bf16 activations, fp32 parameters."""
    names = ("a", "b", "c", "proj")
    p = {n: flat_params[3 * i:3 * i + 3] for i, n in enumerate(names)}

    def conv_bn(h, name, s, pad):
        w, g, b = p[name]
        zeros = torch.zeros_like(g)
        return cb.conv_bn_train(h, w, g, b, zeros, zeros + 1, stride=s,
                                padding=pad, save8=save8)[0]

    x = x.to(torch.bfloat16)
    h = torch.relu(conv_bn(x, "a", 1, 0))
    h = torch.relu(conv_bn(h, "b", stride, 1))
    return torch.relu(conv_bn(h, "c", 1, 0) + conv_bn(x, "proj", stride, 0))


def ops_resnet(torch, dev) -> dict:
    """ResNet-50 (``benchmarks/configs/resnet50.py``: batch 128, 224^2,
    the space-to-depth stem, bf16 compute): the stem conv both ways and
    its 3x3/s2 SAME max pool, the first bottleneck block of each stage
    forward and backward with ``save8`` off and on, the global average
    pool and ``conv_bn_infer``. Parity on 8 images drawn with numpy,
    times at 128 on inputs drawn on the card from a seed."""
    from paddle_tpu_torch.ops import conv, conv_bn as cb, pool
    rng = np.random.RandomState(0)
    B, P = RESNET_BATCH, RESNET_PARITY
    doc = {"batch": B, "parity_images": P}
    x = rng.rand(B, 224, 224, 3).astype(np.float32)
    w = _he(rng, 7, 7, 3, 64)

    def stem_s2d(d, xa, wa):
        ws, pads = conv.space_to_depth_conv_transform(wa, 2)
        return conv.conv2d(conv.space_to_depth(xa, 2), ws, padding=pads)

    def stem_direct(d, xa, wa):
        return conv.conv2d(xa, wa, stride=2, padding=3)

    err, (stem_card,) = held(torch, "stem (s2d) card vs CPU", stem_s2d,
                             [x[:P], w], dev, ulps=OPS_ULPS)
    xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    s2d, direct = stem_s2d(dev, xt, wt), stem_direct(dev, xt, wt)
    s2d_vs_direct = bf16_ulps(torch, s2d.float().cpu(), direct.float().cpu())
    if not s2d_vs_direct <= OPS_ULPS:
        fail(f"ops stem: s2d conv vs the direct 7x7/s2 conv "
             f"{s2d_vs_direct!r} ulps > {OPS_ULPS}")
    pool_err, _ = held(torch, "max pool 3x3/s2 SAME",
                       lambda d, a: pool.max_pool2d(
                           a.to(torch.bfloat16), 3, stride=2, padding="SAME"),
                       [s2d[:P].float().cpu().numpy()], dev, ulps=0)
    doc["stem"] = {
        "shape": list(s2d.shape), "card_vs_cpu_ulps": err,
        "s2d_vs_direct_ulps": s2d_vs_direct,
        "s2d_ms": ops_ms(torch, lambda: stem_s2d(dev, xt, wt)),
        "direct_ms": ops_ms(torch, lambda: stem_direct(dev, xt, wt)),
        "max_pool_card_vs_cpu_ulps": pool_err,
        "max_pool_ms": ops_ms(torch, lambda: pool.max_pool2d(
            s2d, 3, stride=2, padding="SAME"))}
    del xt, s2d, direct

    gen = torch.Generator(device=dev).manual_seed(0)
    stages = []
    for cin, mid, hw, stride in RESNET_STAGES:
        xs = rng.randn(P, hw, hw, cin).astype(np.float32)
        blk = bottleneck_params(rng, cin, mid)
        prm = [a for v in blk.values() for a in v]
        ho = hw // stride
        # each conv_bn_train of the block on its own inputs (ReLU's kink
        # at 0 would turn a rounding-level difference into a different
        # gradient mask, so the gradients are held op by op)
        conv_in = {"a": (xs, 1, 0), "proj": (xs, stride, 0),
                   "b": (rng.randn(P, hw, hw, mid).astype(np.float32),
                         stride, 1),
                   "c": (rng.randn(P, ho, ho, mid).astype(np.float32), 1, 0)}
        row = {"in": [B, hw, hw, cin], "out_channels": 4 * mid,
               "stride": stride}
        for save8 in (False, True):
            key = "save8" if save8 else "exact"

            def fn(d, xa, *pa, save8=save8, stride=stride):
                return bottleneck(torch, cb, xa, pa, stride, save8)

            block_err, _ = held(
                torch, f"stage {len(stages) + 1} block forward ({key})", fn,
                [xs] + prm, dev, rel=OPS_BF16_REL)
            conv_err = 0.0
            for name, (xin, s_, pad) in conv_in.items():
                def one(d, xa, w, g, b, s_=s_, pad=pad, save8=save8):
                    zeros = torch.zeros_like(g)
                    return cb.conv_bn_train(xa.to(torch.bfloat16), w, g, b,
                                            zeros, zeros + 1, stride=s_,
                                            padding=pad, save8=save8)

                err, _ = held(torch, f"stage {len(stages) + 1} conv_bn_train "
                              f"{name} ({key})", one, [xin] + blk[name], dev,
                              wrt=(0, 1, 2, 3), rel=OPS_BF16_REL)
                conv_err = max(conv_err, err)
            xa = torch.randn(B, hw, hw, cin, device=dev, generator=gen,
                             dtype=torch.bfloat16)
            pa = [torch.from_numpy(a).to(dev).requires_grad_() for a in prm]
            cot = torch.randn(B, ho, ho, 4 * mid, device=dev, generator=gen,
                              dtype=torch.bfloat16)

            def fwd(xa=xa, pa=pa, save8=save8, stride=stride):
                with torch.no_grad():
                    return bottleneck(torch, cb, xa, pa, stride, save8)

            def fwd_bwd(xa=xa, pa=pa, save8=save8, stride=stride, cot=cot):
                out = bottleneck(torch, cb, xa.requires_grad_(), pa, stride,
                                 save8)
                torch.autograd.backward(out, cot)

            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            row[key] = {"block_fwd_card_vs_cpu_rel": block_err,
                        "conv_bn_fwd_bwd_card_vs_cpu_rel": conv_err,
                        "fwd_ms": ops_ms(torch, fwd),
                        "fwd_bwd_ms": ops_ms(torch, fwd_bwd),
                        "peak_bytes_above_inputs":
                            torch.cuda.max_memory_allocated() - base}
            del xa, pa, cot
        stages.append(row)
    doc["blocks"] = stages

    gerr, _ = held(torch, "global_avg_pool2d",
                   lambda d, a: pool.global_avg_pool2d(a.to(torch.bfloat16)),
                   [rng.randn(P, 7, 7, 2048).astype(np.float32)], dev,
                   wrt=(0,), ulps=OPS_ULPS)
    ft = torch.randn(B, 7, 7, 2048, device=dev, generator=gen,
                     dtype=torch.bfloat16)
    doc["global_avg_pool"] = {"card_vs_cpu_ulps": gerr,
                              "ms": ops_ms(torch, lambda: pool.global_avg_pool2d(ft))}
    xi = rng.randn(P, 56, 56, 64).astype(np.float32)
    pi = [_he(rng, 3, 3, 64, 64), (1 + 0.1 * rng.randn(64)).astype(np.float32),
          (0.1 * rng.randn(64)).astype(np.float32),
          (0.1 * rng.randn(64)).astype(np.float32),
          (1 + 0.1 * rng.rand(64)).astype(np.float32)]
    ierr, _ = held(torch, "conv_bn_infer",
                   lambda d, a, *p: cb.conv_bn_infer(a.to(torch.bfloat16), *p,
                                                     padding=1),
                   [xi] + pi, dev, rel=OPS_BF16_REL)
    xit = torch.randn(B, 56, 56, 64, device=dev, generator=gen,
                      dtype=torch.bfloat16)
    pit = [torch.from_numpy(a).to(dev) for a in pi]
    doc["conv_bn_infer"] = {"card_vs_cpu_rel": ierr, "ms": ops_ms(
        torch, lambda: cb.conv_bn_infer(xit, *pit, padding=1))}
    return doc


LSTM_BATCH, LSTM_T, LSTM_EMB, LSTM_VOCAB = 64, 100, 128, 30000
LSTM_HIDDEN = (256, 1280)
LSTM_PARITY_ROWS = 8


def ops_lstm(torch, dev) -> dict:
    """The LSTM text classifier (``benchmarks/configs/lstm.py``: batch 64,
    T = 100, emb 128 over a 30000-word table; hidden 256 and 1280):
    the embedding and its scatter-add gradient, ``lstm`` and ``gru``
    forward and backward (forward and reverse, lengths 50..100), the
    sequence pools, ``context_projection`` and ``row_conv`` at D = 512;
    ``torch.nn.LSTM`` (cuDNN) timed at the same shapes as a yardstick
    (the port never calls it). Parity on 8 rows, times at 64."""
    from paddle_tpu_torch.ops import rnn, sequence, sparse
    rng = np.random.RandomState(1)
    B, T, E, P = LSTM_BATCH, LSTM_T, LSTM_EMB, LSTM_PARITY_ROWS
    doc = {"batch": B, "T": T, "emb": E, "parity_rows": P}
    table = (rng.randn(LSTM_VOCAB, E) * 0.1).astype(np.float32)
    ids = rng.randint(0, LSTM_VOCAB, (B, T)).astype(np.int32)
    lengths = rng.randint(T // 2, T + 1, B).astype(np.int32)   # 50..100
    lengths[0] = T
    rows = rng.randn(B * T, E).astype(np.float32)

    emb_err, _ = held(torch, "embedding_lookup",
                      lambda d, tb, i: sparse.embedding_lookup(tb, i),
                      [table, ids], dev, wrt=(0,))
    sc_err, _ = held(torch, "scatter_add_rows",
                     lambda d, tb, i, r: sparse.scatter_add_rows(
                         tb, i.reshape(-1), r),
                     [table, ids, rows], dev, wrt=(0, 2))
    tb = torch.from_numpy(table).to(dev).requires_grad_()
    it = torch.from_numpy(ids).to(dev)
    rt = torch.from_numpy(rows).to(dev)
    ecot = torch.randn(B, T, E, device=dev)
    doc["embedding"] = {
        "card_vs_cpu_rel": emb_err, "scatter_add_card_vs_cpu_rel": sc_err,
        "fwd_ms": ops_ms(torch, lambda: sparse.embedding_lookup(tb, it)),
        "fwd_bwd_ms": ops_ms(torch, lambda: torch.autograd.grad(
            sparse.embedding_lookup(tb, it), tb, ecot)),
        "scatter_add_rows_ms": ops_ms(torch, lambda: sparse.scatter_add_rows(
            tb.detach(), it.reshape(-1), rt))}
    x = (rng.randn(B, T, E) * 0.5).astype(np.float32)
    lt = torch.from_numpy(lengths).to(dev)
    for kind, gates in (("lstm", 4), ("gru", 3)):
        fnc = getattr(rnn, kind)
        for H in LSTM_HIDDEN:
            w_ih = (rng.randn(E, gates * H) / np.sqrt(E)).astype(np.float32)
            w_hh = (rng.randn(H, gates * H) / np.sqrt(H)).astype(np.float32)
            b = (0.1 * rng.randn(gates * H)).astype(np.float32)
            row = {}
            for reverse in (False, True):
                def fn(d, xa, la, *w, reverse=reverse, fnc=fnc):
                    return fnc(xa, la, *w, reverse=reverse)

                err, _ = held(torch, f"{kind} H={H} reverse={reverse}", fn,
                              [x[:P], lengths[:P], w_ih, w_hh, b], dev,
                              wrt=(0, 2, 3, 4), rel=OPS_BF16_REL)
                xt = torch.from_numpy(x).to(dev).requires_grad_()
                wt = [torch.from_numpy(a).to(dev).requires_grad_()
                      for a in (w_ih, w_hh, b)]
                cot = torch.randn(B, T, H, device=dev)

                def fwd_bwd(xt=xt, wt=wt, cot=cot, reverse=reverse, fnc=fnc):
                    out = fnc(xt, lt, *wt, reverse=reverse)[0]
                    torch.autograd.backward(out, cot)

                def fwd(xt=xt, wt=wt, reverse=reverse, fnc=fnc):
                    with torch.no_grad():
                        return fnc(xt, lt, *wt, reverse=reverse)

                row["reverse" if reverse else "forward"] = {
                    "card_vs_cpu_rel": err, "fwd_ms": ops_ms(torch, fwd),
                    "fwd_bwd_ms": ops_ms(torch, fwd_bwd)}
            if kind == "lstm":
                row["cudnn_lstm_fp32"] = cudnn_lstm_ms(torch, dev, B, T, E, H)
            doc[f"{kind}_h{H}"] = row

    D = 512
    xs = rng.randn(B, T, D).astype(np.float32)
    wr = (rng.randn(3, D) * 0.3).astype(np.float32)
    seq_doc = {}
    for name, fn in (
            ("seq_avg", lambda d, a, l: sequence.seq_avg(a, l)),
            ("seq_max", lambda d, a, l: sequence.seq_max(a, l)),
            ("seq_last", lambda d, a, l: sequence.seq_last(a, l)),
            ("context_projection",
             lambda d, a, l: sequence.context_projection(a, l, 3, -1))):
        err, _ = held(torch, name, fn, [xs, lengths], dev, wrt=(0,))
        xt = torch.from_numpy(xs).to(dev)
        seq_doc[name] = {"card_vs_cpu_rel": err,
                         "ms": ops_ms(torch, lambda fn=fn: fn(dev, xt, lt))}
    err, _ = held(torch, "row_conv",
                  lambda d, a, l, w: sequence.row_conv(a, l, w),
                  [xs, lengths, wr], dev, wrt=(0, 2))
    wrt_ = torch.from_numpy(wr).to(dev)
    seq_doc["row_conv"] = {"card_vs_cpu_rel": err, "ms": ops_ms(
        torch, lambda: sequence.row_conv(xt, lt, wrt_))}
    doc[f"sequence_d{D}"] = seq_doc
    return doc


def cudnn_lstm_ms(torch, dev, B, T, E, H) -> dict:
    """``torch.nn.LSTM`` (cuDNN, fp32, TF32 off) at the same shapes,
    forward and forward + backward: a yardstick the port never calls."""
    lstm = torch.nn.LSTM(E, H, batch_first=True).to(dev)
    x = torch.randn(B, T, E, device=dev, requires_grad=True)
    cot = torch.randn(B, T, H, device=dev)

    def fwd():
        with torch.no_grad():
            return lstm(x)

    def fwd_bwd():
        torch.autograd.backward(lstm(x)[0], cot)

    return {"fwd_ms": ops_ms(torch, fwd), "fwd_bwd_ms": ops_ms(torch, fwd_bwd)}


def ops_structured(torch, dev) -> dict:
    """The structured losses: ``crf_log_likelihood`` (and its gradient)
    and ``crf_decode`` at B = 64, T = 100, 64 tags; ``ctc_loss`` with its
    gradient and ``ctc_greedy_decode`` at B = 32, T = 400 frames, 29
    classes with the blank, labels up to 100 long; ``lambda_rank`` at
    B = 64, lists of 50."""
    from paddle_tpu_torch.ops import crf, ctc, loss
    rng = np.random.RandomState(2)
    doc = {}
    B, T, N = 64, 100, 64
    emis = rng.randn(B, T, N).astype(np.float32)
    trans = (0.5 * rng.randn(N + 2, N)).astype(np.float32)
    tags = rng.randint(0, N, (B, T)).astype(np.int32)
    lens = rng.randint(50, T + 1, B).astype(np.int32)
    ll_err, _ = held(torch, "crf_log_likelihood",
                     lambda d, e, tg, l, w: crf.crf_log_likelihood(e, tg, l, w),
                     [emis, tags, lens, trans], dev, wrt=(0, 3))
    dec_err, _ = held(torch, "crf_decode",
                      lambda d, e, l, w: crf.crf_decode(e, l, w),
                      [emis, lens, trans], dev)
    et, tt_, lt, wt = (torch.from_numpy(a).to(dev)
                       for a in (emis, tags, lens, trans))
    et.requires_grad_()
    wt.requires_grad_()
    doc["crf"] = {
        "B": B, "T": T, "tags": N, "log_likelihood_card_vs_cpu_rel": ll_err,
        "decode_tags_equal": True, "decode_score_card_vs_cpu_rel": dec_err,
        "log_likelihood_fwd_bwd_ms": ops_ms(torch, lambda: torch.autograd.grad(
            crf.crf_log_likelihood(et, tt_, lt, wt).sum(), (et, wt))),
        "decode_ms": ops_ms(torch, lambda: crf.crf_decode(et.detach(), lt,
                                                          wt.detach()))}

    B, T, C, L = 32, 400, 29, 100
    logits = rng.randn(B, T, C).astype(np.float32)
    lab_len = rng.randint(50, L + 1, B).astype(np.int32)
    labels = rng.randint(1, C, (B, L)).astype(np.int32)
    in_len = rng.randint(300, T + 1, B).astype(np.int32)
    in_len[0] = T

    def ctc_fn(d, lg, lb, il, ll):
        return ctc.ctc_loss(torch.log_softmax(lg, -1), lb, il, ll)

    ctc_err, _ = held(torch, "ctc_loss", ctc_fn,
                      [logits, labels, in_len, lab_len], dev, wrt=(0,))
    lp = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    gd_err, _ = held(torch, "ctc_greedy_decode",
                     lambda d, a, il: ctc.ctc_greedy_decode(a, il),
                     [lp.astype(np.float32), in_len], dev)
    lg, lb, il, ll = (torch.from_numpy(a).to(dev)
                      for a in (logits, labels, in_len, lab_len))
    lg.requires_grad_()
    lpt = torch.log_softmax(lg.detach(), -1)
    doc["ctc"] = {
        "B": B, "T": T, "classes": C, "max_label": L,
        "loss_card_vs_cpu_rel": ctc_err, "greedy_ids_equal": True,
        "loss_fwd_bwd_ms": ops_ms(torch, lambda: torch.autograd.grad(
            ctc_fn(dev, lg, lb, il, ll).sum(), lg)),
        "loss_fwd_ms": ops_ms(torch, lambda: ctc_fn(dev, lg.detach(), lb, il,
                                                    ll)),
        "greedy_decode_ms": ops_ms(torch, lambda: ctc.ctc_greedy_decode(
            lpt, il))}

    B, T = 64, 50
    scores = rng.randn(B, T).astype(np.float32)
    rel = rng.randint(0, 5, (B, T)).astype(np.float32)
    ln = rng.randint(10, T + 1, B).astype(np.int32)
    lr_err, _ = held(torch, "lambda_rank",
                     lambda d, s, r, l: loss.lambda_rank(s, r, l),
                     [scores, rel, ln], dev, wrt=(0,))
    st, rt, lnt = (torch.from_numpy(a).to(dev) for a in (scores, rel, ln))
    st.requires_grad_()
    doc["lambda_rank"] = {
        "B": B, "list": T, "card_vs_cpu_rel": lr_err,
        "fwd_bwd_ms": ops_ms(torch, lambda: torch.autograd.grad(
            loss.lambda_rank(st, rt, lnt).sum(), st))}
    return doc


# SSD300 (Liu et al. 2016): the six feature maps, their min/max sizes and
# aspect ratios -> 8732 priors
SSD_MAPS = ((38, 30, 60, (2.0,)), (19, 60, 111, (2.0, 3.0)),
            (10, 111, 162, (2.0, 3.0)), (5, 162, 213, (2.0, 3.0)),
            (3, 213, 264, (2.0,)), (1, 264, 315, (2.0,)))
SSD_PRIORS = 8732
ROI_N, ROI_OUT, ROI_MAP = 128, 7, (38, 38, 512)


def ops_ssd(torch, dev) -> dict:
    """SSD300 detection: ``prior_boxes`` over the six maps (8732 priors),
    ``match_priors`` against 10 boxes, ``encode_boxes`` / ``decode_boxes``,
    ``nms`` over the 8732 decoded boxes (max_out 200), and ``roi_pool`` of
    128 ROIs to 7x7 over a 38x38x512 fp32 map, with its peak memory."""
    from paddle_tpu_torch.ops import detection as det
    rng = np.random.RandomState(3)

    def priors(d):
        return torch.cat([det.prior_boxes(f, f, 300, 300, lo, hi, ar,
                                          device=d)
                          for f, lo, hi, ar in SSD_MAPS])

    perr, (pc,) = held(torch, "prior_boxes", priors, [], dev)
    n = pc.shape[0]
    if n != SSD_PRIORS:
        fail(f"ops prior_boxes: {n} priors, expected {SSD_PRIORS}")
    pr = pc.numpy()
    xy = rng.uniform(0.0, 0.7, (10, 2))
    gt = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (10, 2))],
                        1).astype(np.float32)
    valid = np.ones(10, bool)
    valid[9] = False
    merr, (mi, _) = held(torch, "match_priors",
                         lambda d, p, g, v: det.match_priors(p, g, v),
                         [pr, gt, valid], dev)
    matched = int((mi >= 0).sum())
    # regression targets: the matched box, or the prior itself (background)
    gt_p = np.where((mi.numpy() >= 0)[:, None],
                    gt[np.maximum(mi.numpy(), 0)], pr).astype(np.float32)
    eerr, (loc,) = held(torch, "encode_boxes",
                        lambda d, g, p: det.encode_boxes(g, p),
                        [gt_p, pr], dev, wrt=(0,))
    loc = (loc.numpy() + 0.1 * rng.randn(n, 4)).astype(np.float32)
    derr, (boxes,) = held(torch, "decode_boxes",
                          lambda d, l, p: det.decode_boxes(l, p),
                          [loc, pr], dev, wrt=(0,))
    scores = rng.rand(n).astype(np.float32)
    nerr, (sel, _) = held(torch, "nms", lambda d, b, s: det.nms(b, s, 200),
                          [boxes.numpy(), scores], dev)
    pt, gtt, vt = (torch.from_numpy(a).to(dev) for a in (pr, gt, valid))
    bt, st = (torch.from_numpy(a).to(dev) for a in (boxes.numpy(), scores))
    doc = {"priors": n, "prior_boxes_card_vs_cpu_rel": perr,
           "prior_boxes_ms": ops_ms(torch, lambda: priors(dev)),
           "match_equal": True, "matched_priors": matched,
           "match_priors_ms": ops_ms(torch, lambda: det.match_priors(
               pt, gtt, vt)),
           "encode_card_vs_cpu_rel": eerr, "decode_card_vs_cpu_rel": derr,
           "encode_ms": ops_ms(torch, lambda: det.encode_boxes(
               torch.from_numpy(gt_p).to(dev), pt)),
           "decode_ms": ops_ms(torch, lambda: det.decode_boxes(
               torch.from_numpy(loc).to(dev), pt)),
           "nms_equal": True, "nms_kept": int((sel >= 0).sum()),
           "nms_ms": ops_ms(torch, lambda: det.nms(bt, st, 200))}

    H, W, C = ROI_MAP
    feat = rng.randn(H, W, C).astype(np.float32)
    xy = rng.uniform(0, 0.8 * W, (ROI_N, 2))
    rois = np.concatenate([xy, xy + rng.uniform(1, 0.5 * W, (ROI_N, 2))],
                          1).astype(np.float32)
    rerr, _ = held(torch, "roi_pool",
                   lambda d, f, r: det.roi_pool(f, r, ROI_OUT, ROI_OUT),
                   [feat, rois], dev, wrt=(0,))
    ft, rt = (torch.from_numpy(a).to(dev) for a in (feat, rois))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    det.roi_pool(ft, rt, ROI_OUT, ROI_OUT)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    doc["roi_pool"] = {
        "rois": ROI_N, "out": [ROI_OUT, ROI_OUT], "map": list(ROI_MAP),
        "card_vs_cpu_rel": rerr,
        "ms": ops_ms(torch, lambda: det.roi_pool(ft, rt, ROI_OUT, ROI_OUT)),
        "peak_bytes_above_inputs": peak,
        "reference_dense_mask_bytes": ROI_N * ROI_OUT ** 2 * H * W * C * 4}
    return doc


BEAM_B, BEAM_K, BEAM_V, BEAM_H, BEAM_LEN = 16, 5, 30000, 512, 50


def gru_decoder(torch, d, rng):
    """A GRU decoder cell of hidden 512 over a 30000-word vocabulary
    (random weights from ``rng``) as a ``beam_search`` step function on
    ``d``, and its initial state (an encoder context tiled over K)."""
    from paddle_tpu_torch.ops import math, rnn
    H, V = BEAM_H, BEAM_V
    w = {"emb": rng.randn(V, H) * 0.5, "w_ih": rng.randn(H, 3 * H) / np.sqrt(H),
         "w_hh": rng.randn(H, 3 * H) / np.sqrt(H),
         "out": rng.randn(H, V) * 3.0 / np.sqrt(H)}
    w = {k: torch.from_numpy(v.astype(np.float32)).to(d) for k, v in w.items()}

    def step(tok, state):
        b, k = tok.shape
        x = w["emb"][tok.long()].reshape(b * k, H)
        h = rnn.gru_cell(math.matmul(x, w["w_ih"]), state.reshape(b * k, H),
                         w["w_hh"])
        logp = torch.log_softmax(math.matmul(h, w["out"]), -1)
        return logp.reshape(b, k, V), h.reshape(b, k, H)

    return step


def beam_records(torch, run):
    """``run()`` with ``ops.beam``'s top-k recording each step's top K+1
    candidate scores and flat indices (CPU tensors): the K-th to (K+1)-th
    margin decides whether a selection could flip."""
    from paddle_tpu_torch.ops import beam
    records, orig = [], beam.top_k

    def top_k(x, k):
        v, i = orig(x, k + 1)
        records.append((v.detach().cpu(), i.cpu()))
        return v[..., :k], i[..., :k]

    beam.top_k = top_k
    try:
        out = run()
    finally:
        beam.top_k = orig
    return out, records


def beam_gate(torch, label, cpu, card, K) -> dict:
    """Card against CPU per batch row: the rows' selections (flat indices
    of the top K) must be equal at every step, except from a step where the
    CPU's candidates K and K+1 (or two of the top K) lie within ``dmax``,
    the largest |card - CPU| score of the selections that agreed; such a
    row is reported and not compared further."""
    (cout, crec), (gout, grec) = cpu, card
    B = cout[0].shape[0]
    dmax, diverged = 0.0, {}
    for t, ((vc, ic), (vg, ig)) in enumerate(zip(crec, grec)):
        for b in range(B):
            if b in diverged:
                continue
            if torch.equal(ic[b, :K], ig[b, :K]):
                dmax = max(dmax, float((vc[b, :K] - vg[b, :K]).abs().max()))
                continue
            diverged[b] = (t, float((vc[b, :K] - vc[b, 1:K + 1]).min()))
    if len(crec) != len(grec) and len(diverged) < B:
        fail(f"ops {label}: {len(grec)} steps on the card, {len(crec)} on "
             f"the CPU")
    for b, (t, margin) in diverged.items():
        print(f"ops {label} divergence: " + json.dumps(
            {"row": b, "step": t, "margin": margin, "max_abs_dscore": dmax}))
        if not margin < dmax:
            fail(f"ops {label}: row {b} diverges from the CPU at step {t} "
                 f"(margin {margin} vs {dmax})")
    final_ties = 0
    for b in range(B):
        if b in diverged:
            continue
        if rel_err(torch, gout[2][b], cout[2][b]) > OPS_F32_REL:
            fail(f"ops {label}: row {b} scores {gout[2][b].tolist()} vs the "
                 f"CPU's {cout[2][b].tolist()}")
        if all(torch.equal(c[b], g[b]) for c, g in zip(cout[:2], gout[:2])):
            continue
        # equal selections, another final order: only a near-tie of the
        # CPU's final scores may reorder them
        gaps = (cout[2][b][:-1] - cout[2][b][1:]).abs()
        if not (gaps.numel() and float(gaps.min()) < dmax):
            fail(f"ops {label}: row {b} tokens differ from the CPU with "
                 f"equal selections")
        final_ties += 1
    return {"rows_equal": B - len(diverged) - final_ties,
            "rows_diverged_at_near_tie": len(diverged),
            "rows_reordered_at_final_near_tie": final_ties,
            "max_abs_dscore": dmax, "steps": len(grec)}


def ops_beam(torch, dev) -> dict:
    """``beam_search`` (B = 16, K = 5, V = 30000, max_len 50) and
    ``greedy_search`` over a GRU decoder cell of hidden 512, fp32
    compute: tokens against the CPU's (``beam_gate``) and card times."""
    from paddle_tpu_torch.ops import beam
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    old = GLOBAL_FLAGS.get("compute_dtype")
    GLOBAL_FLAGS.set("compute_dtype", "float32")
    try:
        doc = {"B": BEAM_B, "K": BEAM_K, "V": BEAM_V, "hidden": BEAM_H,
               "max_len": BEAM_LEN}
        ctx = np.random.RandomState(5).randn(BEAM_B, 1, BEAM_H).astype(
            np.float32)
        for name, K in (("beam_search", BEAM_K), ("greedy_search", 1)):
            outs = []
            for d in ("cpu", dev):
                step = gru_decoder(torch, d, np.random.RandomState(4))
                st = torch.from_numpy(np.repeat(ctx, K, 1)).to(d)
                if K == 1:
                    run = lambda: beam.greedy_search(step, st, BEAM_B, BEAM_V,
                                                     1, 2, BEAM_LEN)
                else:
                    run = lambda: beam.beam_search(step, st, BEAM_B, K, BEAM_V,
                                                   1, 2, BEAM_LEN)
                with torch.no_grad():
                    out, rec = beam_records(torch, run)
                outs.append(([o.cpu() if o.dim() > 1 else o.cpu()[:, None]
                              for o in out], rec))
                if d != "cpu":
                    with torch.no_grad():
                        ms = ops_ms(torch, run)
            gate = beam_gate(torch, name, outs[0], outs[1], K)
            doc[name] = {**gate, "ms": ms,
                         "ms_per_step": ms / max(gate["steps"], 1)}
    finally:
        GLOBAL_FLAGS.set("compute_dtype", old)
    return doc


def ops_phase(torch, dev) -> dict:
    """The ``ops:`` line: the op layer at the repo's CNN/RNN benchmark
    widths, each group held against the CPU (the port's same function on
    the same inputs, TF32 off) and timed on the card."""
    t0 = time.perf_counter()
    doc = {"resnet50": ops_resnet(torch, dev), "lstm": ops_lstm(torch, dev),
           "structured": ops_structured(torch, dev), "ssd": ops_ssd(torch, dev),
           "beam": ops_beam(torch, dev)}
    doc["phase_s"] = time.perf_counter() - t0
    print("ops: " + json.dumps(doc))
    return doc


# ---------------------------------------------------------------------------
# layers phase: the v2 layer API at the widths of three models the repo
# supports, each network held against the CPU (the port's same graph with
# the same parameters and rows), timed on the card
# ---------------------------------------------------------------------------

LAYERS_LSTM = {"vocab": 30000, "emb": 128, "hidden": 256, "batch": 64,
               "T": 100, "parity_rows": 16, "adam_steps": 5, "lr": 2e-3}
LAYERS_VGG = {"image": 224, "classes": 1000, "batch": 64,
              "parity_images": 2, "momentum": 0.9, "lr": 0.01}
LAYERS_S2S = {"vocab": 30000, "emb": 512, "hidden": 512, "batch": 32,
              "len_lo": 20, "len_hi": 50, "parity_rows": 4, "gen_batch": 16,
              "beam": 3, "max_length": 50, "gate_rows": 4}


def lstm_classifier(T):
    """The LSTM text classifier (``benchmarks/configs/lstm.py`` through
    ``models/text.lstm_text_classification``, its calls): embedding 128,
    ``simple_lstm`` 256, max pooling, a 2-way softmax, with its cost and
    the two evaluators."""
    c = LAYERS_LSTM
    L, dt = T.layer, T.data_type
    words = L.data("words", dt.integer_value_sequence(c["vocab"]))
    lbl = L.data("label", dt.integer_value(2))
    e = L.embedding(words, c["emb"], name="t_emb")
    h = T.networks.simple_lstm(e, c["hidden"], name="t_lstm0")
    pooled = L.pool(h, pooling_type=T.pooling.Max(), name="t_pool")
    out = L.fc(pooled, 2, act=T.activation.Softmax(), name="t_out")
    cost = L.classification_cost(out, lbl, name="cost")
    evals = [T.evaluator.classification_error(out, lbl, name="err"),
             T.evaluator.auc(out, lbl, name="auc")]
    return out, cost, evals


def seq2seq_graphs(T):
    """``models/seq2seq.py``'s training and generation graphs (its calls,
    named layers), one parameter set: two ``simple_gru`` encoders, a
    ``recurrent_group`` over ``gru_decoder_with_attention``, a softmax fc
    over the target vocabulary, and ``beam_search`` sharing them."""
    c = LAYERS_S2S
    L, N, dt = T.layer, T.networks, T.data_type
    V, E, H = c["vocab"], c["emb"], c["hidden"]
    pa = T.attr.ParamAttr
    src = L.data("source_language_word", dt.integer_value_sequence(V))
    se = L.embedding(src, E, name="src_emb",
                     param_attr=pa(name="_source_language_embedding"))
    fwd = N.simple_gru(se, H, name="src_fwd_gru")
    bwd = N.simple_gru(se, H, reverse=True, name="src_bwd_gru")
    enc = L.concat([fwd, bwd], name="encoded_vector")
    proj = L.fc(enc, H, act="linear", bias_attr=False, name="encoded_proj",
                param_attr=pa(name="_encoded_proj.w"))
    boot = L.fc(L.first_seq(bwd, name="enc_last"), H, act="tanh",
                name="decoder_boot", param_attr=pa(name="_decoder_boot.w"))

    def step(e, p, w):
        g = N.gru_decoder_with_attention(e, p, w, H, boot, name="decoder_gru")
        return L.fc(g, V, act="softmax", name="decoder_out",
                    param_attr=pa(name="_decoder_out.w"))
    statics = [L.StaticInput(enc, is_seq=True),
               L.StaticInput(proj, is_seq=True)]
    trg = L.data("target_language_word", dt.integer_value_sequence(V))
    te = L.embedding(trg, E, name="trg_emb",
                     param_attr=pa(name="_target_language_embedding"))
    dec = L.recurrent_group(step, input=statics + [te], name="decoder_group")
    lbl = L.data("target_language_next_word", dt.integer_value_sequence(V))
    cost = L.classification_cost(dec, lbl, name="seq2seq_cost")
    gen = L.beam_search(step, input=statics + [L.GeneratedInput(
        size=V, embedding_name="_target_language_embedding",
        embedding_size=E)], bos_id=0, eos_id=1, beam_size=c["beam"],
        max_length=c["max_length"], name="generated_word")
    return cost, gen


def graph_run(torch, T, topo, params, state, rows, dev, *, is_training=False,
              key=None, grads=True, extra=()):
    """One forward (and the gradients of sum(out * cot) over the floating
    outputs, cotangents from a seed) of ``topo`` on ``dev``, on copies of
    ``params`` there; rows through ``DataFeeder``. Returns CPU tensors:
    (outputs, new state, gradients)."""
    from paddle_tpu_torch.ops import prng
    types = {l.name: l.data_spec for l in topo.data_layers}
    feeds = T.data_feeder.DataFeeder(types, device=dev).feed(rows)
    leaves = {k: v.detach().to(dev).requires_grad_(grads)
              for k, v in params.items()}
    st = {k: v.to(dev) for k, v in state.items()}
    outs, new = topo.compile(extra)(leaves, st, feeds, is_training=is_training,
                                    dropout_key=None if key is None
                                    else prng.prng_key(key))
    g = {}
    if grads:
        rng = np.random.RandomState(1)
        flo = [v.array for _, v in sorted(outs.items())
               if v.array.is_floating_point()]
        loss = sum((a.float() * torch.from_numpy(rng.randn(*a.shape).astype(
            np.float32)).to(dev)).sum() for a in flo)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        g = {k: x.detach().cpu() for k, x in zip(leaves, got)
             if x is not None}
    return ({k: v.array.detach().cpu() for k, v in outs.items()},
            {k: v.detach().cpu() for k, v in new.items()}, g)


def graph_held(torch, label, cpu, card, rel) -> dict:
    """Card against CPU, part by part: floating tensors within ``rel``
    (relative to the CPU's max), integer ones equal. Returns the largest
    error of outputs, state and gradients."""
    doc = {}
    for part, a, b in zip(("outputs", "state", "grads"), card, cpu):
        worst = 0.0
        if set(a) != set(b):
            fail(f"layers {label}: {part} names differ: {sorted(a)} vs "
                 f"{sorted(b)}")
        for n in b:
            if not b[n].is_floating_point():
                if not torch.equal(a[n], b[n]):
                    fail(f"layers {label}: {part} {n} differs from the CPU")
                continue
            if not torch.isfinite(a[n].float()).all():
                fail(f"layers {label}: non-finite {part} {n} on the card")
            err = rel_err(torch, a[n].float(), b[n].float())
            if not err <= rel:
                fail(f"layers {label}: {part} {n} card vs CPU relative error "
                     f"{err!r} > {rel!r}")
            worst = max(worst, err)
        doc[f"{part}_rel"] = worst
    return doc


def layerwise_held(torch, T, topo, params, rows, dev, key, rel,
                   label) -> dict:
    """Each layer of ``topo`` run on the CPU from the card's inputs to it
    (forward, training mode, the same dropout key), and the gradients of
    its parameters from the card's gradient of its output (the card's run:
    sum(out * cot) over the graph's outputs, cotangents from a seed): every
    layer's output and parameter gradients held within ``rel`` of the
    CPU's. Returns the largest errors."""
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.topology import ForwardContext, Value

    def ctx():
        return ForwardContext(is_training=True,
                              dropout_key=prng.prng_key(key), state_in={})

    def to_cpu(v):
        mv = lambda x: None if x is None else x.detach().cpu()
        return Value(mv(v.array), mv(v.lengths), mv(v.sub_lengths),
                     mv(v.weights), mv(v.pre_act))

    types = {l.name: l.data_spec for l in topo.data_layers}
    feeds = T.data_feeder.DataFeeder(types, device=dev).feed(rows)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    values, card_ctx = {}, ctx()
    for l in topo.layers:
        values[l.name] = feeds[l.name] if l.is_data else l.fn(
            leaves, [values[p.name] for p in l.parents], card_ctx)
        if values[l.name].array.requires_grad:
            values[l.name].array.retain_grad()
    rng = np.random.RandomState(1)
    loss = sum((values[o.name].array.float() * torch.from_numpy(rng.randn(
        *values[o.name].array.shape).astype(np.float32)).to(dev)).sum()
        for o in topo.outputs)
    loss.backward()
    fwd_worst, grad_worst = 0.0, 0.0
    for l in topo.layers:
        if l.is_data:
            continue
        lp = {s.name: leaves[s.name].detach().cpu().requires_grad_()
              for s in l.param_specs}
        out = l.fn(lp, [to_cpu(values[p.name]) for p in l.parents], ctx())
        card_out = values[l.name].array
        err = rel_err(torch, card_out.detach().cpu().float(),
                      out.array.detach().float())
        if not err <= rel:
            fail(f"layers {label}: layer {l.name} from the card's inputs: "
                 f"card vs CPU relative error {err!r} > {rel!r}")
        fwd_worst = max(fwd_worst, err)
        if lp and card_out.grad is not None:
            got = torch.autograd.grad(out.array, list(lp.values()),
                                      grad_outputs=card_out.grad.cpu())
            for name, g in zip(lp, got):
                err = rel_err(torch, leaves[name].grad.cpu().float(),
                              g.float())
                if not err <= rel:
                    fail(f"layers {label}: gradient of {name} from the "
                         f"card's upstream gradient: card vs CPU relative "
                         f"error {err!r} > {rel!r}")
                grad_worst = max(grad_worst, err)
    return {"layers": sum(not l.is_data for l in topo.layers),
            "outputs_rel": fwd_worst, "grads_rel": grad_worst}


def cpu_copy(d) -> dict:
    return {k: v.detach().cpu() for k, v in d.items()}


def layers_lstm(torch, T, dev) -> dict:
    """The classifier at batch 64, T = 100 (lengths 50..100), bf16
    compute: parity (forward, loss, gradients, the evaluators' counts) on
    16 rows, 5 Adam steps on the card (finite, falling loss) and the
    forward + backward + update ms."""
    from paddle_tpu_torch.utils.rng import KeySource
    c = LAYERS_LSTM
    out, cost, evals = lstm_classifier(T)
    topo = T.topology.Topology([cost] + evals)
    params = T.parameters.create(topo, KeySource(7), device=dev)
    rng = np.random.RandomState(2)
    rows = [(list(rng.randint(0, c["vocab"], n)), int(rng.randint(2)))
            for n in rng.randint(c["T"] // 2, c["T"] + 1, c["batch"])]
    rows[0] = (list(rng.randint(0, c["vocab"], c["T"])), 1)
    P = c["parity_rows"]
    doc = {k: c[k] for k in ("vocab", "emb", "hidden", "batch", "T",
                             "parity_rows")}
    cpu = graph_run(torch, T, topo, cpu_copy(params.values), {}, rows[:P],
                    "cpu", is_training=True)
    card = graph_run(torch, T, topo, params.values, {}, rows[:P], dev,
                     is_training=True)
    doc["parity"] = graph_held(torch, "lstm", cpu, card, OPS_BF16_REL)
    doc["evaluators_equal"] = all(torch.equal(card[0][e.name], cpu[0][e.name])
                                  for e in evals)
    doc["err_cpu"] = cpu[0]["err"].tolist()

    types = {l.name: l.data_spec for l in topo.data_layers}
    feeds = T.data_feeder.DataFeeder(types, device=dev).feed(rows)
    fwd = T.topology.Topology(cost).compile()
    adam = T.optimizer.Adam(learning_rate=c["lr"])
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.values.items()}
    st = adam.init_state(leaves)
    losses = []

    def step(i):
        nonlocal st
        o, _ = fwd(leaves, {}, feeds, is_training=True)
        loss = o["cost"].array.float().mean()
        loss.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        _, st = adam.update(i, grads, leaves, st)
        for v in leaves.values():
            v.grad = None
        return loss

    for i in range(c["adam_steps"]):
        losses.append(step(i).item())
    doc["adam_losses"] = losses
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"layers lstm: the loss did not fall over {len(losses)} Adam "
             f"steps: {losses}")
    it = iter(range(c["adam_steps"], 10 ** 6))
    doc["fwd_bwd_update_ms"] = ops_ms(torch, lambda: step(next(it)))
    with torch.no_grad():
        doc["fwd_ms"] = ops_ms(torch, lambda: fwd(leaves, {}, feeds))
    return doc, out, params


def layers_vgg(torch, T, dev) -> dict:
    """VGG-16 (``networks.vgg_16_network``: 3x224x224 fed as flat CHW,
    1000 classes, batch 64, bf16 compute) in training mode with dropout
    on: parity on 2 images (outputs, loss and gradients; the dropout
    masks equal the CPU's on the same key), one Momentum step, the
    forward + backward ms and peak memory."""
    from paddle_tpu_torch.utils.rng import KeySource
    c = LAYERS_VGG
    L, dt = T.layer, T.data_type
    d = 3 * c["image"] ** 2
    img = L.data("image", dt.dense_vector(d))
    lbl = L.data("label", dt.integer_value(c["classes"]))
    out = T.networks.vgg_16_network(img, num_channels=3,
                                    num_classes=c["classes"])
    cost = L.classification_cost(out, lbl, name="cost")
    topo = T.topology.Topology(cost)
    drops = [l for l in topo.layers if l.layer_type == "dropout"]
    extra = drops + [l.parents[0] for l in drops]
    t0 = time.perf_counter()
    params = T.parameters.create(topo, KeySource(3), device=dev)
    torch.cuda.synchronize()
    doc = {**c, "params": int(sum(v.numel() for v in params.values.values())),
           "create_s": time.perf_counter() - t0}
    rng = np.random.RandomState(3)
    rows = [(rng.rand(d).astype(np.float32), int(rng.randint(c["classes"])))
            for _ in range(c["batch"])]
    P = c["parity_images"]
    t0 = time.perf_counter()
    cpu = graph_run(torch, T, topo, cpu_copy(params.values), {}, rows[:P],
                    "cpu", is_training=True, key=11, extra=extra,
                    grads=False)
    card = graph_run(torch, T, topo, params.values, {}, rows[:P], dev,
                     is_training=True, key=11, extra=extra, grads=False)
    doc["parity"] = graph_held(torch, "vgg16", cpu, card, OPS_BF16_REL)
    # gradients op by op, as the ops: phase holds ResNet blocks: through
    # 16 bf16 layers a rounding-level difference flips ReLU mask bits and
    # the first layers' gradients (sums with heavy cancellation) drift
    # far beyond any rounding tolerance, on either device
    doc["layerwise"] = layerwise_held(torch, T, topo, params.values,
                                      rows[:P], dev, 11, OPS_BF16_REL,
                                      "vgg16")
    doc["cpu_parity_s"] = time.perf_counter() - t0
    # a dropout mask where both sides' inputs are nonzero (ReLU zeros
    # carry no mask bit)
    compared, differ = 0, 0
    for l in drops:
        pre = l.parents[0].name
        live = (cpu[0][pre] != 0) & (card[0][pre] != 0)
        kc, kg = cpu[0][l.name] != 0, card[0][l.name] != 0
        compared += int(live.sum())
        differ += int((live & (kc != kg)).sum())
    doc["dropout_mask_compared"], doc["dropout_mask_differ"] = compared, differ
    if differ or not compared:
        fail(f"layers vgg16: {differ} of {compared} dropout mask bits differ "
             f"from the CPU's")

    types = {l.name: l.data_spec for l in topo.data_layers}
    feeds = T.data_feeder.DataFeeder(types, device=dev).feed(rows)
    fwd = topo.compile()
    from paddle_tpu_torch.ops import prng
    leaves = {k: v.detach().requires_grad_() for k, v in params.values.items()}
    opt = T.optimizer.Momentum(momentum=c["momentum"], learning_rate=c["lr"])
    st = opt.init_state(leaves)
    keys = iter(range(10 ** 6))

    def fwd_bwd():
        o, _ = fwd(leaves, {}, feeds, is_training=True,
                   dropout_key=prng.prng_key(next(keys)))
        loss = o["cost"].array.float().mean()
        loss.backward()
        return loss

    torch.cuda.reset_peak_memory_stats()
    loss0 = fwd_bwd()
    _, st = opt.update(0, {k: v.grad for k, v in leaves.items()}, leaves, st)
    for v in leaves.values():
        v.grad = None
    doc["loss"] = loss0.item()
    if not np.isfinite(doc["loss"]):
        fail(f"layers vgg16: non-finite loss {doc['loss']}")

    def timed():
        fwd_bwd()
        for v in leaves.values():
            v.grad = None
    doc["fwd_bwd_ms"] = ops_ms(torch, timed)
    doc["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return doc


def layers_seq2seq(torch, T, dev) -> dict:
    """The attention seq2seq at the book's machine-translation widths
    (dictionaries 30000, word vectors 512, encoder and decoder 512), fp32
    compute: teacher-forced training at batch 32 (lengths 20..50; parity
    on 4 rows, forward + backward ms), and ``beam_search`` generation
    (beam 3, max_length 50) at batch 16 sharing those parameters: tokens
    equal to the CPU's on 4 rows except at a near-tie (``beam_gate``)."""
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.utils.rng import KeySource
    c = LAYERS_S2S
    old = GLOBAL_FLAGS.get("compute_dtype")
    GLOBAL_FLAGS.set("compute_dtype", "float32")
    try:
        cost, gen = seq2seq_graphs(T)
        topo, gtopo = T.topology.Topology(cost), T.topology.Topology(gen)
        params = T.parameters.create(topo, KeySource(5), device=dev)
        assert {s.name for s in gtopo.param_specs()} <= set(params.values)
        rng = np.random.RandomState(4)
        V = c["vocab"]

        def pair():
            n, m = rng.randint(c["len_lo"], c["len_hi"] + 1, 2)
            trg = list(rng.randint(2, V, m))
            return list(rng.randint(2, V, n)), [0] + trg[:-1], trg
        rows = [pair() for _ in range(c["batch"])]
        P = c["parity_rows"]
        doc = {k: c[k] for k in c}
        cpu = graph_run(torch, T, topo, cpu_copy(params.values), {}, rows[:P],
                        "cpu", is_training=True)
        card = graph_run(torch, T, topo, params.values, {}, rows[:P], dev,
                         is_training=True)
        doc["parity"] = graph_held(torch, "seq2seq", cpu, card, OPS_F32_REL)
        types = {l.name: l.data_spec for l in topo.data_layers}
        feeds = T.data_feeder.DataFeeder(types, device=dev).feed(rows)
        fwd = topo.compile()
        leaves = {k: v.detach().requires_grad_()
                  for k, v in params.values.items()}

        def fwd_bwd():
            o, _ = fwd(leaves, {}, feeds, is_training=True)
            o["seq2seq_cost"].array.mean().backward()
            for v in leaves.values():
                v.grad = None
        doc["train_T"] = int(feeds["source_language_word"].array.shape[1])
        doc["fwd_bwd_ms"] = ops_ms(torch, fwd_bwd)

        gfwd = gtopo.compile()
        gtypes = {l.name: l.data_spec for l in gtopo.data_layers}
        G = c["gate_rows"]
        outs = []
        for d in ("cpu", dev):
            pv = params.values if d != "cpu" else cpu_copy(params.values)
            f = T.data_feeder.DataFeeder(gtypes, device=d).feed(
                [(r[0],) for r in rows[:G]])
            with torch.no_grad():
                out, rec = beam_records(torch, lambda: gfwd(pv, {}, f)[0])
            v = out["generated_word"]
            outs.append(([v.array.cpu(), v.sub_lengths.cpu(),
                          v.weights.cpu()], rec))
        doc["generate_gate"] = beam_gate(torch, "seq2seq generate", outs[0],
                                         outs[1], c["beam"])
        gfeeds = T.data_feeder.DataFeeder(gtypes, device=dev).feed(
            [(r[0],) for r in rows[:c["gen_batch"]]])
        with torch.no_grad():
            doc["generate_ms"] = ops_ms(
                torch, lambda: gfwd(params.values, {}, gfeeds))
    finally:
        GLOBAL_FLAGS.set("compute_dtype", old)
    return doc, gen, params, rows


MERGED_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from paddle_tpu_torch.io import merged
from paddle_tpu_torch.core.graphs import GraphCaptureError
job = json.load(open(sys.argv[2]))
doc = {}
for name, spec in job.items():
    t0 = time.perf_counter()
    # the card by default; a CPU rehearsal names its device
    m = merged.load_inference_model(
        spec["path"], **({"device": spec["device"]} if "device" in spec
                         else {}))
    doc[name] = {"load_s": time.perf_counter() - t0, "device": str(m.device)}
    feeds = dict(np.load(spec["feeds"]))
    out = m.infer(feeds)[spec["output"]]
    np.save(spec["out"], out)
    if spec.get("capture"):
        try:
            m.aot_compile(spec["capture"])
            doc[name]["capture"] = "captured"
        except GraphCaptureError as e:
            doc[name]["capture"] = "GraphCaptureError: " + str(e)[:160]
bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
       or k.startswith("paddle_tpu.") or k == "chip_smoke"]
doc["foreign_modules"] = bad
print("CHILD " + json.dumps(doc))
"""


def layers_merged(torch, T, dev, clf, clf_params, gen, gen_params,
                  gen_rows) -> dict:
    """The classifier and the seq2seq generator saved with
    ``save_inference_model``, plain and ``weights_int8``; each loaded in a
    fresh process on the card that imports no model-building code, whose
    ``infer`` must give the in-process outputs (ids equal, probabilities
    within 1e-6); ``aot_compile(64)`` + ``call_exported`` of the
    classifier bitwise its eager forward; the generator's capture refused
    with ``GraphCaptureError`` (its stop test reads the device)."""
    from paddle_tpu_torch.io import merged
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    c = LAYERS_LSTM
    tmp = Path(tempfile.mkdtemp(prefix="layers_merged_"))
    rng = np.random.RandomState(6)
    lens = rng.randint(c["T"] // 2, c["T"] + 1, c["batch"]).astype(np.int32)
    words = np.zeros((c["batch"], 128), np.int32)
    for i, n in enumerate(lens):
        words[i, :n] = rng.randint(0, c["vocab"], n)
    clf_feeds = {"words": words, "words.lengths": lens}
    gtypes = {"source_language_word":
              T.data_type.integer_value_sequence(LAYERS_S2S["vocab"])}
    gv = T.data_feeder.DataFeeder(gtypes, device="cpu").feed(
        [(r[0],) for r in gen_rows[:LAYERS_S2S["gen_batch"]]])
    gen_feeds = {"source_language_word": gv["source_language_word"].array
                 .numpy(), "source_language_word.lengths":
                 gv["source_language_word"].lengths.numpy()}
    doc, job, local = {}, {}, {}
    old = GLOBAL_FLAGS.get("compute_dtype")
    for name, out, params, feeds, fp32 in (
            ("classifier", clf, clf_params, clf_feeds, False),
            ("generator", gen, gen_params, gen_feeds, True)):
        np.savez(tmp / f"{name}_feeds.npz", **feeds)
        for q in (False, True):
            key = f"{name}{'_int8' if q else ''}"
            path = str(tmp / f"{key}.tar")
            t0 = time.perf_counter()
            merged.save_inference_model(path, out, params, weights_int8=q)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            m = merged.load_inference_model(path, device=dev)
            load_s = time.perf_counter() - t0
            if fp32:
                GLOBAL_FLAGS.set("compute_dtype", "float32")
            try:
                local[key] = m.infer(feeds)[out.name]
            finally:
                GLOBAL_FLAGS.set("compute_dtype", old)
            doc[key] = {"save_s": save_s, "load_s": load_s,
                        "bytes": Path(path).stat().st_size}
            job[key] = {"path": path, "feeds": str(tmp / f"{name}_feeds.npz"),
                        "output": out.name, "out": str(tmp / f"{key}.npy")}
            if name == "generator" and not q and dev.type == "cuda":
                job[key]["capture"] = 2
            if dev.type != "cuda":
                job[key]["device"] = str(dev)
            if name == "classifier" and not q:
                t0 = time.perf_counter()
                m.aot_compile(c["batch"])
                doc[key]["aot_compile_s"] = time.perf_counter() - t0
                first = m.call_exported(feeds)[out.name]
                again = m.call_exported(feeds)[out.name]
                doc[key]["call_exported_bitwise_infer"] = bool(
                    np.array_equal(first, local[key])
                    and np.array_equal(again, local[key]))
                if not doc[key]["call_exported_bitwise_infer"]:
                    fail("layers merged: call_exported differs from infer")
                doc[key]["graphs"] = m._programs[c["batch"]].program.graphs
                doc[key]["call_exported_ms"] = ops_ms(
                    torch, lambda: m.call_exported(feeds))
                doc[key]["infer_ms"] = ops_ms(torch, lambda: m.infer(feeds))
    (tmp / "job.json").write_text(json.dumps(job))
    env = dict(os.environ)
    t0 = time.perf_counter()
    for keys, dtype in ((("classifier", "classifier_int8"), "bfloat16"),
                        (("generator", "generator_int8"), "float32")):
        sub = tmp / f"job_{dtype}.json"
        sub.write_text(json.dumps({k: job[k] for k in keys}))
        env["PADDLE_TPU_COMPUTE_DTYPE"] = dtype
        r = subprocess.run([sys.executable, "-c", MERGED_CHILD,
                            str(Path(__file__).resolve().parent), str(sub)],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("CHILD ")]
        if r.returncode != 0 or not line:
            fail(f"layers merged: the fresh process failed: "
                 f"{r.stderr[-2000:]}")
        child = json.loads(line[0][6:])
        if child.pop("foreign_modules"):
            fail("layers merged: the fresh process imported model code or "
                 "JAX")
        for k in keys:
            doc[k]["fresh_load_s"] = child[k]["load_s"]
            if child[k]["device"] != str(dev):
                fail(f"layers merged {k}: loaded on {child[k]['device']}")
            got = np.load(job[k]["out"])
            want = local[k]
            if got.dtype.kind == "f":
                err = float(np.abs(got - want).max())
                ids_equal = bool(np.array_equal(got.argmax(-1),
                                                want.argmax(-1)))
                doc[k]["fresh_max_abs_err"] = err
                if not (err <= 1e-6 and ids_equal):
                    fail(f"layers merged {k}: fresh process differs "
                         f"({err}, ids equal {ids_equal})")
            else:
                ids_equal = bool(np.array_equal(got, want))
                if not ids_equal:
                    fail(f"layers merged {k}: fresh-process ids differ")
            doc[k]["fresh_ids_equal"] = ids_equal
            if "capture" in child[k]:
                doc[k]["capture"] = child[k]["capture"]
                if not child[k]["capture"].startswith("GraphCaptureError"):
                    fail(f"layers merged {k}: the generator was captured")
    doc["fresh_processes_s"] = time.perf_counter() - t0
    return doc


def layers_phase(torch, dev) -> dict:
    """The ``layers:`` line: the LSTM text classifier, VGG-16 and the
    attention seq2seq through the port's layer API, each against the
    CPU, timed on the card; then the merged artifacts."""
    import paddle_tpu_torch as T
    t0 = time.perf_counter()
    doc = {}
    doc["lstm"], clf, clf_params = layers_lstm(torch, T, dev)
    doc["vgg16"] = layers_vgg(torch, T, dev)
    torch.cuda.empty_cache()
    doc["seq2seq"], gen, gen_params, rows = layers_seq2seq(torch, T, dev)
    doc["merged"] = layers_merged(torch, T, dev, clf, clf_params, gen,
                                  gen_params, rows)
    doc["phase_s"] = time.perf_counter() - t0
    print("layers: " + json.dumps(doc))
    return doc


# ---------------------------------------------------------------------------
# trainer phase: the models and the single-card trainer (``trainer.SGD``,
# ``cli.measure_time``, the CLI's trainer jobs), each network held against
# the CPU (the port's same graph, parameters and rows)
# ---------------------------------------------------------------------------

TRAINER_RESNET = {"image": 224, "classes": 1000, "batch": 128, "warmup": 3,
                  "timed": 20, "train_batches": 6, "momentum": 0.9,
                  "lr": 0.01, "parity_batch": 4}
TRAINER_LSTM = {"vocab": 30000, "emb": 128, "hidden": 256, "T": 100,
                "batch": 64, "batches": 16, "test_batches": 4, "lr": 2e-3}
TRAINER_CTR = {"wide": 1000000, "vocab": 100000, "emb": 64,
               "hidden": (128, 64), "batch": 256, "steps": 6, "lr": 1e-3}
TRAINER_GEN = {"batch": 64, "steps": 3}
# Card-vs-CPU tolerances of the ``trainer:`` phase (fp32 compute, TF32 off on
# both sides; max |card - CPU| over max |CPU| per tensor), fixed before its
# first run: one step's loss 1e-4; CTR's gradients 1e-4 (its Adam's first
# update is a sign where a gradient is near 0, so its updates are printed,
# not gated); GAN and VAE losses per step 1e-4 of max(|loss|, 1); the
# trainer's step against the step composed by hand on the card 1e-5
# (bitwise printed; ResNet-50 at batch 128, bf16, where two steps from one
# state are bitwise equal). ResNet-50 (batch 4): the loss and the model
# state (every batch norm's new statistics) 1e-4, and the gradients of the
# leaves that no convolution or batch norm takes (the head's fc) 1e-3. Its
# other gradients are sums that cancel far below their terms at
# initialisation (batch norm leaves each conv's output gradient zero-mean
# and uncorrelated with its normalized input), so one fp32 step cannot
# resolve them against another fp32 step; they are held layer by layer
# instead (``hold_ops``): every convolution and batch norm of the card's
# step, from the operands and upstream gradient the card saw, against the
# same op in float64 on the CPU, each element of its output, batch
# statistics and gradients within the fp32 rounding bound of ``op_bound``
# (at most 1); each leaf's gradient is the op's, bitwise; and each update
# is -lr times the card's gradient (Momentum's first step from zero
# velocity) within 4 fp32 ulps of |update| + |parameter| per element.
TRAINER_F32_REL = 1e-4
TRAINER_RESNET_REL = 1e-3
TRAINER_HAND_REL = 1e-5
U32 = 2.0 ** -24          # fp32 unit roundoff
TINY32 = 2.0 ** -126      # the least normal fp32: what a flushed denormal loses


@contextlib.contextmanager
def compute_dtype(name):
    """Run with the ``compute_dtype`` flag set to ``name``."""
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    old = GLOBAL_FLAGS.get("compute_dtype")
    GLOBAL_FLAGS.set("compute_dtype", name)
    try:
        yield
    finally:
        GLOBAL_FLAGS.set("compute_dtype", old)


def recording(opt):
    """``opt`` with its ``update`` wrapped to keep a CPU copy of the
    gradients of each call (``opt.seen``)."""
    inner = opt.update
    opt.seen = []

    def update(step, grads, params, state):
        opt.seen.append({k: g.detach().float().cpu() for k, g in
                         grads.items()})
        return inner(step, grads, params, state)
    opt.update = update
    return opt


def op_bound(torch, got, ref, mag, k) -> float:
    """max over the elements of |got - ref| / (gamma_k * mag + k * 2^-126),
    gamma_k = k u / (1 - k u), u = 2^-24. At most 1 wherever ``got`` is
    an fp32 evaluation, in any order, of sums and products of k rounded
    steps whose exact value is ``ref`` and whose terms' absolute values
    sum to ``mag`` (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., §3.1, eq. 3.5), each flushed denormal costing
    at most 2^-126: a bound that cancellation in the sum cannot break."""
    gk = k * U32 / (1 - k * U32)
    err = (got.detach().cpu().double() - ref).abs()
    return float((err / (gk * mag + k * TINY32)).max())


class OpRecorder:
    """While entered, wraps the port's ``ops.conv.conv2d`` and
    ``ops.norm.batch_norm_train`` (and the batch statistics the latter
    computes): each call's operands, output, statistics, upstream
    gradient and operand gradients are copied into ``ops``, the
    gradients by tensor hooks during the step's ``autograd.grad``. Each
    operand goes in as a view of its own, so the gradient kept is this
    op's alone."""

    def __init__(self):
        self.ops = []

    def __enter__(self):
        from paddle_tpu_torch.ops import conv, norm
        self.saved = (conv.conv2d, norm.batch_norm_train, norm._bn_stats)
        conv_fn, bn_fn, stats_fn = self.saved
        ops = self.ops

        def keep(rec, key):
            def hook(g):
                rec[key] = g.detach().clone()
            return hook

        def watched(rec, named):
            """(views of the operands); each operand copied into ``rec``
            under its name (``key`` less its ``d``), its gradient kept
            under ``key``."""
            views = []
            for key, t in named:
                rec[key[1:]] = t.detach().clone()
                v = t.view_as(t)
                if v.requires_grad:
                    v.register_hook(keep(rec, key))
                views.append(v)
            return views

        def conv2d(x, w, **kw):
            rec = {"kind": "conv", "kw": kw, "w_ptr": w.data_ptr()}
            y = conv_fn(*watched(rec, (("dx", x), ("dw", w))), **kw)
            rec["y"] = y.detach().clone()
            y.register_hook(keep(rec, "dy"))
            ops.append(rec)
            return y

        def bn_stats(x, axes, eps):
            mean, var, inv = stats_fn(x, axes, eps)
            if ops and ops[-1]["kind"] == "bn" and "mean" not in ops[-1]:
                ops[-1].update(mean=mean.detach().clone(),
                               var=var.detach().clone(),
                               inv=inv.detach().clone())
            return mean, var, inv

        def batch_norm_train(x, gamma, beta, rm, rv, **kw):
            rec = {"kind": "bn", "kw": kw, "gamma_ptr": gamma.data_ptr(),
                   "beta_ptr": beta.data_ptr()}
            ops.append(rec)
            y, nm, nv = bn_fn(*watched(rec, (("dx", x), ("dgamma", gamma),
                                             ("dbeta", beta))),
                              rm, rv, **kw)
            rec["y"] = y.detach().clone()
            y.register_hook(keep(rec, "dy"))
            return y, nm, nv

        conv.conv2d, norm.batch_norm_train, norm._bn_stats = (
            conv2d, batch_norm_train, bn_stats)
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import conv, norm
        conv.conv2d, norm.batch_norm_train, norm._bn_stats = self.saved


def conv_op_check(torch, op) -> dict:
    """One recorded convolution: its output, input gradient and weight
    gradient on the card against the port's ``conv2d`` in float64 on
    the CPU from the card's operands and upstream gradient (``op_bound``
    per tensor, k = the sum's length + 1: kH kW Cin for the output, kH
    kW Cout for the input gradient, N Ho Wo for the weight gradient),
    beside the same from the CPU's fp32 ``conv2d`` and the card's under
    ``cudnn.deterministic`` (printed, not gated)."""
    from paddle_tpu_torch.ops import conv
    kh, kw_, cin, cout = op["w"].shape
    n, ho, wo = op["y"].shape[:3]
    ks = {"y": kh * kw_ * cin + 1, "dx": kh * kw_ * cout + 1,
          "dw": n * ho * wo + 1}

    def run(x, w, dy):
        x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = conv.conv2d(x, w, **op["kw"])
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        return {"y": y.detach(), "dx": dx, "dw": dw}
    x, w, dy = op["x"], op["w"], op["dy"]
    with compute_dtype(torch.float64):
        ref = run(x.cpu().double(), w.cpu().double(), dy.cpu().double())
        mag = run(x.cpu().double().abs(), w.cpu().double().abs(),
                  dy.cpu().double().abs())
    with compute_dtype("float32"):
        cpu = run(x.cpu(), w.cpu(), dy.cpu())
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            card_det = run(x, w, dy)
        finally:
            torch.backends.cudnn.deterministic = det
    card = {"y": op["y"], "dx": op.get("dx"), "dw": op["dw"]}
    out = {}
    for t in ("y", "dx", "dw"):
        if card[t] is None:          # the stem's input needs no gradient
            continue
        out[t] = {src: op_bound(torch, got[t], ref[t], mag[t], ks[t])
                  for src, got in (("card", card), ("cpu", cpu),
                                   ("card_det", card_det))}
        out[t]["k"] = ks[t]
    return out


def bn_op_check(torch, op) -> dict:
    """One recorded batch norm: its batch mean and variance, output, input
    gradient and gamma / beta gradients on the card against float64 on
    the CPU from the card's operands and upstream gradient (the
    backward from the statistics the card used), by ``op_bound`` with k
    = n + 2 (mean), n + 4 (variance, as E[x^2] - E[x]^2 with m = E[x^2]
    + 3 E[|x|]^2), 6 (output), n + 2 (beta), n + 4 (gamma) and n + 10
    (input gradient), n = the values per channel; beside the same from
    the port's fp32 formulas on the CPU (printed, not gated)."""
    from paddle_tpu_torch.ops import norm
    x = op["x"].cpu().double()
    axes = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    g, b = op["gamma"].cpu().double(), op["beta"].cpu().double()
    dy = op["dy"].cpu().double()
    mean, inv = op["mean"].cpu().double(), op["inv"].cpu().double()
    xh = (x - mean) * inv
    s = g * inv / n
    sdx, sdy = (dy * xh).sum(axes), dy.sum(axes)
    sdx_m, sdy_m = (dy * xh).abs().sum(axes), dy.abs().sum(axes)
    e_abs = x.abs().mean(axes)
    ref = {"mean": x.mean(axes), "var": x.var(axes, unbiased=False),
           "y": xh * g + b, "dbeta": sdy, "dgamma": sdx,
           "dx": s * (n * dy - sdy - xh * sdx)}
    mag = {"mean": e_abs, "var": x.square().mean(axes) + 3 * e_abs ** 2,
           "y": (x.abs() + mean.abs()) * g.abs() * inv + b.abs(),
           "dbeta": sdy_m, "dgamma": sdx_m,
           "dx": s.abs() * (n * dy.abs() + sdy_m + xh.abs() * sdx_m)}
    ks = {"mean": n + 2, "var": n + 4, "y": 6, "dbeta": n + 2,
          "dgamma": n + 4, "dx": n + 10}
    x32, g32 = op["x"].cpu(), op["gamma"].cpu()
    m32, v32, i32 = norm._bn_stats(x32, axes, op["kw"].get("eps", 1e-5))
    cmean, cinv = op["mean"].cpu(), op["inv"].cpu()
    cdx, cdg, cdb = norm.bn_input_grad(op["dy"].cpu(), x32 - cmean, cinv,
                                       g32, axes)
    cpu = {"mean": m32, "var": v32, "dx": cdx, "dgamma": cdg, "dbeta": cdb,
           "y": norm.bn_affine(x32, g32, op["beta"].cpu(), cmean, cinv)}
    out = {}
    for t in ks:
        out[t] = {"card": op_bound(torch, op[t], ref[t], mag[t], ks[t]),
                  "cpu": op_bound(torch, cpu[t], ref[t], mag[t], ks[t]),
                  "k": ks[t]}
    return out


def hold_ops(torch, ops, values, tr, dev, where) -> tuple:
    """Every convolution and batch norm the card's step ran (``ops``, from
    an ``OpRecorder``) against float64 on the CPU (``conv_op_check``,
    ``bn_op_check``): fails where the card's ``op_bound`` passes 1, or a
    leaf's gradient as the optimizer got it (``tr.optimizer.seen``) is
    not its op's bitwise (the space-to-depth stem's through its weight
    transform's gather, from the leaf's value before the step,
    ``values``). Returns (doc, {leaf: op}) for the leaves so held;
    ``where`` names the run in a failure."""
    from paddle_tpu_torch.ops import conv
    seen = tr.optimizer.seen[0]
    ptr = {v.data_ptr(): k for k, v in tr.parameters.values.items()}
    held, rows, missed = {}, [], []

    def wire(k, grad, label):
        if k is None or k in held or not torch.equal(grad.cpu().float(),
                                                     seen[k]):
            fail(f"{where}: leaf {k}'s gradient is not {label}'s "
                 f"op gradient bitwise (or two ops took it)")
        held[k] = label
    for i, op in enumerate(ops):
        if op["kind"] == "conv":
            k = ptr.get(op["w_ptr"])
            if k is not None and values[k].shape == op["w"].shape:
                label = k
                wire(k, op["dw"], label)
            else:                    # the stem: a transform of its leaf
                label = None
                for k, v in values.items():
                    if k in held or v.dim() != 4:
                        continue
                    w0 = v.to(dev).clone().requires_grad_()
                    ws, _ = conv.space_to_depth_conv_transform(w0)
                    if ws.shape == op["w"].shape and torch.equal(
                            ws.detach(), op["w"]):
                        (g,) = torch.autograd.grad(ws, w0, op["dw"])
                        label = f"{k} (s2d)"
                        wire(k, g, label)
                        break
                if label is None:
                    fail(f"{where}: conv op {i}'s weight is no "
                         f"leaf and no leaf's space-to-depth transform")
            res = conv_op_check(torch, op)
        else:
            label = ptr.get(op["gamma_ptr"])
            wire(label, op["dgamma"], label)
            wire(ptr.get(op["beta_ptr"]), op["dbeta"], label)
            res = bn_op_check(torch, op)
        for t, r in res.items():
            rows.append(dict(r, op=label, kind=op["kind"], tensor=t))
            if not r["card"] <= 1.0:
                missed.append(f"{label} {t} {r['card']!r}")
        op.clear()                   # free the op's card copies
    if missed:
        fail(f"{where}: layer by layer, card vs float64 past the "
             f"fp32 bound: {missed[:8]}")

    def top(key, n=6):
        return [{k: r[k] for k in ("op", "tensor", "card", "cpu",
                                   "card_det", "k") if k in r}
                for r in sorted(rows, key=key, reverse=True)[:n]]
    ratio = [r for r in rows if r["cpu"] > 0]
    doc = {"convs": sum(r["kind"] == "conv" and r["tensor"] == "y"
                        for r in rows),
           "batch_norms": sum(r["kind"] == "bn" and r["tensor"] == "y"
                              for r in rows),
           "leaves_held": len(held), "tensors": len(rows),
           "max_card": max(r["card"] for r in rows),
           "max_cpu": max(r["cpu"] for r in rows),
           "max_card_det": max(r.get("card_det", 0.0) for r in rows),
           "worst_card": top(lambda r: r["card"]),
           "card_over_cpu": top(lambda r: r["card"] / r["cpu"]
                                if r["cpu"] > 0 else 0.0)
           if ratio else []}
    return doc, held


def trainer_step_parity(torch, T, label, cost, values, state, make_opt, rows,
                        dev, grad_rel, recorder=None, first_update=None,
                        feeding=None):
    """One trainer step on the CPU and on the card from the same values,
    state and rows (fp32): the loss and the model state, card against
    CPU, and the gradients the optimizer got within ``grad_rel``
    (printed only where None); each parameter's update is printed.
    ``recorder``: an ``OpRecorder`` the card's step runs in, whose ops
    are then held layer by layer (``hold_ops``), and the leaves they hold
    are left out of the whole-network gradient gate. ``first_update(g)``:
    the exact update of a parameter whose gradient is ``g``; each of the
    card's updates is then held against it, from the card's gradient.
    ``feeding``: the rows' slots by data layer. Returns (doc, card
    trainer)."""
    from paddle_tpu_torch.ops import prng
    doc, missed, runs = {}, [], {}
    specs = T.topology.Topology(cost).param_specs()
    for tag, where in (("card", dev), ("cpu", "cpu")):
        p = T.parameters.Parameters(specs, device=where)
        p.values = {k: v.detach().to(where).clone() for k, v in values.items()}
        p.state = {k: v.detach().to(where).clone() for k, v in state.items()}
        tr = T.trainer.SGD(cost, p, recording(make_opt()))
        feeds = tr._feeder(feeding).feed(rows)
        t0 = time.perf_counter()
        with (recorder if recorder is not None and tag == "card"
              else contextlib.nullcontext()):
            loss, _ = tr._plain_train_step(feeds, 0, prng.prng_key(0))
            loss = float(loss)
        runs[tag] = (tr, loss, time.perf_counter() - t0)
    card, cpu = runs["card"], runs["cpu"]
    doc["loss"] = [card[1], cpu[1]]
    doc["loss_rel"] = abs(card[1] - cpu[1]) / max(abs(cpu[1]), 1e-30)
    doc["cpu_step_s"] = cpu[2]
    if not doc["loss_rel"] <= TRAINER_F32_REL:
        fail(f"trainer {label}: loss card vs CPU relative error "
             f"{doc['loss_rel']!r} > {TRAINER_F32_REL!r}")
    doc["state_rel"] = 0.0
    for k in state:
        err = rel_err(torch, card[0].parameters.state[k].cpu().float(),
                      cpu[0].parameters.state[k].float())
        doc["state_rel"] = max(doc["state_rel"], err)
    if not doc["state_rel"] <= TRAINER_F32_REL:
        fail(f"trainer {label}: model state card vs CPU relative error "
             f"{doc['state_rel']!r} > {TRAINER_F32_REL!r}")
    held = {}
    if recorder is not None:
        t0 = time.perf_counter()
        doc["by_op"], held = hold_ops(torch, recorder.ops, values,
                                      card[0], dev, f"trainer {label}")
        doc["by_op"]["s"] = time.perf_counter() - t0

    def update(tr, k, before):
        return tr.parameters.values[k].detach().cpu().double() - before
    gworst, hworst, uworst, fworst = (0.0, None), 0.0, 0.0, 0.0
    gc, gp = card[0].optimizer.seen[0], cpu[0].optimizer.seen[0]
    for k, v0 in values.items():
        if not torch.isfinite(gc[k]).all():
            fail(f"trainer {label}: non-finite gradient {k} on the card")
        err = rel_err(torch, gc[k], gp[k])
        if k in held:
            gworst = max(gworst, (err, k), key=lambda e: e[0])
        else:
            hworst = max(hworst, err)
            if grad_rel is not None and not err <= grad_rel:
                missed.append(f"gradient {k} {err!r}")
        before = v0.detach().cpu().double()
        dp = update(cpu[0], k, before)
        diff = float((update(card[0], k, before) - dp).abs().max())
        uworst = max(uworst, diff / max(float(dp.abs().max()), 1e-30)
                     if diff else 0.0)
        if first_update is not None:
            want = first_update(gc[k].double())
            bound = 4 * U32 * (want.abs() + before.abs()) + TINY32
            r = float(((update(card[0], k, before) - want).abs()
                       / bound).max())
            fworst = max(fworst, r)
            if not r <= 1.0:
                missed.append(f"update {k} {r!r} of its bound")
    doc["grads_rel"] = hworst
    doc["updates_rel"] = uworst
    if held:
        doc["held_grads_rel"] = {"max": gworst[0], "leaf": gworst[1]}
    if first_update is not None:
        doc["updates_over_bound"] = fworst
    if missed:
        fail(f"trainer {label}: card vs CPU: {missed[:8]} ({doc})")
    return doc, card[0]


def hand_step(torch, T, tr, feeds, key, step, make_opt) -> dict:
    """The trainer's plain step against the same step composed by hand
    (forward, ``autograd.grad``, ``optimizer.update``) from the same
    values, state and optimizer state, on the card."""
    values = {k: v.detach().clone() for k, v in tr.parameters.values.items()}
    state = {k: v.detach().clone() for k, v in tr.parameters.state.items()}
    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              values.items()}
    outs, new_state = tr._forward(leaves, state, feeds, is_training=True,
                                  dropout_key=key)
    loss = outs[tr.cost.name].array.float().mean()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                 allow_unused=True)))
    loss = loss.detach()
    opt = make_opt()
    opt.bind(tr.topology.param_specs())
    hand = {k: v.detach().clone() for k, v in values.items()}
    opt_state = {k: tuple(x.clone() for x in s) if isinstance(s, tuple)
                 else s.clone() for k, s in tr.opt_state.items()}
    opt.update(step, grads, hand, opt_state)
    tl, _ = tr._plain_train_step(feeds, step, key)
    doc = {"loss_rel": abs(float(tl) - float(loss)) / abs(float(loss)),
           "bitwise": bool(float(tl) == float(loss)) and all(
               torch.equal(tr.parameters.values[k], hand[k]) for k in hand)
           and all(torch.equal(tr.parameters.state[k], new_state[k].detach())
                   for k in new_state)}
    doc["params_rel"] = max(rel_err(torch, tr.parameters.values[k].cpu(),
                                    hand[k].cpu()) for k in hand)
    if not (doc["loss_rel"] <= TRAINER_HAND_REL
            and doc["params_rel"] <= TRAINER_HAND_REL):
        fail(f"trainer: the trainer's step differs from the hand-composed "
             f"step: {doc}")
    return doc


def resnet50_cost(T, fused_bn=False):
    """``benchmarks/configs/resnet50.py``'s graph through the port's
    ``models.resnet``: 3x224x224 fed flat CHW, 1000 classes, the
    space-to-depth stem, ``fused_bn`` off (or the given mode)."""
    from paddle_tpu_torch.models import resnet
    c = TRAINER_RESNET
    L, dt = T.layer, T.data_type
    img = L.data("image", dt.dense_vector(3 * c["image"] ** 2))
    lbl = L.data("label", dt.integer_value(c["classes"]))
    out = resnet.resnet_imagenet(img, depth=50, class_num=c["classes"],
                                 stem_space_to_depth=True, fused_bn=fused_bn)
    return L.classification_cost(out, lbl, name="cost")


def median_of(recs, key):
    vals = [r[key] for r in recs if r.get(key) is not None]
    return float(np.median(vals)) if vals else None


def trainer_resnet(torch, T, tcli, dev) -> dict:
    """ResNet-50 at batch 128, bf16: ``cli.measure_time`` (3 warm-up, 20
    timed batches), ``SGD.train`` over a synthetic reader (the step
    monitor's records), two identical steps compared bitwise, the
    trainer's step against the hand-made one and one step under the
    profiler, then, fp32 at batch 4, one step card vs CPU, layer by layer
    against float64."""
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.utils.rng import KeySource
    c = TRAINER_RESNET
    B, d = c["batch"], 3 * c["image"] ** 2
    cost = resnet50_cost(T)
    topo = T.topology.Topology(cost)
    doc = {"params": int(sum(int(np.prod(s.shape))
                             for s in topo.param_specs())),
           "bn_layers": sum(l.layer_type == "batch_norm"
                            for l in topo.layers),
           "batch": B}
    rng = np.random.RandomState(0)
    samples = [(rng.rand(d).astype(np.float32), int(rng.randint(
        c["classes"]))) for _ in range(2 * B)]

    def momentum():
        return T.optimizer.Momentum(momentum=c["momentum"],
                                    learning_rate=c["lr"])
    cfg = {"cost": cost, "reader": lambda: iter(samples), "batch_size": B,
           "optimizer": momentum()}
    T.init(seed=5)
    t = tcli.measure_time(cfg, time_batches=c["timed"],
                          warmup_batches=c["warmup"], device=dev)
    doc["measure_time"] = {
        "ms_per_batch": t["ms_per_batch"],
        "images_per_s": t["examples_per_sec"],
        "flops_per_image": t["flops_per_batch"] / B,
        "mfu": t["mfu"], "peak_memory_bytes": t["peak_memory_bytes"],
        "compile_plus_warmup_s": t["compile_plus_warmup_s"],
        "last_cost": t["last_cost"]}
    if not np.isfinite(t["last_cost"]):
        fail(f"trainer resnet50: non-finite cost {t['last_cost']}")
    torch.cuda.empty_cache()

    # SGD.train over pre-batched columns (two batches, cycled)
    params = T.parameters.create(topo, KeySource(5), device=dev)
    init_values = {k: v.detach().cpu().clone()
                   for k, v in params.values.items()}
    init_state = {k: v.detach().cpu().clone()
                  for k, v in params.state.items()}
    tr = T.trainer.SGD(cost, params, momentum())
    cols = [(np.stack([s[0] for s in samples[i * B:(i + 1) * B]]),
             np.array([s[1] for s in samples[i * B:(i + 1) * B]], np.int32))
            for i in range(2)]
    recs, costs = [], []
    T.observe.add_report_handler(recs.append)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        tr.train(lambda: iter([cols[i % 2]
                               for i in range(c["train_batches"])]),
                 event_handler=lambda e: costs.append(e.cost) if isinstance(
                     e, T.event.EndIteration) else None)
    finally:
        T.observe.remove_report_handler(recs.append)
    steps = [r for r in recs if r.get("kind") == "step"]
    warm = steps[1:]
    doc["train"] = {
        "steps": len(steps), "costs": costs,
        "step_ms_p50": 1e3 * median_of(warm, "wall_time_s"),
        "images_per_s_p50": median_of(warm, "examples_per_sec"),
        "mfu_p50": median_of(warm, "mfu"),
        "first_step_ms": 1e3 * steps[0]["wall_time_s"],
        "feed_ms_p50": 1e3 * median_of(warm, "feed_s"),
        "dispatch_ms_p50": 1e3 * median_of(warm, "dispatch_s"),
        "sync_ms_p50": 1e3 * median_of(warm, "sync_s"),
        "bottleneck": [r["bottleneck"] for r in warm],
        "compile_count": steps[-1]["compile_count"],
        "step_flops": tr._step_flops and next(iter(
            tr._step_flops.values())),
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated(
            dev))}
    if len(steps) != c["train_batches"] or not all(
            np.isfinite(costs)) or steps[-1]["compile_count"] != 1:
        fail(f"trainer resnet50: SGD.train ran {len(steps)} steps, costs "
             f"{costs}, compile_count {steps[-1]['compile_count']}")

    # two identical steps from one state (bitwise?), then the trainer's
    # step against the step composed by hand from that state
    feeds = tr._feeder(None).feed(cols[0])
    key = prng.prng_key(1)
    snap = ({k: v.clone() for k, v in tr.parameters.values.items()},
            {k: v.clone() for k, v in tr.parameters.state.items()},
            {k: tuple(x.clone() for x in s) if isinstance(s, tuple)
             else s.clone() for k, s in tr.opt_state.items()})

    def restore():
        for k, v in snap[0].items():
            tr.parameters.values[k].copy_(v)
        tr.parameters.state = {k: v.clone() for k, v in snap[1].items()}
        tr.opt_state = {k: tuple(x.clone() for x in s)
                        if isinstance(s, tuple) else s.clone()
                        for k, s in snap[2].items()}
    outs = []
    for _ in range(2):
        restore()
        loss, _ = tr._plain_train_step(feeds, tr._step, key)
        outs.append((float(loss), {k: v.clone() for k, v in
                                   tr.parameters.values.items()}))
    doc["repeat"] = {
        "loss_equal": outs[0][0] == outs[1][0],
        "params_bitwise": all(torch.equal(outs[0][1][k], outs[1][1][k])
                              for k in outs[0][1]),
        "params_max_abs_diff": max(float((outs[0][1][k] - outs[1][1][k])
                                         .abs().max()) for k in outs[0][1]),
        "cudnn_deterministic": bool(torch.backends.cudnn.deterministic)}
    del outs
    restore()
    doc["hand_step"] = hand_step(torch, T, tr, feeds, key, tr._step,
                                 momentum)
    # the device's busy share of one more step, under the profiler
    restore()
    doc["profile"] = profile_window(
        torch, lambda: float(tr._plain_train_step(feeds, tr._step, key)[0]))
    del tr, params, snap, feeds
    torch.cuda.empty_cache()

    # fp32 at batch 4: the card against the CPU
    with compute_dtype("float32"):
        doc["parity"], _ = trainer_step_parity(
            torch, T, "resnet50", cost, init_values, init_state, momentum,
            samples[:c["parity_batch"]], dev, TRAINER_RESNET_REL,
            recorder=OpRecorder(), first_update=lambda g: -c["lr"] * g)
    return doc


def trainer_lstm(torch, T, dev) -> dict:
    """The LSTM text classifier at ``benchmarks/configs/lstm.py``'s widths
    through ``SGD.train`` (one pass of separable synthetic rows: the label
    picks the half of the vocabulary the tokens come from) with a
    classification-error evaluator, then ``SGD.test``: the loss must fall.
    Every other token of a row is one of 50 ids that its label owns (ids
    0..49 for label 0, 50..99 for label 1), the rest drawn over the whole
    vocabulary."""
    from paddle_tpu_torch.utils.rng import KeySource
    c = TRAINER_LSTM
    out, cost, evals = lstm_classifier(T)
    params = T.parameters.create(T.topology.Topology([cost] + evals[:1]),
                                 KeySource(9), device=dev)
    tr = T.trainer.SGD(cost, params,
                       T.optimizer.Adam(learning_rate=c["lr"]),
                       extra_layers=evals[:1])
    rng = np.random.RandomState(4)

    def rows(n):
        out = []
        for _ in range(n):
            y = int(rng.randint(2))
            t = rng.randint(0, c["vocab"], c["T"])
            t[::2] = 50 * y + rng.randint(0, 50, (c["T"] + 1) // 2)
            out.append(([int(v) for v in t], y))
        return out
    train_rows = rows(c["batch"] * c["batches"])
    test_rows = rows(c["batch"] * c["test_batches"])
    recs, costs = [], []
    T.observe.add_report_handler(recs.append)
    try:
        tr.train(T.batch(lambda: iter(train_rows), c["batch"]),
                 event_handler=lambda e: costs.append(e.cost) if isinstance(
                     e, T.event.EndIteration) else None)
    finally:
        T.observe.remove_report_handler(recs.append)
    steps = [r for r in recs if r.get("kind") == "step"][1:]
    res = tr.test(T.batch(lambda: iter(test_rows), c["batch"]))
    doc = {"steps": len(costs), "first_costs": costs[:4],
           "last_costs": costs[-4:],
           "step_ms_p50": 1e3 * median_of(steps, "wall_time_s"),
           "dispatch_ms_p50": 1e3 * median_of(steps, "dispatch_s"),
           "sync_ms_p50": 1e3 * median_of(steps, "sync_s"),
           "test_cost": res.cost, "test_error": float(res.metrics["err"]),
           "train_error": float(tr.evaluators.result()["err"])}
    if not (np.all(np.isfinite(costs))
            and np.mean(costs[-4:]) < np.mean(costs[:4])):
        fail(f"trainer lstm: the loss did not fall over one pass: {costs}")
    return doc


def trainer_ctr(torch, T, dev) -> dict:
    """CTR wide&deep at ``benchmarks/configs/ctr.py``'s widths: one step
    held against the CPU (fp32), then ``SGD.train`` for a few batches with
    Adam on the card (ms/batch, peak memory)."""
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.utils.rng import KeySource
    c = TRAINER_CTR
    out, cost = ctr.ctr_wide_deep(c["wide"], c["vocab"], emb_dim=c["emb"],
                                  hidden=c["hidden"])
    topo = T.topology.Topology(cost)
    params = T.parameters.create(topo, KeySource(7), device=dev)
    reader = ctr.synthetic_reader(c["wide"], c["vocab"],
                                  n=c["batch"] * c["steps"])
    rows = list(reader())
    doc = {"params": int(sum(v.numel() for v in params.values.values()))}

    def adam():
        return T.optimizer.Adam(learning_rate=c["lr"])
    with compute_dtype("float32"):
        doc["parity"], _ = trainer_step_parity(
            torch, T, "ctr", cost, params.values, params.state, adam,
            rows[:c["batch"]], dev, TRAINER_F32_REL)
    tr = T.trainer.SGD(cost, params, adam())
    recs, costs = [], []
    T.observe.add_report_handler(recs.append)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        tr.train(T.batch(lambda: iter(rows), c["batch"]),
                 event_handler=lambda e: costs.append(e.cost) if isinstance(
                     e, T.event.EndIteration) else None)
    finally:
        T.observe.remove_report_handler(recs.append)
    steps = [r for r in recs if r.get("kind") == "step"][1:]
    doc.update({"costs": costs,
                "step_ms_p50": 1e3 * median_of(steps, "wall_time_s"),
                "feed_ms_p50": 1e3 * median_of(steps, "feed_s"),
                "max_memory_allocated_bytes": int(
                    torch.cuda.max_memory_allocated(dev))})
    if not np.all(np.isfinite(costs)) or len(costs) != c["steps"]:
        fail(f"trainer ctr: costs {costs}")
    return doc


def trainer_gen(torch, dev) -> dict:
    """GAN and VAE at their config defaults, batch 64: the card's trainer
    and the CPU's from the same weights and keys, each step's losses held
    within 1e-4 of max(|loss|, 1)."""
    from paddle_tpu_torch.models import gan, vae
    from paddle_tpu_torch.ops import prng
    c = TRAINER_GEN
    rng = np.random.RandomState(6)
    doc = {}
    for name, mod, cfg in (("gan", gan, gan.GANConfig()),
                           ("vae", vae, vae.VAEConfig())):
        make = gan.GANTrainer if name == "gan" else vae.VAETrainer
        cpu = make(cfg, prng.prng_key(0), device="cpu")
        card = make(cfg, prng.prng_key(0), device=dev)
        card.params = mod.tree_from_numpy(mod.tree_to_numpy(cpu.params), dev)
        worst, losses, ms = 0.0, [], []
        for i in range(c["steps"]):
            if name == "gan":
                x = (0.7 + 0.05 * rng.randn(c["batch"], cfg.sample_dim))
            else:
                x = rng.rand(c["batch"], cfg.x_dim) > 0.5
            x = x.astype(np.float32)
            a = np.atleast_1d(cpu.train_batch(prng.prng_key(10 + i), x))
            t0 = time.perf_counter()
            b = np.atleast_1d(card.train_batch(prng.prng_key(10 + i), x))
            ms.append(1e3 * (time.perf_counter() - t0))
            err = float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)))
            worst = max(worst, err)
            losses.append(b.tolist())
        doc[name] = {"losses": losses, "loss_rel": worst,
                     "step_ms": ms}
        if not worst <= TRAINER_F32_REL:
            fail(f"trainer {name}: card vs CPU loss error {worst!r} > "
                 f"{TRAINER_F32_REL!r}")
    return doc


TRAINER_CLI_SMALLNET = """
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer
from paddle_tpu_torch.models import smallnet

img = layer.data("image", paddle.data_type.dense_vector(3 * 32 * 32))
lbl = layer.data("label", paddle.data_type.integer_value(10))
out = smallnet.smallnet(img)
cost = layer.classification_cost(out, lbl, name="cost")
batch_size = 64
_rng = np.random.RandomState(0)
_data = [(_rng.rand(3 * 32 * 32).astype("float32"), int(_rng.randint(10)))
         for _ in range(256)]


def reader():
    return iter(_data)
"""

TRAINER_CLI_FC = """
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer

x = layer.data("x", paddle.data_type.dense_vector(16))
y = layer.data("y", paddle.data_type.integer_value(4))
h = layer.fc(x, 8, act=paddle.activation.Tanh(), name="cg_h")
out = layer.fc(h, 4, act=paddle.activation.Softmax(), name="cg_out")
cost = layer.classification_cost(out, y, name="cost")
batch_size = 8
_rng = np.random.RandomState(0)
_data = [(_rng.rand(16).astype("float32"), int(_rng.randint(4)))
         for _ in range(32)]


def reader():
    return iter(_data)
"""


def trainer_cli() -> dict:
    """``python -m paddle_tpu_torch time`` and ``train`` on a smallnet
    config at CIFAR shapes, and ``checkgrad`` on a small tanh fc net (fp32
    compute), three processes on the card at once, seed 1; each must exit
    0."""
    root = str(Path(__file__).resolve().parent)
    # a fixed seed: the jobs draw their parameters from the global key
    env = dict(os.environ, PYTHONPATH=root, PADDLE_TPU_SEED="1")
    doc = {}
    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "smallnet.py").write_text(TRAINER_CLI_SMALLNET)
        Path(tmp, "fc.py").write_text(TRAINER_CLI_FC)
        jobs = {
            "time": (["time", "--config=smallnet.py", "--time_batches=10",
                      "--warmup_batches=2"], env),
            "train": (["train", "--config=smallnet.py", "--num_passes=1",
                       "--save_dir=out"], env),
            # central differences of an fp32 cost: eps 1e-2 keeps their
            # rounding (~1e-7 of the cost over eps) below the 2e-2 bar
            "checkgrad": (["checkgrad", "--config=fc.py",
                           "--checkgrad_eps=1e-2"],
                          dict(env, PADDLE_TPU_COMPUTE_DTYPE="float32")),
        }
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch"] + argv, cwd=tmp,
            env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for k, (argv, e) in jobs.items()}
        for k, p in procs.items():
            try:
                out, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            doc[k] = {"rc": p.returncode,
                      "s": time.perf_counter() - t0,
                      "last": out.strip().splitlines()[-1:] if out else []}
            if p.returncode != 0:
                fail(f"trainer cli: {k} exited {p.returncode}: "
                     f"{out[-2000:]} {err[-2000:]}")
        if not Path(tmp, "out", "pass-00000", "params.tar").exists():
            fail("trainer cli: train wrote no out/pass-00000/params.tar")
    return doc


def trainer_phase(torch, dev) -> dict:
    """The ``trainer:`` line: ResNet-50, the LSTM classifier, CTR, GAN and
    VAE through the port's models and trainers, and the CLI's trainer
    jobs. None of the port's CUDA kernels runs here: their launch counts
    are read around the phase."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch import cli as tcli
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    before = kernels.launch_counts()
    doc = {"resnet50": trainer_resnet(torch, T, tcli, dev)}
    torch.cuda.empty_cache()
    doc["lstm"] = trainer_lstm(torch, T, dev)
    doc["ctr"] = trainer_ctr(torch, T, dev)
    torch.cuda.empty_cache()
    doc.update(trainer_gen(torch, dev))
    doc["cli"] = trainer_cli()
    after = kernels.launch_counts()
    doc["port_kernel_launches"] = sum(after[k] - before.get(k, 0)
                                      for k in after)
    doc["phase_s"] = time.perf_counter() - t0
    print("trainer: " + json.dumps(doc))
    return doc


# ---------------------------------------------------------------------------
# input pipeline and checkpoints phase
# ---------------------------------------------------------------------------

# ``input:`` phase sizes: 2048 uint8 images 256x256x3 in 4 recordio shards
# (chunks of 64 records), the 224 crop fed to ResNet-50 (bf16, batch 128,
# PR 15's ``trainer:`` configuration) through a Pipeline of 4 transform
# workers, a 512-sample shuffle and a 3-batch staging ring; 3 warm-up and
# 20 timed batches; checkpoints every 5 batches; the resume gates train 12
# steps and crash at step 7
INPUT = {"images": 2048, "side": 256, "crop": 224, "classes": 1000,
         "shards": 4, "chunk": 64, "batch": 128, "warmup": 3, "timed": 20,
         "workers": 4, "shuffle": 512, "prefetch": 3, "period": 5,
         "steps": 12, "crash": 7, "seed": 16}
# the resume gate's MLP: fully connected layers only (cuBLAS at fixed
# shapes), 12 batches of 64 an epoch
INPUT_MLP = {"dims": (784, 512, 512, 10), "batch": 64, "rows": 768,
             "shuffle": 128, "lr": 0.05}
# ImageNet's channel mean and standard deviation, on 0..255 pixels
IMAGE_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
IMAGE_INV_STD = 1.0 / (np.array([0.229, 0.224, 0.225], np.float32) * 255.0)


class _Stop(Exception):
    """Raised from an event handler to end a run at a given step."""


def image_shards(tmp, c) -> list:
    """``c["shards"]`` recordio shards of (uint8 image [side, side, 3],
    label, id) records drawn from a seeded numpy generator."""
    from paddle_tpu_torch.runtime import recordio
    rng = np.random.default_rng(c["seed"])
    per, side = c["images"] // c["shards"], c["side"]
    paths = []
    for s in range(c["shards"]):
        imgs = rng.integers(0, 256, (per, side, side, 3), dtype=np.uint8)
        labels = rng.integers(0, c["classes"], per)
        p = str(Path(tmp, f"img-{s:05d}.rio"))
        with recordio.Writer(p, records_per_chunk=c["chunk"]) as w:
            for i in range(per):
                w.write((imgs[i], int(labels[i]), s * per + i))
        paths.append(p)
    return paths


def augment(sample, crop: int):
    """A random ``crop`` x ``crop`` window and a random horizontal flip,
    drawn from the sample's id (the same output whenever the sample is
    transformed again, as a resumed pipeline does), then normalized and
    laid out as flat CHW float32."""
    img, label, sid = sample
    r = np.random.default_rng(sid)
    y, x = r.integers(0, img.shape[0] - crop + 1, 2)
    v = img[y:y + crop, x:x + crop]
    if r.random() < 0.5:
        v = v[:, ::-1]
    v = (v.astype(np.float32) - IMAGE_MEAN) * IMAGE_INV_STD
    return (np.ascontiguousarray(v.transpose(2, 0, 1)).reshape(-1), label,
            sid)


def image_pipe(T, shards, c, prefetch=None):
    """The phase's Pipeline: seeded chunk order, ``augment`` on
    ``c["workers"]`` threads, a seeded streaming shuffle, batches."""
    import functools
    P = T.pipeline
    return P.Pipeline(
        P.ShardSource(shards, shuffle_chunks=True, seed=c["seed"]),
        transform=functools.partial(augment, crop=c["crop"]),
        transform_workers=c["workers"], shuffle_size=c["shuffle"],
        seed=c["seed"], batch_size=c["batch"],
        prefetch=c["prefetch"] if prefetch is None else prefetch)


def image_sync_reader(T, shards, c, epochs=2):
    """The same batch stream as ``image_pipe``'s first ``epochs`` epochs,
    made on the calling thread (the stages run inline): the reader
    ``prefetch=0`` feeds from."""
    P = T.pipeline

    def reader():
        src = P.ShardSource(shards, shuffle_chunks=True, seed=c["seed"])
        shuffle = P.ShuffleStage(c["shuffle"], c["seed"])
        batch = P.BatchStage(c["batch"])
        for _ in range(epochs):
            stream = (augment(s, c["crop"]) for s in src)
            yield from batch.feed(shuffle.feed(stream))
    return reader


def batch_ids(pipe, n) -> list:
    """The sample ids of ``pipe``'s next ``n`` batches (host batches),
    across epochs; the pipeline is closed after."""
    out = []
    with pipe:
        while len(out) < n:
            for b in iter(pipe):
                out.append([int(s[2]) for s in b])
                if len(out) == n:
                    break
    return out


def loader_check(T, shards) -> dict:
    """The native loader: built, taken, and byte-for-byte the records of
    ``recordio.read_records`` on one shard."""
    from paddle_tpu_torch.runtime import loader, native, recordio
    if native.get() is None:
        fail("input: runtime.native.get() is None: the native record "
             "codec did not build")
    ld = loader.PrefetchLoader(shards[0], num_threads=1)
    t0 = time.perf_counter()
    got = list(ld)
    load_s = time.perf_counter() - t0
    want = list(recordio.read_records(shards[0]))
    same = len(got) == len(want) and all(
        a[0].tobytes() == b[0].tobytes() and a[1:] == b[1:]
        for a, b in zip(got, want))
    doc = {"native_loader": ld.path_taken == "native", "records": len(got),
           "records_equal": same,
           "loader_mb_per_s": sum(r[0].nbytes for r in got) / load_s / 1e6}
    if not (doc["native_loader"] and same):
        fail(f"input: native loader check failed: {doc}")
    return doc


def timed_run(torch, T, tr, reader, c, n_batches, pipe=None) -> dict:
    """``tr.train(reader)`` for ``n_batches`` (whole passes of the
    reader); the images/s of the batches after the warm-up, the step
    monitor's medians and, for a Pipeline, the ring depths seen at each
    step."""
    marks, recs, depths = [], [], []

    def h(e):
        if isinstance(e, T.event.EndIteration):
            marks.append(time.perf_counter())
            if pipe is not None and pipe._ring is not None:
                depths.append((pipe._ring.qsize(), pipe._out.qsize()))
    T.observe.add_report_handler(recs.append)
    try:
        tr.train(reader, num_passes=n_batches // (c["images"] // c["batch"])
                 if pipe is not None else 1, event_handler=h)
    finally:
        T.observe.remove_report_handler(recs.append)
    w, n = c["warmup"], c["timed"]
    if len(marks) < w + n:
        fail(f"input: the run gave {len(marks)} batches, want {w + n}")
    steps = [r for r in recs if r.get("kind") == "step"][w:w + n]
    window_s = marks[w + n - 1] - marks[w - 1]
    feed = [r["feed_s"] for r in steps]
    doc = {"batches": len(marks),
           "images_per_s": n * c["batch"] / window_s,
           "window_s": window_s,
           "feed_ms_p50": 1e3 * median_of(steps, "feed_s"),
           "feed_ms_max": 1e3 * max(feed), "feed_s_sum": sum(feed),
           "steps_s_sum": sum(r["wall_time_s"] for r in steps),
           "dispatch_ms_p50": 1e3 * median_of(steps, "dispatch_s"),
           "sync_ms_p50": 1e3 * median_of(steps, "sync_s"),
           "step_ms_p50": 1e3 * median_of(steps, "wall_time_s")}
    if depths:
        ring, out = zip(*depths[w:w + n])
        doc["ring_depth"] = {"median": float(np.median(ring)),
                             "min": min(ring), "max": max(ring),
                             "capacity": pipe.prefetch}
        doc["device_depth"] = {"median": float(np.median(out)),
                               "min": min(out), "max": max(out),
                               "capacity": pipe.device_depth}
    return doc


def d2h_gb_per_s(torch, dev, nbytes=256 << 20) -> float:
    """Device->host bandwidth into pinned memory (CUDA events, median of
    5 copies of ``nbytes``)."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    ts = []
    for _ in range(6):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / 1e3)
    return nbytes / float(np.median(ts[1:])) / 1e9


def state_of(tr) -> dict:
    """A trainer's parameters, optimizer state and model state, cloned."""
    def c(t):
        return {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                    else v.clone()) for k, v in t.items()}
    return {"values": c(tr.parameters.values), "opt": c(tr.opt_state),
            "state": c(tr.parameters.state)}


def states_equal(torch, a, b) -> bool:
    for g in ("values", "opt", "state"):
        if set(a[g]) != set(b[g]):
            return False
        for k in a[g]:
            x, y = a[g][k], b[g][k]
            xs, ys = (x, y) if isinstance(x, tuple) else ((x,), (y,))
            if not all(torch.equal(p, q) for p, q in zip(xs, ys)):
                return False
    return True


def train_until(T, tr, pipe, n, ckpt_dir=None) -> None:
    """Train ``tr`` over ``pipe`` until its step counter reaches ``n``
    (or a chaos rule fires); the pipeline is closed after."""
    def h(e):
        if isinstance(e, T.event.EndIteration) and tr._step >= n:
            raise _Stop
    try:
        tr.train(reader=pipe, num_passes=100, event_handler=h,
                 checkpoint_dir=ckpt_dir)
    except _Stop:
        pass
    finally:
        pipe.close()


def resume_gate(torch, T, label, make_trainer, make_pipe, c, tmp,
                repeat=False) -> dict:
    """The preemption contract on the card: ``c["steps"]`` steps
    uninterrupted; the same job with checkpoints every ``c["period"]``
    steps and a ``crash@step`` chaos rule at ``c["crash"]``, resumed in a
    fresh SGD from the checkpoint dir and the pipeline state. The final
    parameters, optimizer state and model state must be bitwise equal,
    and so must the ids of the batch stream (the checkpoint's pipeline
    state continues the uninterrupted stream). ``repeat``: first check
    that two uninterrupted runs are bitwise equal; the gate holds only
    where they are."""
    from paddle_tpu_torch.io import checkpoint as ckpt_io
    from paddle_tpu_torch.runtime import chaos
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    n, k, period = c["steps"], c["crash"], c["period"]
    doc = {"steps": n, "crash_at": k, "period": period}
    T.init(seed=7)
    tr = make_trainer()
    train_until(T, tr, make_pipe(), n)
    full = state_of(tr)
    del tr
    gated = True
    if repeat:
        T.init(seed=7)
        tr = make_trainer()
        train_until(T, tr, make_pipe(), n)
        doc["resnet_repeat_bitwise"] = gated = states_equal(
            torch, full, state_of(tr))
        del tr
    d = str(Path(tmp, f"resume_{label}"))
    old = GLOBAL_FLAGS.get("checkpoint_period")
    GLOBAL_FLAGS.set("checkpoint_period", period)
    os.environ[chaos.ENV_VAR] = f"crash@step:step={k}"
    chaos.reset()
    try:
        T.init(seed=7)
        tr = make_trainer()
        try:
            train_until(T, tr, make_pipe(), n, ckpt_dir=d)
            doc["crashed"] = False
        except chaos.ChaosError:
            doc["crashed"] = True
        doc["crashed_at_step"] = tr._step
        del tr
        os.environ.pop(chaos.ENV_VAR)
        chaos.reset()
        latest = ckpt_io.latest_checkpoint(d)
        doc["restored_from"] = Path(latest).name if latest else None
        T.init(seed=7)
        tr = make_trainer()
        t0 = time.perf_counter()
        train_until(T, tr, make_pipe(), n, ckpt_dir=d)
        doc["resume_run_s"] = time.perf_counter() - t0
        doc["restore_s"] = tr._acct.snapshot()["buckets"]["restore"]
        resumed = state_of(tr)
        doc["final_step"] = tr._step
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        chaos.reset()
        GLOBAL_FLAGS.set("checkpoint_period", old)
    doc["state_bitwise"] = states_equal(torch, full, resumed)
    # the stream: the checkpoint's pipeline state continues it exactly
    want = batch_ids(make_pipe(), n)
    pipe = make_pipe()
    pipe.load_state_dict(ckpt_io.load_pipeline_state(latest))
    got = want[:int(doc["restored_from"][5:])] if latest else []
    got += batch_ids(pipe, n - len(got))
    doc["ids_equal"] = got == want
    ok = (doc["crashed"] and doc["crashed_at_step"] == k
          and doc["restored_from"] == f"ckpt-{(k // period) * period:08d}"
          and doc["final_step"] == n and doc["ids_equal"])
    if not ok or (gated and not doc["state_bitwise"]):
        fail(f"input: resume gate {label} failed: {doc}")
    doc["gate"] = "held" if gated else "skipped: two runs differ"
    return doc


def mlp_shards(tmp, c) -> list:
    """Two recordio shards of (float32[784], label, id) rows."""
    from paddle_tpu_torch.runtime import recordio
    m = INPUT_MLP
    rng = np.random.default_rng(c["seed"] + 1)
    x = rng.random((m["rows"], m["dims"][0]), dtype=np.float32)
    y = rng.integers(0, m["dims"][-1], m["rows"])
    paths, half = [], m["rows"] // 2
    for s in range(2):
        p = str(Path(tmp, f"mlp-{s:05d}.rio"))
        recordio.write_records(p, ((x[i], int(y[i]), i) for i in range(
            s * half, (s + 1) * half)), chunk_records=c["chunk"])
        paths.append(p)
    return paths


def mlp_cost(T):
    L, A, m = T.layer, T.activation, INPUT_MLP
    h = x = L.data("mlp_x", T.data_type.dense_vector(m["dims"][0]))
    y = L.data("mlp_y", T.data_type.integer_value(m["dims"][-1]))
    for i, w in enumerate(m["dims"][1:-1]):
        h = L.fc(h, w, act=A.Relu(), name=f"mlp_h{i}")
    out = L.fc(h, m["dims"][-1], act=A.Softmax(), name="mlp_out")
    return L.classification_cost(out, y, name="mlp_cost")


def torn_save_check(torch, tr, tmp) -> dict:
    """A multi-process save whose second process dies between moving its
    data files and its manifest (``crash@checkpoint:phase=mid_commit``):
    the previous checkpoint stays ``latest_checkpoint`` and loads, onto
    the card, with its own values."""
    from paddle_tpu_torch.io import checkpoint as ckpt_io
    from paddle_tpu_torch.runtime import chaos
    d = str(Path(tmp, "torn"))
    vals, opt, st = tr.parameters.values, tr.opt_state, tr.parameters.state
    plus = {k: v + 1 for k, v in vals.items()}
    for pi in (0, 1):
        ckpt_io.save_checkpoint(d, 1, vals, opt, st, process_index=pi,
                                process_count=2)
    ckpt_io.save_checkpoint(d, 2, plus, opt, st, process_index=0,
                            process_count=2)
    os.environ[chaos.ENV_VAR] = "crash@checkpoint:phase=mid_commit"
    chaos.reset()
    try:
        ckpt_io.save_checkpoint(d, 2, plus, opt, st, process_index=1,
                                process_count=2)
        fired = False
    except chaos.ChaosError:
        fired = True
    finally:
        os.environ.pop(chaos.ENV_VAR)
        chaos.reset()
    latest = ckpt_io.latest_checkpoint(d)
    step, p, o, s = ckpt_io.load_checkpoint(latest, vals, opt, st)
    doc = {"chaos_fired": fired,
           "torn_complete": ckpt_io.is_complete(str(Path(d,
                                                         "ckpt-00000002"))),
           "latest": Path(latest).name, "step": step,
           "values_equal": all(torch.equal(p[k], vals[k]) for k in vals),
           "on_device": all(v.device == vals[k].device
                            for k, v in p.items())}
    if not (fired and not doc["torn_complete"] and step == 1
            and doc["latest"] == "ckpt-00000001" and doc["values_equal"]
            and doc["on_device"]):
        fail(f"input: torn-save check failed: {doc}")
    return doc


def input_phase(torch, dev, c=INPUT, cost_fn=None) -> dict:
    """The ``input:`` line: recordio shards of uint8 images; the native
    loader; ResNet-50 (bf16, batch 128) fed through a Pipeline
    (``prefetch=3``) against the same stream at ``prefetch=0``; the
    device's busy share of one more pipelined step; the same run with
    asynchronous checkpoints; the resume gates (an MLP and ResNet-50,
    bitwise) and the torn save. No port kernel launches here."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.ops import kernels, prng
    from paddle_tpu_torch.trainer import adopt
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.utils.rng import KeySource
    cost_fn = cost_fn or resnet50_cost
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    cuda = dev.type == "cuda"
    doc = {}
    with tempfile.TemporaryDirectory(prefix="input_") as tmp:
        t0 = time.perf_counter()
        shards = image_shards(tmp, c)
        doc["data"] = {"images": c["images"], "shards": len(shards),
                       "bytes": sum(os.path.getsize(p) for p in shards),
                       "write_s": time.perf_counter() - t0}
        doc.update(loader_check(T, shards))

        cost = cost_fn(T)
        topo = T.topology.Topology(cost)

        def momentum():
            return T.optimizer.Momentum(momentum=0.9, learning_rate=0.01)

        def trainer():
            params = T.parameters.create(topo, KeySource(5), device=dev)
            return T.trainer.SGD(cost, params, momentum())
        T.init(seed=5)
        tr = trainer()
        per_epoch = c["images"] // c["batch"]
        pipe = image_pipe(T, shards, c)
        try:
            doc["pipelined"] = timed_run(
                torch, T, tr, pipe, c, 2 * per_epoch, pipe=pipe)
            # one more pipelined step under the profiler, its ring full
            it = iter(pipe)
            key = prng.prng_key(1)

            def step():
                feeds = next(it)
                adopt(feeds)
                return float(tr._plain_train_step(feeds, tr._step, key)[0])
            step()
            time.sleep(0.5)
            prof = profile_window(torch, step) if cuda else {}
            it.close()
            doc["profile"] = {k: prof.get(k) for k in (
                "step_ms", "device_busy_ms", "device_busy_share")}
            doc["profile"]["host_top"] = prof.get("host_top", [])[:5]
        finally:
            pipe.close()
        doc["prefetch0"] = timed_run(
            torch, T, tr, T.reader.firstn(image_sync_reader(T, shards, c),
                                          c["warmup"] + c["timed"]),
            c, c["warmup"] + c["timed"])
        doc["speedup"] = (doc["pipelined"]["images_per_s"]
                          / doc["prefetch0"]["images_per_s"])

        # the same pipelined run with asynchronous checkpoints
        ck_dir = str(Path(tmp, "ckpt"))
        old = GLOBAL_FLAGS.get("checkpoint_period")
        GLOBAL_FLAGS.set("checkpoint_period", c["period"])
        pipe = image_pipe(T, shards, c)
        try:
            t0 = time.perf_counter()
            tr.train(reader=pipe, num_passes=1, checkpoint_dir=ck_dir)
            run_s = time.perf_counter() - t0
        finally:
            pipe.close()
            GLOBAL_FLAGS.set("checkpoint_period", old)
        from paddle_tpu_torch.io import checkpoint as ckpt_io
        latest = ckpt_io.latest_checkpoint(ck_dir)
        nbytes = sum(f.stat().st_size for f in Path(latest).iterdir())
        saved = sorted(Path(ck_dir).glob("ckpt-*"))
        ck = tr.last_checkpointer
        writes = ck.write_seconds
        stall = tr._acct.snapshot()["buckets"]["checkpoint_save"]
        # each save's stall in its parts, timed inside the save: the
        # pipeline's state_dict, the trees' snapshot (of it the pinned
        # allocation) and the pickle of the state, all on the host, and
        # the hand-off to the writer
        saves = [{(k[:-2] + "_ms" if k.endswith("_s") else k):
                  (1e3 * v if k.endswith("_s") else v)
                  for k, v in sorted(parts.items())}
                 for parts in ck.save_parts]
        dev_bytes = max(p["device_bytes"] for p in ck.save_parts)
        bw = d2h_gb_per_s(torch, dev) if cuda else None
        doc["checkpoint"] = {
            "saves": len(writes), "bytes_on_disk": nbytes,
            "saved": [p.name for p in saved],
            "device_bytes": dev_bytes, "per_save": saves,
            "params": int(sum(v.numel() for v in
                              tr.parameters.values.values())),
            "stall_ms_per_save": 1e3 * stall / max(1, len(writes)),
            "writer_s_per_save": writes,
            "d2h_gb_per_s": bw,
            # the least time the trees' copy off the card can take; the
            # host's part of the stall (state_dict, pickle) is apart
            "stall_bound_ms": (1e3 * dev_bytes / (bw * 1e9) if bw
                               else None),
            "run_s": run_s, "per_pass_batches": per_epoch}
        del tr
        if cuda:
            torch.cuda.empty_cache()

        # resume gates: (a) the MLP, (b) ResNet-50
        mshards = mlp_shards(tmp, c)
        mcost = mlp_cost(T)
        mtopo = T.topology.Topology(mcost)
        m = INPUT_MLP

        def mlp_trainer():
            params = T.parameters.create(mtopo, KeySource(9), device=dev)
            return T.trainer.SGD(mcost, params, T.optimizer.Momentum(
                momentum=0.9, learning_rate=m["lr"]))

        def mlp_pipe():
            P = T.pipeline
            return P.Pipeline(P.ShardSource(mshards, seed=c["seed"]),
                              shuffle_size=m["shuffle"], seed=c["seed"],
                              batch_size=m["batch"], prefetch=3)
        doc["resume_mlp"] = resume_gate(torch, T, "mlp", mlp_trainer,
                                        mlp_pipe, c, tmp)
        tr = mlp_trainer()
        doc["torn_save"] = torn_save_check(torch, tr, tmp)
        del tr
        doc["resume_resnet50"] = resume_gate(
            torch, T, "resnet50", trainer,
            lambda: image_pipe(T, shards, c), c, tmp,
            repeat=True)
    after = kernels.launch_counts()
    doc["port_kernel_launches"] = sum(after[k] - before.get(k, 0)
                                      for k in after)
    doc["phase_s"] = time.perf_counter() - t_phase
    print("input: " + json.dumps(doc))
    return doc


# ---------------------------------------------------------------------------
# book chapters phase
# ---------------------------------------------------------------------------

# ``book:`` phase: the nine chapters of ``tests/test_book.py``, as
# ``tests/torch_book_chapters.py`` builds them (the networks the CPU tests
# hold against the JAX package), trained on the card from the port's
# dataset readers (the synthetic fallbacks unless the corpora are under
# ``PADDLE_TPU_DATA_HOME``), fp32 compute with TF32 off, ``batches``
# batches each (a reader shorter than that is read again). ResNet-32 on
# CIFAR-10 shapes at batch 128 and the LSTM classifier at hidden 256 / emb
# 128 over imdb's dictionary run at their model functions' defaults;
# seq2seq at ``LAYERS_S2S``'s widths (wmt14's 30000-word dictionaries, 512
# wide; its function's default is 32), batch 32; the rest as the test
# makes them.
# The port's same first ``cpu_batches`` steps run on the CPU from the same
# weights, and their costs (the second after one Adam update on each side)
# are held within ``rel``. Not more batches: Adam's first steps act on the
# gradients' signs, so the fp32 rounding the two devices differ by grows
# about tenfold a step (ResNet-32's fourth cost 1.0e-3 apart, the first
# 8.2e-8, on an NVIDIA H100 80GB HBM3 at 700.00 W). Costs cannot show a
# gradient's scale, which Adam divides out, so the first batch's step is
# also held as ``trainer_step_parity`` holds the trainer phase's: each
# gradient the optimizer gets within ``rel`` of its max; ResNet-32's
# convolutions and batch norms op by op against float64 within fp32's
# summation bound (``OpRecorder``, ``hold_ops``: a whole-network gradient
# of a ResNet at initialisation cancels, its relative L2 on the card 1.8e-3
# from the CPU's there), its other leaves within ``TRAINER_RESNET_REL``.
# The cost of the chapter's first ``held`` batches (``SGD.test``) must
# fall between before and after training (the per-batch training costs of
# 20 batches are too noisy for the recommender's and word2vec's to show
# it).
BOOK = {"batches": 20, "held": 4, "cpu_batches": 2, "seed": 17,
        "rel": 1e-4, "resnet_depth": 32, "image_batch": 128,
        "lstm_hidden": 256, "lstm_emb": 128, "wmt_dict": 30000,
        "wmt_dim": 512, "wmt_batch": 32}


def book_module():
    """``tests/torch_book_chapters.py``, loaded from its file (it imports
    neither package; the chapters take the port as an argument)."""
    name = "torch_book_chapters"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(__file__).resolve().parent / "tests" / f"{name}.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def book_chapters(T, c) -> dict:
    """name -> the port's chapter at the widths in ``c``; learn-to-rank's
    reader keeps its seeded shuffle's first pass (each call of a shuffled
    reader draws a new order, and the card's run and the CPU's must read
    the same batches)."""
    book = book_module()
    ch = {n: book.chapter(n, T, c) for n in book.BUILDERS}
    order = list(ch["learn_to_rank"].reader())
    ch["learn_to_rank"].reader = lambda: iter(order)
    return ch


def cycled(reader, n):
    """The first ``n`` samples of ``reader`` read over and over."""
    def gen():
        left = n
        while left:
            got = 0
            for s in itertools.islice(reader(), left):
                got += 1
                yield s
            if not got:
                fail("book: a chapter's reader is empty")
            left -= got
    return gen


def book_train(T, ch, params, n, dev, held=0) -> tuple:
    """``SGD.train`` of ``n`` batches of ``ch`` from ``params`` (values and
    state copied to ``dev``): (costs, step records, trainer, the test cost
    of the first ``held`` batches before and after training)."""
    topo = T.topology.Topology([ch.cost] + ch.extra)
    p = T.parameters.Parameters(topo.param_specs(),
                                state_specs=topo.state_specs(), device=dev)
    # copies: the trainer writes its updates into the values
    p.values = {k: v.to(dev).clone() for k, v in params.values.items()}
    p.state = {k: v.to(dev).clone() for k, v in params.state.items()}
    tr = T.trainer.SGD(ch.cost, p, ch.opt(), extra_layers=ch.extra)
    first = T.batch(cycled(ch.reader, held * ch.batch), ch.batch)
    tests = [tr.test(first, feeding=ch.feeding).cost] if held else []
    recs, costs = [], []
    T.observe.add_report_handler(recs.append)
    try:
        tr.train(T.batch(cycled(ch.reader, n * ch.batch), ch.batch),
                 feeding=ch.feeding,
                 event_handler=lambda e: costs.append(e.cost) if isinstance(
                     e, T.event.EndIteration) else None)
    finally:
        T.observe.remove_report_handler(recs.append)
    if held:
        tests.append(tr.test(first, feeding=ch.feeding).cost)
    return costs, [r for r in recs if r.get("kind") == "step"], tr, tests


def book_data(T, tmp) -> dict:
    """``dataset.cifar.convert`` (recordio through ``common.convert``),
    then ``reader.creator.recordio`` over its files against the in-memory
    readers, sample by sample; MB/s of both steps."""
    D = T.dataset
    t0 = time.perf_counter()
    paths = D.cifar.convert(tmp)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(p) for p in paths)
    t0 = time.perf_counter()
    got = list(T.reader.creator.recordio(paths)())
    read_s = time.perf_counter() - t0
    n = 0
    for split in (D.cifar.train10, D.cifar.test10, D.cifar.train100,
                  D.cifar.test100):
        for x, y in split()():
            if n >= len(got):
                fail(f"book: recordio holds {len(got)} samples, the "
                     f"readers more")
            gx, gy = got[n]
            if not (gx.dtype == x.dtype and gx.tobytes() == x.tobytes()
                    and gy == y and type(gy) is type(y)):
                fail(f"book: recordio sample {n} differs from the reader's")
            n += 1
    if n != len(got):
        fail(f"book: recordio holds {len(got)} samples, the readers {n}")
    return {"files": len(paths), "samples": n, "bytes": nbytes,
            "convert_mb_per_s": nbytes / 1e6 / write_s,
            "recordio_read_mb_per_s": nbytes / 1e6 / read_s,
            "samples_equal": True}


def book_stats(T, tcli, jsonl, steps, tmp) -> dict:
    """``python -m paddle_tpu_torch stats --metrics_file`` over one
    chapter's JSONL in a process, and ``stats --trace`` of this process's
    spans."""
    root = str(Path(__file__).resolve().parent)
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "stats",
         f"--metrics_file={jsonl}"], cwd=tmp, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=root))
    m = re.search(r"\((\d+) steps", p.stdout)
    counted = int(m.group(1)) if m else None
    if p.returncode != 0 or counted != steps:
        fail(f"book: stats --metrics_file rc {p.returncode}, counted "
             f"{counted} steps of {steps}: {p.stdout[-2000:]} "
             f"{p.stderr[-2000:]}")
    out = str(Path(tmp, "book_trace.json"))
    with contextlib.redirect_stdout(io.StringIO()):
        rc = tcli.main(["stats", "--trace", out])
    trace = json.loads(Path(out).read_text())
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    if rc != 0 or not any(e["name"] == "train_step" for e in spans):
        fail(f"book: stats --trace rc {rc}, {len(spans)} spans")
    return {"metrics_file_rc": p.returncode, "steps_counted": counted,
            "summary": p.stdout.strip().splitlines()[:2],
            "trace_rc": rc, "trace_spans": len(spans)}


def book_phase(torch, dev, c=BOOK) -> dict:
    """The ``book:`` line: the nine chapters trained on ``dev`` from the
    port's dataset readers (per chapter: step ms p50, min and max after the
    first step, examples/s, first and last cost, peak memory above what
    was allocated before the chapter, the first batches' costs and the
    first step against the CPU's), the CIFAR recordio path and the CLI's
    ``stats``. The cost of the chapter's first batches must fall between
    before and after training. No port kernel launches here."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch import cli as tcli
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.utils.rng import KeySource
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    cuda = dev.type == "cuda"
    if cuda:
        torch.zeros(1, device=dev)      # the context, for the memory stats
    old = GLOBAL_FLAGS.get("compute_dtype")
    GLOBAL_FLAGS.set("compute_dtype", "float32")
    doc = {"chapters": {}}
    try:
        with tempfile.TemporaryDirectory(prefix="book_") as tmp:
            doc["data"] = book_data(T, tmp)
            chapters = book_chapters(T, c)
            jsonl = str(Path(tmp, "sentiment.jsonl"))
            for i, (name, ch) in enumerate(chapters.items()):
                t0 = time.perf_counter()
                # drawn on ``dev``: seq2seq's 53M parameters take ~60 s
                # to draw on the CPU
                params = T.parameters.create(
                    T.topology.Topology([ch.cost] + ch.extra),
                    KeySource(c["seed"] + i), device=dev)
                cpu_costs, *_ = book_train(T, ch, params, c["cpu_batches"],
                                           "cpu")
                rows = next(iter(T.batch(cycled(ch.reader, ch.batch),
                                         ch.batch)()))
                parity, _ = trainer_step_parity(
                    torch, T, f"book {name}", ch.cost, params.values,
                    params.state, ch.opt, rows, dev,
                    TRAINER_RESNET_REL if name == "image" else c["rel"],
                    recorder=OpRecorder() if name == "image" else None,
                    feeding=ch.feeding)
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                    base = torch.cuda.memory_allocated(dev)
                if name == "sentiment":
                    T.observe.configure(jsonl)
                try:
                    costs, steps, tr, tests = book_train(
                        T, ch, params, c["batches"], dev, c["held"])
                finally:
                    if name == "sentiment":
                        T.observe.configure(None)
                walls = [1e3 * r["wall_time_s"] for r in steps[1:]]
                p50 = float(np.median(walls))
                rels = [abs(a - b) / abs(b) for a, b in zip(costs, cpu_costs)]
                doc["chapters"][name] = {
                    "batch": ch.batch, "batches": len(costs),
                    "step_ms_p50": p50, "step_ms_min": min(walls),
                    "step_ms_max": max(walls),
                    "examples_per_s": ch.batch * 1e3 / p50,
                    "first_cost": costs[0], "last_cost": costs[-1],
                    "held_cost_before": tests[0],
                    "held_cost_after": tests[1],
                    "cpu_costs": cpu_costs, "cpu_rel": rels,
                    "step_parity": parity,
                    "peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                   - base if cuda else None),
                    "device": str(next(iter(
                        tr.parameters.values.values())).device),
                    "s": time.perf_counter() - t0}
                if len(costs) != c["batches"] or not np.all(
                        np.isfinite(costs)):
                    fail(f"book {name}: costs {costs}")
                if not tests[1] < tests[0]:
                    fail(f"book {name}: the cost of the first "
                         f"{c['held']} batches did not fall: {tests} "
                         f"(training costs {costs})")
                if len(cpu_costs) != c["cpu_batches"] or not max(
                        rels) <= c["rel"]:
                    fail(f"book {name}: the first batches' costs "
                         f"{costs[:len(cpu_costs)]!r} on {dev}, {cpu_costs!r}"
                         f" on the CPU: relative errors {rels!r} > "
                         f"{c['rel']!r}")
                del tr, params
            doc["stats"] = book_stats(T, tcli, jsonl, c["batches"], tmp)
    finally:
        GLOBAL_FLAGS.set("compute_dtype", old)
    after = kernels.launch_counts()
    doc["port_kernel_launches"] = sum(after[k] - before.get(k, 0)
                                      for k in after)
    if doc["port_kernel_launches"]:
        fail(f"book: port kernels launched: {before} -> {after}")
    doc["phase_s"] = time.perf_counter() - t_phase
    print("book: " + json.dumps(doc))
    return doc


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, WARMUP, TIMED = 8, 1024, 2, 10


# ---------------------------------------------------------------------------
# the single-card parallel tier (ROADMAP A9): the q8 ResNet recipes, the
# transformer's layer remat and the Switch-8 MoE LM


A9 = {"q8_modes": ("off", "q8", "defer", "q8sr"), "q8_warmup": 2,
      "q8_timed": 10, "q8_train_batches": 4, "block_batch": 4,
      "remat_modes": ("none", "bf16", "q8"), "remat_timed": 3,
      "remat_tol": {"bf16": 0.02, "q8": 0.08},
      "moe_experts": 8, "moe_warmup": 2, "moe_timed": 5,
      "moe_artifact_requests": 4}
# a stash code after a convolution may differ between cuDNN and oneDNN by
# one step where the value before the round lies at a half
Q8_FLIP_SHARE = 5e-3


def q8_codes_check(torch, label, card, cpu, after_conv) -> int:
    """Codes that differ between the card's stash and the CPU's: none
    where no convolution precedes the stash, else each one step (one
    bf16 ulp) and at most ``Q8_FLIP_SHARE`` of them."""
    a, b = card.cpu(), cpu.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        fail(f"q8 {label}: stash {a.dtype}{tuple(a.shape)} on the card vs "
             f"{b.dtype}{tuple(b.shape)} on the CPU")
    diff = a != b
    n = int(diff.sum())
    if n == 0:
        return 0
    if not after_conv:
        fail(f"q8 {label}: {n} stash codes differ where no convolution "
             f"precedes the stash")
    if a.is_floating_point():
        step = (a.float() - b.float()).abs()[diff] / b.float().abs()[
            diff].clamp_min(2.0 ** -126)
        ok = bool((step <= 2.0 ** -7).all())
    else:
        ok = int((a.int() - b.int()).abs().max()) <= 1
    if not ok or n > Q8_FLIP_SHARE * a.numel():
        fail(f"q8 {label}: {n} of {a.numel()} stash codes differ, or by "
             f"more than one step")
    return n


def q8_blocks(torch, dev) -> dict:
    """Each q8 block on the card against the port's same Function on the
    CPU from the same operands (batch 4, fp32 compute, TF32 off, ResNet-50
    res2 / res3 widths): the entry; conv_q8 3x3 at stride 1 and 2, with
    and without the input ReLU; add_q8 (one branch's ReLU deferred); the
    exit. The stash codes (``q8_codes_check``), every other output and
    every input gradient (from seeded cotangents on the carrier and the
    statistics) within ``OPS_F32_REL`` of the CPU's."""
    from paddle_tpu_torch.ops import q8
    N = A9["block_batch"]
    rng = np.random.RandomState(21)

    def vec(c, lo, hi):
        return rng.uniform(lo, hi, c).astype(np.float32)

    def codes(*shape):
        return rng.randint(-127, 128, shape).astype(np.int8)

    cases = {}
    x = rng.randn(N, 56, 56, 64).astype(np.float32)
    cases["entry"] = (lambda d, x_, m, s: q8.make_entry("int8")(x_, m, s),
                      [x, vec(64, -0.1, 0.1), vec(64, 0.02, 0.04)], (0,),
                      1, False)
    for stride in (1, 2):
        for relu in (False, True):
            ops = [np.zeros((N, 56, 56, 64), np.float32), codes(N, 56, 56, 64),
                   (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32),
                   vec(64, 0.8, 1.2), vec(64, -0.1, 0.1),
                   vec(64, -0.1, 0.1), vec(64, 0.015, 0.025),
                   vec(64, -0.1, 0.1), vec(64, 0.06, 0.1)]

            def conv(d, *a, stride=stride, relu=relu):
                a = list(a)
                a[1] = a[1].to(torch.int8)
                return q8.make_conv_q8(stride, 1, relu)(*a)
            cases[f"conv_s{stride}{'_relu' if relu else ''}"] = (
                conv, ops, (0, 2, 3, 4), 1, True)

    def add(d, ya, qa, Ma, Ba, ma, sa, yb, qb, Mb, Bb, mb, sb, mo, so):
        return q8.make_add_q8(False, True)(
            ya, qa.to(torch.int8), Ma, Ba, ma, sa, yb, qb.to(torch.int8),
            Mb, Bb, mb, sb, mo, so)
    shape = (N, 28, 28, 256)
    cases["add"] = (add, [np.zeros(shape, np.float32), codes(*shape),
                          vec(256, 0.8, 1.2), vec(256, -0.1, 0.1),
                          vec(256, -0.1, 0.1), vec(256, 0.02, 0.03),
                          np.zeros(shape, np.float32), codes(*shape),
                          vec(256, 0.8, 1.2), vec(256, -0.1, 0.1),
                          vec(256, -0.1, 0.1), vec(256, 0.02, 0.03),
                          np.zeros(256, np.float32), vec(256, 0.05, 0.07)],
                    (0, 2, 3, 6, 8, 9), 1, False)

    def exit_(d, y, q_, M, B, m, s):
        return q8.make_exit(True)(y, q_.to(torch.int8), M, B, m, s)
    cases["exit"] = (exit_, [np.zeros(shape, np.float32), codes(*shape),
                             vec(256, 0.8, 1.2), vec(256, -0.1, 0.1),
                             vec(256, -0.1, 0.1), vec(256, 0.02, 0.03)],
                     (0, 2, 3), None, False)
    doc = {}
    with compute_dtype("float32"):
        for label, (fn, arrays, wrt, code_i, after_conv) in cases.items():
            cpu = run_on(torch, fn, arrays, "cpu", wrt)
            card = run_on(torch, fn, arrays, dev, wrt)
            flips = (q8_codes_check(torch, label, card[0][code_i],
                                    cpu[0][code_i], after_conv)
                     if code_i is not None else 0)
            worst = 0.0
            for i, (a, b) in enumerate(zip(card[0] + card[1],
                                           cpu[0] + cpu[1])):
                if i == code_i or not b.is_floating_point():
                    continue
                if not torch.isfinite(a.float()).all():
                    fail(f"q8 {label}: non-finite output {i} on the card")
                err = rel_err(torch, a, b)
                if not err <= OPS_F32_REL:
                    fail(f"q8 {label}: output {i} card vs CPU {err!r} > "
                         f"{OPS_F32_REL!r}")
                worst = max(worst, err)
            doc[label] = {"max_rel_err": worst, "code_flips": flips}
    return doc


def q8_resnet(torch, T, tcli, dev, mode) -> dict:
    """ResNet-50 (``resnet50_cost``, batch 128, bf16, the s2d stem) under
    ``fused_bn`` ``mode`` ("off" is PR 15's mode, beside in the same
    run): ``cli.measure_time`` (images/s, ms/batch, peak memory), then
    ``SGD.train`` over one batch repeated (its cost must fall and, on the
    q8 pipeline, a stash site's ``q_scale`` must move off 1), and one more
    step under the profiler."""
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.utils.rng import KeySource
    c, a = TRAINER_RESNET, A9
    B, d = c["batch"], 3 * c["image"] ** 2
    cost = resnet50_cost(T, False if mode == "off" else mode)
    topo = T.topology.Topology(cost)
    rng = np.random.RandomState(0)
    samples = [(rng.rand(d).astype(np.float32), int(rng.randint(
        c["classes"]))) for _ in range(2 * B)]

    def momentum():
        return T.optimizer.Momentum(momentum=c["momentum"],
                                    learning_rate=c["lr"])
    T.init(seed=5)
    t = tcli.measure_time({"cost": cost, "reader": lambda: iter(samples),
                           "batch_size": B, "optimizer": momentum()},
                          time_batches=a["q8_timed"],
                          warmup_batches=a["q8_warmup"], device=dev)
    doc = {"ms_per_batch": t["ms_per_batch"],
           "images_per_s": t["examples_per_sec"], "mfu": t["mfu"],
           "peak_memory_bytes": t["peak_memory_bytes"],
           "stash_sites": sum(l.layer_type in ("q8_entry", "img_conv_bn_q8",
                                               "addto_q8")
                              for l in topo.layers)}
    torch.cuda.empty_cache()
    params = T.parameters.create(topo, KeySource(5), device=dev)
    tr = T.trainer.SGD(cost, params, momentum())
    col = (np.stack([s[0] for s in samples[:B]]),
           np.array([s[1] for s in samples[:B]], np.int32))
    costs = []
    tr.train(lambda: iter([col] * a["q8_train_batches"]),
             event_handler=lambda e: costs.append(e.cost) if isinstance(
                 e, T.event.EndIteration) else None)
    doc["train_costs"] = costs
    if not (all(np.isfinite(costs)) and costs[-1] < costs[0]):
        fail(f"q8 {mode}: SGD.train costs {costs} did not fall")
    if mode != "off":
        s = tr.parameters.state["res2_0_a_q8.q_scale"]
        doc["q_scale_moved"] = float((s - 1.0).abs().max())
        if not doc["q_scale_moved"] > 1e-3:
            fail(f"q8 {mode}: the delayed scale did not move")
    feeds = tr._feeder(None).feed(col)
    key = prng.prng_key(1)
    prof = profile_window(torch, lambda: float(
        tr._plain_train_step(feeds, tr._step, key)[0]))
    doc["profile"] = {k: prof.get(k) for k in (
        "step_ms", "device_busy_ms", "device_busy_share", "device_kernels")}
    doc["profile"]["top"] = prof.get("top", [])[:5]
    del tr, params, feeds
    torch.cuda.empty_cache()
    return doc


def remat_phase(torch, tt, topt, kernels, cfg, dev) -> tuple:
    """GPT-2 small widths, the ``train:`` recipe (B = 8 x T = 1024, bf16,
    flash attention, Adam 1e-4), under ``remat`` "none", "bf16" and "q8",
    each from the same seed-0 weights: the first step's loss (bitwise
    "none"'s) and gradients (worst leaf within ``A9["remat_tol"]`` of
    "none"'s), the peak memory of that forward + backward (q8 < bf16 <
    none), then ``remat_timed`` Adam steps timed (p50) with kernels 5 and
    6 counted (2 and 1 launches a layer a step under remat, 1 and 1
    without). Returns (doc, the timed steps' launches summed)."""
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    targets = tokens.roll(-1, 1)
    doc, ref, total = {}, None, {}
    for mode in A9["remat_modes"]:
        mcfg = dataclasses.replace(cfg, remat=mode)
        params = tt.init_train_params(cfg, torch.Generator().manual_seed(0),
                                      dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = tt.lm_loss(params, tokens, targets, mcfg)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        grads = topt.take_grads(params)
        flat = dict(topt.tree_leaves(grads))
        row = {"first_loss": loss.item(), "peak_bytes_above_weights": peak}
        if ref is None:
            ref = (loss.detach(), flat)
        else:
            row["loss_bitwise_none"] = bool(torch.equal(loss.detach(),
                                                        ref[0]))
            row["worst_grad_rel"] = max(
                float((flat[k] - g).abs().max() / g.abs().max()
                      .clamp_min(1e-30)) for k, g in ref[1].items())
        adam = topt.Adam(learning_rate=1e-4)
        state = adam.tree_init_state(params)
        params, state = adam.tree_update(0, grads, params, state)
        del grads, flat
        times = []
        kernels.reset_launches()
        for i in range(1, 1 + A9["remat_timed"]):
            t0 = time.perf_counter()
            loss = tt.lm_loss(params, tokens, targets, mcfg)
            loss.backward()
            params, state = adam.tree_update(i, topt.take_grads(params),
                                             params, state)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = kernels.launch_counts()
        steps = A9["remat_timed"]
        row.update({"step_ms_p50": 1e3 * float(np.median(times)),
                    "step_ms_min": 1e3 * min(times),
                    "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * steps
                    / sum(times), "last_loss": loss.item(),
                    "flash_fwd_per_step": launches["flash_attention_fwd"]
                    / steps,
                    "flash_bwd_per_step": launches["flash_attention_bwd"]
                    / steps})
        for k in TRAINING_KERNELS:
            total[k] = total.get(k, 0) + launches[k]
        doc[mode] = row
        del params, state, adam, loss
        torch.cuda.empty_cache()
    print("remat: " + json.dumps(doc))
    L = cfg.n_layers
    for mode, row in doc.items():
        fwd = 2 * L if mode != "none" else L
        if (row["flash_fwd_per_step"], row["flash_bwd_per_step"]) != (fwd, L):
            fail(f"remat {mode}: kernels 5 / 6 launched "
                 f"{row['flash_fwd_per_step']} / {row['flash_bwd_per_step']}"
                 f" a step, expected {fwd} / {L}")
        if mode == "none":
            continue
        if not row["loss_bitwise_none"]:
            fail(f"remat {mode}: the first loss is not 'none''s bitwise")
        if not row["worst_grad_rel"] < A9["remat_tol"][mode]:
            fail(f"remat {mode}: worst gradient {row['worst_grad_rel']!r} "
                 f"off 'none''s (limit {A9['remat_tol'][mode]})")
    peaks = [doc[m]["peak_bytes_above_weights"] for m in ("q8", "bf16",
                                                          "none")]
    if not peaks[0] < peaks[1] < peaks[2]:
        fail(f"remat: peak memory q8 / bf16 / none {peaks} not ordered")
    return doc, total


def moe_config(cfg):
    """GPT-2 small widths with every FFN a Switch layer of 8 experts
    (Switch-Base-8's expert count, Fedus et al. 2021) at the JAX
    config's MoE defaults: top-1, capacity factor 1.25, aux weight
    0.01."""
    return dataclasses.replace(cfg, moe_experts=A9["moe_experts"])


def moe_train(torch, tt, topt, kernels, costs, place, mcfg, dev) -> tuple:
    """The ``train:`` recipe on the MoE model: 2 warm-up and 5 timed Adam
    steps: step ms, tokens/s, peak memory, the losses (falling) and the
    aux loss of the last weights (> 0); kernels 5 and 6 once a layer a
    step. Returns (doc, launches)."""
    params = tt.init_train_params(mcfg, torch.Generator().manual_seed(0),
                                  dev)
    adam = topt.Adam(learning_rate=1e-4)
    state = adam.tree_init_state(params)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, mcfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    targets = tokens.roll(-1, 1)

    def step(i):
        nonlocal params, state
        loss = tt.lm_loss(params, tokens, targets, mcfg)
        loss.backward()
        params, state = adam.tree_update(i, topt.take_grads(params), params,
                                         state)
        torch.cuda.synchronize()
        return loss.item()

    torch.cuda.reset_peak_memory_stats()
    losses = [step(i) for i in range(A9["moe_warmup"])]
    kernels.reset_launches()
    times = []
    for i in range(A9["moe_warmup"], A9["moe_warmup"] + A9["moe_timed"]):
        t0 = time.perf_counter()
        losses.append(step(i))
        times.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    with torch.no_grad():
        _, aux = tt.forward(params, tokens, mcfg, return_aux=True)
    p50 = float(np.median(times))
    flops = costs.train_step_flops(mcfg, TRAIN_BATCH, TRAIN_SEQ)
    doc = {"step_ms_p50": 1e3 * p50, "step_ms_min": 1e3 * min(times),
           "step_ms_max": 1e3 * max(times),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * len(times) / sum(times),
           "active_flops_mfu": costs.mfu(flops, p50, place.peak_flops(dev)),
           "params": sum(int(v.numel()) for _, v in
                         topt.tree_leaves(params)),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "aux": aux.item(),
           "launches": {k: launches[k] for k in TRAINING_KERNELS}}
    del params, state, adam
    torch.cuda.empty_cache()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"moe training: losses {losses} did not fall")
    if not doc["aux"] > 0:
        fail(f"moe training: aux loss {doc['aux']}")
    for k in TRAINING_KERNELS:
        if launches[k] != mcfg.n_layers * len(times):
            fail(f"moe training: {k} launched {launches[k]} times in "
                 f"{len(times)} steps")
    return doc, launches


def moe_step_parity(torch, tt, top_k) -> dict:
    """``step_parity``'s walk (two prefill chunks and a decode step) on a
    small fp32 MoE model (4 experts, ``top_k``): the card against the
    CPU, logits and pool within 1e-4."""
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32", moe_experts=4,
                               moe_top_k=top_k)
    bs, nb = 16, 16
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, 256, 40).astype(np.int32)
    pages = np.asarray([3, 9, 4, 0], np.int32)

    def walk(d):
        params = tt.init_params(cfg, torch.Generator().manual_seed(5), d)
        pool = tt.init_block_pool(cfg, nb, bs, device=d)
        out = []
        for off, c in ((0, 32), (32, 8)):
            bucket = 32 if c > 16 else 16
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :c] = prompt[off:off + c]
            pv = pages[:off // bs + bucket // bs]
            lg, _ = tt.prefill_into_blocks(
                params, pool, torch.from_numpy(padded).to(d), c,
                torch.from_numpy(pv.copy()).to(d), cfg, block_size=bs)
            out.append(lg.cpu())
        tok = torch.tensor([int(out[-1].argmax()), 5], dtype=torch.int32)
        lg, _ = tt.decode_step_paged(
            params, pool, tok.to(d),
            torch.tensor([40, 3], dtype=torch.int32).to(d),
            torch.tensor([True, False]).to(d),
            torch.from_numpy(np.stack([pages, pages])).to(d), cfg,
            block_size=bs)
        out.append(lg.cpu())
        return out, {n: t.cpu() for n, t in pool.items()}

    cpu, card = walk("cpu"), walk("cuda")
    err = max((a - b).abs().max().item() for a, b in zip(cpu[0], card[0]))
    pool_err = max((cpu[1][n] - card[1][n]).abs().max().item()
                   for n in ("k", "v"))
    if not (err <= 1e-4 and pool_err <= 1e-4):
        fail(f"moe top-{top_k}: fp32 steps card vs CPU logits {err!r} "
             f"pool {pool_err!r} > 1e-4")
    return {"logits_max_abs_err": err, "pool_max_abs_err": pool_err}


def moe_batch_dlogit(torch, tt, cfg, params, dev, prompt) -> float:
    """Max |logit difference| of one slot's decode step on the MoE model
    alone in the batch (the other 7 rows inactive, token 0) against the
    same step beside 7 active rows of other tokens: where the experts'
    slots shift with the batch's routing (ROADMAP C4). The prefix gate's
    near-tie bound."""
    bs = ENGINE_KW["block_size"]
    P = ENGINE_KW["cache_len"] // bs
    B = ENGINE_KW["batch"]
    pool = tt.init_block_pool(cfg, P + 1, bs, device=dev)
    pages = np.arange(1, P + 1, dtype=np.int32)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    C, off, n = ENGINE_KW["chunk_tokens"], 0, len(prompt)
    while off < n:
        c = min(n - off, C)
        padded = np.zeros((1, C), np.int32)
        padded[0, :c] = prompt[off:off + c]
        lg, _ = tt.prefill_into_blocks(params, pool, T(padded), c,
                                       T(pages[:off // bs + C // bs]), cfg,
                                       block_size=bs)
        off += c
    table = np.zeros((B, P), np.int32)
    table[0] = pages
    rng = np.random.RandomState(5)
    out = []
    for others in (False, True):
        toks = rng.randint(0, cfg.vocab, B).astype(np.int32) if others \
            else np.zeros(B, np.int32)
        toks[0] = int(lg[0].argmax())
        pos = np.full(B, 3, np.int32)
        pos[0] = n
        active = np.zeros(B, bool)
        active[0] = True
        active[1:] = others
        snap = {k: v.clone() for k, v in pool.items()}
        out.append(tt.decode_step_paged(params, snap, T(toks), T(pos),
                                        T(active), T(table), cfg,
                                        block_size=bs)[0][0])
    return (out[0] - out[1]).abs().max().item()


def moe_serve(torch, tt, tlm, kernels, PagedDecodeEngine, mcfg, dev) -> tuple:
    """The engine trace (seed 0, 16 requests) through a fresh
    ``PagedDecodeEngine`` over the MoE model's seed-0 serving weights:
    tokens/s, TTFT, captures, kernels 1-4's launches (each > 0); the
    prefix hit against the prompt cold in a fresh engine (a divergence
    only below the batch's logit difference, ``greedy_gate``); then a v4
    artifact of the weights saved, loaded and served: 4 greedy requests'
    ids equal to a fresh in-process engine's. Returns (doc, launches)."""
    params = tt.init_params(mcfg, torch.Generator().manual_seed(0), dev)
    warm_eng = PagedDecodeEngine.from_params(params, mcfg, device=dev,
                                             **ENGINE_KW)
    submit(warm_eng, np.arange(40) % mcfg.vocab, 4, 0.0)
    warm_eng.run_until_idle()
    del warm_eng
    eng = PagedDecodeEngine.from_params(params, mcfg, device=dev,
                                        **ENGINE_KW)
    reqs_in = trace(np.random.RandomState(0), mcfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    reqs, wall, captures, capture_s = serve_trace(torch, eng, reqs_in)
    launches = kernels.launch_counts()
    doc = trace_doc(reqs, wall, captures, capture_s)
    doc.update({"max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated(),
                "launches": {k: launches[k] for k in SERVING_KERNELS
                             + ("fused_sample.threefry",)}})
    check_served("moe", reqs, reqs_in, mcfg.vocab)
    missing = [k for k in SERVING_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"moe serving: kernels never launched: {missing}")
    cold_eng = PagedDecodeEngine.from_params(params, mcfg, device=dev,
                                             **ENGINE_KW)
    cold = submit(cold_eng, *reqs_in[1])
    cold_eng.run_until_idle()
    del cold_eng
    dmax = moe_batch_dlogit(torch, tt, mcfg, params, dev, reqs_in[1][0])
    divs = greedy_gate(
        [(reqs[1], cold.tokens)], dmax,
        lambda req, ids, i: target_margin(torch, tt, mcfg, params, dev,
                                          eng.buckets, reqs_in[1][0], ids,
                                          i),
        "moe prefix", "the cold prompt")
    doc["prefix"] = {"hit_tokens": reqs[1].prefix_hit_tokens,
                     "identical": cold.tokens == reqs[1].tokens,
                     "batch_dlogit": dmax, "divergences": divs}
    greedy = [r for r in reqs_in if r[2] == 0.0][
        :A9["moe_artifact_requests"]]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tlm.save_lm_artifact(
            f"{tmp}/moe.tar", params, mcfg, batch=ENGINE_KW["batch"],
            prompt_len=ENGINE_KW["chunk_tokens"],
            cache_len=ENGINE_KW["cache_len"], engine_buckets=eng.buckets,
            engine_paged=True, engine_block_size=ENGINE_KW["block_size"])
        save_s = time.perf_counter() - t0
        srv = tlm.load_lm_artifact(f"{tmp}/moe.tar")
        a_eng = srv.engine(seed=0, device=dev)
        load_s = time.perf_counter() - t0 - save_s
    a_reqs, _, _, _ = serve_trace(torch, a_eng, greedy)
    ref_eng = PagedDecodeEngine.from_params(params, mcfg, device=dev,
                                            **ENGINE_KW)
    r_reqs, _, _, _ = serve_trace(torch, ref_eng, greedy)
    same = [a.tokens == r.tokens for a, r in zip(a_reqs, r_reqs)]
    doc["artifact"] = {"format_version": srv.meta["format_version"],
                       "save_s": save_s, "load_s": load_s,
                       "ids_equal": same}
    if not all(same):
        fail(f"moe artifact: ids differ from the in-process engine's "
             f"({same})")
    del eng, a_eng, ref_eng, params, srv
    torch.cuda.empty_cache()
    return doc, launches


def a9_phase(torch, tt, topt, tlm, kernels, costs, place, PagedDecodeEngine,
             cfg, dev) -> dict:
    """The ``q8:``, ``remat:`` and ``moe:`` lines; returns the launches of
    kernels 1-6 the phase's main paths made (MoE serving 1-4, remat and
    MoE training 5-6)."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch import cli as tcli
    t0 = time.perf_counter()
    kernels.reset_launches()
    doc = {"blocks": q8_blocks(torch, dev)}
    for mode in A9["q8_modes"]:
        doc[mode] = q8_resnet(torch, T, tcli, dev, mode)
    q8_launches = kernels.launch_counts()
    if any(q8_launches.values()):
        fail(f"q8: the ResNet recipes launched port kernels: "
             f"{ {k: v for k, v in q8_launches.items() if v} }")
    doc["phase_s"] = time.perf_counter() - t0
    print("q8: " + json.dumps(doc))
    t1 = time.perf_counter()
    _, remat_launches = remat_phase(torch, tt, topt, kernels, cfg, dev)
    mcfg = moe_config(cfg)
    t2 = time.perf_counter()
    mdoc = {"config": {"experts": mcfg.moe_experts, "top_k": mcfg.moe_top_k,
                       "capacity_factor": mcfg.moe_capacity_factor,
                       "aux_weight": mcfg.moe_aux_weight},
            "remat_phase_s": t2 - t1}
    mdoc["train"], train_launches = moe_train(torch, tt, topt, kernels,
                                              costs, place, mcfg, dev)
    mdoc["serve"], serve_launches = moe_serve(torch, tt, tlm, kernels,
                                              PagedDecodeEngine, mcfg, dev)
    mdoc["parity"] = {f"top{k}": moe_step_parity(torch, tt, k)
                      for k in (1, 2)}
    mdoc["phase_s"] = time.perf_counter() - t2
    print("moe: " + json.dumps(mdoc))
    out = {k: remat_launches[k] + train_launches[k]
           for k in TRAINING_KERNELS}
    out.update({k: serve_launches[k] for k in SERVING_KERNELS
                + ("fused_sample.threefry",)})
    return out




def train_phase(torch, tt, topt, kernels, costs, place, cfg, dev):
    """``benchmarks/transformer_bench.py``'s ``_run_variant`` on the
    port: bf16, flash attention, dropout 0, Adam(1e-4), one batch from
    RandomState(0) with targets rolled by one; 2 warm-up and 10 timed
    steps, each ended by ``torch.cuda.synchronize()``."""
    params = tt.init_train_params(cfg, torch.Generator().manual_seed(0), dev)
    adam = topt.Adam(learning_rate=1e-4)
    state = adam.tree_init_state(params)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    targets = tokens.roll(-1, 1)

    def step(i):
        nonlocal params, state
        loss = tt.lm_loss(params, tokens, targets, cfg)
        loss.backward()
        params, state = adam.tree_update(i, topt.take_grads(params), params,
                                         state)
        torch.cuda.synchronize()
        return loss.item()

    torch.cuda.reset_peak_memory_stats()
    losses = [step(i) for i in range(WARMUP)]
    kernels.reset_launches()                 # counts of the timed steps
    times = []
    for i in range(WARMUP, WARMUP + TIMED):
        t0 = time.perf_counter()
        losses.append(step(i))
        times.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    p50 = float(np.median(times))
    flops = costs.train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    doc = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps_timed": TIMED,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TIMED / sum(times),
           "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
           "step_ms_max": max(times) * 1e3, "step_flops": flops,
           "train_mfu": costs.mfu(flops, p50, place.peak_flops(dev)),
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    print("train: " + json.dumps(doc))
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    for name in TRAINING_KERNELS + FP32_BRANCHES:
        want = cfg.n_layers * TIMED if name in TRAINING_KERNELS else 0
        if launches[name] != want:
            fail(f"{name} launched {launches[name]} times in {TIMED} "
                 f"steps, expected {want}")
    train_profile(torch, step, WARMUP + TIMED)
    return launches


def profile_window(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity):
    the host-clocked time, the ten device kernels with the most total
    time (name, calls, ms), the device's busy time (the union of its
    kernel and copy intervals) and its share of the host-clocked time,
    or that the trace holds no device time; ``port_kernels``: calls, ms
    and share of the busy time of each of the port's kernels (by name
    fragment), wherever they rank; ``host_top``: the ten host-side
    events (PyTorch operators and CUDA runtime calls) with the most self
    time, which is where the host's share of the window goes (a
    synchronising call's self time is its wait for the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, host = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            calls, us = host.get(ev.name, (0, 0.0))
            host[ev.name] = (calls + 1, us + ev.self_cpu_time_total)
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        calls, us = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (calls + 1, us + (end - start))
    if not spans:
        return {"step_ms": wall_ms, "device_time": "none in the trace"}
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    port = {}
    for frag in PORT_KERNEL_NAMES:
        hits = [v for name, v in by_name.items() if frag in name]
        us = sum(u for _, u in hits)
        port[frag] = {"calls": sum(c for c, _ in hits), "ms": us / 1e3,
                      "busy_share": us / busy}
    return {"step_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms,
            "device_span_ms": (max(e for _, e in spans)
                               - min(s for s, _ in spans)) / 1e3,
            "device_kernels": len(spans),
            "top": [{"name": name[:120], "calls": calls, "ms": us / 1e3}
                    for name, (calls, us) in top],
            "port_kernels": port,
            "host_top": [{"name": name[:80], "calls": calls,
                          "self_ms": us / 1e3} for name, (calls, us) in
                         sorted(host.items(), key=lambda kv: -kv[1][1])[:10]]}


# a fragment of each port kernel's device name, for profile_window
PORT_KERNEL_NAMES = ("decode_split_kernel", "fused_sample_kernel",
                     "chunk_prefill", "span_write_kernel", "flash_fwd",
                     "flash_bwd")


def train_profile(torch, step, i):
    """One more training step under ``torch.profiler``: the
    ``train_profile:`` line (``profile_window``)."""
    print("train_profile: " + json.dumps(profile_window(torch,
                                                        lambda: step(i))))


# ---------------------------------------------------------------------------


# the parallel tier's phase (ROADMAP A10a)
PARALLEL_SGD = {"warmup": 2, "timed": 5}
PARALLEL_LM_STEPS = 3
# GPT-2 small's attention widths over a 4096-token sequence
PARALLEL_RING = {"B": 2, "H": 12, "D": 64, "T": 4096, "P": (4, 8)}
# Tolerances of the ring's schedule, fixed before its first run: against
# kernels 5/6 over the whole sequence, out within 8e-3 of max |out| (bf16
# outputs: each block's out is rounded to bf16 before the fp32 fold), lse
# within 1e-4 absolute (fp32 on both sides), gradients within 1e-2 of
# their max (each block's bf16 dq/dk/dv is summed over P blocks); the
# same against the plain versions run in the same schedule; the int8 hop
# within 0.05 of max |out| (the JAX package's wire tolerance).
RING_OUT_TOL, RING_LSE_TOL, RING_GRAD_TOL, RING_WIRE_TOL = 8e-3, 1e-4, \
    1e-2, 0.05


def parallel_dist(torch, dev) -> tuple:
    """``distributed.init()`` from the launcher's env contract at world
    1: NCCL on ``cuda:0`` (no PADDLE_PLATFORM), a (data, seq, model) =
    (1, 1, 1) mesh, barrier times, one NCCL all-reduce on the card (the
    port's own collectives skip axes of one rank)."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.parallel import spmd
    from paddle_tpu_torch.runtime import launch
    os.environ.update(PADDLE_COORDINATOR=f"127.0.0.1:{launch.free_port()}",
                      PADDLE_NUM_PROCESSES="1", PADDLE_PROCESS_ID="0")
    os.environ.pop("PADDLE_PLATFORM", None)
    t0 = time.perf_counter()
    distributed.init()
    init_s = time.perf_counter() - t0
    if distributed.backend() != "nccl":
        fail(f"parallel: distributed.init chose {distributed.backend()}")
    mesh = place.make_mesh((1, 1, 1), ("data", "seq", "model"))
    barrier_ms = [distributed.barrier("parallel") * 1e3 for _ in range(5)]
    x = torch.ones(4, device=dev)
    tdist.all_reduce(x, group=mesh.get_group("data"))
    if spmd.all_reduce(x, mesh, ("data", "seq", "model")) is not x:
        fail("parallel: an all-reduce over axes of one rank was not skipped")
    if x.device != dev or not bool((x == 1).all()):
        fail(f"parallel: the NCCL all-reduce gave {x} on {x.device}")
    return mesh, {"backend": "nccl", "world": distributed.process_count(),
                  "device": str(x.device), "init_s": init_s,
                  "mesh": place.mesh_shape(mesh),
                  "barrier_ms_median": float(np.median(barrier_ms)),
                  "barrier_ms": barrier_ms}


def parallel_sgd(torch, T, dev, mesh) -> dict:
    """ResNet-50 as the ``trainer:`` phase builds it (batch 128, bf16)
    through ``SGD(parallel=data_parallel(mesh, zero=z))`` for z in {0, 3}
    and ``parallel=None``, from the same parameters: 2 warm-up and 5
    timed batches each; costs and final parameters must be bitwise
    equal at world 1, where the mesh path issues no collective (axes of
    one rank are skipped); the step records' opt-state bytes."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.parallel import spmd
    from paddle_tpu_torch.utils.rng import KeySource
    c = TRAINER_RESNET
    B, d = c["batch"], 3 * c["image"] ** 2
    n = PARALLEL_SGD["warmup"] + PARALLEL_SGD["timed"]
    cost = resnet50_cost(T)
    T.init(seed=5)
    base = T.parameters.create(cost, KeySource(5), device=dev)
    rng = np.random.RandomState(0)
    samples = [(rng.rand(d).astype(np.float32),
                int(rng.randint(c["classes"]))) for _ in range(B)]
    tmp = tempfile.mkdtemp(prefix="parallel-sgd-")
    runs = {}
    for label, z in (("none", None), ("zero0", 0), ("zero3", 3)):
        params = T.parameters.create(cost, KeySource(5), device=dev)
        with torch.no_grad():
            for k in params.values:
                params.values[k].copy_(base.values[k])
            for k in params.state:
                params.state[k].copy_(base.state[k])
        par = None if z is None else spmd.data_parallel(mesh, zero=z)
        tr = T.trainer.SGD(cost=cost, parameters=params,
                           update_equation=T.optimizer.Momentum(
                               momentum=c["momentum"], learning_rate=c["lr"]),
                           parallel=par)
        costs, walls = [], []
        mpath = os.path.join(tmp, f"{label}.jsonl")
        observe.configure(mpath)
        with spmd.record_collectives() as rec:
            tr.train(reader=T.batch(lambda: itertools.islice(
                itertools.cycle(samples), B * n), B), num_passes=1,
                event_handler=lambda e: (costs.append(e.cost),
                                         walls.append(e.wall_time_s))
                if isinstance(e, T.event.EndIteration) else None)
        observe.sink().flush()
        observe.configure(None)
        recs = [r for r in observe.read_jsonl(mpath)
                if r.get("kind") == "step"]
        timed = walls[PARALLEL_SGD["warmup"]:]
        runs[label] = {
            "costs": costs,
            "values": {k: spmd.full(v).detach().clone()
                       for k, v in tr.parameters.values.items()},
            "doc": {"ms_per_batch": float(np.mean(timed)) * 1e3,
                    "ms_per_batch_median": float(np.median(timed)) * 1e3,
                    "opt_state_bytes": sorted({r["opt_state_bytes"]
                                               for r in recs}),
                    "param_bytes": tr.param_bytes_per_device(),
                    "collectives": len([r for r in rec
                                        if r["kind"] != "parameter"])}}
        del tr, params
        torch.cuda.empty_cache()
    doc = {"batch": B, "warmup": PARALLEL_SGD["warmup"],
           "timed": PARALLEL_SGD["timed"]}
    ref = runs["none"]
    for label in ("none", "zero0", "zero3"):
        r = runs[label]
        doc[label] = r["doc"]
        if label == "none":
            continue
        same_costs = r["costs"] == ref["costs"]
        same_params = all(torch.equal(r["values"][k], ref["values"][k])
                          for k in ref["values"])
        dmax = max((r["values"][k] - ref["values"][k]).abs().max().item()
                   for k in ref["values"])
        doc[label].update(costs_bitwise=same_costs,
                          params_bitwise=same_params,
                          max_abs_param_diff=dmax)
        if not (same_costs and same_params):
            fail(f"parallel sgd {label}: not bitwise parallel=None at "
                 f"world 1 (costs {r['costs']} vs {ref['costs']}, max "
                 f"|dparam| {dmax})")
        if r["doc"]["collectives"]:
            fail(f"parallel sgd {label}: {r['doc']['collectives']} "
                 f"collectives over axes of one rank")
    if not all(np.isfinite(ref["costs"])):
        fail(f"parallel sgd: non-finite costs {ref['costs']}")
    doc["costs"] = ref["costs"]
    return doc


def parallel_lm(torch, tt, topt, dev, cfg, mesh) -> dict:
    """GPT-2 small (the ``train:`` recipe: B=8, T=1024, bf16, Adam 1e-4)
    for 3 steps under ``param_shardings`` on the world-1 mesh against
    the unsharded step from the same parameters: losses and parameters
    bitwise, no collective issued (axes of one rank are skipped);
    ``step_ms_p50`` of both."""
    from paddle_tpu_torch.parallel import spmd
    base = tt.init_train_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    targets = tokens.roll(-1, 1)

    def run(sharded):
        p = {k: v.detach().clone().requires_grad_() for k, v in base.items()
             if k != "blocks"}
        p["blocks"] = {k: v.detach().clone().requires_grad_()
                       for k, v in base["blocks"].items()}
        if sharded:
            p = tt.shard_params(p, cfg, mesh, trainable=True)
        adam = topt.Adam(learning_rate=1e-4)
        state = adam.tree_init_state(p)
        losses, times = [], []
        with spmd.record_collectives() as rec:
            for i in range(PARALLEL_LM_STEPS):
                t0 = time.perf_counter()
                loss = tt.lm_loss(p, tokens, targets, cfg,
                                  mesh=mesh if sharded else None)
                loss.backward()
                grads = topt.take_grads(p)
                if sharded:
                    grads = tt.sync_grads(grads, cfg, mesh)
                p, state = adam.tree_update(i, grads, p, state)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(loss.item())
        return losses, p, times, len(rec)

    l0, p0, t0_, _ = run(False)
    l1, p1, t1_, ncoll = run(True)

    def leaves(t):
        return [(k, v) for k, v in t.items() if k != "blocks"] + \
            [("blocks/" + k, v) for k, v in t["blocks"].items()]
    d1 = dict(leaves(p1))
    same = all(torch.equal(v, d1[k]) for k, v in leaves(p0))
    dmax = max((v - d1[k]).abs().max().item() for k, v in leaves(p0))
    doc = {"steps": PARALLEL_LM_STEPS, "losses": l1, "unsharded_losses": l0,
           "losses_bitwise": l0 == l1, "params_bitwise": same,
           "max_abs_param_diff": dmax, "collectives": ncoll,
           "step_ms_p50": float(np.median(t1_)) * 1e3,
           "unsharded_step_ms_p50": float(np.median(t0_)) * 1e3}
    if not (l0 == l1 and same):
        fail(f"parallel lm: the sharded step is not the unsharded one at "
             f"world 1: {doc}")
    if ncoll:
        fail(f"parallel lm: {ncoll} collectives over axes of one rank")
    return doc


# the transformer's mesh paths at GPT-2 small (ROADMAP A10c): the dropout
# step at the train: recipe's shape, the lockstep shapes of lockstep:
PARALLEL_MESH = {"dropout": 0.1, "prefill_B": 4, "prefill_Tp": 128,
                 "generate_new": 32, "beam_B": 2, "beam_K": 4,
                 "beam_new": 16, "slot_bucket": 256, "slot_length": 200,
                 "slot_rows": 4, "slot_cache": 1024}


def parallel_mesh_paths(torch, tt, topt, kernels, dev, cfg, mesh) -> tuple:
    """The ``mesh_paths`` block of the ``parallel:`` line (ROADMAP A10c):
    the transformer's dropout and lockstep mesh paths on the world-1
    mesh, each against the same call unsharded. ``lm_loss`` with dropout
    0.1 at the ``train:`` recipe's B = 8, T = 1024 from one generator
    seed, forward and backward; ``prefill(mesh=)`` at B = 4, Tp = 128;
    greedy ``generate(mesh=)``, 32 new; ``beam_search(mesh=)`` at B = 2,
    K = 4, 16 new; ``prefill_into_slot(mesh=)`` of a 200-token prompt
    in the 256 bucket into row 1 of a 4-row arena. Every output bitwise,
    no collective issued; kernels 5 and 6 counted over the mesh calls
    only. Returns (doc, those launches)."""
    from paddle_tpu_torch.parallel import spmd
    c = PARALLEL_MESH
    t0 = time.perf_counter()
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    records = []

    def on_mesh(fn):
        kernels.reset_launches()
        with spmd.record_collectives() as rec:
            out = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k in launches:
            launches[k] += counts[k]
        records.extend(rec)
        return out

    def same(a, b):
        a, b = list(a), list(b)
        return len(a) == len(b) and all(map(torch.equal, a, b))

    def leaves(t):
        return [v for _, v in topt.tree_leaves(t)]

    doc = {}
    # (1) the dropout step
    dcfg = dataclasses.replace(cfg, dropout=c["dropout"])
    base = tt.init_train_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.RandomState(24)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    targets = tokens.roll(-1, 1)

    def step(sharded):
        p = {k: v.detach().clone().requires_grad_() for k, v in base.items()
             if k != "blocks"}
        p["blocks"] = {k: v.detach().clone().requires_grad_()
                       for k, v in base["blocks"].items()}
        if sharded:
            p = tt.shard_params(p, dcfg, mesh, trainable=True)
        gen = torch.Generator(device=dev).manual_seed(1024)
        loss = tt.lm_loss(p, tokens, targets, dcfg,
                          mesh=mesh if sharded else None, generator=gen)
        loss.backward()
        grads = topt.take_grads(p)
        if sharded:
            grads = tt.sync_grads(grads, dcfg, mesh)
        return loss.detach(), leaves(grads)

    l0, g0 = step(False)
    l1, g1 = on_mesh(lambda: step(True))
    with torch.no_grad():
        plain = tt.lm_loss(base, tokens, targets, cfg)
    doc["dropout"] = {"B": TRAIN_BATCH, "T": TRAIN_SEQ, "rate": c["dropout"],
                      "loss": l1.item(), "loss_without_dropout": plain.item(),
                      "loss_bitwise": torch.equal(l0, l1),
                      "grads_bitwise": same(g0, g1)}
    del base, g0, g1
    torch.cuda.empty_cache()
    # (2)-(5) the serving entry points on the serving dict
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), dev)
    B, Tp = c["prefill_B"], c["prefill_Tp"]
    prompt = torch.from_numpy(np.random.RandomState(25).randint(
        0, cfg.vocab, (B, Tp)).astype(np.int32)).to(dev)
    cl = Tp + c["generate_new"]
    with torch.no_grad():
        a = tt.prefill(params, prompt, cfg, cl)
        b = on_mesh(lambda: tt.prefill(params, prompt, cfg, cl, mesh=mesh))
        doc["prefill"] = {"B": B, "Tp": Tp,
                          "logits_bitwise": torch.equal(a[0], b[0]),
                          "arena_bitwise": same(a[1].values(),
                                                b[1].values())}
        del a, b
        gk = dict(max_new=c["generate_new"])
        a = tt.generate(params, prompt, cfg, **gk)
        b = on_mesh(lambda: tt.generate(params, prompt, cfg, mesh=mesh,
                                        **gk))
        doc["generate"] = {"B": B, "new": c["generate_new"],
                           "ids_equal": torch.equal(a, b)}
        bp = prompt[:c["beam_B"]]
        bk = dict(max_new=c["beam_new"], beam_size=c["beam_K"])
        a = tt.beam_search(params, bp, cfg, **bk)
        b = on_mesh(lambda: tt.beam_search(params, bp, cfg, mesh=mesh, **bk))
        doc["beam_search"] = {"B": c["beam_B"], "K": c["beam_K"],
                              "new": c["beam_new"],
                              "ids_equal": torch.equal(a[0], b[0]),
                              "scores_bitwise": torch.equal(a[1], b[1])}
        Tb, n = c["slot_bucket"], c["slot_length"]
        slot_toks = torch.from_numpy(np.random.RandomState(26).randint(
            0, cfg.vocab, (1, Tb)).astype(np.int32)).to(dev)
        g = torch.Generator(device=dev).manual_seed(26)
        arena = tt.init_cache(cfg, c["slot_rows"], c["slot_cache"], dev)
        for t in arena.values():
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
        arenas = [{k: t.clone() for k, t in arena.items()}
                  for _ in range(2)]
        del arena
        a = tt.prefill_into_slot(params, arenas[0], slot_toks, n, 1, cfg)
        b = on_mesh(lambda: tt.prefill_into_slot(
            params, arenas[1], slot_toks, n, 1, cfg, mesh=mesh))
        doc["prefill_into_slot"] = {
            "bucket": Tb, "length": n, "rows": c["slot_rows"],
            "logits_bitwise": torch.equal(a[0], b[0]),
            "arena_bitwise": same(arenas[0].values(), arenas[1].values())}
    del params, arenas
    torch.cuda.empty_cache()
    doc.update(collectives=len(records), launches=dict(launches),
               block_s=time.perf_counter() - t0)
    gates = [doc["dropout"]["loss_bitwise"], doc["dropout"]["grads_bitwise"],
             doc["prefill"]["logits_bitwise"],
             doc["prefill"]["arena_bitwise"], doc["generate"]["ids_equal"],
             doc["beam_search"]["ids_equal"],
             doc["beam_search"]["scores_bitwise"],
             doc["prefill_into_slot"]["logits_bitwise"],
             doc["prefill_into_slot"]["arena_bitwise"]]
    if not all(gates):
        fail(f"parallel mesh_paths: a mesh call is not its unsharded call "
             f"at world 1: {doc}")
    if records:
        fail(f"parallel mesh_paths: {len(records)} collectives over axes "
             f"of one rank")
    if not all(launches.values()):
        fail(f"parallel mesh_paths: kernels 5/6 not launched: {launches}")
    if doc["dropout"]["loss"] == doc["dropout"]["loss_without_dropout"]:
        fail("parallel mesh_paths: dropout 0.1 left the loss unchanged")
    return doc, launches


def parallel_ring(torch, ka, kernels, q8, timer, build, dev) -> tuple:
    """The flash ring's schedule at P = 4 and 8 virtual ranks on the
    card (``parallel.ring.ring_flash_schedule``: the loops
    ``ring_flash_attention`` runs, the hop a rotation of the rank list)
    at GPT-2 small's attention widths over T = 4096, bf16, causal:
    forward and backward against kernels 5/6 over the whole sequence
    and against their plain versions in the same schedule; the masked
    blocks' backward exactly 0; the int8 hop's codes against the CPU's;
    kernels 5/6 at the all-to-all layout [B*H/P, T, D]; the launches;
    and rows 5r / 6r (kernels 5/6 at the ring's block shape, timed)."""
    from paddle_tpu_torch.parallel import ring
    c = PARALLEL_RING
    B, H, D, T = c["B"], c["H"], c["D"], c["T"]
    g = torch.Generator(device=dev).manual_seed(4096)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))

    def rows(x):
        return x.transpose(1, 2).reshape(B * H, T, D).contiguous()
    scale = D ** -0.5
    w_out, w_lse = ka.flash_attention_fwd(rows(q), rows(k), rows(v),
                                          sm_scale=scale, causal=True)
    w_grads = ka.flash_attention_bwd(rows(q), rows(k), rows(v), w_out,
                                     w_lse, rows(do), sm_scale=scale,
                                     causal=True)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    doc = {"B": B, "H": H, "D": D, "T": T, "dtype": "bfloat16",
           "causal": True}
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    for P in c["P"]:
        masked = {e: {"blocks": 0, "nonzero": 0, "nonfinite": 0}
                  for e in ("kernel", "plain")}

        def on_block(engine):
            def see(phase, r, src, outs):
                if src > r:
                    m = masked[engine]
                    m["blocks"] += 1
                    m["nonzero"] += sum(int((x != 0).sum()) for x in outs)
                    m["nonfinite"] += sum(int((~torch.isfinite(x)).sum())
                                          for x in outs)
            return see
        kernels.reset_launches()
        out, lse, dq, dk, dv = ring.ring_flash_schedule(
            q, k, v, P, causal=True, do=do, on_block=on_block("kernel"))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for name in launches:
            launches[name] += counts[name]
        pl = ring.ring_flash_schedule(q, k, v, P, causal=True, do=do,
                                      engine="plain",
                                      on_block=on_block("plain"))
        got = {"out": rows(out), "dq": rows(dq), "dk": rows(dk),
               "dv": rows(dv)}
        whole = {"out": w_out, "dq": w_grads[0], "dk": w_grads[1],
                 "dv": w_grads[2]}
        plain = {"out": rows(pl[0]), "dq": rows(pl[2]), "dk": rows(pl[3]),
                 "dv": rows(pl[4])}
        d = {"T_local": T // P, "masked_blocks": masked,
             "launches": {n: counts[n] for n in launches},
             "lse_abs_err": (lse - w_lse).abs().max().item(),
             "lse_abs_err_plain": (lse - pl[1]).abs().max().item()}
        for name in got:
            d[f"{name}_rel_err"] = rel(got[name], whole[name])
            d[f"{name}_rel_err_plain"] = rel(got[name], plain[name])
        # the int8 hop: the card's codes against the CPU's for each
        # rotating K block, and the schedule's output over that wire
        blk = k[:, :T // P]
        cq, cs = q8.wire_encode(blk)
        hq, hs = q8.wire_encode(blk.cpu())
        d["wire_codes_equal"] = bool(torch.equal(cq.cpu(), hq)) and \
            float(cs) == float(hs)
        wired = ring.ring_flash_schedule(
            q, k, v, P, causal=True,
            hop=lambda x: q8.wire_decode(*q8.wire_encode(x), x.dtype))
        d["wire_out_rel_err"] = rel(rows(wired[0]), w_out)
        want = P * P
        doc[f"P{P}"] = d
        print(f"check ring P={P}: " + json.dumps(d))
        bad = [n for n in got if d[f"{n}_rel_err"] > (
            RING_OUT_TOL if n == "out" else RING_GRAD_TOL)
            or d[f"{n}_rel_err_plain"] > (
            RING_OUT_TOL if n == "out" else RING_GRAD_TOL)]
        if bad or max(d["lse_abs_err"], d["lse_abs_err_plain"]) > \
                RING_LSE_TOL:
            fail(f"ring P={P}: disagrees ({bad}): {d}")
        if any(m["nonzero"] or m["nonfinite"] or
               m["blocks"] != P * (P - 1) // 2 for m in masked.values()):
            fail(f"ring P={P}: masked blocks not exactly 0: {masked}")
        if not d["wire_codes_equal"] or d["wire_out_rel_err"] > \
                RING_WIRE_TOL:
            fail(f"ring P={P}: the int8 hop: {d}")
        if counts["flash_attention_fwd"] != want or \
                counts["flash_attention_bwd"] != want:
            fail(f"ring P={P}: launches {counts}, expected {want} each")
        # the all-to-all layout: kernels 5/6 at [B*H/P, T, D]
        a_err, a_ulps, a_rep, _ = check_flash(
            torch, timer, ka, build, dev, 1, T, B * H // P, B * H // P, D,
            torch.bfloat16, True, False)
        doc[f"alltoall_P{P}"] = {"BH": B * H // P, "err": a_err,
                                 "bf16_ulps": a_ulps, "bitwise_repeat": a_rep}
        if max(a_ulps.values()) > FLASH_BF16_ULPS or not a_rep:
            fail(f"all-to-all layout P={P}: {doc[f'alltoall_P{P}']}")
    # rows 5r / 6r: the ring's off-diagonal block (P = 4: T_local 1024,
    # full attention), timed with the library call at the same shape
    err, ulps, rep, times = check_flash(torch, timer, ka, build, dev, B,
                                        T // c["P"][0], H, H, D,
                                        torch.bfloat16, False, True)
    out_rows = {}
    for part in ("fwd", "bwd"):
        if ulps[part] > FLASH_BF16_ULPS or not rep:
            fail(f"ring block flash_attention_{part}: {ulps} {rep}")
        out_rows[f"flash_attention_{part}.ring"] = (
            max(err[part]), {"bf16_ulps": ulps[part], "bitwise_repeat": rep,
                             "shape": [B * H, T // c["P"][0], D],
                             "causal": False}, times[part])
    return doc, out_rows, launches


def parallel_phase(torch, T, tt, topt, ka, kernels, q8, build, cfg,
                   dev) -> tuple:
    """The ``parallel:`` line (ROADMAP A10a, A10c): ``dist``, ``sgd``,
    ``lm``, ``mesh_paths`` and ``ring`` (module docstring, item 16).
    Returns the ring rows, the ring run's kernel 5/6 launches and the
    mesh paths' kernel 5/6 launches."""
    from paddle_tpu_torch import distributed
    t_phase = time.perf_counter()
    timer = Timer(torch)
    mesh, dist_doc = parallel_dist(torch, dev)
    try:
        doc = {"dist": dist_doc}
        doc["sgd"] = parallel_sgd(torch, T, dev, mesh)
        torch.cuda.empty_cache()
        doc["lm"] = parallel_lm(torch, tt, topt, dev, cfg, mesh)
        torch.cuda.empty_cache()
        doc["mesh_paths"], mesh_launches = parallel_mesh_paths(
            torch, tt, topt, kernels, dev, cfg, mesh)
        torch.cuda.empty_cache()
        doc["ring"], ring_rows, ring_launches = parallel_ring(
            torch, ka, kernels, q8, timer, build, dev)
    finally:
        distributed.shutdown()
    doc["phase_s"] = time.perf_counter() - t_phase
    print("parallel: " + json.dumps(doc))
    return ring_rows, ring_launches, mesh_launches


# the elastic gang at world 1 (``gang:`` line): ResNet-50 at full width as
# the ``trainer:`` phase builds it (bf16), batch 32, 8 steps, a checkpoint
# every 2, each on disk before the next step ends (the worker waits: the
# writer takes 1.1-1.8 s a ~205 MB save, longer than 3 steps); the killed
# run loses its one rank at the top of step 5 of its first incarnation,
# so it resumes from the step-4 checkpoint
GANG = {"batch": 32, "steps": 8, "period": 2,
        "chaos": "kill@step:step=5:epoch=1"}


def gang_run(label, tmp, chaos=None) -> dict:
    """One supervised gang of ``tests/torch_elastic_worker.py`` at world 1
    (``cluster=True``: the worker joins a process group through
    ``distributed.init``); the supervisor's result, its ledger and the
    worker's files."""
    from paddle_tpu_torch.runtime import supervisor as sup
    c = GANG
    out = Path(tmp, label)
    worker = Path(__file__).resolve().parent / "tests" / \
        "torch_elastic_worker.py"
    env = {"ELASTIC_MODEL": "resnet50", "ELASTIC_OUT": str(out),
           "ELASTIC_NB": str(c["steps"]), "ELASTIC_BS": str(c["batch"]),
           "PADDLE_TPU_CHECKPOINT_PERIOD": str(c["period"]),
           "ELASTIC_SYNC_SAVES": "1",
           "PADDLE_TPU_COMPUTE_DTYPE": "bfloat16",
           "PADDLE_DIST_TIMEOUT_S": "120"}
    if chaos:
        env["PADDLE_TPU_CHAOS"] = chaos
    s = sup.Supervisor([str(worker)], nprocs=1,
                       state_dir=str(out / "state"), cluster=True,
                       env_extra=env, heartbeat_window=60.0,
                       startup_grace=180.0, poll_interval=0.1,
                       backoff_base=0.1, backoff_cap=0.5, max_restarts=2,
                       attempt_timeout=240.0)
    try:
        res = s.run(total_timeout=400)
    finally:
        s.close()
    t_end = time.time()
    if not res["ok"]:
        fail(f"gang: the {label} gang failed: {res}")
    e = res["epoch"]
    done = json.loads((out / f"done_rank0_epoch{e}.json").read_text())
    losses = {}
    for ln in Path(out, f"losses_rank0_epoch{e}.jsonl").open():
        rec = json.loads(ln)
        losses[rec["step"]] = rec
    final = dict(np.load(out / f"final_rank0_epoch{e}.npz"))
    att = res["attempts"]
    walls = [round(a.get("t_detect", t_end) - a["t_launch"], 3) for a in att]
    ledger = s.ledger.summary()
    doc = {"ok": res["ok"], "restarts": res["restarts"], "epoch": e,
           "backend": done["backend"], "device": done["device"],
           "final_step": done["step"], "incarnation_wall_s": walls,
           "checkpoint_write_s": done["checkpoint_write_s"],
           "startup_s": [ledger["epochs"][str(a["epoch"])].get("startup")
                         for a in att],
           "goodput_fraction": ledger["goodput_fraction"],
           "ledger_totals": ledger["totals"]}
    if len(att) > 1:
        first = att[0]
        killed = [json.loads(ln) for ln in
                  Path(out, "losses_rank0_epoch1.jsonl").open()]
        doc.update(
            reason=first["reason"], failed_ranks=first["failed_ranks"],
            steps_before_kill=len(killed),
            kill_to_detect_s=round(first["t_detect"] - killed[-1]["t"], 3),
            restart_gap_s=ledger["epochs"][str(e)].get("restart_gap"),
            recovery_seconds=att[1].get("recovery_seconds"),
            resumed_at_step=min(losses))
    return {"doc": doc, "losses": losses, "final": final}


def gang_gap(torch, a, b) -> float:
    """The ``trainer:`` gate's measure between two runs: max |a - b| over
    max |b| per parameter, and over the losses of the steps both ran."""
    worst = max(rel_err(torch, torch.from_numpy(a["final"][k]),
                        torch.from_numpy(b["final"][k]))
                for k in b["final"])
    steps = sorted(a["losses"])
    la = torch.tensor([a["losses"][i]["loss"] for i in steps])
    lb = torch.tensor([b["losses"][i]["loss"] for i in steps])
    return max(worst, rel_err(torch, la, lb))


def gang_bitwise(a, b) -> bool:
    return (sorted(a["final"]) == sorted(b["final"])
            and all(np.array_equal(a["final"][k], b["final"][k])
                    for k in b["final"])
            and all(a["losses"][i]["loss"] == b["losses"][i]["loss"]
                    for i in a["losses"]))


def gang_phase(torch, t_script) -> dict:
    """The ``gang:`` line (ROADMAP A10b): the elastic supervisor over
    world-1 gangs on the card (module docstring, item 17). The workers
    join NCCL on ``cuda:0`` with ``PADDLE_PLATFORM`` cleared: the backend
    and the device are asserted, never fallen back from."""
    t_phase = time.perf_counter()
    os.environ.pop("PADDLE_PLATFORM", None)
    os.environ.pop("PADDLE_TPU_CHAOS", None)
    doc = {"model": "resnet50", **GANG}
    with tempfile.TemporaryDirectory() as tmp:
        # the two gangs run side by side on the card (their supervisors
        # in two threads): an incarnation is ~3/4 process startup
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            killed_f = ex.submit(gang_run, "killed", tmp, GANG["chaos"])
            plain, killed = gang_run("plain", tmp), killed_f.result()
        doc["plain"], doc["killed"] = plain["doc"], killed["doc"]
        for label, run in (("plain", plain), ("killed", killed)):
            d = run["doc"]
            if (d["backend"], d["device"]) != ("nccl", "cuda:0"):
                fail(f"gang: the {label} gang ran on {d['backend']} / "
                     f"{d['device']}, not NCCL on cuda:0")
            if d["final_step"] != GANG["steps"]:
                fail(f"gang: the {label} gang ended at step "
                     f"{d['final_step']}: {d}")
        k = killed["doc"]
        if not (k["restarts"] == 1 and k["epoch"] == 2
                and k.get("reason") == "worker_exit:-9"
                and k.get("failed_ranks") == [0]
                and k.get("steps_before_kill") == 5
                and k.get("resumed_at_step") == 4):
            fail(f"gang: the killed gang was not judged and resumed as "
                 f"expected: {k}")
        if plain["doc"]["restarts"] != 0:
            fail(f"gang: the plain gang restarted: {plain['doc']}")
        # the gate: bitwise where two uninterrupted gangs are bitwise
        # (resume_gate's resnet_repeat_bitwise rule), else the trainer:
        # gate's bound
        doc["resumed_bitwise"] = gang_bitwise(killed, plain)
        doc["gap"] = gang_gap(torch, killed, plain)
        if doc["resumed_bitwise"]:
            doc["gate"] = "bitwise"
        else:
            repeat = gang_run("repeat", tmp)
            doc["repeat_bitwise"] = gang_bitwise(repeat, plain)
            if doc["repeat_bitwise"]:
                fail(f"gang: two uninterrupted gangs are bitwise but the "
                     f"resumed one is {doc['gap']!r} from them")
            if not doc["gap"] <= TRAINER_RESNET_REL:
                fail(f"gang: the resumed gang is {doc['gap']!r} from the "
                     f"uninterrupted one > {TRAINER_RESNET_REL!r}")
            doc["gate"] = f"within {TRAINER_RESNET_REL!r}"
        steps = [r["wall_s"] for i, r in sorted(plain["losses"].items())
                 if i > 0]
        doc["step_ms_p50"] = 1e3 * float(np.median(steps))
    doc["phase_s"] = time.perf_counter() - t_phase
    doc["script_s"] = time.perf_counter() - t_script
    print("gang: " + json.dumps(doc))
    return doc


SOURCES = {
    "flash_decode_attention": ("decode_attention.cu",
                               "paddle_tpu/ops/pallas/decode.py:382"),
    "fused_sample": ("fused_sample.cu",
                     "paddle_tpu/ops/pallas/decode.py:558"),
    # the same kernel on the threefry stream: the paged prefill tail,
    # where the JAX package samples with sample_tokens and jax.random
    "fused_sample.threefry": ("fused_sample.cu",
                              "paddle_tpu/ops/pallas/decode.py:558"),
    "flash_chunk_prefill": ("chunk_prefill.cuh",
                            "paddle_tpu/ops/pallas/prefill.py:314"),
    "paged_span_write": ("span_write.cu",
                         "paddle_tpu/ops/pallas/prefill.py:442"),
    "flash_attention_fwd": ("flash_attn_fwd.cuh",
                            "paddle_tpu/ops/pallas/attention.py:351"),
    "flash_attention_bwd": ("flash_attn_bwd.cuh",
                            "paddle_tpu/ops/pallas/attention.py:268"),
    # the same TPU kernels for fp32 inputs: the fp32 (three-term)
    # instantiations of the same kernels
    "flash_attention_fwd.fp32": ("flash_attn_fwd.cuh",
                                 "paddle_tpu/ops/pallas/attention.py:351"),
    "flash_attention_bwd.fp32": ("flash_attn_bwd.cuh",
                                 "paddle_tpu/ops/pallas/attention.py:268"),
}
SERVING_KERNELS = ("flash_decode_attention", "fused_sample",
                   "flash_chunk_prefill", "paged_span_write")
# the quantized branches of kernels 1, 3 and 4, each its own entry: the
# same source, the TPU kernel's kv_dtype="int8"/"int4" path
QUANT_BRANCHES = tuple(f"{k}.{kvd}" for kvd in ("int8", "int4")
                       for k in SERVING_KERNELS if k != "fused_sample")
SOURCES.update({b: SOURCES[b.split(".")[0]] for b in QUANT_BRANCHES})
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
FP32_BRANCHES = tuple(f"{k}.fp32" for k in TRAINING_KERNELS)
# fp32 queries of kernels 1 and 3: the fp32 instantiations of the decode
# and prefill kernels, launched by the fp32 step functions
# (``step_parity``) under the pool storage "none"
PAGED_FP32 = ("flash_decode_attention", "flash_chunk_prefill")
SOURCES["flash_decode_attention.fp32"] = SOURCES["flash_decode_attention"]
SOURCES["flash_chunk_prefill.fp32"] = SOURCES["flash_chunk_prefill"]
# kernel 2 at a speculative verify window's rows, through the entry point
# that reaches it there (its launches: the spec trace's)
SOURCES["fused_spec_verify"] = ("fused_sample.cu",
                                "paddle_tpu/ops/pallas/decode.py:589")
# kernels 5 and 6 at the flash ring's block shapes, through the block
# entries the ring drives (their launches: the ring schedule's)
SOURCES["flash_attention_fwd.ring"] = ("flash_attn_fwd.cuh",
                                       "paddle_tpu/ops/pallas/attention.py:330")
SOURCES["flash_attention_bwd.ring"] = ("flash_attn_bwd.cuh",
                                       "paddle_tpu/ops/pallas/attention.py:341")


def main():
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if importlib.util.find_spec("paddle_tpu_torch") is None:
        fail("paddle_tpu_torch is not beside chip_smoke.py")
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.io import lm_serving as tlm
    from paddle_tpu_torch.models import transformer as tt
    from paddle_tpu_torch.observe import costs
    from paddle_tpu_torch.ops import kernels, q8
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import attention as ka
    from paddle_tpu_torch.ops.kernels import decode as kd
    from paddle_tpu_torch.ops.kernels import prefill as kp
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.serving import (DecodeEngine, PagedDecodeEngine,
                                          SpecDecodeEngine, sampling)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = sh([_build.nvcc_path(), "--version"]).splitlines()[-1]
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "capability": list(torch.cuda.get_device_capability(0)),
           "nvcc": nvcc,
           "triton": importlib.util.find_spec("triton") is not None,
           "cutlass_include": Path("/usr/local/cutlass/include").exists(),
           "card": card, "tf32": False}
    print("env: " + json.dumps(env))

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"build: nvcc_s={info['seconds']!r} load_s="
          f"{time.perf_counter() - t0!r} dir={info['dir']}")

    print("ptxas: " + json.dumps(ptxas_summary(
        info["dir"], ("decode_attention", "chunk_prefill",
                      "chunk_prefill_fp32_d32_128",
                      "chunk_prefill_fp32_d64_96", "flash_attn_fwd",
                      "flash_attn_fwd_fp32_inst", "flash_attn_bwd",
                      "flash_attn_bwd_fp32_inst", "fused_sample",
                      "span_write"))))

    dev = torch.device("cuda:0")
    rows = {**kernel_phase(torch, kd, kp, q8, _build),
            **flash_phase(torch, ka, _build)}
    kernels.reset_launches()            # counts of the fp32 step functions
    step_parity(torch, tt)
    fp32_steps = kernels.launch_counts()
    if not all(fp32_steps[k] > 0 for k in PAGED_FP32):
        fail(f"the fp32 step functions launched no fp32 paged kernel: "
             f"{fp32_steps}")
    kernels.reset_launches()            # fp32 queries over an int8 pool
    step_parity_quant(torch, tt, tlm, q8)
    int8_steps = kernels.launch_counts()
    print("steps launches: " + json.dumps({
        "fp32": {k: fp32_steps[k] for k in PAGED_FP32},
        "fp32_int8_pool": {k + ".int8": int8_steps[k + ".int8"]
                           for k in PAGED_FP32}}))
    if not all(int8_steps[k + ".int8"] > 0 for k in PAGED_FP32):
        fail(f"the int8-pool fp32 step functions launched no int8 paged "
             f"kernel: {int8_steps}")
    parity = train_parity(torch, tt, topt, kernels)
    cfg = gpt2_small(tt)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), dev)
    graph_phase(torch, tt, sampling, cfg, params, dev)
    served, single = engine_phase(torch, tt, kernels, PagedDecodeEngine,
                                  cfg, dev, params, None, "engine", "")
    # (b) int4 pool, bf16 weights
    served4, _ = engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg,
                              dev, params, "int4", "engine_int4", ".int4")
    preempt_phase(torch, PagedDecodeEngine, cfg, dev, params)
    prefix_phase(torch, kernels, PagedDecodeEngine, cfg, dev, params)
    fleet_launches, colocated = fleet_phase(torch, kernels, tlm,
                                            PagedDecodeEngine, cfg, dev,
                                            params, single)
    autoscale_launches = autoscale_phase(torch, kernels, tlm,
                                         PagedDecodeEngine, cfg, dev, params,
                                         single, colocated, t_script)
    spec_launches, rows["fused_spec_verify"] = spec_phase(
        torch, tt, tlm, kd, q8, _build, kernels, sampling, PagedDecodeEngine,
        SpecDecodeEngine, cfg, dev, params)
    slot_launches = slots_phase(torch, tt, kernels, sampling, ka, _build,
                                DecodeEngine, PagedDecodeEngine, cfg, dev,
                                params)
    kernels.reset_launches()            # counts of the lockstep calls
    lockstep_phase(torch, tt, tlm, prng, DecodeEngine, cfg, dev, params)
    lock_launches = kernels.launch_counts()
    if lock_launches["flash_attention_fwd"] <= 0:
        fail(f"lockstep: kernel 5 never launched: {lock_launches}")
    quant_logits_phase(torch, tt, cfg, params, dev)
    del params                  # (a)'s peak memory holds its weights only
    # (a) int8 pool, int8 weights from the same seed-0 fp32 draws
    fp32 = tt.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w8 = tlm.quantize_lm_params(fp32, device=dev)
    del fp32
    served8, _ = engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg,
                              dev, w8, "int8", "engine_int8", ".int8")
    del w8
    ops_phase(torch, dev)
    layers_phase(torch, dev)
    trainer_phase(torch, dev)
    torch.cuda.empty_cache()
    input_phase(torch, dev)
    torch.cuda.empty_cache()
    book_phase(torch, dev)
    torch.cuda.empty_cache()
    a9 = a9_phase(torch, tt, topt, tlm, kernels, costs, place,
                  PagedDecodeEngine, cfg, dev)
    torch.cuda.empty_cache()
    import paddle_tpu_torch as T
    ring_rows, ring_launches, mesh_launches = parallel_phase(
        torch, T, tt, topt, ka, kernels, q8, _build, cfg, dev)
    rows.update(ring_rows)
    torch.cuda.empty_cache()
    gang_phase(torch, t_script)
    trained = train_phase(torch, tt, topt, kernels, costs, place, cfg, dev)
    launches = {**{k: served[k] for k in SERVING_KERNELS},
                "fused_sample.threefry": served["fused_sample.threefry"],
                **{k: served8[k] for k in QUANT_BRANCHES if "int8" in k},
                **{k: served4[k] for k in QUANT_BRANCHES if "int4" in k},
                **{k: trained[k] for k in TRAINING_KERNELS},
                **{k: parity[k] for k in FP32_BRANCHES},
                **{k + ".fp32": fp32_steps[k] for k in PAGED_FP32},
                "fused_spec_verify": spec_launches["fused_spec_verify"],
                **{k + ".ring": n for k, n in ring_launches.items()}}
    # the slot engine's trace and the lockstep calls run kernels 2 and 5
    for k in ("fused_sample", "fused_sample.threefry", "flash_attention_fwd"):
        launches[k] += slot_launches[k] + lock_launches[k]
    # the fleet's replicas run kernels 1-4, in this process (the
    # replicas of the process fleet and the CLI count in their own)
    for k in SERVING_KERNELS + ("fused_sample.threefry",):
        launches[k] += fleet_launches[k] + autoscale_launches[k]
    # the MoE engine runs kernels 1-4, remat and MoE training 5 and 6
    for k, n in a9.items():
        launches[k] += n
    # the transformer's mesh paths run kernels 5 and 6
    for k, n in mesh_launches.items():
        launches[k] += n

    out = []
    for name, (src, replaces) in SOURCES.items():
        err, extra, times = rows[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, **extra, **times})
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
