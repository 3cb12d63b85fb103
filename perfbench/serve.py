"""The serving driver: a closed loop of clients over the port's
``PagedDecodeEngine``.

Set-up makes the weights from the seed on the card, builds the engine
the configuration file's ``engine`` object describes, captures every
chunk-prefill program the mix can reach and the decode program, then
runs the loop until ``warm_completions`` requests have completed, so
that the first wave of requests, all started together, is not measured.
The window then drives ``submit`` / ``step`` for ``--seconds``; a traced
run goes on for ``profile_steps`` steps under the profiler. The loop
keeps its load after the window until every request that arrived in it
has finished. Once the program's state is freed, the plain reference
judges a sample of the greedy requests the window finished.
"""

import gc
import time
from typing import Dict, List

import numpy as np

from perfbench import harness, reference, traffic, weights

KERNELS = {"decode": "decode_split_kernel",
           "prefill": "chunk_prefill_tc_kernel"}
DRAIN_LIMIT_S = 60.0       # a window arrival unfinished by then failed


class Recorder:
    """The benchmark's spans and counts around the calls into the
    engine's step programs: every prefill chunk's (context offset,
    tokens), every decode step's active positions and the engine's own
    decode-step seconds, kept while ``on``."""

    def __init__(self, torch, eng, block_size: int):
        self.on = False
        self.prefills: List[tuple] = []
        self.decodes: List[np.ndarray] = []
        self.decode_s: List[float] = []
        prefill, decode = eng._prefill_fn, eng._decode_fn
        account = eng._account_step
        span = torch.profiler.record_function

        def prefill_call(*args):
            # (params, pool, tokens [1, bucket], length, pages [P], ...)
            bucket, c, npages = args[2].shape[1], int(args[3]), len(args[4])
            if self.on:
                off = (npages - -(-bucket // block_size)) * block_size
                self.prefills.append((off, c))
            with span("perfbench.prefill_program"):
                return prefill(*args)

        def decode_call(*args):
            # (params, pool, tokens [B], pos [B], active [B], ...)
            if self.on:
                self.decodes.append(args[3][args[4]].copy())
            with span("perfbench.decode_program"):
                return decode(*args)

        def account_step(dt, flops):
            if self.on:
                self.decode_s.append(dt)
            return account(dt, flops)

        eng._prefill_fn, eng._decode_fn = prefill_call, decode_call
        eng._account_step = account_step

    def take(self) -> dict:
        out = {"prefills": self.prefills, "decodes": self.decodes,
               "decode_s": self.decode_s}
        self.prefills, self.decodes, self.decode_s = [], [], []
        return out


class Loop:
    """The closed loop: each client sends its next request when its last
    one completes."""

    def __init__(self, torch, eng, seq: traffic.Sequence, clients: int):
        self.torch, self.eng, self.seq = torch, eng, seq
        self.client_of: Dict[int, int] = {}
        self.reqs = []                     # (Request, EngineRequest)
        self.completed = 0
        for c in range(clients):
            self._send(c)

    def _send(self, client: int):
        r = self.seq.next()
        er = self.eng.submit(r.prompt, r.max_new, temperature=r.temperature,
                             top_k=r.top_k)
        self.client_of[er.rid] = client
        self.reqs.append((r, er))

    def step(self):
        with self.torch.profiler.record_function("perfbench.engine_step"):
            done = self.eng.step()
        with self.torch.profiler.record_function("perfbench.clients"):
            for er in done:
                self.completed += 1
                self._send(self.client_of.pop(er.rid))


def build_engine(torch, tt, model: dict, seed: int, device):
    from paddle_tpu_torch.serving.engine import PagedDecodeEngine
    sz = weights.sizes(model)
    cfg = tt.TransformerConfig(vocab=sz.vocab, d_model=sz.d_model,
                               n_heads=sz.n_heads, n_layers=sz.n_layers,
                               d_ff=sz.d_ff, max_len=sz.max_len,
                               dtype=torch.bfloat16)
    params = weights.tree(torch, sz, seed, device,
                          matmul_dtype=torch.bfloat16)
    e = model["engine"]
    eng = PagedDecodeEngine.from_params(
        params, cfg, batch=e["slots"], cache_len=e["cache_len"],
        block_size=e["block_size"], num_blocks=e["num_blocks"],
        chunk_tokens=e["chunk_tokens"],
        seed=weights.torch_seed(seed, 7) % (1 << 32), device=device)
    return sz, eng


def warm_programs(eng, mix: dict, vocab: int, seed: int):
    """Capture every prefill program the mix can reach (one request per
    (context offset, chunk bucket), two tokens each) and the decode
    program, then drain."""
    rng = np.random.default_rng(weights.torch_seed(seed, 11))
    for off, b in traffic.prefill_keys(mix, eng.chunk_tokens, eng.buckets,
                                       eng.block_size):
        # the last chunk fills its bucket, leaving room for two tokens
        n = min(off + b, eng.cache_len - 2)
        eng.submit(rng.integers(0, vocab, size=n, dtype=np.int32), 2)
    eng.run_until_idle()


def run(torch, cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, fault=None) -> dict:
    from paddle_tpu_torch.models import transformer as tt
    mix = cell["traffic"]
    sz, eng = build_engine(torch, tt, cell["model"], seed, device)
    if fault is not None:
        fault(eng)
    rec = Recorder(torch, eng, eng.block_size)
    warm_programs(eng, mix, sz.vocab, seed)
    loop = Loop(torch, eng, traffic.Sequence(mix, sz.vocab, seed),
                mix["clients"])
    while loop.completed < mix["warm_completions"]:
        loop.step()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()

    # -- the window -----------------------------------------------------
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    at_open = {er.rid: len(er.tokens) for _, er in loop.reqs}
    captures0 = sum(eng.compile_counts().values())
    occupancy = []
    rec.on = True
    while time.perf_counter() - t_open < seconds:
        loop.step()
        occupancy.append(eng.active_count)
    if cuda:
        torch.cuda.synchronize()
    t_close = time.perf_counter()
    rec.on = False
    window_s = t_close - t_open
    captures = sum(eng.compile_counts().values()) - captures0
    tokens = sum(len(er.tokens) - at_open.get(er.rid, 0)
                 for _, er in loop.reqs
                 if er.rid in at_open or er.submit_t >= t_open)
    arrivals = [(r, er) for r, er in loop.reqs
                if t_open <= er.submit_t < t_close]
    window = rec.take()

    traced = None
    if trace:
        traced = profile_steps(torch, loop, rec, mix["profile_steps"])

    # -- drain: the window's arrivals finish under the same load ----------
    t_drain = time.perf_counter()
    while (any(er.finish_t is None for _, er in arrivals)
           and time.perf_counter() - t_drain < DRAIN_LIMIT_S):
        loop.step()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    done = [(r, er) for r, er in arrivals if er.finish_t is not None]
    failed = len(arrivals) - len(done)

    ttft = [(er.first_token_t - er.submit_t) * 1e3 for _, er in done]
    tpot = [(er.finish_t - er.first_token_t) * 1e3 / (len(er.tokens) - 1)
            for _, er in done if len(er.tokens) > 1]
    e2e = {"serve_tokens_per_s": tokens / window_s,
           "ttft_p95_ms": harness.percentile(ttft, 95),
           "tpot_p95_ms": harness.percentile(tpot, 95),
           "setup_s": setup_s}
    ctx = {"model": sz, "block_size": eng.block_size, "slots": eng.batch,
           "window_s": window_s, "occupancy": occupancy,
           "captures": captures,
           "queue_wait_s": [er.queue_wait_s for _, er in done],
           "prefill_own_s": [er.prefill_own_s for _, er in done],
           "prompt_lens": [int(r.prompt.size) for r, _ in done],
           "chunk_tokens": eng.chunk_tokens, **window,
           "trace": traced}
    sample = check_sample(done, seed, mix["check_requests"])
    attempted = len(arrivals)
    del eng, loop, rec, arrivals, done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = judge(torch, cell["model"], sz, seed, device, sample, control)
    limit = cell["limits"]["max_gap"]
    checks = {"max_gap": (gaps["gap"], limit), "unfinished": (failed, 0)}
    return {"correct": gaps["gap"] <= limit and failed == 0,
            "attempted": attempted, "failed": failed,
            "e2e": e2e, "ctx": ctx, "trace": traced, "peak_bytes": peak,
            "checks": checks, "control": gaps.get("control_gap"),
            "sample_tokens": sum(len(s) for _, s in sample)}


def profile_steps(torch, loop: Loop, rec: Recorder, steps: int) -> dict:
    """``steps`` engine steps under ``torch.profiler``, after a short
    profile that starts the profiler's device tracing outside them."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        loop.step()
        torch.cuda.synchronize()
    rec.on = True
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loop.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    rec.on = False
    doc = harness.read_trace(prof, window_s, KERNELS)
    doc.update(rec.take())
    return doc


def check_sample(done, seed: int, n: int) -> List[tuple]:
    """The greedy requests the reference judges: the one with the most
    served tokens, and others drawn from the seed, up to ``n``."""
    greedy = [(r.prompt.tolist(), list(er.tokens)) for r, er in done
              if r.greedy]
    if not greedy:
        return []
    longest = max(range(len(greedy)),
                  key=lambda i: (len(greedy[i][1]), len(greedy[i][0])))
    rest = [i for i in range(len(greedy)) if i != longest]
    rng = np.random.default_rng(weights.torch_seed(seed, 13))
    pick = rng.permutation(rest)[:max(n - 1, 0)].tolist()
    return [greedy[i] for i in [longest] + pick]


def judge(torch, model: dict, sz, seed: int, device, sample,
          control: bool) -> dict:
    """The widest gap over the sample (and the fp8 control's, when
    asked), from the weights made again from the seed in fp32."""
    reference.no_tf32()
    w = weights.flat(weights.tree(torch, sz, seed, device,
                                  matmul_dtype=torch.bfloat16))
    w = {k: v.float() for k, v in w.items()}
    out = {"gap": float("inf") if not sample else 0.0}
    if control:
        out["control_gap"] = 0.0
    for prompt, served in sample:
        g = reference.served_gaps(w, sz, prompt, served, device,
                                  fp8_control=control)
        for k, v in g.items():
            out[k] = max(out[k], v)
    return out
