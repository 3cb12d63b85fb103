"""The training driver: consecutive steps of the port's LM training
(``transformer.lm_loss``, ``backward``, ``optimizer.Adam.tree_update``)
on fresh batches of uniform ids staged on the card ahead of the window.

Set-up makes the fp32 master weights from the seed on the card and
drives the one training step it builds through its first three steps,
on batches 0-2, through the window's own call; the window takes the same
objects on from step 3. What those first steps leave (each loss, the
first gradient as Adam's first moment holds it, the change of every
leaf after the third) is read as they happen, and judged once the
window has closed and the program's state is freed, against the plain
reference's three fp32 steps from the same weights and batches.
"""

import gc
import time
from statistics import median

from perfbench import harness, reference, traffic, weights

KERNELS = {"flash_fwd": "flash_fwd_tc_kernel", "flash_bwd": "flash_bwd_"}
CHECKED_STEPS = 3


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; leaves whose reference gradient is under
    a thousandth of the median leaf's are left out (``ref`` has the
    gradient norms under ``"_grad"``)."""
    grads = ref["_grad"]
    floor = 1e-3 * median(grads.values())
    keep = [k for k in prog if grads[k] >= floor]
    mid = median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], mid) for k in keep)


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers the limits hold: the worst step's loss gap
    (relative), the first gradient's worst leaf, the change's worst
    leaf."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                      ref["losses"]))
    grads = dict(ref["grad_norms"], _grad=ref["grad_norms"])
    change = dict(ref["change_norms"], _grad=ref["grad_norms"])
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(prog["grad_norms"], grads),
            "change_gap": leaf_gap(prog["change_norms"], change)}


class Step:
    """The one training step of the run, over the params and Adam state
    it holds; CUDA events around the loss and backward and around the
    optimizer, per step."""

    def __init__(self, torch, tt, topt, cfg, params, lr: float, device):
        self.torch, self.tt, self.topt, self.cfg = torch, tt, topt, cfg
        self.params = params
        self.adam = topt.Adam(learning_rate=lr)
        self.state = self.adam.tree_init_state(params)
        self.cuda = device.type == "cuda"
        self.events = []
        self.i = 0

    def __call__(self, batch):
        torch = self.torch
        T = batch.shape[1] - 1
        tokens = batch[:, :T].contiguous()
        targets = batch[:, 1:].contiguous()
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if self.cuda else None)
        span = torch.profiler.record_function
        with span("perfbench.fwd_bwd"):
            if ev:
                ev[0].record()
            loss = self.tt.lm_loss(self.params, tokens, targets, self.cfg)
            loss.backward()
        with span("perfbench.optimizer"):
            if ev:
                ev[1].record()
            _, self.state = self.adam.tree_update(
                self.i, self.topt.take_grads(self.params), self.params,
                self.state)
            if ev:
                ev[2].record()
        if ev:
            self.events.append(ev)
        self.i += 1
        return loss.detach()


def run(torch, cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, fault=None) -> dict:
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import transformer as tt
    job = cell["model"]["training"]
    B, T, lr = job["batch"], job["seq"], job["learning_rate"]
    sz = weights.sizes(cell["model"])
    cfg = tt.TransformerConfig(vocab=sz.vocab, d_model=sz.d_model,
                               n_heads=sz.n_heads, n_layers=sz.n_layers,
                               d_ff=sz.d_ff, max_len=sz.max_len,
                               dtype=torch.bfloat16, dropout=sz.dropout)
    params = weights.tree(torch, sz, seed, device)
    for v in weights.flat(params).values():
        v.requires_grad_(True)
    batches = traffic.train_batches(torch, seed, cell["traffic"]["batches"],
                                    B, T, sz.vocab, device)
    step = Step(torch, tt, topt, cfg, params, lr, device)
    if fault is not None:
        fault(step)
    cuda = device.type == "cuda"

    # -- set-up: the first three steps, read as they happen ---------------
    names = list(weights.flat(params))
    prog = {"losses": []}
    for i in range(CHECKED_STEPS):
        prog["losses"].append(float(step(batches[i])))
        if i == 0:
            # Adam's first moment after one step is (1 - beta1) g
            prog["grad_norms"] = {
                k: float(step.state[_key(step.state, k)][0].norm()
                         / (1 - step.adam.b1)) for k in names}
    flat = weights.flat(params)
    prog["change_norms"] = {}
    with torch.no_grad():
        for k in names:
            p0 = weights.leaf(torch, sz, k, seed, device)
            prog["change_norms"][k] = float((flat[k] - p0).norm())
            del p0
    step.events.clear()
    if cuda:
        torch.cuda.synchronize()

    # -- the window -------------------------------------------------------
    n = batches.shape[0]
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    steps = 0
    while time.perf_counter() - t_open < seconds:
        step(batches[(CHECKED_STEPS + steps) % n])
        steps += 1
    if cuda:
        torch.cuda.synchronize()      # the window ends with its last step
    window_s = time.perf_counter() - t_open
    times = [(a.elapsed_time(b), b.elapsed_time(c))
             for a, b, c in step.events] if cuda else []
    step.events.clear()
    traced = None
    if trace:
        traced = profile_steps(torch, step, batches, CHECKED_STEPS + steps,
                               cell["traffic"]["profile_steps"])
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e = {"train_tokens_per_s": B * T * steps / window_s,
           "setup_s": setup_s}
    ctx = {"model": sz, "batch": B, "seq": T, "steps": steps,
           "window_s": window_s, "step_ms": times, "trace": traced}

    # -- the reference, once the program's state is freed -----------------
    del step, params, flat, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref, ctl = judge(torch, cell, sz, seed, B, T, lr, device, control)
    got = compare(prog, ref)
    limits = cell["limits"]
    checks = {k: (got[k], limits[k]) for k in ("loss_gap", "grad_gap",
                                               "change_gap")}
    return {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": steps, "failed": 0, "e2e": e2e, "ctx": ctx,
            "trace": traced, "peak_bytes": peak, "checks": checks,
            "control": ctl, "readings": got}


def _key(state: dict, leaf: str) -> str:
    """The optimizer state's key of a leaf (its keystr path)."""
    hits = [k for k in state if k.endswith(f"['{leaf}']")]
    if len(hits) != 1:
        raise KeyError(f"no single optimizer state for {leaf!r}: {hits}")
    return hits[0]


def profile_steps(torch, step: Step, batches, first: int, n: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        step(batches[first % batches.shape[0]])
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(batches[(first + 1 + i) % batches.shape[0]])
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    step.events.clear()
    doc = harness.read_trace(prof, window_s, KERNELS)
    doc["steps"] = n
    return doc


def judge(torch, cell: dict, sz, seed: int, B: int, T: int, lr: float,
          device, control: bool):
    """The reference's three fp32 steps from the weights and batches made
    again from the seed; with ``control``, also the readings against them
    of the fp8 control and of the half-batch fault, each put in the
    program's place."""
    reference.no_tf32()
    batches = traffic.train_batches(torch, seed, cell["traffic"]["batches"],
                                    B, T, sz.vocab, device)[:CHECKED_STEPS]

    def steps(**kw):
        w = weights.flat(weights.tree(torch, sz, seed, device))
        out = reference.train_steps(w, list(batches), sz, lr, **kw)
        del w
        gc.collect()
        return out

    ref = steps()
    if not control:
        return ref, None
    return ref, {"fp8": compare(steps(fp8=True), ref),
                 "half_batch": compare(steps(half_batch=True), ref)}
