#!/usr/bin/env python3
"""Kernel 5 (the flash attention forward) of two trees, in turns, on one
card, to compare them within one call.

    python3 tools/attention_fwd_ab.py BEFORE_DIR AFTER_DIR [--rounds 1]

Each tree is a checkout holding ``paddle_tpu_torch/``. Runs alternate
(before, after, after, before in each round), each in a fresh process of
its own, which builds that tree's kernels and, at the training slice
(B*H = 96, T = 1024, D = 64, causal), times that tree's
``flash_attention_fwd`` on fp32 and on bf16 inputs: through the wrapper
(``ms``), its C entry alone (``entry_ms``) and on the device
(``device_ms``: the profiler's time of the kernels whose name holds
``flash_fwd``), beside SDPA on the same inputs (``sdpa_ms``), all with
this checkout's ``chip_smoke.Timer`` (medians of 30 launches, L2 evicted
before each). Each run also prints the max abs error of out and lse
against the plain version and a hash of the out and lse bytes, equal
across the trees when their kernels compute bitwise the same. One JSON
line a run, prefixed with its label; exits non-zero when a run fails.
Needs one CUDA card.
"""

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ONE_TREE = r'''
import hashlib, importlib.util, json, sys
sys.path.insert(0, {tree!r})
import torch
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import attention as ka
assert _build.__file__.startswith({tree!r}), _build.__file__
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda:0")
timer = cs.Timer(torch)
lib = _build.library()
B, T, H, D = 8, 1024, 12, 64
doc = {{"tree": {tree!r}, "card": cs.sh(["nvidia-smi",
       "--query-gpu=name,power.limit", "--format=csv,noheader"])}}
for dtype in (torch.float32, torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(B * H, T, D, generator=g, device=dev).to(dtype)
               for _ in range(3))
    kw = dict(sm_scale=D ** -0.5, causal=True)
    out, lse = ka.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = ka.flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    digest = hashlib.sha256(
        out.view(-1).view(torch.uint8).cpu().numpy().tobytes()
        + lse.cpu().numpy().tobytes()).hexdigest()[:16]
    spare = [torch.empty_like(out), torch.empty_like(lse)]
    args = [_build.ptr(t) for t in (q, k, v, *spare)] + [
        B * H, T, D, kw["sm_scale"], 1, _build.DTYPE_CODES[dtype],
        _build.stream(dev)]

    def entry():
        return lib.pk_flash_attn_fwd(*args)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(B, H, T, D) for t in (q, k, v))
    doc[str(dtype).replace("torch.", "")] = {{
        "hash": digest,
        "max_abs_err": (out.float() - want_out.float()).abs().max().item(),
        "lse_max_abs_err": (lse - want_lse).abs().max().item(),
        "ms": timer.ms(lambda: ka.flash_attention_fwd(q, k, v, **kw)),
        "entry_ms": timer.ms(entry),
        "device_ms": timer.device_ms(entry, "flash_fwd")[0],
        "sdpa_ms": timer.ms(lambda: sdpa(q4, k4, v4, is_causal=True))}}
print(json.dumps(doc))
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--rounds", type=int, default=1)
    a = ap.parse_args()
    trees = {"before": str(Path(a.before).resolve()),
             "after": str(Path(a.after).resolve())}
    order = []
    for r in range(a.rounds):
        order += [("before", 2 * r), ("after", 2 * r), ("after", 2 * r + 1),
                  ("before", 2 * r + 1)]
    failed = False
    for label, i in order:
        code = ONE_TREE.format(tree=trees[label],
                               smoke=str(ROOT / "chip_smoke.py"))
        done = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True)
        if done.returncode != 0:
            failed = True
            print(f"{label}{i}: FAILED\n{done.stderr[-2000:]}", flush=True)
            continue
        print(f"{label}{i}: {done.stdout.strip().splitlines()[-1]}",
              flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
