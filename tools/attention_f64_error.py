#!/usr/bin/env python3
"""How far the fp32 attention kernels and their plain versions land from
a float64 evaluation of the same function, on one CUDA card.

    python3 tools/attention_f64_error.py [TREE]

``TREE`` is a checkout holding ``paddle_tpu_torch/`` (default: this
one). Prints one JSON object: for the flash attention forward at
B*H = 96, T = 1024 and B*H = 12, T = 4096 (D = 64, causal, fp32), the
max abs error of out and lse from the kernel and from the plain version
against ``flash_attention_fwd_plain`` in float64 on the same inputs; for
the flash attention backward at
B*H = 96, T = 1024, causal (the training slice), B*H = 24, T = 1000,
non-causal, and B*H = 12, T = 2048, causal (D = 64, fp32), the max abs
error of dq, dk and dv from the kernel and from the plain version
against ``flash_attention_bwd_plain`` in float64 on the same inputs, with
the largest magnitude of each; and for chunk prefill with fp32 queries
at the serving slice (C = 256, 12 kv heads, 512 context positions), the
same two errors of the output. TF32 is off.
"""

import json
import sys
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(TREE))

import torch  # noqa: E402

from paddle_tpu_torch.ops.kernels import attention as ka  # noqa: E402
from paddle_tpu_torch.ops.kernels import prefill as kp  # noqa: E402


def err(a, b):
    return (a.double() - b).abs().max().item()


def forward(dev, B, T, H, causal) -> dict:
    g = torch.Generator(device=dev).manual_seed(T + H)
    q, k, v = (torch.randn(B * H, T, 64, generator=g, device=dev)
               for _ in range(3))
    kw = dict(sm_scale=0.125, causal=causal)
    got = ka.flash_attention_fwd(q, k, v, **kw)
    plain = ka.flash_attention_fwd_plain(q, k, v, **kw)
    exact = ka.flash_attention_fwd_plain(
        *(t.double() for t in (q, k, v)), **kw)
    return {"kernel": [err(a, r) for a, r in zip(got, exact)],
            "plain": [err(a, r) for a, r in zip(plain, exact)],
            "max_exact": [r.abs().max().item() for r in exact]}


def backward(dev, B, T, H, causal) -> dict:
    g = torch.Generator(device=dev).manual_seed(T + H)
    q, k, v, do = (torch.randn(B * H, T, 64, generator=g, device=dev)
                   for _ in range(4))
    kw = dict(sm_scale=0.125, causal=causal)
    out, lse = ka.flash_attention_fwd(q, k, v, **kw)
    got = ka.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    plain = ka.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    exact = ka.flash_attention_bwd_plain(
        *(t.double() for t in (q, k, v, out, lse, do)), **kw)
    return {"kernel": [err(a, r) for a, r in zip(got, exact)],
            "plain": [err(a, r) for a, r in zip(plain, exact)],
            "max_exact": [r.abs().max().item() for r in exact]}


def prefill(dev) -> dict:
    C, Hkv, G, Dh, P, bs, nblocks = 256, 12, 1, 64, 32, 16, 512
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(C, Hkv, G, Dh, generator=g, device=dev)
    kck, vck = (torch.randn(C, Hkv, Dh, generator=g, device=dev)
                for _ in range(2))
    k, v = (torch.randn(Hkv, nblocks * bs, Dh, generator=g, device=dev)
            for _ in range(2))
    pages = torch.randperm(nblocks, device=dev, generator=g)[:P].to(
        torch.int32)
    got = kp.flash_chunk_prefill(q, kck, vck, k, v, pages, block_size=bs)
    plain = kp.flash_chunk_prefill_plain(q, kck, vck, k, v, pages,
                                         block_size=bs)
    S = P * bs
    rows = (pages.long()[:, None] * bs
            + torch.arange(bs, device=dev)).reshape(S)
    kall = torch.cat([k[:, rows], kck.transpose(0, 1)], 1).double()
    vall = torch.cat([v[:, rows], vck.transpose(0, 1)], 1).double()
    s = torch.einsum("ckgd,ktd->ckgt", q.double(), kall) / Dh ** 0.5
    seen = torch.cat([torch.ones(C, S, dtype=torch.bool, device=dev),
                      torch.ones(C, C, dtype=torch.bool,
                                 device=dev).tril()], 1)
    s = torch.where(seen[:, None, None, :], s, -1e30)
    exact = torch.einsum("ckgt,ktd->ckgd", torch.softmax(s, -1), vall)
    return {"kernel": err(got, exact), "plain": err(plain, exact)}


def main():
    if not torch.cuda.is_available():
        sys.exit("attention_f64_error: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    doc = {"tree": str(TREE), "device": torch.cuda.get_device_name(0)}
    for B, T, H in ((8, 1024, 12), (1, 4096, 12)):
        doc[f"fwd T={T} causal=True"] = forward(dev, B, T, H, True)
    for B, T, H, causal in ((8, 1024, 12, True), (2, 1000, 12, False),
                            (1, 2048, 12, True)):
        doc[f"bwd T={T} causal={causal}"] = backward(dev, B, T, H, causal)
    doc["prefill slice"] = prefill(dev)
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
