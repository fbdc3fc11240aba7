"""Does a chunked online softmax change the long-window attention's time?

The port's counterpart of scripts/attn_online_probe.py. At FasterViT-4-21k's
768² level-2 call (B 16, S 2304, H 16, hd 49, bf16 q, k, v and bias) it
times the shipped long-window kernel (K3, `window_mhsa_long_cuda`, on the
same q, k and v packed as qkv) against P1 (`online_attention`, the key row
in C chunks with a running (max, sum, context) rescaled once a chunk) at
C = 2 and 4, in turns, and holds P1 to K3 on the first two windows
(`maxdiff_vs_shipped`, the largest |P1 − K3| there).

    python -m fastervit_tpu_torch.probes.attn_online_probe [--out PATH]
    python -m fastervit_tpu_torch.probes.attn_online_probe --device cpu \\
        --batch 2 --seq 64 --heads 2
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from fastervit_tpu_torch.ops import attention, attention_probes, \
    cuda_attention
from fastervit_tpu_torch.probes import (device_record, in_turns, parse_args,
                                        report, resolve_device)

CHUNKS = (2, 4)  # the JAX probe's


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(__doc__, argv)
    device = resolve_device(args.device)
    b, s, h, d = args.batch, args.seq, args.heads, args.head_dim
    for c in CHUNKS:
        attention_probes.check_chunks(s, c)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    bias = torch.randn(h, s, s, generator=gen, device=device,
                       dtype=torch.bfloat16)
    scale = d ** -0.5
    qkv = attention_probes.pack_qkv(q, k, v)
    long_attention = (cuda_attention.window_mhsa_long_cuda
                      if device.type == "cuda"
                      else attention.window_mhsa_long_reference)
    flops = 4.0 * b * h * s * s * d
    result = {"probe": "attn_online_probe",
              "geometry": {"b": b, "s": s, "heads": h, "head_dim": d,
                           "dtype": "bfloat16", "bias": "bfloat16"},
              "device": device_record(device), "gflop": flops / 1e9}

    def shipped(n=b):
        out = long_attention(qkv[:n], bias, h, scale)
        return out.reshape(n, s, h, d).transpose(1, 2)

    def online(c, n=b):
        return attention_probes.online_attention(q[:n], k[:n], v[:n], bias,
                                                 scale, c)

    with torch.no_grad():
        rows = {"shipped": shipped}
        rows.update({f"online_c{c}": (lambda c=c: online(c))
                     for c in CHUNKS})
        if device.type == "cuda":
            times = in_turns(rows)
        else:
            times = {name: None for name in rows}
            for fn in rows.values():
                fn()
        n = min(2, b)
        ref = shipped(n).float()
        for name, ms in times.items():
            row = {"ms": ms,
                   "tf_s": None if ms is None else flops / ms / 1e9}
            if name != "shipped":
                got = online(int(name[len("online_c"):]), n).float()
                row["maxdiff_vs_shipped"] = ((got - ref).abs().max().item()
                                             if ref.numel() else 0.0)
            result[name] = row
    return report(result, args.out)


if __name__ == "__main__":
    main()
