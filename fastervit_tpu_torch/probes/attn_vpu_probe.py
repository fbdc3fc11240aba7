"""Where does the long-window attention's time go at FasterViT-4-21k's 768²
level-2 call (B 16 windows, S 2304, H 16, hd 49, bf16)?

The port's counterpart of scripts/attn_vpu_probe.py. Each part of the
shipped kernel's work is timed alone, in turns, beside the kernels:

  qk_hd49, qk_hd128   q kᵀ alone (torch.matmul, bf16 in and out), at hd 49
                      and at hd 128;
  av_hd49             p v alone on (B, H, S, S) bf16 scores;
  bias_softmax_f32    softmax(scores + bias) in f32, stored in bf16;
  exp_only_f32        exp of the scores in f32;
  flash_bias_f32      K3 (window_mhsa_long_cuda) with an f32 bias, on q, k
                      and v packed as the qkv projection writes them,
                      (B, S, 3·H·hd);
  flash_bias_bf16     K3 with a bf16 bias, as the served model streams it;
  flash_nobias        P2 (nobias_attention), K3's kernel without the bias,
                      on views of the same packed qkv: the three flash rows
                      read one layout and differ by the bias alone, as the
                      JAX probe's do;
  flash_nobias_bhsd   P2 on separate (B, H, S, hd) q, k and v, the layout
                      of the JAX probe's inputs;
  composed            plain torch ops: bf16 q kᵀ, f32 softmax with the
                      bias, bf16 p v;
  sdpa_bias           scaled_dot_product_attention with the bias as a
                      float mask, the library yardstick;
  sdpa_nobias         the same with no mask.

The SDPA rows take q, k and v zero-padded to a head dim that is a multiple
of 8 (56 at hd 49) on the card (`probes.sdpa_for`). TFLOP/s is counted at
the true hd. The inputs (about 4 GB at the default size) live through the
run; each call's outputs and temporaries (up to 16 GB, the composed row's)
are freed before the next.

    python -m fastervit_tpu_torch.probes.attn_vpu_probe [--out PATH]
    python -m fastervit_tpu_torch.probes.attn_vpu_probe --device cpu \\
        --batch 2 --seq 64 --heads 2
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from fastervit_tpu_torch.ops import attention, attention_probes, \
    cuda_attention
from fastervit_tpu_torch.probes import (device_record, in_turns, parse_args,
                                        report, resolve_device, sdpa_backend,
                                        sdpa_for)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(__doc__, argv)
    device = resolve_device(args.device)
    b, s, h, d = args.batch, args.seq, args.heads, args.head_dim
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.bfloat16)

    q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
    bias = randn(h, s, s)
    scores = randn(b, h, s, s)
    q128, k128 = randn(b, h, s, 128), randn(b, h, s, 128)
    bias32 = bias.float()
    scale = d ** -0.5
    qkv = attention_probes.pack_qkv(q, k, v)
    packed = attention_probes.qkv_views(qkv, h)
    long_attention = (cuda_attention.window_mhsa_long_cuda
                      if device.type == "cuda"
                      else attention.window_mhsa_long_reference)
    sdpa = {"sdpa_bias": sdpa_for(q, k, v, bias[None], scale),
            "sdpa_nobias": sdpa_for(q, k, v, None, scale)}

    def composed():
        p = torch.matmul(q, k.transpose(-1, -2)).float().mul_(scale)
        p = torch.softmax(p.add_(bias32), dim=-1)
        return torch.matmul(p.to(v.dtype), v)

    mm = 2.0 * b * h * s * s
    rows = {  # name: (function, operations)
        "qk_hd49": (lambda: torch.matmul(q, k.transpose(-1, -2)), mm * d),
        "qk_hd128": (lambda: torch.matmul(q128, k128.transpose(-1, -2)),
                     mm * 128),
        "av_hd49": (lambda: torch.matmul(scores, v), mm * d),
        "bias_softmax_f32": (lambda: torch.softmax(
            scores.float() + bias32, dim=-1).to(torch.bfloat16), None),
        "exp_only_f32": (lambda: torch.exp(scores.float()), None),
        "flash_bias_f32": (lambda: long_attention(qkv, bias32, h, scale),
                           2 * mm * d),
        "flash_bias_bf16": (lambda: long_attention(qkv, bias, h, scale),
                            2 * mm * d),
        "flash_nobias": (lambda: attention_probes.nobias_attention(
            *packed, scale), 2 * mm * d),
        "flash_nobias_bhsd": (lambda: attention_probes.nobias_attention(
            q, k, v, scale), 2 * mm * d),
        "composed": (composed, 2 * mm * d),
        **{name: (run, 2 * mm * d) for name, (run, _) in sdpa.items()},
    }
    result = {"probe": "attn_vpu_probe",
              "geometry": {"b": b, "s": s, "heads": h, "head_dim": d,
                           "dtype": "bfloat16"},
              "device": device_record(device)}
    with torch.no_grad():
        fns = {name: fn for name, (fn, _) in rows.items()}
        if device.type == "cuda":
            times = in_turns(fns)
        else:
            times = {name: None for name in fns}
            for fn in fns.values():
                fn()
        for name, (fn, flops) in rows.items():
            ms = times[name]
            row = {"ms": ms}
            if flops:
                row["tf_s"] = None if ms is None else flops / ms / 1e9
            result[name] = row
        for name, (run, head_dim) in sdpa.items():
            result[name]["head_dim_padded_to"] = head_dim
            result[name]["ran"] = sdpa_backend(run)
    return report(result, args.out)


if __name__ == "__main__":
    main()
