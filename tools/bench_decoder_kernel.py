#!/usr/bin/env python3
"""Time the Tacotron-2 decoder kernels (K1 whole loop, K2 segments) on one
CUDA GPU.

    python3 tools/bench_decoder_kernel.py [--rows 1,4,8,16] [--steps 500]
        [--t-in 120] [--check 64] [--root DIR]
        [--out build/bench_decoder_kernel.json]

At the shipped decoder width (E = 768, H = Hd = 1024, P = 256, A = 128,
r = 2), from seeded random weights, encoder outputs and prenet masks:
microseconds per decoder step of the whole-loop kernel for float32 and
(where the package offers them) bfloat16 weights at each batch size, no
early exit, each launch timed with CUDA events after one warm launch,
twice; the same steps as a chain of 16-step segment launches; and the
step's time by phase from the kernel's clock stamps (medians over the
steps).  ``--check N`` also holds the first N steps of each launch
against the plain PyTorch loop of the same type.

``--root DIR`` imports ``msa_tts_tpu_torch`` from another checkout (for
example the parent commit unpacked under ``build/``), so that two
versions of the kernel are timed in one run on one card; only what both
versions offer is measured there.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

SHIPPED = dict(
    n_mel_channels=80, n_frames_per_step=2, encoder_embedding_dim=768,
    attention_rnn_dim=1024, decoder_rnn_dim=1024, prenet_dim=256,
    max_decoder_steps=500, gate_threshold=0.5, p_attention_dropout=0.1,
    p_decoder_dropout=0.1, early_stopping=False,
    attention_params={
        "attention_type": "ForwardAttention", "attention_dim": 128,
        "attention_location_n_filters": 32,
        "attention_location_kernel_size": 31, "windowing": False,
        "norm": "softmax", "forward_attn": True, "trans_agent": True,
        "forward_attn_mask": False, "mask_energies": True,
    },
)
# the stamp intervals of a package that does not name its own
OLD_PHASES = ("prenet 1", "prenet 2", "attention LSTM", "query", "energies",
              "attention rows", "decoder LSTM", "proj+gate", "bookkeeping")
SEG = 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="1,4,8,16")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--t-in", type=int, default=120)
    ap.add_argument("--root", default=None)
    ap.add_argument("--check", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("bench_decoder_kernel: needs a CUDA device", file=sys.stderr)
        return 1
    from msa_tts_tpu_torch.kernels import build
    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.models import decoder as D

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{gpu}; package from {root}")
    device = torch.device("cuda", 0)
    S, T_in = args.steps, args.t_in
    cfg = D.DecoderConfig(**dict(SHIPPED, max_decoder_steps=S))
    has_bf16 = "dtype" in inspect.signature(
        CD.split_decoder_params).parameters
    phases = getattr(CD, "PHASES", OLD_PHASES)
    res = {"gpu": gpu, "root": root, "steps": S, "t_in": T_in,
           "us_per_step": {}, "segment_us_per_step": {}, "phase_us": {}}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        out, us = None, []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            us.append(1e3 * start.elapsed_time(end) / S)
        return out, us

    g = torch.Generator().manual_seed(0)
    dec32 = D.Decoder(cfg, generator=g).to(device).eval()
    b_max = max(int(b) for b in args.rows.split(","))
    enc_all = torch.randn(b_max, T_in, cfg.encoder_embedding_dim,
                          generator=g).to(device)
    lens_all = torch.randint(T_in // 2, T_in + 1, (b_max,), generator=g)
    lens_all[0] = T_in
    lens_all = lens_all.to(device)
    masks_all = CD.prenet_masks(cfg, S, b_max, g, device=device)
    types = [("f32", torch.float32)]
    if has_bf16:
        types.append(("bf16", torch.bfloat16))
    for tag, dtype in types:
        dec = dec32 if dtype == torch.float32 else D.Decoder(
            cfg, generator=torch.Generator().manual_seed(0)
        ).to(device, dtype).eval()
        for B in (int(b) for b in args.rows.split(",")):
            enc = enc_all[:B].to(dtype).contiguous()
            lens = lens_all[:B].contiguous()
            masks = masks_all[:, :, :B].contiguous()
            key = f"{tag} B={B}"
            out, us = timed(
                lambda: CD.cuda_decoder_infer(dec, cfg, enc, lens, masks))
            res["us_per_step"][key] = us
            line = f"{key}: " + ", ".join(f"{u:.2f}" for u in us) + " us/step"

            pin, maskf = CD.segment_inputs(dec, cfg, enc, lens)

            def chain():
                st = D.decoder_stream_init(cfg, B, T_in, device=device)
                for step in range(0, S, SEG):
                    n = min(SEG, S - step)
                    st, *_ = CD.cuda_decoder_segment(
                        dec, cfg, enc, pin, maskf,
                        masks[step: step + n].contiguous(), st, n)
                return st

            _, seg_us = timed(chain)
            res["segment_us_per_step"][key] = seg_us
            line += ("; segments of " + str(SEG) + ": "
                     + ", ".join(f"{u:.2f}" for u in seg_us))

            ns = torch.zeros(S, CD.N_STAMPS, dtype=torch.int64, device=device)
            CD.cuda_decoder_infer(dec, cfg, enc, lens, masks, phase_ns=ns)
            torch.cuda.synchronize()
            d = (ns[:, 1:] - ns[:, :-1]).double()
            med = (d.median(dim=0).values / 1e3).tolist()
            step_us = float((ns[1:, 0] - ns[:-1, 0]).double().median() / 1e3)
            res["phase_us"][key] = dict(zip(phases, med), step=step_us)
            line += "; by phase: " + ", ".join(
                f"{n} {v:.1f}" for n, v in zip(phases, med)
            ) + f", step {step_us:.1f}"
            if hasattr(CD, "profile_decoder_infer"):
                # the same from the grid's last block, a prenet block
                ns = CD.profile_decoder_infer(dec, cfg, enc, lens, masks,
                                              stamp_block=-1)
                torch.cuda.synchronize()
                d = (ns[:, 1:6] - ns[:, :5]).double()
                last = (d.median(dim=0).values / 1e3).tolist()
                res["phase_us"][key]["last block"] = dict(
                    zip(phases[:5], last))
                line += "; last block: " + ", ".join(
                    f"{n} {v:.1f}" for n, v in zip(phases[:5], last))
            if args.check:
                n = min(args.check, S)
                ccfg = cfg._replace(max_decoder_steps=n)
                plain = D.decoder_infer(dec, ccfg, enc, lens, masks[:n])
                r = cfg.n_frames_per_step
                errs = [float((out[0][..., : n * r] - plain[0]).abs().max()),
                        float((out[1][:, : n * r] - plain[1]).abs().max()),
                        float((out[2][:, :n] - plain[2]).abs().max())]
                line += (f"; vs plain over {n} steps: max|d| mels "
                         f"{errs[0]:.2e}, gates {errs[1]:.2e}, aligns "
                         f"{errs[2]:.2e}")
                res.setdefault("max_abs_err", {})[key] = errs
            print(line, flush=True)
        del dec
    for name, (sec, log) in build.build_log.items():
        print(f"nvcc {name}: {sec:.1f} s")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print("   ", ln.strip())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
