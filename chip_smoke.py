#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA
GPU.

    python3 chip_smoke.py [--only 12,13,14,15,16,17,18]

(``--only``: phase 1, then only the phases named.)

Phases (any failure exits non-zero):
  1. require CUDA, build the hand-written kernels from the sources in
     the checkout, count the tensor-core opcodes (HMMA) of the three
     kernels' bf16 paths (none is an error), print the card's name and
     power limit;
  2. hold the whole-loop decoder kernel against its plain PyTorch
     version on the card at the full width of examples/maml/params.yml,
     with float32 and with bfloat16 weights;
  3. serve a few requests through ``AdaptiveTTS`` with seeded random
     weights and the kernel as the decode backend (float32, and one
     request with ``infer_dtype: bfloat16``), and check the waveforms
     and the kernel's launch count;
  4. hold the segment kernel, chained over all steps, against the
     whole-loop kernel (bit for bit) and the plain segment chain, its
     state after one segment, and a B = 4 row against B = 1, in both
     types;
  5. stream the requests through ``synthesize_stream``: mel and length
     against the offline path, one launch per segment (four float32
     streams, one bfloat16);
  6. multiplex four staggered streams through ``StreamMultiplexer``:
     each equals its solo stream and agrees with the same stream decoded
     by the plain segment, one launch per tick (float32 with Griffin-Lim
     too; bfloat16 the mel run);
  7. serve /synthesize and /synthesize_stream from ``TTSServer``, in
     float32 and in bfloat16;
  8. hold the WaveRNN sample-loop kernel against its plain PyTorch
     version at the default width (B = 44 folds, T = 3,850 samples), f32
     and bf16 weights, mixture-of-logistics and Gaussian outputs; time it
     at the served fold rows, print a step's time by phase from the
     kernel's clock stamps, and what one grid barrier costs;
  9. serve requests, a batch and a stream through ``AdaptiveTTS`` with a
     WaveRNN and a HiFi-GAN (v1) attached: lengths, ranges, one
     sample-loop launch per vocoded call, a batch row against its solo
     vocoding;
 10. hold the LSTM-cell kernel against its plain version (B = 16,
     H = 1024, f32 and bf16 weights), repeat a launch bit for bit, run
     its 400-step scan in both types against the plain scans, and time
     it on the device apart from the host (tools/bench_lstm_cell.py:
     cold after an L2 flush, in a scan replayed from a CUDA graph) in
     turns with the library pair, and the scan's wall and host time;
 11. adapt the float32 model at that width from four synthetic clips
     (``AdaptiveTTS.adapt``: the shipped loss, 5 SGD steps and the query
     pass), print its warm wall time and peak device memory, hold the
     adapted weights and query loss against the same adapt on the CPU,
     check the query loss is below the first inner step's, round-trip
     the voice file, and serve the adapted voice through the whole-loop
     kernel (float32 and bfloat16) and the segment kernel against the
     plain decode;
 12. meta-train at that width through ``python -m
     msa_tts_tpu_torch.trainers.maml`` (``main``: examples/maml/params.yml
     with only the data and run-length entries changed, MAML_REDUCED;
     second order, bfloat16 compute, 4 tasks x 8 shots) for 3 epochs on a
     synthetic corpus: meta-step times, mel frames per second, peak device
     memory, the meta-test's losses and MCD; the run's files after 2
     epochs resumed to 3 against it; one float32 meta-step, second and first
     order, on the card against the CPU; and the trained checkpoint
     (``from_experiment``) served through the whole-loop kernel (float32
     and bfloat16) and the segment kernel against the plain decode;
 13. train at that width through the entry points of the joint trainer
     (``trainers.baseline.main``, 2 epochs of examples/baseline/params.yml
     with a meta-test), Reptile (2 sequential meta-steps, 1 batched) and
     the continual streams (EWC and ER-KD of 3 speakers; ER, ER-reg and
     cumulative of 2), each examples/<method>/params.yml with only data
     and run length changed (TRAIN_REDUCED): step times, mel frames per
     second, peak device memory, the joint step's device busy share under
     ``torch.profiler``, each task's and the Fisher's time; the joint run
     resumed from epoch 1 and the EWC stream from task 2, each equal bit
     for bit to its unbroken run; one float32 joint and one EWC step on
     the card against the CPU; and the joint checkpoint and the last EWC
     checkpoint served through the whole-loop kernel (float32 and
     bfloat16) and the segment kernel against the plain decode;
 14. build the host feature library (``native/feats.cpp``, g++) and hold
     its features to the numpy path; train WaveRNN at the served width
     (MOL, rnn/fc 512, 10 res blocks, hop 256; batches of 16 windows of
     1,280 samples, 100 steps) and HiFi-GAN v1 (batches of 16 segments of
     8,192 samples, 60 steps) through ``trainers.{wavernn,hifigan}_train.
     main`` on phase 12's corpus: step times, samples per second, peak
     device memory, the logged losses falling; one step of each on the
     card against the CPU from the trained checkpoint, and repeated bit
     for bit; the sample-loop kernel on the trained WaveRNN (44 fold rows
     of a corpus mel, f32 and bf16) against the plain loop; and each
     trained vocoder serving a request;
 15. run the inference CLIs (``infer``, ``infer_cumulative``) at the
     shipped width through their entry points on the checkpoints of
     phases 12-14, through the decoder and sample-loop kernels;
 16. serve a batch over a mesh of two shards of the one card
     (``serving.decode_sharded``, B = 4 and B = 3 with a filler row,
     float32 and bfloat16): two K1 launches a call, each row against the
     single-device K1 decode; ``AdaptiveTTS`` with more ``dp`` than cards
     raises; train over two gloo ranks that share the card
     (``parallel/launch.py``): MAML ``{task: 2}``, joint and WaveRNN
     ``{dp: 2}`` against world 1, the shipped MAML and joint steps timed
     at both, a world-2 MAML checkpoint resumed at world 2 (bit for bit)
     and at world 1; and ``torchrun --nproc_per_node 1`` of the MAML
     entry point on NCCL;
 17. tensor parallelism (``parallel/tp.py``): ``AdaptiveTTS`` with
     ``parallel: {tp: 2}`` over two shards of the one card (B = 1 and
     B = 4, float32, the plain decode with partitioned products): each
     row against the one-device plain decode, no K1 launch, the wall
     time beside the plain decode's and K1's, one bfloat16 request
     against the one-device bfloat16 plain decode, the kernel decode
     under tp refused; the joint trainer and second-order MAML (2
     tasks) at ``{dp: 1, tp: 2}`` over two gloo ranks sharing the card
     against world 1, the joint run resumed at tp 2 (bit for bit) and at
     world 1, each rank's peak memory and the bytes it holds, warm step
     times;
 18. hold WaveGlow's two WN passes (``vocoders/cuda_wn.py``) bit for bit
     against their eager ops at the benchmark cell's N = 512,000
     positions and C = 256, bfloat16 and float32, and time each beside
     them; serve a batch through ``synthesize_batch(vocoder=
     "waveglow")`` at NVIDIA's published width and count its WN launches
     (192); time the cell's call (16 rows of 1,000 frames) with the
     passes and with the eager ops, and hold its waveforms bit for bit.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists each kernel with its launches on its main
path (phase 3 for the whole loop, phase 5 for the segments, phase 9 for
the sample loop, phase 10's scan for the cell; the decoder kernels'
``adapted_voice_launches`` are phase 11's, ``trained_checkpoint_launches``
phase 12's, ``joint_`` and ``ewc_checkpoint_launches`` phase 13's; the
sample loop's ``trained_checkpoint_launches`` phase 14's; the whole
loop's ``dp_serving_launches`` phase 16's; the WN passes' launches phase
18's), its
error against the
plain version, both times, and the least time the card could take for
the same work (``bound_ms``: the larger of bytes over 3.35 TB/s and
operations over the peak rate of their type; weights count once per
launch where they stay on the chip, and once per step only where a step
must read them again: the float32 decoder's LSTM segments that its
shared-memory plan does not keep resident, 62 of its 82 MB, more than
the L2 holds; the 41 MB of bfloat16 weights stay in shared memory and
the L2).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# examples/maml/params.yml — `model` and `audio_params`, carried as a
# dict because the machine with the GPU may have no yaml
# (tests/test_torch_serving.py holds the two equal).
SHIPPED_MODEL = {
    "attention_params": {
        "attention_dim": 128,
        "attention_location_kernel_size": 31,
        "attention_location_n_filters": 32,
        "attention_type": "ForwardAttention",
        "forward_attn": True,
        "forward_attn_mask": False,
        "norm": "softmax",
        "trans_agent": True,
        "windowing": False,
    },
    "attention_rnn_dim": 1024,
    "decoder_no_early_stopping": False,
    "decoder_rnn_dim": 1024,
    "encoder_embedding_dim": 512,
    "encoder_kernel_size": 5,
    "encoder_n_convolutions": 3,
    "gate_threshold": 0.5,
    "mask_padding": True,
    "max_decoder_steps": 500,
    "n_frames_per_step": 2,
    "p_attention_dropout": 0.1,
    "p_decoder_dropout": 0.1,
    "postnet_embedding_dim": 512,
    "postnet_kernel_size": 5,
    "postnet_n_convolutions": 5,
    "prenet_dim": 256,
    "scan_unroll": 16,
    "speaker_emb_type": "static",
    "speaker_embedding_dim": 256,
    "speaker_embedding_dim_lin": 64,
    "symbols_embedding_dim": 512,
    "use_residual_encoder": False,
}
SHIPPED_AUDIO = {
    "f_max": 8000.0,
    "f_min": 0.0,
    "griffinlim_iters": 60,
    "hop_length": 256,
    "n_fft": 1024,
    "n_mels": 80,
    "n_mfcc": 13,
    "sample_rate": 22050,
    "win_length": 1024,
}

# examples/maml/params.yml — what AdaptiveTTS.adapt reads besides the
# model: the loss, the inner optimizer and its steps, the frontend and
# the silence trim (tests/test_torch_serving.py holds them equal)
SHIPPED_ADAPT = {
    "audio_processor": "ap",
    "criterion": {"criterion_type": "Tacotron2Loss", "pos_weight": 6.0,
                  "reduction": "none"},
    "dataset_train": {"trim_margin_silence": True},
    "n_inner_test": 5,
    "optim_inner": {"lr": "1e-2", "optimizer_type": "SGD"},
}

# the card's published peaks (NVIDIA H100 SXM data sheet)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

ATOL = 1e-4          # kernel vs plain, f32, first CHECK_STEPS steps
CHECK_STEPS = 64
# Decoder kernels with bfloat16 weights against the plain bfloat16 loop:
# the two differ by summation order only, but every product rounds its
# input vector to bfloat16, where a last-bit difference of a float32 sum
# can move a value by 2^-8 of its size; the AR feedback carries that on.
# So: a bound over the first CHECK_STEPS steps, and over the whole run
# the share of values further off than a flip threshold.  Fixed before
# the run from an earlier run's readings at these shapes (NVIDIA H100
# 80GB HBM3): first 64 steps mels 2.4e-3 to 5.2e-3, gates 1.4e-3 to
# 3.1e-3, alignments 1e-4 to 1.4e-3; whole run mels <= 1.6e-2,
# alignments <= 5.1e-3; the state after one segment <= 2.1e-3.  Random
# weights give |log-mel| and |gate| of ~0.1-0.5 and alignments of ~1/T_in
# = 8e-3 with peaks near 1; each judgement prints the mean |value|.
DEC_BF16_ATOL = {"mels": 2e-2, "gates": 2e-2, "aligns": 5e-3}
DEC_BF16_FLIP = {"mels": 5e-2, "gates": 5e-2, "aligns": 5e-3}
DEC_BF16_SHARE = 1e-3
# the carried state after one segment: LSTM h/c, context and decoder
# input like the mels, the attention's rows and agent like the alignments
DEC_BF16_STATE_ATOL = {"lstm": 2e-2, "attention": 5e-3}
# a served bfloat16 request's log-mel (postnet included, a bfloat16
# library convolution), kernel decode vs plain decode over all 500
# steps: the flip share as above and a bound on the worst value (an
# earlier run read 1.6e-2)
SERVE_BF16_MAX = 1e-1
T_IN = 120
# served log-mel, kernel vs plain decode over all 500 steps: the f32
# summation orders differ, and the AR feedback carries that through
SERVE_ATOL = 1e-3


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _bound(n_bytes: float, n_ops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_b, t_o = n_bytes / HBM_BPS, n_ops / peak_flops
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _is_bf16(tts) -> bool:
    import torch

    return tts.infer_dtype == torch.bfloat16


def _decoder_bound(tts, B: int, S: int, T_in: int, *io):
    """Decoder kernels: two operations per matrix weight, row and step.
    Bytes: what the launch's shared-memory plan streams (the LSTM
    segments that are not resident) counts once per step in float32,
    where the 82 MB of weights exceed what the chip holds; everything
    else — the resident segments, the other matrices and vectors, and in
    bfloat16 (41 MB, which shared memory and the L2 hold for the whole
    launch) all of the weights — counts once.  ``io`` are the launch's
    other inputs and outputs, counted once."""
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD

    dcfg = tts.cfg.decoder_config()
    w = CD._packed_params(tts.model.decoder, dcfg)
    n_w = sum(w[k].numel() for k in CD._MATRICES)
    once = _nbytes(*w.values()) + _nbytes(*io)
    if _is_bf16(tts):
        return _bound(once, S * 2.0 * n_w * B, BF16_FLOPS)
    n_sm = torch.cuda.get_device_properties(
        w["w_q"].device).multi_processor_count
    plan = CD.smem_plan(dcfg, B, T_in, torch.float32, n_sm)
    return _bound(once + (S - 1.0) * plan["streamed_bytes"],
                  S * 2.0 * n_w * B, F32_FLOPS)


def _judge_dec(kern, plain, cuts, bf16: bool, label: str) -> float:
    """Hold a decoder kernel's (mels, gates, aligns) against the plain
    loop's; ``cuts``: how many trailing-axis entries (aligns: steps) the
    first CHECK_STEPS steps are.  float32: max |d| over the first steps
    within ATOL.  bfloat16: within DEC_BF16_ATOL there, and over the
    whole run at most DEC_BF16_SHARE of the values beyond DEC_BF16_FLIP.
    Returns the first steps' max |d|."""
    worst = 0.0
    for name, a, b, cut in zip(("mels", "gates", "aligns"), kern, plain,
                               cuts):
        win = a[..., :cut] if name != "aligns" else a[:, :cut]
        ref = b[..., :cut] if name != "aligns" else b[:, :cut]
        d = (a - b).abs()
        err, whole = float((win - ref).abs().max()), float(d.max())
        limit = DEC_BF16_ATOL[name] if bf16 else ATOL
        line = (f"  {label} {name} (mean |value| {float(b.abs().mean()):.2e})"
                f": max|d| first {CHECK_STEPS} steps {err:.3e} (limit "
                f"{limit}), whole run {whole:.3e}")
        if bf16:
            share = float((d > DEC_BF16_FLIP[name]).float().mean())
            line += (f", share beyond {DEC_BF16_FLIP[name]}: {share:.2e} "
                     f"(limit {DEC_BF16_SHARE})")
        print(line)
        if not err <= limit:
            raise AssertionError(f"{label}, {name}: {err} > {limit}")
        if bf16 and not share <= DEC_BF16_SHARE:
            raise AssertionError(f"{label}, {name}: share {share} > "
                                 f"{DEC_BF16_SHARE}")
        worst = max(worst, err)
    return worst


def _time_ms(fn, n: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_vs_plain(tts, device, seed: int = 0) -> dict:
    """Phase 2: the decoder kernel against the plain loop at full width,
    on the serving model's decoder (float32 or bfloat16, as ``tts`` was
    built), with the same encoder outputs and prenet masks; the early-
    stopping comparison (identical stop steps) is held in float32."""
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.models.decoder import decoder_infer

    dcfg = tts.cfg.decoder_config()._replace(early_stopping=False)
    decoder = tts.model.decoder
    bf16 = _is_bf16(tts)
    dtype = tts.infer_dtype
    g = torch.Generator().manual_seed(seed)
    S, E = dcfg.max_decoder_steps, dcfg.encoder_embedding_dim
    r = dcfg.n_frames_per_step
    res = {"max_abs_err": 0.0}
    for B in (1, 4):
        enc = torch.randn(B, T_IN, E, generator=g).to(device, dtype)
        lens = torch.tensor([T_IN, 97, 110, 64][:B], device=device)
        masks = CD.prenet_masks(dcfg, S, B, g, device=device)
        plain = decoder_infer(decoder, dcfg, enc, lens, masks)
        kern = CD.cuda_decoder_infer(decoder, dcfg, enc, lens, masks)
        torch.cuda.synchronize()
        n = CHECK_STEPS
        err = _judge_dec(kern[:3], plain[:3], (n * r, n * r, n), bf16,
                         f"B={B}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if int(kern[4]) != S or int(plain[4]) != S:
            raise AssertionError("no-early-stop runs must take all S steps")
        k_ms = _time_ms(
            lambda: CD.cuda_decoder_infer(decoder, dcfg, enc, lens, masks), 5
        )
        p_ms = _time_ms(
            lambda: decoder_infer(decoder, dcfg, enc, lens, masks), 1
        )
        res["ms"], res["plain_ms"] = k_ms, p_ms
        res["bound_ms"], res["bound_by"] = _decoder_bound(
            tts, B, S, T_IN, enc, masks, *kern[:3])
        res[f"us_per_step_b{B}"] = 1e3 * k_ms / S
        print(f"  B={B}: kernel {1e3 * k_ms / S:.1f} us/step, plain "
              f"{1e3 * p_ms / S:.1f} us/step, bound "
              f"{1e3 * res['bound_ms'] / S:.2f} us/step by "
              f"{res['bound_by']} ({S} steps, T_in {T_IN})")
        ns = torch.zeros(S, CD.N_STAMPS, dtype=torch.int64, device=device)
        CD.cuda_decoder_infer(decoder, dcfg, enc, lens, masks, phase_ns=ns)
        torch.cuda.synchronize()
        med = ((ns[:, 1:] - ns[:, :-1]).double().median(dim=0).values
               / 1e3).tolist()
        in_barriers = sum(v for name, v in zip(CD.PHASES, med)
                          if name.startswith("barrier"))
        res[f"barrier_us_per_step_b{B}"] = in_barriers
        print("    us by phase (block 0): " + ", ".join(
            f"{name} {v:.1f}" for name, v in zip(CD.PHASES, med))
            + f"; in the step's grid barriers {in_barriers:.1f}")
    if bf16:
        return res

    # early stopping at B = 4 on the same inputs: shift the gate bias (the
    # gate does not feed back, so the trajectory is unchanged) so that
    # every row has stopped by the step where the row with the lowest
    # peak gate peaks; then stop steps and mel_lengths must be equal
    gates = plain[1][:, ::r][:, :200]
    shift = 0.05 - float(gates.max(dim=1).values.min())
    cfg = dcfg._replace(early_stopping=True)
    bias = decoder.gate_layer.linear_layer.bias
    with torch.no_grad():
        bias += shift
    try:
        plain = decoder_infer(decoder, cfg, enc, lens, masks)
        kern = CD.cuda_decoder_infer(decoder, cfg, enc, lens, masks)
    finally:
        with torch.no_grad():
            bias -= shift
    n_run = int(plain[4])
    prob = torch.sigmoid(plain[1][:, ::r][:, :n_run])
    closest = float((prob - cfg.gate_threshold).abs().min())
    ml_k, ml_p = kern[3].tolist(), plain[3].tolist()
    print(f"  early stop B=4: closest gate to threshold {closest:.3e}; "
          f"mel_lengths kernel {ml_k} plain {ml_p}, n_steps kernel "
          f"{int(kern[4])} plain {n_run}")
    if closest <= 1e-4:
        raise AssertionError(
            "a gate lies within 1e-4 of the threshold: pick another seed"
        )
    if ml_k != ml_p or int(kern[4]) != n_run or n_run >= S:
        raise AssertionError("early-stopping run: stop steps differ")
    return res


SEG = 16             # streaming segment length (decoder steps)
SEG_ROW_ATOL = 1e-5  # a B = 4 row against its B = 1 decode
STREAM_ATOL = 1e-4   # streamed mel against the offline mel
MUX_ATOL = 1e-5      # a muxed stream's mel against its solo stream


def _chain(seg_fn, S: int, n_seg: int):
    """Run segments of n_seg steps (the last one shorter) until S steps;
    returns the step-concatenated mels, gates, aligns and the final
    state.  ``seg_fn(state, step, n) -> (state, mels, gates, aligns)``."""
    import torch

    st, parts, step = None, [], 0
    while step < S:
        n = min(n_seg, S - step)
        st, *o = seg_fn(st, step, n)
        parts.append(o)
        step += n
    mels, gates, aligns = (torch.cat(x, dim=1 if i == 2 else -1)
                           for i, x in enumerate(zip(*parts)))
    return mels, gates, aligns, st


def segment_vs_plain(tts, device, gate_bias0, seed: int = 1) -> dict:
    """Phase 4: the segment kernel chained over all S steps against the
    whole-loop kernel (bit for bit) and the plain segment chain, at full
    width with the model's own gate bias, in the type ``tts`` was built
    with; its state after one segment; and each row of a B = 4 chain
    against that row decoded alone."""
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.models.decoder import (
        decoder_infer_segment,
        decoder_stream_init,
    )

    dcfg = tts.cfg.decoder_config()._replace(early_stopping=False)
    decoder = tts.model.decoder
    bf16 = _is_bf16(tts)
    bias = decoder.gate_layer.linear_layer.bias
    served_bias = bias.detach().clone()
    S, E, r = dcfg.max_decoder_steps, dcfg.encoder_embedding_dim, \
        dcfg.n_frames_per_step
    g = torch.Generator().manual_seed(seed)
    res = {"max_abs_err": 0.0}

    def kernel_chain(enc, pin, maskf, masks):
        B, T = enc.shape[:2]

        def seg(st, step, n):
            st = st or decoder_stream_init(dcfg, B, T, device=device)
            return CD.cuda_decoder_segment(
                decoder, dcfg, enc, pin, maskf,
                masks[step: step + n].contiguous(), st, n)
        return _chain(seg, S, SEG)

    def plain_chain(enc, lens, masks):
        B, T = enc.shape[:2]

        def seg(st, step, n):
            st = st or decoder_stream_init(dcfg, B, T, device=device)
            return decoder_infer_segment(decoder, dcfg, enc, lens,
                                         masks[step: step + n], st, n)
        return _chain(seg, S, SEG)

    with torch.no_grad():
        bias.copy_(gate_bias0)
    try:
        for B in (1, 4):
            enc = torch.randn(B, T_IN, E, generator=g).to(device,
                                                          tts.infer_dtype)
            lens = torch.tensor([T_IN, 97, 110, 64][:B], device=device)
            masks = CD.prenet_masks(dcfg, S, B, g, device=device)
            pin, maskf = CD.segment_inputs(decoder, dcfg, enc, lens)
            whole = CD.cuda_decoder_infer(decoder, dcfg, enc, lens, masks)
            kern = kernel_chain(enc, pin, maskf, masks)
            plain = plain_chain(enc, lens, masks)
            torch.cuda.synchronize()
            same = (torch.equal(kern[0], whole[0])
                    and torch.equal(kern[1].repeat_interleave(r, 1),
                                    whole[1])
                    and torch.equal(kern[2], whole[2])
                    and torch.equal(kern[3]["mel_lengths"], whole[3]))
            print(f"  B={B}: segment chain (n_seg {SEG}) == whole-loop "
                  f"kernel bit for bit: {same}")
            if not same:
                raise AssertionError(f"B={B}: segment chain != whole loop")
            err = _judge_dec(
                kern[:3], plain[:3],
                (CHECK_STEPS * r, CHECK_STEPS, CHECK_STEPS), bf16,
                f"B={B} segment kernel vs plain segment")
            res["max_abs_err"] = max(res["max_abs_err"], err)

            # the state after one segment, the transition agent included
            st0 = decoder_stream_init(dcfg, B, T_IN, device=device)
            ks = CD.cuda_decoder_segment(decoder, dcfg, enc, pin, maskf,
                                         masks[:SEG].contiguous(), st0, SEG)
            ps = decoder_infer_segment(decoder, dcfg, enc, lens,
                                       masks[:SEG], st0, SEG)
            kc, pc = ks[0]["carry"], ps[0]["carry"]
            errs = {
                "decoder_input": ks[0]["decoder_input"]
                - ps[0]["decoder_input"],
                **{f: getattr(kc, f) - getattr(pc, f) for f in kc._fields
                   if f != "attn_state"},
                **{f: getattr(kc.attn_state, f) - getattr(pc.attn_state, f)
                   for f in ("attention_weights", "attention_weights_cum",
                             "alpha", "u")},
            }
            att_f = ("attention_weights", "attention_weights_cum", "alpha",
                     "u")
            worst = {"attention": 0.0, "lstm": 0.0}
            for f, v in errs.items():
                kind = "attention" if f in att_f else "lstm"
                worst[kind] = max(worst[kind], float(v.abs().max()))
            lim = (DEC_BF16_STATE_ATOL if bf16
                   else {"lstm": ATOL, "attention": ATOL})
            print(f"  B={B}: state after one segment, max|d| over LSTM h/c, "
                  f"context and decoder input {worst['lstm']:.3e} (limit "
                  f"{lim['lstm']}), over the attention's rows and agent "
                  f"{worst['attention']:.3e} (limit {lim['attention']}); u "
                  f"max|d| {float(errs['u'].abs().max()):.3e}")
            if any(not worst[k] <= lim[k] for k in lim) or not (
                    torch.equal(ks[0]["not_finished"],
                                ps[0]["not_finished"])
                    and torch.equal(ks[0]["mel_lengths"],
                                    ps[0]["mel_lengths"])):
                raise AssertionError("state after one segment differs")

            launches = CD.SEG_LAUNCHES
            k_ms = _time_ms(lambda: kernel_chain(enc, pin, maskf, masks), 3)
            n_launch = (CD.SEG_LAUNCHES - launches) // 3
            w_ms = _time_ms(lambda: CD.cuda_decoder_infer(
                decoder, dcfg, enc, lens, masks), 3)
            p_ms = _time_ms(lambda: plain_chain(enc, lens, masks), 1)
            res["ms"], res["plain_ms"] = k_ms, p_ms
            res["bound_ms"], res["bound_by"] = _decoder_bound(
                tts, B, S, T_IN, enc, masks, *kern[:3])
            res[f"us_per_step_b{B}"] = 1e3 * k_ms / S
            print(f"  B={B}: segment kernel {1e3 * k_ms / S:.1f} us/step "
                  f"({n_launch} launches of <= {SEG} steps), whole-loop "
                  f"kernel {1e3 * w_ms / S:.1f}, plain segment "
                  f"{1e3 * p_ms / S:.1f} us/step ({S} steps, T_in {T_IN})")

        # rows against B = 1: once on these inputs, once with the gate
        # bias shifted (as in phase 2) so that the rows stop at steps of
        # their own; the stop steps are the chains' mel_lengths
        gates = plain[1][:, :200]
        shift = 0.05 - float(gates.max(dim=1).values.min())
        for label, delta in (("gate as is", 0.0),
                             (f"gate shifted {shift:+.3f}", shift)):
            with torch.no_grad():
                bias.copy_(gate_bias0 + delta)
            four = kernel_chain(enc, pin, maskf, masks)
            worst, ml_one = 0.0, []
            for b in range(4):
                one = kernel_chain(
                    enc[b:b + 1].contiguous(), pin[b:b + 1].contiguous(),
                    maskf[b:b + 1].contiguous(),
                    masks[:, :, b:b + 1].contiguous())
                for a, o in zip(four[:3], one[:3]):
                    worst = max(worst, float((a[b:b + 1] - o).abs().max()))
                ml_one.append(int(one[3]["mel_lengths"][0]))
            ml_four = four[3]["mel_lengths"].tolist()
            # the stop decisions: each row's steps up to its firing one
            prob = torch.sigmoid(four[1])
            closest = min(
                float((prob[b, : ml + 1] - dcfg.gate_threshold).abs().min())
                for b, ml in enumerate(four[3]["mel_lengths"].tolist()))
            print(f"  B=4 rows vs B=1 ({label}): max|d| {worst:.3e}; stop "
                  f"steps B=4 {ml_four}, B=1 {ml_one}; closest gate to the "
                  f"threshold {closest:.3e}")
            if not worst <= SEG_ROW_ATOL or ml_four != ml_one:
                raise AssertionError("a B = 4 row differs from its B = 1 "
                                     "decode")
            if delta and min(ml_four) >= S:
                raise AssertionError("shifted gate: no row stopped")
    finally:
        with torch.no_grad():
            bias.copy_(served_bias)
    return res


STREAM_BF16_ATOL = 5e-2   # bfloat16: the postnet's library convolutions
                          # round to bfloat16 and sum in another order at a
                          # window's shape than at the whole mel's


def stream_requests(tts, device, n_texts: int = 4) -> int:
    """Phase 5: stream the first ``n_texts`` texts one after another
    through ``synthesize_stream`` with the CUDA decode backend: the
    streamed mel against the offline mel, the streamed Griffin-Lim length
    against the offline wav's, one segment-kernel launch per segment.
    Returns the launches of the Griffin-Lim streams (the main path)."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD

    emb = np.random.default_rng(0).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32)
    sr = tts.params["audio_params"]["sample_rate"]
    S = tts.cfg.max_decoder_steps
    n_seg = -(-S // SEG)
    atol = STREAM_BF16_ATOL if _is_bf16(tts) else STREAM_ATOL
    for i, text in enumerate(TEXTS[:n_texts]):
        off = tts.synthesize(text, spk_emb=emb, seed=i, vocoder="none")
        mel = np.concatenate(list(tts.synthesize_stream(
            text, spk_emb=emb, seed=i, vocoder="none", segment_steps=SEG)),
            axis=-1)
        err = (float(np.abs(mel - off).max()) if mel.shape == off.shape
               else float("inf"))
        print(f"  stream #{i} mel: {mel.shape[1]} frames (offline "
              f"{off.shape[1]}), max|d| vs offline {err:.3e}")
        if not err <= atol:
            raise AssertionError(f"streamed mel #{i} differs: {err}")
    total = 0
    for i, text in enumerate(TEXTS[:n_texts]):
        want = len(tts.synthesize(text, spk_emb=emb, seed=i))
        torch.cuda.synchronize()
        CD.SEG_LAUNCHES = 0
        t0 = time.perf_counter()
        n, t_first, n_chunks = 0, None, 0
        for chunk in tts.synthesize_stream(text, spk_emb=emb, seed=i,
                                           segment_steps=SEG):
            if t_first is None:
                t_first = time.perf_counter() - t0
            n += len(chunk)
            n_chunks += 1
        wall = time.perf_counter() - t0
        launches = CD.SEG_LAUNCHES
        print(f"  stream #{i} griffinlim: first chunk {1e3 * t_first:.1f} "
              f"ms, {n_chunks} chunks, {n} samples (offline {want}) in "
              f"{wall:.3f} s, real-time factor {n / sr / wall:.1f}; "
              f"{launches} segment-kernel launches for {n_seg} segments")
        if n != want or launches != n_seg:
            raise AssertionError(f"stream #{i}: {n} samples (want {want}),"
                                 f" {launches} launches (want {n_seg})")
        total += launches
    return total


def multiplex(tts, device, full: bool = True) -> int:
    """Phase 6: four streams joining a 4-slot CUDA multiplexer staggered;
    each stream's mel against its solo stream (exactly: the same rows
    through the same kernel) and, with ``full``, its plain-segment stream
    at the mux's padded text length, one segment-kernel launch per tick;
    then, with ``full``, the same with Griffin-Lim for the aggregate
    real-time factor.  Returns the launches of the last run."""
    import threading

    import numpy as np
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.serving import AdaptiveTTS
    from msa_tts_tpu_torch.stream_mux import StreamMultiplexer

    t_cap = 128
    sr = tts.params["audio_params"]["sample_rate"]
    embs = [np.random.default_rng(10 + i).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32) for i in range(4)]

    def run(mux, vocoder):
        outs, firsts = {}, {}

        def worker(i):
            t0 = time.perf_counter()
            chunks = []
            for c in mux.stream(TEXTS[i], spk_emb=embs[i], seed=i,
                                vocoder=vocoder):
                if not chunks:
                    firsts[i] = time.perf_counter() - t0
                chunks.append(c)
            outs[i] = np.concatenate(chunks, axis=-1)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        torch.cuda.synchronize()
        ticks0 = mux.metrics()["ticks_total"]
        CD.SEG_LAUNCHES = 0
        t0 = time.perf_counter()
        for th in threads:
            th.start()
            time.sleep(0.02)        # staggered joins: other step phases
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or len(outs) != 4:
            raise AssertionError("a muxed stream did not finish")
        return (outs, firsts, wall, mux.metrics()["ticks_total"] - ticks0,
                CD.SEG_LAUNCHES)

    # the same streams decoded by the plain segment at the mux's padded
    # text length: holds the kernel at B = 4, T = t_cap, under the mux's
    # state gather and insert, against its plain version
    plain_tts = AdaptiveTTS(dict(tts.params, decode_backend="torch"),
                            tts.model, device=device)
    mux = StreamMultiplexer(tts, n_slots=4, backend="cuda", t_cap=t_cap,
                            segment_steps=SEG)
    try:
        outs, _, wall, ticks, launches = run(mux, "none")
        for i in range(4):
            errs = []
            for ref_tts, tol in ((tts, MUX_ATOL),
                                 (plain_tts, SERVE_ATOL))[: 2 if full else 1]:
                ref = np.concatenate(list(ref_tts.synthesize_stream(
                    TEXTS[i], spk_emb=embs[i], seed=i, vocoder="none",
                    segment_steps=SEG, text_pad_multiple=t_cap)), axis=-1)
                errs.append(float(np.abs(outs[i] - ref).max())
                            if outs[i].shape == ref.shape else float("inf"))
                if not errs[-1] <= tol:
                    raise AssertionError(
                        f"muxed stream #{i} differs from its "
                        f"{ref_tts.decode_backend} stream: {errs[-1]} > {tol}")
            print(f"  muxed stream #{i} mel: {outs[i].shape[1]} frames, "
                  f"max|d| vs solo {errs[0]:.3e} (tolerance {MUX_ATOL})"
                  + (f", vs plain-segment stream {errs[1]:.3e} (tolerance "
                     f"{SERVE_ATOL})" if full else ""))
        print(f"  mel run: {ticks} ticks, {launches} segment-kernel "
              f"launches, {1e6 * wall / ticks:.0f} us per tick (wall)")
        if launches != ticks:
            raise AssertionError(f"{launches} launches for {ticks} ticks")
        if not full:
            return launches
        outs, firsts, wall, ticks, launches = run(mux, "griffinlim")
        audio = sum(len(w) for w in outs.values()) / sr
        print(f"  griffinlim run: {ticks} ticks, {launches} launches, "
              f"{1e6 * wall / ticks:.0f} us per tick (wall), {audio:.2f} s "
              f"of audio in {wall:.3f} s: aggregate real-time factor "
              f"{audio / wall:.1f}; first chunks "
              + ", ".join(f"{1e3 * firsts[i]:.0f}" for i in range(4))
              + " ms")
        if launches != ticks:
            raise AssertionError(f"{launches} launches for {ticks} ticks")
    finally:
        mux.close()
    return launches


def http_server(tts, device) -> None:
    """Phase 7: ``TTSServer(stream_multiplex=4)`` on 127.0.0.1:0, one
    POST to /synthesize and one to /synthesize_stream; both wav bodies
    have the offline length, and /stats counts both requests."""
    import http.client
    import json as _json

    import numpy as np

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.server import TTSServer

    emb = np.random.default_rng(0).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32)
    hop = tts.params["audio_params"]["hop_length"]
    want = 2 * hop * (tts.cfg.max_decoder_steps
                      * tts.cfg.n_frames_per_step - 1)
    server = TTSServer(tts, default_spk_emb=emb, stream_multiplex=4)
    port = server.start()
    try:
        bodies = {}
        CD.LAUNCHES = CD.SEG_LAUNCHES = 0
        for path in ("/synthesize", "/synthesize_stream"):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            t0 = time.perf_counter()
            conn.request("POST", path, _json.dumps({"text": TEXTS[0]}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            print(f"  POST {path}: {resp.status}, {len(body)} bytes in "
                  f"{time.perf_counter() - t0:.3f} s")
            if resp.status != 200 or body[:4] != b"RIFF":
                raise AssertionError(f"{path}: status {resp.status}")
            bodies[path] = body
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = _json.loads(conn.getresponse().read())
        conn.close()
        mux = stats["stream_mux"]
        print(f"  /stats: requests_total {stats['requests_total']}, "
              f"errors_total {stats['errors_total']}, stream_mux admitted "
              f"{mux['admitted_total']}, completed {mux['completed_total']}"
              f", ticks {mux['ticks_total']}; whole-loop launches "
              f"{CD.LAUNCHES}, segment launches {CD.SEG_LAUNCHES}")
        for path, body in bodies.items():
            if len(body) - 44 != want:
                raise AssertionError(f"{path}: {len(body) - 44} PCM bytes, "
                                     f"want {want}")
        if (stats["requests_total"] != 2 or stats["errors_total"] != 0
                or mux["completed_total"] != 1 or CD.LAUNCHES != 1
                or CD.SEG_LAUNCHES != mux["ticks_total"]):
            raise AssertionError("server counts are off")
    finally:
        server.stop()


# --------------------------------------------------------------------
# Phases 8-10: the vocoder kernels
# --------------------------------------------------------------------

GEN_B, GEN_T = 44, 3850   # folds of a ~6 s utterance; target + 2·overlap
GEN_RUN_ATOL = 1e-4       # f32, whole run: the summation orders differ
                          # and the loop feeds that back 3,850 times
GEN_FLIP = 1e-3           # a row "left" the plain trajectory beyond this
# bf16 weights round every product's input to bf16, where a last-bit
# difference of the f32 sums moves a value by 2^-8 relative, and in the
# mixture output such a jump can change the chosen component.  So: a
# looser bound over the first steps for the Gaussian output (no discrete
# choice), and for both outputs over the whole run the share of samples
# beyond GEN_FLIP (a row that leaves comes back within a few steps; a
# quarter of the rows leave at least once in 3,850 steps, so the count
# of rows that ever left says nothing here)
GEN_BF16_ATOL = 2e-2
GEN_BF16_SHARE = 5e-3
# fewer than 16 rows (a stream window folds to 8): one row's excursion of
# ~100 samples is already 3e-3 of the run, so the share gets more room;
# the f32 comparison at the same rows is the tight one
GEN_BF16_SHARE_FEW = 2e-2
# HiFi-GAN v1 (the JAX package's serving benchmark's generator)
HIFIGAN_V1 = dict(
    resblock="1", upsample_rates=[8, 8, 2, 2],
    upsample_kernel_sizes=[16, 16, 4, 4], upsample_initial_channel=512,
    resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
)


def _gen_bound(gp: dict, B: int, T: int, bf16: bool, *io):
    """Sample loop: two operations per matrix weight, row and step.  Its
    bytes are each input once: the sample-loop weights ``gp`` too (15 MB
    in f32 at the default width, which the 50 MB L2 or the SMs' shared
    memory can hold for the whole launch, so no step has to read them
    from HBM again; the kernel's packed copy of them is its own affair),
    the conditioning and noise streams, and the output (``io``)."""
    from msa_tts_tpu_torch.vocoders.wavernn import GEN_LAYERS

    held = [t for name in GEN_LAYERS for t in gp[name].values()]
    n_mat = sum(t.numel() for name in GEN_LAYERS if name != "I"
                for k, t in gp[name].items() if k.startswith("weight"))
    return _bound(_nbytes(*held, *io), T * 2.0 * n_mat * B,
                  BF16_FLOPS if bf16 else F32_FLOPS)


def _judge_gen(kern, plain, mode: str, tag: str, label: str) -> float:
    """Hold the kernel's samples (rows, T) against the plain loop's from
    the same inputs; returns max |d| over the first CHECK_STEPS steps.
    f32: (a) every row within ATOL over the first steps, (b) the
    Gaussian output within GEN_RUN_ATOL over the whole run, (c) at most
    max(1, 2 %) of the rows ever beyond GEN_FLIP (the mixture choice is
    discrete: a near tie may flip).  bf16: the Gaussian output within
    GEN_BF16_ATOL over the first steps, and the share of samples beyond
    GEN_FLIP over the whole run (GEN_BF16_SHARE, or GEN_BF16_SHARE_FEW
    below 16 rows)."""
    import torch

    if kern.shape != plain.shape:
        raise AssertionError(f"{label}: shapes {tuple(kern.shape)} and "
                             f"{tuple(plain.shape)}")
    if not torch.isfinite(kern).all() or kern.abs().max() > 1.0:
        raise AssertionError(f"{label}: samples not finite or outside "
                             "[-1, 1]")
    B, n = kern.shape[0], CHECK_STEPS
    d = (kern - plain).abs()
    head, whole = float(d[:, :n].max()), float(d.max())
    over = d > GEN_FLIP
    rows = over.any(dim=1)
    firsts = sorted(int(over[b].float().argmax())
                    for b in range(B) if rows[b])
    share = float(over.float().mean())
    print(f"  {label}: {B} rows, max|d| first {n} steps {head:.3e}, whole "
          f"run {whole:.3e}; rows ever beyond {GEN_FLIP}: "
          f"{int(rows.sum())}/{B} (first steps {firsts[:12]}), share of "
          f"samples beyond it {share:.2e}")
    if tag == "f32":
        if not head <= ATOL:
            raise AssertionError(f"{label} first steps: {head}")
        if mode == "GAUSS" and not whole <= GEN_RUN_ATOL:
            raise AssertionError(f"{label} whole run: {whole}")
        if int(rows.sum()) > max(1, int(0.02 * B)):
            raise AssertionError(f"{label}: {int(rows.sum())} rows of {B} "
                                 "left the plain trajectory")
    else:
        if mode == "GAUSS" and not head <= GEN_BF16_ATOL:
            raise AssertionError(f"{label} first steps: {head}")
        limit = GEN_BF16_SHARE if B >= 16 else GEN_BF16_SHARE_FEW
        if not share <= limit:
            raise AssertionError(f"{label}: share {share} > {limit}")
    return head


def gen_kernel_vs_plain(device, seed: int = 0) -> dict:
    """Phase 8: the sample-loop kernel against the plain loop at the
    default WaveRNN width, from seeded weights, conditioning and noise."""
    import torch

    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    B, T = GEN_B, GEN_T
    res = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0}
    inputs = {}
    for mode in ("MOL", "GAUSS"):
        cfg = W.WaveRNNConfig(mode=mode)
        g = torch.Generator().manual_seed(seed)
        model = W.WaveRNNModel(cfg, g).to(device)
        mels_up = torch.randn(B, T, cfg.n_mels, generator=g).to(device)
        aux = torch.randn(B, T, cfg.res_out_dims, generator=g).to(device)
        n1, n2 = W.generation_noise(cfg, g, T, B, device=device)
        for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
            gp = W.cast_generation_params(model, dtype)
            ist, ar = W.hoisted_inputs(gp, cfg, mels_up, aux)
            w = G.kernel_weights(gp, cfg)
            inputs[mode, tag] = (cfg, gp, w, ist, ar, n1, n2)
            kern = G.cuda_generate(w, cfg, ist, ar, n1, n2)
            torch.cuda.synchronize()
            k_ms = _time_ms(
                lambda: G.cuda_generate(w, cfg, ist, ar, n1, n2), 2)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain = W.sample_loop(gp, cfg, ist, ar, n1, n2)
            end.record()
            torch.cuda.synchronize()
            p_ms = start.elapsed_time(end)
            b_ms, b_by = _gen_bound(gp, B, T, dtype is not None, ist, ar,
                                    n1, n2, kern)
            print(f"  {mode} {tag}: kernel {1e3 * k_ms / T:.1f} us/step, "
                  f"plain {1e3 * p_ms / T:.1f} us/step, bound "
                  f"{1e3 * b_ms / T:.2f} us/step by {b_by} ({T} steps)")
            head = _judge_gen(kern, plain, mode, tag, f"{mode} {tag}")
            key = "max_abs_err" if tag == "f32" else "max_abs_err_bf16"
            res[key] = max(res[key], head)
            if mode == "MOL":
                res[tag] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                bound_by=b_by)

    # other batches, MOL: one row, the fold rows the serving phase gives
    # the kernel (a stream window 8, a 1,000-frame request 80, a batch of
    # four 320), and the folds of four ~6 s utterances
    cfg, gp, w, ist, ar, n1, n2 = inputs["MOL", "f32"]
    _, gpb, wb, _, _, _, _ = inputs["MOL", "bf16"]
    t_plain = 200
    for B2 in (1, 8, GEN_B, 80, 4 * GEN_B, 320):
        reps = -(-B2 // B)
        big = [x.repeat(1, reps, *([1] * (x.dim() - 2)))[:, :B2].contiguous()
               for x in (ist, ar, n1, n2)]
        line = f"  MOL B={B2}:"
        for tag, ww, pp in (("f32", w, gp), ("bf16", wb, gpb)):
            k_ms = _time_ms(lambda: G.cuda_generate(ww, cfg, *big), 1)
            p_ms = _time_ms(lambda: W.sample_loop(
                pp, cfg, *(x[:t_plain] for x in big)), 1)
            line += (f" {tag} kernel {1e3 * k_ms / T:.1f} us/step, plain "
                     f"{1e3 * p_ms / t_plain:.1f} us/step (plain over "
                     f"{t_plain} steps);")
        print(line)
        # where a step's time goes (bf16, block 0's clock stamps): the
        # stamped launch must give the samples of the unstamped one
        stamps = torch.zeros(T, G.N_STAMPS, dtype=torch.int64, device=device)
        plain_out = G.cuda_generate(wb, cfg, *big)
        stamped = G.cuda_generate(wb, cfg, *big, phase_ns=stamps)
        torch.cuda.synchronize()
        if not torch.equal(stamped, plain_out):
            raise AssertionError(f"B={B2}: the stamped launch's samples "
                                 "differ from the unstamped one's")
        bd = G.phase_breakdown(stamps)
        total = sum(v for d in bd.values() for v in d.values())
        if not (stamps > 0).all() or not 0.0 < total < 1e4:
            raise AssertionError(f"B={B2}: clock stamps missing or "
                                 f"{total} us a step")
        print(f"    bf16 us/step by phase ({'/'.join(G.PARTS)}): "
              + ", ".join(f"{ph} " + "/".join(f"{v:.2f}" for v in d.values())
                          for ph, d in bd.items())
              + f"; sum {total:.1f}")
    # the main path's fold rows (16 requests x 78 folds), MOL, both types,
    # distinct rows held against the plain loop over the first steps: there
    # bf16 copies a phase's weights in by phase, and past 1,056 rows the
    # sample groups hold 9 or 10 rows
    B3, T3 = 16 * 78, 200
    g = torch.Generator().manual_seed(seed + 1)
    mels3 = torch.randn(B3, T3, cfg.n_mels, generator=g).to(device)
    aux3 = torch.randn(B3, T3, cfg.res_out_dims, generator=g).to(device)
    noise3 = W.generation_noise(cfg, g, T3, B3, device=device)
    for tag, ww, pp in (("f32", w, gp), ("bf16", wb, gpb)):
        ins = (*W.hoisted_inputs(pp, cfg, mels3, aux3), *noise3)
        kern = G.cuda_generate(ww, cfg, *ins)
        plain = W.sample_loop(pp, cfg, *ins)
        head = _judge_gen(kern, plain, "MOL", tag, f"MOL {tag} B={B3}")
        key = "max_abs_err" if tag == "f32" else "max_abs_err_bf16"
        res[key] = max(res[key], head)
        del ins, kern, plain
    # the step barrier alone: a launch of grid barriers and nothing else
    res["barrier_us"] = G.barrier_us(device=device)
    print(f"  one grid barrier (grid.sync(), one block of 512 threads per "
          f"SM) alone: {res['barrier_us']:.3f} us")
    if not 0.0 < res["barrier_us"] < 100.0:
        raise AssertionError(f"barrier time {res['barrier_us']}")
    return res


def serve_vocoders(tts, device) -> int:
    """Phase 9: one request, one batch of four and one stream per neural
    vocoder through ``AdaptiveTTS`` (cuda decode, cuda sample loop, bf16
    sample-loop weights as by default); returns the sample-loop kernel's
    launches on that path.  Then, outside that count: the kernel at the
    fold rows this path gave it against the plain loop, a batch row
    against its solo vocoding, and a request's stages."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders.hifigan import Generator, HiFiGAN
    from msa_tts_tpu_torch.vocoders.wavernn import (
        WaveRNN,
        WaveRNNConfig,
        _fold_counts,
        generation_noise,
    )

    g = torch.Generator().manual_seed(0)
    wcfg = WaveRNNConfig()
    voc = WaveRNN(cfg=wcfg, generator=g, gen_backend="cuda", device=device)
    tts.attach_vocoder("wavernn", voc)
    tts.attach_vocoder("hifigan", HiFiGAN.from_params(
        Generator(HIFIGAN_V1, SHIPPED_AUDIO["n_mels"], g), HIFIGAN_V1))
    emb = np.random.default_rng(0).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32)
    hop, sr = SHIPPED_AUDIO["hop_length"], SHIPPED_AUDIO["sample_rate"]
    n_frames = tts.cfg.max_decoder_steps * tts.cfg.n_frames_per_step
    want = {"wavernn": (n_frames - 1) * hop, "hifigan": n_frames * hop}
    target, overlap = 2_750, 550        # generate_batch's defaults
    L = target + 2 * overlap

    def check(w, name):
        if (w.shape != (want[name],) or not np.isfinite(w).all()
                or np.abs(w).max() > 1.0):
            raise AssertionError(f"{name}: wav of shape {w.shape} (want "
                                 f"{want[name]}), not finite or outside "
                                 "[-1, 1]")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def draw(seed, n_frames_):
        """One utterance's noise for a mel of that many frames."""
        _, n_pad = _fold_counts(-(-n_frames_ // 32) * 32 * hop, target,
                                overlap)
        return generation_noise(wcfg, torch.Generator().manual_seed(seed),
                                L, n_pad, device=device)

    # the per-utterance WaveRNN noise of the batch, drawn here so that a
    # row can be vocoded again alone from the same noise
    noises = [draw(100 + i, n_frames) for i in range(len(TEXTS))]

    # ---- the main path: every launch from here to the count is served
    G.GEN_LAUNCHES = 0
    calls = 0
    for name in ("wavernn", "hifigan"):
        w, dt = timed(lambda: tts.synthesize(TEXTS[0], spk_emb=emb, seed=0,
                                             vocoder=name))
        check(w, name)
        calls += name == "wavernn"
        print(f"  {name} synthesize: {dt:.3f} s wall, {len(w)} samples, "
              f"real-time factor {len(w) / sr / dt:.2f}")
        kw = {"voc_noise": noises} if name == "wavernn" else {}
        batch, dt = timed(lambda: tts.synthesize_batch(
            TEXTS, spk_emb=emb, seed=2, vocoder=name, **kw))
        for w in batch:
            check(w, name)
        calls += name == "wavernn"
        n = sum(len(w) for w in batch)
        print(f"  {name} synthesize_batch x{len(TEXTS)}: {dt:.3f} s wall, "
              f"aggregate real-time factor {n / sr / dt:.2f}")
        if G.GEN_LAUNCHES != calls:
            raise AssertionError(f"{G.GEN_LAUNCHES} sample-loop launches "
                                 f"after {calls} WaveRNN calls")
        if name == "wavernn":
            wavernn_batch = batch
    for name in ("wavernn", "hifigan"):
        before = G.GEN_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n, t_first, n_chunks = 0, None, 0
        for chunk in tts.synthesize_stream(TEXTS[1], spk_emb=emb, seed=1,
                                           vocoder=name, segment_steps=SEG):
            if t_first is None:
                t_first = time.perf_counter() - t0
            if not np.isfinite(chunk).all() or np.abs(chunk).max() > 1.0:
                raise AssertionError(f"{name} stream: bad chunk")
            n += len(chunk)
            n_chunks += 1
        wall = time.perf_counter() - t0
        windows = G.GEN_LAUNCHES - before
        print(f"  {name} stream: first chunk {1e3 * t_first:.1f} ms, "
              f"{n_chunks} chunks, {n} samples in {wall:.3f} s, real-time "
              f"factor {n / sr / wall:.2f}; {windows} sample-loop launches")
        if n != want[name] or windows != (n_chunks if name == "wavernn"
                                          else 0):
            raise AssertionError(f"{name} stream: {n} samples (want "
                                 f"{want[name]}), {windows} launches for "
                                 f"{n_chunks} windows")
    launches = G.GEN_LAUNCHES
    print(f"  sample-loop launches on the served path: {launches} (2 calls "
          f"and {launches - 2} stream windows)")

    # ---- comparisons, not counted above
    # the kernel at the fold rows that path gave it (a 72-frame stream
    # window, a request, the batch of four) against the plain loop: the
    # same weights, mels and noise through a twin with gen_backend
    # "torch", compared on the folded samples before the crossfade
    mels = [torch.as_tensor(m).to(device) for m in tts.synthesize_batch(
        TEXTS, spk_emb=emb, seed=2, vocoder="none")]
    window = mels[1][:, :72].contiguous()
    cases = (("stream window", [window], [draw(200, 72)]),
             ("request", mels[:1], noises[:1]),
             ("batch of 4", mels, noises))
    for gen_dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
        pair = [WaveRNN(voc.model, wcfg, gen_dtype=gen_dtype,
                        gen_backend=backend, device=device)
                for backend in ("cuda", "torch")]
        for label, ms, ns in cases:
            padded, _ = voc._pad_batch(ms)
            (kern, nf), (plain, _) = (
                v._run_folded(padded, target, overlap, ns) for v in pair)
            _judge_gen(kern.flatten(0, 1), plain.flatten(0, 1), wcfg.mode,
                       tag, f"{label}, {tag}, kernel vs plain loop")
    # each row of the batch against its own mel vocoded alone from the
    # same noise: the kernel's rows do not depend on the batch, so only
    # the upsampling network's batch size differs
    for i, mel in enumerate(mels):
        solo = tts._vocode([mel], "wavernn", None,
                           voc_noise=noises[i: i + 1])[0]
        d = np.abs(solo - wavernn_batch[i])
        share = float((d > GEN_FLIP).mean())
        print(f"  wavernn batch row {i} vs solo: max|d| {d.max():.3e}, "
              f"share of samples beyond {GEN_FLIP}: {share:.2e} "
              f"(tolerance {GEN_BF16_SHARE})")
        if solo.shape != wavernn_batch[i].shape or share > GEN_BF16_SHARE:
            raise AssertionError(f"batched wavernn row {i} differs from "
                                 "its solo vocoding")
    # where a vocoded request's time goes (warm): the decode, then the
    # vocoder's stages, each closed by a device synchronisation
    _, t_mel = timed(lambda: tts.synthesize(TEXTS[0], spk_emb=emb, seed=0,
                                            vocoder="none"))
    mel = mels[0]
    n_pad = noises[0][1].shape[1]
    g1 = torch.Generator().manual_seed(7)
    noise, t_noise = timed(lambda: generation_noise(wcfg, g1, L, n_pad,
                                                    device=device))
    if noise[0].device.type != "cuda":
        raise AssertionError("WaveRNN noise was not drawn on the card")
    padded, _ = voc._pad_batch([mel])
    _, t_dev = timed(lambda: voc._run_folded(padded, target, overlap,
                                             [noise]))
    _, t_all = timed(lambda: voc.generate_batch([mel], noises=[noise],
                                                verbose=False))
    _, t_hifi = timed(lambda: tts._vocode([mel], "hifigan", None))
    print(f"  stages of one request, s: text to mel {t_mel:.4f}; WaveRNN "
          f"noise drawn on the card {t_noise:.4f}, upsample + fold "
          f"+ sample loop ({n_pad} rows) {t_dev:.4f}, the whole "
          f"generate_batch with noise given {t_all:.4f} (copy back and "
          f"crossfade {t_all - t_dev:.4f}); HiFi-GAN {t_hifi:.4f}")
    return launches


# bf16 weights, the kernel's 400-step scan against the plain bf16 scan:
# both round the same h to bf16 each step, but the f32 sums' last bits
# differ and a flipped rounding of h feeds back; 4 x the reading of
# 5.1e-4 (NVIDIA H100 80GB HBM3, 700 W).
LSTM_BF16_SCAN_ATOL = 2e-3


def lstm_cell_vs_plain(device, seed: int = 0) -> dict:
    """Phase 10: the LSTM-cell kernel against its plain version at
    B = 16, H = 1024, f32 and bf16 weights: one step, one launch repeated
    bit for bit, the 400-step scans (the kernel's path, its launches
    counted), and the library pair (``torch.mm`` then
    ``aten._thnn_fused_lstm_cell``) computing the same function; then
    ``tools/bench_lstm_cell.py``'s measurements on the device, in turns
    with the library pair: a launch after an L2 flush, a step inside a
    scan replayed from a CUDA graph (no host), the scan's wall and host
    time per step with the host launching."""
    import torch

    from msa_tts_tpu_torch.experimental import cuda_lstm_cell as C
    from tools.bench_lstm_cell import measure

    B, H, T = 16, 1024, 400
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(T, B, 4 * H, generator=g).to(device)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(device)
    h0, c0 = (torch.randn(B, H, generator=g).to(device) for _ in range(2))
    weights = {"f32": w, "bf16": w.to(torch.bfloat16)}
    res, b16 = {}, {}
    for tag, ww in weights.items():
        hk, ck = C.cuda_lstm_cell(xs[0], h0, c0, ww)
        h2, c2 = C.cuda_lstm_cell(xs[0], h0, c0, ww)
        torch.cuda.synchronize()
        hr, cr = C.lstm_cell_reference(xs[0], h0, c0, ww)
        err = max(float((hk - hr).abs().max()), float((ck - cr).abs().max()))
        same = torch.equal(hk, h2) and torch.equal(ck, c2)
        print(f"  cell {tag}: max|d| {err:.3e} (tolerance 1e-5; the plain "
              "version rounds the same h and weights, sums in f32); a "
              f"repeated launch equal bit for bit: {same}")
        if not err <= 1e-5 or not same:
            raise AssertionError(f"lstm cell {tag}: {err} > 1e-5 or a "
                                 "repeat differs")
        (res if tag == "f32" else b16)["max_abs_err"] = err

    # the kernel's path: a scan in each type, the counts read just after
    for tag, ww in weights.items():
        C.CELL_LAUNCHES = 0
        hs, (hT, cT) = C.lstm_scan(xs, h0, c0, ww)
        torch.cuda.synchronize()
        n = C.CELL_LAUNCHES
        hp, (hpT, cpT) = C.lstm_scan(xs, h0, c0, ww, backend="torch")
        err = max(float((hs - hp).abs().max()), float((cT - cpT).abs().max()))
        tol = 1e-4 if tag == "f32" else LSTM_BF16_SCAN_ATOL
        print(f"  {tag} scan of {T} steps: {n} launches, max|d| vs the "
              f"plain scan {err:.3e} (tolerance {tol})")
        if n != T or not err <= tol:
            raise AssertionError(f"lstm scan {tag}: launches or values are "
                                 "off")
        out = res if tag == "f32" else b16
        out.update(launches=n, scan_max_abs_err=err)

    def library_cell(x_proj, h, c, w_hh_t):
        hy, cy, _ = torch.ops.aten._thnn_fused_lstm_cell(
            x_proj, torch.mm(h, w_hh_t), c)
        return hy, cy

    hl, cl = library_cell(xs[0], h0, c0, w)
    hr, cr = C.lstm_cell_reference(xs[0], h0, c0, w)
    err = max(float((hl - hr).abs().max()), float((cl - cr).abs().max()))
    if not err <= 1e-5:
        raise AssertionError(f"the library's cell computes another "
                             f"function: {err}")

    m = measure(C, B, H, T, turns=5, seed=seed)
    us = {k: v["median"] for k, v in m["us"].items()}
    print("  on the device, µs, medians of 5 turns [min-max] (kernel and "
          "library pair alternate; copy: one 64 KB copy kernel, the "
          "method's floor):")
    for k, v in m["us"].items():
        print(f"    {k:28s} {v['median']:8.2f} [{v['min']:.2f}-"
              f"{v['max']:.2f}]")
    for k, v in m["profiler"].items():
        print(f"    profiler {k}: {v['us_per_step']:.2f} µs/step")
    for tag, out in (("f32", res), ("bf16", b16)):
        out.update(
            ms=1e-3 * us[f"kernel_{tag}_in_scan"],
            plain_ms=1e-3 * us["plain_f32_scan_wall"],
            bound_ms=1e-3 * m[f"bound_us_{tag}"],
            bound_by=m[f"bound_by_{tag}"],
            device_us_cold=us[f"kernel_{tag}_cold"],
            device_us_in_scan=us[f"kernel_{tag}_in_scan"],
            profiler_us_in_scan=m["profiler"][f"kernel_{tag}"]["us_per_step"],
            library_device_us_in_scan=us["library_f32_in_scan"],
            library_device_us_cold=us["library_f32_cold"],
            bound_us=m[f"bound_us_{tag}"],
            scan_wall_us=us[f"kernel_{tag}_scan_wall"],
            scan_host_us=us[f"kernel_{tag}_scan_host"],
        )
    res.update(library_ms=1e-3 * us["library_f32_in_scan"],
               per_call_wall_us=us["kernel_f32_per_call_scan_wall"],
               per_call_host_us=us["kernel_f32_per_call_scan_host"],
               floor_us_cold=us["copy_f32_cold"],
               floor_us_in_scan=us["copy_f32_in_scan"])
    print(f"  host per step: lstm_scan {res['scan_host_us']:.2f} µs (its "
          "arguments built once a scan) against one cuda_lstm_cell call a "
          f"step {res['per_call_host_us']:.2f} µs (built every step)")
    res["bf16"] = b16
    return res


# --------------------------------------------------------------------
# Phase 11: few-shot adaptation
# --------------------------------------------------------------------

# The card's adapt against the same adapt on the CPU with the same clips
# and masks, float32 on both sides (TF32 off): cuDNN's LSTM and the
# library convolutions sum in other orders than the CPU's, over 5 forward
# and backward passes.  Each limit is set from its own readings (NVIDIA
# H100 80GB HBM3, 700 W, three machines), at no more than 4 x the
# largest: the adapted weights max|d| 2.7e-6 and 2.8e-6 (absolute); the
# batch norms' running statistics, whose variances reach the hundreds,
# per tensor max|d| over max|value|, 9.4e-5 on one machine (a postnet
# running mean, values near zero); the query loss 1.3e-7, 2.6e-7 and
# 1.3e-7 relative.
ADAPT_W_ATOL = 1e-5
ADAPT_STAT_RTOL = 3e-4
ADAPT_LOSS_RTOL = 1e-6


def _clips(dirname: str, n: int, sr: int, seed: int = 0) -> list:
    """``n`` clips of 1.5-2.5 s: voiced harmonics (a gliding pitch) and
    noise between quiet margins, so that the silence trim keeps most of
    each; written as 16-bit wavs."""
    import os

    import numpy as np

    from msa_tts_tpu_torch.ops.audio import save_wav

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        n_samp = int(sr * (1.5 + i / max(n - 1, 1)))
        t = np.arange(n_samp) / sr
        f0 = 110.0 + 30.0 * i + 20.0 * np.sin(2 * np.pi * 0.7 * t)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        w = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
        w = w + 0.02 * rng.standard_normal(n_samp)
        edge = int(0.15 * sr)
        w[:edge] *= 1e-3
        w[-edge:] *= 1e-3
        paths.append(os.path.join(dirname, f"clip{i}.wav"))
        save_wav(paths[-1], w, sr)
    return paths


def adapt_phase(device, mp: dict, audio: dict, adapt_params: dict,
                n_clips: int = 4) -> dict:
    """Phase 11: ``AdaptiveTTS.adapt`` of seeded random weights from
    ``n_clips`` synthetic clips on the card, timed warm (median of 3,
    with its range) with the peak device memory; the adapted weights and
    query loss against the same adapt on the CPU with the same masks;
    the query loss below the first inner step's; every adapted weight
    finite; ``save_voice`` / ``load_voice`` serving the same mel bit for
    bit; then the adapted voice served through the whole-loop kernel
    (float32, and bfloat16 from the same float32 weights) and the
    segment kernel, with their launches counted from 0 and held against
    the plain decode at phase 3's limits."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
        dropout_masks,
    )
    from msa_tts_tpu_torch.serving import AdaptiveTTS, Voice

    params = dict(adapt_params, model=mp, audio_params=dict(audio),
                  decode_backend="cuda")

    def make(dev, **over):
        model = Tacotron2NV(config_from_params(mp),
                            generator=torch.Generator().manual_seed(0))
        return AdaptiveTTS(dict(params, **over), model, device=dev)

    tts, cpu = make(device), make("cpu", decode_backend="torch")
    n_inner = tts._n_inner
    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_adapt_")
    try:
        wavs = _clips(tmp, n_clips, audio["sample_rate"])
        phones = [tts.g2p.text_to_phone(t) for t in TEXTS[:n_clips]]
        emb = np.random.default_rng(5).standard_normal(
            tts.cfg.speaker_embedding_dim).astype(np.float32)
        t0 = time.perf_counter()
        batch = cpu.adapt_batch(wavs, phones, emb)
        res["features_s"] = time.perf_counter() - t0
        B, T_in = batch["inputs"].shape
        T_mel = batch["melspecs"].shape[-1]
        print(f"  {n_clips} clips of 1.5-2.5 s; "
              f"batch B {B}, T_in {T_in}, T_mel {T_mel} (mel lengths "
              f"{batch['melspec_lengths'].tolist()}), "
              f"{T_mel // tts.cfg.n_frames_per_step} teacher-forced steps "
              f"a pass, {n_inner} steps of {adapt_params['optim_inner']} "
              f"+ the query pass; "
              f"{sum(p.numel() for p in tts.model.parameters()) / 1e6:.1f} "
              f"M parameters; the clips' features and batch on the host "
              f"{1e3 * res['features_s']:.0f} ms")

        # the product path: masks drawn on the card from the seed
        tts.adapt(wavs, phones, emb, seed=0)                  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base_mem = torch.cuda.memory_allocated(device)
        walls = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tts.adapt(wavs, phones, emb, seed=i + 1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(device)
        res["adapt_s"] = sorted(walls)[1]
        res["adapt_s_min"], res["adapt_s_max"] = min(walls), max(walls)
        res["peak_bytes"] = peak
        res["peak_above_weights_bytes"] = peak - base_mem
        print(f"  adapt, warm, masks drawn on the card: median "
              f"{res['adapt_s']:.3f} s of 3 [{min(walls):.3f}-"
              f"{max(walls):.3f}]; peak device memory {peak / 2**20:.0f} "
              f"MiB ({(peak - base_mem) / 2**20:.0f} MiB above what was "
              f"held before); {_gpu_line()}")

        # card against CPU on the same masks (drawn on the CPU)
        g = torch.Generator().manual_seed(11)
        masks = [dropout_masks(tts.cfg, B, T_in, T_mel, g, device="cpu")
                 for _ in range(n_inner + 1)]
        v = tts.adapt(wavs, phones, emb, masks=masks)
        t0 = time.perf_counter()
        ref = cpu.adapt(wavs, phones, emb, masks=masks)
        res["cpu_adapt_s"] = time.perf_counter() - t0
        # weights absolute; running statistics relative to their tensor's
        # largest value
        worst = {"weights": (0.0, None), "statistics": (0.0, None)}
        moved = 0.0
        for k, t in v.state_dict.items():
            if not t.is_floating_point():
                continue
            if not torch.isfinite(t).all():
                raise AssertionError(f"adapted {k} is not finite")
            r = ref.state_dict[k]
            d = float((t.cpu() - r).abs().max())
            kind = "statistics" if "running_" in k else "weights"
            if kind == "statistics":
                d /= max(float(r.abs().max()), 1e-30)
            else:
                moved = max(moved, float((t - tts._master[k]).abs().max()))
            if d >= worst[kind][0]:
                worst[kind] = (d, k)
        rel = abs(v.support_loss - ref.support_loss) / ref.support_loss
        res["max_abs_err"] = worst["weights"][0]
        res["stat_rel_err"] = worst["statistics"][0]
        res["loss_rel_err"] = rel
        print(f"  card vs CPU ({res['cpu_adapt_s']:.1f} s on the CPU), same "
              f"masks: adapted weights max|d| {worst['weights'][0]:.3e} "
              f"({worst['weights'][1]}; limit {ADAPT_W_ATOL}); running "
              f"statistics max|d|/max|value| {worst['statistics'][0]:.3e} "
              f"({worst['statistics'][1]}; limit {ADAPT_STAT_RTOL}); largest "
              f"step from the base weights {moved:.3e}; query loss card "
              f"{v.support_loss:.6f} CPU {ref.support_loss:.6f} (rel "
              f"{rel:.2e}, limit {ADAPT_LOSS_RTOL})")
        if not (worst["weights"][0] <= ADAPT_W_ATOL
                and worst["statistics"][0] <= ADAPT_STAT_RTOL
                and rel <= ADAPT_LOSS_RTOL):
            raise AssertionError("the card's adapt differs from the CPU's")

        # the first inner step's loss: the base weights on pass 0's masks
        first = make(device, n_inner_test=0).adapt(wavs, phones, emb,
                                                   masks=masks[:1])
        res["first_inner_loss"] = first.support_loss
        res["query_loss"] = v.support_loss
        print(f"  first inner loss {first.support_loss:.6f}, query loss "
              f"after {n_inner} steps {v.support_loss:.6f}")
        if not v.support_loss < first.support_loss:
            raise AssertionError("adaptation did not lower the loss")

        # serve the adapted voice for all max_decoder_steps: random
        # weights fire the gate at once (see serve())
        sd = dict(v.state_dict)
        sd["decoder.gate_layer.linear_layer.bias"] = torch.full_like(
            sd["decoder.gate_layer.linear_layer.bias"], -1e4)
        voice = Voice(sd, v.spk_emb, v.support_loss)
        path = f"{tmp}/adapted.voice"
        tts.save_voice(voice, path)
        loaded = tts.load_voice(path)
        a = tts.synthesize(TEXTS[0], voice, seed=0, vocoder="none")
        b = tts.synthesize(TEXTS[0], loaded, seed=0, vocoder="none")
        print(f"  save_voice -> load_voice: the loaded voice serves the same "
              f"mel bit for bit: {np.array_equal(a, b)}")
        if not np.array_equal(a, b):
            raise AssertionError("a loaded voice serves another mel")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- the adapted voice's main path: every launch from here is served
    tts16 = make(device, infer_dtype="bfloat16")
    S = tts.cfg.max_decoder_steps
    hop = audio["hop_length"]
    want = hop * (S * tts.cfg.n_frames_per_step - 1)
    tts.synthesize(TEXTS[1], voice, seed=0)         # loads the voice once
    tts16.synthesize(TEXTS[1], voice, seed=0)
    torch.cuda.synchronize()
    CD.LAUNCHES = CD.SEG_LAUNCHES = 0
    wavs_out = [tts.synthesize(TEXTS[0], voice, seed=0),
                tts16.synthesize(TEXTS[0], voice, seed=0)]
    n_chunks = n_samples = 0
    for chunk in tts.synthesize_stream(TEXTS[1], voice, seed=1,
                                       segment_steps=SEG):
        n_samples += len(chunk)
        n_chunks += 1
    torch.cuda.synchronize()
    res["launches"], res["seg_launches"] = CD.LAUNCHES, CD.SEG_LAUNCHES
    n_seg = -(-S // SEG)
    print(f"  adapted voice served: synthesize float32 and bfloat16, "
          f"{res['launches']} whole-loop launches; synthesize_stream "
          f"{n_chunks} chunks, {n_samples} samples, {res['seg_launches']} "
          f"segment launches for {n_seg} segments")
    for w in wavs_out:
        if w.shape != (want,) or not np.isfinite(w).all():
            raise AssertionError(f"adapted voice: wav of shape {w.shape}")
    if (res["launches"] != 2 or res["seg_launches"] != n_seg
            or n_samples != want):
        raise AssertionError("adapted voice: launches or samples are off")

    # ---- comparisons, not counted above: kernels against the plain decode
    for t, tag in ((tts, "float32"), (tts16, "bfloat16")):
        plain = AdaptiveTTS(dict(t.params, decode_backend="torch"), t.model,
                            device=device)
        mel = t.synthesize(TEXTS[0], voice, seed=0, vocoder="none")
        ref = plain.synthesize(TEXTS[0], voice, seed=0, vocoder="none")
        d = np.abs(mel - ref) if mel.shape == ref.shape else np.inf
        err = float(np.max(d))
        if tag == "bfloat16":
            share = float((d > DEC_BF16_FLIP["mels"]).mean())
            ok = err <= SERVE_BF16_MAX and share <= DEC_BF16_SHARE
            extra = (f" (limit {SERVE_BF16_MAX}), share beyond "
                     f"{DEC_BF16_FLIP['mels']}: {share:.2e} (limit "
                     f"{DEC_BF16_SHARE})")
        else:
            ok, extra = err <= SERVE_ATOL, f" (limit {SERVE_ATOL})"
            res["serve_max_abs_err"] = err
        print(f"  adapted voice, {tag}: kernel vs plain decode, mel max|d| "
              f"{err:.3e}{extra}")
        if not ok:
            raise AssertionError(f"adapted voice ({tag}) differs from the "
                                 "plain decode")
    streamed = np.concatenate(list(tts.synthesize_stream(
        TEXTS[0], voice, seed=0, vocoder="none", segment_steps=SEG)), -1)
    off = tts.synthesize(TEXTS[0], voice, seed=0, vocoder="none")
    err = (float(np.abs(streamed - off).max()) if streamed.shape == off.shape
           else float("inf"))
    print(f"  adapted voice streamed (segment kernel) vs offline: mel max|d| "
          f"{err:.3e} (limit {STREAM_ATOL})")
    if not err <= STREAM_ATOL:
        raise AssertionError("adapted voice: streamed mel differs")
    return res


# ---------------------------------------------------------------- phase 12
# examples/maml/params.yml with only the data and run-length entries
# changed; everything else (widths, compute_dtype bfloat16, second order,
# 4 tasks x 8 shots, 1 inner step, 5 meta-test steps, the optimizers and
# the clip) is the shipped file's.
MAML_REDUCED = {
    "dataset_*.dataset_path / meta_file / speakers_list":
        "the synthetic corpus: 4 speakers x 12 clips of 0.4-1.2 s, seed 0 "
        "(VCTK's clips are ~2-4 s; no VCTK in the repository)",
    "output_path": "a temporary directory",
    "n_epochs": "3 (500); one meta-step an epoch (4 speakers, 4 tasks)",
    "ckpt_save_epoch_interval": "1 (5)",
    "metatest_epoch_interval": "3 (10)",
    "plot_examples": "false (no matplotlib on the GPU host)",
    "use_tensorboard": "false",
}
MAML_SPEAKERS = ["spk00", "spk01", "spk02", "spk03"]
# Card against CPU, one float32 meta-step (TF32 off) on the same init,
# episode and masks, K = 2 tasks x 2 shots; the outer step there is SGD
# with lr 1, so the new weights carry the (clipped) meta-gradient itself
# (Adam's first step is lr·sign(g), which turns float noise in a
# near-zero gradient into a step of lr).  Limits set from the readings of
# an earlier run (NVIDIA H100 80GB HBM3, 700 W), no looser than 4x the
# larger of the two orders': new weights 1.6e-7 / 1.9e-7 absolute (the
# step moved them by up to 4.8e-2), merged statistics 3.7e-6 / 2.8e-6
# relative to each tensor's largest value, the query loss equal (0 read:
# held to one float32 ulp, 1.2e-7 relative), the gradient norm 1.4e-6 /
# 1.7e-6 relative.
MAML_W_ATOL = 7.6e-7
MAML_STAT_RTOL = 1.4e-5
MAML_LOSS_RTOL = 1.2e-7
MAML_NORM_RTOL = 6.6e-6
# The same second-order card step with compute_dtype bfloat16 against
# float32, 4x the readings of an earlier run (same card and limit): new
# weights 1.1e-3 absolute, statistics 2.3e-2 relative to each tensor's
# largest value, the query loss 3.6e-4 and the gradient norm 1.1e-2
# relative (bfloat16 keeps 8 bits).
MAML_BF16_W_ATOL = 4.2e-3
MAML_BF16_STAT_RTOL = 9.2e-2
MAML_BF16_LOSS_RTOL = 1.4e-3
MAML_BF16_NORM_RTOL = 4.2e-2
# The resumed run against the unbroken one, in the shipped bfloat16: equal
# bit for bit (weights, statistics, step 3's train/loss).  The trainers
# make their steps reproducible on the card (utils/determinism.py: the
# backward on the calling thread, so a second-order step's summation
# order no longer depends on how many steps the autograd engine's worker
# thread ran before).


def maml_params(corpus: str, out: str, **over) -> dict:
    """examples/maml/params.yml pointed at ``corpus`` and ``out`` with the
    run-length entries of MAML_REDUCED, then ``over``."""
    import os

    from msa_tts_tpu_torch.config import load_params

    here = os.path.dirname(os.path.abspath(__file__))
    p = load_params(os.path.join(here, "examples", "maml", "params.yml"))
    for k in ("dataset_train", "dataset_metatrain", "dataset_metatest"):
        p[k] = dict(p[k], dataset_path=corpus, meta_file="metadata.csv",
                    speakers_list=list(MAML_SPEAKERS))
    p.update(output_path=out, n_epochs=3, ckpt_save_epoch_interval=1,
             metatest_epoch_interval=3, plot_examples=False,
             use_tensorboard=False)
    p.update(over)
    return p


def _run_maml(params: dict, workdir: str, keep: tuple = ()) -> list:
    """``trainers.maml.main`` on ``params`` written to
    ``workdir/params.yml``; returns one record per meta-step: wall s,
    peak device bytes above what was held before it, and the valid mel
    frames of its support and query sets.  ``keep``: ``(epoch, dir)``,
    where a copy of the run's files goes once that epoch's are written."""
    import argparse
    import os
    import shutil

    import torch

    from msa_tts_tpu_torch.config import save_params
    from msa_tts_tpu_torch.trainers import maml as TM

    os.makedirs(workdir, exist_ok=True)
    save_params(params, os.path.join(workdir, "params.yml"))
    steps = []

    class Timed(TM.MAML):
        def _init_criterion_optimizer(self):
            super()._init_criterion_optimizer()
            step = self._maml_step

            def timed(state, sup, qry, masks):
                dev = self.device
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                t0 = time.perf_counter()
                out = step(state, sup, qry, masks)
                torch.cuda.synchronize(dev)
                steps.append({
                    "s": time.perf_counter() - t0,
                    "peak_above_bytes":
                        torch.cuda.max_memory_allocated(dev) - base,
                    "frames": int(sup["melspec_lengths"].sum()
                                  + qry["melspec_lengths"].sum()),
                })
                return out

            self._maml_step = timed

        def _save_epoch_state(self, epoch, extra=None):
            super()._save_epoch_state(epoch, extra)
            if keep and epoch == keep[0]:
                if self._async_ckpt is not None:     # drain the writer
                    self._async_ckpt.close()
                    self._async_ckpt = None
                shutil.copytree(self.path_manager.output_path, keep[1])

    orig, TM.MAML = TM.MAML, Timed
    try:
        TM.main(argparse.Namespace(params_path=workdir))
    finally:
        TM.MAML = orig
    return steps


def _logged(run_dir: str) -> dict:
    """Every value the run logged, ``{(tag, step): value}``."""
    import glob
    import os

    out = {}
    for path in glob.glob(os.path.join(run_dir, "logs", "*",
                                       "metrics.jsonl")):
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                out[(d["tag"], d["step"])] = d["value"]
    return out


def _ckpt_state(run_dir: str, cfg, name: str = "checkpoint_0.ckpt"):
    import os

    from msa_tts_tpu_torch.utils.checkpoint import load_checkpoint
    from msa_tts_tpu_torch.utils.convert import state_dict_from_jax

    raw = load_checkpoint(os.path.join(run_dir, "checkpoints", name))
    return state_dict_from_jax(raw["params"], raw["model_state"], cfg), raw


def _compare_steps(a, b, theta: dict) -> dict:
    """Two meta-steps' results ``(state, metrics)``: new weights max|d|
    (and how far ``a``'s moved from ``theta``), merged statistics
    relative to each tensor's largest value, query loss and gradient
    norm relative."""
    (new_a, m_a), (new_b, m_b) = a, b
    return {
        "w_max_abs": max(float((new_a.params[k].cpu() - v.cpu()).abs().max())
                         for k, v in new_b.params.items()),
        "moved": max(float((v.cpu() - theta[k].cpu()).abs().max())
                     for k, v in new_b.params.items()),
        "stat_rel": max(float((new_a.model_state[k].cpu() - v.cpu()).abs()
                              .max() / v.abs().max())
                        for k, v in new_b.model_state.items()
                        if "running" in k),
        "loss_rel": abs(float(m_a.loss) - float(m_b.loss))
        / abs(float(m_b.loss)),
        "norm_rel": abs(float(m_a.grad_norm) - float(m_b.grad_norm))
        / float(m_b.grad_norm),
        "loss": float(m_b.loss), "grad_norm": float(m_b.grad_norm),
    }


def _step_card_vs_cpu(device, params: dict, second_order: bool,
                      tmp: str) -> dict:
    """One float32 meta-step (TF32 off) of K = 2 tasks x 2 shots on the
    card and on the CPU from the same init, episode and masks (drawn on
    the CPU); the new weights, the merged batch-norm statistics, the
    query loss and the gradient norm, each as max|d|.  With
    ``second_order``, also the same step on the card with compute_dtype
    bfloat16 against float32 (``bf16_vs_f32``)."""
    import torch

    from msa_tts_tpu_torch.dataloaders.loader_meta import unpack_task_batch
    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks
    from msa_tts_tpu_torch.trainers.maml import MAML

    tag = "second" if second_order else "first"
    p = dict(params, compute_dtype="float32", meta_batch_size=2,
             track_higher_grads=second_order,
             optim_outer={"optimizer_type": "SGD", "lr": 1.0},
             dataset_metatrain=dict(params["dataset_metatrain"],
                                    batch_size=2))
    card = MAML(**dict(p, output_path=f"{tmp}/{tag}_card"))
    cpu = MAML(**dict(p, output_path=f"{tmp}/{tag}_cpu", device="cpu"))
    speakers, sup, qry = next(card.dataloader_metatrain.iter_stacked())
    K, B, T_in = sup.inputs.shape
    T_mel = sup.mels.shape[-1]
    g = torch.Generator().manual_seed(12)
    masks = [[dropout_masks(card.cfg, B, T_in, T_mel, g, device="cpu")
              for _ in range(card.n_inner_train + 1)] for _ in range(K)]
    out = {}
    trainers = [(card, "card"), (cpu, "cpu")]
    if second_order:
        # the shipped compute type on the card, from the same float32 init
        trainers.append((MAML(**dict(p, compute_dtype="bfloat16",
                                     output_path=f"{tmp}/{tag}_bf16")),
                         "bf16"))
    for t, name in trainers:
        m = [[{k: ([x.to(t.device) for x in v] if isinstance(v, list)
                   else v.to(t.device)) for k, v in d.items()}
              for d in task] for task in masks]
        t0 = time.perf_counter()
        out[name] = t._maml_step(
            t.train_state, unpack_task_batch(sup, t.speaker_emb_type,
                                             t.device),
            unpack_task_batch(qry, t.speaker_emb_type, t.device), m)
        if t.device.type == "cuda":
            torch.cuda.synchronize(device)
        out[name + "_s"] = time.perf_counter() - t0
    theta = cpu.train_state.params
    res = dict(_compare_steps(out["card"], out["cpu"], theta), order=tag,
               card_s=out["card_s"], cpu_s=out["cpu_s"],
               shape=[K, B, T_in, T_mel])
    if second_order:
        res["bf16_vs_f32"] = _compare_steps(out["bf16"], out["card"], theta)
    return res


def maml_phase(device) -> dict:
    """Phase 12: MAML meta-training at the shipped width through the
    port's entry point (``trainers.maml.main``, second order, bfloat16
    compute, 4 tasks x 8 shots) for 3 epochs on a synthetic corpus: each
    meta-step's wall time, mel frames per second and peak device memory,
    the meta-test's losses and MCD, every logged value finite; the run's
    files after 2 epochs resumed to 3 against it; one float32 meta-step,
    second and then first order, on the card against the CPU; and the
    trained checkpoint served through the whole-loop kernel (float32 and
    bfloat16) and the segment kernel, held to the plain decode."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus

    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_maml_")
    try:
        corpus = f"{tmp}/corpus"
        make_synthetic_corpus(corpus, n_speakers=4,
                              utterances_per_speaker=12, seed=0,
                              spk_emb_dim=SHIPPED_MODEL[
                                  "speaker_embedding_dim"])
        params = maml_params(corpus, f"{tmp}/full")
        print("  reduced: " + json.dumps(MAML_REDUCED))
        mp = params["model"]
        print(f"  kept: width E {mp['encoder_embedding_dim']} + "
              f"{mp['speaker_embedding_dim']}, H = Hd "
              f"{mp['decoder_rnn_dim']}, P {mp['prenet_dim']}, "
              f"r {mp['n_frames_per_step']}, compute_dtype "
              f"{params['compute_dtype']}, track_higher_grads "
              f"{params['track_higher_grads']}, {params['meta_batch_size']}"
              f" tasks x {params['dataset_metatrain']['batch_size']} shots, "
              f"n_inner_train {params['n_inner_train']}, n_inner_test "
              f"{params['n_inner_test']}, optim_outer "
              f"{params['optim_outer']}, clip {params['grad_clip_thresh']}")
        t0 = time.perf_counter()
        part_dir = f"{tmp}/part/maml/{params['experiment_name']}"
        steps = _run_maml(params, f"{tmp}/full", keep=(2, part_dir))
        res["run_s"] = time.perf_counter() - t0
        run_dir = f"{tmp}/full/maml/{params['experiment_name']}"
        walls = [s["s"] for s in steps]
        warm = walls[1:]
        res["meta_step_s"] = walls
        res["meta_step_s_warm_median"] = statistics.median(warm)
        res["mel_frames_per_s"] = [s["frames"] / s["s"] for s in steps]
        res["peak_above_bytes"] = max(s["peak_above_bytes"] for s in steps)
        res["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        logs = _logged(run_dir)
        res["test_loss"] = {k[0]: v for k, v in logs.items()
                            if k[0].startswith("test/loss")}
        res["test_mcd"] = {k[0]: v for k, v in logs.items()
                           if k[0].startswith("test/mcd")}
        res["train_loss"] = [logs[("train/loss", i)] for i in range(3)]
        print(f"  trainers.maml.main: {len(steps)} meta-steps in "
              f"{res['run_s']:.1f} s (datasets, checkpoints and the "
              f"meta-test included); meta-step wall s "
              + ", ".join(f"{w:.3f}" for w in walls)
              + f" (warm median {res['meta_step_s_warm_median']:.3f}); "
              f"mel frames/s " + ", ".join(
                  f"{f:.0f}" for f in res["mel_frames_per_s"])
              + f" ({steps[0]['frames']} support+query frames a step); "
              f"peak device memory of a meta-step "
              f"{res['peak_above_bytes'] / 2**30:.2f} GiB above what was "
              f"held ({res['peak_bytes'] / 2**30:.2f} GiB in all); "
              f"{_gpu_line()}")
        print(f"  train/loss {res['train_loss']}; meta-test query losses "
              f"{res['test_loss']}; MCD {res['test_mcd']}")
        bad = [k for k, v in logs.items() if not np.isfinite(v)]
        if bad or len(steps) != 3 or not res["test_loss"]:
            raise AssertionError(f"meta-training: {len(steps)} steps, "
                                 f"non-finite logs {bad}")

        # ---- resume: the unbroken run's files after epoch 2 (kept
        # above), resume: true to epoch 3
        _run_maml(maml_params(corpus, f"{tmp}/part", n_epochs=3,
                              resume=True), f"{tmp}/part")
        cfg = _trained_cfg(run_dir)
        full_sd, full_raw = _ckpt_state(run_dir, cfg)
        part_sd, part_raw = _ckpt_state(part_dir, cfg)
        names = [k for k, v in full_sd.items()
                 if "running" not in k and v.is_floating_point()]
        w = max(float((part_sd[k] - full_sd[k]).abs().max()) for k in names)
        stat = max(float((part_sd[k] - v).abs().max())
                   for k, v in full_sd.items() if "running" in k)
        n_off = sum(not torch.equal(part_sd[k], v)
                    for k, v in full_sd.items())
        part_loss = _logged(part_dir)[("train/loss", 2)]
        res["resume"] = {"w_max_abs": w, "stat_max_abs": stat,
                         "n_differ": n_off,
                         "loss": [part_loss, res["train_loss"][2]]}
        print(f"  2 epochs + resume to 3 against 3 unbroken: steps "
              f"{int(part_raw['step'])} / {int(full_raw['step'])}; weights "
              f"max|d| {w:.3e}, statistics max|d| {stat:.3e}, {n_off} of "
              f"{len(full_sd)} tensors differ; step 3's train/loss "
              f"{part_loss!r} / {res['train_loss'][2]!r} (all must be equal)")
        if int(part_raw["step"]) != 3:
            raise AssertionError("the resumed run took another step count")
        if n_off or part_loss != res["train_loss"][2]:
            raise AssertionError("the resumed run differs")

        # ---- card against CPU, float32, second and first order
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["card_vs_cpu"] = []
        for so in (True, False):
            r = _step_card_vs_cpu(device, params, so, tmp)
            res["card_vs_cpu"].append(r)
            print(f"  {r['order']}-order meta-step card vs CPU (K, B, T_in,"
                  f" T_mel {r['shape']}; card {r['card_s']:.2f} s, CPU "
                  f"{r['cpu_s']:.1f} s): new weights max|d| "
                  f"{r['w_max_abs']:.3e} (limit {MAML_W_ATOL}; the step "
                  f"moved them by up to {r['moved']:.3e}), merged "
                  f"statistics max|d|/max|value| {r['stat_rel']:.3e} (limit"
                  f" {MAML_STAT_RTOL}), query loss {r['loss']:.6f} rel "
                  f"{r['loss_rel']:.2e} (limit {MAML_LOSS_RTOL}), grad norm"
                  f" {r['grad_norm']:.4f} rel {r['norm_rel']:.2e} (limit "
                  f"{MAML_NORM_RTOL})")
            for key, lim in (("w_max_abs", MAML_W_ATOL),
                             ("stat_rel", MAML_STAT_RTOL),
                             ("loss_rel", MAML_LOSS_RTOL),
                             ("norm_rel", MAML_NORM_RTOL)):
                if not r[key] <= lim:
                    raise AssertionError(f"{r['order']}-order meta-step: "
                                         f"{key} {r[key]} > {lim}")
            if "bf16_vs_f32" in r:
                b = r["bf16_vs_f32"]
                print(f"  the same second-order step on the card with "
                      f"compute_dtype bfloat16 against float32: new weights "
                      f"max|d| {b['w_max_abs']:.3e} (limit "
                      f"{MAML_BF16_W_ATOL}), statistics {b['stat_rel']:.3e} "
                      f"(limit {MAML_BF16_STAT_RTOL}), query loss rel "
                      f"{b['loss_rel']:.2e} (limit {MAML_BF16_LOSS_RTOL}), "
                      f"grad norm rel {b['norm_rel']:.2e} (limit "
                      f"{MAML_BF16_NORM_RTOL})")
                for key, lim in (("w_max_abs", MAML_BF16_W_ATOL),
                                 ("stat_rel", MAML_BF16_STAT_RTOL),
                                 ("loss_rel", MAML_BF16_LOSS_RTOL),
                                 ("norm_rel", MAML_BF16_NORM_RTOL)):
                    if not b[key] <= lim:
                        raise AssertionError(f"bf16 meta-step: {key} "
                                             f"{b[key]} > {lim}")

        # ---- the trained checkpoint served: every launch from here on
        res.update(serve_checkpoint(run_dir, "0", device, "trained "
                                    "checkpoint"))
        KEPT["maml_ckpt"] = shutil.copy(
            f"{run_dir}/checkpoints/checkpoint_0.ckpt",
            f"{_kept_dir()}/maml_checkpoint_0.ckpt")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ---------------------------------------------------------------- phase 13
# examples/{baseline,reptile,continual_ewc,continual_erkd}/params.yml with
# only the data and run-length entries changed; everything else (widths,
# compute_dtype bfloat16, batch sizes, optimizers and weight decay, the
# clip, Reptile's 4 tasks x 8 shots and 3 inner steps, the buffers,
# ewc_importance) is the shipped files'.
TRAIN_REDUCED = {
    "dataset_*.dataset_path / meta_file / speakers_list":
        "phase 12's synthetic corpus (4 speakers x 12 clips of 0.4-1.2 s, "
        "seed 0); the streams take its first 3 speakers (the shipped files "
        "name VCTK's p225-p228; no VCTK in the repository)",
    "output_path": "a temporary directory",
    "baseline n_epochs": "2 (200): 2 steps an epoch (40 training clips, "
                         "batches of 32)",
    "baseline ckpt_save_epoch_interval": "1 (5), so that epoch 1 resumes",
    "baseline metatest_epoch_interval": "2 (10), so the meta-test runs once",
    "reptile n_epochs": "2 (500), then 1 in batched mode; one meta-step an "
                        "epoch",
    "continual n_max_epochs": "1 (50, early stopping on): one epoch a task",
    "continual_er, continual_er_reg, cumulative": "streams of 2 speakers "
                                                  "(the shipped 4)",
    "plot_examples": "false (no matplotlib on the GPU host)",
    "use_tensorboard": "false",
    "card against CPU": "batches of 2 (buffer 2, buffer batches of 2) and "
                        "SGD of lr 1, so the new weights carry the clipped "
                        "gradient; float32, TF32 off",
}
TRAIN_METHODS = {"baseline": "JointTrainer", "reptile": "Reptile",
                 "continual_ewc": "EWCTrainer",
                 "continual_erkd": "ExperienceReplayKnowledgeDistillTrainer",
                 "continual_er": "ExperienceReplayTrainer",
                 "continual_er_reg": "ExperienceReplayRegTrainer",
                 "cumulative": "CumulativeTrainer"}
# Card against CPU, one float32 step of the joint trainer and one of EWC
# (its penalised step after the Fisher of two buffer batches, the weights
# moved off the anchor by a seeded 1e-2 normal drawn on the CPU), same
# init, batch and masks: limits 4x the readings of a first run (NVIDIA
# H100 80GB HBM3, 700 W): joint new weights 1.2e-7 absolute (the step
# moved them by up to 2.6e-2), statistics 4.8e-6 relative to each
# tensor's largest value, loss 9.0e-8 and gradient norm 2.5e-7 relative;
# EWC 2.5e-7 (moved up to 0.35), 3.4e-6, 6.5e-8 and 1.5e-7, its Fisher
# within 7.1e-7 of its largest value.  (An earlier move off the anchor,
# 1e-2 sin(i) computed on each device, read 6.4e-5 and 1.7e-4 for EWC:
# the two devices' float32 sines of arguments up to 4e6 differ, and the
# penalty's importance of 1000 carries that into the gradient.)
TRAIN_LIMITS = {
    "joint": {"w_max_abs": 4.8e-7, "stat_rel": 1.9e-5, "loss_rel": 3.6e-7,
              "norm_rel": 1.0e-6},
    "ewc": {"w_max_abs": 1.0e-6, "stat_rel": 1.4e-5, "loss_rel": 2.6e-7,
            "norm_rel": 6.1e-7},
}


def example_params(name: str, corpus: str, out: str, speakers: list,
                   **over) -> dict:
    """examples/<name>/params.yml pointed at ``corpus``, ``speakers`` and
    ``out``, without plots or TensorBoard, then ``over``."""
    import os

    from msa_tts_tpu_torch.config import load_params

    here = os.path.dirname(os.path.abspath(__file__))
    p = load_params(os.path.join(here, "examples", name, "params.yml"))
    for k in ("dataset_train", "dataset_metatrain", "dataset_metatest"):
        if k in p:
            p[k] = dict(p[k], dataset_path=corpus, meta_file="metadata.csv",
                        speakers_list=list(speakers))
    p.update(output_path=out, plot_examples=False, use_tensorboard=False)
    p.update(over)
    return p


def _run_trainer(method: str, params: dict, workdir: str,
                 timed: tuple = (), preempt_task: int | None = None):
    """``trainers.<method>.main`` on ``params`` written to
    ``workdir/params.yml``.  Each method named in ``timed`` (``"step"``:
    Reptile's meta-step) is wrapped to record its wall time (synchronised)
    and the device memory it peaked at above what was held, and for a
    step the valid mel frames of its batches; with ``preempt_task`` the
    stream dies entering that task.  Returns ``(trainer, {name:
    [records]})``."""
    import argparse
    import importlib
    import os

    import torch

    from msa_tts_tpu_torch.config import save_params

    os.makedirs(workdir, exist_ok=True)
    save_params(params, os.path.join(workdir, "params.yml"))
    mod = importlib.import_module(f"msa_tts_tpu_torch.trainers.{method}")
    name = TRAIN_METHODS[method]
    base = getattr(mod, name)
    recs = {n: [] for n in timed}

    def timer(n, fn):
        def call(*a, **k):
            dev = torch.device("cuda", 0)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(dev)
            rec = {"s": time.perf_counter() - t0,
                   "peak_above_bytes":
                       torch.cuda.max_memory_allocated(dev) - held}
            batches = [x for x in a if isinstance(x, dict)
                       and "melspec_lengths" in x]
            if batches:
                rec["frames"] = sum(int(b["melspec_lengths"].sum())
                                    for b in batches)
            recs[n].append(rec)
            return out
        return call

    ran = []

    class Timed(base):
        def _init_criterion_optimizer(self):
            super()._init_criterion_optimizer()
            if "step" in timed:
                self._reptile_step = timer("step", self._reptile_step)

        def run(self):
            ran.append(self)
            for n in timed:
                if n != "step":
                    setattr(self, n, timer(n, getattr(self, n)))
            super().run()

        def _task_train_items(self, speaker, spk_itr):
            if spk_itr == preempt_task:
                raise RuntimeError("simulated preemption")
            return super()._task_train_items(speaker, spk_itr)

    setattr(mod, name, Timed)
    try:
        mod.main(argparse.Namespace(params_path=workdir))
    except RuntimeError as e:
        if preempt_task is None or "simulated preemption" not in str(e):
            raise
    finally:
        setattr(mod, name, base)
    return ran[0], recs


def _same_state(a, b) -> tuple:
    """``(weights max|d|, statistics max|d|, number of tensors that
    differ)`` of two train states."""
    import torch

    w = max(float((a.params[k] - v).abs().max()) for k, v in b.params.items())
    st = max(float((a.model_state[k].float() - v.float()).abs().max())
             for k, v in b.model_state.items())
    n = sum(not torch.equal(a.params[k], v) for k, v in b.params.items())
    n += sum(not torch.equal(a.model_state[k], v)
             for k, v in b.model_state.items())
    return w, st, n


def _train_card_vs_cpu(kind: str, params: dict, tmp: str) -> dict:
    """One float32 step (TF32 off) on the card and on the CPU from the same
    init, batch and masks (drawn on the CPU): the joint trainer's step, or
    EWC's penalised step after the Fisher of a buffer of two tasks (the
    weights moved off its anchor by a seeded 1e-2 normal drawn on the
    CPU); batches of 2, SGD of lr 1.  The new weights, statistics, loss
    and gradient norm, as max|d|; for EWC also its Fisher's."""
    import importlib

    import torch

    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks

    method = "baseline" if kind == "joint" else "continual_ewc"
    base = getattr(importlib.import_module(
        f"msa_tts_tpu_torch.trainers.{method}"), TRAIN_METHODS[method])

    class OnHost(base):
        """Every pass's masks drawn on the CPU (the Fisher's too), so that
        both devices see the same."""

        def _draw_step_masks(self, phase, key, batch):
            B, T_in = batch["inputs"].shape
            g = torch.Generator().manual_seed(
                self._mask_generator(phase, *key).initial_seed())
            return {k: ([x.to(self.device) for x in v]
                        if isinstance(v, list) else v.to(self.device))
                    for k, v in dropout_masks(
                        self.cfg, B, T_in, batch["melspecs"].shape[-1], g,
                        device="cpu").items()}

    p = dict(params, compute_dtype="float32",
             dataset_train=dict(params["dataset_train"], batch_size=2),
             optim={"optimizer_type": "SGD", "lr": 1.0},
             buffer_sample_size=2, buffer_batch_size=2, do_metatest=False)
    out, ts, fishers = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t = OnHost(**dict(p, output_path=f"{tmp}/{kind}_{dev}", device=dev))
        t0 = time.perf_counter()
        if kind == "joint":
            b = next(iter(t.dataloader_train))
        else:
            t.speakers_so_far = []
            for i, spk in enumerate(t.all_speakers[:2]):
                t.speakers_so_far.append(spk)
                t._reset_optimizer(spk)
                items = t._task_train_items(spk, i)
            b = next(iter(t._make_loader(items, seed=1)))
            g = torch.Generator().manual_seed(13)
            with torch.no_grad():
                t.train_state = t.train_state._replace(params={
                    k: v + 1e-2 * torch.randn(v.shape, generator=g).to(
                        v.device)
                    for k, v in t.train_state.params.items()})
            fishers[dev] = {k: v.cpu() for k, v in t._ewc[0].items()}
        batch = t._unpack_batch(b)
        B, T_in = batch["inputs"].shape
        masks = t._draw_step_masks("task", (1, 0), batch)
        p0 = {k: v.cpu() for k, v in t.train_state.params.items()}
        step = t._task_step if kind == "ewc" else t._train_step
        out[dev] = step(t.train_state, batch, masks)
        if t.device.type == "cuda":
            torch.cuda.synchronize()
        ts[dev] = time.perf_counter() - t0
    (sc, mc, _), (sr, mr, _) = out["cuda"], out["cpu"]
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))  # noqa: E731
    extra = {}
    if fishers:
        top = max(float(v.abs().max()) for v in fishers["cpu"].values())
        extra = {"fisher_rel": max(float((fishers["cuda"][k] - v).abs().max())
                                   for k, v in fishers["cpu"].items()) / top,
                 "fisher_max": top,
                 "base_loss": float(mr["base_loss"])}
    return {**extra,
        "kind": kind, "shape": [B, T_in, batch["melspecs"].shape[-1]],
        "card_s": ts["cuda"], "cpu_s": ts["cpu"],
        "w_max_abs": max(float((sc.params[k].cpu() - v).abs().max())
                         for k, v in sr.params.items()),
        "moved": max(float((v - p0[k]).abs().max())
                     for k, v in sr.params.items()),
        "stat_rel": max(float((sc.model_state[k].cpu() - v).abs().max()
                              / v.abs().max())
                        for k, v in sr.model_state.items() if "running" in k),
        "loss_rel": rel(mc["loss"], mr["loss"]),
        "norm_rel": rel(mc["grad_norm"], mr["grad_norm"]),
        "loss": float(mr["loss"]),
    }


def _check_card_vs_cpu(r: dict) -> None:
    lim = TRAIN_LIMITS[r["kind"]]
    fisher = (f"; the Fisher max|d| {r['fisher_rel']:.3e} of its largest "
              f"value {r['fisher_max']:.3e}, the loss without the penalty "
              f"{r['base_loss']:.6f}" if "fisher_rel" in r else "")
    print(f"  {r['kind']} step card vs CPU (B, T_in, T_mel {r['shape']}; "
          f"card {r['card_s']:.2f} s, CPU {r['cpu_s']:.1f} s, set-up "
          f"included): new weights max|d| {r['w_max_abs']:.3e} (limit "
          f"{lim['w_max_abs']}; the step moved them by up to "
          f"{r['moved']:.3e}), statistics {r['stat_rel']:.3e} (limit "
          f"{lim['stat_rel']}), loss {r['loss']:.6f} rel {r['loss_rel']:.2e} "
          f"(limit {lim['loss_rel']}), grad norm rel {r['norm_rel']:.2e} "
          f"(limit {lim['norm_rel']}){fisher}")
    for key, limit in lim.items():
        if not r[key] <= limit:
            raise AssertionError(f"{r['kind']} step card vs CPU: {key} "
                                 f"{r[key]} > {limit}")


def _steps_summary(recs: list) -> dict:
    import statistics

    walls = [r["s"] for r in recs]
    out = {"step_s": walls,
           "peak_above_bytes": max(r["peak_above_bytes"] for r in recs)}
    if len(walls) > 1:
        out["step_s_warm_median"] = statistics.median(walls[1:])
    if "frames" in recs[0]:
        out["mel_frames_per_s"] = [r["frames"] / r["s"] for r in recs]
    return out


def train_phase(device) -> dict:
    """Phase 13: the joint trainer, Reptile and the continual streams
    (EWC and ER-KD of 3 speakers, ER, ER-reg and cumulative of 2) at the
    shipped width through their entry points (``main``), then the joint
    checkpoint and the last EWC checkpoint served through the decoder
    kernels."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
    from tools.profile_decode import device_busy

    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        corpus = f"{tmp}/corpus"
        make_synthetic_corpus(corpus, n_speakers=4, utterances_per_speaker=12,
                              seed=0, spk_emb_dim=SHIPPED_MODEL[
                                  "speaker_embedding_dim"])
        print("  reduced: " + json.dumps(TRAIN_REDUCED))

        # ---- joint training: 2 epochs, a meta-test after epoch 2
        jp = example_params("baseline", corpus, f"{tmp}/joint", MAML_SPEAKERS,
                            n_epochs=2, ckpt_save_epoch_interval=1,
                            metatest_epoch_interval=2)
        t0 = time.perf_counter()
        joint, recs = _run_trainer("baseline", jp, f"{tmp}/joint",
                                   ("_train_step",))
        j = _steps_summary(recs["_train_step"])
        j["run_s"] = time.perf_counter() - t0
        run_dir = joint.path_manager.output_path
        logs = _logged(run_dir)
        j["train_loss"] = [logs[("train/loss", i)]
                           for i in range(joint.step_global)
                           if ("train/loss", i) in logs]
        j["test_loss"] = {k[0]: v for k, v in logs.items()
                          if k[0].startswith("test/loss")}
        bad = [k for k, v in logs.items() if not np.isfinite(v)]
        if bad or joint.step_global != 4 or "test/loss_spk00" not in \
                j["test_loss"]:
            raise AssertionError(f"joint training: {joint.step_global} steps,"
                                 f" non-finite logs {bad}")
        batch = joint._unpack_batch(next(iter(joint.dataloader_train)))
        masks = joint._draw_step_masks("train", (3, 1), batch)
        joint._train_step(joint.train_state, batch, masks)       # warm
        busy, _ = device_busy(lambda: joint._train_step(
            joint.train_state, batch, masks), "joint_step")
        j["profiled"] = busy
        j["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        print(f"  trainers.baseline.main: {joint.step_global} steps (batch "
              f"{jp['dataset_train']['batch_size']}) in {j['run_s']:.1f} s "
              "(datasets, test passes, checkpoints and the meta-test "
              "included); step wall s " + ", ".join(
                  f"{w:.3f}" for w in j["step_s"])
              + f" (warm median {j['step_s_warm_median']:.3f}); mel "
              "frames/s " + ", ".join(f"{f:.0f}"
                                      for f in j["mel_frames_per_s"])
              + f"; peak device memory of a step "
              f"{j['peak_above_bytes'] / 2**30:.2f} GiB above what was held; "
              f"profiled warm step: {busy['wall_ms']:.1f} ms wall, device "
              f"busy {busy['device_busy_ms']:.1f} ms (share "
              f"{busy['busy_share']:.3f}, {busy['device_events']} device "
              f"events); {_gpu_line()}")
        print(f"  train/loss {j['train_loss']}; test losses {j['test_loss']}")

        # resume: 1 epoch, then resume: true to 2, against the 2 above
        part = dict(jp, n_epochs=1)
        _run_trainer("baseline", part, f"{tmp}/joint_part")
        resumed, _ = _run_trainer("baseline", dict(part, n_epochs=2,
                                                   resume=True),
                                  f"{tmp}/joint_part")
        w, st, n = _same_state(resumed.train_state, joint.train_state)
        j["resume"] = {"w_max_abs": w, "stat_max_abs": st, "n_differ": n,
                       "best_equal": resumed.best_test_loss
                       == joint.best_test_loss}
        print(f"  1 epoch + resume to 2 against 2 unbroken: steps "
              f"{resumed.step_global} / {joint.step_global}; weights max|d| "
              f"{w:.3e}, statistics {st:.3e}, {n} tensors differ; best test "
              f"loss {resumed.best_test_loss} / {joint.best_test_loss}")
        if n or not j["resume"]["best_equal"] or \
                resumed.step_global != joint.step_global:
            raise AssertionError("the resumed joint run differs")
        res["joint"] = j

        # ---- Reptile: 2 sequential meta-steps, then 1 batched
        res["reptile"] = {}
        for mode, n_ep in (("sequential", 2), ("batched", 1)):
            rp = example_params("reptile", corpus, f"{tmp}/reptile_{mode}",
                                MAML_SPEAKERS, n_epochs=n_ep,
                                reptile_mode=mode)
            rt, recs = _run_trainer("reptile", rp, f"{tmp}/reptile_{mode}",
                                    ("step",))
            r = _steps_summary(recs["step"])
            r["train_loss"] = [v for k, v in sorted(
                _logged(rt.path_manager.output_path).items())
                if k[0] == "train/loss"]
            res["reptile"][mode] = r
            print(f"  trainers.reptile.main ({mode}, "
                  f"{rp['meta_batch_size']} tasks x "
                  f"{rp['dataset_metatrain']['batch_size']} shots, "
                  f"{rp['n_inner_train']} inner steps): meta-step wall s "
                  + ", ".join(f"{x:.3f}" for x in r["step_s"])
                  + "; mel frames/s " + ", ".join(
                      f"{f:.0f}" for f in r["mel_frames_per_s"])
                  + f"; peak {r['peak_above_bytes'] / 2**30:.2f} GiB above "
                  f"held; train/loss {r['train_loss']}")
            if (len(r["step_s"]) != n_ep or rt.train_state.step
                    != n_ep * (4 if mode == "sequential" else 1)
                    or not all(np.isfinite(r["train_loss"]))):
                raise AssertionError(f"Reptile {mode}: steps or losses")

        # ---- continual streams of 3 speakers
        speakers = MAML_SPEAKERS[:3]
        res["streams"] = {}
        for method, timed in (("continual_ewc", ("_train_task",
                                                 "_compute_fisher")),
                              ("continual_erkd", ("_train_task",
                                                  "_soften"))):
            cp = example_params(method, corpus, f"{tmp}/{method}", speakers,
                                n_max_epochs=1)
            ct, recs = _run_trainer(method, cp, f"{tmp}/{method}", timed)
            cumu = ct.cumutest_dict
            c = {"task_s": [r["s"] for r in recs["_train_task"]],
                 timed[1] + "_s": [r["s"] for r in recs[timed[1]]],
                 "cumutest": {k: v["losses"] for k, v in cumu.items()},
                 "steps": ct.step_global}
            res["streams"][method] = c
            print(f"  trainers.{method}.main, {len(speakers)} speakers "
                  f"(order {ct.all_speakers}): task wall s "
                  + ", ".join(f"{x:.2f}" for x in c["task_s"])
                  + f"; {timed[1]} s " + ", ".join(
                      f"{x:.2f}" for x in c[timed[1] + "_s"])
                  + f"; {ct.step_global} steps; cumulative test "
                  f"{c['cumutest']}")
            if (sorted(cumu) != [0, 1, 2] or len(cumu[2]["losses"]) != 3
                    or not all(np.isfinite(v)
                               for v in cumu[2]["losses"].values())):
                raise AssertionError(f"{method}: cumulative test")
            if method == "continual_ewc":
                ewc = ct
                if ct._ewc is None or len(c["_compute_fisher_s"]) != 2:
                    raise AssertionError("EWC: no Fisher")
            elif not all(it.soft_mel is not None for it in ct.buffer):
                raise AssertionError("ER-KD: buffer without soft targets")

        # the other three methods, streams of 2 speakers
        for method in ("continual_er", "continual_er_reg", "cumulative"):
            cp = example_params(method, corpus, f"{tmp}/{method}",
                                MAML_SPEAKERS[:2], n_max_epochs=1)
            ct, recs = _run_trainer(method, cp, f"{tmp}/{method}",
                                    ("_train_task",))
            last = ct.cumutest_dict[1]["losses"]
            res["streams"][method] = {
                "task_s": [r["s"] for r in recs["_train_task"]],
                "cumutest": last}
            print(f"  trainers.{method}.main, 2 speakers: task wall s "
                  + ", ".join(f"{r['s']:.2f}" for r in recs["_train_task"])
                  + f"; cumulative test after task 1 {last}")
            if len(last) != 2 or not all(np.isfinite(v)
                                         for v in last.values()):
                raise AssertionError(f"{method}: cumulative test")

        # EWC resume at task 2, against the unbroken stream
        ep = example_params("continual_ewc", corpus, f"{tmp}/ewc_part",
                            speakers, n_max_epochs=1)
        _run_trainer("continual_ewc", ep, f"{tmp}/ewc_part", preempt_task=2)
        resumed, _ = _run_trainer("continual_ewc", dict(ep, resume=True),
                                  f"{tmp}/ewc_part")
        w, st, n = _same_state(resumed.train_state, ewc.train_state)
        same_cumu = resumed.cumutest_dict == ewc.cumutest_dict
        same_buf = ([it.item_id for it in resumed.buffer]
                    == [it.item_id for it in ewc.buffer])
        res["streams"]["continual_ewc"]["resume"] = {
            "w_max_abs": w, "stat_max_abs": st, "n_differ": n,
            "cumutest_equal": same_cumu, "buffer_equal": same_buf}
        print(f"  EWC stream died entering task 2, resumed, against the "
              f"unbroken stream: weights max|d| {w:.3e}, statistics "
              f"{st:.3e}, {n} tensors differ; cumulative test equal "
              f"{same_cumu}, buffer equal {same_buf}")
        if n or not same_cumu or not same_buf or \
                resumed.step_global != ewc.step_global:
            raise AssertionError("the resumed EWC stream differs")
        print(_gpu_line())

        # ---- the joint and the last EWC checkpoints served
        res["joint_served"] = serve_checkpoint(run_dir, "best", device,
                                               "joint checkpoint")
        ewc_dir = ewc.path_manager.output_path
        last = f"best_2_{ewc.all_speakers[2]}.ckpt"
        shutil.copy(os.path.join(ewc_dir, "checkpoints", last),
                    os.path.join(ewc_dir, "checkpoints",
                                 "checkpoint_last_task.ckpt"))
        res["ewc_served"] = serve_checkpoint(ewc_dir, "last_task", device,
                                             f"EWC checkpoint {last}")
        KEPT["stream"] = f"{_kept_dir()}/ewc"
        os.makedirs(f"{KEPT['stream']}/checkpoints")
        shutil.copy(f"{ewc_dir}/params.yml", KEPT["stream"])
        for i, spk in enumerate(ewc.all_speakers):
            shutil.copy(f"{ewc_dir}/checkpoints/best_{i}_{spk}.ckpt",
                        f"{KEPT['stream']}/checkpoints")

        # ---- card against CPU: one float32 joint step, one EWC step
        for kind, params in (("joint", jp), ("ewc", ep)):
            res[f"{kind}_card_vs_cpu"] = _train_card_vs_cpu(kind, params,
                                                            tmp)
        for kind in ("joint", "ewc"):
            _check_card_vs_cpu(res[f"{kind}_card_vs_cpu"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def serve_checkpoint(run_dir: str, ckpt_id: str, device, label: str) -> dict:
    """A trainer's checkpoint (``checkpoints/checkpoint_{ckpt_id}.ckpt``)
    served through ``from_experiment``: two sentences in float32 and two
    in bfloat16 through the whole-loop kernel and one stream through the
    segment kernel, their launches counted (the counts set to 0 just
    before); then, not counted, each kernel's mel held against the plain
    decode of its type and the stream against the offline mel.  The gate
    bias is held at -1e4 (a few steps do not teach the gate), so every
    decode runs all its steps."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    res = {}
    tts = AdaptiveTTS.from_experiment(run_dir, ckpt_id, device=device,
                                      decode_backend="cuda")
    tts16 = AdaptiveTTS.from_experiment(run_dir, ckpt_id, device=device,
                                        decode_backend="cuda",
                                        infer_dtype="bfloat16")
    for t in (tts, tts16):
        with torch.no_grad():
            t.model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    emb = np.random.default_rng(5).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32)
    S = tts.cfg.max_decoder_steps
    hop = SHIPPED_AUDIO["hop_length"]
    want = hop * (S * tts.cfg.n_frames_per_step - 1)
    for t in (tts, tts16):
        t.synthesize(TEXTS[2], spk_emb=emb, seed=0)        # warm
    torch.cuda.synchronize()
    CD.LAUNCHES = CD.SEG_LAUNCHES = 0
    wavs = [t.synthesize(text, spk_emb=emb, seed=i)
            for t in (tts, tts16) for i, text in enumerate(TEXTS[:2])]
    n_samples = sum(len(c) for c in tts.synthesize_stream(
        TEXTS[1], spk_emb=emb, seed=1, segment_steps=SEG))
    torch.cuda.synchronize()
    res["launches"], res["seg_launches"] = CD.LAUNCHES, CD.SEG_LAUNCHES
    n_seg = -(-S // SEG)
    print(f"  {label} served: 2 sentences in float32 and 2 in bfloat16, "
          f"{res['launches']} whole-loop launches; one stream, {n_samples} "
          f"samples, {res['seg_launches']} segment launches for {n_seg} "
          "segments")
    for w in wavs:
        if w.shape != (want,) or not np.isfinite(w).all():
            raise AssertionError(f"{label}: wav {w.shape}")
    if (res["launches"] != 4 or res["seg_launches"] != n_seg
            or n_samples != want):
        raise AssertionError(f"{label}: launches or samples")

    # ---- comparisons, not counted: kernels against the plain decode
    for t, tag in ((tts, "float32"), (tts16, "bfloat16")):
        plain = AdaptiveTTS(dict(t.params, decode_backend="torch"), t.model,
                            device=device)
        for i, text in enumerate(TEXTS[:2]):
            mel = t.synthesize(text, spk_emb=emb, seed=i, vocoder="none")
            ref = plain.synthesize(text, spk_emb=emb, seed=i, vocoder="none")
            d = np.abs(mel - ref) if mel.shape == ref.shape else np.inf
            err = float(np.max(d))
            if tag == "bfloat16":
                share = float((d > DEC_BF16_FLIP["mels"]).mean())
                ok = err <= SERVE_BF16_MAX and share <= DEC_BF16_SHARE
                extra = (f" (limit {SERVE_BF16_MAX}), share beyond "
                         f"{DEC_BF16_FLIP['mels']}: {share:.2e} (limit "
                         f"{DEC_BF16_SHARE})")
            else:
                ok, extra = err <= SERVE_ATOL, f" (limit {SERVE_ATOL})"
                res["serve_max_abs_err"] = max(
                    res.get("serve_max_abs_err", 0.0), err)
            print(f"  {label}, {tag}, sentence {i}: kernel vs plain decode, "
                  f"mel max|d| {err:.3e}{extra}")
            if not ok:
                raise AssertionError(f"{label} ({tag}) differs from the "
                                     "plain decode")
    streamed = np.concatenate(list(tts.synthesize_stream(
        TEXTS[0], spk_emb=emb, seed=0, vocoder="none", segment_steps=SEG)),
        -1)
    off = tts.synthesize(TEXTS[0], spk_emb=emb, seed=0, vocoder="none")
    err = (float(np.abs(streamed - off).max())
           if streamed.shape == off.shape else float("inf"))
    print(f"  {label} streamed (segment kernel) vs offline: mel max|d| "
          f"{err:.3e} (limit {STREAM_ATOL})")
    if not err <= STREAM_ATOL:
        raise AssertionError(f"{label}: streamed mel differs")
    return res


def _trained_cfg(run_dir: str):
    """The model config of a trainer's experiment directory, as
    ``from_experiment`` builds it."""
    import os

    from msa_tts_tpu_torch.config import load_params
    from msa_tts_tpu_torch.models.tacotron2nv import config_from_params
    from msa_tts_tpu_torch.serving import N_SYMBOLS

    p = load_params(os.path.join(run_dir, "params.yml"))
    return config_from_params(dict(
        p["model"], n_mel_channels=p["audio_params"]["n_mels"],
        n_symbols=N_SYMBOLS, num_speakers=1))


TEXTS = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It is easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
]


def serve(tts, device, n_single: int = 2, batch: bool = True) -> int:
    """Phase 3: ``n_single`` single requests and (with ``batch``) one
    batch of four through ``AdaptiveTTS`` with the CUDA decode backend, in
    the type ``tts`` was built with; returns the number of decoder-kernel
    launches they made.  Then one request's mel against the same request
    decoded by the plain loop."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    emb = np.random.default_rng(0).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32)
    hop = tts.params["audio_params"]["hop_length"]
    # Random weights fire the gate at once, and a request's mel is cut at
    # its gate (mel_lengths) even without early stopping.  A gate bias of
    # -1e4 keeps every row unfinished, so each request decodes all
    # max_decoder_steps and yields that many frames of audio.
    with torch.no_grad():
        tts.model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    n_frames = tts.cfg.max_decoder_steps * tts.cfg.n_frames_per_step
    want = hop * (n_frames - 1)
    wavs = []
    tag = "bfloat16" if _is_bf16(tts) else "float32"
    tts.synthesize(TEXTS[0], spk_emb=emb, seed=0)          # warm
    CD.LAUNCHES = 0
    for i, text in enumerate(TEXTS[:n_single]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs.append(tts.synthesize(text, spk_emb=emb, seed=i))
        print(f"  synthesize #{i} ({tag}): {time.perf_counter() - t0:.3f} s "
              f"wall, {len(wavs[-1])} samples")
    batched = []
    if batch:
        t0 = time.perf_counter()
        batched = tts.synthesize_batch(TEXTS, spk_emb=emb, seed=2)
        dt = time.perf_counter() - t0
        print(f"  synthesize_batch x{len(TEXTS)}: {dt:.3f} s wall "
              f"({dt / len(TEXTS):.3f} s per request)")
    launches = CD.LAUNCHES
    n_decodes = n_single + int(batch)
    if launches != n_decodes:
        raise AssertionError(f"{launches} kernel launches for {n_decodes} "
                             "decodes")
    # the same request decoded by the plain loop must give the same mel
    mel = tts.synthesize(TEXTS[0], spk_emb=emb, seed=0, vocoder="none")
    plain_tts = AdaptiveTTS(dict(tts.params, decode_backend="torch"),
                            tts.model, device=device)
    ref = plain_tts.synthesize(TEXTS[0], spk_emb=emb, seed=0,
                               vocoder="none")
    d = np.abs(mel - ref)
    err = float(d.max())
    if _is_bf16(tts):
        # the two bfloat16 decodes part by roundings that flip (see
        # DEC_BF16_*), and the postnet is a bfloat16 library convolution
        flip = DEC_BF16_FLIP["mels"]
        share = float((d > flip).mean())
        print(f"  request mel ({tag}, mean |value| "
              f"{float(np.abs(ref).mean()):.2e}), kernel vs plain decode: "
              f"max|d| {err:.3e} (limit {SERVE_BF16_MAX}), share beyond "
              f"{flip}: {share:.2e} (limit {DEC_BF16_SHARE})")
        ok = share <= DEC_BF16_SHARE and err <= SERVE_BF16_MAX
    else:
        print(f"  request mel, kernel vs plain decode: max|d| {err:.3e} "
              f"(tolerance {SERVE_ATOL})")
        ok = err <= SERVE_ATOL
    if mel.shape != ref.shape or not ok:
        raise AssertionError(f"served mel differs from plain decode: {err}")
    wavs += batched
    for w in wavs:
        if w.shape != (want,) or not np.isfinite(w).all():
            raise AssertionError(
                f"waveform of shape {w.shape} (want ({want},)) or not finite"
            )
    print(f"  decoder kernel launches: {launches} for {n_decodes} decodes; "
          f"all waveforms finite, {want} samples")
    return launches


# ---------------------------------------------------------------- phase 14
# The vocoder trainers at the served widths on phase 12's synthetic corpus.
# WaveRNN: the WaveRNNConfig defaults (MOL, rnn/fc 512, compute and res_out
# 128, 10 res blocks, upsample (4, 8, 8) for hop 256), seq_len 1280, batches
# of 16, Adam lr 1e-4; HiFi-GAN v1 (HIFIGAN_V1), segments of 8192, batches
# of 16, the recipe's AdamWs (lr 2e-4, b 0.8 / 0.99).
VOC_REDUCED = {
    "dataset_train": "phase 12's synthetic corpus: 4 speakers x 12 clips of "
                     "0.4-1.2 s, seed 0 (LJSpeech / VCTK clips are ~2-10 s; "
                     "none in the repository)",
    "wavernn n_steps": "100 (the reference's trainers run ~1e6)",
    "hifigan n_steps": "60 (the recipe runs ~2.5e6)",
    "output_path": "a temporary directory",
    "use_tensorboard": "false",
    "card against CPU": "the same batch on both: WaveRNN 16 rows (the "
                        "served batch), HiFi-GAN 2 segments; float32, TF32 "
                        "off; from the trained checkpoint",
}
VOC_WAVERNN_STEPS = 100
VOC_HIFIGAN_STEPS = 60
VOC_HIFIGAN_CPU_BATCH = 2
# "ap2" at the served hop (HiFi-GAN v1's 8·8·2·2 = 256)
VOC_AP2 = {"n_fft": 1024, "hop_size": 256, "win_size": 1024, "n_mels": 80,
           "sample_rate": 22050, "fmin": 0.0, "fmax": 8000.0,
           "center": False}
# the host library against the numpy path: tests/test_native_feats.py's
FEATS_MEL_ATOL = 1e-5
FEATS_DATASET_ATOL = 2e-4
# Card against CPU, one float32 step from the trained checkpoint's weights
# and a fresh Adam on the same batch: the loss (each of HiFi-GAN's three)
# relative, and Adam's moments after the step (mu: the gradient; the
# square root of nu: its magnitude) as the relative L2 norm of the
# difference over all tensors (mu_l2, nu_l2; G and D apart for HiFi-GAN)
# and as max|d| relative to each tensor's largest value (mu_max, nu_max).
# A ReLU or leaky ReLU whose input lies within rounding of 0 takes the
# other slope on the other device, and a weight gradient summed over a
# few hundred positions then moves by a visible share of its largest
# value, while the L2 norm barely moves.  So the step is taken once more
# on the card with the CPU's slopes forced at every kink (_Slopes): its
# per-tensor bound is held (*_forced), the flips counted; the card's own
# step is held by the L2 norm (and, for WaveRNN, per tensor).  Limits: 4x
# the readings of an earlier run (NVIDIA H100 80GB HBM3, 700 W): WaveRNN
# loss 2.9e-7, mu max 4.9e-4, mu and sqrt(nu) L2 3.0e-5; HiFi-GAN losses
# 1.9e-7, G's mu and sqrt(nu) L2 1.4e-5, D's 7.6e-6.  The forced step,
# per tensor: 4x the readings of the first run that forced the slopes
# (same card; 1e-4 was predicted before it): WaveRNN 4.9e-5 (3 of 21 M
# inputs flipped; unforced 4.9e-4), HiFi-GAN's G 1.08e-4 (unforced
# 2.5e-3) and D 5.7e-6 (unforced 5.5e-4; 11 of 94 M inputs flipped).
VOC_LIMITS = {
    "wavernn": {"loss_rel": 1.2e-6, "mu_max": 2e-3, "nu_max": 2e-3,
                "mu_l2": 1.2e-4, "nu_l2": 1.2e-4,
                "mu_max_forced": 2e-4, "nu_max_forced": 2e-4},
    "hifigan": {"loss_rel": 7.5e-7, "mu_l2G": 5.7e-5, "nu_l2G": 5.7e-5,
                "mu_l2D": 3.1e-5, "nu_l2D": 3.1e-5,
                "mu_maxG_forced": 4.4e-4, "nu_maxG_forced": 4.4e-4,
                "mu_maxD_forced": 2.3e-5, "nu_maxD_forced": 2.3e-5},
}


def _voc_params(kind: str, corpus: str, out: str, **over) -> dict:
    """The params.yml of phase 14's run of the ``kind`` vocoder trainer."""
    from msa_tts_tpu_torch.dataloaders.synthetic import synthetic_params
    from msa_tts_tpu_torch.vocoders.wavernn import WaveRNNConfig

    p = synthetic_params(corpus, n_speakers=4, batch_size=16)
    p["dataset_train"]["speakers_list"] = list(MAML_SPEAKERS)
    p.update(method=kind, experiment_name="phase14", output_path=out,
             use_tensorboard=False, tb_log_interval=1, print_interval=20,
             ckpt_save_step_interval=10 ** 6, train_seed=0, model_seed=0,
             batch_size=16)
    if kind == "wavernn":
        cfg = WaveRNNConfig()
        p.update(audio_params=dict(SHIPPED_AUDIO), voc_mode=cfg.mode,
                 rnn_dims=cfg.rnn_dims, fc_dims=cfg.fc_dims,
                 compute_dims=cfg.compute_dims,
                 res_out_dims=cfg.res_out_dims, res_blocks=cfg.res_blocks,
                 pad=cfg.pad, upsample_factors=list(cfg.upsample_factors),
                 seq_len=1280, lr=1e-4, n_steps=VOC_WAVERNN_STEPS)
    else:
        p.update(audio_processor="ap2", audio_params=dict(VOC_AP2),
                 hifigan=dict(HIFIGAN_V1), segment_size=8192, lr=2e-4,
                 n_steps=VOC_HIFIGAN_STEPS)
    p.update(over)
    return p


def _run_vocoder_trainer(kind: str, params: dict, workdir: str):
    """``trainers.<kind>_train.main`` on ``params`` written to
    ``workdir/params.yml``, each step timed (synchronised) with the device
    memory it peaked at; returns ``(trainer, [records])``."""
    import argparse
    import importlib
    import os

    import torch

    from msa_tts_tpu_torch.config import save_params

    os.makedirs(workdir, exist_ok=True)
    save_params(params, os.path.join(workdir, "params.yml"))
    mod = importlib.import_module(f"msa_tts_tpu_torch.trainers.{kind}_train")
    name = {"wavernn": "WaveRNNTrainer", "hifigan": "HiFiGANTrainer"}[kind]
    base = getattr(mod, name)
    recs, ran = [], []

    class Timed(base):
        def _step(self, *a, **k):
            dev = self.device
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            out = super()._step(*a, **k)
            torch.cuda.synchronize(dev)
            recs.append({"s": time.perf_counter() - t0,
                         "peak_above_bytes":
                             torch.cuda.max_memory_allocated(dev) - held,
                         "samples": int(a[-1].numel())})
            return out

        def run(self):
            ran.append(self)
            return super().run()

    setattr(mod, name, Timed)
    try:
        mod.main(argparse.Namespace(params_path=workdir))
    finally:
        setattr(mod, name, base)
    return ran[0], recs


def _moment_errs(ours: list, ref: list) -> dict:
    """Adam's moments after a step on two devices (``ours[0]``: the first
    Adam state): for mu (the gradient) and the square root of nu (its
    magnitude), the relative L2 norm of the difference over all tensors
    (``mu_l2``, ``nu_l2``) and the largest max|d| relative to a tensor's
    largest |value| (``mu_max``, ``nu_max``), with the three tensors
    furthest off by the latter (``worst``)."""
    out, rows = {}, []
    for name, f in (("mu", lambda t: t), ("nu", lambda t: t.sqrt())):
        num = den = 0.0
        for k, v in ref[0][name].items():
            r, a = f(v.cpu()), f(ours[0][name][k].cpu())
            num += float(((a - r) ** 2).sum())
            den += float((r ** 2).sum())
            scale = max(float(r.abs().max()), 1e-30)
            rows.append((float((a - r).abs().max()) / scale, name, k, scale))
        out[f"{name}_l2"] = (num / max(den, 1e-300)) ** 0.5
        out[f"{name}_max"] = max(r[0] for r in rows if r[1] == name)
    out["worst"] = sorted(rows, reverse=True)[:3]
    return out


def _same(a, b) -> bool:
    """Two trees of tensors equal bit for bit."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


class _Slopes:
    """``F.relu`` and ``F.leaky_relu`` swapped, within ``record()`` or
    ``replay()``, for versions that note which inputs are > 0 or that
    apply the noted slopes in place of their own, call by call:
    ``where(mask, x, slope * x)`` is the function's value and gradient
    wherever the signs agree.  A step on the card replaying the CPU's
    notes takes the CPU's slope at every kink; ``flips`` counts the
    inputs whose own sign was the other one, of ``inputs``."""

    def __init__(self):
        self.masks, self.i, self.inputs = [], 0, 0
        self._flips = 0

    @property
    def flips(self) -> int:
        return int(self._flips)

    def _swapped(self, act):
        import contextlib

        import torch.nn.functional as F

        @contextlib.contextmanager
        def cm():
            relu, leaky = F.relu, F.leaky_relu
            F.relu = lambda x, inplace=False: act(x, 0.0, relu(x))
            F.leaky_relu = (lambda x, negative_slope=0.01, inplace=False:
                            act(x, negative_slope,
                                leaky(x, negative_slope)))
            try:
                yield self
            finally:
                F.relu, F.leaky_relu = relu, leaky
        return cm()

    def record(self):
        def act(x, slope, y):
            self.masks.append(x.detach() > 0)
            return y
        return self._swapped(act)

    def replay(self):
        import torch

        def act(x, slope, y):
            m = self.masks[self.i].to(x.device)
            self.i += 1
            self.inputs += m.numel()
            self._flips = self._flips + (m != (x.detach() > 0)).sum()
            return torch.where(m, x, x * slope)
        self.i = 0
        return self._swapped(act)


def _voc_card_vs_cpu(kind: str, params: dict, ckpt: str, tmp: str) -> dict:
    """One float32 step of the ``kind`` trainer on the card and on the CPU
    from the trained checkpoint's weights and a fresh Adam on the same
    batch, the card's step taken twice from the same state (equal bit
    for bit), and once more with the CPU's ReLU slopes (``_Slopes``)."""
    import importlib

    import numpy as np
    import torch

    mod = importlib.import_module(f"msa_tts_tpu_torch.trainers.{kind}_train")
    cls = getattr(mod, {"wavernn": "WaveRNNTrainer",
                        "hifigan": "HiFiGANTrainer"}[kind])
    trainers = {}
    for dev in ("cuda", "cpu"):
        t = cls(**dict(params, output_path=f"{tmp}/{kind}_{dev}",
                       device=dev))
        t.restore(ckpt)
        # a fresh Adam, so that its moments after the step hold this
        # step's gradients alone
        if kind == "wavernn":
            t.opt_state = t.tx.init(t.model_params)
        else:
            t.opt_g = t.tx_g.init(t.gen_params)
            t.opt_d = t.tx_d.init(t.disc_params)
        trainers[dev] = t
    n = 16 if kind == "wavernn" else VOC_HIFIGAN_CPU_BATCH
    batch = trainers["cpu"]._sample_batch(np.random.default_rng(7), n)
    slopes = _Slopes()

    def step(dev):
        t = trainers[dev]
        state = ((t.model_params, t.opt_state) if kind == "wavernn"
                 else (t.gen_params, t.disc_params, t.opt_g, t.opt_d))
        return t._step(*state, *(x.to(t.device) for x in batch))

    out, secs = {}, {}
    t0 = time.perf_counter()
    with slopes.record():
        out["cpu"] = step("cpu")
    secs["cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cuda"] = step("cuda")
    torch.cuda.synchronize()
    repeat = _same(out["cuda"], step("cuda"))
    secs["cuda"] = time.perf_counter() - t0
    with slopes.replay():
        forced = step("cuda")
    if slopes.i != len(slopes.masks):
        raise AssertionError(f"{kind}: {slopes.i} activations on the card, "
                             f"{len(slopes.masks)} on the CPU")
    c, r = out["cuda"], out["cpu"]
    if kind == "wavernn":
        losses = {"nll": (c[2], r[2])}
        moments = {"": _moment_errs(c[1], r[1]),
                   "_forced": _moment_errs(forced[1], r[1])}
    else:
        losses = {k: (c[4][k], r[4][k]) for k in r[4]}
        moments = {"G": _moment_errs(c[2], r[2]),
                   "D": _moment_errs(c[3], r[3]),
                   "G_forced": _moment_errs(forced[2], r[2]),
                   "D_forced": _moment_errs(forced[3], r[3])}
    res = {"kind": kind, "rows": n, "card_s": secs["cuda"],
           "cpu_s": secs["cpu"], "repeat_equal": repeat,
           "losses": {k: float(v[1]) for k, v in losses.items()},
           "loss_rel": max(abs(float(a) - float(b)) / abs(float(b))
                           for a, b in losses.values()),
           "slope_flips": slopes.flips, "slope_inputs": slopes.inputs}
    for opt, m in moments.items():
        res.update({f"{key}{opt}": m[key] for key in m if key != "worst"})
    lim = VOC_LIMITS[kind]
    print(f"  {kind} step card vs CPU ({n} rows, the trained checkpoint's "
          f"weights, a fresh Adam; card {res['card_s']:.2f} s for two steps,"
          f" CPU {res['cpu_s']:.1f} s): losses {res['losses']}, max rel "
          f"{res['loss_rel']:.2e} (limit {lim['loss_rel']}); the card's "
          f"step repeated equal bit for bit: {repeat}")
    print(f"    the CPU's slopes forced on a further card step: "
          f"{res['slope_flips']} of {res['slope_inputs']} ReLU / leaky-ReLU "
          "inputs took the other sign on the card")
    for opt, m in moments.items():
        opt = opt.replace("_forced", ", slopes forced").lstrip(", ")
        print(f"    Adam{' of ' + opt if opt else ''}: mu L2 rel "
              f"{m['mu_l2']:.2e}, sqrt(nu) L2 rel {m['nu_l2']:.2e}; of a "
              f"tensor's largest: mu {m['mu_max']:.2e}, sqrt(nu) "
              f"{m['nu_max']:.2e}; furthest off: " + "; ".join(
                  f"{name} {k} {e:.2e} of {sc:.2e}"
                  for e, name, k, sc in m["worst"]))
    bad = [f"{key} {res[key]} > {limit}" for key, limit in lim.items()
           if not res[key] <= limit]
    if bad:
        raise AssertionError(f"{kind} card vs CPU: " + ", ".join(bad))
    if not repeat:
        raise AssertionError(f"{kind}: the repeated step differs")
    return res


def _logged_values(trainer, tag: str) -> list:
    """The values a trainer logged under ``tag``, in step order."""
    with open(trainer.logger.jsonl_path) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in sorted(rows, key=lambda r: r["step"])
            if r["tag"] == tag]


def _voc_summary(kind: str, recs: list, logged: list, params: dict) -> dict:
    import statistics

    import torch

    warm = [r["s"] for r in recs[1:]]
    res = {"steps": len(recs), "step_s_first": recs[0]["s"],
           "step_s_warm_median": statistics.median(warm),
           "step_s_warm_range": [min(warm), max(warm)],
           "samples_per_s": recs[0]["samples"] / statistics.median(warm),
           "peak_above_bytes": max(r["peak_above_bytes"] for r in recs),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    k = max(len(logged) // 10, 1)
    res["loss_first"] = sum(logged[:k]) / k
    res["loss_last"] = sum(logged[-k:]) / k
    print(f"  {kind}: {len(recs)} steps of {recs[0]['samples']} samples "
          f"(batch {params['batch_size']}); step wall s first "
          f"{recs[0]['s']:.3f}, warm median {res['step_s_warm_median']:.4f} "
          f"[{min(warm):.4f}-{max(warm):.4f}], {res['samples_per_s']:.0f} "
          f"samples/s; peak device memory of a step "
          f"{res['peak_above_bytes'] / 2**30:.2f} GiB above what was held; "
          f"logged loss, mean of the first {k} {res['loss_first']:.4f}, of "
          f"the last {k} {res['loss_last']:.4f}; {_gpu_line()}")
    if not all(map(math.isfinite, logged)) or not (
            res["loss_last"] < res["loss_first"]):
        raise AssertionError(f"{kind}: the logged loss did not fall")
    return res


def _serving_tts(device):
    """The shipped Tacotron at full width with seeded random weights and
    the decoder kernel, every decode its 500 steps (the gate bias at
    -1e4)."""
    import torch

    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS, AdaptiveTTS

    mp = dict(SHIPPED_MODEL, decoder_no_early_stopping=True,
              n_mel_channels=SHIPPED_AUDIO["n_mels"], n_symbols=N_SYMBOLS)
    model = Tacotron2NV(config_from_params(mp),
                        generator=torch.Generator().manual_seed(0))
    tts = AdaptiveTTS({"model": mp, "audio_params": dict(SHIPPED_AUDIO),
                       "decode_backend": "cuda"}, model, device=device)
    with torch.no_grad():       # random weights fire the gate at once
        tts.model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    return tts


# K3 on trained weights.  The bf16 sample loop rounds every product's
# input to bf16, so two loops that sum in other orders round some input
# the other way now and then (2^-8 of its size).  On random weights that
# moved the samples by less than GEN_FLIP (phase 8); on the weights phase
# 14 trains it moves them by about GEN_FLIP, and at a near tie it changes
# the mixture's choice, after which the loop follows its own samples.
# In the first run that read it (NVIDIA H100 80GB HBM3, 700 W) phase 8's
# judgement (the share of samples beyond GEN_FLIP <= GEN_BF16_SHARE)
# failed: the kernel against the plain loop 1.21e-1, the plain loop on
# the card against the same loop on the CPU 1.20e-1, 43 of 44 rows
# parting a median 26 and 30 steps in, after which nothing can be
# compared.  So the kernel is also run on noise whose mixture choice the
# noise alone decides (GEN_FORCE added to the gumbel draw's own winner,
# far beyond any difference of the mixture logits), where the loops
# cannot part at a tie, and in bf16 held there step by step over all
# 3,850 steps within GEN_BF16_ATOL, phase 8's per-step bf16 limit: a
# second run read max|d| 4.6e-3 there (and still a share of 1.19e-1
# beyond GEN_FLIP).  Phase 8's judgement is printed on both noises, beside
# the plain bf16 loop on the CPU against the plain loop on the card.
GEN_FORCE = 1e3
# Phase 8's share judgement cannot hold bf16 on trained weights: the JAX
# package's own bf16 sample loop departs from its f32 loop by a share of
# 0.50 of the samples beyond GEN_FLIP on a WaveRNN the port trained for
# 100 steps at the served width (tools/settle_gen_bf16.py, on the CPU;
# the port's plain bf16 loop from the JAX package's bf16 loop 0.14, the
# card's kernel from the card's plain loop 0.12).  So bf16 is held in
# distribution: the MCD between the log-mels of the kernel's bf16 and f32
# vocodings of the same noise must stay below GEN_BF16_MCD_SHARE times the
# MCD between two f32 vocodings of different noise (read on the CPU, the
# JAX package's loops: 0.58 against 21.7, a share of 0.027).
GEN_BF16_MCD_SHARE = 0.1


def _departure(a, b) -> dict:
    """Samples of ``a`` and ``b`` (rows, T) further apart than GEN_FLIP:
    their share, the rows that ever are, the median step of a row's
    first; and max|d| over the run."""
    import statistics

    d = (a - b).abs()
    over = d > GEN_FLIP
    rows = over.any(dim=1)
    firsts = [int(over[r].float().argmax()) for r in range(over.shape[0])
              if rows[r]]
    return {"share": float(over.float().mean()), "rows": int(rows.sum()),
            "first_median": statistics.median(firsts) if firsts else None,
            "max_abs": float(d.max())}


def _trained_wavernn_vs_plain(model, cfg, mels, device) -> dict:
    """K3 on the trained weights against the plain loop: a 544-frame mel
    of the corpus folds to 44 rows of 3,850 samples (target 2,750, overlap
    550), the same noise through twins with ``gen_backend`` cuda and
    torch, in f32 and bf16, on the sampled noise and on the noise with
    the mixture choice forced (above).  f32 is judged as in phase 8 on
    both; bf16 is held within GEN_BF16_ATOL on the forced noise and by
    the MCD of its vocoding against the f32 one (GEN_BF16_MCD_SHARE),
    and phase 8's share judgement printed beside the plain bf16 loop on
    the CPU."""
    import copy

    import torch

    from msa_tts_tpu_torch.vocoders.wavernn import WaveRNN, generation_noise

    target, overlap = 2_750, 550
    noise = generation_noise(cfg, torch.Generator().manual_seed(21),
                             target + 2 * overlap, GEN_B, device=device)
    n1 = noise[0]
    noises = {"sampled": noise, "forced": (
        n1 + GEN_FORCE * torch.nn.functional.one_hot(
            n1.argmax(-1), n1.shape[-1]).to(n1.dtype), noise[1])}
    label = f"trained WaveRNN, {GEN_B} rows"
    res, out = {}, {}
    for gen_dtype, tag in (("float32", "f32"), ("bfloat16", "bf16")):
        kern_v, plain_v = (WaveRNN(model, cfg, gen_dtype=gen_dtype,
                                   gen_backend=b, device=device)
                           for b in ("cuda", "torch"))
        padded, _ = kern_v._pad_batch([mels])
        for name, nz in noises.items():
            (kern, nf), (plain, _) = (v._run_folded(padded, target,
                                                    overlap, [nz])
                                      for v in (kern_v, plain_v))
            if kern.shape[1] != GEN_B:
                raise AssertionError(f"{kern.shape[1]} fold rows, want "
                                     f"{GEN_B}")
            out[tag, name] = [x.flatten(0, 1).cpu() for x in (kern, plain)]
        if tag == "f32":
            # the same vocoding on noise of another seed: how far two
            # draws of the sampler are apart (the bf16 check's scale)
            other = generation_noise(cfg, torch.Generator().manual_seed(22),
                                     target + 2 * overlap, GEN_B,
                                     device=device)
            out["f32", "other"] = [kern_v._run_folded(
                padded, target, overlap, [other])[0].flatten(0, 1).cpu()]
    for name in noises:
        res[f"max_abs_err_f32_{name}"] = _judge_gen(
            *out["f32", name], cfg.mode, "f32",
            f"{label}, f32, {name} noise, kernel vs plain loop")
    # bf16: the plain bf16 loop on the CPU (the same weights, inputs and
    # noise, other summation orders) beside the kernel
    cpu_v = WaveRNN(copy.deepcopy(model).cpu(), cfg, gen_dtype="bfloat16",
                    gen_backend="torch", device="cpu")
    padded, _ = cpu_v._pad_batch([mels.cpu()])
    dep, t0 = {}, time.perf_counter()
    for name, nz in noises.items():
        plain_cpu, _ = cpu_v._run_folded(padded, target, overlap,
                                         [tuple(n.cpu() for n in nz)])
        kern, plain = out["bf16", name]
        if not torch.isfinite(kern).all() or kern.abs().max() > 1.0:
            raise AssertionError(f"{label}, bf16: samples not finite or "
                                 "outside [-1, 1]")
        dep[name] = {"kernel_vs_plain": _departure(kern, plain),
                     "plain_vs_plain_cpu": _departure(
                         plain, plain_cpu.flatten(0, 1))}
        for pair, v in dep[name].items():
            print(f"  {label}, bf16, {name} noise, "
                  f"{pair.replace('_', ' ')}: max|d| {v['max_abs']:.3e}, "
                  f"share of samples beyond {GEN_FLIP} {v['share']:.3e} "
                  f"(phase 8's judgement, share <= {GEN_BF16_SHARE}, not "
                  f"held: {'passes' if v['share'] <= GEN_BF16_SHARE else 'fails'}"
                  f"), rows ever beyond {v['rows']}/{GEN_B}, median first "
                  f"step {v['first_median']}")
    print(f"  (the CPU's plain bf16 loops took "
          f"{time.perf_counter() - t0:.1f} s)")
    res["bf16_departures"] = dep
    res["max_abs_err_bf16_forced"] = dep["forced"]["kernel_vs_plain"][
        "max_abs"]
    if not res["max_abs_err_bf16_forced"] <= GEN_BF16_ATOL:
        raise AssertionError(f"{label}, bf16, forced noise: max|d| "
                             f"{res['max_abs_err_bf16_forced']} > "
                             f"{GEN_BF16_ATOL}")
    # bf16 held in distribution: the kernel's bf16 vocoding against its
    # f32 vocoding of the same noise, by the MCD of their log-mels, a
    # small share of the MCD between two f32 vocodings of other noise
    waves = {k: _gen_wave(out[k][0], nf, target, overlap, mels.shape[-1],
                          cfg.hop_length)
             for k in (("bf16", "sampled"), ("f32", "sampled"),
                       ("f32", "other"))}
    mcd = {"bf16_vs_f32": _wave_mcd(waves["bf16", "sampled"],
                                    waves["f32", "sampled"]),
           "f32_vs_f32_other_noise": _wave_mcd(waves["f32", "sampled"],
                                               waves["f32", "other"])}
    res["bf16_mcd"] = mcd
    lim = GEN_BF16_MCD_SHARE * mcd["f32_vs_f32_other_noise"]
    print(f"  {label}, bf16 vs f32 (kernel, sampled noise): MCD "
          f"{mcd['bf16_vs_f32']:.4f} (limit {GEN_BF16_MCD_SHARE} x the MCD "
          f"of two f32 vocodings of other noise, "
          f"{mcd['f32_vs_f32_other_noise']:.4f}: {lim:.4f})")
    if not mcd["bf16_vs_f32"] <= lim:
        raise AssertionError(f"{label}: bf16 vocoding MCD "
                             f"{mcd['bf16_vs_f32']} > {lim}")
    return res


def _gen_wave(samples, n_folds: int, target: int, overlap: int,
              n_frames: int, hop: int):
    """Folded samples (rows, L) → the utterance's waveform (numpy)."""
    import numpy as np

    from msa_tts_tpu_torch.vocoders.wavernn import xfade_and_unfold

    return xfade_and_unfold(samples[:n_folds].numpy().astype(np.float64),
                            target, overlap)[:(n_frames - 1) * hop]


def _wave_mcd(a, b) -> float:
    """``ops/metrics.mcd_batch`` between the log-mels of two waveforms."""
    import numpy as np

    from msa_tts_tpu_torch.ops.audio import melspec_ap
    from msa_tts_tpu_torch.ops.metrics import mcd_batch

    ma = melspec_ap(a.astype(np.float32), SHIPPED_AUDIO).T[None]
    mb = melspec_ap(b.astype(np.float32), SHIPPED_AUDIO).T[None]
    return mcd_batch(ma, mb, np.asarray([ma.shape[1]]))


def vocoder_phase(device) -> dict:
    """Phase 14: the host feature library built and held to the numpy
    path; the WaveRNN and HiFi-GAN trainers at the served widths through
    their entry points (``main``) on a synthetic corpus: step times,
    samples per second, peak device memory, the logged losses falling;
    one step of each on the card against the CPU and repeated bit for
    bit; K3 on the trained WaveRNN against the plain loop in f32 and
    bf16; and each trained vocoder serving a request (K3's launches
    there counted, the count set to 0 just before)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from msa_tts_tpu_torch import native as NF
    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
    from msa_tts_tpu_torch.ops import audio as A
    from msa_tts_tpu_torch.utils.checkpoint import load_checkpoint
    from msa_tts_tpu_torch.utils.convert import (
        tree_to_state_dict,
        wavernn_state_dict_from_jax,
    )
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders.hifigan import Generator, HiFiGAN
    from msa_tts_tpu_torch.vocoders.wavernn import (
        WaveRNN,
        WaveRNNModel,
        config_from_params,
    )

    res = {}
    torch.zeros(1, device=device)       # the allocator, for its statistics
    tmp = tempfile.mkdtemp(prefix="chip_smoke_voc_")
    try:
        corpus = f"{tmp}/corpus"
        make_synthetic_corpus(corpus, n_speakers=4,
                              utterances_per_speaker=12, seed=0,
                              spk_emb_dim=SHIPPED_MODEL[
                                  "speaker_embedding_dim"])
        print("  reduced: " + json.dumps(VOC_REDUCED))

        # ---- the host feature library
        t0 = time.perf_counter()
        if not NF.native_available():
            raise AssertionError("the host feature library did not build")
        res["feats_build_s"] = NF.build_seconds
        print(f"  feature library {NF.library_path().name}: built in "
              f"{NF.build_seconds:.1f} s (loaded in "
              f"{time.perf_counter() - t0:.1f} s)")
        # tests/test_native_feats.py's mel check: seeded noise of 0.4, 1.0
        # and 2.3 s through both frontends (the corpus is held below, as
        # that file's dataset check holds it)
        rng = np.random.default_rng(0)
        wavs = [rng.standard_normal(int(22050 * d)).astype(np.float32) * 0.3
                for d in (0.4, 1.0, 2.3)]
        lib = {"ap": NF.extract_logmels_batch(wavs, "ap", SHIPPED_AUDIO),
               "ap2": NF.extract_logmels_batch(wavs, "ap2", VOC_AP2)}
        ref = {"ap": [A.melspec_ap(w, SHIPPED_AUDIO) for w in wavs],
               "ap2": [A.melspec_ap2(w[None], VOC_AP2)[0] for w in wavs]}
        err = max(float(np.abs(m - r).max()) for k in lib
                  for m, r in zip(lib[k][0], ref[k]))
        res["feats_mel_max_abs"] = err
        print(f"  seeded noise, both frontends: library vs numpy max|d| "
              f"{err:.2e} (limit {FEATS_MEL_ATOL})")
        if not err <= FEATS_MEL_ATOL:
            raise AssertionError(f"library features off by {err}")

        # ---- WaveRNN
        calls = NF.CALLS
        wp = _voc_params("wavernn", corpus, f"{tmp}/out")
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        wt, recs = _run_vocoder_trainer("wavernn", wp, f"{tmp}/wavernn")
        res["wavernn_run_s"] = time.perf_counter() - t0
        if NF.CALLS == calls:
            raise AssertionError("the trainer's dataset did not use the "
                                 "feature library")
        from msa_tts_tpu_torch.dataloaders.dataset import TTSDataset
        from msa_tts_tpu_torch.dataloaders.metafile import (
            parse_metafile,
            split_speakers,
        )

        splits, _ = split_speakers(parse_metafile(
            f"{corpus}/metadata.csv"), list(MAML_SPEAKERS), seed=0)
        t0 = time.perf_counter()
        np_ds = TTSDataset(splits, "train", dataset_path=corpus,
                           audio_params=SHIPPED_AUDIO,
                           use_native_feats=False)
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        TTSDataset(splits, "train", dataset_path=corpus,
                   audio_params=SHIPPED_AUDIO)
        t_lib = time.perf_counter() - t0
        err = max(float(np.abs(a.mel - b.mel).max())
                  for a, b in zip(wt.dataset.items, np_ds.items))
        res["feats_dataset_max_abs"] = err
        res["feats_dataset_s"] = {"library": t_lib, "numpy": t_np}
        print(f"  the trainer's dataset (library) vs numpy: "
              f"{len(np_ds)} items, max|d| {err:.2e} (limit "
              f"{FEATS_DATASET_ATOL}); a split's dataset built in "
              f"{t_lib:.3f} s with the library, {t_np:.3f} s with numpy")
        if not err <= FEATS_DATASET_ATOL:
            raise AssertionError(f"dataset features off by {err}")
        logged = _logged_values(wt, "train/nll")
        res["wavernn"] = _voc_summary("wavernn", recs, logged, wp)
        ckpt = f"{wt.path_manager.checkpoints_path}/wavernn_" \
               f"{VOC_WAVERNN_STEPS}.ckpt"
        res["wavernn_card_vs_cpu"] = _voc_card_vs_cpu("wavernn", wp, ckpt,
                                                      tmp)

        # ---- K3 on the trained weights
        raw = load_checkpoint(ckpt)
        cfg = config_from_params(**wp)
        model = WaveRNNModel(cfg)
        model.load_state_dict(wavernn_state_dict_from_jax(
            raw["params"], raw["model_state"], cfg), strict=True)
        frames = np.concatenate([it.mel for it in wt.dataset.items], 1)
        mels = torch.from_numpy(frames[:, :544].copy()).to(device)
        res.update(_trained_wavernn_vs_plain(model, cfg, mels, device))

        # ---- HiFi-GAN
        hp = _voc_params("hifigan", corpus, f"{tmp}/out")
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        ht, recs = _run_vocoder_trainer("hifigan", hp, f"{tmp}/hifigan")
        res["hifigan_run_s"] = time.perf_counter() - t0
        logged = _logged_values(ht, "train/loss_mel")
        res["hifigan"] = _voc_summary("hifigan", recs, logged, hp)
        hckpt = f"{ht.path_manager.checkpoints_path}/hifigan_" \
                f"{VOC_HIFIGAN_STEPS}.ckpt"
        res["hifigan_card_vs_cpu"] = _voc_card_vs_cpu("hifigan", hp, hckpt,
                                                      tmp)

        KEPT["wavernn_params"] = wp
        KEPT["wavernn_sd"] = {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()}

        # ---- the trained vocoders served: K3's launches counted
        tts = _serving_tts(device)
        tts.attach_vocoder("wavernn", WaveRNN(model, cfg, gen_backend="cuda",
                                              device=device))
        gen = Generator(HIFIGAN_V1, VOC_AP2["n_mels"])
        gen.load_state_dict(tree_to_state_dict(
            load_checkpoint(hckpt)["generator"]), strict=True)
        KEPT["hifigan_sd"] = {k: v.detach().cpu().clone()
                              for k, v in gen.state_dict().items()}
        tts.attach_vocoder("hifigan", HiFiGAN.from_params(gen, HIFIGAN_V1))
        emb = np.random.default_rng(0).standard_normal(
            tts.cfg.speaker_embedding_dim).astype(np.float32)
        n_frames = tts.cfg.max_decoder_steps * tts.cfg.n_frames_per_step
        hop = SHIPPED_AUDIO["hop_length"]
        torch.cuda.synchronize()
        G.GEN_LAUNCHES = 0
        served = {name: tts.synthesize(TEXTS[0], spk_emb=emb, seed=0,
                                       vocoder=name)
                  for name in ("wavernn", "hifigan")}
        torch.cuda.synchronize()
        res["launches"] = G.GEN_LAUNCHES
        for name, w in served.items():
            want = (n_frames - (name == "wavernn")) * hop
            print(f"  the trained {name} served one request: {len(w)} "
                  f"samples (want {want}), max |sample| "
                  f"{float(np.abs(w).max()):.3f}")
            if (w.shape != (want,) or not np.isfinite(w).all()
                    or np.abs(w).max() > 1.0 or not np.abs(w).max() > 0):
                raise AssertionError(f"trained {name}: bad waveform")
        print(f"  sample-loop launches on the served path: {res['launches']}")
        if res["launches"] != 1:
            raise AssertionError(f"{res['launches']} sample-loop launches "
                                 "for one WaveRNN request")
        if not os.path.exists(ckpt):
            raise AssertionError(ckpt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ---------------------------------------------------------------- phase 15
# The inference CLIs at the shipped width.  Phases 12-14 keep what they
# trained in KEPT (the MAML checkpoint, the EWC stream's checkpoints, the
# WaveRNN and HiFi-GAN generator weights); phase 15 serves those, or, when
# a phase did not run (``--only 15``), seeded weights of the same shapes.
# Each Tacotron checkpoint is served with its gate bias at -1e4 (a few
# training steps do not teach the gate), so every decode runs its 500
# steps and the stop steps of kernel and plain decode are compared over
# the whole run.
KEPT: dict = {}
CLI_REDUCED = {
    "dataset_metatest": "phase 12's synthetic corpus (4 speakers x 12 "
                        "clips of 0.4-1.2 s, seed 0), 2 of its speakers",
    "decoder gate bias": "-1e4 in the served checkpoints (every decode "
                         "runs its 500 steps)",
    "checkpoints": "phase 12's MAML checkpoint, phase 13's EWC stream of 3 "
                   "speakers, phase 14's WaveRNN and HiFi-GAN v1 (seeded "
                   "weights of the same shapes when a phase did not run)",
    "plot_inference": "false (no matplotlib on the GPU host)",
}


def _kept_dir() -> str:
    """The directory that holds KEPT's files until the script ends."""
    import tempfile

    if "dir" not in KEPT:
        KEPT["dir"] = tempfile.mkdtemp(prefix="chip_smoke_kept_")
    return KEPT["dir"]


def _write_tacotron_ckpt(sd: dict, cfg, path: str) -> None:
    """``sd`` (a Tacotron state_dict) as a ``.ckpt`` with the gate bias at
    -1e4."""
    from msa_tts_tpu_torch.utils.checkpoint import save_checkpoint
    from msa_tts_tpu_torch.utils.convert import jax_from_state_dict

    sd = dict(sd)
    key = "decoder.gate_layer.linear_layer.bias"
    sd[key] = sd[key].detach().clone().fill_(-1e4)
    params, state = jax_from_state_dict(sd, cfg)
    save_checkpoint(path, {"params": params, "model_state": state})


def _cli_model_sd(cfg, path: str | None, seed: int) -> dict:
    """The state_dict of the checkpoint at ``path``, or seeded weights."""
    import torch

    from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV
    from msa_tts_tpu_torch.utils.checkpoint import load_model_checkpoint

    if path:
        return load_model_checkpoint(path, cfg)[0]
    return Tacotron2NV(cfg, generator=torch.Generator().manual_seed(
        seed)).state_dict()


def _cli_vocoders(corpus: str, out: str) -> dict:
    """The vocoder files the CLIs load: WaveRNN's params.yml and
    ``state_dict`` (served width), HiFi-GAN v1's config and generator."""
    import os

    import torch

    from msa_tts_tpu_torch.config import save_params
    from msa_tts_tpu_torch.vocoders.hifigan import Generator
    from msa_tts_tpu_torch.vocoders.wavernn import (
        WaveRNNModel,
        config_from_params,
    )

    os.makedirs(out, exist_ok=True)
    wp = dict(KEPT.get("wavernn_params")
              or _voc_params("wavernn", corpus, out))
    wsd = KEPT.get("wavernn_sd")
    if wsd is None:
        wsd = WaveRNNModel(config_from_params(**wp),
                           torch.Generator().manual_seed(0)).state_dict()
    torch.save(wsd, f"{out}/wavernn.pt")
    save_params(dict(wp, checkpoint_path=f"{out}/wavernn.pt",
                     target=2_750, overlap=550, gen_backend="cuda"),
                f"{out}/wavernn.yml")
    hsd = KEPT.get("hifigan_sd")
    if hsd is None:
        hsd = Generator(HIFIGAN_V1, SHIPPED_AUDIO["n_mels"],
                        torch.Generator().manual_seed(2)).state_dict()
    torch.save({"generator": hsd}, f"{out}/hifigan.pt")
    with open(f"{out}/hifigan.json", "w") as f:
        json.dump(HIFIGAN_V1, f)
    return {"wavernn": {"vocoder_params_path": f"{out}/wavernn.yml"},
            "hifigan": {"vocoder_params_path": f"{out}/hifigan.json",
                        "vocoder_ckpt_path": f"{out}/hifigan.pt"},
            "griffinlim": {}}


def _checked_save_wav(mod, seen: list, bounded: bool):
    """Swap ``mod.save_wav`` for one that checks each waveform before
    writing it: finite, not silent, and with ``bounded`` (WaveRNN,
    HiFi-GAN) inside [-1, 1] (Griffin-Lim's is not bounded: ``save_wav``
    scales a waveform that would clip); returns the original."""
    import numpy as np

    orig = mod.save_wav

    def save_wav(path, wav, sr):
        w = np.asarray(wav)
        peak = float(np.abs(w).max())
        if (not np.isfinite(w).all() or not peak > 0
                or (bounded and peak > 1.0)):
            raise AssertionError(f"{path}: samples not finite, silent or "
                                 f"outside [-1, 1] (max|x| {peak})")
        seen.append((path, w.shape, peak))
        return orig(path, wav, sr)

    mod.save_wav = save_wav
    return orig


def _plain_vs_cli(cfg, sd: dict, inputs, in_len, spk, masks, device,
                  mel_cli, len_cli, label: str) -> float:
    """The plain decode (``decode_backend: torch``) of the weights ``sd``
    on the same inputs and prenet masks, held against the CLI's mels
    (each row cut at its length) at phase 3's limit, lengths equal."""
    import torch

    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        tacotron2nv_infer,
    )

    model = Tacotron2NV(cfg)
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval()
    with torch.no_grad():
        mel, mel_len, _ = tacotron2nv_infer(
            model, cfg, inputs, in_len, spk, masks, decode_backend="torch")
    mel_len = mel_len.cpu().numpy()
    r = cfg.n_frames_per_step
    err = 0.0
    for i in range(len(mel_len)):
        steps = max(int(mel_len[i]), 1)
        ref = mel[i, :, :steps * r].float().cpu().numpy()
        got = mel_cli[i]
        if steps != max(int(len_cli[i]), 1) or got.shape != ref.shape:
            raise AssertionError(f"{label}, row {i}: stop step "
                                 f"{int(len_cli[i])} against the plain "
                                 f"decode's {steps}")
        err = max(err, float(abs(got - ref).max()))
    print(f"  {label}: kernel vs plain decode, {len(mel_len)} rows, stop "
          f"steps {sorted(set(int(x) for x in mel_len))} equal, mel max|d| "
          f"{err:.3e} (limit {SERVE_ATOL})")
    if not err <= SERVE_ATOL:
        raise AssertionError(f"{label}: the CLI's mel differs from the "
                             "plain decode")
    return err


def _run_infer(run_dir: str, cmd: dict, device):
    """``infer.main`` on ``run_dir`` with ``cmd``; returns the Inference,
    each speaker's ``(adapted state_dict, mel, length)`` and the launches
    of both kernels (the counts set to 0 just before)."""
    import torch

    from msa_tts_tpu_torch import infer as TI
    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.vocoders import cuda_gen as G

    seen, wavs = [], []

    class Kept(TI.Inference):
        def generate_melspec(self, adapted, ms, speaker):
            mel, attn = super().generate_melspec(adapted, ms, speaker)
            seen.append((speaker, {k: v.detach().clone()
                                   for k, v in {**adapted, **ms}.items()},
                         mel, attn.shape[0]))
            return mel, attn

    orig, TI.Inference = TI.Inference, Kept
    orig_save = _checked_save_wav(TI, wavs, cmd["vocoder"] != "griffinlim")
    try:
        torch.cuda.synchronize(device)
        CD.LAUNCHES = G.GEN_LAUNCHES = 0
        inf = TI.main(dict(cmd, params_path=run_dir))
        torch.cuda.synchronize(device)
        launches = {"decoder_loop": CD.LAUNCHES,
                    "wavernn_loop": G.GEN_LAUNCHES}
    finally:
        TI.Inference, TI.save_wav = orig, orig_save
    if len(wavs) != len(seen):
        raise AssertionError("infer: a speaker's wav was not written")
    print(f"  {cmd['vocoder']}: {len(wavs)} wavs, max|sample| "
          + ", ".join(f"{w[2]:.3f}" for w in wavs))
    return inf, seen, launches


def cli_phase(device) -> dict:
    """Phase 15: the inference CLIs at the shipped width through their
    entry points.  ``infer.main``: 2 speakers of phase 12's corpus
    adapted (n_inner_test 5) from the MAML checkpoint and one sentence
    synthesized through the decoder kernel, vocoded once with each
    vocoder (Griffin-Lim, WaveRNN at the served width through the
    sample-loop kernel, HiFi-GAN v1); each speaker's mel held against the
    plain decode of its adapted weights and masks.
    ``infer_cumulative.main``: the EWC stream's ``best_{i}_{speaker}``
    checkpoints, 4 sentences a batch through the decoder kernel at B = 4
    and WaveRNN's ``generate_batch`` through the sample-loop kernel;
    every wav checked, the first batch held against the plain decode.
    Both kernels' launches counted on each CLI's path, and each
    speaker's wall seconds of adaptation, decoding and vocoding
    printed."""
    import os
    import random
    import shutil
    import tempfile

    import torch

    from msa_tts_tpu_torch import infer_cumulative as TIC
    from msa_tts_tpu_torch.config import load_params, save_params
    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
    from msa_tts_tpu_torch.models.tacotron2nv import config_from_params
    from msa_tts_tpu_torch.serving import N_SYMBOLS

    res = {"infer": {}, "launches": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        corpus = f"{tmp}/corpus"
        make_synthetic_corpus(corpus, n_speakers=4,
                              utterances_per_speaker=12, seed=0,
                              spk_emb_dim=SHIPPED_MODEL[
                                  "speaker_embedding_dim"])
        print("  reduced: " + json.dumps(CLI_REDUCED))
        voc = _cli_vocoders(corpus, f"{tmp}/vocoders")

        # ---- infer.main: the MAML experiment
        p = maml_params(corpus, f"{tmp}/out", experiment_name="cli",
                        plot_inference=False)
        run_dir = f"{tmp}/out/maml/cli"
        os.makedirs(f"{run_dir}/checkpoints")
        save_params(p, f"{run_dir}/params.yml")
        cfg = config_from_params(dict(
            p["model"], n_mel_channels=p["audio_params"]["n_mels"],
            n_symbols=N_SYMBOLS, num_speakers=1))
        src = KEPT.get("maml_ckpt")
        print(f"  infer: checkpoint {'of phase 12' if src else 'seeded'}")
        _write_tacotron_ckpt(_cli_model_sd(cfg, src, 0), cfg,
                             f"{run_dir}/checkpoints/checkpoint_0.ckpt")
        cmd = {"checkpoint_id": 0, "speaker": "spk00,spk01",
               "n_inner_test": 5, "input_text": TEXTS[0],
               "spk_emb_path": f"{corpus}/spk_emb.pkl",
               "decode_backend": "cuda", "infer_seed": 3}
        total = {"decoder_loop": 0, "wavernn_loop": 0}
        for name in ("griffinlim", "wavernn", "hifigan"):
            t0 = time.perf_counter()
            inf, seen, n = _run_infer(run_dir, dict(cmd, vocoder=name,
                                                    **voc[name]), device)
            wall = time.perf_counter() - t0
            for k in total:
                total[k] += n[k]
            res["infer"][name] = {"wall_s": wall, "launches": n,
                                  "timings": inf.timings}
            print(f"  infer.main, vocoder {name}: {wall:.1f} s, decoder "
                  f"kernel {n['decoder_loop']} launches, sample-loop kernel"
                  f" {n['wavernn_loop']}; per speaker, s: " + "; ".join(
                      f"{t['speaker']} adapt {t['adapt_s']:.3f} decode "
                      f"{t['decode_s']:.3f} vocode {t['vocode_s']:.3f}"
                      for t in inf.timings) + f"; {_gpu_line()}")
            if (n["decoder_loop"] != 2
                    or n["wavernn_loop"] != (2 if name == "wavernn" else 0)
                    or len(seen) != 2):
                raise AssertionError(f"infer ({name}): launches {n}")
            if name == "griffinlim":
                # not counted: each speaker against the plain decode
                seq, _ = inf.g2p.convert(inp=TEXTS[0],
                                         convert_mode="text_to_phone_to_idx")
                res["infer"]["mel_max_abs_err"] = max(
                    _plain_vs_cli(
                        inf.cfg, sd,
                        torch.tensor([seq], device=device),
                        torch.tensor([len(seq)], device=device),
                        torch.as_tensor(inf._speaker_vec(spk)[None],
                                        device=device),
                        inf._prenet_masks(1), device, [mel], [n_steps],
                        f"infer, {spk}")
                    for spk, sd, mel, n_steps in seen)
        res["launches"]["infer"] = total

        # ---- infer_cumulative.main: the EWC stream
        stream = KEPT.get("stream")
        if stream:
            sp = load_params(f"{stream}/params.yml")
            ckpts = {f: f"{stream}/checkpoints/{f}"
                     for f in os.listdir(f"{stream}/checkpoints")
                     if f.startswith("best_")}
        else:
            sp = example_params("continual_ewc", corpus, f"{tmp}/x",
                                MAML_SPEAKERS[:2])
            order = list(sp["dataset_train"]["speakers_list"])
            random.Random(sp.get("speaker_seed", 0)).shuffle(order)
            ckpts = {f"best_{i}_{s}.ckpt": None for i, s in enumerate(order)}
        print(f"  infer_cumulative: {len(ckpts)} checkpoints "
              f"{'of phase 13' if stream else 'seeded'}")
        sp.update(output_path=f"{tmp}/stream", experiment_name="cli")
        sdir = f"{tmp}/stream/{sp['method']}/cli"
        os.makedirs(f"{sdir}/checkpoints")
        save_params(sp, f"{sdir}/params.yml")
        scfg = config_from_params(dict(
            sp["model"], n_mel_channels=sp["audio_params"]["n_mels"],
            n_symbols=N_SYMBOLS, num_speakers=1))
        for i, (name, path) in enumerate(sorted(ckpts.items())):
            _write_tacotron_ckpt(_cli_model_sd(scfg, path, 10 + i), scfg,
                                 f"{sdir}/checkpoints/{name}")
        with open(f"{tmp}/sents.txt", "w") as f:
            f.write("\n".join(TEXTS) + "\n")
        batches, wavs = [], []

        class Kept(TIC.InferCumulative):
            def _infer_batch(self, inputs, in_lens, spk):
                mel, mel_len = super()._infer_batch(inputs, in_lens, spk)
                if not batches:
                    batches.append((inputs, in_lens, spk, mel, mel_len,
                                    {k: v.detach().clone() for k, v in
                                     self.model.state_dict().items()},
                                    self._prenet_masks(len(inputs))))
                else:
                    batches.append(None)
                return mel, mel_len

        orig, TIC.InferCumulative = TIC.InferCumulative, Kept
        orig_save = _checked_save_wav(TIC, wavs, True)
        from msa_tts_tpu_torch.models import cuda_decoder as CD
        from msa_tts_tpu_torch.vocoders import cuda_gen as G

        try:
            torch.cuda.synchronize(device)
            CD.LAUNCHES = G.GEN_LAUNCHES = 0
            t0 = time.perf_counter()
            ic = TIC.main({"params_path": sdir,
                           "input_text_file": f"{tmp}/sents.txt",
                           "spk_emb_path": f"{corpus}/spk_emb.pkl",
                           "vocoder": "wavernn", "decode_backend": "cuda",
                           "checkpoint_id": "all",
                           **voc["wavernn"]})
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            n = {"decoder_loop": CD.LAUNCHES,
                 "wavernn_loop": G.GEN_LAUNCHES}
        finally:
            TIC.InferCumulative, TIC.save_wav = orig, orig_save
        res["launches"]["infer_cumulative"] = n
        n_b = len(batches)
        res["infer_cumulative"] = {"wall_s": wall, "batches": n_b,
                                   "timings": ic.timings}
        print(f"  infer_cumulative.main: {wall:.1f} s, {n_b} batches of "
              f"{len(TEXTS)} sentences, {len(wavs)} wavs (max|sample| "
              f"{max(w[2] for w in wavs):.3f}); decoder kernel "
              f"{n['decoder_loop']} launches, sample-loop kernel "
              f"{n['wavernn_loop']}; per (checkpoint, speaker), s: "
              + "; ".join(f"{t['step']}/{t['speaker']} decode "
                          f"{t['decode_s']:.3f} vocode {t['vocode_s']:.3f}"
                          for t in ic.timings) + f"; {_gpu_line()}")
        n_targets = sum(range(1, len(ckpts) + 1))
        if (n_b != n_targets or n["decoder_loop"] != n_b
                or n["wavernn_loop"] != n_b
                or len(wavs) != n_b * len(TEXTS)):
            raise AssertionError(f"infer_cumulative: {n_b} batches, "
                                 f"launches {n}, {len(wavs)} wavs")
        inputs, in_lens, spk, mel, mel_len, sd, masks = batches[0]
        if inputs.shape[1] % 16:
            raise AssertionError("infer_cumulative: T_in not a multiple "
                                 "of 16")
        r = scfg.n_frames_per_step
        res["infer_cumulative"]["mel_max_abs_err"] = _plain_vs_cli(
            scfg, sd, torch.as_tensor(inputs, dtype=torch.int64,
                                      device=device),
            torch.as_tensor(in_lens, dtype=torch.int64, device=device),
            torch.as_tensor(spk.copy(), device=device), masks, device,
            [mel[i, :, :max(int(mel_len[i]), 1) * r].float().cpu().numpy()
             for i in range(len(mel_len))], mel_len,
            f"infer_cumulative, first batch (B = {len(inputs)})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ------------------------------------------------------------- phase 16
# Dp serving: each row of the sharded decode (2 shards on one card) held
# against the single-device K1 decode of the whole batch with the same
# masks: float32 within DP_SERVE_ATOL (phase 4's limit for a B = 4 row
# against its B = 1 decode); bfloat16 as _judge_dec holds the kernel
# against the plain loop (DEC_BF16_ATOL over the first CHECK_STEPS steps,
# the flip share over the run).  Stop steps equal.
DP_SERVE_ATOL = 1e-5
# Two ranks on one card over gloo against the same run at world 1: the
# JAX package's limit for a parallel run against a single-device one
# (tests/test_trainer_parallel.py), and for the batch-norm running
# statistics a relative bound (each tensor's max |d| over its largest
# value).  The resume at world 2 equals the unbroken run bit for bit.
PAR_W_ATOL = 3e-5
PAR_STAT_RTOL = 1e-4
PAR_REDUCED = {
    "corpus": "phase 12's synthetic corpus (4 speakers x 12 clips)",
    "maml": "2 meta-steps (4 tasks x 8 shots), float32, SGD outer of "
            "lr 1e-2, no meta-test; timing: the shipped settings "
            "(bfloat16, Adam) for 3 meta-steps (4 until the whole script "
            "read 1,014 s of its 1,200 with phase 17)",
    "joint": "1 epoch (2 steps: 32 and 8 rows), float32, SGD of lr "
             "1e-2, no meta-test; timing: the shipped settings for 2 "
             "epochs",
    "wavernn": "10 steps of phase 14's served width (16 rows)",
    "torchrun": "1 meta-step of the shipped MAML, no meta-test",
}
PAR_DEVICE = "cuda:0"      # both ranks' (and world 1's) device
PAR_WAIT_S = 900           # how long the ranks wait for world 1's checks
PAR_TRAINERS = {"maml": ("maml", "MAML"),
                "baseline": ("baseline", "JointTrainer"),
                "wavernn": ("wavernn_train", "WaveRNNTrainer")}


def dp_serving(device) -> dict:
    """Phase 16, part 1: ``serving.decode_sharded`` on a mesh of two
    shards of ``cuda:0`` (``make_mesh(dp=2, devices=[cuda:0, cuda:0])``)
    at the full width, B = 4 and B = 3 (a filler row), float32 and
    bfloat16, T_in 120, gate bias -1e4 (500 steps): K1 launches twice a
    call, and each row equals the single-device K1 decode of the same
    rows and masks.  ``AdaptiveTTS`` with ``parallel: {dp: 2}`` raises
    on a host with fewer cards."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
        tacotron2nv_infer,
    )
    from msa_tts_tpu_torch.parallel import make_mesh
    from msa_tts_tpu_torch.serving import (
        N_SYMBOLS,
        AdaptiveTTS,
        decode_sharded,
    )

    mp = dict(SHIPPED_MODEL, decoder_no_early_stopping=True,
              n_mel_channels=SHIPPED_AUDIO["n_mels"], n_symbols=N_SYMBOLS)
    params = {"model": mp, "audio_params": dict(SHIPPED_AUDIO),
              "decode_backend": "cuda"}
    n_cards = torch.cuda.device_count()
    try:
        AdaptiveTTS(dict(params, parallel={"dp": n_cards + 1}),
                    Tacotron2NV(config_from_params(mp)), device=device)
    except ValueError as e:
        print(f"  AdaptiveTTS parallel: {{dp: {n_cards + 1}}} on {n_cards} "
              f"card(s): {e}")
        if f"have {n_cards}" not in str(e):
            raise
    else:
        raise AssertionError("a mesh larger than the host's cards built")
    mesh = make_mesh(dp=2, task=1, devices=[device, device])
    res = {"launches": 0, "max_abs_err": 0.0}
    g = torch.Generator().manual_seed(16)
    for dtype in ("float32", "bfloat16"):
        tts = AdaptiveTTS(dict(params, infer_dtype=dtype),
                          Tacotron2NV(config_from_params(mp),
                                      generator=torch.Generator()
                                      .manual_seed(0)), device=device)
        with torch.no_grad():
            tts.model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
        cfg, dcfg = tts.cfg, tts.cfg.decoder_config()
        S, r = dcfg.max_decoder_steps, cfg.n_frames_per_step
        for B in (4, 3):
            lens = np.array([T_IN, T_IN - 23, T_IN - 10, T_IN - 56][:B]
                            + [T_IN] * (4 - B))
            inputs = np.random.default_rng(B).integers(
                1, N_SYMBOLS, (4, T_IN))
            for i in range(4):
                inputs[i, lens[i]:] = 0
            inputs[B:], lens[B:] = inputs[0], lens[0]      # filler rows
            emb = np.random.default_rng(7).standard_normal(
                (4, cfg.speaker_embedding_dim)).astype(np.float32)
            pm = CD.prenet_masks(dcfg, S, 4, g, device=device)

            def sharded():
                return decode_sharded(
                    mesh, [tts.model, tts.model], cfg, inputs, lens, emb,
                    pm, decode_backend="cuda")

            sharded()                   # the first call packs the weights
            torch.cuda.synchronize()
            CD.LAUNCHES = 0
            t0 = time.perf_counter()
            mel, mel_len = sharded()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            n = CD.LAUNCHES
            res["launches"] += n
            if n != 2:
                raise AssertionError(f"dp serving launched K1 {n} times, "
                                     "want 2")
            t0 = time.perf_counter()
            ref, ref_len, _ = tacotron2nv_infer(
                tts.model, cfg, torch.as_tensor(inputs, device=device),
                torch.as_tensor(lens, device=device),
                torch.as_tensor(emb, device=device), pm, mask_pad=True,
                decode_backend="cuda")
            torch.cuda.synchronize()
            one_ms = 1e3 * (time.perf_counter() - t0)
            if not torch.equal(mel_len.cpu(), ref_len.cpu()):
                raise AssertionError(f"stop steps {mel_len} != {ref_len}")
            d = (mel[:B] - ref[:B]).abs()
            err = float(d.max())
            line = (f"  {dtype} B={B}: 2 shards vs one decode max|d| "
                    f"{err:.3e}")
            if dtype == "float32":
                ok = err <= DP_SERVE_ATOL
                line += f" (limit {DP_SERVE_ATOL})"
            else:
                # as _judge_dec holds bf16 mels: the first steps, and the
                # share of flips over the run
                first = float(d[..., :CHECK_STEPS * r].max())
                share = float((d > DEC_BF16_FLIP["mels"]).float().mean())
                ok = (first <= DEC_BF16_ATOL["mels"]
                      and share <= DEC_BF16_SHARE)
                line += (f", first {CHECK_STEPS} steps {first:.3e} (limit "
                         f"{DEC_BF16_ATOL['mels']}), share beyond "
                         f"{DEC_BF16_FLIP['mels']} {share:.2e} (limit "
                         f"{DEC_BF16_SHARE})")
                err = first
            print(line + f", stop steps {mel_len.tolist()}, K1 launches {n},"
                  f" {ms:.1f} ms (one decode {one_ms:.1f} ms)")
            if not ok:
                raise AssertionError(f"{dtype} B={B}: dp serving rows")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res[f"ms_{dtype}_b{B}"] = ms
            res[f"one_device_ms_{dtype}_b{B}"] = one_ms
        del tts
        torch.cuda.empty_cache()
    return res


def _par_run(method: str, workdir: str, step_attr: str,
             keep_epoch1: str | None = None):
    """``trainers.<method>.main`` on ``workdir/params.yml`` (written by
    the caller) with the trainer's ``step_attr`` timed (synchronised) and
    the device's peak memory in each; ``keep_epoch1``: where rank 0
    copies the run's checkpoints once epoch 1's are written.  Returns
    ``(trainer, records)``."""
    import argparse
    import importlib
    import shutil

    import torch

    mod_name, name = PAR_TRAINERS[method]
    mod = importlib.import_module(f"msa_tts_tpu_torch.trainers.{mod_name}")
    base = getattr(mod, name)
    recs, ran = [], []

    class Timed(base):
        def run(self):
            ran.append(self)
            fn = getattr(self, step_attr)

            def timed(*a, **k):
                dev = self.device
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev)
                recs.append({"s": time.perf_counter() - t0,
                             "peak_bytes": peak,
                             "peak_above_bytes": peak - held})
                return out

            setattr(self, step_attr, timed)
            return super().run()

        def _save_epoch_state(self, epoch, extra=None):
            super()._save_epoch_state(epoch, extra)
            if keep_epoch1 and epoch == 1 and self.is_writer:
                if self._async_ckpt is not None:     # drain the writer
                    self._async_ckpt.close()
                    self._async_ckpt = None
                shutil.copytree(self.path_manager.output_path, keep_epoch1)

    setattr(mod, name, Timed)
    try:
        mod.main(argparse.Namespace(params_path=workdir))
    finally:
        setattr(mod, name, base)
    return ran[0], recs


def _par_state(t) -> dict:
    """A trainer's weights and batch-norm statistics on the host."""
    if hasattr(t, "train_state"):
        return {"w": {k: v.cpu() for k, v in t.train_state.params.items()},
                "stats": {k: v.cpu() for k, v in
                          t.train_state.model_state.items()
                          if v.is_floating_point()}}
    return {"w": {k: v.cpu() for k, v in t.model_params.items()},
            "stats": {}}


def _par_rank(rank: int, world: int, tmp: str) -> None:
    """What each of phase 16's two ranks (gloo, both on ``cuda:0``) runs:
    the gloo collectives on CUDA tensors without staging (reported), then
    every world-2 case of ``<tmp>/cases.json`` in order; each rank writes
    ``<tmp>/rank<r>.pt``."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(PAR_DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    direct = {}
    # gloo on CUDA tensors, which the port relies on for ranks that share
    # one card
    for op in ("all_reduce", "all_gather", "broadcast"):
        x = torch.full((4,), float(rank + 1), device=dev)
        try:
            if op == "all_reduce":
                dist.all_reduce(x)
                ok = x.tolist() == [3.0] * 4
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                ok = torch.cat(parts).tolist() == [1.0] * 4 + [2.0] * 4
            else:
                dist.broadcast(x, src=0)
                ok = x.tolist() == [1.0] * 4
            direct[op] = "ok" if ok else "wrong values"
        except Exception as e:
            direct[op] = f"{type(e).__name__}: {str(e)[:120]}"
    if set(direct.values()) != {"ok"}:
        raise AssertionError(f"gloo on CUDA tensors: {direct}")
    with open(os.path.join(tmp, "cases.json")) as f:
        cases = json.load(f)
    out = {"gloo_cuda_direct": direct}
    waited = False
    for name, c in cases.items():
        if c.get("timed") and not waited:
            # the timed runs wait until world 1's untimed ones are done
            waited = True
            dist.barrier()
            if rank == 0:
                open(f"{tmp}/w2_checked", "w").close()
            t0 = time.perf_counter()
            while not os.path.exists(f"{tmp}/w1_checked"):
                if time.perf_counter() - t0 > PAR_WAIT_S:
                    raise TimeoutError("world 1's checks did not end")
                time.sleep(0.2)
        if c.get("copy"):
            # a run that resumes from a copy of an earlier run's files
            if rank == 0:
                shutil.copytree(*c["copy"])
            dist.barrier()
        t, recs = _par_run(c["method"], os.path.join(tmp, name), c["step"],
                           c.get("keep_epoch1"))
        out[name] = dict(_par_state(t), recs=recs, step=t.step_global)
        del t
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _par_err(a: dict, b: dict) -> tuple:
    """``(weights max|d|, statistics max relative |d|)``."""
    w = max(float((a["w"][k] - b["w"][k]).abs().max()) for k in b["w"])
    s = max([float((a["stats"][k] - b["stats"][k]).abs().max()
                   / b["stats"][k].abs().max().clamp_min(1e-30))
             for k in b["stats"]] or [0.0])
    return w, s


def _warm(recs: list) -> dict:
    import statistics

    warm = [r["s"] for r in recs[1:]] or [recs[0]["s"]]
    return {"median_warm_s": statistics.median(warm), "n_warm": len(warm),
            "peak_gib": max(r["peak_bytes"] for r in recs) / 2 ** 30,
            "peak_above_gib":
                max(r["peak_above_bytes"] for r in recs) / 2 ** 30}


def parallel_training(device) -> dict:
    """Phase 16, parts 2 and 3: two gloo ranks sharing ``cuda:0``
    (``parallel/launch.py``) run MAML ``parallel: {task: 2}`` (float32,
    second order, SGD outer, 2 meta-steps), the joint trainer ``{dp: 2}``
    (float32, SGD, batches of 32, 2 steps) and WaveRNN ``{dp: 2}`` (10
    steps) through their entry points, held against the same runs at
    world 1 on the card; the shipped MAML and joint settings timed at
    world 2 and at world 1; a world-2 MAML run of one meta-step resumed
    at world 2 (bit for bit against the unbroken run) and at world 1;
    and ``torchrun --standalone --nproc_per_node 1`` of the MAML entry
    point on NCCL."""
    import os
    import shutil
    import tempfile

    import torch

    from msa_tts_tpu_torch.config import save_params
    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
    from msa_tts_tpu_torch.parallel.launch import spawn

    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        corpus = f"{tmp}/corpus"
        make_synthetic_corpus(corpus, n_speakers=4,
                              utterances_per_speaker=12, seed=0,
                              spk_emb_dim=SHIPPED_MODEL[
                                  "speaker_embedding_dim"])
        print("  reduced: " + json.dumps(PAR_REDUCED))
        sgd = {"optimizer_type": "SGD", "lr": 1e-2}
        no_test = dict(metatest_epoch_interval=10 ** 6, do_metatest=False)
        spk = list(MAML_SPEAKERS)
        params = {
            "maml": ("maml", maml_params(
                corpus, "", n_epochs=2, compute_dtype="float32",
                optim_outer=sgd, async_checkpoint=False, **no_test)),
            "joint": ("baseline", example_params(
                "baseline", corpus, "", spk, n_epochs=1,
                compute_dtype="float32", optim=sgd, **no_test)),
            "wavernn": ("wavernn", _voc_params("wavernn", corpus, "",
                                               n_steps=10)),
            "maml_shipped": ("maml", maml_params(corpus, "", n_epochs=3,
                                                 **no_test)),
            "joint_shipped": ("baseline", example_params(
                "baseline", corpus, "", spk, n_epochs=2, **no_test)),
        }
        step_attr = {"maml": "_maml_step", "baseline": "_train_step",
                     "wavernn": "_step"}

        def write(root: str, world: int, **extra) -> dict:
            cases = {}
            for name, (method, p) in params.items():
                d = f"{root}/{name}"
                p = dict(p, output_path=f"{d}/out", device=PAR_DEVICE,
                         **extra.get(name, {}))
                if world == 2:
                    p["parallel"] = ({"task": 2} if method == "maml"
                                     else {"dp": 2})
                os.makedirs(d, exist_ok=True)
                save_params(p, f"{d}/params.yml")
                attr = step_attr[method]
                if method == "maml" and world == 2:
                    attr = "_maml_step_sharded"
                cases[name] = {"method": method, "step": attr,
                               "timed": name.endswith("_shipped")}
            return cases

        w2 = f"{tmp}/w2"
        cases = write(w2, 2)
        # the unbroken world-2 MAML run keeps its files after step 1; a
        # copy of them resumes at world 2 (and at world 1 below)
        kept = f"{tmp}/maml_step1"
        exp = f"maml/{params['maml'][1]['experiment_name']}"
        cases["maml"]["keep_epoch1"] = kept
        d = f"{w2}/maml_resumed"
        os.makedirs(d)
        save_params(dict(params["maml"][1], output_path=f"{d}/out",
                         device=PAR_DEVICE, parallel={"task": 2},
                         resume=True), f"{d}/params.yml")
        cases["maml_resumed"] = {"method": "maml",
                                 "step": "_maml_step_sharded",
                                 "copy": [kept, f"{d}/out/{exp}"]}
        order = [n for n in cases if not cases[n].get("timed")]
        with open(f"{w2}/cases.json", "w") as f:
            json.dump({n: cases[n] for n in order
                       + [n for n in cases if n not in order]}, f)
        # world 2's and world 1's untimed runs and the torchrun run go side
        # by side; then world 2's timed runs, then world 1's, alone
        t_side = time.perf_counter()
        wait = spawn(_par_rank, 2, w2, store=f"{w2}/store", join=False)

        # NCCL at world 1 through torchrun, beside the untimed runs
        d = f"{tmp}/torchrun"
        os.makedirs(d)
        save_params(maml_params(corpus, f"{d}/out", n_epochs=1,
                                parallel={"dp": 1, "task": 1}, **no_test),
                    f"{d}/params.yml")
        here = os.path.dirname(os.path.abspath(__file__))
        t_run = time.perf_counter()
        torchrun = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "msa_tts_tpu_torch.trainers.maml",
             "--params_path", d], cwd=here, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        w1 = f"{tmp}/w1"
        write(w1, 1)
        ref = {}
        try:
            for name in ("maml", "joint", "wavernn"):
                method = params[name][0]
                t, recs = _par_run(method, f"{w1}/{name}", step_attr[method])
                ref[name] = dict(_par_state(t), step=t.step_global)
                del t
            # world 2's files after step 1, resumed at world 1, once the
            # world-2 untimed runs are done
            while not os.path.exists(f"{w2}/w2_checked"):
                if wait(0.5):
                    raise AssertionError("the ranks ended before their "
                                         "timed runs")
            d1 = f"{w1}/maml_from_w2"
            os.makedirs(d1)
            shutil.copytree(kept, f"{d1}/out/{exp}")
            save_params(dict(params["maml"][1], output_path=f"{d1}/out",
                             device=PAR_DEVICE, resume=True),
                        f"{d1}/params.yml")
            t, _ = _par_run("maml", d1, "_maml_step")
            from_w2 = dict(_par_state(t), step=t.step_global)
            del t
            out, err = torchrun.communicate(timeout=600)
        finally:
            if torchrun.poll() is None:
                torchrun.kill()
                torchrun.wait()
        sec = time.perf_counter() - t_run
        torch.cuda.empty_cache()
        open(f"{w2}/w1_checked", "w").close()
        wait()
        print(f"  world 2 (two gloo ranks on one card), with world 1's "
              f"untimed runs beside it: {time.perf_counter() - t_side:.1f} s")
        r0, r1 = (torch.load(f"{w2}/rank{r}.pt", weights_only=False)
                  for r in (0, 1))
        res["gloo_cuda_direct"] = r0["gloo_cuda_direct"]
        print(f"  gloo's all-reduce, all-gather and broadcast of CUDA "
              f"tensors: {r0['gloo_cuda_direct']}")
        for name in r0:
            if name == "gloo_cuda_direct":
                continue
            w, s = _par_err(r0[name], r1[name])
            if w or s:
                raise AssertionError(f"{name}: ranks differ ({w}, {s})")
        t0 = time.perf_counter()
        for name in ("maml_shipped", "joint_shipped"):
            method = params[name][0]
            t, recs = _par_run(method, f"{w1}/{name}", step_attr[method])
            ref[name] = {"recs": recs}
            del t
            torch.cuda.empty_cache()
        print(f"  world 1's timed runs: {time.perf_counter() - t0:.1f} s")

        for name in ("maml", "joint", "wavernn"):
            w, s = _par_err(r0[name], ref[name])
            steps = (r0[name]["step"], ref[name]["step"])
            print(f"  {name}: world 2 vs world 1 weights max|d| {w:.3e} "
                  f"(limit {PAR_W_ATOL}), statistics {s:.3e} (limit "
                  f"{PAR_STAT_RTOL}), steps {steps}")
            if not (w <= PAR_W_ATOL and s <= PAR_STAT_RTOL
                    and steps[0] == steps[1]):
                raise AssertionError(f"{name}: world 2 vs 1 ({w}, {s}, "
                                     f"{steps})")
            res[f"{name}_w_err"], res[f"{name}_stat_err"] = w, s
        w, s = _par_err(r0["maml_resumed"], r0["maml"])
        print(f"  MAML resumed at world 2 after step 1 vs unbroken: "
              f"{w:.3e}, {s:.3e} (equal bit for bit)")
        if w or s or r0["maml_resumed"]["step"] != r0["maml"]["step"]:
            raise AssertionError("world-2 resume is not the unbroken run")
        w, s = _par_err(from_w2, r0["maml"])
        print(f"  MAML world-2 checkpoint resumed at world 1: weights "
              f"{w:.3e} (limit {PAR_W_ATOL}), statistics {s:.3e}")
        if not (w <= PAR_W_ATOL and s <= PAR_STAT_RTOL
                and from_w2["step"] == r0["maml"]["step"]):
            raise AssertionError(f"world-1 resume ({w}, {s})")
        res["resume_w1_w_err"] = w
        for name in ("maml_shipped", "joint_shipped"):
            a = [_warm(r[name]["recs"]) for r in (r0, r1)]
            b = _warm(ref[name]["recs"])
            print(f"  {name}: world 2 median warm step "
                  f"{a[0]['median_warm_s']:.3f} s (ranks' peaks "
                  f"{a[0]['peak_gib']:.2f}, {a[1]['peak_gib']:.2f} GiB, "
                  f"{a[0]['peak_above_gib']:.2f}, {a[1]['peak_above_gib']:.2f}"
                  f" above what each held), world 1 "
                  f"{b['median_warm_s']:.3f} s ({b['peak_gib']:.2f} GiB, "
                  f"{b['peak_above_gib']:.2f} above what it held); "
                  f"{b['n_warm']} warm steps each; two ranks share one "
                  "card, so this is no multi-GPU speed-up")
            res[name] = {"world2": a, "world1": b}

        ckpts = sorted(os.listdir(f"{d}/out/{exp}/checkpoints")) \
            if torchrun.returncode == 0 else []
        want = "nccl" if PAR_DEVICE.startswith("cuda") else "gloo"
        print(f"  torchrun --nproc_per_node 1: exit {torchrun.returncode}, "
              f"{sec:.1f} s beside world 1's untimed runs, backend {want}, "
              f"checkpoints {ckpts}")
        if (torchrun.returncode != 0 or "checkpoint_0.ckpt" not in ckpts
                or f"backend {want}" not in out):
            print(out[-2000:], err[-3000:])
            raise AssertionError("the torchrun run failed")
        res["torchrun_s"] = sec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def parallel_phase(device) -> dict:
    """Phase 16: dp serving through K1, then data- and task-parallel
    training (``dp_serving``, ``parallel_training``)."""
    print("  dp serving: 2 shards of one card through K1")
    res = {"serving": dp_serving(device)}
    print("  training: 2 gloo ranks on one card, and torchrun on NCCL")
    res["training"] = parallel_training(device)
    return res


# ------------------------------------------------------------- phase 17
# Tensor parallelism (parallel/tp.py).  Serving: {tp: 2} on two shards of
# cuda:0 runs the plain decode with partitioned products (the JAX
# package's choice under tp: its whole-loop kernel is single-device), so
# K1 must not launch; each row's mel is held to the one-device plain
# decode at the JAX package's limit for tp serving
# (tests/test_serving.py), stop steps equal.  Training: two gloo ranks on
# cuda:0 at {dp: 1, tp: 2} against world 1 at phase 16's limits; a tp-2
# run resumed at tp 2 equals the unbroken run bit for bit, and its
# checkpoint, at world 1, the unbroken tp-2 run within TP_RESUME_ATOL.
TP_SERVE_ATOL = 1e-4
TP_RESUME_ATOL = 1e-6
TP_REDUCED = {
    "serving": "B 1 and B 4, T_in 120, 500 steps, float32, and one "
               "bfloat16 request at B 1; the full width",
    "joint": "2 epochs of phase 16's joint run (2 steps each: 32 and 8 "
             "rows), float32, SGD of lr 1e-2, no meta-test",
    "maml": "1 meta-step of phase 16's MAML run at 2 tasks x 8 shots (its "
            "first 2 speakers; 4 until the whole script read 1,014 s of its "
            "1,200: the tasks run one after another, shots do not cost "
            "time), float32, second order, SGD outer of lr 1e-2, no "
            "meta-test",
}
TP_DEVICES = ["cuda:0", "cuda:0"]   # serving's two shards
TP_TRAIN = {"dp": 1, "tp": 2}


def tp_serving(device) -> dict:
    """Phase 17, part 1: ``AdaptiveTTS`` with ``parallel: {tp: 2}`` over
    ``TP_DEVICES`` at the full width (seeded weights, gate bias -1e4,
    T_in 120, 500 steps), B = 1 and B = 4: rows against the one-device
    plain decode, K1 launches under tp (0), and the wall time of a tp-2
    decode, a one-device plain decode and K1's; one ``infer_dtype:
    bfloat16`` request (B = 1) against the one-device plain bfloat16
    decode at phase 3's bound.  An explicit ``cuda`` decode under tp
    raises."""
    import copy

    import numpy as np
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS, AdaptiveTTS

    mp = dict(SHIPPED_MODEL, decoder_no_early_stopping=True,
              n_mel_channels=SHIPPED_AUDIO["n_mels"], n_symbols=N_SYMBOLS)
    params = {"model": mp, "audio_params": dict(SHIPPED_AUDIO)}
    model = Tacotron2NV(config_from_params(mp),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    one = AdaptiveTTS(dict(params, decode_backend="torch"), model,
                      device=device)
    kern = AdaptiveTTS(dict(params, decode_backend="cuda"), model,
                       device=device)
    tp = AdaptiveTTS(dict(params, parallel={"tp": 2}), model, device=device,
                     mesh_devices=TP_DEVICES)
    n_split = sum(a is not None for a in tp._tp_plan.values())
    print(f"  tp serving: decode_backend {tp.decode_backend}, mesh "
          f"{tp._tp_mesh}, {n_split} of {len(tp._tp_plan)} tensors split")
    if tp.decode_backend != "torch":
        raise AssertionError("tp serving resolved to a kernel decode")
    try:
        AdaptiveTTS(dict(params, parallel={"tp": 2}, decode_backend="cuda"),
                    model, device=device, mesh_devices=TP_DEVICES)
    except NotImplementedError as e:
        print(f"  decode_backend cuda with tp raises: {e}")
        if "single-device" not in str(e):
            raise
    else:
        raise AssertionError("decode_backend cuda with tp did not raise")
    cfg, dcfg = one.cfg, one.cfg.decoder_config()
    S, r = dcfg.max_decoder_steps, cfg.n_frames_per_step
    g = torch.Generator().manual_seed(17)
    res = {"k1_launches_under_tp": 0, "max_abs_err": 0.0}

    def timed(tts, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tts._decode(tts.model, *args)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    for B in (1, 4):
        lens = np.array([T_IN, T_IN - 23, T_IN - 10, T_IN - 56][:B])
        inputs = np.random.default_rng(B).integers(1, N_SYMBOLS, (B, T_IN))
        for i in range(B):
            inputs[i, lens[i]:] = 0
        emb = np.random.default_rng(7).standard_normal(
            (B, cfg.speaker_embedding_dim)).astype(np.float32)
        pm = CD.prenet_masks(dcfg, S, B, g, device=device)
        args = (inputs, lens, emb, None, pm)
        if B == 1:                   # warm each path once
            args1 = args
            for tts in (one, tp, kern):
                tts._decode(tts.model, *args)
        (ref, ref_len), plain_ms = timed(one, *args)
        CD.LAUNCHES = 0
        (mel, mel_len), tp_ms = timed(tp, *args)
        n = CD.LAUNCHES
        res["k1_launches_under_tp"] += n
        (_, k1_len), k1_ms = timed(kern, *args)
        if n != 0:
            raise AssertionError(f"tp serving launched K1 {n} times")
        if not np.array_equal(mel_len, ref_len):
            raise AssertionError(f"stop steps {mel_len} != {ref_len}")
        err = max(float((mel[i, :, :max(int(ref_len[i]), 1) * r]
                         - ref[i, :, :max(int(ref_len[i]), 1) * r])
                        .abs().max()) for i in range(B))
        print(f"  float32 B={B}: tp 2 vs one-device plain decode max|d| "
              f"{err:.3e} (limit {TP_SERVE_ATOL}), stop steps "
              f"{mel_len.tolist()} (K1's {k1_len.tolist()}), K1 launches "
              f"under tp {n}; wall {tp_ms:.1f} ms tp 2, {plain_ms:.1f} ms "
              f"one-device plain ({tp_ms / plain_ms:.2f}x), {k1_ms:.1f} ms "
              f"K1; {tp_ms / S:.2f} ms a step under tp")
        if not err <= TP_SERVE_ATOL:
            raise AssertionError(f"B={B}: tp serving rows ({err})")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res[f"b{B}"] = {"tp_ms": tp_ms, "plain_ms": plain_ms,
                        "k1_ms": k1_ms, "max_abs_err": err}
    del one, kern, tp

    # one bfloat16 request (B = 1): the shards cast as the one-device
    # model is, against the one-device plain bfloat16 decode at phase 3's
    # bound (a copy: the one-device service casts its model in place)
    p16 = dict(params, infer_dtype="bfloat16", decode_backend="torch")
    tp16 = AdaptiveTTS(dict(p16, parallel={"tp": 2}), model, device=device,
                       mesh_devices=TP_DEVICES)
    one16 = AdaptiveTTS(p16, copy.deepcopy(model), device=device)
    for tts in (one16, tp16):
        tts._decode(tts.model, *args1)
    (ref, ref_len), plain_ms = timed(one16, *args1)
    CD.LAUNCHES = 0
    (mel, mel_len), tp_ms = timed(tp16, *args1)
    n = CD.LAUNCHES
    res["k1_launches_under_tp"] += n
    if n != 0:
        raise AssertionError(f"bfloat16 tp serving launched K1 {n} times")
    if not np.array_equal(mel_len, ref_len):
        raise AssertionError(f"bfloat16 stop steps {mel_len} != {ref_len}")
    L = max(int(ref_len[0]), 1) * r
    d = (mel[0, :, :L].float() - ref[0, :, :L].float()).abs()
    err = float(d.max())
    share = float((d > DEC_BF16_FLIP["mels"]).float().mean())
    print(f"  bfloat16 B=1: tp 2 vs one-device plain bfloat16 decode max|d| "
          f"{err:.3e} (limit {SERVE_BF16_MAX}), share beyond "
          f"{DEC_BF16_FLIP['mels']}: {share:.2e} (limit {DEC_BF16_SHARE}), "
          f"stop steps {mel_len.tolist()}, K1 launches under tp {n}; wall "
          f"{tp_ms:.1f} ms tp 2, {plain_ms:.1f} ms one-device plain "
          f"({tp_ms / plain_ms:.2f}x)")
    if not (err <= SERVE_BF16_MAX and share <= DEC_BF16_SHARE):
        raise AssertionError(f"bfloat16 tp serving rows ({err}, {share})")
    res["bf16_b1"] = {"tp_ms": tp_ms, "plain_ms": plain_ms,
                      "max_abs_err": err, "share_beyond": share}
    del one16, tp16, model
    torch.cuda.empty_cache()
    return res


def _tp_state(t) -> dict:
    """A trainer's whole weights and batch-norm statistics on the host
    (a tp trainer's ranks gather them: every rank calls this)."""
    ts = t._whole_state()
    return {"w": {k: v.cpu() for k, v in ts.params.items()},
            "stats": {k: v.cpu() for k, v in ts.model_state.items()
                      if v.is_floating_point()}}


def _held_bytes(t) -> dict:
    """The bytes of weights this process holds, and of the Adam moments
    of the same layout (``optim.make_optimizer``'s Adam on them)."""
    from msa_tts_tpu_torch.optim import make_optimizer

    params = t.train_state.params
    adam = make_optimizer({"optimizer_type": "Adam", "lr": 1e-3}).init(
        params)
    moments = [v for s in adam if isinstance(s, dict)
               for m in ("mu", "nu") for v in s.get(m, {}).values()]
    return {"weights": sum(v.numel() * v.element_size()
                           for v in params.values()),
            "moments": sum(v.numel() * v.element_size() for v in moments)}


def _tp_rank(rank: int, world: int, tmp: str) -> None:
    """What each of phase 17's two ranks (gloo, both on ``cuda:0``) runs:
    every case of ``<tmp>/cases.json`` in order; each rank writes
    ``<tmp>/rank<r>.pt``."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device(PAR_DEVICE))
    with open(os.path.join(tmp, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    for name, c in cases.items():
        if c.get("copy"):
            if rank == 0:
                shutil.copytree(*c["copy"])
            dist.barrier()
        t, recs = _par_run(c["method"], os.path.join(tmp, name), c["step"],
                           c.get("keep_epoch1"))
        out[name] = dict(_tp_state(t), recs=recs, step=t.step_global,
                         held=_held_bytes(t))
        del t
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def tp_training(device) -> dict:
    """Phase 17, part 2: two gloo ranks sharing ``cuda:0`` at ``{dp: 1,
    tp: 2}`` run the joint trainer (float32, SGD, 2 epochs of 2 steps)
    and second-order MAML (float32, SGD outer, 1 meta-step of 2 tasks)
    through their entry points, held against the same runs at world 1;
    the joint run's files after epoch 1 resumed at tp 2 (bit for bit
    against the unbroken run) and at world 1; each rank's peak memory
    and the bytes of
    weights (and of Adam's moments of that layout) it holds, against
    world 1's; median warm step times at both worlds."""
    import os
    import shutil
    import tempfile

    import torch

    from msa_tts_tpu_torch.config import save_params
    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
    from msa_tts_tpu_torch.parallel.launch import spawn

    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        corpus = f"{tmp}/corpus"
        make_synthetic_corpus(corpus, n_speakers=4,
                              utterances_per_speaker=12, seed=0,
                              spk_emb_dim=SHIPPED_MODEL[
                                  "speaker_embedding_dim"])
        print("  reduced: " + json.dumps(TP_REDUCED))
        sgd = {"optimizer_type": "SGD", "lr": 1e-2}
        no_test = dict(metatest_epoch_interval=10 ** 6, do_metatest=False)
        params = {
            "joint": ("baseline", example_params(
                "baseline", corpus, "", list(MAML_SPEAKERS), n_epochs=2,
                compute_dtype="float32", optim=sgd, async_checkpoint=False,
                ckpt_save_epoch_interval=1, **no_test)),
            "maml": ("maml", maml_params(
                corpus, "", n_epochs=1, compute_dtype="float32",
                optim_outer=sgd, async_checkpoint=False, **no_test)),
        }
        for k in ("dataset_train", "dataset_metatrain", "dataset_metatest"):
            mp = params["maml"][1]
            mp[k] = dict(mp[k], speakers_list=list(MAML_SPEAKERS[:2]))
        step_attr = {"maml": "_maml_step", "baseline": "_train_step"}
        exp = f"baseline/{params['joint'][1]['experiment_name']}"
        kept = f"{tmp}/joint_epoch1"

        def write(root: str, parallel) -> dict:
            cases = {}
            for name, (method, p) in params.items():
                d = f"{root}/{name}"
                p = dict(p, output_path=f"{d}/out", device=PAR_DEVICE)
                if parallel:
                    p["parallel"] = dict(parallel)
                os.makedirs(d, exist_ok=True)
                save_params(p, f"{d}/params.yml")
                attr = step_attr[method]
                if method == "maml" and parallel:
                    attr = "_maml_step_sharded"   # the tasks' placement
                cases[name] = {"method": method, "step": attr}
            return cases

        w2 = f"{tmp}/tp2"
        cases = write(w2, TP_TRAIN)
        cases["joint"]["keep_epoch1"] = kept
        d = f"{w2}/joint_resumed"
        os.makedirs(d)
        save_params(dict(params["joint"][1], output_path=f"{d}/out",
                         device=PAR_DEVICE, parallel=dict(TP_TRAIN),
                         resume=True), f"{d}/params.yml")
        cases["joint_resumed"] = {"method": "baseline", "step": "_train_step",
                                  "copy": [kept, f"{d}/out/{exp}"]}
        with open(f"{w2}/cases.json", "w") as f:
            json.dump(cases, f)
        t0 = time.perf_counter()
        spawn(_tp_rank, 2, w2, store=f"{w2}/store")
        print(f"  tp 2 (two gloo ranks on one card): "
              f"{time.perf_counter() - t0:.1f} s")
        r0, r1 = (torch.load(f"{w2}/rank{r}.pt", weights_only=False)
                  for r in (0, 1))
        for name in r0:
            w, s = _par_err(r0[name], r1[name])
            if w or s:
                raise AssertionError(f"{name}: ranks' gathered states "
                                     f"differ ({w}, {s})")
        w1 = f"{tmp}/w1"
        write(w1, None)
        ref = {}
        t0 = time.perf_counter()
        for name in ("joint", "maml"):
            method = params[name][0]
            t, recs = _par_run(method, f"{w1}/{name}", step_attr[method])
            ref[name] = dict(_tp_state(t), recs=recs, step=t.step_global,
                             held=_held_bytes(t))
            del t
            torch.cuda.empty_cache()
        d1 = f"{w1}/joint_from_tp2"
        os.makedirs(d1)
        shutil.copytree(kept, f"{d1}/out/{exp}")
        save_params(dict(params["joint"][1], output_path=f"{d1}/out",
                         device=PAR_DEVICE, resume=True), f"{d1}/params.yml")
        t, _ = _par_run("baseline", d1, "_train_step")
        from_tp2 = dict(_tp_state(t), step=t.step_global)
        del t
        torch.cuda.empty_cache()
        print(f"  world 1's runs: {time.perf_counter() - t0:.1f} s")

        for name in ("joint", "maml"):
            w, s = _par_err(r0[name], ref[name])
            steps = (r0[name]["step"], ref[name]["step"])
            print(f"  {name}: tp 2 vs world 1 weights max|d| {w:.3e} (limit "
                  f"{PAR_W_ATOL}), statistics {s:.3e} (limit "
                  f"{PAR_STAT_RTOL}), steps {steps}")
            if not (w <= PAR_W_ATOL and s <= PAR_STAT_RTOL
                    and steps[0] == steps[1]):
                raise AssertionError(f"{name}: tp 2 vs world 1 ({w}, {s}, "
                                     f"{steps})")
            res[f"{name}_w_err"], res[f"{name}_stat_err"] = w, s
        w, s = _par_err(r0["joint_resumed"], r0["joint"])
        print(f"  joint resumed at tp 2 after epoch 1 vs unbroken: {w:.3e}, "
              f"{s:.3e} (equal bit for bit)")
        if (w or s
                or r0["joint_resumed"]["step"] != r0["joint"]["step"]):
            raise AssertionError("tp-2 resume is not the unbroken run")
        w, s = _par_err(from_tp2, r0["joint"])
        print(f"  joint tp-2 checkpoint resumed at world 1: weights {w:.3e} "
              f"(limit {TP_RESUME_ATOL}), statistics {s:.3e} (limit "
              f"{PAR_STAT_RTOL})")
        if not (w <= TP_RESUME_ATOL and s <= PAR_STAT_RTOL
                and from_tp2["step"] == r0["joint"]["step"]):
            raise AssertionError(f"world-1 resume of tp 2 ({w}, {s})")
        res["resume_w1_w_err"], res["resume_w1_stat_err"] = w, s
        for name in ("joint", "maml"):
            a = [_warm(r[name]["recs"]) for r in (r0, r1)]
            b = _warm(ref[name]["recs"])
            held = [r[name]["held"] for r in (r0, r1)]
            mb = [(h["weights"] + h["moments"]) / 1e6 for h in held]
            mb1 = (ref[name]["held"]["weights"]
                   + ref[name]["held"]["moments"]) / 1e6
            print(f"  {name}: tp 2 median warm step "
                  f"{a[0]['median_warm_s']:.3f} s, world 1 "
                  f"{b['median_warm_s']:.3f} s ({b['n_warm']} warm steps); "
                  f"peak memory per rank {a[0]['peak_gib']:.2f}, "
                  f"{a[1]['peak_gib']:.2f} GiB ({a[0]['peak_above_gib']:.2f}"
                  f", {a[1]['peak_above_gib']:.2f} above what each held) "
                  f"against world 1's {b['peak_gib']:.2f} GiB "
                  f"({b['peak_above_gib']:.2f}); weights and Adam moments "
                  f"held per rank {mb[0]:.1f}, {mb[1]:.1f} MB against "
                  f"{mb1:.1f} MB; two ranks share one card, so this is no "
                  "multi-GPU speed-up")
            res[name] = {"tp2": a, "world1": b, "held_mb_tp2": mb,
                         "held_mb_world1": mb1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def tp_phase(device) -> dict:
    """Phase 17: tp serving over two shards of the card (no kernel), then
    tensor-parallel training over two gloo ranks (``tp_serving``,
    ``tp_training``)."""
    print("  tp serving: 2 shards of one card, the plain decode")
    res = {"serving": tp_serving(device)}
    print("  training: {dp: 1, tp: 2} over 2 gloo ranks on one card")
    res["training"] = tp_training(device)
    return res


# ------------------------------------------------------------- phase 18
# WaveGlow's WN passes (csrc/waveglow_wn.cu) at the benchmark cell's
# call: 16 rows of 1,000 frames, N = 512,000 group positions, C = 256
# channels (NVIDIA's config.json: 12 flows of 8 layers).
WG_ROWS, WG_FRAMES, WG_C, WG_LAYERS, WG_FLOWS = 16, 1000, 256, 8, 12


def _wn_differ(got, want, what: str) -> None:
    """Raise, naming the output and how many of its elements differ,
    unless ``got`` equals ``want`` bit for bit."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}, the "
                             f"eager ops {want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: {int((got != want).sum())} of "
                             f"{got.numel()} elements differ from the eager "
                             "ops")


def wn_passes(device, dt, N: int, C: int) -> dict:
    """Each WN pass against its eager ops at N positions of C channels in
    type ``dt``: bit for bit (the residual pass of the first, a middle
    and the last layer), then a launch of the gate and of a middle
    layer's residual pass (7 of a flow's 8) timed with CUDA events;
    bound: each input read and each output written once over 3.35
    TB/s."""
    import torch

    from msa_tts_tpu_torch.vocoders import cuda_wn as CW

    g = torch.Generator(device=device).manual_seed(3)

    def rnd(w):
        return torch.randn((1, N, w), generator=g, device=device).to(dt)

    zc, zd, rs, x, skip, rs_last = (rnd(w) for w in (2 * C, 2 * C, 2 * C,
                                                     C, C, C))
    acts = CW.gate_reference(zc, zd)
    _wn_differ(CW.cuda_gate(zc, zd), acts, f"gate ({dt})")
    for layer, r, s in (("first", rs, None), ("middle", rs, skip),
                        ("last", rs_last, skip)):
        s2 = None if s is None else s.clone()
        kern = CW.cuda_residual(r, x.clone(), s2)
        plain = CW.residual_reference(r, x.clone(),
                                      None if s is None else s.clone())
        for out, got, want in zip(("x", "skip"), kern, plain):
            _wn_differ(got, want, f"residual pass, {layer} layer, {out} "
                                  f"({dt})")
    res = {}
    for name, kern, plain, nbytes in (
            ("gate", lambda: CW.cuda_gate(zc, zd),
             lambda: CW.gate_reference(zc, zd), _nbytes(zc, zd, acts)),
            # x and skip in place: each read and written
            ("residual", lambda: CW.cuda_residual(rs, x, skip),
             lambda: CW.residual_reference(rs, x, skip),
             _nbytes(rs, x, skip, x, skip))):
        kern()
        plain()
        ms, plain_ms = _time_ms(kern, 20), _time_ms(plain, 20)
        bound_ms, _ = _bound(nbytes, 0, BF16_FLOPS)
        res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "bytes": nbytes}
        print(f"  {name} ({dt}): kernel {1e3 * ms:.1f} us, eager ops "
              f"{1e3 * plain_ms:.1f} us, bound {1e3 * bound_ms:.1f} us "
              f"({nbytes / 1e9:.3f} GB; kernel at "
              f"{100 * bound_ms / ms:.1f} % of 3.35 TB/s); bit for bit")
    # one WN layer's pair (the last layer's residual pass is lighter)
    return {k: res["gate"][k] + res["residual"][k]
            for k in ("ms", "plain_ms", "bound_ms")} | res


def waveglow_phase(device) -> dict:
    """Phase 18: WaveGlow's WN passes alone (``wn_passes``) at the cell's
    N and C, bfloat16 and float32; a batch served through
    ``AdaptiveTTS.synthesize_batch(vocoder="waveglow")`` at the published
    width, its WN launches counted from 0 (2 x layers x flows); then,
    outside that count, the cell's call (``infer_batch`` over 16 rows of
    1,000 frames) timed with the passes and with their eager ops in their
    place, and its waveforms held bit for bit to the eager ops' (cuDNN
    deterministic for that comparison: in float32 it may otherwise take
    an algorithm for the upsampler whose sums land in another order)."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.vocoders import cuda_wn as CW
    from msa_tts_tpu_torch.vocoders.waveglow import WaveGlowVocoder
    from tools.bench_waveglow import published_waveglow

    hop = SHIPPED_AUDIO["hop_length"]
    N = WG_ROWS * WG_FRAMES * hop // 8          # n_group 8
    res = {}
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        print(f"  WN passes alone ({tag}): N {N}, C {WG_C}")
        res[tag] = wn_passes(device, dt, N, WG_C)
        torch.cuda.empty_cache()

    # ---- the main path: every WN launch from here to the count is served
    tts = _serving_tts(device)
    voc = WaveGlowVocoder(published_waveglow(0), dtype="bfloat16",
                          device=device)
    tts.attach_vocoder("waveglow", voc)
    emb = np.random.default_rng(0).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32)
    n_frames = tts.cfg.max_decoder_steps * tts.cfg.n_frames_per_step
    CW.WN_LAUNCHES = 0
    wavs = tts.synthesize_batch(TEXTS[:2], spk_emb=emb, seed=0,
                                vocoder="waveglow")
    res["launches"] = CW.WN_LAUNCHES
    want = 2 * WG_LAYERS * WG_FLOWS
    print(f"  synthesize_batch x2 (vocoder='waveglow'): {res['launches']} "
          f"WN launches (want {want})")
    if res["launches"] != want:
        raise AssertionError(f"{res['launches']} WN launches in one served "
                             f"WaveGlow call, want {want}")
    for w in wavs:
        if w.shape != (n_frames * hop,) or not np.isfinite(w).all():
            raise AssertionError(f"waveglow: wav of shape {w.shape} (want "
                                 f"{n_frames * hop}) or not finite")
    del tts, wavs

    # ---- the cell's call, not counted above
    g = torch.Generator().manual_seed(1)
    mels = [torch.randn((80, WG_FRAMES), generator=g)
            for _ in range(WG_ROWS)]
    noise = [torch.randn((8, WG_FRAMES * hop // 8), generator=g)
             for _ in range(WG_ROWS)]
    passes = CW.cuda_gate, CW.cuda_residual
    eager = CW.gate_reference, CW.residual_reference
    det = torch.backends.cudnn.deterministic
    out = {}
    try:
        for side, (gate, residual) in (("kernels", passes),
                                       ("eager", eager)):
            CW.cuda_gate, CW.cuda_residual = gate, residual
            voc.infer_batch(mels, noise)
            res["call_ms" if side == "kernels" else "plain_call_ms"] = (
                _time_ms(lambda: voc.infer_batch(mels, noise), 3))
            torch.backends.cudnn.deterministic = True
            out[side] = torch.stack(voc.infer_batch(mels, noise))
            torch.backends.cudnn.deterministic = det
    finally:
        CW.cuda_gate, CW.cuda_residual = passes
        torch.backends.cudnn.deterministic = det
    _wn_differ(out["kernels"], out["eager"], "the cell's call, waveforms")
    print(f"  the cell's call ({WG_ROWS} x {WG_FRAMES} frames, bf16): "
          f"{res['call_ms']:.1f} ms with the passes, "
          f"{res['plain_call_ms']:.1f} ms with the eager ops; waveforms "
          "bit for bit")
    return res


def main(argv=None) -> int:
    import shutil

    try:
        return _run(argv)
    finally:
        if "dir" in KEPT:
            shutil.rmtree(KEPT.pop("dir"), ignore_errors=True)


def _run(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one GPU.")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases (12, 13, 14, 15, 16, 17, "
                         "18) to run "
                         "after phase 1 instead of all phases; the kernels "
                         "line is then not printed")
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from msa_tts_tpu_torch.kernels import build
    from msa_tts_tpu_torch.models import cuda_decoder as CD

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.prebuild(["decoder_loop", "wavernn_loop", "lstm_cell",
                    "waveglow_wn"])
    CD._lib()
    print(f"phase 1: kernels built/loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, (sec, log) in build.build_log.items():
        print(f"  nvcc {name}: {sec:.1f} s")
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the mangled name's tail holds the kernel's name and its
                # weight type (If = float, I13__nv_bfloat16, It = bf16)
                print("    ..." + line.split("'")[1][-58:])
            elif "registers" in line or "spill" in line or "smem" in line:
                print("     ", line.strip())
    n_mma = build.sass_count("wavernn_loop", "HMMA")
    print(f"  wavernn_loop machine code: {n_mma} HMMA opcodes (the tensor "
          "cores' bf16 product)" if n_mma is not None
          else "  cuobjdump not found: machine code not inspected")
    n_dec = build.sass_count("decoder_loop", "HMMA")
    n_cell = build.sass_count("lstm_cell", "HMMA")
    if n_mma is not None:
        print(f"  decoder_loop machine code: {n_dec} HMMA opcodes (the "
              "bf16 LSTM and prenet products)")
        print(f"  lstm_cell machine code: {n_cell} HMMA opcodes (the bf16 "
              "recurrent product)")
    if n_mma == 0 or n_dec == 0 or n_cell == 0:
        raise AssertionError("a kernel's bf16 path holds no tensor-core "
                             "opcode")
    gpu = _gpu_line()
    print(gpu)
    if only:
        for phase in only.split(","):
            print(f"phase {phase} alone")
            t0 = time.perf_counter()
            res = {"12": maml_phase, "13": train_phase,
                   "14": vocoder_phase, "15": cli_phase,
                   "16": parallel_phase, "17": tp_phase,
                   "18": waveglow_phase}[phase](device)
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
            print(gpu)
            print(json.dumps({phase: res}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS, AdaptiveTTS

    mp = dict(SHIPPED_MODEL, decoder_no_early_stopping=True,
              n_mel_channels=SHIPPED_AUDIO["n_mels"], n_symbols=N_SYMBOLS)

    def make_tts(infer_dtype):
        model = Tacotron2NV(config_from_params(mp),
                            generator=torch.Generator().manual_seed(0))
        return AdaptiveTTS(
            {"model": mp, "audio_params": dict(SHIPPED_AUDIO),
             "decode_backend": "cuda", "infer_dtype": infer_dtype},
            model, device=device,
        )

    # the same seeded weights served in float32 and in bfloat16
    tts, tts16 = make_tts("float32"), make_tts("bfloat16")
    both = ((tts, "float32"), (tts16, "bfloat16"))
    bias0 = {tag: t.model.decoder.gate_layer.linear_layer.bias.detach()
             .clone() for t, tag in both}
    k, sk, launches, seg_launches = {}, {}, {}, {}
    for t, tag in both:
        print(f"phase 2 ({tag}): decoder kernel vs plain PyTorch at full "
              "width")
        k[tag] = kernel_vs_plain(t, device)
    print("phase 3: serve requests (seeded random weights, cuda decode)")
    launches["float32"] = serve(tts, device)
    launches["bfloat16"] = serve(tts16, device, n_single=1, batch=False)
    print(gpu)
    for t, tag in both:
        print(f"phase 4 ({tag}): segment kernel vs whole-loop kernel and "
              f"plain segment at full width (n_seg {SEG})")
        sk[tag] = segment_vs_plain(t, device, bias0[tag])
    print(gpu)
    print("phase 5: stream requests through synthesize_stream (cuda)")
    seg_launches["float32"] = stream_requests(tts, device)
    seg_launches["bfloat16"] = stream_requests(tts16, device, n_texts=1)
    print(gpu)
    print("phase 6: multiplex 4 staggered streams (cuda engine, t_cap 128)")
    multiplex(tts, device)
    print("  bfloat16:")
    multiplex(tts16, device, full=False)
    print(gpu)
    print("phase 7: HTTP server with stream_multiplex=4")
    http_server(tts, device)
    print("  bfloat16:")
    http_server(tts16, device)
    print(gpu)
    del tts16
    torch.cuda.empty_cache()
    print(f"phase 8: WaveRNN sample-loop kernel vs plain PyTorch at the "
          f"default width (B {GEN_B}, T {GEN_T})")
    gk = gen_kernel_vs_plain(device)
    print(gpu)
    print("phase 9: serve with WaveRNN and HiFi-GAN attached (cuda decode, "
          "cuda sample loop)")
    gen_launches = serve_vocoders(tts, device)
    print(gpu)
    print("phase 10: LSTM-cell kernel vs plain PyTorch (B 16, H 1024) and "
          "its 400-step scan")
    ck = lstm_cell_vs_plain(device)
    print(gpu)
    print("phase 11: few-shot adaptation (AdaptiveTTS.adapt) at the shipped "
          "width, and the adapted voice served through the decoder kernels")
    ad = adapt_phase(device, dict(SHIPPED_MODEL, n_symbols=N_SYMBOLS,
                                  n_mel_channels=SHIPPED_AUDIO["n_mels"]),
                     SHIPPED_AUDIO, SHIPPED_ADAPT)
    print(gpu)
    print(json.dumps({"adapt": ad}))
    print("phase 12: MAML meta-training at the shipped width "
          "(trainers.maml.main), resume, card vs CPU, and the trained "
          "checkpoint served through the decoder kernels")
    mm = maml_phase(device)
    print(gpu)
    print(json.dumps({"maml": mm}))
    print("phase 13: joint, Reptile and continual (EWC, ER-KD) training at "
          "the shipped width through their entry points, resumes, card vs "
          "CPU, and the joint and EWC checkpoints served through the "
          "decoder kernels")
    t0 = time.perf_counter()
    tp = train_phase(device)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    print(gpu)
    print(json.dumps({"train": tp}))
    print("phase 14: the host feature library, WaveRNN and HiFi-GAN v1 "
          "trained at the served widths through their entry points, card "
          "vs CPU, the sample-loop kernel on the trained WaveRNN, and both "
          "trained vocoders served")
    t0 = time.perf_counter()
    vp = vocoder_phase(device)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    print(gpu)
    print(json.dumps({"vocoders": vp}))
    print("phase 15: the inference CLIs (infer, infer_cumulative) at the "
          "shipped width through their entry points, on the checkpoints "
          "of phases 12-14, through the decoder and sample-loop kernels")
    t0 = time.perf_counter()
    cp = cli_phase(device)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    print(gpu)
    print(json.dumps({"cli": cp}))
    cli_launches = {k: sum(n[k] for n in cp["launches"].values())
                    for k in ("decoder_loop", "wavernn_loop")}
    print("phase 16: dp serving through the decoder kernel (2 shards of "
          "one card), data- and task-parallel training over 2 gloo ranks "
          "on one card against world 1, resumes, and torchrun on NCCL")
    t0 = time.perf_counter()
    pp = parallel_phase(device)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    print(gpu)
    print(json.dumps({"parallel": pp}))
    print("phase 17: tensor parallelism: {tp: 2} serving over 2 shards of "
          "one card (the plain decode, no kernel), and {dp: 1, tp: 2} "
          "joint and MAML training over 2 gloo ranks on one card against "
          "world 1, resumes")
    t0 = time.perf_counter()
    tpp = tp_phase(device)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")
    print(gpu)
    print(json.dumps({"tp": tpp}))
    print("phase 18: WaveGlow's WN passes alone at the cell's shape, a "
          "batch served with WaveGlow attached, and the cell's call "
          "against the eager ops")
    t0 = time.perf_counter()
    wg = waveglow_phase(device)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    print(gpu)
    print(json.dumps({"waveglow": wg}))

    def dec_entry(name, line, res, n_launch):
        """One decoder kernel's entry: float32 at the top (B = 4, T_in
        120, 500 steps), the bfloat16 numbers of the same shapes under
        ``bf16``; ``launches`` counts both types' served launches."""
        f32, b16 = res["float32"], res["bfloat16"]
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "us_per_step_b1", "us_per_step_b4")
        keys += tuple(key for key in ("barrier_us_per_step_b1",
                                      "barrier_us_per_step_b4")
                      if key in f32)
        return {
            "name": name,
            "route": "cuda",
            "source": "msa_tts_tpu_torch/csrc/decoder_loop.cu",
            "replaces": f"msa_tts_tpu/models/pallas_decoder.py:{line}",
            "launches": n_launch["float32"] + n_launch["bfloat16"],
            **{key: f32[key] for key in keys},
            "library_ms": None,
            "bf16": {"launches": n_launch["bfloat16"],
                     **{key: b16[key] for key in keys}},
        }

    print(json.dumps({"kernels": [
        # adapted_voice_launches: phase 11's served path;
        # trained_checkpoint_launches: phase 12's; joint_ and
        # ewc_checkpoint_launches: phase 13's
        dict(dec_entry("decoder_loop", 458, k, launches),
             adapted_voice_launches=ad["launches"],
             trained_checkpoint_launches=mm["launches"],
             joint_checkpoint_launches=tp["joint_served"]["launches"],
             ewc_checkpoint_launches=tp["ewc_served"]["launches"],
             cli_launches=cli_launches["decoder_loop"],
             dp_serving_launches=pp["serving"]["launches"],
             dp_serving_max_abs_err=pp["serving"]["max_abs_err"]),
        dict(dec_entry("decoder_segment", 553, sk, seg_launches),
             adapted_voice_launches=ad["seg_launches"],
             trained_checkpoint_launches=mm["seg_launches"],
             joint_checkpoint_launches=tp["joint_served"]["seg_launches"],
             ewc_checkpoint_launches=tp["ewc_served"]["seg_launches"]),
        {
        # the serving path's type: bf16 weight matrices, B 44, T 3,850
        "name": "wavernn_loop",
        "route": "cuda",
        "source": "msa_tts_tpu_torch/csrc/wavernn_loop.cu",
        "replaces": "msa_tts_tpu/vocoders/pallas_gen.py:228",
        "launches": gen_launches,
        "max_abs_err": gk["max_abs_err"],
        "max_abs_err_bf16": gk["max_abs_err_bf16"],
        **gk["bf16"],
        "library_ms": None,
        "f32": gk["f32"],
        "barrier_us": gk["barrier_us"],
        # phase 14: one request vocoded by the trained WaveRNN, and the
        # kernel on its weights against the plain loop (44 rows; the
        # sampled noise, and the noise with the mixture choice forced)
        "trained_checkpoint_launches": vp["launches"],
        "trained_checkpoint_max_abs_err": vp["max_abs_err_f32_sampled"],
        "trained_checkpoint_max_abs_err_forced": vp["max_abs_err_f32_forced"],
        "trained_checkpoint_max_abs_err_bf16_forced":
            vp["max_abs_err_bf16_forced"],
        "trained_checkpoint_bf16_departures": vp["bf16_departures"],
        # phase 15: the inference CLIs' WaveRNN vocodings
        "cli_launches": cli_launches["wavernn_loop"],
    }, {
        # one launch is one step: B 16, H 1024, f32 (bf16 under "bf16");
        # ms and library_ms are device times per step inside a 400-step
        # scan replayed from a CUDA graph, plain_ms the plain scan's wall
        "name": "lstm_cell",
        "route": "cuda",
        "source": "msa_tts_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "msa_tts_tpu/experimental/pallas_lstm_cell.py:87",
        **ck,
    }, {
        # one WN layer's gate and residual pass, each a launch at the
        # cell's call (N 512,000, C 256), bf16 as served (f32 under
        # "f32"); launches: phase 18's served batch, 2 a layer
        "name": "waveglow_wn",
        "route": "cuda",
        "source": "msa_tts_tpu_torch/csrc/waveglow_wn.cu",
        "replaces": None,
        "launches": wg["launches"],
        "max_abs_err": 0.0,
        **wg["bf16"],
        "library_ms": None,
        "f32": wg["f32"],
        "call_ms": wg["call_ms"],
        "plain_call_ms": wg["plain_call_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
