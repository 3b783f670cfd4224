"""WaveGlow inference (NVIDIA/waveglow ``glow.py``, ``WaveGlow.infer``),
plain PyTorch, one mel at a time, at a :class:`Precision`: the
upsampler, then the flows in reverse from the given latent noise.

At a precision below float32 it computes what the configuration states
the served model computes (``configs/t2nv_waveglow.json``, ``assumed``):
the operands of the upsampler's, ``start``'s, the conditioning's, the
dilated, res/skip and ``end`` products rounded (``p.w``, ``p.x``), their
sums in float32, and every activation between them stored at bfloat16
(``p.vec``): the upsampler's output before and after its bias, each
product's output with its bias, the gate's sum, ``tanh``, ``sigmoid``
and their product, the residual and skip sums.  ``end``'s output, the
coupling, the invertible convolutions and the audio stay float32.  At
float32 nothing is rounded.

Departures from NVIDIA's code: weight norm is already folded into the
weights; the latent noise is given (``noise``: (n_group, P), channels in
the order the reverse pass consumes them, see
``msa_tts_tpu_torch/vocoders/waveglow.py``) rather than drawn; ``sigma``
is a parameter; the dilated convolution's bias is added to the
conditioning's before the product's output is rounded (b_cond + b_in);
the upsampler's bias is added after its product's output is rounded; the
coupling multiplies by exp(−s); W⁻¹ is made in float64.  The products
run with TF32 off (the caller's ``no_tf32``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Precision

HOP = 256


def _flows(v: dict) -> list:
    n_rem, out = v["n_group"], []
    for k in range(v["n_flows"]):
        if k % v["n_early_every"] == 0 and k > 0:
            n_rem -= v["n_early_size"]
        out.append(n_rem)
    return out


def upsample(p: Precision, sd: dict, v: dict, mel) -> torch.Tensor:
    """(n_mel, T) → spect (1, n_mel · n_group, T · hop / n_group)."""
    T = mel.shape[-1]
    up = F.conv_transpose1d(p.x(mel)[None], p.w(sd["upsample.weight"]),
                            stride=HOP)[..., : T * HOP]
    up = p.vec(p.vec(up) + p.vec(sd["upsample.bias"])[:, None])
    g = v["n_group"]
    return up.unflatten(-1, (T * HOP // g, g)).permute(0, 1, 3, 2).flatten(1, 2)


def _1x1(p: Precision, w, b, x):
    return F.conv1d(p.x(x), p.w(w), b)


def wn(p: Precision, sd: dict, v: dict, k: int, a0, spect):
    """Flow ``k``'s WN: (1, n_half, L) → ``end``'s (1, 2·n_half, L)."""
    cfg = v["WN_config"]
    C, K, pre = cfg["n_channels"], cfg["kernel_size"], f"WN.{k}."
    S = p.vec
    x = S(_1x1(p, sd[pre + "start.weight"], S(sd[pre + "start.bias"]), a0))
    cw, cb = p.w(sd[pre + "cond_layer.weight"]), sd[pre + "cond_layer.bias"]
    skip = None
    n = cfg["n_layers"]
    for i in range(n):
        d, sl = 2 ** i, slice(2 * C * i, 2 * C * (i + 1))
        bias = S(cb[sl].float() + sd[f"{pre}in_layers.{i}.bias"].float())
        g = S(F.conv1d(p.x(spect), cw[sl], bias))
        c = S(F.conv1d(p.x(x), p.w(sd[f"{pre}in_layers.{i}.weight"]),
                       dilation=d, padding=(K * d - d) // 2))
        z = S(g + c)
        acts = S(S(torch.tanh(z[:, :C])) * S(torch.sigmoid(z[:, C:])))
        rs = S(_1x1(p, sd[f"{pre}res_skip_layers.{i}.weight"],
                    S(sd[f"{pre}res_skip_layers.{i}.bias"]), acts))
        if i < n - 1:
            x = S(x + rs[:, :C])
            s = rs[:, C:]
        else:
            s = rs
        skip = s if skip is None else S(skip + s)
    return _1x1(p, sd[pre + "end.weight"], sd[pre + "end.bias"].float(),
                skip)


def infer(p: Precision, sd: dict, v: dict, mel, noise,
          sigma: float) -> torch.Tensor:
    """(n_mel, T) mel and (n_group, P ≥ T·hop/n_group) noise → the
    waveform (T·hop,), float32."""
    spect = upsample(p, sd, v, mel.float())
    L = spect.shape[-1]
    noise = noise[:, :L].float()
    n_rem = _flows(v)[-1]
    audio, c = sigma * noise[None, :n_rem], n_rem
    for k in reversed(range(v["n_flows"])):
        h = audio.shape[1] // 2
        a0, a1 = audio[:, :h], audio[:, h:]
        e = wn(p, sd, v, k, a0, spect)
        a1 = (a1 - e[:, :h]) * torch.exp(-e[:, h:])
        W = sd[f"convinv.{k}.conv.weight"][..., 0].double()
        audio = F.conv1d(torch.cat([a0, a1], 1),
                         torch.linalg.inv(W).float()[..., None])
        if k % v["n_early_every"] == 0 and k > 0:
            e_ = v["n_early_size"]
            audio = torch.cat([sigma * noise[None, c:c + e_], audio], 1)
            c += e_
    return audio[0].T.reshape(-1)
