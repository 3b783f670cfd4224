"""WaveGlow inference as NVIDIA/waveglow's ``glow.py`` writes it
(``WaveGlow.infer``, ``WN.forward``, ``Invertible1x1Conv`` reversed), in
float32, one mel at a time: no batching, no masks.  Plain PyTorch; it
imports nothing of the port, of JAX or of ``msa_tts_tpu``.

Departures from NVIDIA's code: weight norm is already folded into the
weights (``state_dict`` keys ``*.weight``, ``*.bias``); the latent noise
is given (``noise``: (n_group, P), channels in the order the reverse pass
consumes them: the ``n_remaining_channels`` it starts from, then
``n_early_size`` for each flow that adds them, last flow first) rather
than drawn; ``sigma`` is a parameter.  :func:`forward_flow` is the
training direction of one flow (``WaveGlow.forward``'s loop body), for
inverting a flow by hand.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _layout(cfg: dict) -> list:
    """(n_half, n_remaining) of each flow, as ``WaveGlow.__init__``."""
    n_half, n_rem, out = cfg["n_group"] // 2, cfg["n_group"], []
    for k in range(cfg["n_flows"]):
        if k % cfg["n_early_every"] == 0 and k > 0:
            n_half -= cfg["n_early_size"] // 2
            n_rem -= cfg["n_early_size"]
        out.append((n_half, n_rem))
    return out


def wn(sd: dict, k: int, cfg: dict, audio, spect):
    """``WN.forward((audio, spect))`` of flow ``k``: (1, C, L) → (1, 2C, L)."""
    w = cfg["WN_config"]
    nc, p = w["n_channels"], f"WN.{k}."
    audio = F.conv1d(audio, sd[p + "start.weight"], sd[p + "start.bias"])
    output = torch.zeros_like(audio)
    spect = F.conv1d(spect, sd[p + "cond_layer.weight"],
                     sd[p + "cond_layer.bias"])
    for i in range(w["n_layers"]):
        d = 2 ** i
        a = F.conv1d(audio, sd[f"{p}in_layers.{i}.weight"],
                     sd[f"{p}in_layers.{i}.bias"], dilation=d,
                     padding=(w["kernel_size"] * d - d) // 2)
        in_act = a + spect[:, i * 2 * nc:(i + 1) * 2 * nc]
        acts = torch.tanh(in_act[:, :nc]) * torch.sigmoid(in_act[:, nc:])
        rs = F.conv1d(acts, sd[f"{p}res_skip_layers.{i}.weight"],
                      sd[f"{p}res_skip_layers.{i}.bias"])
        if i < w["n_layers"] - 1:
            audio = audio + rs[:, :nc]
            output = output + rs[:, nc:]
        else:
            output = output + rs
    return F.conv1d(output, sd[p + "end.weight"], sd[p + "end.bias"])


def upsample(sd: dict, cfg: dict, mel):
    """(n_mel, T) → spect (1, n_mel · n_group, T · 256 / n_group)."""
    up = sd["upsample.weight"]
    spect = F.conv_transpose1d(mel[None], up, sd["upsample.bias"],
                               stride=256)
    spect = spect[:, :, :-(up.shape[-1] - 256)]
    g = cfg["n_group"]
    spect = spect.unfold(2, g, g).permute(0, 2, 1, 3)
    return spect.contiguous().view(1, spect.size(1), -1).permute(0, 2, 1)


def infer(sd: dict, cfg: dict, mel, noise, sigma: float = 0.6):
    """(n_mel, T) mel and (n_group, P ≥ T·256/n_group) noise → the
    waveform (T·256,)."""
    sd = {k: v.float() for k, v in sd.items()}
    spect = upsample(sd, cfg, mel.float())
    L = spect.size(2)
    noise = noise[:, :L].float()
    layout = _layout(cfg)
    n_rem = layout[-1][1]
    audio, c = sigma * noise[None, :n_rem], n_rem
    for k in reversed(range(cfg["n_flows"])):
        n_half = audio.size(1) // 2
        audio_0, audio_1 = audio[:, :n_half], audio[:, n_half:]
        output = wn(sd, k, cfg, audio_0, spect)
        s, b = output[:, n_half:], output[:, :n_half]
        audio_1 = (audio_1 - b) / torch.exp(s)
        audio = torch.cat([audio_0, audio_1], 1)
        W = sd[f"convinv.{k}.conv.weight"].squeeze()
        audio = F.conv1d(audio, W.float().inverse()[..., None])
        if k % cfg["n_early_every"] == 0 and k > 0:
            e = cfg["n_early_size"]
            audio = torch.cat([sigma * noise[None, c:c + e], audio], 1)
            c += e
    return audio.permute(0, 2, 1).contiguous().view(-1)


def forward_flow(sd: dict, cfg: dict, k: int, audio, spect):
    """Flow ``k`` in the training direction: the invertible convolution,
    then the affine coupling (1, C, L) → (1, C, L)."""
    sd = {n: v.float() for n, v in sd.items()}
    audio = F.conv1d(audio, sd[f"convinv.{k}.conv.weight"])
    n_half = audio.size(1) // 2
    audio_0, audio_1 = audio[:, :n_half], audio[:, n_half:]
    output = wn(sd, k, cfg, audio_0, spect)
    log_s, b = output[:, n_half:], output[:, :n_half]
    return torch.cat([audio_0, torch.exp(log_s) * audio_1 + b], 1)
