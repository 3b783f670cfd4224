"""WaveGlow (NVIDIA/waveglow, arXiv:1811.00002), inference only.

:class:`WaveGlow` holds the published model's convolutions under its
``state_dict`` keys with weight norm folded into plain weights
(``upsample.*``, ``WN.{k}.{start,end,cond_layer}.*``,
``WN.{k}.in_layers.{i}.*``, ``WN.{k}.res_skip_layers.{i}.*``,
``convinv.{k}.conv.weight``), so such a ``state_dict`` loads with
``strict=True``.  :class:`WaveGlowVocoder` serves it
(``AdaptiveTTS.attach_vocoder("waveglow", ...)``): ``infer_batch`` runs
the reverse pass of ``glow.py``'s ``infer`` over a padded batch of mels.

- The mel is upsampled by ``ConvTranspose1d(n_mel, n_mel, 1024, stride
  256)``, cut by 768 samples and grouped into ``n_mel · n_group``
  conditioning channels a group position (channel ``mel · n_group + j``).
- The flows run in reverse from latent noise times ``sigma``: each WN
  (a 1×1 ``start``; per layer a dilated convolution added to its slice
  of one 1×1 conditioning product, ``tanh · sigmoid``, a 1×1 res/skip;
  a 1×1 ``end``) gives ``b`` and ``s``, the coupling takes
  ``(x₁ − b) · exp(−s)``, then the inverse of the flow's invertible 1×1
  convolution mixes the channels, and every ``n_early_every`` flows
  ``n_early_size`` channels of noise join in front.

**Noise.** A row's latent noise is one ``(n_group, P)`` tensor, ``P`` at
least the row's group positions (``frames · hop / n_group``; the first
``frames · hop / n_group`` are used): channels ``[0, n_rem)`` are those
the reverse pass starts from, then ``n_early_size`` channels for each
flow that adds them, in the order the reverse pass reaches them (for the
published model: 4, then 2 at flow 8, then 2 at flow 4).  Given none, it
is drawn standard normal from ``generator``.

**Layout.** Activations are positions-major, ``(B, L, C)``: a 1×1
convolution is one cuBLAS product over ``B·L`` rows (``F.linear``, bias
in its epilogue), a dilated one a cuDNN convolution on the channels-last
view, and the last flow's ``(B, L, n_group)`` is the waveform.  What
lies between a WN layer's products, the gate and the residual and skip
sums, is two hand-written passes on CUDA tensors (``cuda_wn``,
``csrc/waveglow_wn.cu``) and eager ops on the CPU, with the same bits.

**Precision** (``dtype="bfloat16"``; ``"float32"`` computes everything
in float32).  R(·) is rounding to bfloat16.

- Weights of the upsampler, ``start``, the conditioning, the dilated and
  res/skip convolutions and ``end``: R(w); biases R(b), except
  ``end``'s, float32.  The conditioning's bias of layer i is
  R(b_cond_i + b_in_i) (the dilated convolution's folded in), the
  product runs without it.
- Products take bfloat16 operands and accumulate in float32.
- ``spect`` = R(R(upsample(R(mel))) + R(b_up)) (the bias added after
  the product, as PyTorch's cuDNN path adds one).
- WN of flow k: x = R(start(R(x₀))); per layer z = R(R(cond_i(spect)) +
  R(dilated_i(x))), acts = R(R(tanh z₁) · R(sigmoid z₂)), rs =
  R(res_skip_i(acts)), x = R(x + rs_res), skip = R(skip + rs_skip) (the
  first layer's skip is rs_skip itself).  (b, s) = end(skip) in float32
  from the bfloat16 operands.
- The coupling, the invertible convolutions (W⁻¹ made once, in float64,
  kept in float32), the noise and the audio are float32.

**Rows of unequal length** are zero-padded to the longest mel; the
padded positions of the WN's residual stream are zeroed before each
dilated convolution, so every row gives what it gives alone, and each
waveform is cut to ``frames · hop`` samples.

While a ``torch.profiler`` session runs, a call records the spans
``waveglow.upsample`` and ``waveglow.flows`` and ``waveglow`` stamps
(``utils/profiling.py``): a device mark at the call's start, after the
upsampling and after each flow (CUDA events; the host clock on the
CPU), with the call's rows and real group positions;
:func:`phase_breakdown` reduces them.  Off, it records and launches
nothing of the kind.  ``WaveGlowVocoder.calls`` counts its calls.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling
from ..utils.backend import load_device
from ..utils.profiling import annotate
from . import cuda_wn

UPSAMPLE_KERNEL = 1024
HOP = 256
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Invertible1x1Conv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv1d(c, c, 1, bias=False)


class WN(nn.Module):
    """One coupling's network (``glow.py`` ``WN``), weight norm folded."""

    def __init__(self, n_in_channels: int, n_mel_channels: int,
                 n_layers: int, n_channels: int, kernel_size: int):
        super().__init__()
        if kernel_size % 2 != 1 or n_channels % 2 != 0:
            raise ValueError("WN needs an odd kernel_size and even n_channels")
        self.n_layers, self.n_channels = n_layers, n_channels
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        self.start = nn.Conv1d(n_in_channels, n_channels, 1)
        self.end = nn.Conv1d(n_channels, 2 * n_in_channels, 1)
        self.cond_layer = nn.Conv1d(n_mel_channels,
                                    2 * n_channels * n_layers, 1)
        for i in range(n_layers):
            d = 2 ** i
            self.in_layers.append(nn.Conv1d(
                n_channels, 2 * n_channels, kernel_size, dilation=d,
                padding=(kernel_size * d - d) // 2))
            out = 2 * n_channels if i < n_layers - 1 else n_channels
            self.res_skip_layers.append(nn.Conv1d(n_channels, out, 1))


class WaveGlow(nn.Module):
    """The published model's modules (``glow.py`` ``WaveGlow``); the
    arguments are ``config.json``'s ``waveglow_config``."""

    def __init__(self, n_mel_channels: int, n_flows: int, n_group: int,
                 n_early_every: int, n_early_size: int, WN_config: dict):
        super().__init__()
        if n_group % 2 != 0:
            raise ValueError("n_group must be even")
        self.n_mel_channels, self.n_flows, self.n_group = (
            n_mel_channels, n_flows, n_group)
        self.n_early_every, self.n_early_size = n_early_every, n_early_size
        self.upsample = nn.ConvTranspose1d(n_mel_channels, n_mel_channels,
                                           UPSAMPLE_KERNEL, stride=HOP)
        self.WN = nn.ModuleList()
        self.convinv = nn.ModuleList()
        n_half, n_rem = n_group // 2, n_group
        for k in range(n_flows):
            if self.adds_noise(k):
                n_half -= n_early_size // 2
                n_rem -= n_early_size
            self.convinv.append(Invertible1x1Conv(n_rem))
            self.WN.append(WN(n_half, n_mel_channels * n_group, **WN_config))
        self.n_remaining_channels = n_rem

    def adds_noise(self, k: int) -> bool:
        """Whether the reverse pass adds noise channels after flow k."""
        return k % self.n_early_every == 0 and k > 0


class _Flow:
    """One flow's weights as the served pass uses them (module docstring,
    Precision)."""

    def __init__(self, wn: WN, convinv: Invertible1x1Conv, dt, device):
        def w(t):
            return t.detach().to(device, dt)

        def w1(conv):          # a 1×1 convolution's weight as (out, in)
            return w(conv.weight[..., 0])

        nc = wn.n_channels
        self.start_w, self.start_b = w1(wn.start), w(wn.start.bias)
        cw, cb = wn.cond_layer.weight[..., 0], wn.cond_layer.bias
        self.cond_w, self.cond_b, self.in_w, self.rs_w, self.rs_b = (
            [], [], [], [], [])
        for i, (inl, rs) in enumerate(zip(wn.in_layers, wn.res_skip_layers)):
            sl = slice(2 * nc * i, 2 * nc * (i + 1))
            self.cond_w.append(w(cw[sl]))
            self.cond_b.append(w(cb[sl].float() + inl.bias.float()))
            # (out, in, 1, k): the convolution on the channels-last view
            self.in_w.append(w(inl.weight[:, :, None, :]).contiguous(
                memory_format=torch.channels_last))
            self.rs_w.append(w1(rs))
            self.rs_b.append(w(rs.bias))
        # end: bfloat16-valued operands, float32 product and bias
        self.end_w = w1(wn.end).float()
        self.end_b = wn.end.bias.detach().to(device, torch.float32)
        W = convinv.conv.weight[..., 0].detach().to(device, torch.float64)
        self.w_inv = torch.linalg.inv(W).float()


def _mark(device: torch.device):
    if device.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter_ns()


def phase_breakdown(marks: list) -> dict:
    """Microseconds of one call between its marks: ``upsample`` (start to
    after the upsampling), ``flow.<k>`` for each flow in the order run,
    ``flows`` their sum and ``total`` (first mark to last)."""
    if isinstance(marks[0], int):
        d = [(b - a) * 1e-3 for a, b in zip(marks, marks[1:])]
    else:
        marks[-1].synchronize()
        d = [a.elapsed_time(b) * 1e3 for a, b in zip(marks, marks[1:])]
    n = len(d) - 1
    out = {"upsample": d[0], "flows": sum(d[1:]), "total": sum(d)}
    out.update({f"flow.{n - 1 - j}": t for j, t in enumerate(d[1:])})
    return out


class WaveGlowVocoder:
    """Serves a :class:`WaveGlow` (module docstring): ``dtype``
    ``"bfloat16"`` or ``"float32"``, ``sigma`` the noise's scale."""

    def __init__(self, model: WaveGlow, *, dtype: str = "bfloat16",
                 sigma: float = 0.6, device=None):
        if dtype not in DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}: expected "
                             f"{sorted(DTYPES)}")
        self.dtype, self.sigma = dtype, float(sigma)
        self.calls = 0
        self._set(model, device)

    def _set(self, model: WaveGlow, device) -> None:
        self.device = (next(model.parameters()).device if device is None
                       else load_device(device))
        self.model = model.to(self.device).eval()
        dt = DTYPES[self.dtype]
        self._dt = dt
        self._up_w = model.upsample.weight.detach().to(dt)
        self._up_b = model.upsample.bias.detach().to(dt)
        self.flows = [_Flow(wn, ci, dt, self.device)
                      for wn, ci in zip(model.WN, model.convinv)]

    def to(self, device) -> "WaveGlowVocoder":
        self._set(self.model, device)
        return self

    # ----------------------------------------------------------- stages
    def upsample(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mel, T) zero-padded mels → ``spect`` (B, T·hop/n_group,
        n_mel·n_group)."""
        m = self.model
        B, n_mel, T = mel.shape
        L = T * HOP // m.n_group
        up = F.conv_transpose1d(mel.to(self._dt), self._up_w, stride=HOP)
        spect = torch.empty((B, L, n_mel, m.n_group), dtype=self._dt,
                            device=mel.device)
        torch.add(up[..., : T * HOP].unflatten(-1, (L, m.n_group))
                  .permute(0, 2, 1, 3), self._up_b.view(1, 1, n_mel, 1),
                  out=spect)
        return spect.flatten(2)

    def _dilated(self, x: torch.Tensor, w: torch.Tensor,
                 d: int) -> torch.Tensor:
        """x (B, L, C) → the dilated convolution (B, L, C_out), as a cuDNN
        convolution on the channels-last view, no bias."""
        k = w.shape[-1]
        y = F.conv2d(x.transpose(1, 2).unsqueeze(2), w, None,
                     padding=(0, (k * d - d) // 2), dilation=(1, d))
        return y.squeeze(2).transpose(1, 2)

    def wn(self, f: _Flow, a0: torch.Tensor, spect: torch.Tensor,
           pad: torch.Tensor | None) -> torch.Tensor:
        """The flow's WN: ``end``'s output (B, L, 2·n_half), float32.
        Between a layer's products, the gate and the residual pass
        (``cuda_wn``): one kernel launch each on CUDA tensors, the eager
        ops on the CPU."""
        if a0.is_cuda:
            gate, residual = cuda_wn.cuda_gate, cuda_wn.cuda_residual
        else:
            gate, residual = cuda_wn.gate_reference, cuda_wn.residual_reference
        x = F.linear(a0.to(self._dt), f.start_w, f.start_b)
        if pad is not None:
            x = x.masked_fill(pad, 0.0)
        skip = None
        for i in range(len(f.in_w)):
            z = F.linear(spect, f.cond_w[i], f.cond_b[i])
            acts = gate(z, self._dilated(x, f.in_w[i], 2 ** i))
            rs = F.linear(acts, f.rs_w[i], f.rs_b[i])
            # zeroes x's padded positions for the next layer
            x, skip = residual(rs, x, skip, pad)
        return F.linear(skip, f.end_w, f.end_b)

    def reverse_flow(self, k: int, audio: torch.Tensor, spect: torch.Tensor,
                     pad: torch.Tensor | None = None) -> torch.Tensor:
        """Flow ``k`` in reverse: audio (B, L, C) float32 → (B, L, C)."""
        f = self.flows[k]
        h = audio.shape[-1] // 2
        a0, a1 = audio[..., :h], audio[..., h:]
        e = self.wn(f, a0, spect, pad)
        a1 = (a1 - e[..., :h]) * torch.exp(-e[..., h:])
        return torch.cat([a0, a1], -1) @ f.w_inv.T

    def _noise(self, noise, P: list, generator) -> torch.Tensor:
        """Each row's noise (module docstring), (B, max P, n_group)
        float32 on the device, zero past a row's positions."""
        C = self.model.n_group
        if noise is None:
            noise = [torch.randn((C, p), generator=generator,
                                 device=None if generator is None
                                 else generator.device) for p in P]
        if len(noise) != len(P):
            raise ValueError(f"{len(noise)} noise tensors for {len(P)} mels")
        rows = []
        for z, p in zip(noise, P):
            z = torch.as_tensor(z)
            if z.dim() != 2 or z.shape[0] != C or z.shape[1] < p:
                raise ValueError(f"a row's noise must be ({C}, >= {p}), "
                                 f"got {tuple(z.shape)}")
            rows.append(z[:, :p].T.to(self.device, torch.float32))
        return nn.utils.rnn.pad_sequence(rows, batch_first=True)

    @torch.no_grad()
    def infer_batch(self, mels, noise=None, sigma: float | None = None,
                    generator: torch.Generator | None = None) -> list:
        """Mels (n_mel, T_i) → waveforms (T_i·hop,) float32 on the device,
        one pass for all (module docstring); ``noise``: one tensor a
        row, or None to draw it from ``generator``; ``sigma`` defaults to
        the vocoder's."""
        m = self.model
        sigma = self.sigma if sigma is None else float(sigma)
        self.calls += 1
        marks = [] if profiling.on() else None
        if marks is not None:
            marks.append(_mark(self.device))
        mels = [torch.as_tensor(x).to(self.device, torch.float32)
                for x in mels]
        T = [x.shape[1] for x in mels]
        P = [t * HOP // m.n_group for t in T]
        z = self._noise(noise, P, generator)
        with annotate("waveglow.upsample"):
            batch = torch.stack([F.pad(x, (0, max(T) - x.shape[1]))
                                 for x in mels])
            spect = self.upsample(batch)
            L = spect.shape[1]
            pad = None
            if min(P) < L:
                pad = (torch.arange(L, device=self.device)[None, :, None]
                       >= torch.tensor(P, device=self.device)[:, None, None])
        if marks is not None:
            marks.append(_mark(self.device))
        with annotate("waveglow.flows"):
            n_rem = m.n_remaining_channels
            audio = sigma * z[..., :n_rem]
            c = n_rem
            for k in reversed(range(m.n_flows)):
                audio = self.reverse_flow(k, audio, spect, pad)
                if m.adds_noise(k):
                    e = m.n_early_size
                    audio = torch.cat([sigma * z[..., c: c + e], audio], -1)
                    c += e
                if marks is not None:
                    marks.append(_mark(self.device))
        if marks is not None:
            profiling.RECORDER.stamp(
                "waveglow", marks, len(marks), phase_breakdown,
                info={"rows": len(mels), "positions": sum(P)})
        wav = audio.flatten(1)
        return [wav[i, : t * HOP] for i, t in enumerate(T)]
