"""The vocoders, and the one seam serving calls each through
(``AdaptiveTTS.attach_vocoder(name, vocoder)``; Griffin-Lim is attached
by default).  A vocoder has:

- ``name``, the name it is attached under by convention;
- ``tail_frames``: W frames give (W − ``tail_frames``)·hop samples, so
  that a stream needs ``vocode_ctx_frames >= 1`` if it is not 0;
- ``streams``: whether a stream may vocode it window by window;
- ``to(device)``: itself on ``device``;
- ``vocode(mels, generator, *, phase=None, noise=None)``: (n_mel, T_i)
  device mels → one waveform each (device tensors or host arrays), the
  noise (Griffin-Lim's starting phase) drawn from ``generator`` unless
  injected;
- ``stream_noise(seed, *, phase=None, noise=None)``: a function of a
  stream window's width giving the ``(generator, phase, noise)`` that
  ``vocode`` takes for it."""

import torch

SEAM = ("name", "tail_frames", "streams", "to", "vocode", "stream_noise")


class Vocoder:
    """No tail, streamed, and each window from a fresh generator seeded
    with the stream's seed (as the JAX package hands every window the
    same key) with the injected noise: the neural vocoders' defaults."""

    tail_frames = 0
    streams = True

    def stream_noise(self, seed: int, *, phase=None, noise=None):
        return lambda width: (torch.Generator().manual_seed(seed), None,
                              noise)
