"""The port's audio ops (msa_tts_tpu_torch/ops/audio.py) against the JAX
package's: STFT/ISTFT, the HTK filterbank and its pseudo-inverse at
1e-6, and Griffin-Lim from the same initial phase at 1e-4 × peak (four
iterations of f32 FFT round trips)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.ops import audio as JA
from msa_tts_tpu_torch.ops import audio as A

AP = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
          f_min=0.0, f_max=8000.0, n_mels=20, griffinlim_iters=4)


def _sig(n=4000, seed=0):
    rs = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (np.sin(2 * np.pi * 440 * t) + 0.1 * rs.standard_normal(n)
            ).astype(np.float32)


def test_hann_window():
    np.testing.assert_allclose(A.hann_window(400).numpy(),
                               np.asarray(JA.hann_window(400)), atol=1e-7)
    np.testing.assert_allclose(A.hann_window(400).numpy(),
                               torch.hann_window(400).numpy(), atol=1e-6)


@pytest.mark.parametrize("win_length", [512, 400])
def test_stft_matches_jax_and_round_trips(win_length):
    x = _sig()
    spec = A.stft(torch.from_numpy(x), 512, win_length, 128, power=None)
    ref = JA.stft(jnp.asarray(x), 512, win_length, 128, power=None)
    peak = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(spec.numpy(), np.asarray(ref),
                               atol=1e-6 * peak)
    back = A.istft(spec, 512, win_length, 128, length=len(x))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    jback = JA.istft(ref, 512, win_length, 128, length=len(x))
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), atol=1e-6)


def test_stft_power_and_batch():
    x = np.stack([_sig(3000, 1), _sig(3000, 2)])
    p = A.stft(torch.from_numpy(x), 512, 512, 128, power=2.0)
    ref = JA.stft(jnp.asarray(x), 512, 512, 128, power=2.0)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref),
                               atol=1e-6 * float(np.asarray(ref).max()))


def test_mel_filterbank_and_pinv():
    args = (AP["n_fft"] // 2 + 1, AP["f_min"], AP["f_max"], AP["n_mels"],
            AP["sample_rate"])
    fb = A.mel_filterbank(*args)
    ref = JA.mel_filterbank(*args, mel_scale="htk", norm=None)
    assert fb.dtype == np.float32 and fb.shape == ref.shape
    np.testing.assert_allclose(fb, ref, atol=1e-6)
    np.testing.assert_allclose(A._mel_fbank_pinv(*args),
                               JA._mel_fbank_pinv(*args), atol=1e-6)


def _jax_phase(shape):
    """The phase griffin_lim draws when given no rng (PRNGKey(0))."""
    return np.array(jax.random.uniform(
        jax.random.PRNGKey(0), shape, minval=-math.pi, maxval=math.pi
    ))


@pytest.mark.parametrize("T", [3, 40])
def test_griffinlim_logmelspec_matches_jax(T):
    """From the same initial phase; T = 3 exercises the min-frames edge
    pad."""
    logmel = (np.random.default_rng(T).standard_normal((AP["n_mels"], T))
              * 0.5 - 3.0).astype(np.float32)
    ref = np.asarray(JA.griffinlim_logmelspec(jnp.asarray(logmel), AP))
    n_frames = max(T, AP["n_fft"] // AP["hop_length"] + 1)
    phase = _jax_phase((AP["n_fft"] // 2 + 1, n_frames))
    out = A.griffinlim_logmelspec(torch.from_numpy(logmel), AP,
                                  init_phase=torch.from_numpy(phase))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_griffinlim_batch_rows_match_single():
    """Leading dims are a batch: each row equals its own inversion."""
    logmel = (np.random.default_rng(0).standard_normal((2, AP["n_mels"], 16))
              - 3.0).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    batch = A.griffinlim_logmelspec(torch.from_numpy(logmel), AP,
                                    generator=g)
    for i in range(2):
        one = A.griffinlim_logmelspec(torch.from_numpy(logmel[i]), AP,
                                      generator=torch.Generator()
                                      .manual_seed(0))
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(),
                                   atol=1e-5)


def test_save_wav_round_trip(tmp_path):
    from scipy.io import wavfile

    x = 0.5 * _sig(2000)
    path = str(tmp_path / "a.wav")
    A.save_wav(path, x, 22050)
    sr, data = wavfile.read(path)
    assert sr == 22050 and data.dtype == np.int16
    np.testing.assert_allclose(data / 32767.0, x, atol=1e-4)
