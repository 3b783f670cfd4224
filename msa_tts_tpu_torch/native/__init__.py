"""The host C++ feature library (counterpart of
``msa_tts_tpu/native/__init__.py``, built from the port's own copy of
``feats.cpp``).

``extract_logmels_batch`` runs silence trimming, STFT, mel and log
compression for a batch of utterances in a C++ thread pool;
``resample_batch`` / ``resample`` is a polyphase resampler with
``scipy.signal.resample_poly``'s default filter; ``trim_slice`` the trim
bounds alone.  Their output equals the numpy path of ``ops/audio.py`` to
float32 rounding, and equals the JAX package's library bit for bit (the
same source).

The library is compiled with ``g++`` at first use into ``build/native/``
at the repository root, keyed by a hash of the source (a per-process
temporary name and an atomic rename, so that processes building at once
never load a half-written file).  Every entry point returns None when no
compiler is found or the build fails, and its callers then take the
numpy or scipy path: the library speeds the host pipeline up, it is
never a dependency.  ``CALLS`` counts the batches the library computed,
``build_seconds`` the time this process spent compiling it.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "feats.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib = None
_lib_failed = False
CALLS = 0                 # batches computed by the library (extract, resample)
build_seconds = 0.0       # time this process spent compiling it


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmsafeats_{tag}.so"


def _compile() -> Path | None:
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=180)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return so if so.exists() else None
    finally:
        build_seconds += time.perf_counter() - t0
    return so


def _bind(lib) -> None:
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    PP, PI64 = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)
    lib.msa_extract_batch.restype = I
    lib.msa_extract_batch.argtypes = [
        PP, PI64, I,                    # wavs, wav_lens, n_utts
        I, ctypes.c_float, I, I,        # trim: enable, ref_level_db, frame, hop
        I, I, I, I, I,                  # flavor, n_fft, win_length, hop, center
        P, I,                           # mel filterbank, n_mels
        PP, PI64, PI64, PI64,           # out mels, frames, trim start, end
        I,                              # n_threads
    ]
    lib.msa_trim.restype = None
    lib.msa_trim.argtypes = [P, I64, ctypes.c_float, I, I, PI64, PI64]
    lib.msa_resample_len.restype = I64
    lib.msa_resample_len.argtypes = [I64, I, I]
    lib.msa_resample_batch.restype = I
    lib.msa_resample_batch.argtypes = [PP, PI64, I, I, I, PP, I]


def get_lib():
    """The library, compiled at the first call if needed; None when it
    cannot be built or loaded."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _compile()
        try:
            lib = None if so is None else ctypes.CDLL(str(so))
        except OSError:
            lib = None
        if lib is None:
            _lib_failed = True
            return None
        _bind(lib)
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _flavor_config(audio_processor: str, audio_params: dict) -> dict:
    p = audio_params
    if audio_processor == "ap":
        return dict(flavor=0, n_fft=p["n_fft"], win_length=p["win_length"],
                    hop_length=p["hop_length"], center=1,
                    fb_kwargs=dict(mel_scale="htk", norm=None),
                    f_min=p["f_min"], f_max=p["f_max"])
    if audio_processor == "ap2":
        return dict(flavor=1, n_fft=p["n_fft"], win_length=p["win_size"],
                    hop_length=p["hop_size"],
                    center=int(p.get("center", False)),
                    fb_kwargs=dict(mel_scale="slaney", norm="slaney"),
                    f_min=p["fmin"], f_max=p["fmax"])
    raise ValueError(f"unknown audio_processor: {audio_processor}")


def _max_frames(n: int, cfg: dict) -> int:
    """The frame count of an untrimmed signal of ``n`` samples (a trimmed
    one has at most as many)."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    pad = (n_fft - hop) // 2 * 2 if cfg["flavor"] == 1 else 0
    pad += n_fft if cfg["center"] else 0
    total = n + pad
    return 0 if total < n_fft else 1 + (total - n_fft) // hop


def _ptrs(arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])


def _threads(n_threads: int | None) -> int:
    return min(os.cpu_count() or 1, 16) if n_threads is None else n_threads


def extract_logmels_batch(wavs: list, audio_processor: str,
                          audio_params: dict, *,
                          trim_margin_silence: bool = False,
                          ref_level_db: float = 26,
                          n_threads: int | None = None):
    """Threaded trim and log-mel of a batch of waveforms: ``(mels,
    slices)``, ``mels[i]`` the float32 ``(n_mels, T_i)`` log-mel of the
    (optionally trimmed) ``wavs[i]`` and ``slices[i] = (start, end)`` its
    trim slice into ``wavs[i]``; None without the library.  A signal too
    short to frame raises, as the numpy path does."""
    global CALLS
    lib = get_lib()
    if lib is None:
        return None
    from ..ops.audio import mel_filterbank

    cfg = _flavor_config(audio_processor, audio_params)
    n_mels = audio_params["n_mels"]
    fb = np.ascontiguousarray(mel_filterbank(
        cfg["n_fft"] // 2 + 1, cfg["f_min"], cfg["f_max"], n_mels,
        audio_params["sample_rate"], **cfg["fb_kwargs"]), dtype=np.float32)
    n = len(wavs)
    if n == 0:
        return [], []
    wavs32 = [np.ascontiguousarray(w, dtype=np.float32) for w in wavs]
    bufs = [np.empty(n_mels * max(_max_frames(len(w), cfg), 1), np.float32)
            for w in wavs32]
    out_frames = (ctypes.c_int64 * n)()
    t_start = (ctypes.c_int64 * n)()
    t_end = (ctypes.c_int64 * n)()
    rc = lib.msa_extract_batch(
        _ptrs(wavs32), (ctypes.c_int64 * n)(*[len(w) for w in wavs32]), n,
        int(trim_margin_silence), float(ref_level_db), 1024, 256,
        cfg["flavor"], cfg["n_fft"], cfg["win_length"], cfg["hop_length"],
        cfg["center"], fb.ctypes.data_as(ctypes.c_void_p), n_mels,
        _ptrs(bufs), out_frames, t_start, t_end, _threads(n_threads))
    if rc != 0:
        return None
    mels, slices = [], []
    for i in range(n):
        frames = int(out_frames[i])
        if frames == 0:
            raise ValueError(
                f"signal too short to frame: item {i} has "
                f"{int(t_end[i]) - int(t_start[i])} samples after trim "
                f"(< {cfg['n_fft']} required with center="
                f"{bool(cfg['center'])})")
        mels.append(bufs[i][: n_mels * frames].reshape(n_mels, frames))
        slices.append((int(t_start[i]), int(t_end[i])))
    CALLS += 1
    return mels, slices


def resample_batch(wavs: list, up: int, down: int, *,
                   n_threads: int | None = None) -> list | None:
    """Threaded polyphase resampling by the rational rate ``up / down``
    (reduced here), ``scipy.signal.resample_poly``'s default filter and
    alignment; None without the library."""
    global CALLS
    lib = get_lib()
    if lib is None:
        return None
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    n = len(wavs)
    if n == 0:
        return []
    wavs32 = [np.ascontiguousarray(w, dtype=np.float32) for w in wavs]
    outs = [np.empty(int(lib.msa_resample_len(len(w), up, down)), np.float32)
            for w in wavs32]
    rc = lib.msa_resample_batch(
        _ptrs(wavs32), (ctypes.c_int64 * n)(*[len(w) for w in wavs32]), n,
        up, down, _ptrs(outs), _threads(n_threads))
    if rc != 0:
        return None
    CALLS += 1
    return outs


def resample(wav: np.ndarray, orig_sr: int, target_sr: int):
    """One signal from ``orig_sr`` to ``target_sr``; None without the
    library."""
    out = resample_batch([wav], target_sr, orig_sr, n_threads=1)
    return None if out is None else out[0]


def trim_slice(wav: np.ndarray, ref_level_db: float = 26,
               frame_length: int = 1024, hop_length: int = 256):
    """The silence-trim bounds ``(start, end)`` (librosa.effects.trim
    semantics, as ``ops.audio.trim_margin_silence_slice``); None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(wav, dtype=np.float32)
    start, end = ctypes.c_int64(), ctypes.c_int64()
    lib.msa_trim(w.ctypes.data_as(ctypes.c_void_p), len(w),
                 float(ref_level_db), frame_length, hop_length,
                 ctypes.byref(start), ctypes.byref(end))
    return int(start.value), int(end.value)
