"""The port's stream multiplexer (msa_tts_tpu_torch/stream_mux.py) on
the CPU, through its plain torch engine.

The contract: a multiplexed stream gives the same audio as the same
request through ``AdaptiveTTS.synthesize_stream`` at the mux's padded
text length, whatever slot it lands in, whoever its neighbours are and
whenever it joins.  The engine runs the same B = 1 ops as the solo
path, so the tolerance is 1e-6 (equal in practice).  Every thread join
and HTTP call has a timeout."""

import threading
import time

import numpy as np
import pytest
import torch

from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV, config_from_params
from msa_tts_tpu_torch.serving import AdaptiveTTS, Voice
from msa_tts_tpu_torch.stream_mux import MuxSaturated, StreamMultiplexer

# tests/test_stream_mux.py's tiny config
AP = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
          f_min=0.0, f_max=8000.0, n_mels=20, griffinlim_iters=4)
MODEL = {
    "mask_padding": False, "n_mel_channels": 20, "n_frames_per_step": 2,
    "n_symbols": 200, "symbols_embedding_dim": 16,
    "encoder_n_convolutions": 2, "encoder_embedding_dim": 16,
    "encoder_kernel_size": 5, "speaker_emb_type": "static",
    "num_speakers": 1, "speaker_embedding_dim": 6, "attention_rnn_dim": 20,
    "decoder_rnn_dim": 20, "prenet_dim": 12, "max_decoder_steps": 24,
    # above every gate probability of these random weights (<= 0.57):
    # the streams run all 24 steps
    "gate_threshold": 0.9, "p_attention_dropout": 0.1,
    "p_decoder_dropout": 0.1, "decoder_no_early_stopping": True,
    "postnet_embedding_dim": 16, "postnet_kernel_size": 5,
    "postnet_n_convolutions": 2,
    "attention_params": {
        "attention_type": "ForwardAttention", "attention_dim": 16,
        "attention_location_n_filters": 8,
        "attention_location_kernel_size": 15, "windowing": False,
        "norm": "softmax", "forward_attn": True, "trans_agent": True,
        "forward_attn_mask": False,
    },
}
T_CAP = 16
SEG = 4
TIMEOUT = 60


def _tts(seed=3, **over):
    mp = dict(MODEL, **over)
    model = Tacotron2NV(config_from_params(dict(mp)),
                        generator=torch.Generator().manual_seed(seed))
    return AdaptiveTTS({"model": mp, "audio_params": dict(AP)}, model)


def _solo(tts, text, emb, vocoder="griffinlim", voice=None, seed=0):
    """The same request through synthesize_stream at the mux's padded
    text length and segment size."""
    return np.concatenate(list(tts.synthesize_stream(
        text, voice, spk_emb=emb, vocoder=vocoder, seed=seed,
        segment_steps=SEG, text_pad_multiple=T_CAP,
    )), axis=-1)


def _mux_out(mux, text, emb=None, vocoder="griffinlim", voice=None,
             seed=0):
    return np.concatenate(list(mux.stream(
        text, spk_emb=emb, voice=voice, vocoder=vocoder, seed=seed,
    )), axis=-1)


def _slow_ticks(mux, seconds=0.02) -> list:
    """Stretch every tick of ``mux`` (the math is untouched) so that
    streams started a few ms apart overlap; returns the list of active
    slot counts, one per tick."""
    seen, seg = [], mux.engine.seg

    def slow(active):
        seen.append(len(active))
        time.sleep(seconds)
        return seg(active)

    mux.engine.seg = slow
    return seen


def _run_concurrently(fns, stagger=0.0):
    results = {}
    threads = [threading.Thread(target=lambda i=i, f=f:
                                results.__setitem__(i, f()))
               for i, f in enumerate(fns)]
    for t in threads:
        t.start()
        time.sleep(stagger)
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a stream hung"
    return results


@pytest.fixture(scope="module")
def tts():
    return _tts()


@pytest.fixture(scope="module")
def mux(tts):
    m = StreamMultiplexer(tts, n_slots=3, t_cap=T_CAP, segment_steps=SEG)
    m.active_per_tick = _slow_ticks(m)
    yield m
    m.close()


def _emb(seed):
    return np.random.RandomState(seed).randn(6).astype(np.float32)


def test_auto_backend_on_cpu_is_torch(mux):
    assert mux.backend == "torch"
    assert mux.metrics()["backend"] == "torch"


def test_single_stream_matches_solo(tts, mux):
    want = _solo(tts, "hello world", _emb(0))
    got = _mux_out(mux, "hello world", _emb(0))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_concurrent_streams_each_match_solo(tts, mux):
    """Three texts and speakers live at once, joining staggered (other
    step phases): each equals its own solo run, mels and waveforms."""
    reqs = [("hi there", _emb(1), 0, "griffinlim"),
            ("longer one", _emb(2), 1, "none"),
            ("ok", _emb(3), 2, "griffinlim")]
    mux.active_per_tick.clear()
    got = _run_concurrently(
        [lambda r=r: _mux_out(mux, r[0], r[1], vocoder=r[3], seed=r[2])
         for r in reqs], stagger=0.05)
    for i, (text, emb, seed, voc) in enumerate(reqs):
        want = _solo(tts, text, emb, vocoder=voc, seed=seed)
        assert got[i].shape == want.shape
        np.testing.assert_allclose(got[i], want, atol=1e-6, rtol=0,
                                   err_msg=f"stream {i} ({text!r})")
    assert max(mux.active_per_tick) == 3     # all three were live at once


def test_more_streams_than_slots_queue_up(tts, mux):
    """A 4th stream on a 3-slot mux waits for a slot and still matches."""
    reqs = [(f"text {i}", _emb(10 + i)) for i in range(4)]
    mux.active_per_tick.clear()
    got = _run_concurrently([lambda r=r: _mux_out(mux, *r) for r in reqs])
    assert max(mux.active_per_tick) == 3
    assert mux.metrics()["queue_depth"] == 0
    for i, (text, emb) in enumerate(reqs):
        np.testing.assert_allclose(got[i], _solo(tts, text, emb),
                                   atol=1e-6, rtol=0)


def test_early_stopping_stream_matches_solo():
    """With early stopping and a gate that fires mid-stream, the stream
    retires its slot and still matches solo (the shared cursor's
    offline-trim bookkeeping).  These weights' gate probability climbs
    from 0.393 and first passes 0.4176 at step 6 (margin 1.3e-3)."""
    tts = _tts(seed=0, decoder_no_early_stopping=False,
               gate_threshold=0.4176)
    mux = StreamMultiplexer(tts, n_slots=2, t_cap=T_CAP, segment_steps=SEG)
    try:
        want = _solo(tts, "stop early", _emb(4), vocoder="none")
        assert 2 < want.shape[-1] < MODEL["max_decoder_steps"] * 2
        got = _mux_out(mux, "stop early", _emb(4), vocoder="none")
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert mux.metrics()["completed_total"] == 1
    finally:
        mux.close()


def test_text_longer_than_cap_rejected(mux):
    with pytest.raises(ValueError, match="t_cap"):
        mux.stream("this text is going to be far too long for the tiny "
                   "cap " * 3, spk_emb=np.zeros(6, np.float32))


def _hold(max_steps=2000):
    """A 1-slot mux whose only slot is held by a long stream."""
    tts = _tts(max_decoder_steps=max_steps)
    return StreamMultiplexer(tts, n_slots=1, t_cap=T_CAP, segment_steps=SEG,
                             backend="torch", max_pending=0)


def test_mux_backpressure_and_metrics():
    """max_pending bounds the queue: with every slot busy and the queue
    full, stream() raises MuxSaturated and metrics() counts it."""
    mux = _hold()
    try:
        emb = np.zeros(6, np.float32)
        mux.stream("hold it", spk_emb=emb)
        deadline = time.time() + TIMEOUT
        while time.time() < deadline:
            m = mux.metrics()
            if m["active_slots"] == 1 and m["queue_depth"] == 0:
                break
            time.sleep(0.01)
        else:
            pytest.fail("first stream was never admitted")
        with pytest.raises(MuxSaturated):
            mux.stream("too many", spk_emb=emb)
        m = mux.metrics()
        assert m["rejected_total"] == 1
        assert m["admitted_total"] == 1
        assert m["max_pending"] == 0
        assert m["ticks_total"] >= 0
    finally:
        mux.close()


def test_mux_backpressure_bounds_queue_with_free_slots():
    """A burst between worker ticks does not queue past max_pending plus
    the free slots, whether or not the first stream was admitted yet."""
    mux = _hold()
    try:
        emb = np.zeros(6, np.float32)
        mux.stream("hold it", spk_emb=emb)
        with pytest.raises(MuxSaturated):
            mux.stream("burst", spk_emb=emb)
        assert mux.metrics()["rejected_total"] == 1
    finally:
        mux.close()


def test_close_with_pending_stream_terminates_client():
    """close() ends active AND queued (never admitted) streams: no
    client blocks forever."""
    mux = _hold()
    mux.max_pending = None
    emb = np.zeros(6, np.float32)
    done = {}

    def consume(name, gen):
        done[name] = [np.asarray(c) for c in gen]

    ga = mux.stream("hold", spk_emb=emb)
    ta = threading.Thread(target=consume, args=("a", ga))
    ta.start()
    time.sleep(0.3)           # let A admit
    gb = mux.stream("wait", spk_emb=emb)
    tb = threading.Thread(target=consume, args=("b", gb))
    tb.start()
    time.sleep(0.1)
    mux.close()
    ta.join(timeout=30)
    tb.join(timeout=30)
    assert not ta.is_alive() and not tb.is_alive(), "a client hung"
    assert "b" in done        # terminated (possibly with zero chunks)


def _fake_voice(tts, seed):
    """An 'adapted' voice: the base weights perturbed as an inner loop
    would perturb them, and its own d-vector."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: (v + 0.05 * torch.randn(v.shape, generator=g)
              if v.is_floating_point() and "running" not in k else v)
          for k, v in tts.model.state_dict().items()}
    return Voice(state_dict=sd, spk_emb=_emb(seed))


def test_adapted_voices_match_solo():
    """per_slot_params=True: two adapted voices and a base-voice stream
    live at once, each slot under its own weights; each equals its solo
    stream, and an adapted voice differs from the base one."""
    tts = _tts()
    mux = StreamMultiplexer(tts, n_slots=3, t_cap=T_CAP, segment_steps=SEG,
                            backend="torch", per_slot_params=True)
    try:
        v1, v2 = _fake_voice(tts, 21), _fake_voice(tts, 22)
        reqs = [("first voice", v1, None), ("second one", v2, None),
                ("plain base", None, _emb(23))]
        seen = _slow_ticks(mux)
        got = _run_concurrently(
            [lambda r=r: _mux_out(mux, r[0], r[2], voice=r[1])
             for r in reqs], stagger=0.05)
        for i, (text, voice, emb) in enumerate(reqs):
            want = _solo(tts, text, emb, voice=voice)
            np.testing.assert_allclose(got[i], want, atol=1e-6, rtol=0,
                                       err_msg=f"stream {i} ({text!r})")
        assert max(seen) == 3
        base = _solo(tts, "first voice", v1.spk_emb)
        assert base.shape != got[0].shape or not np.allclose(base, got[0])
    finally:
        mux.close()


def test_adapted_voice_rejected_without_per_slot_params(tts, mux):
    with pytest.raises(ValueError, match="per_slot_params"):
        mux.stream("hello", voice=_fake_voice(tts, 31))


def test_backend_rules(tts):
    """cuda on CPU tensors raises; cuda with per-slot weights raises;
    auto on CPU tensors is torch; an unknown name raises."""
    with pytest.raises(ValueError):
        StreamMultiplexer(tts, n_slots=2, t_cap=T_CAP, backend="cuda")
    with pytest.raises(ValueError, match="per_slot_params"):
        StreamMultiplexer(tts, n_slots=2, t_cap=T_CAP, backend="cuda",
                          per_slot_params=True)
    with pytest.raises(ValueError, match="backend"):
        StreamMultiplexer(tts, n_slots=2, t_cap=T_CAP, backend="xla")
    m = StreamMultiplexer(tts, n_slots=2, t_cap=T_CAP, backend="auto",
                          per_slot_params=True)
    try:
        assert m.backend == "torch" and m.per_slot_params
    finally:
        m.close()


def test_stress_many_clients_short_switch_interval():
    """Twice as many concurrent clients as cores on a 2-slot mux, with a
    tiny interpreter switch interval: every stream ends, each equals its
    solo stream, and the counters balance (admitted == completed, no
    error, an empty queue), which a lost update would break."""
    import os
    import sys

    tts = _tts(max_decoder_steps=8)
    mux = StreamMultiplexer(tts, n_slots=2, t_cap=T_CAP, segment_steps=SEG)
    n = 2 * (os.cpu_count() or 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        texts = [f"client {i}" for i in range(n)]
        got = _run_concurrently([
            lambda t=t, i=i: _mux_out(mux, t, _emb(i), vocoder="none")
            for i, t in enumerate(texts)])
    finally:
        sys.setswitchinterval(old)
        mux.close()
    m = mux.metrics()
    assert m["admitted_total"] == m["completed_total"] == n
    assert m["errored_total"] == 0 and m["queue_depth"] == 0
    for i, t in enumerate(texts):
        np.testing.assert_array_equal(
            got[i], _solo(tts, t, _emb(i), vocoder="none"))
