"""The port's HTTP server (msa_tts_tpu_torch/server.py) on the CPU: the
dynamic batcher's semantics, the HTTP routes end to end, streaming
(per-stream and multiplexed), and the adapted-voice multiplexer.  Every
thread join and HTTP call has a timeout of 60 s or less."""

import http.client
import json
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV, config_from_params
from msa_tts_tpu_torch.server import DynamicBatcher, ServerStats, TTSServer
from msa_tts_tpu_torch.serving import AdaptiveTTS, Voice

SPK_DIM = 6
TIMEOUT = 60
AP = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
          f_min=0.0, f_max=8000.0, n_mels=20, griffinlim_iters=4)
MODEL = {
    "mask_padding": False, "n_mel_channels": 20, "n_frames_per_step": 2,
    "n_symbols": 200, "symbols_embedding_dim": 16,
    "encoder_n_convolutions": 2, "encoder_embedding_dim": 16,
    "encoder_kernel_size": 5, "speaker_emb_type": "static",
    "num_speakers": 1, "speaker_embedding_dim": SPK_DIM,
    "attention_rnn_dim": 20, "decoder_rnn_dim": 20, "prenet_dim": 12,
    "max_decoder_steps": 20, "gate_threshold": 0.9,
    "p_attention_dropout": 0.1, "p_decoder_dropout": 0.1,
    "decoder_no_early_stopping": True, "postnet_embedding_dim": 16,
    "postnet_kernel_size": 5, "postnet_n_convolutions": 2,
    "attention_params": {
        "attention_type": "ForwardAttention", "attention_dim": 16,
        "attention_location_n_filters": 8,
        "attention_location_kernel_size": 15,
    },
}
T_CAP = 16
ZERO = np.zeros(SPK_DIM, np.float32)


@pytest.fixture(scope="module")
def tts():
    model = Tacotron2NV(config_from_params(dict(MODEL)),
                        generator=torch.Generator().manual_seed(0))
    return AdaptiveTTS({"model": dict(MODEL), "audio_params": dict(AP)},
                       model)


def _post(port, path, body: bytes):
    rq = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(rq, timeout=TIMEOUT)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _stream(port, text, voice=None):
    """POST /synthesize_stream; returns (wav header, int16 PCM)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    body = {"text": text} if voice is None else {"text": text,
                                                 "voice": voice}
    conn.request("POST", "/synthesize_stream", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "audio/wav"
    header = resp.read(44)
    pcm = np.frombuffer(resp.read(), "<i2")
    conn.close()
    return header, pcm


# ----------------------------------------------------------- batcher unit
def test_batcher_coalesces_queued_requests():
    calls = []

    def synth(texts, voice, vocoder, pad_batch_to):
        calls.append((tuple(texts), voice, vocoder, pad_batch_to))
        return [t.upper() for t in texts]

    b = DynamicBatcher(synth, max_batch=8, window_ms=50)
    futs = [b.submit(f"t{i}") for i in range(4)]  # queued before start
    b.start()
    results = [f.result(timeout=10) for f in futs]
    b.stop()
    assert results == ["T0", "T1", "T2", "T3"]
    assert len(calls) == 1                    # one device call for all
    assert calls[0][3] == 4                   # snapped to the 4-bucket
    snap = b.stats.snapshot()
    assert snap["requests_total"] == 4
    assert snap["batches_total"] == 1
    assert snap["mean_batch_size"] == 4.0


def test_batcher_groups_by_voice_and_vocoder():
    calls = []

    def synth(texts, voice, vocoder, pad_batch_to):
        calls.append((tuple(texts), voice, vocoder))
        return list(texts)

    b = DynamicBatcher(synth, max_batch=8, window_ms=50)
    f1 = b.submit("a", voice="v1")
    f2 = b.submit("b", voice="v2")
    f3 = b.submit("c", voice="v1")
    b.start()
    for f in (f1, f2, f3):
        f.result(timeout=10)
    b.stop()
    keys = {(c[1], c[2]): c[0] for c in calls}
    assert keys[("v1", "griffinlim")] == ("a", "c")
    assert keys[("v2", "griffinlim")] == ("b",)
    assert len(calls) == 2


def test_batcher_error_propagates_per_request():
    def synth(texts, voice, vocoder, pad_batch_to):
        raise RuntimeError("device on fire")

    b = DynamicBatcher(synth, max_batch=4, window_ms=10)
    f = b.submit("x")
    b.start()
    with pytest.raises(RuntimeError, match="device on fire"):
        f.result(timeout=10)
    b.stop()
    assert b.stats.snapshot()["errors_total"] == 1


def test_bucket_snapping_and_ladder():
    b = DynamicBatcher(lambda *a: [], batch_buckets=(1, 2, 4, 8))
    assert [b.bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
    b16 = DynamicBatcher(lambda *a: [], max_batch=16)
    assert max(b16.batch_buckets) == 16 and b16.bucket(9) == 16
    assert DynamicBatcher(lambda *a: [], max_batch=8).batch_buckets == (
        1, 2, 4, 8)


def test_stats_percentiles():
    s = ServerStats()
    for ms in (1, 2, 3, 4, 100):
        s.record_request(ms / 1e3, error=False)
    snap = s.snapshot()
    assert snap["latency_p50_s"] == pytest.approx(0.003)
    assert snap["latency_p95_s"] == pytest.approx(0.1)


def test_batcher_stop_fails_queued_requests():
    """Requests still queued at shutdown get an immediate error, not a
    client-side timeout; submit() after stop() fails at once."""
    def synth(texts, voice, vocoder, pad_batch_to):
        time.sleep(0.3)
        return list(texts)

    b = DynamicBatcher(synth, max_batch=1, window_ms=0)
    b.start()
    f1 = b.submit("a")           # picked up, slow
    time.sleep(0.05)
    f2 = b.submit("b")
    f3 = b.submit("c")
    b.stop()
    done = 0
    for f in (f1, f2, f3):
        try:
            f.result(timeout=10)
            done += 1
        except RuntimeError as e:
            assert "shutting down" in str(e)
    assert done >= 1
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit("too late").result(timeout=5)


def test_queue_wait_spans_match_stats(tts):
    """Under a profiler, a tiny server's batcher records one
    ``serve.queue`` span a request and one ``serve.batch`` a group (the
    parent of the ``tts.*`` spans on its thread); the spans' p95 queue
    wait is the one ``/stats`` reports, within 1 ms."""
    from msa_tts_tpu_torch.utils.profiling import RECORDER

    server = TTSServer(tts, default_spk_emb=ZERO, window_ms=5.0,
                       max_batch=4)
    assert server.recorder is RECORDER is tts.recorder
    RECORDER.clear()
    server.batcher.start()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            futs = []
            for i in range(24):
                futs.append(server.batcher.submit(f"hello {i % 5}"))
                time.sleep(0.002 * (i % 3))
            for f in futs:
                f.result(timeout=TIMEOUT)
    finally:
        server.batcher.stop()
    spans = list(RECORDER.spans)
    RECORDER.clear()
    queue = [s for s in spans if s.name == "serve.queue"]
    batches = {s.sid: s for s in spans if s.name == "serve.batch"}
    assert len(queue) == 24 and len({s.ident for s in queue}) == 24
    assert sum(s.rows for s in batches.values()) == 24
    assert sum(s.name == "serve.submit" for s in spans) == 24
    decodes = [s for s in spans if s.name == "tts.decode"]
    assert len(decodes) == len(batches)
    for s in spans:
        if s.name in ("tts.g2p", "tts.inputs", "tts.sync", "tts.to_host"):
            assert s.parent in batches
    waits = sorted((s.end_ns - s.start_ns) * 1e-9 for s in queue)
    p95 = waits[min(len(waits) - 1, int(0.95 * len(waits)))]
    snap = server.stats.snapshot()
    assert abs(p95 - snap["queue_wait_p95_s"]) < 1e-3
    assert snap["queue_wait_p50_s"] <= snap["queue_wait_p95_s"]


# --------------------------------------------------------- http end-to-end
def test_http_server_end_to_end(tts):
    server = TTSServer(tts, default_spk_emb=ZERO, window_ms=10.0)
    port = server.start()
    try:
        health = _get(port, "/health")
        assert health["status"] == "ok"
        assert health["decode_backend"] == "auto"
        assert health["device"] == "cpu"
        assert health["stream_multiplex"] == 0
        with _post(port, "/synthesize",
                   json.dumps({"text": "hello world"}).encode()) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "audio/wav"
            body = r.read()
        hop = AP["hop_length"]
        n_frames = MODEL["max_decoder_steps"] * MODEL["n_frames_per_step"]
        assert body[:4] == b"RIFF"
        assert len(body) == 44 + 2 * hop * (n_frames - 1)

        results = []

        def fire(i):
            with _post(port, "/synthesize", json.dumps(
                    {"text": f"hello number {i}"}).encode()) as rr:
                results.append((rr.status, rr.read()[:4]))

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert len(results) == 4
        assert all(s == 200 and h == b"RIFF" for s, h in results)

        snap = _get(port, "/stats")
        assert snap["requests_total"] == 5
        assert snap["errors_total"] == 0
        assert snap["batches_total"] <= snap["requests_total"]

        for bad in (b'{"nope": 1}',
                    json.dumps({"text": "hi", "voice": "ghost"}).encode()):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(port, "/synthesize", bad)
            assert ei.value.code == 400
        assert _get(port, "/voices")["voices"] == []
    finally:
        server.stop()


def test_post_rejects_non_object_json(tts):
    server = TTSServer(tts, default_spk_emb=ZERO, window_ms=1.0)
    port = server.start()
    try:
        for body in (b'"hello"', b"[1, 2]", b"42"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(port, "/synthesize", body)
            assert ei.value.code == 400, body
    finally:
        server.stop()


def test_http_streaming_endpoint(tts):
    """POST /synthesize_stream: a chunked WAV whose PCM payload is the
    whole utterance, the same samples synthesize_stream gives."""
    server = TTSServer(tts, default_spk_emb=ZERO, window_ms=5.0,
                       text_pad_multiple=T_CAP)
    port = server.start()
    try:
        header, pcm = _stream(port, "hello world")
        assert header[:4] == b"RIFF" and header[8:12] == b"WAVE"
        assert struct.unpack("<I", header[24:28])[0] == AP["sample_rate"]
        want = np.concatenate(list(tts.synthesize_stream(
            "hello world", spk_emb=ZERO, text_pad_multiple=T_CAP)))
        assert pcm.shape == want.shape
        ref = (np.clip(want, -1, 1) * 32767.0).astype("<i2")
        np.testing.assert_array_equal(pcm, ref)
    finally:
        server.stop()


def test_unservable_vocoder_rejected_with_400(tts):
    """'none' (raw mel) and the not-ported neural vocoders give 400 on
    both endpoints."""
    server = TTSServer(tts, default_spk_emb=ZERO, window_ms=1.0)
    port = server.start()
    try:
        for path in ("/synthesize", "/synthesize_stream"):
            for voc in ("none", "wavernn", "nonsense"):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _post(port, path, json.dumps(
                        {"text": "hi", "vocoder": voc}).encode())
                assert ei.value.code == 400, (path, voc)
        assert server.servable_vocoders() == {"griffinlim"}
    finally:
        server.stop()


def test_attached_vocoders_are_served():
    """With a WaveRNN and a HiFi-GAN attached both become servable on
    both endpoints, and the PCM is the library call's for the request's
    seed (the JAX comparison of the same calls is in
    test_torch_serving.py and test_torch_stream.py)."""
    from torch_parity import vocoder_pairs

    model = Tacotron2NV(config_from_params(dict(MODEL)),
                        generator=torch.Generator().manual_seed(0))
    own = AdaptiveTTS({"model": dict(MODEL), "audio_params": dict(AP)},
                      model)
    for name, (_, voc) in vocoder_pairs(AP["n_mels"],
                                        AP["hop_length"]).items():
        own.attach_vocoder(name, voc)
    server = TTSServer(own, default_spk_emb=ZERO, window_ms=1.0)
    assert server.servable_vocoders() == {"griffinlim", "wavernn",
                                          "hifigan"}
    port = server.start()
    hop = AP["hop_length"]
    n_frames = MODEL["max_decoder_steps"] * MODEL["n_frames_per_step"]
    try:
        for voc, want in (("hifigan", n_frames * hop),
                          ("wavernn", (n_frames - 1) * hop)):
            with _post(port, "/synthesize", json.dumps(
                    {"text": "hello world", "vocoder": voc}).encode()) as r:
                assert r.status == 200
                body = r.read()
            pcm = np.frombuffer(body[44:], "<i2")
            assert len(pcm) == want, voc
            ref = own.synthesize_batch(
                ["hello world"], vocoder=voc, spk_emb=ZERO,
                text_pad_multiple=server.text_pad_multiple)[0]
            np.testing.assert_array_equal(
                pcm, (np.clip(np.asarray(ref, np.float32), -1, 1)
                      * 32767.0).astype("<i2"))
        header, pcm = _stream(port, "hello world")
        assert header[:4] == b"RIFF"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
        conn.request("POST", "/synthesize_stream", json.dumps(
            {"text": "hello world", "vocoder": "hifigan"}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert len(resp.read()) == 44 + 2 * n_frames * hop
        conn.close()
        assert _get(port, "/stats")["errors_total"] == 0
    finally:
        server.stop()


def test_streaming_requests_counted_in_stats(tts):
    server = TTSServer(tts, default_spk_emb=ZERO, window_ms=1.0)
    port = server.start()
    try:
        _stream(port, "hi")
        snap = _get(port, "/stats")
        assert snap["requests_total"] == 1
        assert snap["errors_total"] == 0
        # an unknown voice is a 400 at parse time, not counted
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
        conn.request("POST", "/synthesize_stream",
                     json.dumps({"text": "hi", "voice": "ghost"}),
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
        snap = _get(port, "/stats")
        assert snap["requests_total"] == 1
        assert snap["errors_total"] == 0
    finally:
        server.stop()


def test_encode_wav_clips_like_streaming(tts):
    server = TTSServer(tts, default_spk_emb=ZERO)
    loud = np.array([0.5, 1.5, -2.0, 0.0], np.float32)
    pcm = np.frombuffer(server.encode_wav(loud)[-8:], "<i2")
    np.testing.assert_allclose(pcm.astype(np.float32) / 32767.0,
                               np.clip(loud, -1.0, 1.0), atol=1e-4)


def test_warmup_without_default_voice(tts):
    """warmup uses a registered voice, and is a no-op without any."""
    TTSServer(tts, window_ms=1.0).warmup(["hi"])
    srv = TTSServer(tts, window_ms=1.0)
    srv.register_voice("only", Voice(tts.model.state_dict(), ZERO))
    srv.warmup(["hi"])


def _fake_voice(tts, seed):
    g = torch.Generator().manual_seed(seed)
    sd = {k: (v + 0.05 * torch.randn(v.shape, generator=g)
              if v.is_floating_point() and "running" not in k else v)
          for k, v in tts.model.state_dict().items()}
    return Voice(state_dict=sd,
                 spk_emb=np.random.RandomState(seed).randn(SPK_DIM)
                 .astype(np.float32))


def test_http_multiplexed_streaming_matches_solo_server(tts):
    """TTSServer(stream_multiplex=2): concurrent base-voice streams go
    through the mux, adapted-voice streams through the per-slot-weights
    mux, and each response equals a no-mux server's; /health and /stats
    report both muxes."""
    voice = _fake_voice(tts, 41)
    ref_srv = TTSServer(tts, default_spk_emb=ZERO, text_pad_multiple=T_CAP)
    ref_srv.register_voice("v1", voice)
    srv = TTSServer(tts, default_spk_emb=ZERO, text_pad_multiple=T_CAP,
                    stream_multiplex=2, stream_mux_t_cap=T_CAP)
    assert srv.adapted_mux is None            # built on register_voice
    srv.register_voice("v1", voice)
    ref_port, port = ref_srv.start(), srv.start()
    try:
        health = _get(port, "/health")
        assert health["stream_multiplex"] == 2
        assert health["stream_mux_backend"] == "torch"
        assert health["stream_mux_adapted"] == 2
        reqs = [("hi there", None), ("ok then", None), ("hi there", "v1"),
                ("ok then", "v1")]
        refs = [_stream(ref_port, t, v)[1] for t, v in reqs]
        results = {}
        threads = [threading.Thread(
            target=lambda i=i, r=r: results.__setitem__(
                i, _stream(port, *r)[1]))
            for i, r in enumerate(reqs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(results[i], refs[i])
        assert not np.array_equal(refs[0], refs[2])   # the voice differs
        stats = _get(port, "/stats")
        for key in ("stream_mux", "adapted_mux"):
            assert stats[key]["admitted_total"] == 2
            assert stats[key]["completed_total"] == 2
    finally:
        srv.stop()
        ref_srv.stop()


def test_adapted_mux_without_base_multiplex():
    """stream_mux_adapted works alone (no base mux), and is only built
    once a voice is registered."""
    model = Tacotron2NV(config_from_params(dict(MODEL)),
                        generator=torch.Generator().manual_seed(0))
    tts = AdaptiveTTS({"model": dict(MODEL), "audio_params": dict(AP)},
                      model)
    srv = TTSServer(tts, stream_mux_adapted=2, stream_mux_t_cap=T_CAP)
    assert srv.stream_mux is None and srv.adapted_mux is None
    srv.register_voice("v1", _fake_voice(tts, 7))
    assert srv.adapted_mux is not None and srv.adapted_mux.B == 2
    assert srv.adapted_mux.backend == "torch"
    srv.stop()


def test_main_rejects_voices_dir(tmp_path):
    """A --voices_dir that is not a directory raises before the model
    loads (tests/test_torch_adapt.py registers the voices of one)."""
    from msa_tts_tpu_torch.server import main

    with pytest.raises(FileNotFoundError, match="voices_dir"):
        main(["--experiment_path", str(tmp_path), "--voices_dir",
              str(tmp_path / "missing")])


@pytest.mark.parametrize("decode_backend", ["auto", "torch"])
def test_base_mux_follows_the_decode_backend(decode_backend):
    """The base mux decodes as the model's decode_backend names it (on a
    CPU both resolve to the plain segment), and /health reports the
    resolved engine."""
    model = Tacotron2NV(config_from_params(dict(MODEL)),
                        generator=torch.Generator().manual_seed(0))
    tts = AdaptiveTTS({"model": dict(MODEL), "audio_params": dict(AP),
                       "decode_backend": decode_backend}, model)
    srv = TTSServer(tts, default_spk_emb=ZERO, stream_multiplex=2,
                    stream_mux_t_cap=T_CAP)
    port = srv.start()
    try:
        assert srv.stream_mux.backend == "torch"
        health = _get(port, "/health")
        assert health["decode_backend"] == decode_backend
        assert health["stream_mux_backend"] == "torch"
    finally:
        srv.stop()
