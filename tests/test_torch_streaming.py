"""PyTorch port: streaming encode/decode (``deploy/streaming.py``), the span
batcher and duplex sessions (``deploy/streaming_server.py``), and the codec
and streaming HTTP servers through ``deploy/http_client.py``, on the CPU
over an exported artifact with the JAX package's narrow weights. Streamed
decode equals the offline decode (fp32, exact mixers, 1e-5) and the JAX
package's (2e-4); streamed tokens equal an offline pass over the stream's
windows; the JAX package's streamers run the same spans over the port's
runtime."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.deploy.streaming import StreamingDecoder as JaxStreamingDecoder
from mqgan_tpu.deploy.streaming import StreamingEncoder as JaxStreamingEncoder
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu_torch.core.chunking import chunk_plan
from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.deploy import export, http_server, http_streaming
from mqgan_tpu_torch.deploy.http_client import CodecClient, CodecHTTPStatusError
from mqgan_tpu_torch.deploy.http_server import CodecHTTPServer, CodecHTTPService
from mqgan_tpu_torch.deploy.http_streaming import (StreamingHTTPServer,
                                                   StreamingHTTPService)
from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
from mqgan_tpu_torch.deploy.streaming import StreamingDecoder, StreamingEncoder
from mqgan_tpu_torch.deploy.streaming_server import StreamingCodecServer
from tests.test_torch_bridge import MELS, NARROW, narrow_jax_params, port_model

BUCKETS = (32, 64, 128)
T_DEC, T_ENC = 300, 260
STREAM_TOL = 1e-5  # exact fp32 mixers
DECODE_TOL = 2e-4


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    _, tree = narrow_jax_params()
    out = str(tmp_path_factory.mktemp("exp"))
    export.export_preencoder(port_model(tree), GeneratorConfig(**NARROW), out,
                             buckets=BUCKETS, verify=False)
    return out


@pytest.fixture(scope="module")
def rt(artifact):
    return ExportedPreEncoder(artifact, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(4).integers(0, 1000, T_DEC).astype(np.int32)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(5).standard_normal((T_ENC, MELS)).astype(np.float32)


def _padded(arr, pad=32):
    """The whole clip with a masked tail: the convention every window has."""
    t = arr.shape[0]
    x = np.zeros((1, t + pad) + arr.shape[1:], arr.dtype)
    x[0, :t] = arr
    return x, np.arange(t + pad)[None, :] >= t


def _drive(stream, data, chunks):
    outs, pos = [], 0
    for c in chunks:
        outs.append(stream.feed(data[pos:pos + c]))
        pos += c
    assert pos == len(data)
    outs.append(stream.flush())
    return np.concatenate(outs, axis=0)


def _even(n, c):
    return [c] * (n // c) + ([n % c] if n % c else [])


@pytest.mark.parametrize("chunk", [5, 37, T_DEC])
def test_streaming_decode_matches_offline_and_jax(rt, tokens, chunk):
    dec = StreamingDecoder.from_runtime(rt)
    assert dec.latency_frames == rt.decoder_halos[1] and dec.window == BUCKETS[-1]
    streamed = _drive(dec, tokens, _even(T_DEC, chunk))
    idx, mask = _padded(tokens)
    offline = rt.model.decode(torch.from_numpy(idx), torch.from_numpy(mask))
    np.testing.assert_allclose(streamed, offline[0, :T_DEC].numpy(),
                               atol=STREAM_TOL, rtol=STREAM_TOL)
    gen, tree = narrow_jax_params()
    want = np.asarray(_jax_decode(gen)({"params": tree}, jnp.asarray(idx),
                                       jnp.asarray(mask)))[0, :T_DEC]
    np.testing.assert_allclose(streamed, want, atol=DECODE_TOL, rtol=DECODE_TOL)


@functools.lru_cache(maxsize=None)
def _jax_decode(gen):
    return jax.jit(functools.partial(gen.apply, method=JaxPreEncoder.decode))


def stream_windows(t, window, halo):
    """The encoder stream's windows, (start, stop, keep_lo, keep_hi): whole
    windows [k * stride, k * stride + window), stride = window - 2 * halo,
    each kept from halo past its start (0 for the first) to halo before its
    end, and the last one to the clip end."""
    spans, emitted = [], 0
    while emitted < t:
        ws = max(0, emitted - halo)
        we = min(t, ws + window)
        up = t if we == t else we - halo
        spans.append((ws, we, emitted, up))
        emitted = up
    return spans


def _offline_encode(rt, mel, spans):
    """An offline pass over ``spans``, each padded to the window."""
    window = rt.buckets[-1]
    out = np.zeros(len(mel), np.int32)
    for ws, we, lo, hi in spans:
        x = np.zeros((1, window, MELS), np.float32)
        x[0, :we - ws] = mel[ws:we]
        out[lo:hi] = rt.encode(x, [we - ws])[0, lo - ws:hi - ws]
    return out


def test_streaming_encode_equals_its_windows_at_any_cadence(rt, mel):
    """Streamed tokens equal an offline pass over the stream's own
    position-determined windows, whatever the feed cadence. chunk_plan's
    windows start halo earlier (its first is window - halo long), so the
    CBAM gates pool over other frames there and a few tokens differ: the
    JAX package's docstring claims equality with chunk_plan, which holds
    only where window statistics match clip statistics."""
    window, halo = rt.buckets[-1], rt.encoder_halo
    want = _offline_encode(rt, mel, stream_windows(T_ENC, window, halo))
    for chunks in (_even(T_ENC, 1), _even(T_ENC, 17), [T_ENC]):
        enc = StreamingEncoder.from_runtime(rt)
        assert enc.latency_frames == window - halo
        np.testing.assert_array_equal(_drive(enc, mel, chunks), want)
    plan = [(s.start, s.stop, s.keep_lo, s.keep_hi)
            for s in chunk_plan(T_ENC, window, halo, halo, align=1)]
    print(f"{int((_offline_encode(rt, mel, plan) != want).sum())} of {T_ENC} "
          "tokens differ between chunk_plan's windows and the stream's")


def test_jax_streamers_run_the_same_spans(rt, tokens, mel):
    """The JAX package's streamers (numpy only) over the port's runtime emit
    what the port's own copies emit, chunk for chunk."""
    halo_l, halo_r = rt.decoder_halos

    def dec_fn(idx, mask):
        return rt.decode(idx, (~mask).sum(1).astype(np.int32))

    def enc_fn(x, mask):
        return rt.encode(x, (~mask).sum(1).astype(np.int32))

    chunks = [5, 60, 1, 90, 144]
    port = StreamingDecoder.from_runtime(rt)
    jaxs = JaxStreamingDecoder(dec_fn, halo_l, halo_r, rt.buckets[-1],
                               align=rt.halo_align, mel_channels=MELS)
    pos = 0
    for c in chunks + [None]:
        if c is None:
            a, b = port.flush(), jaxs.flush()
        else:
            a, b = port.feed(tokens[pos:pos + c]), jaxs.feed(tokens[pos:pos + c])
            pos += c
        np.testing.assert_array_equal(a, b)
    port = StreamingEncoder.from_runtime(rt)
    jaxs = JaxStreamingEncoder(enc_fn, rt.encoder_halo, rt.buckets[-1], MELS)
    np.testing.assert_array_equal(_drive(port, mel, _even(T_ENC, 40)),
                                  _drive(jaxs, mel, _even(T_ENC, 40)))


def test_batched_sessions_match_solo(rt, tokens, mel):
    solo_dec = _drive(StreamingDecoder.from_runtime(rt), tokens, _even(T_DEC, 23))
    solo_duplex = _drive(StreamingDecoder.from_runtime(rt),
                         _drive(StreamingEncoder.from_runtime(rt), mel, [T_ENC]), [T_ENC])
    results = {}
    with StreamingCodecServer.from_runtime(rt, max_batch=4, max_delay_ms=200.0) as srv:
        def run(name, stream, data, chunk):
            results[name] = _drive(stream, data, _even(len(data), chunk))

        threads = [threading.Thread(target=run, args=(f"dec{i}", srv.open_decoder(),
                                                      tokens, 23)) for i in range(3)]
        duplex = srv.open_duplex()
        assert duplex.latency_frames == (rt.buckets[-1] - rt.encoder_halo
                                         + rt.decoder_halos[1])
        threads.append(threading.Thread(target=run, args=("duplex", duplex, mel, 29)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        stats = srv.stats()
    for i in range(3):
        np.testing.assert_allclose(results[f"dec{i}"], solo_dec,
                                   atol=STREAM_TOL, rtol=STREAM_TOL)
    np.testing.assert_allclose(results["duplex"], solo_duplex,
                               atol=STREAM_TOL, rtol=STREAM_TOL)
    assert stats["decode"]["mean_batch_size"] > 1


def test_codec_http_server_answers_like_the_runtime(rt, mel):
    rng = np.random.default_rng(6)
    clips = [rng.standard_normal((n, MELS)).astype(np.float32)
             for n in (5, 31, 32, 50, 64, 100, 128, 77)]
    service = CodecHTTPService(runtime=rt, max_batch=8, max_delay_ms=300.0)
    with CodecHTTPServer(service) as srv:
        client = CodecClient(srv.url)
        health = client.health()
        assert health["buckets"] == list(BUCKETS) and health["device"] == "cpu"
        results = [None] * len(clips)

        def call(i):
            results[i] = client.reencode(clips[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(clips))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for clip, (toks, out) in zip(clips, results):
            want_toks, want = rt.reencode(clip[None])
            np.testing.assert_array_equal(toks, want_toks[0])
            np.testing.assert_allclose(out, want[0], atol=STREAM_TOL, rtol=STREAM_TOL)
        assert client.stats()["reencode"]["mean_batch_size"] > 1
        toks = client.encode(clips[3])
        np.testing.assert_array_equal(toks, rt.encode(clips[3][None])[0])
        np.testing.assert_allclose(client.decode(toks), rt.decode(toks[None])[0],
                                   atol=STREAM_TOL, rtol=STREAM_TOL)
        # a masked tail: the clip's first 20 frames
        np.testing.assert_array_equal(client.encode(clips[3], length=20)[:20],
                                      rt.encode(clips[3][None], [20])[0, :20])
        for call_, status in ((lambda: client.encode(np.zeros((129, MELS))), 413),
                              (lambda: client.encode(np.zeros((4, MELS + 1))), 400),
                              (lambda: client.decode(np.zeros((4,), np.float32)), 400),
                              (lambda: client.encode(clips[0], length=99), 400),
                              (lambda: client._post_clip("nope", clips[0], None), 404)):
            with pytest.raises(CodecHTTPStatusError) as e:
                call_()
            assert e.value.status == status


def test_streaming_http_server_sessions(rt, tokens, mel):
    solo_duplex = _drive(StreamingDecoder.from_runtime(rt),
                         _drive(StreamingEncoder.from_runtime(rt), mel, [T_ENC]), [T_ENC])
    solo_enc = _drive(StreamingEncoder.from_runtime(rt), mel, [T_ENC])
    solo_dec = _drive(StreamingDecoder.from_runtime(rt), tokens, [T_DEC])
    service = StreamingHTTPService(runtime=rt, stream_max_delay_ms=50.0)
    with StreamingHTTPServer(service) as srv:
        client = CodecClient(srv.url)
        with client.open_duplex() as s:
            assert s.window == BUCKETS[-1]
            got = _drive(s, mel, _even(T_ENC, 41))
            np.testing.assert_allclose(got, solo_duplex, atol=STREAM_TOL, rtol=STREAM_TOL)
            # flush reset the session: the same clip again gives the same
            np.testing.assert_allclose(_drive(s, mel, [T_ENC]), got,
                                       atol=STREAM_TOL, rtol=STREAM_TOL)
        with client.open_encoder() as s:
            np.testing.assert_array_equal(_drive(s, mel, _even(T_ENC, 64)), solo_enc)
        with client.open_decoder() as s:
            np.testing.assert_allclose(_drive(s, tokens, _even(T_DEC, 50)), solo_dec,
                                       atol=STREAM_TOL, rtol=STREAM_TOL)
            with pytest.raises(CodecHTTPStatusError) as e:
                s.feed(mel[:3])  # a decoder takes 1-D tokens
            assert e.value.status == 400
        assert client.stream_stats()["sessions"] == 0
        with pytest.raises(CodecHTTPStatusError) as e:
            s.feed(tokens[:3])  # closed
        assert e.value.status == 404
        np.testing.assert_array_equal(client.encode(mel[:50]), rt.encode(mel[None, :50])[0])
    swept = StreamingHTTPService(runtime=rt, idle_timeout_s=1e-9)
    try:
        first = swept.open_stream("decoder")["session"]
        swept.open_stream("decoder")
        assert first not in swept._sessions
    finally:
        swept.close()


def test_server_mains_default_to_cuda(artifact):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for main in (http_server.main, http_streaming.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--model_dir", artifact, "--port", "0"])
