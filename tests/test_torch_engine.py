"""The port's re-prefilling evaluation path against the JAX package, on
the CPU: k-means (the Lloyd loop started from JAX's own kmeans++ seeds),
keyframe selection, the event-summary batch, event relevance, minor-frame
pooling, the pixel-diff mask, splice + compaction, the whole Visual
Stream Compression of a turn, ``CogReasonerEngine.chat`` in FCC / AC /
NC / gt, and ``answer_generate.run_eval`` on a written clip.

Weights come from the JAX initializer through models/bridge.py (f32).
Tolerances: assignments, masks, token ids, selections and the summary
batch are IDENTICAL; centers within 1e-5 relative; similarities,
pooled features and spliced embeddings within 1e-5.

k-means draws its seeds from a ``torch.Generator``, which cannot
reproduce ``jax.random``. The engine tests therefore use videos of
static scenes: identical frames inside a scene have distance 0, so
kmeans++ never seeds two centers in one scene and the partition is the
same for every seed (asserted below over several seeds on both sides).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogstream_tpu.runtime.engine as jeng_mod
import cogstream_tpu_torch.runtime.engine as teng_mod
from cogstream_tpu.config import (CogReasonerConfig as JConfig,
                                  CompressionConfig as JCompression)
from cogstream_tpu.models import cogreasoner as jcr
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.ops import kmeans as jkm
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.runtime.engine import CogReasonerEngine as JEngine
from cogstream_tpu_torch.config import (CogReasonerConfig as TConfig,
                                        CompressionConfig as TCompression)
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import cogreasoner as tcr
from cogstream_tpu_torch.ops import kmeans as tkm
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.runtime.engine import CogReasonerEngine as TEngine

cv2 = pytest.importorskip("cv2")

TOL = dict(atol=1e-5, rtol=1e-5)
COMP = dict(frames_per_event=2, keyframes_per_event=1,
            min_events_for_compression=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JConfig.tiny(),
                               compression=JCompression(**COMP))
    tcfg = dataclasses.replace(TConfig.tiny(),
                               compression=TCompression(**COMP))
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    model = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, params),
                                           tcfg, device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, tcfg, params, model = setup
    return (JEngine(params, jcfg, JTok(image_token_id=1000)),
            TEngine(model, tcfg, TTok(image_token_id=1000)))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _clustered(rng, T, K, F):
    centers = rng.standard_normal((K, F)) * 4
    lab = np.sort(rng.integers(0, K, T))
    lab[:K] = np.arange(K)
    lab.sort()
    x = centers[lab] + rng.standard_normal((T, F)) * 0.3
    return x.astype(np.float32), np.arange(T, dtype=np.float32)


@pytest.mark.parametrize("seed,T,K,F", [(0, 12, 3, 8), (1, 30, 4, 16),
                                        (2, 20, 5, 6), (3, 9, 2, 24)])
def test_lloyd_from_jax_seeds(seed, T, K, F):
    """The port's Lloyd loop started from the kmeans++ seeds JAX draws
    (the key split of kmeans_with_time) gives JAX's assignments and
    centers. No cluster empties here, so no reseed draw is taken."""
    rng = np.random.default_rng(seed)
    x, ts = _clustered(rng, T, K, F)
    key = jax.random.PRNGKey(seed)
    init_key, _ = jax.random.split(key)
    _, idxs = jkm._kmeanspp_init(init_key, jnp.asarray(x), K)
    ref = jkm.kmeans_with_time(jnp.asarray(x), jnp.asarray(ts), K, key,
                               alpha=2.0, max_iters=30)
    got = tkm.lloyd_iterations(_t(x), _t(ts), _t(np.asarray(idxs)).long(),
                               30, 2.0)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(ref.assignments))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               rtol=1e-5, atol=1e-5 * np.abs(x).max())
    np.testing.assert_allclose(got.center_times.numpy(),
                               np.asarray(ref.center_times), rtol=1e-5)


def test_kmeans_with_time_is_kmeanspp_then_lloyd():
    """The whole port k-means is its kmeans++ draw followed by the Lloyd
    loop, reproducible from its generator; it rejects T <= K."""
    rng = np.random.default_rng(5)
    x, ts = _clustered(rng, 24, 4, 12)
    runs = [tkm.kmeans_with_time(_t(x), _t(ts), 4,
                                 torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0].assignments, runs[1].assignments)
    g = torch.Generator().manual_seed(1)
    init = tkm.kmeanspp_init(_t(x), 4, g)
    assert len(set(init.tolist())) == 4
    again = tkm.lloyd_iterations(_t(x), _t(ts), init, 30, 2.0, g)
    assert torch.equal(again.assignments, runs[2].assignments)
    assert torch.equal(again.centers, runs[2].centers)
    with pytest.raises(ValueError):
        tkm.kmeans_with_time(_t(x[:4]), _t(ts[:4]), 4)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_select_event_keyframes(k):
    """Per-cluster nearest members, invalid slots for small clusters,
    and ties (duplicate frames) broken toward the lower index as
    lax.top_k breaks them."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((10, 6)).astype(np.float32)
    x[4] = x[3]
    x[7] = x[6] = x[5]
    assign = np.array([0, 0, 1, 1, 1, 2, 2, 2, 0, 3], np.int32)
    centers = np.stack([x[assign == c].mean(0) for c in range(4)])
    ji, jv = jkm.select_event_keyframes(jnp.asarray(x), jnp.asarray(centers),
                                        jnp.asarray(assign), k=k)
    ti, tv = tkm.select_event_keyframes(_t(x), _t(centers), _t(assign), k=k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(np.where(tv.numpy(), ti.numpy(), -1),
                                  np.where(np.asarray(jv), np.asarray(ji), -1))


# ---------------------------------------------------------------------------
# compression pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_frames,pad_to", [(0, 0), (2, 8), (64, 4)])
def test_build_summary_batch_byte_exact(max_frames, pad_to):
    """The port's batch (never padded to more events) is the first K
    rows of JAX's, padded or not."""
    assign = np.array([0, 0, 1, 2, 1, 1, 2, 0, 0, 0], np.int32)
    ts = np.arange(10, dtype=np.float32) * 1.5
    args = (assign, ts, 3, 3)
    j = jcr.build_summary_batch(JTok(image_token_id=1000), *args,
                                max_frames_per_event=max_frames,
                                pad_events_to=pad_to)
    t = tcr.build_summary_batch(TTok(image_token_id=1000), *args,
                                max_frames_per_event=max_frames)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and a.shape[0] == 3
        np.testing.assert_array_equal(a, b[:3])


def test_event_relevance(setup):
    """Batched summary forwards + question forward (f32): sims within
    1e-5 of JAX's, pad rows included."""
    jcfg, tcfg, params, model = setup
    rng = np.random.default_rng(0)
    T, P, H = 6, 4, jcfg.text.hidden_size
    feats = rng.standard_normal((T * P, H)).astype(np.float32)
    assign = np.array([0, 0, 1, 1, 2, 2], np.int32)
    summary = jcr.build_summary_batch(JTok(image_token_id=1000), assign,
                                      np.arange(T, dtype=np.float32), P, 3,
                                      pad_events_to=4)
    q = np.asarray(JTok().encode("what happens at the start?"), np.int32)
    ref = jcr.event_relevance(params, jcfg, jnp.asarray(feats), summary, q)
    got = tcr.event_relevance(model, tcfg, _t(feats), summary, q)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_minor_frames_pooling_and_splice(setup):
    """minor_frame_mask, pool_minor_frames and splice_and_compact against
    JAX on the same inputs (masks and ids identical, floats 1e-5)."""
    jcfg, tcfg, params, model = setup
    rng = np.random.default_rng(1)
    T, P, H = 6, 4, jcfg.text.hidden_size
    assign = np.array([0, 0, 1, 1, 2, 2], np.int32)
    unimp = np.array([True, False, True])
    kidx = np.array([[1], [2], [5]], np.int32)
    kval = np.array([[True], [True], [False]])
    jm = jcr.minor_frame_mask(jnp.asarray(assign), jnp.asarray(unimp),
                              jnp.asarray(kidx), jnp.asarray(kval), T)
    tm = tcr.minor_frame_mask(_t(assign), _t(unimp), _t(kidx), _t(kval), T)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    feats = rng.standard_normal((T * P, H)).astype(np.float32)
    jp = jcr.pool_minor_frames(jnp.asarray(feats), jm, P)
    tp = tcr.pool_minor_frames(_t(feats), tm, P)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)

    S, img = 40, jcfg.image_token_index
    ids = rng.integers(16, 200, S).astype(np.int32)
    ids[3:3 + T * P // 2] = img           # 12 of the 24 features placed
    ids[20:32] = img
    valid = np.arange(S) < 36
    keep = rng.random(T * P) < 0.6
    jmi = jcr.splice_and_compact(params, jcfg, jnp.asarray(ids),
                                 jnp.asarray(valid), jp, jnp.asarray(keep))
    tmi = tcr.splice_and_compact(model, tcfg, _t(ids), _t(valid), tp,
                                 _t(keep))
    assert int(tmi.length) == int(jmi.length)
    assert int(tmi.last_index) == int(jmi.last_index)
    np.testing.assert_array_equal(tmi.positions.numpy(),
                                  np.asarray(jmi.positions))
    n = int(jmi.length)
    np.testing.assert_allclose(tmi.embeds.numpy()[:n],
                               np.asarray(jmi.embeds)[:n], **TOL)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pixel_diff_keep_mask_device(dtype):
    """The port's mask equals JAX's device mask and JAX's host mirror,
    byte for byte."""
    rng = np.random.default_rng(2)
    t, merged, row = 5, 6, 4 * 3 * 14 * 14
    if dtype == np.uint8:
        pv = rng.integers(0, 256, (t * merged, row), dtype=np.uint8)
        pv[merged:2 * merged] = pv[:merged]
        pv[3 * merged + 2] = pv[2 * merged + 2]
    else:
        pv = rng.normal(size=(t * merged, row)).astype(np.float32)
        pv[4 * merged:] = pv[3 * merged:4 * merged]
    minor = np.array([0, 1, 0, 0, 1], bool)
    for thr, mt in ((0.1, 1), (40.0, 2)):
        kw = dict(threshold=thr, min_tokens=mt, image_std=(0.5, 0.25, 0.5),
                  rescale_factor=1 / 255)
        got = tcr.pixel_diff_keep_mask(_t(pv), t, merged, _t(minor), **kw)
        ref = jcr.pixel_diff_keep_mask(jnp.asarray(pv), t, merged,
                                       jnp.asarray(minor), **kw)
        host = jcr.pixel_diff_keep_mask_host(pv, t, merged, minor, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), host)


def _scene_frames(n_scenes, per_scene, h, w, seed=0):
    rng = np.random.default_rng(seed)
    scenes = [rng.integers(0, 256, (h, w, 3), np.uint8)
              for _ in range(n_scenes)]
    return [scenes[i // per_scene] for i in range(n_scenes * per_scene)]


def test_run_visual_compression(setup, engines):
    """One turn's compression on a 3-scene video (events on: 6 frames, K
    = 3): the same partition for every seed on both sides, then keep
    mask, minor frames and sims identical / within 1e-5 of JAX's."""
    jcfg, tcfg, params, model = setup
    jeng, teng = engines
    frames = _scene_frames(3, 2, 56, 56)
    batch = teng.processor.image_processor([frames], ["video"])
    ts = np.arange(6, dtype=np.float32)
    q = np.asarray(JTok().encode("what is in the second scene?"), np.int32)
    jmm = jcr.encode_images(params, batch.pixel_values, batch.grid_sizes,
                            batch.merge_sizes, jcfg)
    tmm = tcr.encode_images(model, _t(batch.pixel_values), batch.grid_sizes,
                            batch.merge_sizes)
    np.testing.assert_allclose(tmm.numpy(), np.asarray(jmm), **TOL)
    P = tmm.shape[0] // 6

    def parts(assign):
        return sorted(tuple(np.nonzero(assign == k)[0])
                      for k in np.unique(assign))

    for s in range(3):
        ja = jkm.kmeans_with_time(jmm.reshape(6, P, -1), jnp.asarray(ts), 3,
                                  jax.random.PRNGKey(s)).assignments
        ta = tkm.kmeans_with_time(tmm.reshape(6, P, -1), _t(ts), 3,
                                  torch.Generator().manual_seed(s)).assignments
        assert parts(np.asarray(ja)) == parts(ta.numpy()) == \
            [(0, 1), (2, 3), (4, 5)]

    args = (batch.grid_sizes, batch.merge_sizes, batch.modals, ts, q)
    ref = jcr.run_visual_compression(
        params, jcfg, JTok(image_token_id=1000), jmm,
        jnp.asarray(batch.pixel_values), *args, jax.random.PRNGKey(0))
    got = tcr.run_visual_compression(
        model, tcfg, TTok(image_token_id=1000), tmm,
        _t(batch.pixel_values), *args, torch.Generator().manual_seed(0))
    thr = tcfg.compression.similarity_threshold
    assert np.abs(np.asarray(ref.similarities) - thr).min() > 1e-4
    np.testing.assert_allclose(np.sort(got.similarities.numpy()),
                               np.sort(np.asarray(ref.similarities)), **TOL)
    np.testing.assert_array_equal(got.minor_frames.numpy(),
                                  np.asarray(ref.minor_frames))
    np.testing.assert_array_equal(got.keep_visual.numpy(),
                                  np.asarray(ref.keep_visual))
    np.testing.assert_allclose(got.mm_features.numpy(),
                               np.asarray(ref.mm_features), **TOL)
    # static scenes: the repeated frame of each scene keeps min_tokens
    assert got.keep_visual.sum() < got.keep_visual.numel()


# ---------------------------------------------------------------------------
# the engine and the evaluation entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_clip(tmp_path_factory):
    """8 s at 10 fps of four 2-second static scenes (mp4v): sampled at 1
    fps, each 4-frame half holds two scenes of two frames, and the whole
    clip K = 4 events of two frames."""
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for f in _scene_frames(4, 20, 48, 64, seed=3):
        w.write(f)
    w.release()
    return path


def test_scene_clip_partition_is_seed_free(setup, engines, scene_clip):
    """The premise of the engine tests: on the decoded clip, k-means
    finds the scenes whatever the seed, on both sides."""
    jcfg, tcfg, params, model = setup
    out = engines[1].processor(_conversation(scene_clip))
    im, ts = out.images, out.all_timestamps
    mm = tcr.encode_images(model, _t(im.pixel_values), im.grid_sizes,
                           im.merge_sizes)
    frames = mm.reshape(len(ts), -1)
    want = [(0, 1), (2, 3), (4, 5), (6, 7)]
    for s in range(4):
        ta = tkm.kmeans_with_time(frames, _t(ts), 4,
                                  torch.Generator().manual_seed(s))
        ja = jkm.kmeans_with_time(jnp.asarray(frames.numpy()),
                                  jnp.asarray(ts), 4, jax.random.PRNGKey(s))
        for a in (ta.assignments.numpy(), np.asarray(ja.assignments)):
            assert sorted(tuple(np.nonzero(a == k)[0])
                          for k in np.unique(a)) == want


def _conversation(path):
    def video(s, e):
        return {"role": "stream", "content": [{"type": "video", "video": {
            "video_path": path, "fps": 1, "max_frames": 8,
            "start_time": s, "end_time": e}}]}

    return [video(0.0, 3.5),
            {"role": "user", "content": "what is the first scene?"},
            {"role": "assistant", "content": "a noisy pattern."},
            video(3.5, 8.0),
            {"role": "user", "content": "and what came after it?"}]


def _capture_tokens(monkeypatch, module):
    seen = []
    orig = module.decode_new_tokens

    def capture(tokens, num, tok, *a, **k):
        n = int(np.asarray(num)[0])
        seen.append(np.asarray(tokens)[0, :n].tolist())
        return orig(tokens, num, tok, *a, **k)

    monkeypatch.setattr(module, "decode_new_tokens", capture)
    return seen


@pytest.mark.parametrize("mode", ["FCC", "AC", "NC", "gt"])
def test_engine_chat_matches_jax(engines, scene_clip, monkeypatch, mode):
    """A two-segment conversation with one answered turn in its history:
    identical selections, greedy tokens and prefill inputs (events on
    for the visual modes: 8 frames, K = 4)."""
    jeng, teng = engines
    jtoks = _capture_tokens(monkeypatch, jeng_mod)
    ttoks = _capture_tokens(monkeypatch, teng_mod)
    conv = _conversation(scene_clip)
    kw = dict(select_gt=[0], if_visual=False) if mode == "gt" else {}
    ref = jeng.chat(conv, mode=mode, max_new_tokens=8, **kw)
    got = teng.chat(conv, mode=mode, max_new_tokens=8, **kw)
    assert (got.selection, got.if_visual, got.num_tokens, got.text) == \
        (ref.selection, ref.if_visual, ref.num_tokens, ref.text)
    assert ttoks == jtoks and len(ttoks) == 1

    out_j = jeng.processor(conv)
    out_t = teng.processor(conv)
    sel = jeng.qa_selection(out_j, mode="NC")
    je, jp, jl = jeng.prepare_multimodal(out_j, sel.input_ids, sel.if_visual)
    te, tp, tl = teng.prepare_multimodal(out_t, sel.input_ids, sel.if_visual)
    n = tp.shape[1]
    assert int(tl[0]) == int(jl[0]) and (np.asarray(jp)[0, n:] == -1).all()
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp)[:, :n])
    np.testing.assert_allclose(te.numpy(), np.asarray(je)[:, :n], **TOL)


def _run_eval(module, engine, processor, clip, root, mode):
    import os
    import shutil

    qdir, save = root / "queries", root / f"preds_{module.__name__[:14]}"
    qdir.mkdir(exist_ok=True)
    spec = {"video": os.path.basename(clip), "segments": [
        {"timestamp": [0.0, 3.5], "QAs": [
            {"QA_pairs": [{"Q": "what is shown?", "A": "noise"}],
             "relevance": [], "is_visual": True, "label": "Basic"}]},
        {"timestamp": [3.5, 8.0], "QAs": [
            {"QA_pairs": [{"Q": "and later?", "A": "more"}],
             "relevance": [1], "is_visual": True, "label": "Streaming"}]},
    ]}
    (qdir / "vid.json").write_text(json.dumps(spec))
    shutil.rmtree(save, ignore_errors=True)
    logs = []
    module.run_eval(engine, processor, os.path.dirname(clip), str(qdir),
                    str(save), mode=mode, process_index=0, process_count=1,
                    sampling={"extra_eos_ids": (2,)}, max_new_tokens=6,
                    log=logs.append)
    return json.loads((save / "vid.json").read_text()), logs


@pytest.mark.parametrize("mode", ["FCC", "gt"])
def test_run_eval_matches_jax(engines, scene_clip, tmp_path, mode):
    """answer_generate.run_eval over a one-video spec: the result JSON
    equals JAX's apart from the latency fields."""
    from cogstream_tpu.evaluate import answer_generate as jag
    from cogstream_tpu_torch.evaluate import answer_generate as tag

    jeng, teng = engines
    ref, _ = _run_eval(jag, jeng, jeng.processor, scene_clip, tmp_path, mode)
    got, logs = _run_eval(tag, teng, teng.processor, scene_clip, tmp_path,
                          mode)
    assert len(logs) == 1 and "2 turns" in logs[0]
    for r in ref["QAs"] + got["QAs"]:
        r.pop("latency_s")
    assert got == ref


def test_process_rank_and_cli_refusals(tmp_path, monkeypatch):
    """Without a process group the shard is (0, 1); the flags the port
    cannot serve exit naming their ROADMAP queue item; the quantized
    modes load as JAX's CLI loads them (``--w8a8-prefill`` needs
    ``--quantize-weights``; int8 + w8a8_prefill + a W8A8 tower reach the
    engine and the streaming sessions); ``--lookahead-k 3`` (once
    refused) reaches every turn's kwargs, and its engine's greedy tokens
    equal the JAX engine's on the same checkpoint."""
    from cogstream_tpu.config import load_hf_config as j_load_hf_config
    from cogstream_tpu.models.checkpoint import (
        load_cogreasoner_from_hf as j_load)
    from cogstream_tpu_torch.evaluate import answer_generate as tag
    from cogstream_tpu_torch.models.checkpoint import save_cogreasoner_to_hf
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params

    assert tag.process_rank() == (0, 1)
    base = ["--model-dir", str(tmp_path), "--video-dir", str(tmp_path),
            "--query-dir", str(tmp_path), "--save-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="requires --quantize-weights int4"):
        tag.main(base + ["--w4a8-decode"])
    with pytest.raises(SystemExit, match="requires --quantize-weights$"):
        tag.main(base + ["--w8a8-prefill"])
    cfg = TConfig.tiny()
    save_cogreasoner_to_hf(init_cogreasoner_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), cfg,
        str(tmp_path))
    ran = []
    monkeypatch.setattr(tag, "run_eval", lambda engine, *a, **k: ran.append(
        (engine, k["session_factory"], k["sampling"])))
    tag.main(base + ["--quantize-weights", "int8", "--w8a8-prefill",
                     "--encoder-int8", "--streaming", "--device", "cpu"])
    engine, factory, _ = ran[0]
    for model in (engine.model, factory().model):
        assert model.text.cfg.w8a8_prefill and model.vision.int8
        assert model.text.int8["down_proj"].q.dtype == torch.int8

    tag.main(base + ["--lookahead-k", "3", "--device", "cpu"])
    engine, _, sampling = ran[1]
    assert sampling["lookahead_k"] == 3
    jcfg = j_load_hf_config(str(tmp_path / "config.json"))
    jeng = JEngine(j_load(str(tmp_path), jcfg), jcfg,
                   JTok(image_token_id=jcfg.image_token_index))
    jtoks = _capture_tokens(monkeypatch, jeng_mod)
    ttoks = _capture_tokens(monkeypatch, teng_mod)
    conv = [{"role": "user", "content": "what is the first scene?"}]
    ref = jeng.chat(conv, mode="AC", max_new_tokens=8, **sampling)
    got = engine.chat(conv, mode="AC", max_new_tokens=8, **sampling)
    assert (got.text, got.num_tokens) == (ref.text, ref.num_tokens)
    assert ttoks == jtoks and len(ttoks) == 1


def test_engine_refuses_unported_options(setup, engines, monkeypatch):
    """``mesh`` (once refused naming its item) takes only a
    ``parallel.mesh.Mesh``; ``encoder_int8`` and ``generate(lookahead_k=2)``
    (once refused) run, the latter with the JAX engine's tokens."""
    jcfg, tcfg, params, model = setup
    tok = TTok(image_token_id=1000)
    with pytest.raises(TypeError, match="Mesh"):
        TEngine(model, tcfg, tok, mesh=object())
    # encoder_int8 (once refused): the engine's own W8A8 tower
    assert TEngine(model, tcfg, tok, encoder_int8=True).model.vision.int8
    assert not model.vision.int8
    eng = TEngine(model, tcfg, tok)
    jeng = engines[0]
    jtoks = _capture_tokens(monkeypatch, jeng_mod)
    ttoks = _capture_tokens(monkeypatch, teng_mod)
    conv = [{"role": "user", "content": "hi"}]
    out = eng.processor(conv)
    sel = eng.qa_selection(out, mode="AC")
    got = eng.generate(out, sel, max_new_tokens=16, lookahead_k=2)
    out_j = jeng.processor(conv)
    ref = jeng.generate(out_j, jeng.qa_selection(out_j, mode="AC"),
                        max_new_tokens=16, lookahead_k=2)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert ttoks == jtoks and len(ttoks) == 1


@pytest.mark.parametrize("streaming", [False, True])
def test_answer_generate_cli_on_cpu(scene_clip, tmp_path, streaming):
    """``python -m cogstream_tpu_torch answer-generate --device cpu`` over
    a checkpoint the port writes: one result per QA, through the engine
    or (``--streaming``) the KV-reusing session."""
    import os

    from cogstream_tpu_torch import __main__ as tmain
    from cogstream_tpu_torch.models.checkpoint import save_cogreasoner_to_hf
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params

    cfg = TConfig.tiny()
    ckpt = str(tmp_path / "ckpt")
    save_cogreasoner_to_hf(init_cogreasoner_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), cfg, ckpt)
    qdir = tmp_path / "q"
    qdir.mkdir()
    (qdir / "v.json").write_text(json.dumps({
        "video": os.path.basename(scene_clip), "segments": [
            {"timestamp": [0.0, 3.5], "QAs": [
                {"QA_pairs": [{"Q": "what?", "A": "x"}]}]},
            {"timestamp": [3.5, 8.0], "QAs": [
                {"QA_pairs": [{"Q": "then?", "A": "y"}]}]}]}))
    argv = ["answer-generate", "--model-dir", ckpt, "--video-dir",
            os.path.dirname(scene_clip), "--query-dir", str(qdir),
            "--save-dir", str(tmp_path / "out"), "--mode", "FCC",
            "--max-new-tokens", "4", "--device", "cpu"]
    assert tmain.main(argv + (["--streaming"] if streaming else [])) == 0
    out = json.loads((tmp_path / "out" / "v.json").read_text())
    assert len(out["QAs"]) == 2 and out.get("streaming", False) == streaming
    assert all(isinstance(q["prediction"], str) for q in out["QAs"])


def test_engine_on_a_one_rank_mesh(setup, engines):
    """``mesh=`` a 1 x 1 mesh: the engine serves its own shard (the whole
    model, the plan attached, the caller's model left whole) and answers
    the text turn, vanilla and lookahead, as the JAX engine does."""
    from cogstream_tpu_torch.parallel.mesh import single_device_mesh
    from cogstream_tpu_torch.parallel.sharding import sharded_mesh

    jcfg, tcfg, params, model = setup
    mesh = single_device_mesh()
    eng = TEngine(model, tcfg, TTok(image_token_id=1000), mesh=mesh)
    assert sharded_mesh(eng.model) is mesh and sharded_mesh(model) is None
    conv = [{"role": "user", "content": "hello, what now?"}]
    want = engines[0].chat(conv, mode="AC", max_new_tokens=8)
    for k in (0, 4):
        got = eng.chat(conv, mode="AC", max_new_tokens=8, lookahead_k=k)
        assert (got.text, got.num_tokens) == (want.text, want.num_tokens)
