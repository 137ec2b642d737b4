"""The PyTorch port's host-side copies against the JAX originals.

The port cannot import ``cogstream_tpu`` (its package ``__init__``
imports JAX), so it carries small copies of the host pieces its serving
slice needs. Each copy is pinned here to the original: config fields
and defaults, the byte tokenizer and selector token sets, selection
parsing, prompt strings (byte-exact), the pixel-diff keep mask
(byte-exact), the vision metadata, and the evaluation path's host
processor (chat template, image processor, video loader, the
conversation processor and the history rewrite: byte-exact outputs on
the same frames), the serving path's frame stream, snapshot codec
and stage timer, and the code of the evaluation harness and dataset
generation (copied whole, docstrings aside). The last tests check that
the port imports with JAX and ``cogstream_tpu`` blocked, and that no
port module imports PIL, OpenCV, ``transformers``, ``safetensors``,
nltk or openai when it is imported.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cogstream_tpu import config as jcfg, presets as jpresets
from cogstream_tpu.models import cogreasoner as jcr
from cogstream_tpu.models import vision_encoder as jve
from cogstream_tpu.processor import chat_template as jchat
from cogstream_tpu.processor import image_processor as jimg
from cogstream_tpu.processor import processing as jproc
from cogstream_tpu.processor import tokenizer as jtok
from cogstream_tpu.processor import video_loader as jvid
from cogstream_tpu.runtime import history as jhist
from cogstream_tpu.runtime import retrieval as jret
from cogstream_tpu.runtime import session as jsess
from cogstream_tpu_torch import config as tcfg, presets as tpresets
from cogstream_tpu_torch.models import cogreasoner as tcr
from cogstream_tpu_torch.models import vision_encoder as tve
from cogstream_tpu_torch.ops import rope as trope
from cogstream_tpu_torch.processor import chat_template as tchat
from cogstream_tpu_torch.processor import image_processor as timg
from cogstream_tpu_torch.processor import processing as tproc
from cogstream_tpu_torch.processor import tokenizer as ttok
from cogstream_tpu_torch.processor import video_loader as tvid
from cogstream_tpu_torch.runtime import history as thist
from cogstream_tpu_torch.runtime import retrieval as tret
from cogstream_tpu_torch.runtime import session as tsess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "cogstream_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["VisionEncoderConfig", "Qwen2Config",
                                  "CompressionConfig", "ProcessorConfig",
                                  "CogReasonerConfig", "LoRAConfig"])
def test_config_fields_and_defaults(name):
    def spec(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else "factory") for f in dataclasses.fields(cls)]

    assert spec(getattr(tcfg, name)) == spec(getattr(jcfg, name))


@pytest.mark.parametrize("preset", ["tiny", "cogreasoner_7b", "demo"])
def test_config_presets(preset):
    if preset == "tiny":
        j, t = jcfg.CogReasonerConfig.tiny(), tcfg.CogReasonerConfig.tiny()
    else:
        j, t = getattr(jpresets, preset)(), getattr(tpresets, preset)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.text.head_dim == j.text.head_dim
    assert t.text.num_kv_groups == j.text.num_kv_groups
    assert t.vision.head_dim == j.vision.head_dim
    assert t.text.torch_dtype == {"float32": torch.float32,
                                  "bfloat16": torch.bfloat16}[j.text.dtype]


# ---------------------------------------------------------------------------
# tokenizer, selection parsing
# ---------------------------------------------------------------------------

SAMPLES = [
    "", "hello", "<|im_start|>user\nwhat?<|im_end|>\n",
    "Time 1.0s:<image><image><|im_end|>", "ünïcødé ✓ 漢字",
    "<|stream_start|>x<|stream_end|>[yes,0,5]",
]


@pytest.mark.parametrize("image_id,vocab", [(1000, 1024), (151665, 152064)])
def test_byte_tokenizer(image_id, vocab):
    j = jtok.ByteTokenizer(image_token_id=image_id, vocab=vocab)
    t = ttok.ByteTokenizer(image_token_id=image_id, vocab=vocab)
    for s in SAMPLES:
        ids = t.encode(s)
        assert ids == j.encode(s)
        for skip in (False, True):
            assert t.decode(ids, skip) == j.decode(ids, skip)
    junk = [3, 999, 16 + 65, 5000, image_id, 2]
    assert t.decode(junk, True) == j.decode(junk, True)
    assert t.convert_tokens_to_ids("]") == j.convert_tokens_to_ids("]")
    assert ttok.constrained_selector_token_ids(t) == \
        jtok.constrained_selector_token_ids(j)
    assert ttok.selector_stop_token_ids(t) == jtok.selector_stop_token_ids(j)
    for attr in ("eos_token_id", "bos_token_id", "pad_token_id",
                 "image_token_id"):
        assert getattr(t, attr) == getattr(j, attr)


@pytest.mark.parametrize("sel", ["[yes,0,5]", "[no,1]", "[no]", "[yes]", "",
                                 "[0,x,3]", " [ yes , 2 ,, 7 ] ", "[maybe,4]"])
def test_parse_selection(sel):
    assert thist.parse_selection(sel) == jhist.parse_selection(sel)
    vis, idx = jhist.parse_selection(sel)
    assert thist.selection_string(vis, idx) == jhist.selection_string(vis, idx)


# ---------------------------------------------------------------------------
# prompt strings (byte-exact)
# ---------------------------------------------------------------------------

def test_prompt_strings_byte_exact():
    assert tret.SELECTOR_SYSTEM == jret.SELECTOR_SYSTEM
    assert tret.SELECTOR_DEMO == jret.SELECTOR_DEMO
    for demo in (True, False):
        assert tret.selector_prefix_text(demo) == jret.selector_prefix_text(demo)
        args = ("what now?", ["q0", "q1 ü"], ["a0", "a1"], demo)
        assert tret.build_selector_prompt(*args) == \
            jret.build_selector_prompt(*args)
    assert tcr.SUMMARY_SYSTEM == jcr.SUMMARY_SYSTEM
    assert tcr.SUMMARY_INSTRUCTION == jcr.SUMMARY_INSTRUCTION
    assert tsess.SYSTEM_PROMPT == jsess.SYSTEM_PROMPT


def test_selector_host_helpers():
    tok_j, tok_t = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    for h in (0, 3, 9, 30):
        assert tret.maximal_selection(h) == jret.maximal_selection(h)
        assert tret.selector_token_cap(h, tok_t) == \
            jret.selector_token_cap(h, tok_j)
    for s in ("", "yes,1", "[no,2", "[yes]"):
        assert tret.normalize_selection(s) == jret.normalize_selection(s)
    qs = [f"question {i} " * 5 for i in range(12)]
    as_ = [f"answer {i} " * 5 for i in range(12)]
    for cap in (10 ** 6, 2000, 900):
        assert tret.window_selector_history(tok_t, "q?", qs, as_, cap) == \
            jret.window_selector_history(tok_j, "q?", qs, as_, cap)
    assert tret._remap_selection("[yes,0,2]", 3) == \
        jret._remap_selection("[yes,0,2]", 3)


# ---------------------------------------------------------------------------
# pixel-diff mask, vision metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pixel_diff_keep_mask_byte_exact(dtype):
    rng = np.random.default_rng(0)
    t, merged, row = 4, 6, 4 * 3 * 14 * 14
    if dtype == np.uint8:
        pv = rng.integers(0, 256, (t * merged, row), dtype=np.uint8)
        pv[merged:2 * merged] = pv[:merged]          # a static frame
        pv[2 * merged + 1] = pv[merged + 1]          # one static patch
    else:
        pv = rng.normal(size=(t * merged, row)).astype(np.float32)
        pv[3 * merged:] = pv[2 * merged:3 * merged]
    for minor in (np.zeros(t, bool), np.array([0, 1, 0, 1], bool)):
        for thr, mt in ((0.1, 1), (40.0, 2)):
            kw = dict(threshold=thr, min_tokens=mt,
                      image_std=(0.5, 0.25, 0.5), rescale_factor=1 / 255)
            got = tcr.pixel_diff_keep_mask(torch.from_numpy(pv), t, merged,
                                           torch.from_numpy(minor),
                                           **kw).numpy()
            ref = jcr.pixel_diff_keep_mask_host(pv, t, merged, minor, **kw)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("grids,merges,pad_to", [
    ([[2, 4, 4]], [2], None), ([[2, 4, 4], [1, 6, 4]], [2, 2], 96),
    ([[3, 4, 6]], [1], 128)])
def test_vision_metadata(grids, merges, pad_to):
    j = jve.build_vision_metadata(np.array(grids), np.array(merges), pad_to)
    t = tve.build_vision_metadata(np.array(grids), np.array(merges), pad_to)
    np.testing.assert_array_equal(t.pos_ids, j.pos_ids)
    np.testing.assert_array_equal(t.segment_ids, j.segment_ids)
    np.testing.assert_array_equal(t.merge_group_ids, j.merge_group_ids)
    assert t.num_out_tokens == j.num_out_tokens
    from cogstream_tpu.ops.rope import grid_position_ids
    np.testing.assert_array_equal(trope.grid_position_ids(2, 4, 6, 2),
                                  grid_position_ids(2, 4, 6, 2))


def test_vision_kv_ranges_cover_each_tiles_segments():
    """K1's host metadata: each 64-token query tile gets exactly the
    token span of the segments it holds."""
    from cogstream_tpu_torch.ops.flash_attention import vision_kv_ranges

    seg = np.concatenate([np.full(50, 0), np.full(100, 1), np.full(30, 2),
                          np.full(20, -1)]).astype(np.int32)
    lo, hi = vision_kv_ranges(seg, 64)
    assert lo.tolist() == [0, 50, 50, 0]
    assert hi.tolist() == [150, 150, 180, 0]
    with pytest.raises(ValueError):
        vision_kv_ranges(np.array([1, 1, 0, 0], np.int32), 64)


# ---------------------------------------------------------------------------
# the port never imports JAX
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the evaluation path's host processor
# ---------------------------------------------------------------------------

def _frames(rng, n, h, w, chw=False):
    f = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    return [x.transpose(2, 0, 1).copy() for x in f] if chw else f


@pytest.mark.parametrize("case", ["video_resize", "video_chw", "array4d",
                                  "mixed", "raw_uint8", "exact_size"])
def test_image_processor_byte_exact(case):
    rng = np.random.default_rng(0)
    kw = {}
    if case == "video_resize":
        items, modals = [_frames(rng, 3, 50, 70)], ["video"]
    elif case == "video_chw":
        items, modals = [_frames(rng, 4, 40, 90, chw=True)], ["video"]
    elif case == "array4d":
        items, modals = [np.stack(_frames(rng, 2, 30, 30))], ["video"]
    elif case == "mixed":
        items = [_frames(rng, 1, 60, 45)[0], _frames(rng, 2, 33, 57)]
        modals = ["image", "video"]
    elif case == "raw_uint8":
        items, modals = [_frames(rng, 3, 50, 70)], ["video"]
        kw = dict(raw_uint8=True)
    else:   # frames already at the smart-resize target: no resample
        items, modals = [_frames(rng, 2, 56, 84)], ["video"]
    j = jimg.ImageProcessor(jcfg.ProcessorConfig())(items, modals, **kw)
    t = timg.ImageProcessor(tcfg.ProcessorConfig())(items, modals, **kw)
    assert t.pixel_values.dtype == j.pixel_values.dtype
    np.testing.assert_array_equal(t.pixel_values, j.pixel_values)
    np.testing.assert_array_equal(t.grid_sizes, j.grid_sizes)
    np.testing.assert_array_equal(t.merge_sizes, j.merge_sizes)
    assert t.modals == j.modals


@pytest.mark.parametrize("hw", [(224, 364), (28, 28), (17, 45)])
def test_resize_bicubic_identity_at_equal_size(hw):
    """At its own size a frame comes back unchanged — byte-identical to
    Pillow's resize (the original's path), which copies in that case —
    and the port does not import PIL for it."""
    frame = np.random.default_rng(1).integers(0, 256, hw + (3,),
                                              dtype=np.uint8)
    got = timg.resize_bicubic(frame, hw)
    np.testing.assert_array_equal(got, jimg.resize_bicubic(frame, hw))
    np.testing.assert_array_equal(
        timg.resize_bicubic(frame, (hw[0] + 14, hw[1])),
        jimg.resize_bicubic(frame, (hw[0] + 14, hw[1])))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["PIL"] = None
        import numpy as np
        from cogstream_tpu_torch.processor import image_processor as ip
        f = np.zeros({hw + (3,)!r}, np.uint8)
        assert ip.resize_bicubic(f, {hw!r}) is f
        if f.shape[:2] == (224, 364):   # its own smart-resize target
            b = ip.ImageProcessor()([[f, f]], ["video"])
            assert tuple(b.grid_sizes[0]) == (2, 16, 26)
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


CONVERSATIONS = [
    [{"role": "user", "content": "hello there"}],
    [{"role": "system", "content": "be brief"},
     {"role": "user", "content": [{"type": "text", "text": "q1"}]},
     {"role": "assistant", "content": "a1"}],
    [{"role": "stream", "content": [
        {"type": "video", "num_frames": 2, "timestamps": [0.0, 1.25]}]},
     {"role": "user", "content": [
         {"type": "image", "timestamp": 3.0},
         {"type": "text", "text": "what?"}]}],
]


@pytest.mark.parametrize("conv", range(len(CONVERSATIONS)))
@pytest.mark.parametrize("sys_p,gen_p", [(False, True), (True, False)])
def test_render_chat_byte_exact(conv, sys_p, gen_p):
    c = CONVERSATIONS[conv]
    assert tchat.render_chat(c, sys_p, gen_p) == \
        jchat.render_chat(c, sys_p, gen_p)
    assert tchat.GENERATION_PROMPT == jchat.GENERATION_PROMPT
    assert tchat.DEFAULT_SYSTEM_PROMPT == jchat.DEFAULT_SYSTEM_PROMPT


@pytest.fixture(scope="module")
def frame_dirs(tmp_path_factory):
    """Two extracted-frame directories (.npy frames: the frame-dir path
    of the video loader, no decoder needed)."""
    rng = np.random.default_rng(2)
    dirs = []
    for i, n in enumerate((4, 3)):
        d = tmp_path_factory.mktemp(f"frames{i}")
        for k, f in enumerate(_frames(rng, n, 42, 70)):
            np.save(d / f"{k:03d}.npy", f)
        dirs.append(str(d))
    return dirs


def _eval_conversation(dirs, role="stream"):
    def video(d):
        return [{"type": "video", "video": {"video_path": d, "fps": 1,
                                            "max_frames": 8}}]

    conv = [{"role": role, "content": video(dirs[0])},
            {"role": "user", "content": "what happened first?"},
            {"role": "assistant", "content": "a red thing moved."},
            {"role": role, "content": video(dirs[1])},
            {"role": "user", "content": "and then?"}]
    if role == "user":   # the reference layout: video rides the question
        conv = [{"role": "user", "content": video(dirs[0]) + [
                    {"type": "text", "text": "what happened first?"}]},
                conv[2],
                {"role": "user", "content": video(dirs[1]) + [
                    {"type": "text", "text": "and then?"}]}]
    return conv


@pytest.mark.parametrize("role", ["stream", "user"])
@pytest.mark.parametrize("labels", [False, True])
def test_processor_outputs_byte_exact(frame_dirs, role, labels):
    """CogStreamProcessor: prompt text, input_ids, labels, patch rows,
    grids, timestamps and history identical to the original's."""
    conv = _eval_conversation(frame_dirs, role)
    kw = dict(return_labels=labels)
    j = jproc.CogStreamProcessor(jtok.ByteTokenizer(), jcfg.ProcessorConfig())(
        conv, rng=np.random.default_rng(0) if labels else None, **kw)
    t = tproc.CogStreamProcessor(ttok.ByteTokenizer(), tcfg.ProcessorConfig())(
        conv, rng=np.random.default_rng(0) if labels else None, **kw)
    assert t.original_text == j.original_text
    np.testing.assert_array_equal(t.input_ids, j.input_ids)
    if labels:
        np.testing.assert_array_equal(t.labels, j.labels)
    else:
        assert t.labels is None and j.labels is None
    np.testing.assert_array_equal(t.images.pixel_values,
                                  j.images.pixel_values)
    np.testing.assert_array_equal(t.images.grid_sizes, j.images.grid_sizes)
    assert t.images.modals == j.images.modals
    assert t.all_timestamps.dtype == j.all_timestamps.dtype
    np.testing.assert_array_equal(t.all_timestamps, j.all_timestamps)
    assert (t.hist_qs, t.hist_as, t.current_question, t.total_image_num) == \
        (j.hist_qs, j.hist_as, j.current_question, j.total_image_num)


@pytest.mark.parametrize("visual", [True, False])
@pytest.mark.parametrize("role", ["stream", "user"])
def test_rewrite_history_byte_exact(frame_dirs, visual, role):
    out = jproc.CogStreamProcessor(jtok.ByteTokenizer())(
        _eval_conversation(frame_dirs, role))
    for kept in ([], [0]):
        args = (out.original_text, visual, [out.hist_qs[i] for i in kept],
                [out.hist_as[i] for i in kept], out.current_question)
        assert thist.rewrite_history(*args) == jhist.rewrite_history(*args)


def test_video_loader_matches_original(tmp_path):
    """load_video (OpenCV's decoder where no ffmpeg binary is installed)
    and the shared frame plan: identical frames, stamps and duration."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(3)
    for i in range(45):
        w.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
    w.release()
    for kw in ({}, {"start_time": 1.0, "end_time": 3.2},
               {"max_frames": 2, "temporal_factor": 2},
               {"fps": 2, "trim_time": 0.5}):
        jf, jt, jd = jvid.load_video(path, **kw)
        tf, tt, td = tvid.load_video(path, **kw)
        assert (tt, td) == (jt, jd) and len(tf) == len(jf)
        for a, b in zip(tf, jf):
            np.testing.assert_array_equal(a, b)
    assert tvid.cv2_frame_plan(45, 10.0, 1.0, None, 1.0, 3, 0.5)[2] == \
        jvid.cv2_frame_plan(45, 10.0, 1.0, None, 1.0, 3, 0.5)[2]


@pytest.mark.parametrize("kw", [dict(fps=2.0, chunk_frames=5,
                                      max_frames=128),
                                 dict(start=2.0, end=6.0, fps=2.0,
                                      chunk_frames=3),
                                 dict(fps=4.0, chunk_frames=4, max_frames=6)])
def test_frame_stream_matches_original(tmp_path, kw):
    """open_frame_stream (the cv2 thread where no ffmpeg binary is
    installed): the same chunks, stamps, backend and frame-count hint as
    the JAX package's; a frame directory returns None in both."""
    cv2 = pytest.importorskip("cv2")
    from cogstream_tpu.processor import frame_stream as jfs
    from cogstream_tpu_torch.processor import frame_stream as tfs

    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(7)
    for i in range(80):
        frame = rng.integers(0, 255, (48, 64, 3), np.uint8)
        frame[:8, :8] = i * 3
        w.write(frame)
    w.release()
    js, ts = jfs.open_frame_stream(path, **kw), tfs.open_frame_stream(path,
                                                                     **kw)
    assert (ts.backend, ts.total_frames_hint, ts.chunk_frames) == \
        (js.backend, js.total_frames_hint, js.chunk_frames)
    with js, ts:
        jchunks, tchunks = list(js), list(ts)
    assert len(tchunks) == len(jchunks) > 1
    for (tc, tt), (jc, jt) in zip(tchunks, jchunks):
        assert tt == jt
        np.testing.assert_array_equal(tc, jc)
    assert ts.frames_seen == js.frames_seen
    assert tfs.open_frame_stream(str(tmp_path)) is None
    assert jfs.open_frame_stream(str(tmp_path)) is None


def test_snapshot_codec_matches_original(tmp_path):
    """pack_array: the JAX package's bytes and dtype names (numpy arrays,
    and torch bf16 as JAX's bfloat16); unpack_array inverts both
    packages' output without ml_dtypes; atomic_write_npz writes the same
    archive members."""
    import ml_dtypes

    from cogstream_tpu.utils import io as jio
    from cogstream_tpu_torch.utils import io as tio

    rng = np.random.default_rng(0)
    for a in (rng.standard_normal((2, 3, 4)).astype(np.float32),
              np.arange(5, dtype=np.int32), np.arange(4, dtype=np.uint32),
              rng.integers(0, 255, (3, 6), np.uint8)):
        tb, tn = tio.pack_array(a)
        jb, jn = jio.pack_array(a)
        assert tn == jn and np.array_equal(tb, jb)
        np.testing.assert_array_equal(tio.unpack_array(jb, jn), a)
    x = torch.randn(3, 5).to(torch.bfloat16)
    tb, tn = tio.pack_array(x)
    jb, jn = jio.pack_array(x.float().numpy().astype(ml_dtypes.bfloat16))
    assert tn == jn == "bfloat16" and np.array_equal(tb, jb)
    assert torch.equal(tio.unpack_array(jb, jn), x)
    with pytest.raises(ValueError):     # a 0-d tensor has no byte view
        tio.pack_array(torch.tensor(1.0, dtype=torch.bfloat16))
    tio.atomic_write_npz(str(tmp_path / "t.npz"), a=tb, b=np.arange(3))
    jio.atomic_write_npz(str(tmp_path / "j.npz"), a=jb, b=np.arange(3))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])
    assert sorted(os.listdir(tmp_path)) == ["j.npz", "t.npz"]


def test_unpack_array_without_ml_dtypes():
    code = textwrap.dedent("""
        import sys
        sys.modules["ml_dtypes"] = None
        import numpy as np, torch
        from cogstream_tpu_torch.utils.io import pack_array, unpack_array
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        assert torch.equal(unpack_array(*pack_array(x.bfloat16())).float(), x)
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_stage_timer_and_logger_match_original(monkeypatch):
    from cogstream_tpu.utils import profiling as jprof
    from cogstream_tpu_torch.utils import profiling as tprof

    ticks = iter(np.arange(0.0, 100.0, 0.25))
    for mod in (jprof, tprof):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
    timers = (jprof.StageTimer(), tprof.StageTimer())
    for t in timers:
        for _ in range(3):
            with t.stage("ask"):
                pass
        t.record("ingest", 1.5)
        t.record("ingest", 0.5)
    assert timers[0].summary() == timers[1].summary()
    lj, lt = jprof.get_logger("pin_j"), tprof.get_logger("pin_t")
    assert lt.level == lj.level and len(lt.handlers) == len(lj.handlers)
    assert lt.handlers[0].formatter._fmt == lj.handlers[0].formatter._fmt


def test_native_video_binds_the_repository_library():
    from cogstream_tpu.processor import native_video as jnv
    from cogstream_tpu_torch.processor import native_video as tnv

    assert tnv._SO_PATH == jnv._SO_PATH
    assert tnv._SO_PATH == os.path.join(ROOT, "native", "libvideoio.so")


def test_load_tokenizer(tmp_path, monkeypatch):
    """Without tokenizer files: the byte fallback with the config's ids,
    as the original. With them: the HF wrapper, whose methods forward to
    ``AutoTokenizer`` as the original's do (a stand-in module here: no
    tokenizer files ship in the repository)."""
    import types

    for kw in ({}, {"image_token_id": 151665, "vocab_size": 152064}):
        j = jtok.load_tokenizer(str(tmp_path), *kw.values())
        t = ttok.load_tokenizer(str(tmp_path), *kw.values())
        assert type(t).__name__ == type(j).__name__ == "ByteTokenizer"
        assert (t.image_token_id, t.vocab_size()) == \
            (j.image_token_id, j.vocab_size())

    class Fake:
        eos_token_id, pad_token_id, bos_token_id = 7, None, 1

        @classmethod
        def from_pretrained(cls, path, use_fast=True):
            return cls()

        def __len__(self):
            return 99

        def convert_tokens_to_ids(self, tok):
            return {"<image>": 42}.get(tok, 3)

        def encode(self, text, add_special_tokens=True):
            return [len(text), int(add_special_tokens)]

        def decode(self, ids, skip_special_tokens=False):
            return f"{ids}|{skip_special_tokens}"

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(AutoTokenizer=Fake))
    (tmp_path / "tokenizer.json").write_text("{}")
    j = jtok.load_tokenizer(str(tmp_path))
    t = ttok.load_tokenizer(str(tmp_path))
    assert isinstance(t, ttok.HFTokenizer)
    for attr in ("eos_token_id", "pad_token_id", "bos_token_id",
                 "image_token_id"):
        assert getattr(t, attr) == getattr(j, attr)
    assert (t.vocab_size(), t.encode("abc"), t.decode((1, 2), True),
            t.convert_tokens_to_ids("x")) == \
        (j.vocab_size(), j.encode("abc"), j.decode((1, 2), True),
         j.convert_tokens_to_ids("x"))


# host-only modules the port carries as copies of the JAX package's
COPIED_MODULES = [
    "evaluate/synonyms_data", "evaluate/nlp_metrics", "evaluate/aggregate",
    "datagen/client", "evaluate/judges", "datagen/prompts",
    "datagen/segmentation", "datagen/generation", "datagen/reformatting",
    "datagen/scoring", "datagen/dialogue_path", "datagen/formatting",
    "datagen/__init__",
]


def _code(path: str) -> str:
    """The AST of a source file with every docstring removed."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("mod", COPIED_MODULES)
def test_copied_host_module_code_equals_the_original(mod):
    """The evaluation harness and dataset generation are copies: the
    code (docstrings aside) equals the JAX package's, so the CLI's host
    stages give the same outputs."""
    got = _code(os.path.join(PORT, f"{mod}.py"))
    want = _code(os.path.join(ROOT, "cogstream_tpu", f"{mod}.py"))
    assert got == want


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return mods


def test_port_imports_without_jax():
    """Every port module imports with ``jax`` and ``cogstream_tpu``
    blocked, and without nvcc (kernels build at first launch only)."""
    for m in ("runtime.pool", "runtime.serve", "processor.frame_stream",
              "utils.io", "utils.profiling", "datagen", "evaluate.judges",
              "parallel.pipeline", "ops.ring_attention"):
        assert f"cogstream_tpu_torch.{m}" in _port_modules()
    for mod in COPIED_MODULES:
        name = "cogstream_tpu_torch." + mod.replace("/", ".")
        assert name.removesuffix(".__init__") in _port_modules()
    code = textwrap.dedent(f"""
        import sys, importlib
        sys.modules["jax"] = None
        sys.modules["cogstream_tpu"] = None
        for m in {_port_modules()!r}:
            importlib.import_module(m)
        from cogstream_tpu_torch.ops import kernels
        assert kernels._lib is None
        print("ok")
    """)
    env = {**os.environ, "PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_port_sources_never_name_jax():
    """AST scan: no port file (nor chip_smoke.py) imports jax or
    cogstream_tpu."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "cogstream_tpu"), \
                    f"{path} imports {n}"


HOST_LIBS = ("PIL", "cv2", "transformers", "safetensors", "nltk", "openai")


def test_port_sources_import_host_libraries_lazily():
    """AST scan: no port file (nor chip_smoke.py) imports PIL, cv2,
    transformers, safetensors, nltk or openai at module level — only inside the
    function that uses it — so a machine without them runs the port."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in HOST_LIBS, \
                    f"{path} imports {n} at module level"


def test_port_imports_without_host_libraries():
    """Every port module imports with PIL, cv2, transformers,
    safetensors, nltk and openai blocked."""
    code = textwrap.dedent(f"""
        import sys, importlib
        for m in {HOST_LIBS!r}:
            sys.modules[m] = None
        for m in {_port_modules()!r}:
            importlib.import_module(m)
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
