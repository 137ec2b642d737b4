"""The PyTorch port's host-side copies against the JAX originals.

The port cannot import ``cogstream_tpu`` (its package ``__init__``
imports JAX), so it carries small copies of the host pieces its serving
slice needs. Each copy is pinned here to the original: config fields
and defaults, the byte tokenizer and selector token sets, selection
parsing, prompt strings (byte-exact), the pixel-diff keep mask
(byte-exact) and the vision metadata. The last tests check that the
port imports with JAX and ``cogstream_tpu`` blocked.
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
from cogstream_tpu.processor import tokenizer as jtok
from cogstream_tpu.runtime import history as jhist
from cogstream_tpu.runtime import retrieval as jret
from cogstream_tpu.runtime import session as jsess
from cogstream_tpu_torch import config as tcfg, presets as tpresets
from cogstream_tpu_torch.models import cogreasoner as tcr
from cogstream_tpu_torch.models import vision_encoder as tve
from cogstream_tpu_torch.ops import rope as trope
from cogstream_tpu_torch.processor import tokenizer as ttok
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
            got = tcr.pixel_diff_keep_mask_host(pv, t, merged, minor, **kw)
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
