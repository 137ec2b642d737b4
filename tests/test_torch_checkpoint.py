"""The port's HF checkpoint I/O against the JAX package and the
``safetensors`` package, on the CPU.

* the port's safetensors writer: byte-identical files to the package's
  for the same tensors; its reader returns what the package wrote,
  sharded index included, over the mapped file (no host copy);
* a tiny checkpoint written by JAX's ``save_cogreasoner_to_hf`` and
  loaded by the port equals JAX's loader on it, tensor for tensor (bit
  for bit, through models/bridge.py), in f32 and bf16;
* one written by the port is byte-identical to JAX's export of the same
  weights, and JAX loads it back equal;
* ``quantize_text_bits=4`` and ``8`` on load equal JAX's host int4 /
  int8 trees and the port's ``quantize_text_``;
* ``merge_lora`` against JAX's (f32, within 1e-6);
* the config readers and writer against the originals on the same files.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogstream_tpu import config as jcfg_mod
from cogstream_tpu.config import CogReasonerConfig as JConfig, LoRAConfig
from cogstream_tpu.models import checkpoint as jck
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.models.lora import init_cogreasoner_lora
from cogstream_tpu_torch import config as tcfg_mod
from cogstream_tpu_torch.config import CogReasonerConfig as TConfig
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import checkpoint as tck
from cogstream_tpu_torch.models import safetensors_io as st
from cogstream_tpu_torch.ops import quant

safetensors_torch = pytest.importorskip("safetensors.torch")

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype):
    def with_dtype(cfg):
        return dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, dtype=dtype),
            vision=dataclasses.replace(cfg.vision, dtype=dtype))

    return with_dtype(JConfig.tiny()), with_dtype(TConfig.tiny())


@pytest.fixture(scope="module")
def params():
    return init_cogreasoner_params(jax.random.PRNGKey(0), JConfig.tiny())


@pytest.fixture(scope="module")
def jax_ckpts(params, tmp_path_factory):
    """Tiny checkpoints written by the JAX exporter, stored f32 / bf16."""
    out = {}
    for dt in ("float32", "bfloat16"):
        d = str(tmp_path_factory.mktemp(f"jax_{dt}"))
        jck.save_cogreasoner_to_hf(params, JConfig.tiny(), d, dtype=JDT[dt])
        out[dt] = d
    return out


def _assert_same_model(got, ref):
    a, b = got.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _tensors(kind):
    g = torch.Generator().manual_seed(0)
    if kind == "float":
        return {"w": torch.randn(5, 3, generator=g),
                "b.bias": torch.randn(3, generator=g).bfloat16(),
                "h": torch.randn(2, 2, generator=g).half(),
                "d": torch.randn(4, generator=g).double(),
                "scalar": torch.tensor(0.5)}
    if kind == "int":
        return {"q4": torch.randint(-8, 8, (4, 6), generator=g,
                                    dtype=torch.int8),
                "u8": torch.randint(0, 255, (7,), generator=g,
                                    dtype=torch.uint8),
                "i16": torch.arange(3, dtype=torch.int16),
                "i32": torch.arange(5, dtype=torch.int32),
                "i64": torch.arange(2, dtype=torch.int64),
                "mask": torch.tensor([True, False, True])}
    return {"model.layers.10.x": torch.ones(2), "model.layers.2.x":
            torch.zeros(2), "ünï": torch.ones(1).bfloat16(),
            "empty": torch.zeros((0, 4))}


@pytest.mark.parametrize("kind", ["float", "int", "names"])
@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_safetensors_writer_byte_identical(kind, metadata, tmp_path):
    t = _tensors(kind)
    ref = safetensors_torch.save(t, metadata=metadata)
    st.save_file(t, str(tmp_path / "x.safetensors"), metadata)
    assert (tmp_path / "x.safetensors").read_bytes() == ref


def test_safetensors_reader_and_sharded_index(tmp_path):
    """The reader returns the package's tensors, dtype and bytes exact,
    across an index of two shards; a truncated file is refused."""
    t = {**_tensors("float"), **_tensors("int")}
    names = sorted(t)
    shards = {"model-00001-of-00002.safetensors": names[:5],
              "model-00002-of-00002.safetensors": names[5:]}
    for shard, keys in shards.items():
        safetensors_torch.save_file({k: t[k] for k in keys},
                                    str(tmp_path / shard))
    (tmp_path / st.CheckpointReader.INDEX).write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: s for s, ks in shards.items()
                                        for k in ks}}))
    sd = st.CheckpointReader(str(tmp_path))
    assert sorted(sd) == names and len(sd) == len(names) and "w" in sd
    for k in names:
        got = sd[k]
        assert got.dtype == t[k].dtype and got.shape == t[k].shape
        assert torch.equal(got, t[k])
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes((tmp_path / "model-00001-of-00002.safetensors")
                    .read_bytes()[:-3])
    with pytest.raises(ValueError):
        st.SafeTensorsFile(str(bad))


def test_safetensors_reader_maps_without_copy(tmp_path):
    """A read tensor lies over the file's mapped pages (no host copy);
    writing to it leaves the file as it was."""
    t = _tensors("float")
    path = str(tmp_path / "x.safetensors")
    st.save_file(t, path)
    f = st.SafeTensorsFile(path)
    w = f.get("w")
    with open("/proc/self/maps") as maps:
        spans = [tuple(int(x, 16) for x in line.split()[0].split("-"))
                 for line in maps if line.rstrip().endswith(path)]
    assert any(a <= w.data_ptr() < b for a, b in spans)
    w.add_(1.0)
    assert torch.equal(f.get("w"), t["w"])
    assert torch.equal(f.get("b.bias"), t["b.bias"])


# ---------------------------------------------------------------------------
# the model checkpoint, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stored,dtype", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
def test_load_jax_checkpoint(jax_ckpts, stored, dtype):
    """Every tensor the port loads equals JAX's loader's leaf."""
    jcfg, tcfg = _cfgs(dtype)
    ref_tree = jck.load_cogreasoner_from_hf(jax_ckpts[stored], jcfg)
    ref = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, ref_tree),
                                         tcfg, device="cpu")
    got = tck.load_cogreasoner_from_hf(jax_ckpts[stored], tcfg, device="cpu")
    _assert_same_model(got, ref)
    assert not any(p.requires_grad for p in got.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_matches_jax_export(params, jax_ckpts, tmp_path, dtype):
    """The port's export of the same weights is byte-identical to JAX's
    (weights, index, config), and JAX loads it back equal."""
    model = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, params),
                                           TConfig.tiny(), device="cpu")
    out = tck.save_cogreasoner_to_hf(model, TConfig.tiny(), str(tmp_path),
                                     dtype=TDT[dtype])
    for f in ("model.safetensors", "model.safetensors.index.json",
              "config.json"):
        assert open(os.path.join(out, f), "rb").read() == \
            open(os.path.join(jax_ckpts[dtype], f), "rb").read(), f
    back = jck.load_cogreasoner_from_hf(out, JConfig.tiny())
    ref = jck.load_cogreasoner_from_hf(jax_ckpts[dtype], JConfig.tiny())
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, ref)


def test_round_trip_bit_exact(jax_ckpts, tmp_path):
    """port load → port save → port load: every tensor bit-identical
    (bf16 storage and model)."""
    _, tcfg = _cfgs("bfloat16")
    first = tck.load_cogreasoner_from_hf(jax_ckpts["bfloat16"], tcfg,
                                         device="cpu")
    tck.save_cogreasoner_to_hf(first, tcfg, str(tmp_path))
    _assert_same_model(tck.load_cogreasoner_from_hf(str(tmp_path), tcfg,
                                                    device="cpu"), first)


@pytest.mark.parametrize("stored,dtype", [("float32", "float32"),
                                          ("bfloat16", "bfloat16")])
def test_int4_on_load(jax_ckpts, stored, dtype):
    """quantize_text_bits=4: the int4 stores equal JAX's host quantizer
    (_lazy_quant4u, through the bridge) and the port's quantize_text_ on
    the loaded bf16/f32 model."""
    jcfg, tcfg = _cfgs(dtype)
    ref_tree = jck.load_cogreasoner_from_hf(jax_ckpts[stored], jcfg,
                                            quantize_text_bits=4)
    ref = bridge.qwen2_from_params(jax.tree.map(np.asarray,
                                                ref_tree["text"]),
                                   tcfg.text, device="cpu")
    got = tck.load_cogreasoner_from_hf(jax_ckpts[stored], tcfg,
                                       quantize_text_bits=4, device="cpu")
    _assert_same_model(got.text, ref)
    dense = tck.load_cogreasoner_from_hf(jax_ckpts[stored], tcfg,
                                         device="cpu")
    _assert_same_model(got.text, quant.quantize_text_(dense.text))
    assert isinstance(got.text.lm_head, quant.Int4Linear)


def test_unported_load_modes_raise(jax_ckpts):
    """quantize_text_bits=8 (once refused) loads the int8 decoder JAX's
    host quantizer (_lazy_quant8) loads, byte for byte, and equals the
    port's quantize_text_(bits=8) of the loaded model; other widths and
    wrong shapes still raise."""
    jcfg, tcfg = _cfgs("float32")
    ref_tree = jck.load_cogreasoner_from_hf(jax_ckpts["float32"], jcfg,
                                            quantize_text_bits=8)
    ref = bridge.qwen2_from_params(jax.tree.map(np.asarray,
                                                ref_tree["text"]),
                                   tcfg.text, device="cpu")
    got = tck.load_cogreasoner_from_hf(jax_ckpts["float32"], tcfg,
                                       quantize_text_bits=8, device="cpu")
    _assert_same_model(got.text, ref)
    dense = tck.load_cogreasoner_from_hf(jax_ckpts["float32"], tcfg,
                                         device="cpu")
    _assert_same_model(got.text, quant.quantize_text_(dense.text, bits=8))
    assert got.text.int8["q_proj"].q.dtype == torch.int8
    with pytest.raises(ValueError):
        tck.load_cogreasoner_from_hf(jax_ckpts["float32"], TConfig.tiny(),
                                     quantize_text_bits=3, device="cpu")
    small = dataclasses.replace(TConfig.tiny(), text=dataclasses.replace(
        TConfig.tiny().text, vocab_size=512))
    with pytest.raises(ValueError, match="shape"):
        tck.load_cogreasoner_from_hf(jax_ckpts["float32"], small,
                                     device="cpu")


@pytest.mark.parametrize("projector", [False, True])
def test_merge_lora(params, projector):
    """merge_lora folds the same deltas as JAX's (f32, 1e-6)."""
    cfg = JConfig.tiny()
    lora = init_cogreasoner_lora(jax.random.PRNGKey(1), cfg,
                                 LoRAConfig(include_projector=projector))
    rng = np.random.default_rng(0)
    lora = jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(
        a.shape).astype(np.float32) * 0.1, lora)
    ref = bridge.cogreasoner_from_params(
        jax.tree.map(np.asarray, jck.merge_lora(params, lora, 2.0)),
        TConfig.tiny(), device="cpu")
    model = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, params),
                                           TConfig.tiny(), device="cpu")
    got = tck.merge_lora(model, bridge.lora_from_params(lora, "cpu"), 2.0)
    a, b = got.state_dict(), ref.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=1e-6, rtol=1e-6)
    base = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, params),
                                          TConfig.tiny(), device="cpu")
    changed = [k for k in a if not torch.equal(a[k], base.state_dict()[k])]
    assert any("projector" in k for k in changed) == projector
    assert any("mlp.down_proj" in k for k in changed)


def test_export_hf_cli_matches_jax(jax_ckpts, tmp_path, monkeypatch):
    """``python -m cogstream_tpu_torch export-hf --device cpu`` with a
    LoRA adapter writes the tensors of JAX's ``export-hf`` (f32, 1e-6:
    the two merges sum the rank-8 products in their own orders)."""
    import sys

    from cogstream_tpu import __main__ as jmain
    from cogstream_tpu.train.checkpoint import save_lora_adapter
    from cogstream_tpu_torch import __main__ as tmain

    lora = init_cogreasoner_lora(jax.random.PRNGKey(2), JConfig.tiny(),
                                 LoRAConfig())
    lora = jax.tree.map(lambda a: jnp.asarray(a) + 0.05, lora)
    npz = save_lora_adapter(str(tmp_path / "ad"), lora)
    src = jax_ckpts["float32"]
    monkeypatch.setattr(sys, "argv", list(sys.argv))   # jmain rewrites it
    jmain.main(["export-hf", "--model-dir", src, "--out",
                str(tmp_path / "j"), "--adapter", npz])
    assert tmain.main(["export-hf", "--model-dir", src, "--out",
                       str(tmp_path / "t"), "--adapter", npz,
                       "--device", "cpu"]) == 0
    a = (tmp_path / "t" / "model.safetensors").read_bytes()
    b = (tmp_path / "j" / "model.safetensors").read_bytes()
    assert len(a) == len(b)
    ta = safetensors_torch.load(a)
    tb = safetensors_torch.load(b)
    for k in tb:
        torch.testing.assert_close(ta[k], tb[k], atol=1e-6, rtol=1e-6)


def test_cli_names_the_queue_of_unported_commands(capsys):
    """Every command of the JAX package's CLI is a command of the port's:
    its help lists each one, none is left in NOT_PORTED, and an unknown
    command still returns 2."""
    import re

    from cogstream_tpu import __main__ as jmain_mod
    from cogstream_tpu_torch import __main__ as tmain

    jax_cmds = set(re.findall(r"^  ([a-z0-9-]+) ", jmain_mod.__doc__, re.M))
    port_cmds = set(re.findall(r"^  ([a-z0-9-]+) ", tmain.__doc__, re.M))
    assert len(jax_cmds) == 10 and jax_cmds <= port_cmds
    assert tmain.NOT_PORTED == {}
    assert tmain.main([]) == 0
    out = capsys.readouterr().out
    assert all(c in out for c in jax_cmds)
    for cmd in sorted(jax_cmds):
        with pytest.raises(SystemExit) as e:
            tmain.main([cmd, "--help"])
        assert e.value.code == 0, cmd
    assert tmain.main(["bogus"]) == 2


# ---------------------------------------------------------------------------
# config files
# ---------------------------------------------------------------------------

def test_hf_config_round_trip(tmp_path):
    """save_hf_config writes JAX's bytes; load_hf_config reads every
    field as JAX's does, for the tiny, demo and 7B shapes."""
    from cogstream_tpu import presets as jp
    from cogstream_tpu_torch import presets as tp

    for j, t in ((JConfig.tiny(), TConfig.tiny()), (jp.demo(), tp.demo()),
                 (jp.cogreasoner_7b(), tp.cogreasoner_7b())):
        jcfg_mod.save_hf_config(j, str(tmp_path / "j.json"))
        tcfg_mod.save_hf_config(t, str(tmp_path / "t.json"))
        assert (tmp_path / "t.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()
        assert dataclasses.asdict(tcfg_mod.load_hf_config(
            str(tmp_path / "j.json"))) == dataclasses.asdict(
            jcfg_mod.load_hf_config(str(tmp_path / "j.json")))


@pytest.mark.parametrize("files", [
    {},
    {"generation_config.json": {"do_sample": False, "eos_token_id": 7,
                                "repetition_penalty": 1.05}},
    {"generation_config.json": {"temperature": 0.7, "top_k": 20,
                                "top_p": 0.8,
                                "eos_token_id": [151645, 151643]},
     "preprocessor_config.json": {"patch_size": 14, "max_tokens": 8192,
                                  "image_mean": [0.4, 0.5, 0.6],
                                  "image_std": [0.2, 0.3, 0.4]},
     "processor_config.json": {"fps": 2, "max_frames": 180,
                               "video_merge_size": 2}},
])
def test_generation_and_processor_configs(tmp_path, files):
    for name, body in files.items():
        (tmp_path / name).write_text(json.dumps(body))
    d = str(tmp_path)
    jg, tg = (jcfg_mod.load_generation_config(d),
              tcfg_mod.load_generation_config(d))
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    assert tg.sampling_kwargs == jg.sampling_kwargs
    assert dataclasses.asdict(tcfg_mod.load_processor_config(d)) == \
        dataclasses.asdict(jcfg_mod.load_processor_config(d))
