"""The port's GPipe pipeline parallelism and ring sequence parallelism
against the JAX package's, on the CPU.

The port's side runs as gloo worlds of tests/torch_train_parallel_child.py
(``--suite _pp``, one process per rank, importing only the port): four
ranks run the pipeline forward at (stages, data, M) = (4, 1, 8) and (2,
2, 2), the ring and the stage-2 sp loss over four, and ``train_stage1``
on (data 2, pipe 2); two ranks run the pipeline at (2, 1, 4), the ring,
``qwen2_forward_sp``, the sp loss and ``Stage2Trainer`` with
``sequence_parallel=2``, and a pipelined train state saved for a
one-process resume. Two more ranks run ``train-stage1 --pipeline-stages
2`` and then ``train-stage2 --sequence-parallel 2`` under torchrun's
environment variables. They start first and run while the JAX references
compute on conftest's CPU devices; each world has its own deadline, and
its collectives time out before it. Tiny config, f32, LoRA dropout 0 on
both sides unless stated. Tolerances, each stated where it is asserted:

* forwards: JAX's own 2e-5 (tests/test_pipeline.py); the ring within
  1e-5 of each row's max |ref|, padding queries exactly zero;
* losses: rtol 1e-5; gradients: per leaf, within 1e-4 of its max |ref|;
* updated adapters: in units of the learning rate
  (tests/test_torch_train.py's rule);
* stages and data replicas: bit-equal where they hold the same values.

In one process: JAX's refusals with JAX's messages, the microbatch rule,
``PipeLayout``'s round trip, and dropout's draws across stages,
microbatches and ring positions.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogstream_tpu.config import CogReasonerConfig as JConfig
from cogstream_tpu.config import LoRAConfig as JLoRA
from cogstream_tpu.models import lora as jlora
from cogstream_tpu.models import qwen2 as jq
from cogstream_tpu.models.checkpoint import save_cogreasoner_to_hf
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.ops.ring_attention import ring_causal_gqa_attention
from cogstream_tpu.parallel import pipeline as jpipe
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.train import data as jdata
from cogstream_tpu.train import multimodal as jmm
from cogstream_tpu.train import stage1 as jstage1
from cogstream_tpu.train import stage2 as jstage2
from cogstream_tpu_torch.config import CogReasonerConfig as TConfig
from cogstream_tpu_torch.config import LoRAConfig as TLoRA
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import lora as tlora
from cogstream_tpu_torch.models import qwen2 as tq
from cogstream_tpu_torch.parallel import mesh as tmesh
from cogstream_tpu_torch.parallel import pipeline as tpipe
from cogstream_tpu_torch.parallel import sharding as tsh
from cogstream_tpu_torch.train import checkpoint as tckpt
from cogstream_tpu_torch.train import stage1 as tstage1
from cogstream_tpu_torch.train import stage2 as tstage2
from cogstream_tpu_torch.train import trainer as ttr

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "torch_train_parallel_child.py")
sys.path.insert(0, HERE)
from test_torch_train_parallel import (QA, _adapters_close, _flat,  # noqa
                                       _free_port, _grads_close, _losses,
                                       _nonzero_b, _spawn, _text_batch,
                                       _tree, _turns)
from torch_train_parallel_child import (LORA_SCALE, PIPE_CASES, S1_PP,  # noqa
                                        S2)

# seconds each world may take (its collectives give up after 120)
WORLD_TIMEOUT_S = {4: 240, 2: 240, "cli": 300}
COLLECTIVE_TIMEOUT_S = 120
LOSS = dict(rtol=1e-5, atol=1e-6)
FWD = dict(rtol=2e-5, atol=2e-5)
CHAIN = [
    {"Q": ["what is shown?"], "A": ["noise."],
     "info": {"Event_Time": 1, "relevance": [], "is_visual": True}},
    {"Q": ["and now?"], "A": ["more noise."],
     "info": {"Event_Time": 7, "relevance": [1], "is_visual": True}},
]


def _pp_inputs():
    """tests/test_pipeline.py's batch: B = 8 rows of 16 ids, the last
    row's last 4 positions padding; ``w`` the gradient cases' probe."""
    rng = np.random.default_rng(0)
    B, S = 8, 16
    ids = rng.integers(3, 100, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[-1, -4:] = -1
    w = np.random.default_rng(9).standard_normal((B, S, 64)).astype(
        np.float32)
    return {"ids": ids, "pos": pos, "w": w}


def _ring_inputs():
    """tests/test_sharding.py's ring inputs: [2, 64] of 4 / 2 heads of 8,
    the last 5 positions padding."""
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 2, 64, 4, 2, 8
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[:, -5:] = -1
    return {"q": rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            "k": rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            "pos": pos}


def _sp_inputs():
    rng = np.random.default_rng(1)
    B, S = 2, 64
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, -9:] = -1
    return {"ids": rng.integers(3, 200, size=(B, S)).astype(np.int32),
            "pos": pos}


def _clip(root):
    """40 frames of seeded noise at 10 fps as ``vidA``'s two segment
    files (tests/test_torch_qlora.py's clip)."""
    import cv2

    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (48, 64, 3), np.uint8) for _ in range(40)]
    os.makedirs(os.path.join(root, "vidA"))
    for name, part in (("segment_1.mp4", frames[:20]),
                       ("segment_2.mp4", frames[20:])):
        w = cv2.VideoWriter(os.path.join(root, "vidA", name),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for f in part:
            w.write(f)
        w.release()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Inputs on disk, then the port's worlds started."""
    d = str(tmp_path_factory.mktemp("train_pp"))
    cfg = JConfig.tiny()
    params = init_cogreasoner_params(jax.random.PRNGKey(0), cfg)
    cfg4 = dataclasses.replace(cfg.text, num_hidden_layers=4)
    params4 = jq.init_qwen2_params(jax.random.PRNGKey(0), cfg4)
    full4 = dataclasses.replace(cfg, text=cfg4)
    pp_lora = _nonzero_b(jax.tree.map(np.asarray, jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(1), full4, JLoRA()))["text"], 3)
    lora_s1 = jax.tree.map(np.asarray, jlora.init_qwen2_lora(
        jax.random.PRNGKey(0), cfg.text, JLoRA(dropout=0.0)))
    lora_s2 = jax.tree.map(np.asarray, jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(0), cfg, JLoRA(dropout=0.0,
                                          include_projector=True)))
    lora_mm = _nonzero_b(jax.tree.map(np.asarray, jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(1), cfg, JLoRA(include_projector=True))), 1)
    pool, text, mm = _turns(cfg)
    trees = {"params": jax.tree.map(np.asarray, params),
             "pp_params": jax.tree.map(np.asarray, params4),
             "pp_lora": pp_lora, "lora_s1": lora_s1, "lora_s2": lora_s2,
             "lora_mm": lora_mm}
    for name, tree in trees.items():
        np.savez(os.path.join(d, f"{name}.npz"), **_flat(tree))
    for name, b in (("batch_pool", pool), ("batch_text", text),
                    ("batch_mm", mm), ("batch_resume", _text_batch()),
                    ("pp_inputs", _pp_inputs()),
                    ("ring_inputs", _ring_inputs()),
                    ("sp_inputs", _sp_inputs())):
        np.savez(os.path.join(d, f"{name}.npz"), **b)
    with open(os.path.join(d, "qa.json"), "w") as f:
        json.dump(QA, f)
    save_cogreasoner_to_hf(params, cfg, os.path.join(d, "hf"),
                           dtype=jnp.float32)
    videos, queries = os.path.join(d, "videos"), os.path.join(d, "queries")
    _clip(videos)
    os.makedirs(queries)
    with open(os.path.join(queries, "vidA.json"), "w") as f:
        json.dump([CHAIN], f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_",
                                "LOCAL_RANK"))}
    procs = []
    for world in (4, 2):
        port = _free_port()
        for r in range(world):
            procs.append(_spawn(
                [sys.executable, CHILD, "--world", str(world), "--rank",
                 str(r), "--port", str(port), "--dir", d, "--suite", "_pp",
                 "--timeout", str(COLLECTIVE_TIMEOUT_S)], d,
                f"w{world}_pp_r{r}", env))
    cli = []
    ports = _free_port(), _free_port()
    hf = os.path.join(d, "hf")
    s1 = ["train-stage1", "--qa-json", os.path.join(d, "qa.json"),
          "--model-dir", hf, "--out", os.path.join(d, "pp_cli"),
          "--epochs", "1", "--batch-size", "4", "--max-len", "2048",
          "--pipeline-stages", "2", "--pipeline-microbatches", "2",
          "--device", "cpu"]
    s2 = ["train-stage2", "--model-dir", hf, "--video-dir", videos,
          "--query-dir", queries, "--out", os.path.join(d, "sp_cli"),
          "--sequence-parallel", "2", "--device", "cpu"]
    for r in range(2):
        # the two commands one after the other, each its own world
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1")
        script = " && ".join(
            f"MASTER_PORT={p} {sys.executable} -m cogstream_tpu_torch "
            + " ".join(args) for p, args in zip(ports, (s1, s2)))
        log, p = _spawn(["sh", "-c", script], d, f"cli_pp_r{r}", e)
        procs.append((log, p))
        cli.append(p)
    yield d, cfg, params, (pool, text, mm), cli
    for log, p in procs:
        if p.poll() is None:
            p.kill()
        log.close()


def _load(d, name):
    with np.load(os.path.join(d, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _tree_of(d, name):
    from torch_parallel_child import unflatten

    return unflatten(os.path.join(d, f"{name}.npz"))


@pytest.fixture(scope="module")
def jref(data):
    """The JAX package's results for the worlds' cases, on conftest's
    CPU devices: six independent groups, traced and compiled on threads
    side by side (JAX's compile dominates this module's wall)."""
    from concurrent.futures import ThreadPoolExecutor

    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    d, cfg, params, (pool, text, mm), _ = data
    cfg4 = dataclasses.replace(cfg.text, num_hidden_layers=4)
    params4 = jax.tree.map(jnp.asarray, _tree_of(d, "pp_params"))
    pp_lora = jax.tree.map(jnp.asarray, _tree_of(d, "pp_lora"))
    b = _pp_inputs()
    emb = jq.embed(params4, jnp.asarray(b["ids"]))
    pos = jnp.asarray(b["pos"])
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("sp",))

    def pipe_forwards():
        # JAX's schedule at each layout with the adapters; without them,
        # and for the gradients, one reference serves every layout (JAX's
        # output and gradients are the layout's function:
        # tests/test_pipeline.py)
        out = {"pp_plain": np.asarray(jax.jit(lambda e: jq.qwen2_forward(
            params4, e, pos, cfg4)[0])(emb))}
        for world in (4, 2):
            for stages, dp, M, _ in PIPE_CASES[world]:
                out[f"pp{stages}x{dp}x{M}_lora"] = np.asarray(
                    jpipe.pipeline_decoder_forward(
                        params4, emb, pos, cfg4,
                        jpipe.make_pipeline_mesh(stages, dp),
                        num_microbatches=M,
                        adapters=[(pp_lora, jnp.float32(1.0))]))
        return out

    def pipe_grad():
        def loss(ad):
            h = jpipe.pipeline_decoder_forward(
                params4, emb, pos, cfg4, jpipe.make_pipeline_mesh(2, 1),
                num_microbatches=4, adapters=[(ad, jnp.float32(1.0))],
                remat=True)
            return jnp.mean(h.astype(jnp.float32) * b["w"])
        return {"pp_grad": jax.grad(loss)(pp_lora)}

    def rings():
        r = _ring_inputs()
        args = [jnp.asarray(r[k]) for k in ("q", "k", "v", "pos", "pos")]
        out = {}
        for n in (4, 2):
            mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
            for chunk in (1024, 3):
                fn = shard_map(
                    lambda *a, n=n, c=chunk: ring_causal_gqa_attention(
                        *a, axis_name="sp", axis_size=n, kv_chunk=c),
                    mesh=mesh, in_specs=(P(None, "sp"),) * 5,
                    out_specs=P(None, "sp"))
                out[f"ring{n}_c{chunk}"] = np.asarray(fn(*args))
        s = _sp_inputs()
        out["fwd_sp"] = np.asarray(jq.qwen2_forward_sp(
            params["text"], jq.embed(params["text"], jnp.asarray(s["ids"])),
            jnp.asarray(s["pos"]), cfg.text, mesh2, axis="sp"))
        return out

    def mm_sp():
        # one reference for both worlds: JAX's sp loss is its dense loss
        # (tests/test_stage2_e2e.py)
        lora_mm = jax.tree.map(jnp.asarray, _tree_of(d, "lora_mm"))
        bm = {k: jnp.asarray(v) for k, v in mm.items()
              if k != "num_vis_tokens"}
        n_vis = int(mm["num_vis_tokens"])
        return {"mm_sp": jax.jit(jax.value_and_grad(
            lambda lo: jmm.multimodal_loss_fn(
                params, lo, bm, cfg, LORA_SCALE, num_vis_tokens=n_vis,
                remat=True, sp=(mesh2, "sp"))))(lora_mm)}

    def stage2_sp(mp):
        mp.setattr(jstage2, "LoRAConfig",
                   lambda **kw: JLoRA(dropout=0.0, **kw))
        tr = jstage2.Stage2Trainer(params, cfg, JTok(image_token_id=1000),
                                   jstage2.Stage2Config(
                                       **S2, sequence_parallel=2),
                                   os.path.join(d, "j_s2sp"),
                                   total_steps=20, log=lambda *a: None)
        losses = [tr.train_turn(dict(t)) for t in (pool, text)]
        return {"s2sp_losses": losses,
                "s2sp_lora": jax.tree.map(np.asarray, tr.state.lora)}

    def stage1_pp(mp):
        mp.setattr(jstage1, "LoRAConfig", lambda: JLoRA(dropout=0.0))
        logs = []
        st = jstage1.train_stage1(
            {"text": params["text"]}, cfg, JTok(image_token_id=1000),
            jdata.load_selector_dataset(os.path.join(d, "qa.json")),
            os.path.join(d, "j_s1pp"), jstage1.Stage1Config(
                **S1_PP, data_parallel=2, pipeline_stages=2),
            log=logs.append)
        return {"s1pp_logs": logs,
                "s1pp_lora": jax.tree.map(np.asarray, st.lora)}

    out = {}
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as ex:
        jobs = [ex.submit(f) for f in (pipe_forwards, pipe_grad, rings,
                                       mm_sp)]
        jobs += [ex.submit(f, mp) for f in (stage2_sp, stage1_pp)]
        for j in jobs:
            out.update(j.result())
    return out


@pytest.fixture(scope="module")
def worlds(data, jref):
    """Each rank's outputs: {world: [(json, npz) per rank]}; then the
    commands' exit."""
    d = data[0]
    out = {}
    for world in (4, 2):
        deadline = time.time() + WORLD_TIMEOUT_S[world]
        ranks = []
        for r in range(world):
            stem = os.path.join(d, f"w{world}_pp_r{r}")
            while not os.path.exists(stem + ".json"):
                if time.time() > deadline:
                    with open(stem + ".log") as f:
                        pytest.fail(f"world {world} rank {r} timed out:\n"
                                    + f.read()[-3000:])
                time.sleep(0.2)
            time.sleep(0.1)
            with open(stem + ".json") as f:
                res = json.load(f)
            if "error" in res:
                pytest.fail(f"world {world} rank {r}:\n{res['error']}")
            with np.load(stem + ".npz") as z:
                ranks.append((res, {k: z[k] for k in z.files}))
        out[world] = ranks
    deadline = time.time() + WORLD_TIMEOUT_S["cli"]
    for r, p in enumerate(data[4]):
        try:
            rc = p.wait(max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            with open(os.path.join(d, f"cli_pp_r{r}.log")) as f:
                pytest.fail(f"command rank {r} rc {rc}:\n"
                            + f.read()[-3000:])
    return out


def _rows(world_ranks, key, data_of):
    """The whole batch's rows from the ranks' local rows: data rank d's
    chunk from the first rank that holds it; every stage of a replica
    holds the same rows (asserted bit-equal)."""
    chunks = {}
    for res, arrays in world_ranks:
        d = data_of(res)
        if d in chunks:
            np.testing.assert_array_equal(arrays[key], chunks[d], err_msg=key)
        else:
            chunks[d] = arrays[key]
    return np.concatenate([chunks[d] for d in sorted(chunks)])


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case", [(w, c) for w in (4, 2)
                                        for c in PIPE_CASES[w]])
def test_pipeline_forward_matches_jax(worlds, jref, world, case):
    """``pipeline_decoder_forward`` at (stages, data, M) with LoRA
    adapters equals JAX's at the same layout, and without them JAX's
    forward, within JAX's own 2e-5; every stage holds the same outputs;
    each rank holds L / stages layers, and a forward takes M + stages - 2
    hops."""
    stages, dp, M, _ = case
    tag = f"pp{stages}x{dp}x{M}"
    for res, _ in worlds[world]:
        assert res[tag]["layers"] == 4 // stages
        assert res[tag]["hops"] == 2 * (M + stages - 2)
    for name, ref in (("plain", jref["pp_plain"]),
                      ("lora", jref[f"{tag}_lora"])):
        got = _rows(worlds[world], f"{tag}_{name}",
                    lambda res: res[tag]["data_index"])
        np.testing.assert_allclose(got, ref, **FWD)
    assert np.abs(jref[f"{tag}_lora"] - jref["pp_plain"]).max() > 1e-3


@pytest.mark.parametrize("world,case", [(w, c) for w in (4, 2)
                                        for c in PIPE_CASES[w] if c[3]])
def test_pipeline_remat_gradients_match_jax(worlds, jref, world, case):
    """``jax.grad`` of mean(h * w) (``w`` a seeded probe) through JAX's
    schedule at (2, 1, 4) with remat, and the port's autograd through its
    hops at (2, 1, 4) and (4, 1, 8) (gathered over the stages): each leaf
    within 1e-4 of its max; the backward took as many hops as the
    forward."""
    stages, dp, M, _ = case
    tag = f"pp{stages}x{dp}x{M}"
    for res, arrays in worlds[world]:
        _grads_close(jref["pp_grad"], _tree(arrays, f"{tag}_grad"))
        fwd = 2 * (M + stages - 2)
        assert res[tag]["hops_with_grad"] == fwd + 2 * (M + stages - 2)


def test_train_stage1_on_data2_pipe2_matches_jax(data, worlds, jref):
    """``train_stage1`` with ``pipeline_stages=2, data_parallel=2`` (4
    rows a step, 2 microbatches): the logged losses within the log's 4
    decimals of JAX's; the gathered adapters and the saved
    ``language_module`` (the one-process file) in units of lr, and it
    loads as a whole tree; only rank 0 logs."""
    d = data[0]
    res0 = worlds[4][0][0]["s1pp"]
    assert res0["mesh"] == {"data": 2, "pipe": 2} and res0["step"] == 2
    assert res0["layers"] == 1       # a stage's adapters: L / 2
    np.testing.assert_allclose(_losses(res0["logs"]),
                               _losses(jref["s1pp_logs"]), atol=1.1e-4,
                               rtol=0)
    assert all(not res["s1pp"]["logs"] for res, _ in worlds[4][1:])
    for _, arrays in worlds[4]:
        _adapters_close(jref["s1pp_lora"], _tree(arrays, "s1pp_whole"), 1e-3)
    saved = _load(os.path.join(d, "s1pp"), "language_module")
    want = _load(os.path.join(d, "j_s1pp"), "language_module")
    assert sorted(saved) == sorted(want)
    dd = max(np.abs(saved[k] - want[k]).max() for k in want)
    assert dd <= 2.01 * 1e-3, dd
    tree = tckpt.load_lora_adapter(os.path.join(d, "s1pp",
                                                "language_module.npz"),
                                   device="cpu")
    assert len(tree["layers"]) == TConfig.tiny().text.num_hidden_layers


def test_pipelined_state_resumes_in_one_process(data, worlds):
    """Two text steps on (data 1, pipe 2) (dropout 0, accumulation 2),
    the state saved (gathered, one file), restored in one process and
    stepped twice more: its losses, moments and the continued adapters
    equal a one-process run of the same steps (rtol 1e-5; moments 1e-4 of
    each leaf's max; adapters in units of lr)."""
    d, cfg = data[0], TConfig.tiny()
    assert os.listdir(os.path.join(d, "pp_resume")) == ["step_2.pt"]
    model = bridge.cogreasoner_from_params(_tree_of(d, "params"), cfg,
                                           device="cpu")
    loss_fn = ttr.bind_text_loss(TLoRA(dropout=0.0), remat=True)
    batch = ttr.to_device(_load(d, "batch_resume"), "cpu")

    def fresh():
        tx = ttr.make_optimizer(1e-2, total_steps=6, warmup_steps=1,
                                grad_accum=2)
        lora = bridge.lora_from_params(_tree_of(d, "lora_s1"), device="cpu")
        return tx, ttr.init_train_state(tx, lora)

    tx, state = fresh()
    step = ttr.make_train_step(tx, loss_fn)
    losses = []
    for _ in range(2):
        state, loss = step(model.text, state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(worlds[2][0][0]["pp_resume"]["losses"],
                               losses, **LOSS)
    tx2, template = fresh()
    got = tckpt.restore_train_state(os.path.join(d, "pp_resume"), template)
    assert got.step == 2
    for key in ("mu", "nu"):
        assert len(got.opt_state["inner"][key]) == len(
            state.opt_state["inner"][key])
        for a, b in zip(got.opt_state["inner"][key],
                        state.opt_state["inner"][key]):
            assert float((a - b).abs().max()) <= \
                1e-4 * float(b.abs().max()), key
    step2 = ttr.make_train_step(tx2, loss_fn)
    for _ in range(2):
        state, _ = step(model.text, state, batch)
        got, _ = step2(model.text, got, batch)
    _adapters_close(bridge.lora_to_params(state.lora),
                    dict(tlora.iter_leaves(bridge.lora_to_params(got.lora))),
                    1e-2)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("chunk", [1024, 3])
def test_ring_attention_matches_jax(worlds, jref, world, chunk):
    """``ring_causal_gqa_attention`` over 4 and 2 ranks, at the default
    and a 3-slot fold chunk (a short last chunk): each valid query within
    1e-5 of its row's max |ref| of JAX's ring, padding queries exactly
    zero."""
    got = np.concatenate([a[f"ring_c{chunk}"] for _, a in worlds[world]],
                         axis=1)
    ref = jref[f"ring{world}_c{chunk}"]
    valid = _ring_inputs()["pos"] >= 0
    scale = np.abs(ref).max(axis=(2, 3), keepdims=True)
    assert (np.abs(got - ref) <= 1e-5 * scale)[valid].all()
    assert np.abs(got[~valid]).max() == 0.0


def test_qwen2_forward_sp_matches_jax(worlds, jref):
    """``qwen2_forward_sp`` on two ranks, its shards in rank order, equals
    JAX's at every position within JAX's 2e-5."""
    got = np.concatenate([a["fwd_sp"] for _, a in worlds[2]], axis=1)
    np.testing.assert_allclose(got, jref["fwd_sp"], **FWD)


@pytest.mark.parametrize("world", [4, 2])
def test_stage2_sp_loss_and_grads_match_jax(worlds, jref, world):
    """``multimodal_loss_fn(sp=)`` on ``dryrun_multichip``'s batch over 4
    and 2 ranks: the shares' sum rtol 1e-5 of JAX's sp loss over 2 (its
    dense loss, tests/test_stage2_e2e.py), each LoRA leaf's
    gradient (summed over the sp group once) within 1e-4 of its max;
    every rank's sum and gradients the same; the shares differ (each is
    its shard's); a layer's ring takes n - 1 hops in the forward, as many
    in remat's recompute and in the backward."""
    jloss, jgrad = jref["mm_sp"]
    shares = []
    for res, arrays in worlds[world]:
        np.testing.assert_allclose(res["mm_sp"]["loss"], float(jloss),
                                   **LOSS)
        _grads_close(jgrad, _tree(arrays, "mm_sp_grad"))
        shares.append(res["mm_sp"]["share"])
        assert res["mm_sp"]["hops"] == 3 * 2 * (world - 1)
    np.testing.assert_allclose(sum(shares), float(jloss), **LOSS)
    assert len(set(shares)) > 1


def test_stage2_trainer_sequence_parallel_matches_jax(data, worlds, jref):
    """Two ``Stage2Trainer`` turns with ``sequence_parallel=2``: losses
    rtol 1e-5 of JAX's, the (replicated) adapters in units of lr and
    bit-equal on both ranks; ``finish`` wrote the one-process file."""
    trees = []
    for res, arrays in worlds[2]:
        np.testing.assert_allclose(res["s2sp"]["losses"],
                                   jref["s2sp_losses"], **LOSS)
        trees.append(_tree(arrays, "s2sp_whole"))
        _adapters_close(jref["s2sp_lora"], trees[-1], 1e-3)
    for k in trees[0]:
        np.testing.assert_array_equal(trees[0][k], trees[1][k], err_msg=k)
    assert os.path.exists(os.path.join(data[0], "s2sp_r0",
                                       "full_module.npz"))


def test_training_commands_under_torchrun(data, worlds):
    """``train-stage1 --pipeline-stages 2 --pipeline-microbatches 2`` and
    ``train-stage2 --sequence-parallel 2`` under torchrun's environment
    (gloo, ``--device cpu``): each writes its adapter file, which loads
    whole; only rank 0 prints."""
    d = data[0]
    with open(os.path.join(d, "cli_pp_r0.log")) as f:
        r0 = f.read()
    with open(os.path.join(d, "cli_pp_r1.log")) as f:
        r1 = f.read()
    assert "stage1: 2 steps" in r0 and "stage1:" not in r1
    assert "vidA.json: 2 turns, mean loss" in r0 and "vidA.json" not in r1
    tree = tckpt.load_lora_adapter(
        os.path.join(d, "pp_cli", "language_module.npz"), device="cpu")
    assert len(tree["layers"]) == TConfig.tiny().text.num_hidden_layers
    full = np.load(os.path.join(d, "sp_cli", "full_module.npz"))
    assert any(k.startswith("projector.") for k in full.files)


@pytest.mark.parametrize("index", [0, 1])
def test_stage_loads_only_its_layers(data, index):
    """``train-stage1 --pipeline-stages``'s loader
    (``qwen2_from_state_dict(pipe=)``) builds this stage's view from the
    HF checkpoint: its layers are the whole load's ``[lo, hi)`` and the
    replicated tensors the whole load's, bit for bit, and it holds no
    tensor of another stage's layers."""
    from cogstream_tpu_torch.models.checkpoint import qwen2_from_state_dict
    from cogstream_tpu_torch.models.safetensors_io import CheckpointReader

    cfg = TConfig.tiny().text
    sd = CheckpointReader(os.path.join(data[0], "hf"))
    whole = qwen2_from_state_dict(sd, cfg, device="cpu")
    pipe = _fake_pipe(2, index)
    stage = qwen2_from_state_dict(sd, cfg, device="cpu", pipe=pipe)
    assert stage.pp.mesh is pipe and stage.pp.lo == index
    want = whole.state_dict()
    got = stage.state_dict()
    w = cfg.num_hidden_layers // 2
    for k, v in got.items():
        if k.startswith("layers."):
            li, rest = k.split(".", 2)[1:]
            assert int(li) < w
            k = f"layers.{int(li) + index * w}.{rest}"
        assert torch.equal(v, want[k]), k
    assert len(got) == len(want) - sum(
        k.startswith("layers.") for k in want) // 2
    with pytest.raises(ValueError, match="unquantized"):
        qwen2_from_state_dict(sd, cfg, device="cpu", pipe=pipe,
                              quantize_text_bits=4)


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------

def _raises_alike(jfn, tfn, match):
    """Both packages raise ``ValueError`` with the same message."""
    with pytest.raises(ValueError, match=match) as je:
        jfn()
    with pytest.raises(ValueError, match=match) as te:
        tfn()
    assert str(te.value) == str(je.value).replace(", SCALING.md", "")


def _fake_pipe(pipe, index=0, data=1):
    return types.SimpleNamespace(pipe=pipe, pipe_index=index, data=data,
                                 data_index=0, pipe_group=None,
                                 data_group=None)


def test_jax_refusals_with_jax_messages(tmp_path):
    """Every ``ValueError`` of JAX's pipeline and sequence-parallel paths,
    with JAX's message: M not dividing B, stages not dividing L, the data
    axis not dividing the microbatch, too few devices for the pipe mesh
    and for the sp axis, pipeline with a model axis, sp with a model axis,
    sp not a power of two, sp not dividing max_seq_len."""
    cfg = JConfig.tiny()
    jp = init_cogreasoner_params(jax.random.PRNGKey(0), cfg)
    tcfg = TConfig.tiny()
    model = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, jp),
                                           tcfg, device="cpu")
    b = _pp_inputs()
    emb = jq.embed(jp["text"], jnp.asarray(b["ids"]))
    temb = tq.embed(model.text, torch.as_tensor(b["ids"]))
    tpos = torch.as_tensor(b["pos"])
    jmesh2 = jpipe.make_pipeline_mesh(2, 1)
    pipe2 = _fake_pipe(2)
    _raises_alike(
        lambda: jpipe.pipeline_decoder_forward(
            jp["text"], emb, jnp.asarray(b["pos"]), cfg.text, jmesh2,
            num_microbatches=3),
        lambda: tpipe.pipeline_decoder_forward(
            tsh.stage_qwen2(model.text, pipe2), temb, tpos, pipe2,
            num_microbatches=3),
        "microbatches")
    # the port's forward runs a stage's view only; the view raises JAX's
    # error when the stages do not divide the layers
    with pytest.raises(ValueError, match="stage's view"):
        tpipe.pipeline_decoder_forward(model.text, temb, tpos, pipe2,
                                       num_microbatches=4)
    cfg3 = dataclasses.replace(cfg.text, num_hidden_layers=3)
    p3 = jq.init_qwen2_params(jax.random.PRNGKey(0), cfg3)
    t3 = bridge.qwen2_from_params(jax.tree.map(np.asarray, p3),
                                  dataclasses.replace(tcfg.text,
                                                      num_hidden_layers=3),
                                  device="cpu")
    _raises_alike(
        lambda: jpipe.pipeline_decoder_forward(
            p3, emb, jnp.asarray(b["pos"]), cfg3, jmesh2,
            num_microbatches=4),
        lambda: tsh.stage_qwen2(t3, pipe2),
        "stages must divide")
    jmesh22 = jpipe.make_pipeline_mesh(2, 2)
    pipe22 = _fake_pipe(2, data=2)
    _raises_alike(
        lambda: jpipe.pipeline_decoder_forward(
            jp["text"], emb, jnp.asarray(b["pos"]), cfg.text, jmesh22,
            num_microbatches=8),
        lambda: tpipe.pipeline_decoder_forward(
            tsh.stage_qwen2(model.text, pipe22), temb[:4], tpos[:4], pipe22,
            num_microbatches=8),
        "must divide microbatch size")
    n = len(jax.devices())
    with pytest.raises(ValueError, match=f"needs {2 * n} devices"):
        jpipe.make_pipeline_mesh(2, n)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_pipeline_mesh(2, 1)
    # the sp checks, in JAX's order, before anything is built
    jtok = JTok(image_token_id=cfg.image_token_index)
    for kw, match in (({"sequence_parallel": 2, "model_parallel": 2},
                       "exclusive"),
                      ({"sequence_parallel": 3}, "power of two"),
                      ({"sequence_parallel": 16, "max_seq_len": 3000},
                       "must divide"),
                      ({"sequence_parallel": 2 * n}, "needs")):
        with pytest.raises(ValueError, match=match) as je:
            jstage2.Stage2Trainer(jp, cfg, jtok, jstage2.Stage2Config(**kw),
                                  str(tmp_path / "j"), log=lambda *a: None)
        world = n if match == "needs" else 1
        with pytest.raises(ValueError, match=match) as te:
            tstage2.check_parallel(tstage2.Stage2Config(**kw), world)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tstage2.Stage2Trainer(model, tcfg, None,
                              tstage2.Stage2Config(sequence_parallel=2),
                              str(tmp_path / "t"))
    with pytest.raises(ValueError, match="exclusive with model_parallel"):
        jstage1.train_stage1(jp, cfg, jtok, [], str(tmp_path / "j1"),
                             jstage1.Stage1Config(pipeline_stages=2,
                                                  model_parallel=2))
    with pytest.raises(ValueError, match="exclusive with model_parallel"):
        tstage1.train_stage1(model.text, tcfg, None, [], str(tmp_path / "t1"),
                             tstage1.Stage1Config(pipeline_stages=2,
                                                  model_parallel=2))
    assert not os.path.exists(tmp_path / "t1")


@pytest.mark.parametrize("B,stages", [(8, 2), (10, 2), (4, 2), (12, 4),
                                      (6, 1), (16, 4)])
def test_auto_microbatches_is_jax_rule(B, stages):
    """The smallest divisor of B that is at least 4 x stages (B itself
    when none is): JAX's rule, in the forward and in stage 1."""
    want = next(c for c in range(min(B, 4 * stages), B + 1) if B % c == 0)
    assert tpipe.auto_microbatches(B, stages) == want
    assert tstage1.pipeline_microbatches(tstage1.Stage1Config(
        batch_size=B, pipeline_stages=stages)) == want


class _Gather:
    """A thread group's all-gather for :class:`tsh.PipeLayout`."""

    def __init__(self, n):
        import threading

        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.local = threading.local()

    def __call__(self, x, group, dim=-1):
        self.slots[self.local.rank] = x.detach().clone()
        self.barrier.wait()
        out = torch.cat(list(self.slots), dim=dim)
        self.barrier.wait()
        return out


@pytest.mark.parametrize("stages", [2, 4])
def test_pipe_layout_round_trip(monkeypatch, stages):
    """``PipeLayout.shard`` for each stage keeps its layers' adapters (and
    a replicated lm_head adapter), ``shard_leaves`` the same leaves of a
    per-leaf list, and ``gather`` over a thread group gives the whole tree
    back exactly."""
    import threading

    cfg = dataclasses.replace(TConfig.tiny().text, num_hidden_layers=4)
    tree = tlora.init_qwen2_lora(torch.Generator().manual_seed(0), cfg,
                                 TLoRA(), device="cpu")
    tree = tlora.map_leaves(lambda t: t + torch.randn_like(t), tree)
    tree["lm_head"] = {"a": torch.randn(64, 8), "b": torch.randn(8, 300)}
    gather = _Gather(stages)
    monkeypatch.setattr(tsh, "all_gather", gather)
    flat = [t for _, t in tlora.iter_leaves(tree)]
    back = [None] * stages

    def rank(r):
        gather.local.rank = r
        mesh = types.SimpleNamespace(pipe=stages, pipe_index=r, data=1,
                                     pipe_group=object())
        lay = tsh.PipeLayout(tree, mesh)
        part = lay.shard(tree)
        assert len(part["layers"]) == 4 // stages
        assert part["layers"][0]["attn"]["q_proj"]["a"].requires_grad
        assert torch.equal(part["layers"][0]["mlp"]["up_proj"]["b"],
                           tree["layers"][r * 4 // stages]["mlp"]["up_proj"]
                           ["b"])
        for a, (_, b) in zip(lay.shard_leaves(flat), tlora.iter_leaves(part)):
            assert torch.equal(a, b)
        back[r] = lay.gather(part)

    ths = [threading.Thread(target=rank, args=(r,)) for r in range(stages)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    for r in range(stages):
        for (k, a), (_, b) in zip(tlora.iter_leaves(back[r]),
                                  tlora.iter_leaves(tree)):
            assert torch.equal(a, b.detach()), (r, k)


def test_dropout_draws_fold_stage_microbatch_and_ring_position(monkeypatch):
    """LoRA dropout's generators: the pipeline's (a stage's view, as
    ``train_stage1`` runs it) number each stage's layers from 0 and differ
    across stages (the stage folds into the seed) and microbatches, the
    ring's across positions, and each (layer, site) draws once a forward;
    at dropout 0 (or without a seed) no generator is made."""
    cfg = TConfig.tiny()
    model = bridge.cogreasoner_from_params(jax.tree.map(
        np.asarray, init_cogreasoner_params(jax.random.PRNGKey(0),
                                            JConfig.tiny())), cfg,
        device="cpu").text
    seeds = []
    make = tq.site_generator

    def spy(seed, *ids, device=None):
        seeds.append((seed, ids))
        return make(seed, *ids, device=device)

    monkeypatch.setattr(tq, "site_generator", spy)
    b = _pp_inputs()
    emb = tq.embed(model, torch.as_tensor(b["ids"]))
    pos = torch.as_tensor(b["pos"])
    draws = {}
    for s in (0, 1):
        seeds.clear()
        pipe = _fake_pipe(2, s)
        stage = tsh.stage_qwen2(model, pipe)
        assert len(stage.layers) == 1 and stage.pp.lo == s
        tpipe.pipeline_decoder_forward(stage, emb, pos, pipe,
                                       num_microbatches=2, dropout_rate=0.1,
                                       dropout_seed=7)
        draws[s] = list(seeds)
    # 3 ticks a stage, one layer a stage, 7 sites a layer
    for s in (0, 1):
        assert len(draws[s]) == 3 * 7
        assert all(ids[0] == 0 for _, ids in draws[s])   # the stage's layer
        assert sorted({ids[1] for _, ids in draws[s]}) == list(range(7))
    by_mb = {}
    for seed, ids in draws[0][:14]:
        by_mb.setdefault(seed, set()).add(ids)
    assert len(by_mb) == 2                  # microbatches 0 and 1
    first_seed = {s: draws[s][0][0] for s in (0, 1)}
    assert first_seed[0] != first_seed[1]   # stages fold in
    assert first_seed[0] == tq.fold_seed(7, 0, 0)
    assert first_seed[1] == tq.fold_seed(7, 1, 0)
    # the ring position folds in; the projector's draws do not
    sp = []
    for r in (0, 1):
        seeds.clear()
        mesh = types.SimpleNamespace(size=2, sp_index=r, sp_group=None)
        tq.qwen2_forward_sp(model, emb[:2], pos[:2], mesh, dropout_rate=0.1,
                            dropout_seed=7)
        sp.append({seed for seed, _ in seeds})
        assert sp[-1] == {tq.fold_seed(7, r)}
    assert sp[0] != sp[1]
    seeds.clear()
    pipe = _fake_pipe(1)
    tpipe.pipeline_decoder_forward(tsh.stage_qwen2(model, pipe), emb, pos,
                                   pipe, num_microbatches=2,
                                   dropout_rate=0.0, dropout_seed=7)
    tq.qwen2_forward_sp(model, emb[:2], pos[:2], mesh, dropout_rate=0.1)
    assert seeds == []


def test_one_stage_pipeline_and_one_rank_ring_equal_one_process():
    """With one stage (and one data rank) the schedule is the plain
    forward within 1e-6 (microbatches are row blocks of one product); with
    one rank the ring is the attention within 1e-6."""
    from cogstream_tpu_torch.ops.attention import causal_gqa_attention
    from cogstream_tpu_torch.ops.ring_attention import (
        ring_causal_gqa_attention as tring)

    cfg = TConfig.tiny()
    model = bridge.cogreasoner_from_params(jax.tree.map(
        np.asarray, init_cogreasoner_params(jax.random.PRNGKey(0),
                                            JConfig.tiny())), cfg,
        device="cpu").text
    b = _pp_inputs()
    emb = tq.embed(model, torch.as_tensor(b["ids"]))
    pos = torch.as_tensor(b["pos"])
    with torch.no_grad():
        want = tq.qwen2_forward_train(model, emb, pos)
        pipe = _fake_pipe(1)
        stage = tsh.stage_qwen2(model, pipe)
        for M in (1, 4, 8):
            got = tpipe.pipeline_decoder_forward(stage, emb, pos, pipe,
                                                 num_microbatches=M)
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    r = {k: torch.as_tensor(v) for k, v in _ring_inputs().items()}
    want = causal_gqa_attention(r["q"], r["k"], r["v"], r["pos"],
                                r["pos"] >= 0, r["pos"])
    got = tring(r["q"], r["k"], r["v"], r["pos"], r["pos"], None)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
