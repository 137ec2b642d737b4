"""The port's data- and tensor-parallel LoRA training against the JAX
package's mesh training, on the CPU.

The port's side runs as gloo worlds (tests/torch_train_parallel_child.py,
one process per rank, importing only the port): a (data 2, model 2) world
of four ranks, a (data 1, model 2) world of two, and the ``train-stage1
--data-parallel 2`` command under torchrun's environment variables on two
more. They start first and run while the JAX references compute on
conftest's CPU devices. Tiny config, f32, LoRA dropout 0 on both sides
unless stated. Tolerances, each stated where it is asserted:

* losses: rtol 1e-5 (f32, summation order); the stage-1 log's 4 decimals;
* gradients: per leaf, within 1e-4 of the leaf's own max |ref|;
* updated adapters: in units of the learning rate
  (tests/test_torch_train.py's rule);
* replicated leaves, their gradients, data replicas: bit-equal.

In one process: the vocab-parallel loss (slices combined through a
thread-simulated group), the W8A8 straight-through product on row and
column shards (threads again), ``lora_specs_like`` against JAX's, the
``shard_lora`` / ``LoraLayout.gather`` round trip, ``shard_batch`` and the
refusals.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
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
from cogstream_tpu.models.checkpoint import save_cogreasoner_to_hf
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.ops.quant import quantize_tree
from cogstream_tpu.parallel import mesh as jmesh
from cogstream_tpu.parallel import sharding as jsh
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.train import data as jdata
from cogstream_tpu.train import multimodal as jmm
from cogstream_tpu.train import stage1 as jstage1
from cogstream_tpu.train import stage2 as jstage2
from cogstream_tpu_torch.config import CogReasonerConfig as TConfig
from cogstream_tpu_torch.config import LoRAConfig as TLoRA
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import lora as tlora
from cogstream_tpu_torch.parallel import sharding as tsh
from cogstream_tpu_torch.train import checkpoint as tckpt
from cogstream_tpu_torch.train import stage1 as tstage1
from cogstream_tpu_torch.train import trainer as ttr

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "torch_train_parallel_child.py")
sys.path.insert(0, HERE)
from torch_train_parallel_child import CLI_S1, LORA_SCALE, S1, S2  # noqa

WORLD_TIMEOUT_S = 300
LOSS = dict(rtol=1e-5, atol=1e-6)
QA = {"vid1": {"QAs": [
    {"QA_pairs": [{"Q": "q0", "A": "a0"}], "relevance": [], "is_visual": True},
    {"QA_pairs": [{"Q": "q1", "A": "a1"}], "relevance": [1],
     "is_visual": False},
    {"QA_pairs": [{"Q": "q2", "A": "a2"}], "relevance": [1, 0],
     "is_visual": True},
    {"QA_pairs": [{"Q": "q3 ü", "A": "a3"}], "relevance": [0, 1, 1],
     "is_visual": True},
]}}


def _flat(tree, prefix=""):
    out = {}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nonzero_b(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, tree)


def _turns(cfg):
    """Two stage-2 turns (one with a pooling plan, one text-only) and the
    multimodal batch of ``dryrun_multichip`` (B = 2)."""
    t, gh, gw, ms = 2, 4, 4, 2
    merged = (gh // ms) * (gw // ms)
    rng = np.random.default_rng(2)
    images = types.SimpleNamespace(
        pixel_values=rng.normal(size=(t * gh * gw, 3 * 14 * 14)).astype(
            np.float32),
        grid_sizes=np.array([[t, gh, gw]]), merge_sizes=np.array([ms]))
    keep = np.ones((t * merged,), bool)
    keep[merged + 1:] = False
    prompt = ("<|im_start|>user\n" + "<image>" * (t * merged) +
              "what?<|im_end|>\n<|im_start|>assistant\n")
    tok = JTok(image_token_id=cfg.image_token_index)
    pool = jstage2.pack_turn_batch(tok, cfg, prompt, "an answer", images,
                                   keep, 2048,
                                   minor_frames=np.array([False, True]))
    text = jstage2.pack_turn_batch(
        tok, cfg, "<|im_start|>user\nhi?<|im_end|>\n", "yes", None, None,
        2048)
    import __graft_entry__ as graft

    _, mm, n_vis = graft._example(cfg, tiny=True)
    mm = {k: np.asarray(v) for k, v in mm.items()}
    mm["num_vis_tokens"] = np.asarray(n_vis)
    return pool, text, mm


def _text_batch(B=2, S=24, seed=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(16, 272, (B, S)).astype(np.int32)
    ids[1, -5:] = 0
    labels = np.full((B, S), -100, np.int32)
    labels[:, 12:] = ids[:, 12:]
    labels[1, -5:] = -100
    return {"input_ids": ids, "labels": labels}


def _spawn(cmd, d, name, env):
    log = open(os.path.join(d, f"{name}.log"), "w")
    return log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                 env=env, cwd=REPO)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Inputs on disk, then the three port worlds started."""
    d = str(tmp_path_factory.mktemp("train_tp"))
    cfg = JConfig.tiny()
    params = init_cogreasoner_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.asarray, params)
    trees = {
        "params": host,
        "params_int8": quantize_tree(host, bits=8),
        # group 16: a rank's 32 rows of a row-parallel weight hold whole
        # groups (the default 64 does not divide them at this width)
        "params_nf4": quantize_tree(host, bits=4, group_size=16)}
    lora_s1 = jax.tree.map(np.asarray, jlora.init_qwen2_lora(
        jax.random.PRNGKey(0), cfg.text, JLoRA(dropout=0.0)))
    lora_s2 = jax.tree.map(np.asarray, jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(0), cfg, JLoRA(dropout=0.0,
                                          include_projector=True)))
    lora_mm = _nonzero_b(jax.tree.map(np.asarray, jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(1), cfg, JLoRA(include_projector=True))), 1)
    pool, text, mm = _turns(cfg)
    files = {**trees, "lora_s1": lora_s1, "lora_s2": lora_s2,
             "lora_mm": lora_mm}
    for name, tree in files.items():
        np.savez(os.path.join(d, f"{name}.npz"), **_flat(tree))
    for name, b in (("batch_pool", pool), ("batch_text", text),
                    ("batch_mm", mm), ("batch_resume", _text_batch())):
        np.savez(os.path.join(d, f"{name}.npz"), **b)
    with open(os.path.join(d, "qa.json"), "w") as f:
        json.dump(QA, f)
    save_cogreasoner_to_hf(params, cfg, os.path.join(d, "hf"),
                           dtype=jnp.float32)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_",
                                "LOCAL_RANK"))}
    procs = []
    for world in (4, 2):
        port = _free_port()
        for r in range(world):
            procs.append(_spawn(
                [sys.executable, CHILD, "--world", str(world), "--rank",
                 str(r), "--port", str(port), "--dir", d], d,
                f"w{world}_r{r}", env))
    port = _free_port()
    cli = []
    for r in range(2):
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="1")
        args = ["train-stage1", "--qa-json", os.path.join(d, "qa.json"),
                "--model-dir", os.path.join(d, "hf"), "--out",
                os.path.join(d, "dp_cli"), "--epochs",
                str(CLI_S1["epochs"]), "--batch-size",
                str(CLI_S1["batch_size"]), "--max-len",
                str(CLI_S1["max_len"]), "--lr", str(CLI_S1["learning_rate"]),
                "--data-parallel", "2", "--device", "cpu"]
        log, p = _spawn([sys.executable, "-m", "cogstream_tpu_torch"] + args,
                        d, f"cli_r{r}", e)
        procs.append((log, p))
        cli.append(p)
    yield d, cfg, params, trees, (pool, text, mm), cli
    for log, p in procs:
        if p.poll() is None:
            p.kill()
        log.close()


def _one_device_mesh(*args, **kwargs):
    return jmesh.make_mesh(1, 1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def jref(data):
    """The JAX package's results for the worlds' cases."""
    d, cfg, params, trees, (pool, text, mm), _ = data
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstage1, "LoRAConfig", lambda: JLoRA(dropout=0.0))
        # JAX's train_stage1 with data_parallel=2 on a (2, 2) mesh
        mp.setattr(jstage1, "make_mesh", lambda dp, tp: jmesh.make_mesh(
            dp, 2, devices=jax.devices()[:2 * dp]))
        logs = []
        st = jstage1.train_stage1(
            {"text": params["text"]}, cfg, JTok(image_token_id=1000),
            jdata.load_selector_dataset(os.path.join(d, "qa.json")),
            os.path.join(d, "j_s1"), jstage1.Stage1Config(
                **S1, data_parallel=2), log=logs.append)
        out["s1_logs"] = logs
        out["s1_lora"] = jax.tree.map(np.asarray, st.lora)
    lora_mm = jax.tree.map(jnp.asarray, _load_tree(d, "lora_mm"))

    def mm_grad(tree, batch):
        b = {k: jnp.asarray(v) for k, v in batch.items()
             if k != "num_vis_tokens"}
        n_vis = int(batch["num_vis_tokens"])
        return jax.value_and_grad(lambda lo: jmm.multimodal_loss_fn(
            tree, lo, b, cfg, LORA_SCALE, num_vis_tokens=n_vis,
            remat=True))(lora_mm)

    out["mm"] = mm_grad(params, mm)
    for name in ("params_int8", "params_nf4"):
        out[name] = mm_grad(jax.tree.map(jnp.asarray, trees[name]), pool)
    # the int8 base's decoder W8A8 (stage 2's --w8a8-forward), one device
    w8_cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, w8a8_prefill=True))
    b = {k: jnp.asarray(v) for k, v in pool.items() if k != "num_vis_tokens"}
    out["params_int8_w8a8"] = jax.value_and_grad(
        lambda lo: jmm.multimodal_loss_fn(
            jax.tree.map(jnp.asarray, trees["params_int8"]), lo, b, w8_cfg,
            LORA_SCALE, num_vis_tokens=int(pool["num_vis_tokens"]),
            remat=True))(lora_mm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstage2, "LoRAConfig",
                   lambda **kw: JLoRA(dropout=0.0, **kw))
        mp.setattr(jstage2, "make_mesh", _one_device_mesh)
        tr = jstage2.Stage2Trainer(params, cfg, JTok(image_token_id=1000),
                                   jstage2.Stage2Config(**S2),
                                   os.path.join(d, "j_s2"), total_steps=20,
                                   log=lambda *a: None)
        out["s2_losses"] = [tr.train_turn(dict(b)) for b in (pool, text)]
        out["s2_lora"] = jax.tree.map(np.asarray, tr.state.lora)
    return out


def _load_tree(d, name):
    from torch_parallel_child import unflatten

    return unflatten(os.path.join(d, f"{name}.npz"))


@pytest.fixture(scope="module")
def worlds(data, jref):
    """Each rank's outputs: {world: [(json, npz) per rank]}."""
    d = data[0]
    deadline = time.time() + WORLD_TIMEOUT_S
    out = {}
    for world in (4, 2):
        ranks = []
        for r in range(world):
            stem = os.path.join(d, f"w{world}_r{r}")
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
    for r, p in enumerate(data[5]):
        try:
            rc = p.wait(max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            with open(os.path.join(d, f"cli_r{r}.log")) as f:
                pytest.fail(f"train-stage1 rank {r} rc {rc}:\n"
                            + f.read()[-3000:])
    return out


def _tree(arrays, tag):
    """The ``tag/...`` entries of a rank's npz as {leaf path: array}."""
    n = len(tag) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(tag + "/")}


def _adapters_close(ref, got, lr):
    ref = dict(tlora.iter_leaves(ref))
    assert ref.keys() == got.keys()
    dd = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert dd.max() <= 2.01 * lr, dd.max() / lr
    assert np.mean(dd > 1e-3 * lr) < 0.01, np.mean(dd > 1e-3 * lr)


def _grads_close(ref, got, rel=1e-4):
    ref = dict(tlora.iter_leaves(jax.tree.map(np.asarray, ref)))
    assert ref.keys() == got.keys()
    for k in ref:
        bound = rel * max(float(np.abs(ref[k]).max()), 1e-30)
        assert np.abs(got[k] - ref[k]).max() <= bound, (k, bound)


def _losses(logs):
    return [float(m.split(" loss ")[1].split()[0]) for m in logs
            if " loss " in m]


# ---------------------------------------------------------------------------
# the (data 2, model 2) world
# ---------------------------------------------------------------------------

def test_stage1_on_a_2x2_mesh_matches_jax(worlds, jref):
    """``train_stage1`` with ``data_parallel=2`` on four ranks: 3 steps,
    the logged losses within the log's 4 decimals of JAX's mesh run (the
    per-step losses, global, within rtol 1e-5 of each other's log), the
    gathered adapters in units of lr; only rank 0 logs."""
    w = worlds[4]
    res0 = w[0][0]["s1"]
    assert res0["step"] == 3 and res0["mesh"] == {"data": 2, "model": 2}
    np.testing.assert_allclose(_losses(res0["logs"]),
                               _losses(jref["s1_logs"]), atol=1.1e-4, rtol=0)
    assert all(not res["s1"]["logs"] for res, _ in w[1:])
    for res, _ in w:
        np.testing.assert_allclose(res["s1"]["losses"], res0["losses"],
                                   rtol=0, atol=0)
    for _, arrays in w:
        _adapters_close(jref["s1_lora"], _tree(arrays, "s1_whole"), 1e-3)


@pytest.mark.parametrize("case", ["s1", "s2"])
def test_replicas_stay_equal_every_step(worlds, case):
    """After every step both data replicas hold the same adapter slices,
    and every leaf that the model group replicates is bit-equal across it
    (rank r sits at (r // 2, r % 2))."""
    w = worlds[4]
    n = len(w[0][0][case]["step_losses" if case == "s2" else "losses"])
    assert n >= 2
    for i in range(n):
        tag = f"{case}_step{i}"
        trees = [_tree(arrays, tag) for _, arrays in w]
        for m in (0, 1):
            a, b = trees[m], trees[2 + m]
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=(tag, k))
        rep = [k for k in trees[0] if _replicated(k)]
        assert rep
        for k in rep:
            np.testing.assert_array_equal(trees[0][k], trees[1][k],
                                          err_msg=(tag, k))


def _replicated(key):
    """A leaf (JAX layout path) that the model axis replicates: ``a`` of a
    column-parallel site, ``b`` of a row-parallel one."""
    row = ("o_proj", "down_proj") if "projector" not in key else ("1",)
    site = key.split(".")[-2]
    return (key.endswith(".a") and site not in row) or \
        (key.endswith(".b") and site in row)


def test_multimodal_step_on_a_2x2_mesh_matches_jax_grad(worlds, jref):
    """The step of ``dryrun_multichip`` (B = 2 on ``data``): the global
    loss rtol 1e-5, each LoRA leaf's gradient (summed over data, gathered
    over the model group) within 1e-4 of its max against ``jax.grad``;
    replicated leaves' gradients bit-equal across the model group, and
    the collectives counted."""
    w = worlds[4]
    jloss, jgrad = jref["mm"]
    for res, arrays in w:
        np.testing.assert_allclose(res["mm"]["loss"], float(jloss), **LOSS)
        _grads_close(jgrad, _tree(arrays, "mm_grad"))
    g0, g1 = (_tree(w[r][1], "mm_local_grad") for r in (0, 1))
    rep = [k for k in g0 if _replicated(k)]
    assert rep
    for k in rep:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    calls = w[0][0]["mm"]["collectives"]
    assert calls.get("all_reduce_sum", 0) > 0 and \
        calls.get("all_reduce_max", 0) > 0


def test_stage2_trainer_on_a_2x2_mesh_matches_jax(worlds, jref):
    """Two ``Stage2Trainer`` turns on (2, 2): the turn is not split on
    data (every replica computes it whole, as JAX's); losses rtol 1e-5,
    the gathered adapters in units of lr."""
    for res, arrays in worlds[4]:
        np.testing.assert_allclose(res["s2"]["losses"], jref["s2_losses"],
                                   **LOSS)
        _adapters_close(jref["s2_lora"], _tree(arrays, "s2_whole"), 1e-3)


# ---------------------------------------------------------------------------
# the (data 1, model 2) world
# ---------------------------------------------------------------------------

def test_w8a8_forward_on_shards_matches_jax(worlds, jref):
    """The same micro-step on the int8 base with ``w8a8_prefill`` (stage 2's
    ``--w8a8-forward``) on model-axis shards at tp = 2 against JAX's
    one-device W8A8 step on the same tree and config: loss rtol 1e-5,
    gradients 1e-4 of each leaf's max (the quantized bases' bounds). Each
    rank also ran the int8 products: its count of W8A8 calls is the
    decoder's seven sites a layer."""
    jloss, jgrad = jref["params_int8_w8a8"]
    wloss, _ = jref["params_int8"]
    for res, arrays in worlds[2]:
        got = res["params_int8_w8a8"]
        np.testing.assert_allclose(got["loss"], float(jloss), **LOSS)
        _grads_close(jgrad, _tree(arrays, "params_int8_w8a8_grad"))
        assert got["int8_mm"] >= 7 * JConfig.tiny().text.num_hidden_layers
    # the W8A8 objective is another function than the weight-only one
    assert abs(float(jloss) - float(wloss)) > 1e-6 * abs(float(wloss))


@pytest.mark.parametrize("name", ["params_int8", "params_nf4"])
def test_quantized_base_on_shards_matches_jax(worlds, jref, name):
    """A stage-2 micro-step on an int8 and an NF4 base (JAX's weight-only
    trees, group 16, sharded at tp = 2): loss rtol 1e-5, gradients 1e-4
    of each leaf's max (tests/test_torch_qlora.py's bounds)."""
    jloss, jgrad = jref[name]
    for res, arrays in worlds[2]:
        np.testing.assert_allclose(res[name]["loss"], float(jloss), **LOSS)
        _grads_close(jgrad, _tree(arrays, f"{name}_grad"))


def test_state_saved_on_a_mesh_resumes_in_one_process(data, worlds):
    """Two text steps on (1, 2) with dropout 0.1 and accumulation 2, the
    state saved (gathered, one file), then restored in one process and
    stepped twice more: the saved state and the continued one equal a
    one-process run of the same steps (moments 1e-4 of each leaf's max,
    adapters in units of lr), and the mesh's losses its losses (rtol
    1e-5)."""
    d, cfg = data[0], TConfig.tiny()
    files = os.listdir(os.path.join(d, "resume"))
    assert files == ["step_2.pt"], files
    model = bridge.cogreasoner_from_params(_load_tree(d, "params"), cfg,
                                           device="cpu")
    loss_fn = ttr.bind_text_loss(TLoRA(dropout=0.1), remat=True)
    batch = ttr.to_device(dict(np.load(os.path.join(d, "batch_resume.npz"))),
                          "cpu")

    def fresh():
        tx = ttr.make_optimizer(1e-2, total_steps=6, warmup_steps=1,
                                grad_accum=2)
        lora = bridge.lora_from_params(_load_tree(d, "lora_s1"),
                                       device="cpu")
        return tx, ttr.init_train_state(tx, lora)

    tx, state = fresh()
    step = ttr.make_train_step(tx, loss_fn, dropout_seed=9)
    losses = []
    for _ in range(2):
        state, loss = step(model.text, state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(worlds[2][0][0]["resume"]["losses"], losses,
                               **LOSS)
    tx2, template = fresh()
    got = tckpt.restore_train_state(os.path.join(d, "resume"), template)
    assert got.step == 2 and got.opt_state["mini_step"] == 0
    # the first moments are gradients: 1e-4 of each leaf's max
    for key in ("mu", "nu"):
        for a, b in zip(got.opt_state["inner"][key],
                        state.opt_state["inner"][key]):
            bound = 1e-4 * float(b.abs().max())
            assert float((a - b).abs().max()) <= bound, key
    step2 = ttr.make_train_step(tx2, loss_fn, dropout_seed=9)
    for _ in range(2):
        state, _ = step(model.text, state, batch)
        got, _ = step2(model.text, got, batch)
    _adapters_close(bridge.lora_to_params(state.lora),
                    dict(tlora.iter_leaves(bridge.lora_to_params(got.lora))),
                    1e-2)


def test_train_stage1_command_with_data_parallel(data, worlds):
    """``train-stage1 --data-parallel 2`` under torchrun's environment on
    a world of two (gloo, ``--device cpu``) writes the adapter that
    ``train_stage1`` on a (2, 1) mesh writes in the other world, bit for
    bit; the adapter loads as ``answer-generate --adapter`` loads it."""
    d = data[0]
    cli = np.load(os.path.join(d, "dp_cli", "language_module.npz"))
    ref = np.load(os.path.join(d, "dp_inprocess", "language_module.npz"))
    assert sorted(cli.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(cli[k], ref[k], err_msg=k)
    # the zero-initialized b leaves moved: the run took its updates
    assert all(np.abs(ref[k]).max() > 0 for k in ref.files
               if k.endswith(".b"))
    tree = tckpt.load_lora_adapter(
        os.path.join(d, "dp_cli", "language_module.npz"), device="cpu")
    assert len(tree["layers"]) == TConfig.tiny().text.num_hidden_layers
    with open(os.path.join(d, "cli_r0.log")) as f:
        r0 = f.read()
    with open(os.path.join(d, "cli_r1.log")) as f:
        r1 = f.read()
    assert "stage1: 9 steps" in r0 and "stage1:" not in r1


def test_sigterm_to_one_rank_stops_every_rank(data, worlds):
    """Rank 1 signals itself (SIGTERM) after its second step: both ranks
    stop at step 2 and one state (step 2) is saved."""
    d = data[0]
    steps = [res["preempt"]["step"] for res, _ in worlds[2]]
    assert steps == [2, 2]
    assert [res["preempt"]["guard"] for res, _ in worlds[2]] == [False, True]
    assert os.listdir(os.path.join(d, "preempt")) == ["step_2.pt"]
    assert any("preempted at step 2" in m
               for m in worlds[2][0][0]["preempt"]["logs"])


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------

class _ThreadGroup:
    """A group of threads standing in for ranks: each collective waits
    for every member's tensor and gives each the combination."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.local = threading.local()

    def _swap(self, x):
        self.slots[self.local.rank] = x.detach().clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def reduce(self, x, op):
        stack = torch.stack(self._swap(x))
        return stack.sum(0) if op == "sum" else stack.amax(0)

    def gather(self, x, dim):
        return torch.cat(self._swap(x), dim=dim)


def _run_ranks(n, fn):
    ths = [threading.Thread(target=fn, args=(r,)) for r in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()


def _threaded_all_reduce(x, group, op="sum"):
    if group is None:
        return x
    out = group.reduce(x, op)
    if op == "sum" and torch.is_grad_enabled() and x.requires_grad:
        return x + (out - x).detach()       # identity backward
    return out


def _w8a8_operands(seed=4, M=24, din=64, dout=48):
    """x (its second half of channels 3x the first, so the two halves'
    absmax differ), an int8 weight with power-of-two scales and an integer
    output gradient: every dx product and sum is exact in f32, so a
    sharded dx equals the whole one bit for bit, whatever the order."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, din)).astype(np.float32)
    x[:, din // 2:] *= 3.0
    q = rng.integers(-127, 128, (din, dout)).astype(np.int8)
    scale = np.exp2(-rng.integers(5, 9, dout)).astype(np.float32)
    g = rng.integers(-4, 5, (M, dout)).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(q),
            torch.from_numpy(scale), torch.from_numpy(g))


@pytest.mark.parametrize("layout,local_absmax", [
    ("row", False), ("col", False), ("row", True)])
def test_w8a8_ste_on_shards_matches_whole(monkeypatch, layout,
                                          local_absmax):
    """``quant._W8A8STE`` on 2 shards (threads for ranks) against the whole
    product. Row shards (o_proj / down_proj: each rank its input channels,
    the group as ``reduce``): every rank's forward is the whole product
    bit for bit and its ``dx`` the whole ``dx``'s columns of its channels.
    Column shards (each rank its output channels, ``x`` whole through
    ``copy_to_model``): each forward the whole product's columns, bit for
    bit, and ``dx`` after ``copy_to_model``'s all-reduce the whole ``dx``.
    The control (``local_absmax``): row shards whose activations take each
    rank's own absmax differ from the whole product."""
    from cogstream_tpu_torch.ops import quant
    from cogstream_tpu_torch.parallel import mesh as tmesh
    from cogstream_tpu_torch.parallel.mesh import copy_to_model

    x, q, scale, g = _w8a8_operands()
    whole = x.clone().requires_grad_(True)
    ref = quant._W8A8STE.apply(whole, q, scale)
    ref_dx, = torch.autograd.grad(ref, whole, g)
    monkeypatch.setattr(quant, "all_reduce", _threaded_all_reduce)
    monkeypatch.setattr(tmesh, "_all_reduce",
                        lambda t, group, op: group.reduce(t, op))
    if local_absmax:
        alone = quant.quantize_int8_act
        monkeypatch.setattr(quant, "quantize_int8_act",
                            lambda t, reduce=None: alone(t))
    n, din, dout = 2, x.shape[1], q.shape[1]
    group = _ThreadGroup(n)
    res = [None] * n

    def rank(r):
        group.local.rank = r
        if layout == "row":
            cin = slice(r * din // n, (r + 1) * din // n)
            xr = x[:, cin].clone().requires_grad_(True)
            y = quant._W8A8STE.apply(xr, q[cin].contiguous(), scale, group)
            res[r] = (y.detach(), torch.autograd.grad(y, xr, g)[0])
        else:
            cout = slice(r * dout // n, (r + 1) * dout // n)
            xr = x.clone().requires_grad_(True)
            y = quant._W8A8STE.apply(copy_to_model(xr, group),
                                     q[:, cout].contiguous(), scale[cout])
            res[r] = (y.detach(), torch.autograd.grad(y, xr, g[:, cout])[0])

    _run_ranks(n, rank)
    if local_absmax:
        assert not any(torch.equal(y, ref.detach()) for y, _ in res)
        return
    if layout == "row":
        for y, _ in res:
            assert torch.equal(y, ref.detach())
        assert torch.equal(torch.cat([dx for _, dx in res], 1), ref_dx)
    else:
        assert torch.equal(torch.cat([y for y, _ in res], 1), ref.detach())
        for _, dx in res:
            assert torch.equal(dx, ref_dx)


@pytest.mark.parametrize("masked", [None, "some", "empty_slice"])
def test_vocab_parallel_loss_matches_whole(monkeypatch, masked):
    """The vocab-parallel CE over 4 slices (4 threads through a simulated
    group) equals ``masked_cross_entropy`` on the whole vocabulary, loss
    and logits' gradient within 1e-6, with no mask, a mask, and a mask
    that leaves a slice with no allowed token."""
    rng = np.random.default_rng(0)
    B, S, V, n = 2, 7, 64, 4
    logits = torch.tensor(rng.normal(size=(B, S, V)) * 3, dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, V, (B, S)))
    labels[0, :3] = ttr.IGNORE_INDEX
    mask = None
    if masked:
        mask = torch.zeros(V, dtype=torch.bool)
        allowed = [1, 5, 9, 40, 41] if masked == "some" else [1, 5, 9, 20]
        mask[allowed] = True         # "empty_slice": slice 3 has none
        labels = torch.tensor(rng.choice(allowed, (B, S)))
        labels[1, 4:] = ttr.IGNORE_INDEX
    whole = logits.clone().requires_grad_(True)
    ref, ref_n = ttr.masked_cross_entropy(whole, labels, mask)
    ref_g, = torch.autograd.grad(ref, whole)
    monkeypatch.setattr(ttr, "all_reduce", _threaded_all_reduce)
    group = _ThreadGroup(n)
    w = V // n
    res = [None] * n

    def rank(r):
        group.local.rank = r
        part = logits[..., r * w:(r + 1) * w].clone().requires_grad_(True)
        loss, cnt = ttr.masked_cross_entropy(part, labels, mask,
                                             vocab=(r * w, (r + 1) * w),
                                             group=group)
        res[r] = (loss, cnt, torch.autograd.grad(loss, part)[0])

    _run_ranks(n, rank)
    for loss, cnt, _ in res:
        assert torch.isfinite(loss)
        np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
        assert int(cnt) == int(ref_n)
    got = torch.cat([g for *_, g in res], dim=-1)
    np.testing.assert_allclose(got.numpy(), ref_g.numpy(), atol=1e-6)


def test_lora_specs_like_matches_jax():
    """The port's LoRA placements equal JAX's ``lora_specs_like`` on the
    tiny trees at tp = 2 (decoder and projector), the port's per-layer
    decoder entries against JAX's stacked ones with their leading [L]
    axis."""
    from jax.sharding import PartitionSpec as P

    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    jm = jmesh.make_mesh(1, 2, devices=jax.devices()[:2])
    jtree = jlora.init_cogreasoner_lora(jax.random.PRNGKey(0), jcfg,
                                        JLoRA(include_projector=True))
    jspecs = jsh.lora_specs_like(jtree, jsh.cogreasoner_param_specs(jcfg,
                                                                    jm))
    jflat = dict(tlora.iter_leaves(jspecs))
    assert all(isinstance(v, P) for v in jflat.values())
    ttree = bridge.lora_from_params(jax.tree.map(np.asarray, jtree),
                                    device="cpu")
    layout = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                   data_index=0, model_index=1,
                                   model_group=None, data_group=None)
    tspecs = tsh.lora_specs_like(ttree, tsh.cogreasoner_param_specs(
        tcfg, layout))
    assert len(tspecs) == len(list(tlora.iter_leaves(ttree)))
    for path, spec in tspecs.items():
        parts = path.split(".")
        if parts[0] == "text":      # text.layers.<i>.<group>.<name>.<leaf>
            key, lead = ".".join(parts[:2] + parts[3:]), (None,)
        else:
            key, lead = path, ()
        assert tuple(jflat[key]) == lead + spec.axes, (path, spec.axes)
    # a split leaf holds rank 1's block
    b = tspecs["text.layers.0.attn.q_proj.b"]
    assert b.dim == 1 and torch.equal(b.index, torch.arange(32, 64))


def test_shard_and_gather_lora_round_trip(monkeypatch):
    """``shard_lora`` for each model rank, then ``LoraLayout.gather``
    (the checkpoints' gather: its flat all-gather over 2 threads through
    a simulated group), gives the whole tree back exactly; the layout's
    ``shard_leaves`` gives the same slices, and
    ``init_cogreasoner_lora(mesh=)`` the slice of the whole initial
    tree."""
    tcfg = TConfig.tiny()
    init = tlora.init_cogreasoner_lora(
        torch.Generator().manual_seed(3), tcfg,
        TLoRA(include_projector=True), device="cpu")
    tree = tlora.map_leaves(lambda t: t + torch.randn_like(t), init)
    group = _ThreadGroup(2)
    monkeypatch.setattr(tsh, "all_gather",
                        lambda x, g, dim=-1: g.gather(x, dim))
    layouts, slices = [], []
    for r in range(2):
        layout = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                       data_index=0, model_index=r,
                                       model_group=group, data_group=None,
                                       model=2)
        lay = tsh.LoraLayout(tree, tsh.cogreasoner_param_specs(tcfg, layout),
                             layout)
        layouts.append(lay)
        slices.append(tsh.shard_lora(tree, lay.specs))
        local = tlora.init_cogreasoner_lora(
            torch.Generator().manual_seed(3), tcfg,
            TLoRA(include_projector=True), device="cpu", mesh=layout)
        for (k, a), (_, b) in zip(tlora.iter_leaves(local), tlora.iter_leaves(
                lay.shard(init))):
            assert torch.equal(a, b) and a.requires_grad, k
        for a, (_, b) in zip(lay.shard_leaves(
                [t for _, t in tlora.iter_leaves(tree)]),
                tlora.iter_leaves(slices[-1])):
            assert torch.equal(a, b)
    assert slices[0]["text"]["layers"][0]["mlp"]["gate_proj"]["b"].shape \
        == (8, 64)
    back = [None, None]

    def rank(r):
        group.local.rank = r
        back[r] = layouts[r].gather(slices[r])

    _run_ranks(2, rank)
    for r in range(2):
        for (k, a), (_, b) in zip(tlora.iter_leaves(back[r]),
                                  tlora.iter_leaves(tree)):
            assert torch.equal(a, b.detach()), (r, k)


def test_shard_batch_chunks_and_raise():
    """``shard_batch`` keeps data rank d's contiguous chunk of every
    leaf's leading dim; a size ``data`` does not divide raises;
    ``batch_specs`` puts every leading dim on ``data``."""
    batch = {"input_ids": np.arange(12).reshape(4, 3),
             "labels": np.arange(4)}
    for d in range(2):
        mesh = types.SimpleNamespace(data=2, data_index=d)
        got = ttr.shard_batch(batch, mesh)
        np.testing.assert_array_equal(got["input_ids"],
                                      batch["input_ids"][2 * d:2 * d + 2])
        np.testing.assert_array_equal(got["labels"],
                                      batch["labels"][2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="does not divide"):
        ttr.shard_batch({"x": np.zeros((3, 2))},
                        types.SimpleNamespace(data=2, data_index=0))
    assert ttr.batch_specs(batch) == {"input_ids": ("data", None),
                                      "labels": ("data",)}


def test_parallel_sizes_without_a_world_raise(tmp_path):
    """``--data-parallel 2`` (or a model axis of 2) in a process without
    a group raises, in the API and through the command; nothing trains
    alone on one rank."""
    tcfg = TConfig.tiny()
    model = bridge.qwen2_from_params(
        jax.tree.map(np.asarray, init_cogreasoner_params(
            jax.random.PRNGKey(0), JConfig.tiny())["text"]), tcfg.text,
        device="cpu")
    for kw in ({"data_parallel": 2}, {"model_parallel": 2}):
        with pytest.raises(ValueError, match="ranks"):
            tstage1.train_stage1(model, tcfg, None, [], str(tmp_path),
                                 tstage1.Stage1Config(**kw))
    with pytest.raises(ValueError, match="ranks"):
        tstage1.join_training_world("cpu", 2)
    assert not os.listdir(tmp_path)


def test_refusals_on_a_mesh_name_queue_1_9(monkeypatch):
    """The refusals left on a mesh (the test keeps its name): JAX's
    ``ValueError``s for a pipeline with a model axis and a ring with a
    model axis. ``--w8a8-forward`` with a model axis above 1 is no longer
    refused: ``check_parallel`` passes it, and the command under
    torchrun's world of 2 gets past the check to the missing checkpoint.
    A pipeline alone passes the check (it trains:
    tests/test_torch_pipeline.py), and so does an sp run."""
    from cogstream_tpu_torch.train import stage2 as tstage2

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(FileNotFoundError):
        tstage2.main(["--model-dir", "/nonexistent", "--video-dir", "v",
                      "--query-dir", "q", "--out", "o", "--quantize-base",
                      "int8", "--w8a8-forward"])
    assert tstage2.check_parallel(tstage2.Stage2Config(model_parallel=2),
                                  2) is None
    # a data axis over the whole world leaves the model axis at 1
    assert tstage2.check_parallel(tstage2.Stage2Config(data_parallel=2),
                                  2) is None
    with pytest.raises(ValueError, match="exclusive with model_parallel"):
        tstage1.check_pipeline(tstage1.Stage1Config(pipeline_stages=2,
                                                    model_parallel=2))
    assert tstage1.check_pipeline(tstage1.Stage1Config(
        pipeline_stages=2)) is None
    with pytest.raises(ValueError, match="exclusive with model_parallel"):
        tstage2.check_parallel(tstage2.Stage2Config(sequence_parallel=2,
                                                    model_parallel=2))
    assert tstage2.check_parallel(tstage2.Stage2Config(sequence_parallel=2),
                                  2) is None
