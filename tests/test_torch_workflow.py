"""The reference's whole published workflow through the port's command
line on the CPU (the JAX package's tests/test_full_workflow.py with
``python -m cogstream_tpu_torch ... --device cpu``):

  segment-videos -> datagen (FakeMLLM) -> train-stage1 -> train-stage2 ->
  answer-generate (FCC, both adapters) -> judge x5 -> summarize ->
  nlp-metrics

on a tiny checkpoint written by the JAX package's exporter. The host
stages also run through the JAX package's command line on the same
inputs, and their outputs must be equal: the segment spec, segment
files and keyframes byte for byte, the generated dataset, and (over the
port's predictions) the judged files, the report and the nlp-metrics
line.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogstream_tpu.__main__ as jmain
import cogstream_tpu_torch.__main__ as tmain
from cogstream_tpu.config import CogReasonerConfig
from cogstream_tpu.models.checkpoint import save_cogreasoner_to_hf
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path) as f:
        return json.load(f)


def _files(root):
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _run(main_fn, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", list(sys.argv))   # jmain rewrites it
    rc = main_fn(argv)
    return rc, capsys.readouterr().out


def test_full_published_workflow_through_the_port(tmp_path, capsys,
                                                  monkeypatch):
    root = tmp_path
    run = lambda fn, argv: _run(fn, argv, capsys, monkeypatch)  # noqa: E731

    # --- 0. a tiny raw video --------------------------------------------
    vid = str(root / "movie.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(7)
    for _ in range(60):                       # 6 s @ 10 fps
        w.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
    w.release()

    # --- 1. segmentation, both command lines ----------------------------
    seg = {}
    for name, fn in (("jax", jmain.main), ("torch", tmain.main)):
        out = str(root / name / "segmented")
        seg[name] = run(fn, ["segment-videos", "--video", vid, "--timestamps",
                             "2.0,4.0", "--out-root", out])
    assert seg["torch"] == seg["jax"] and seg["torch"][0] == 0
    tseg, jseg = str(root / "torch" / "segmented"), str(root / "jax" /
                                                         "segmented")
    spec = _read(os.path.join(tseg, "movie.json"))
    assert len(spec["segments"]) == 3
    assert all(s["keyframes"] for s in spec["segments"])
    assert json.dumps(spec).replace(tseg, "<root>") == \
        json.dumps(_read(os.path.join(jseg, "movie.json"))).replace(
            jseg, "<root>")
    # segment files and keyframes: byte-equal (cv2 encodes
    # deterministically on one host)
    assert _files(tseg).keys() == _files(jseg).keys()
    for rel, raw in _files(tseg).items():
        if rel != "movie.json":
            assert raw == _files(jseg)[rel], rel

    # --- 2. datagen (FakeMLLM), both command lines -----------------------
    dg = {}
    for name, fn in (("jax", jmain.main), ("torch", tmain.main)):
        rc, said = run(fn, ["datagen", "--segments-dir",
                            str(root / name / "segmented"), "--out-root",
                            str(root / name / "datagen"), "--model", "fake"])
        dg[name] = (rc, said.replace(str(root / name), "<root>"))
    assert dg["torch"] == dg["jax"] and dg["torch"][0] == 0
    tdata, jdata = (_files(root / n / "datagen") for n in ("torch", "jax"))
    assert tdata.keys() == jdata.keys() and tdata
    for rel in tdata:
        a = tdata[rel].decode().replace(str(root / "torch"), "<root>")
        b = jdata[rel].decode().replace(str(root / "jax"), "<root>")
        assert (json.loads(a) if rel.endswith(".json") else a) == \
            (json.loads(b) if rel.endswith(".json") else b), rel
    dataset_dir = str(root / "torch" / "datagen" / "dataset")
    chains_dir = os.path.join(dataset_dir, "query_chains")
    chains = _read(os.path.join(chains_dir, "movie.json"))["query_chains"]
    assert chains and chains[0]
    assert isinstance(chains[0][0]["Q"], list)
    times = [q["info"]["Event_Time"] for q in chains[0]]
    assert times == sorted(times)

    # --- 3. a tiny HF-layout base checkpoint (the JAX exporter) ----------
    cfg = CogReasonerConfig.tiny()
    base = str(root / "base")
    save_cogreasoner_to_hf(init_cogreasoner_params(jax.random.PRNGKey(0),
                                                   cfg), cfg, base,
                           dtype=jnp.float32)

    # --- 4. stage-1 selector LoRA off the generated dataset --------------
    s1 = str(root / "stage1")
    rc, _ = run(tmain.main, ["train-stage1", "--qa-json", dataset_dir,
                             "--model-dir", base, "--out", s1, "--epochs",
                             "1", "--batch-size", "2", "--device", "cpu"])
    lang = os.path.join(s1, "language_module.npz")
    assert rc == 0 and os.path.exists(lang)

    # --- 5. published eval layout: per-video dir of segment files --------
    eval_videos = root / "eval_videos" / "movie"
    eval_videos.mkdir(parents=True)
    for s in spec["segments"]:
        shutil.copy(s["path"], str(eval_videos))

    # --- 6. stage-2 interleave LoRA off the query-chain layout -----------
    s2 = str(root / "stage2")
    rc, _ = run(tmain.main, ["train-stage2", "--model-dir", base,
                             "--video-dir", str(root / "eval_videos"),
                             "--query-dir", chains_dir, "--out", s2,
                             "--num-epochs", "1", "--device", "cpu"])
    full = os.path.join(s2, "full_module.npz")
    assert rc == 0 and os.path.exists(full)

    # --- 7. answer generation with both adapters (FCC) -------------------
    preds = str(root / "preds")
    rc, _ = run(tmain.main, ["answer-generate", "--model-dir", base,
                             "--lora-adapter-1", lang, "--lora-adapter-2",
                             full, "--video-dir", str(root / "eval_videos"),
                             "--query-dir", chains_dir, "--save-dir", preds,
                             "--mode", "FCC", "--max-new-tokens", "8",
                             "--device", "cpu"])
    assert rc == 0
    out = _read(os.path.join(preds, "movie.json"))
    assert out["QAs"] and len(out["QAs"]) == len(chains[0])
    assert all("prediction" in q and "pred_coi" in q for q in out["QAs"])

    # --- 8. judges, aggregation, NLP metrics, both command lines ---------
    res = {}
    for name, fn in (("jax", jmain.main), ("torch", tmain.main)):
        judged = str(root / name / "judged")
        said = [run(fn, ["judge", "--metric", m, "--pred-dir", preds,
                         "--out-dir", judged, "--model", "fake"])
                for m in ("IA", "DC", "CA", "TP", "LC")]
        report = str(root / name / "report.json")
        said.append(run(fn, ["summarize", "--judged-dir", judged, "--out",
                             report]))
        said.append(run(fn, ["nlp-metrics", "--pred-dir", preds]))
        res[name] = (said, _files(judged), open(report, "rb").read())
    assert res["torch"] == res["jax"]
    assert all(rc == 0 for rc, _ in res["torch"][0])
    scores = json.loads(res["torch"][1]["movie.json"])["QAs"][0]["scores"]
    assert set(scores) == {"IA", "DC", "CA", "TP", "LC"}
    report = json.loads(res["torch"][2])
    assert report["scores"]["average"] is not None
    assert report["coi"]["f1"] is not None
    metrics = json.loads(res["torch"][0][-1][1])
    assert set(metrics) == {"BLEU-4", "METEOR", "ROUGE-L", "CIDEr"}
