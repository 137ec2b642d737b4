"""The port's host-only evaluation harness and dataset generation against
the JAX package's modules on the same inputs.

``cogstream_tpu_torch/{datagen,evaluate}`` carry copies of
``cogstream_tpu/{datagen,evaluate}``'s host modules (the port imports
nothing of the JAX package). Each scenario of the JAX package's
tests/test_datagen_eval.py, test_judge_http.py, test_nlp_meteor.py,
test_label_taxonomy_parity.py and test_cli.py runs here once through
each package; its checks hold for both, and the two results (QA sets,
streams, scores, reports, files written, requests sent to a stub judge
endpoint on 127.0.0.1) must be equal.
"""

import json
import os
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

import cogstream_tpu.__main__ as jmain
import cogstream_tpu_torch.__main__ as tmain
from cogstream_tpu.datagen import (client as jclient,
                                   dialogue_path as jdialogue,
                                   formatting as jformatting,
                                   generation as jgeneration,
                                   reformatting as jreformatting,
                                   scoring as jscoring,
                                   segmentation as jsegmentation)
from cogstream_tpu.evaluate import (aggregate as jaggregate,
                                    judges as jjudges,
                                    nlp_metrics as jnlp,
                                    synonyms_data as jsyn)
from cogstream_tpu_torch.datagen import (client as tclient,
                                         dialogue_path as tdialogue,
                                         formatting as tformatting,
                                         generation as tgeneration,
                                         reformatting as treformatting,
                                         scoring as tscoring,
                                         segmentation as tsegmentation)
from cogstream_tpu_torch.evaluate import (aggregate as taggregate,
                                          judges as tjudges,
                                          nlp_metrics as tnlp,
                                          synonyms_data as tsyn)

PKGS = {
    "jax": types.SimpleNamespace(
        client=jclient, dialogue_path=jdialogue, formatting=jformatting,
        generation=jgeneration, reformatting=jreformatting,
        scoring=jscoring, segmentation=jsegmentation, aggregate=jaggregate,
        judges=jjudges, nlp=jnlp, syn=jsyn),
    "torch": types.SimpleNamespace(
        client=tclient, dialogue_path=tdialogue, formatting=tformatting,
        generation=tgeneration, reformatting=treformatting,
        scoring=tscoring, segmentation=tsegmentation, aggregate=taggregate,
        judges=tjudges, nlp=tnlp, syn=tsyn),
}

QUIET = dict(log=lambda *a: None)


def _both(scenario, tmp_path):
    """Run ``scenario(m, dir)`` for each package (each in its own
    directory); return both results with the directory replaced by
    ``<dir>`` in every string."""
    out = {}
    for name, m in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        res = scenario(m, d)
        out[name] = json.loads(json.dumps(res, sort_keys=True)
                               .replace(str(d), "<dir>"))
    return out["jax"], out["torch"]


def _segments_spec():
    return [{"index": i, "keyframes": [], "timestamp": [10 * i, 10 * i + 10]}
            for i in range(3)]


# ---------------------------------------------------------------------------
# dataset generation (tests/test_datagen_eval.py)
# ---------------------------------------------------------------------------

def _generation(m, d):
    client = m.client.FakeMLLM()
    video = m.generation.generate_video_qas(client, _segments_spec(), **QUIET)
    assert len(video["segments"]) == 3 and video["summary"]
    assert video["segments"][0]["QAs"]["L1"]
    assert "L3" in video["segments"][1]["QAs"]
    assert "L4" in video["segments"][2]["QAs"]
    seg0 = video["segments"][0]["QAs"]
    assert all("type" in qa and not qa["Q"].startswith("[")
               for qa in seg0["L1"])
    for l2 in seg0["L2"]:
        assert l2["type"] == "Co-reference"
        assert 0 <= l2["ref"] < len(seg0["L1"])
    return {"video": video, "calls": client.calls}


def _remix_score_streams(m, d):
    client = m.client.FakeMLLM()
    video = m.generation.generate_video_qas(client, _segments_spec(), **QUIET)
    video["video"] = "v"
    video = m.reformatting.cap_counts(m.reformatting.remix(video, seed=0),
                                      seed=0)
    for seg in video["segments"]:
        assert len(seg["QAs"].get("L1", [])) <= 5
        assert len(seg["QAs"].get("L3", [])) <= 4
    scored = m.scoring.score_video(client, video, out_path=str(d / "s.json"),
                                   **QUIET)
    merged = m.dialogue_path.merge_score_matrices([scored["links"]])
    streams = m.dialogue_path.build_streams(video, merged, n_streams=2)
    assert len(streams) == 2 and streams[0]["QAs"]
    assert {m.aggregate.label_group(qa["label"])
            for qa in streams[0]["QAs"]} <= {"Basic", "Streaming", "Global"}
    simple = m.formatting.stream_to_simple("v", streams[0], video["segments"])
    for i, qa in enumerate(simple["QAs"]):
        assert len(qa["relevance"]) == i
        assert all(0 <= c < i for c in qa["coi"])
    chain = m.formatting.stream_to_query_chain(streams[0], video["segments"])
    calls = client.calls
    m.scoring.score_video(client, video, out_path=str(d / "s.json"), **QUIET)
    assert client.calls == calls        # resumed: nothing re-scored
    return {"video": video, "scored": scored, "streams": streams,
            "simple": simple, "chain": chain, "calls": calls,
            "links": sorted(m.dialogue_path.coi_links(merged).items()),
            "qa_links": sorted(
                (repr(k), sorted(v.items())) for k, v in
                m.dialogue_path.qa_link_scores(video, merged).items())}


def _parsers(m, d):
    qs = ["[Attributes] What color is it?", "no tag?",
          "[Co-reference](QA2) How did it break?",
          "[Co-reference](3) and bare ids?", "[Attributes] not coref",
          " [Co-Reference] ( QA1 ) spaced?"]
    texts = ['[{"Q": "a?", "A": "b."}]', "junk [ ] more", "no json",
             'x [{"Q": "q?", "A": "a."}, {"Q": "r?"}] y']
    return {"label": [m.generation.split_label(q) for q in qs],
            "coref": [m.generation.split_coref(q) for q in qs],
            "qa_json": [m.generation.parse_qa_json(t) for t in texts],
            "score": [m.scoring.parse_score(t)
                      for t in ("Score: 5", "7", "none", "-2 then 3", "12")],
            "temporal": [m.reformatting.is_temporal({"Q": q, "A": "x"})
                         for q in ("when did it happen?", "what color?",
                                   "at what time did he leave?")]}


def _chain_fixture():
    video = {"video": "v", "segments": [
        {"index": 0, "QAs": {"L1": [
            {"Q": "qa?", "A": "aa.", "type": "Attributes"},
            {"Q": "qb?", "A": "ab.", "type": "Items"}]}},
        {"index": 1, "QAs": {"L3": [{"Q": "qx?", "A": "ax."}]}},
        {"index": 2, "QAs": {"L3": [{"Q": "qy?", "A": "ay."},
                                    {"Q": "qz?", "A": "az."}]}},
    ]}
    links = {"1": {"0": {"0": [6, 0]}},
             "2": {"0": {"0": [0, 0], "1": [7]},
                   "1": {"0": [0, 6], "1": [0]}}}
    return video, links


def _chains_and_boosts(m, d):
    video, links = _chain_fixture()
    streams = m.dialogue_path.build_streams(video, links, n_streams=1,
                                            k_advanced=2, basic_rate=1.0,
                                            seed=0)
    by_q = {qa["QA_pairs"][0]["Q"]: qa for qa in streams[0]["QAs"]}
    assert [by_q[q]["chain_length"] for q in
            ("qa?", "qb?", "qx?", "qy?", "qz?")] == [1, 1, 2, 3, 2]
    simple = m.formatting.stream_to_simple("v", streams[0], video["segments"])
    for qa in simple["QAs"]:
        assert [i for i, r in enumerate(qa["relevance"]) if r] == qa["coi"]
    l2_video = {"video": "v", "segments": [{"index": 0, "QAs": {
        "L1": [{"Q": "who?", "A": "a man.", "type": "Attributes"}],
        "L2": [{"Q": "what is he doing?", "A": "walking.",
                "type": "Co-reference", "ref": 0}]}}]}
    chained = [m.dialogue_path.build_streams(l2_video, {}, n_streams=1,
                                             basic_rate=1.0, seed=s)
               for s in range(16)]
    assert any(qa["class"] == "Co-reference"
               for st in chained for qa in st[0]["QAs"])
    return {"streams": streams, "simple": simple, "chained": chained}


def _remix_refs_and_temporal(m, d):
    l1 = [{"Q": f"q{i}?", "A": f"a{i}.",
           "type": "Temporal Perception" if i == 1 else "Items"}
          for i in range(6)]
    video = {"video": "v", "segments": [
        {"index": 0, "QAs": {"L1": list(l1), "L2": [
            {"Q": "l2?", "A": "x.", "type": "Co-reference", "ref": 4}]}},
        {"index": 1, "QAs": {"L1": [{"Q": "z?", "A": "z.",
                                     "type": "Items"}]}},
    ]}
    out = []
    for seed in range(8):
        v = m.reformatting.cap_counts(m.reformatting.remix(video, seed=seed),
                                      seed=seed)
        qas = v["segments"][0]["QAs"]
        for l2 in qas.get("L2", []):
            assert qas["L1"][l2["ref"]]["Q"] == "q4?"
        out.append(v)
    tvideo = {"video": "v", "segments": [
        {"index": 0, "QAs": {"L1": [
            {"Q": "what instant did it happen?", "A": "at 3s.",
             "type": "Temporal Perception"},
            {"Q": "color?", "A": "red.", "type": "Attributes"}]}},
        {"index": 1, "QAs": {"L1": [{"Q": "z?", "A": "z.",
                                     "type": "Items"}]}},
    ]}
    moved = [m.reformatting.remix(tvideo, seed=s) for s in range(16)]
    assert any(v["segments"][1]["QAs"].get("TP") for v in moved)
    injected = m.reformatting.inject_dynamic_updating(
        {**out[0], "segments": [dict(sg, timestamp=[10 * i, 10 * i + 10])
                                for i, sg in enumerate(out[0]["segments"])]},
        [{"Q": "now?", "A": "yes.", "time": 12.0}])
    return {"capped": out, "moved": moved, "injected": injected}


def _pipeline_dirs(m, d):
    """The directory stages the ``datagen`` command chains: generation,
    scoring, path construction and formatting, over two segment specs."""
    seg_dir = d / "segs"
    seg_dir.mkdir()
    for v in ("a", "b"):
        (seg_dir / f"{v}.json").write_text(json.dumps(
            {"video": v, "segments": _segments_spec()}))
    client = m.client.FakeMLLM(3)
    m.generation.run_generation(client, str(seg_dir), str(d / "qas"), seed=3,
                                **QUIET)
    m.scoring.run_scoring(client, str(d / "qas"), str(d / "scores"), **QUIET)
    m.dialogue_path.run_path_construction(
        str(d / "scores"), str(d / "qas"), str(d / "streams"), n_streams=2,
        threshold=5, seed=3, **QUIET)
    stats = m.formatting.format_dataset(str(d / "streams"), str(d / "qas"),
                                        str(d / "dataset"), **QUIET)
    return {"stats": stats, "files": _tree(d, ("qas", "scores", "streams",
                                               "dataset"))}


def _tree(root, subdirs):
    """Every file under ``root/<subdir>``: its relative path and parsed
    JSON (or raw text)."""
    out = {}
    for sub in subdirs:
        for dirpath, _, names in os.walk(root / sub):
            for n in sorted(names):
                p = os.path.join(dirpath, n)
                raw = open(p, "rb").read().decode()
                out[os.path.relpath(p, root)] = (json.loads(raw)
                                                if n.endswith(".json")
                                                else raw)
    return out


# ---------------------------------------------------------------------------
# judges and aggregation (tests/test_datagen_eval.py, test_cli.py)
# ---------------------------------------------------------------------------

def _pred_video():
    return {"video": "v", "QAs": [
        {"question": "what color is the car", "prediction": "the car is red",
         "answer": "the car is red", "label": "Basic", "class": "Attribute",
         "relevance": [], "is_visual": True, "pred_coi": [],
         "pred_visual": True, "latency_s": 0.5},
        {"question": "what happened after",
         "prediction": "something unrelated entirely",
         "answer": "the red car drove away", "label": "Streaming",
         "class": "Sequence", "relevance": [1], "is_visual": True,
         "pred_coi": [0], "pred_visual": True, "latency_s": 1.5},
        {"question": "and at the end", "prediction": "it stopped\nat a light",
         "answer": "the car stopped at a red light",
         "label": "Global/Summary", "relevance": [0, 1], "is_visual": False,
         "pred_coi": [1], "pred_visual": False, "latency_s": 0.25},
    ]}


def _judges_and_aggregate(m, d):
    (d / "preds").mkdir()
    (d / "preds" / "v.json").write_text(json.dumps(_pred_video()))
    client = m.judges.FakeJudge()
    for metric in m.judges.METRIC_RUBRICS:
        m.judges.judge_directory(metric, client, str(d / "preds"),
                                 str(d / "judged"),
                                 coi_context=metric == "DC", **QUIET)
    calls = client.calls
    for metric in m.judges.METRIC_RUBRICS:     # idempotent: all skipped
        m.judges.judge_directory(metric, client, str(d / "preds"),
                                 str(d / "judged"), **QUIET)
    assert client.calls == calls
    videos = m.aggregate.load_judged_dir(str(d / "judged"))
    items = m.aggregate.coi_items_from_videos(videos)
    report = m.aggregate.summarize(str(d / "judged"), str(d / "report.json"))
    assert report["scores"]["average"] is not None
    assert 0 <= report["scores"]["average"] <= 100
    return {"videos": videos, "calls": calls, "report": report,
            "table": m.aggregate.format_table(report),
            "latex": m.aggregate.format_table(report, latex=True),
            "coi": m.aggregate.coi_metrics(items),
            "visual": m.aggregate.visual_flag_metrics(items),
            "coherence": m.aggregate.dialogue_coherence(videos),
            "latency": m.aggregate.latency_stats(videos),
            "files": _tree(d, ("judged",)),
            "report_file": json.loads((d / "report.json").read_text())}


def _judge_resume(m, d):
    (d / "p").mkdir()
    (d / "o").mkdir()
    (d / "o" / "v.json").write_text(json.dumps({"QAs": [
        {"question": "q0", "prediction": "a", "answer": "a",
         "scores": {"IA": 9}},
        {"question": "q1", "prediction": "b", "answer": "b",
         "scores": {"IA": None}}]}))
    (d / "p" / "v.json").write_text(json.dumps({"QAs": []}))
    client = m.judges.FakeJudge()
    m.judges.judge_directory("IA", client, str(d / "p"), str(d / "o"),
                             **QUIET)
    video = json.loads((d / "o" / "v.json").read_text())
    assert video["QAs"][0]["scores"]["IA"] == 9 and client.calls == 1
    gt = "the red car drove away\nthen it stopped at the light"
    replies = [client.chat("s", f"Item 1\nQuestion: q\nPrediction: {p}\n"
                                f"Ground truth: {gt}")
               for p in (gt, "zebra", "the car")]
    return {"video": video, "replies": replies,
            "extracted": [m.judges.extract_scores(r) for r in replies],
            "prompts": {k: m.judges.build_judge_prompt(
                k, [{"question": "q", "prediction": "p",
                     "ground_truth": "g"}] * 2)
                for k in sorted(m.judges.METRIC_RUBRICS)}}


def _visual_flags(m, d):
    videos = [{"QAs": [
        {"pred_coi": [], "relevance": None, "pred_visual": True,
         "is_visual": True},
        {"pred_coi": [], "relevance": None, "pred_visual": False,
         "is_visual": True},
        {"pred_coi": [], "relevance": None, "pred_visual": None,
         "is_visual": True}]}]
    items = m.aggregate.coi_items_from_videos(videos)
    vf = m.aggregate.visual_flag_metrics(items)
    coi = m.aggregate.coi_metrics(items)
    assert vf["n"] == 2 and vf["accuracy"] == 0.5 and coi["support"] == 0
    return {"visual": vf, "coi": coi,
            "confusion": m.aggregate.coi_confusion([0, 2], [0, 1], 3)}


LABELS = ["Basic", "Streaming", "Global", "Basic/Attributes",
          "Basic/Co-reference", "Streaming/Reasoning",
          "Streaming/Some Future Class", "NotAGroup/Thing", "", "Global/Summary",
          "Streaming/Dialogue-Recalling", "Streaming/Dynamic Updating",
          "Global/Overall Reasoning"]


def _label_taxonomy(m, d):
    labels = list(LABELS) + sorted(m.aggregate.LABEL_ALIASES)
    for g, cs in m.aggregate.LABEL_GROUPS.items():
        labels += [f"{g}/{c}" for c in cs] + list(cs)
    assert m.aggregate.label_group("Streaming/Some Future Class") == \
        "Streaming"
    assert m.aggregate.label_group("NotAGroup/Thing") is None
    assert m.aggregate.label_group("") is None
    return {"groups": [m.aggregate.label_group(x) for x in labels],
            "canonical": [m.aggregate.canonical_label(x) for x in labels],
            "tables": [m.aggregate.LABEL_ALIASES, m.aggregate.LABEL_GROUPS]}


# ---------------------------------------------------------------------------
# NLP metrics (tests/test_datagen_eval.py, test_nlp_meteor.py)
# ---------------------------------------------------------------------------

METEOR_CASES = [
    ("the quick brown fox jumps over the lazy dog",
     "a quick brown dog jumps over the lazy fox"),
    ("it is a guide to action which ensures that the military always "
     "obeys the commands of the party",
     "it is a guide to action that ensures that the military will "
     "forever heed party commands"),
    ("the man is cooking dinner in the kitchen",
     "a person prepares a meal in the kitchen"),
    ("completely unrelated words here", "nothing matches at all"),
    ("exact match sentence", "exact match sentence"),
    ("running runs runner", "run running runs"),
    ("", "empty hypothesis"),
    ("empty reference", ""),
    ("the large dog sits on the sofa", "the big canine sits on the couch"),
    ("paris is the capital of france", "the capital of france is paris"),
]


def _nlp(m, d):
    preds = ["the red car drove away quickly", "a cat sat on the mat"]
    refs = ["the red car drove away quickly", "dogs bark loudly at night"]
    same = m.nlp.compute_all(preds[:1], refs[:1])
    diff = m.nlp.compute_all(preds[1:], refs[1:])
    assert same["BLEU-4"] > 0.99 and same["ROUGE-L"] > 0.99
    assert diff["BLEU-4"] < 0.1 and diff["ROUGE-L"] < 0.3
    corpus = m.nlp.compute_all(preds, refs)
    swapped = m.nlp.compute_all(preds[::-1], refs)
    assert corpus["CIDEr"] > swapped["CIDEr"]
    with pytest.raises(ValueError, match="predictions"):
        m.nlp.compute_all(["a"], ["a", "b"])
    no_syn = lambda w: frozenset()   # noqa: E731
    ps, rs = zip(*METEOR_CASES)
    return {"same": same, "diff": diff, "corpus": corpus,
            "swapped": swapped, "all": m.nlp.compute_all(list(ps), list(rs)),
            "single": [[m.nlp.meteor_single(m.nlp.tokenize(p),
                                            m.nlp.tokenize(r),
                                            synonyms=no_syn),
                        m.nlp.meteor_single(m.nlp.tokenize(p),
                                            m.nlp.tokenize(r))]
                       for p, r in METEOR_CASES],
            "meteor": [m.nlp.meteor(list(ps), list(rs)),
                       m.nlp.meteor(list(ps), list(rs), synonyms=no_syn)],
            "tokens": [m.nlp.tokenize(p) for p in ps]}


def _synonyms(m, d):
    table = m.nlp._bundled_synonyms()
    assert "big" in m.nlp.default_synonyms("large")
    assert m.nlp.default_synonyms("zzz-not-a-word") == frozenset()
    assert len(m.syn.SYNONYM_GROUPS) >= 500
    return {"groups": m.syn.SYNONYM_GROUPS,
            "table": {k: sorted(v) for k, v in table.items()},
            "lookups": [sorted(m.nlp.default_synonyms(w)) for w in
                        ("car", "throw", "about", "beautiful", "zzz")]}


SCENARIOS = {
    "generation": _generation,
    "remix_score_streams": _remix_score_streams,
    "parsers": _parsers,
    "chains_and_boosts": _chains_and_boosts,
    "remix_refs_and_temporal": _remix_refs_and_temporal,
    "pipeline_dirs": _pipeline_dirs,
    "judges_and_aggregate": _judges_and_aggregate,
    "judge_resume": _judge_resume,
    "visual_flags": _visual_flags,
    "label_taxonomy": _label_taxonomy,
    "nlp": _nlp,
    "synonyms": _synonyms,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_matches_jax(name, tmp_path):
    want, got = _both(SCENARIOS[name], tmp_path)
    assert got == want


def test_meteor_matches_nltk_exact_and_stem():
    """The port's METEOR on the exact + stem stages equals nltk's with
    an empty WordNet (as the JAX package's test holds its own)."""
    nltk_meteor = pytest.importorskip("nltk.translate.meteor_score")

    class EmptyWordnet:
        def synsets(self, word):
            return []

    for pred, ref in METEOR_CASES[:8]:
        p, r = tnlp.tokenize(pred), tnlp.tokenize(ref)
        got = tnlp.meteor_single(p, r, synonyms=lambda w: frozenset())
        if not p or not r:
            assert got == 0.0
            continue
        want = nltk_meteor.single_meteor_score(r, p, wordnet=EmptyWordnet())
        assert got == pytest.approx(want, rel=1e-12), (pred, ref)


# ---------------------------------------------------------------------------
# segmentation (cv2 route; tests/test_datagen_eval.py)
# ---------------------------------------------------------------------------

def _clip(path, n=60, fps=10, hw=(48, 64), seed=0):
    cv2 = pytest.importorskip("cv2")
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (hw[1], hw[0]))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        w.write(rng.integers(0, 255, (*hw, 3), np.uint8))
    w.release()
    return str(path)


def _segmentation(m, d):
    cv2 = pytest.importorskip("cv2")
    path = _clip(d / "clip.mp4")
    dur = m.segmentation.probe_duration(path)
    assert 5.0 < dur < 7.0
    spec = m.segmentation.split_and_sample(path, str(d / "out"), [3.0],
                                           **QUIET)
    assert len(spec["segments"]) == 2
    assert m.segmentation.split_and_sample(path, str(d / "out"), [3.0],
                                           **QUIET) == spec
    pixels = []
    for s in spec["segments"]:
        assert m.segmentation.probe_duration(s["path"]) > 1.0
        for kf in s["keyframes"]:
            img = cv2.imread(kf)
            assert img is not None and max(img.shape[:2]) <= 512
            pixels.append(int(img.astype(np.int64).sum()))
    seg_bytes = [len(open(s["path"], "rb").read()) for s in spec["segments"]]
    with pytest.raises(RuntimeError, match="0 frames"):
        m.segmentation._cv2_segment(_clip(d / "c.mp4", n=10, hw=(32, 32)),
                                    str(d / "seg.mp4"), 50.0, 51.0)
    assert not os.path.exists(d / "seg.mp4")
    return {"duration": dur, "spec": spec, "keyframe_sums": pixels,
            "segment_sizes": seg_bytes,
            "counts": [m.segmentation.keyframe_count(t)
                       for t in (0.5, 3.0, 30.0, 600.0)]}


def test_segmentation_matches_jax(tmp_path, monkeypatch):
    """The cv2 route (the card's machine has no ffmpeg): the same spec,
    segment files and keyframe pixels."""
    for m in (jsegmentation, tsegmentation):
        monkeypatch.setattr(m, "_have_ffmpeg", lambda: False)
    want, got = _both(_segmentation, tmp_path)
    assert got == want


# ---------------------------------------------------------------------------
# the OpenAI-compatible judge over a stub endpoint (tests/test_judge_http.py)
# ---------------------------------------------------------------------------

class _Stub:
    """A scripted chat-completions endpoint on 127.0.0.1: each entry a
    reply (dict) or an HTTP error (int); the last one repeats."""

    def __init__(self, script):
        self.script = list(script)
        self.requests = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers["Content-Length"])
                stub.requests.append({
                    "path": self.path,
                    "body": json.loads(self.rfile.read(n).decode()),
                    "auth": self.headers.get("Authorization")})
                plan = (stub.script.pop(0) if len(stub.script) > 1
                        else stub.script[0])
                if isinstance(plan, int):
                    self.send_response(plan)
                    self.end_headers()
                    return
                raw = json.dumps({
                    "choices": [{"message": {"content": plan["content"]}}],
                    "usage": {"prompt_tokens": 7, "completion_tokens": 3},
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, *a):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/v1"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _http_judge(m, d):
    out = {}
    stubs = []

    def judge(script, **kw):
        stub = _Stub(script)
        stubs.append(stub)
        return stub, m.judges.OpenAICompatJudge(
            "judge-model", api_key="test-key", base_url=stub.url,
            backoff=lambda s: None, **kw)

    try:
        stub, j = judge([{"content": "Score: 7\nScore: 9"}])
        out["happy"] = [m.judges.extract_scores(j.chat("sys", "user")),
                        j.prompt_tokens, j.completion_tokens]
        stub, j = judge([500, {"content": "Score: 6"}])
        out["retry"] = m.judges.extract_scores(j.chat("s", "u"))
        stub, j = judge([500, 500, 500, {"content": "Score: 4"}],
                        max_retries=5, fallback_model="fallback-model")
        out["fallback"] = m.judges.extract_scores(j.chat("s", "u"))
        stub, j = judge([500], max_retries=3)
        with pytest.raises(Exception):
            j.chat("s", "u")
        stub, j = judge([{"content": "Score: 8\nScore: 5\nScore: 10"}])
        items = [{"question": f"q{i}", "prediction": f"p{i}",
                  "ground_truth": f"g{i}"} for i in range(4)]
        out["batch"] = m.judges.judge_video("IA", j, items)
        (d / "pred").mkdir()
        (d / "pred" / "v.json").write_text(json.dumps({"QAs": [
            {"question": "q0", "prediction": "p0", "answer": "a0"},
            {"question": "q1", "prediction": "p1", "answer": "a1"}]}))
        for script in ([{"content": "Score: 9"}, {"content": "no score"}],
                       [{"content": "Score: 3"}]):
            stub, j = judge(script)
            m.judges.judge_directory("DC", j, str(d / "pred"),
                                     str(d / "out"), **QUIET)
            out.setdefault("resume", []).append(
                json.loads((d / "out" / "v.json").read_text()))
        out["requests"] = [[{**r, "body": r["body"]} for r in s.requests]
                           for s in stubs]
    finally:
        for s in stubs:
            s.close()
    assert out["batch"] == [8.0, 5.0, 10.0, None]
    assert out["resume"][1]["QAs"][1]["scores"]["DC"] == 3.0
    assert [len(r) for r in out["requests"]] == [1, 2, 4, 3, 1, 2, 1]
    return out


def test_http_judge_matches_jax(tmp_path):
    """The same replies give the same scores, and the port sends the
    same requests (model, messages, temperature, authorization)."""
    want, got = _both(_http_judge, tmp_path)
    assert got == want
    first = got["requests"][0][0]
    assert first["body"]["model"] == "judge-model"
    assert first["auth"] == "Bearer test-key"
    assert got["requests"][2][-1]["body"]["model"] == "fallback-model"


def test_mllm_client_over_stub_matches_jax(tmp_path):
    """``MLLMClient`` (the datagen LLM client) over the stub: chat, vision
    (base64 image parts) and mix_chat send the same bodies."""
    img = tmp_path / "k.jpg"
    img.write_bytes(b"\xff\xd8fake-jpeg\xff\xd9")
    got = {}
    for name, m in PKGS.items():
        stub = _Stub([{"content": "ok"}])
        try:
            c = m.client.MLLMClient("gen-model", api_key="k",
                                    base_url=stub.url,
                                    backoff=lambda s: None)
            replies = [c.chat("hi", system="sys"),
                       c.vision("look", [str(img), img.read_bytes()]),
                       c.mix_chat(["a", {"image": str(img)}, "b"])]
            got[name] = (replies, stub.requests, c.prompt_tokens,
                         c.completion_tokens)
        finally:
            stub.close()
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# the five host commands (tests/test_cli.py)
# ---------------------------------------------------------------------------

def _cli(main_fn, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", list(sys.argv))   # jmain rewrites it
    rc = main_fn(argv)
    return rc, capsys.readouterr().out


def test_cli_host_commands_match_jax(tmp_path, capsys, monkeypatch):
    """judge (each metric, twice: the second run skips), summarize and
    nlp-metrics through both command lines on one predictions directory:
    the same exit codes, standard output and files."""
    preds = tmp_path / "preds"
    preds.mkdir()
    (preds / "v.json").write_text(json.dumps(_pred_video()))
    res = {}
    for name, main_fn in (("jax", jmain.main), ("torch", tmain.main)):
        d = tmp_path / name
        runs = []
        for metric in ("IA", "DC", "CA", "TP", "LC", "IA"):
            runs.append(_cli(main_fn, ["judge", "--metric", metric,
                                       "--pred-dir", str(preds), "--out-dir",
                                       str(d / "judged"), "--model", "fake"],
                             capsys, monkeypatch))
        runs.append(_cli(main_fn, ["summarize", "--judged-dir",
                                   str(d / "judged"), "--out",
                                   str(d / "report.json")],
                         capsys, monkeypatch))
        runs.append(_cli(main_fn, ["nlp-metrics", "--pred-dir", str(preds)],
                         capsys, monkeypatch))
        res[name] = (runs, _tree(d, ("judged",)),
                     (d / "report.json").read_bytes())
    assert res["torch"] == res["jax"]
    assert all(rc == 0 for rc, _ in res["torch"][0])
    assert "Avg." in res["torch"][0][6][1]
    judged = res["torch"][1]["judged/v.json"]
    assert set(judged["QAs"][0]["scores"]) == {"IA", "DC", "CA", "TP", "LC"}
