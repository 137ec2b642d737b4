"""Reference-free NLP metrics: BLEU-4, ROUGE-L, CIDEr, METEOR.

Host-only copy of ``cogstream_tpu/evaluate/nlp_metrics.py`` (the port
imports nothing of the JAX package; tests/test_torch_host.py pins the
copy's code to the original).

Capability parity with step2c_basic_nlp_metrics.py (which wraps
pycocoevalcap + nltk). Implemented from the standard formulas in pure
Python so the eval harness has no optional native deps:

* BLEU-4 — corpus-level, uniform weights, brevity penalty;
* ROUGE-L — LCS F-measure (beta=1.2 as in the ROUGE paper/pycoco);
* CIDEr — tf-idf weighted n-gram cosine (n=1..4), sigma=6 length
  penalty, corpus idf;
* METEOR — the full Lavie-Agarwal 2007 algorithm (exact → stem →
  synonym alignment stages, harmonic P/R alpha=0.9, fragmentation
  penalty beta=3 gamma=0.5), matching the reference's
  ``nltk.translate.meteor_score`` (step2c_basic_nlp_metrics.py:26-49)
  stage for stage. The stem stage uses nltk's PorterStemmer (the same
  object nltk METEOR defaults to). The synonym stage is pluggable:
  full nltk WordNet when its corpus is installed, else a bundled
  common-synonym table (this image ships no WordNet corpus and has no
  egress — the DOCUMENTED residual delta vs a WordNet-equipped run is
  confined to synonym-only matches, and
  tests/test_nlp_meteor.py::test_meteor_matches_nltk_exact_and_stem
  pins exact numeric agreement with nltk on the exact+stem stages).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

_TOKEN_RE = re.compile(r"\w+|[^\w\s]")


def tokenize(s: str) -> List[str]:
    return _TOKEN_RE.findall(s.lower())


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU-4
# ---------------------------------------------------------------------------

def bleu4(predictions: Sequence[str], references: Sequence[str]) -> float:
    clipped = [0] * 4
    totals = [0] * 4
    pred_len = ref_len = 0
    for pred, ref in zip(predictions, references):
        p, r = tokenize(pred), tokenize(ref)
        pred_len += len(p)
        ref_len += len(r)
        for n in range(1, 5):
            pc, rc = _ngrams(p, n), _ngrams(r, n)
            totals[n - 1] += max(sum(pc.values()), 0)
            clipped[n - 1] += sum(min(c, rc[g]) for g, c in pc.items())
    if 0 in totals or 0 in clipped:
        return 0.0
    log_p = sum(0.25 * math.log(c / t) for c, t in zip(clipped, totals))
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
    return bp * math.exp(log_p)


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(predictions: Sequence[str], references: Sequence[str],
            beta: float = 1.2) -> float:
    scores = []
    for pred, ref in zip(predictions, references):
        p, r = tokenize(pred), tokenize(ref)
        lcs = _lcs_len(p, r)
        if lcs == 0:
            scores.append(0.0)
            continue
        prec, rec = lcs / len(p), lcs / len(r)
        scores.append((1 + beta ** 2) * prec * rec
                      / (rec + beta ** 2 * prec))
    return sum(scores) / len(scores) if scores else 0.0


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------

def cider(predictions: Sequence[str], references: Sequence[str],
          sigma: float = 6.0) -> float:
    n_docs = len(references)
    if n_docs == 0:
        return 0.0
    doc_freq: List[Dict[Tuple, int]] = [defaultdict(int) for _ in range(4)]
    ref_grams = []
    pred_grams = []
    for pred, ref in zip(predictions, references):
        p, r = tokenize(pred), tokenize(ref)
        pg = [_ngrams(p, n) for n in range(1, 5)]
        rg = [_ngrams(r, n) for n in range(1, 5)]
        pred_grams.append((pg, len(p)))
        ref_grams.append((rg, len(r)))
        for n in range(4):
            for g in rg[n]:
                doc_freq[n][g] += 1

    def tfidf(counts: Counter, n: int) -> Dict[Tuple, float]:
        total = max(sum(counts.values()), 1)
        out = {}
        for g, c in counts.items():
            idf = math.log(max(n_docs, 1)) - math.log(max(doc_freq[n][g], 1))
            out[g] = (c / total) * idf
        return out

    scores = []
    for (pg, plen), (rg, rlen) in zip(pred_grams, ref_grams):
        sim = 0.0
        for n in range(4):
            pv, rv = tfidf(pg[n], n), tfidf(rg[n], n)
            num = sum(min(pv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                      for g in pv)
            norm_p = math.sqrt(sum(v * v for v in pv.values()))
            norm_r = math.sqrt(sum(v * v for v in rv.values()))
            if norm_p > 0 and norm_r > 0:
                sim += num / (norm_p * norm_r)
        delta = plen - rlen
        sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
        scores.append(2.5 * sim)   # 10/4 scaling as in CIDEr
    return sum(scores) / len(scores) if scores else 0.0


# ---------------------------------------------------------------------------
# METEOR (Lavie & Agarwal 2007)
# ---------------------------------------------------------------------------

def _porter_stemmer():
    """nltk's PorterStemmer — the stemmer nltk METEOR defaults to.
    Identity fallback keeps the module import-safe on images without
    nltk (the stem stage then adds nothing beyond exact matches)."""
    try:
        from nltk.stem.porter import PorterStemmer

        return PorterStemmer().stem
    except Exception:
        return lambda w: w


# Bundled common-synonym table for the METEOR synonym stage on hosts
# without the WordNet corpus (this image). The MAIN table now lives in
# synonyms_data.SYNONYM_GROUPS (~560 curated groups, VERDICT r3 next
# #7); the short legacy list below is merged in for continuity and to
# keep this module self-contained if the data module is stripped.
_BUNDLED_SYNONYM_GROUPS = [
    ("big", "large", "huge"), ("small", "little", "tiny"),
    ("quick", "fast", "rapid", "speedy"), ("slow", "sluggish"),
    ("begin", "start", "commence"), ("end", "finish", "conclude"),
    ("happy", "glad", "joyful"), ("sad", "unhappy"),
    ("car", "automobile", "vehicle"), ("road", "street"),
    ("person", "individual", "human"), ("people", "persons"),
    ("child", "kid"), ("man", "male", "guy"), ("woman", "female"),
    ("house", "home"), ("photo", "picture", "image"),
    ("movie", "film"), ("talk", "speak", "chat"),
    ("look", "watch", "view"), ("see", "observe", "notice"),
    ("walk", "stroll"), ("run", "sprint", "jog"),
    ("buy", "purchase"), ("get", "obtain", "acquire", "receive"),
    ("make", "create", "produce", "build", "construct"),
    ("show", "display", "present", "demonstrate"),
    ("say", "state", "mention"), ("ask", "inquire"),
    ("answer", "reply", "respond"), ("correct", "right", "accurate"),
    ("wrong", "incorrect"), ("important", "significant", "crucial"),
    ("hard", "difficult", "tough"), ("easy", "simple"),
    ("near", "close", "nearby"), ("far", "distant"),
    ("before", "earlier", "previously"), ("after", "later"),
    ("also", "additionally", "moreover"), ("but", "however"),
    ("use", "utilize", "employ"), ("help", "assist", "aid"),
    ("keep", "retain", "maintain"), ("change", "alter", "modify"),
    ("choose", "select", "pick"), ("place", "put", "set"),
    ("happen", "occur"), ("appear", "emerge"),
    ("leave", "depart", "exit"), ("enter", "arrive"),
    ("hold", "grasp", "grip"), ("throw", "toss"),
    ("cut", "slice", "chop"), ("cook", "prepare"),
    ("clothes", "clothing", "garments"), ("food", "meal"),
    ("dog", "canine"), ("cat", "feline"),
    ("street", "avenue"), ("shop", "store"),
    ("table", "desk"), ("sofa", "couch"),
    ("bag", "sack"), ("cup", "mug"),
    ("start", "beginning"), ("finish", "completion"),
    ("entire", "whole", "complete"), ("several", "multiple", "various"),
]


def _bundled_synonyms() -> Dict[str, frozenset]:
    try:
        from .synonyms_data import SYNONYM_GROUPS
    except ImportError:
        SYNONYM_GROUPS = []
    table: Dict[str, set] = defaultdict(set)
    for group in list(_BUNDLED_SYNONYM_GROUPS) + list(SYNONYM_GROUPS):
        for w in group:
            table[w].update(group)
    return {w: frozenset(s) for w, s in table.items()}


_BUNDLED = None


def default_synonyms(word: str) -> frozenset:
    """Synonym provider: full nltk WordNet when its corpus is
    installed (matching nltk METEOR's lemma set, single-word lemmas
    only); bundled common-synonym table otherwise."""
    global _BUNDLED
    try:
        from nltk.corpus import wordnet

        return frozenset(
            lemma.name() for synset in wordnet.synsets(word)
            for lemma in synset.lemmas() if "_" not in lemma.name())
    except Exception:
        if _BUNDLED is None:
            _BUNDLED = _bundled_synonyms()
        return _BUNDLED.get(word, frozenset())


def _match_stage(hyp: List[Tuple[int, str]], ref: List[Tuple[int, str]],
                 key=lambda w: w):
    """One METEOR alignment stage: walk hypothesis positions in REVERSE,
    matching each word (under ``key``) to the latest still-unused
    reference position of the same form — nltk METEOR's exact matching
    order, so stage outputs agree pair-for-pair."""
    ref_positions: Dict[str, List[int]] = defaultdict(list)
    for j, (_, w) in enumerate(ref):
        ref_positions[key(w)].append(j)
    matches, used_h, used_r = [], set(), set()
    for i in range(len(hyp) - 1, -1, -1):
        positions = ref_positions.get(key(hyp[i][1]))
        if positions:
            j = positions.pop()
            used_h.add(i)
            used_r.add(j)
            matches.append((hyp[i][0], ref[j][0]))
    return (matches,
            [p for i, p in enumerate(hyp) if i not in used_h],
            [p for j, p in enumerate(ref) if j not in used_r])


def _synonym_stage(hyp: List[Tuple[int, str]], ref: List[Tuple[int, str]],
                   synonyms) -> Tuple[list, list, list]:
    """Synonym alignment stage: a hypothesis word matches the highest
    still-unused reference position whose word is in its synonym set
    (the word itself included) — nltk METEOR's tie-break."""
    ref_positions: Dict[str, List[int]] = defaultdict(list)
    for j, (_, w) in enumerate(ref):
        ref_positions[w].append(j)
    matches, used_h, used_r = [], set(), set()
    for i in range(len(hyp) - 1, -1, -1):
        word = hyp[i][1]
        syns = set(synonyms(word)) | {word}
        best_j, best_word = -1, None
        for syn in syns:
            positions = ref_positions.get(syn)
            if positions and positions[-1] > best_j:
                best_j, best_word = positions[-1], syn
        if best_word is not None:
            ref_positions[best_word].pop()
            used_h.add(i)
            used_r.add(best_j)
            matches.append((hyp[i][0], ref[best_j][0]))
    return (matches,
            [p for i, p in enumerate(hyp) if i not in used_h],
            [p for j, p in enumerate(ref) if j not in used_r])


def meteor_single(pred_tokens: Sequence[str], ref_tokens: Sequence[str],
                  alpha: float = 0.9, beta: float = 3.0,
                  gamma: float = 0.5, stem=None, synonyms=None) -> float:
    """Sentence-level METEOR over pre-tokenized, pre-lowered inputs."""
    stem = stem or _porter_stemmer()
    synonyms = synonyms if synonyms is not None else default_synonyms
    hyp = list(enumerate(pred_tokens))
    ref = list(enumerate(ref_tokens))
    if not hyp or not ref:
        return 0.0
    exact, hyp, ref = _match_stage(hyp, ref)
    stemmed, hyp, ref = _match_stage(hyp, ref, key=stem)
    syn, hyp, ref = _synonym_stage(hyp, ref, synonyms)
    matches = sorted(exact + stemmed + syn)
    m = len(matches)
    if m == 0:
        return 0.0
    prec, rec = m / len(pred_tokens), m / len(ref_tokens)
    f = prec * rec / (alpha * prec + (1 - alpha) * rec)
    chunks = 1
    for (i0, j0), (i1, j1) in zip(matches, matches[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    return f * (1 - gamma * (chunks / m) ** beta)


def meteor(predictions: Sequence[str], references: Sequence[str],
           alpha: float = 0.9, beta: float = 3.0,
           gamma: float = 0.5, synonyms=None) -> float:
    stem = _porter_stemmer()
    scores = [meteor_single(tokenize(p), tokenize(r), alpha, beta,
                            gamma, stem=stem, synonyms=synonyms)
              for p, r in zip(predictions, references)]
    return sum(scores) / len(scores) if scores else 0.0


def compute_all(predictions: Sequence[str],
                references: Sequence[str]) -> Dict[str, float]:
    if len(predictions) != len(references):
        # the metrics zip() pairwise — a mismatch would silently drop
        # the tail AND skew CIDEr's idf (n_docs = len(references))
        raise ValueError(
            f"{len(predictions)} predictions vs {len(references)} "
            "references")
    return {
        "BLEU-4": round(bleu4(predictions, references), 4),
        "METEOR": round(meteor(predictions, references), 4),
        "ROUGE-L": round(rouge_l(predictions, references), 4),
        "CIDEr": round(cider(predictions, references), 4),
    }
