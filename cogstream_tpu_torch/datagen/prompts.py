"""Prompt library for the dataset-generation pipeline (C19/C21 tasks).

Host-only copy of ``cogstream_tpu/datagen/prompts.py`` (the port imports
nothing of the JAX package; tests/test_torch_host.py pins the copy's
code to the original).

Same task structure as the reference's prompt set
(dataset_gen_pipeline/tools/all_prompt.py) — L1 basic + L2 co-reference
QAs per segment, L3 cross-temporal QAs against the rolling summary, a
polish pass, two-task rolling summarization, L4 global QAs, the
Dialogue-Recalling QA, Object-Tracking co-reference QAs, and the 0-7
dependency-scoring rubric — written in our own words (prompts are task
specs, not copied text).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

JSON_QA_FORMAT = (
    'Reply with ONLY a JSON list of objects like '
    '[{"Q": "...", "A": "..."}] and no other text.')


def basic_qa_prompt(n_questions: int = 5) -> str:
    """L1: directly-observable facts, each tagged with a class label.

    The reference's first-segment prompt (all_prompt.py:149-157) requires
    every L1 question to open with one of four bracketed labels; the
    label later becomes the QA's fine-grained class in the dataset
    (dialogue_path_construction.py extract_label)."""
    return (
        "You are watching one segment of a longer video, given as "
        "keyframes in order. Write up to "
        f"{n_questions} question-answer pairs about facts a viewer can "
        "verify directly in THIS segment. Start every question with "
        "exactly one bracketed label naming what it tests:\n"
        "[Temporal Perception] - when something happens, or before/after "
        "ordering within the segment\n"
        "[Attributes] - color, size, position, surroundings of something "
        "visible\n"
        "[Actions] - an observable behaviour or movement\n"
        "[Items] - an object or item in the scene\n"
        "Answers must be short, factual and self-contained. "
        + JSON_QA_FORMAT)


def coreference_qa_prompt(l1_json: str, n_questions: int = 2) -> str:
    """L2: pronoun follow-ups, each tied to one L1 pair by id.

    Distinct tagged level per the reference (all_prompt.py:158-166):
    each question begins '[Co-reference](QA<k>)' where k is the 1-based
    index of the L1 pair whose entity the pronoun resolves against; the
    pronoun must only be unambiguous when read together with that pair."""
    return (
        "Here are question-answer pairs already written about the "
        f"current video segment:\n{l1_json}\n\n"
        f"Write up to {n_questions} follow-up pairs about an entity from "
        "one of those pairs, referring to it ONLY by a pronoun (he/she/"
        "it/they) or definite reference, so the question is clear only "
        "when paired with its source. Begin each question with "
        "'[Co-reference](QA<k>)' where <k> is the 1-based number of the "
        "source pair, e.g. '[Co-reference](QA2) What is he holding "
        "now?'. Answers stay grounded in the current segment. "
        + JSON_QA_FORMAT)


def cross_temporal_qa_prompt(summary: str, n_questions: int = 4) -> str:
    """L3: questions whose answer needs BOTH this segment and history."""
    return (
        "Here is a summary of everything that happened earlier in the "
        f"video:\n{summary}\n\n"
        "Now look at the keyframes of the CURRENT segment. Write up to "
        f"{n_questions} question-answer pairs that can only be answered "
        "by combining the current segment with the earlier events — "
        "comparisons over time, cause-and-effect across segments, "
        "changes of state, repeated appearances. Do not ask anything "
        "answerable from the current segment alone. "
        + JSON_QA_FORMAT)


def polish_prompt(qa_json: str) -> str:
    """Polish pass over L3 candidates (grammar, specificity, leakage)."""
    return (
        "Review these draft question-answer pairs about a video:\n"
        f"{qa_json}\n\n"
        "Fix grammar, make vague questions specific, remove any pair "
        "whose question leaks its own answer or that cannot be answered "
        "from video content, and keep the rest unchanged in meaning. "
        + JSON_QA_FORMAT)


def rolling_summary_prompt(prev_summary: Optional[str]) -> str:
    """Two-task summarization: update the running summary AND list the
    entities that stay trackable."""
    prev = prev_summary or "(nothing yet — this is the first segment)"
    return (
        "Running summary of the video so far:\n"
        f"{prev}\n\n"
        "Using the keyframes of the new segment, produce an UPDATED "
        "running summary (3-6 sentences, chronological, keep earlier "
        "events) followed by a line 'Entities:' listing the people and "
        "objects that remain identifiable for future segments.")


def global_qa_prompt(summary: str, n_questions: int = 2) -> str:
    """L4: whole-video questions, asked on the last segment."""
    return (
        "Here is the full chronological summary of a video:\n"
        f"{summary}\n\n"
        f"Write up to {n_questions} question-answer pairs about the video "
        "AS A WHOLE: overall narrative, purpose, global counts, the "
        "order of major events. " + JSON_QA_FORMAT)


def recalling_qa_prompt(history_qas: str) -> str:
    """Dialogue-Recalling: asks what was previously asked/answered."""
    return (
        "Here are the question-answer pairs a user already asked about "
        f"this video:\n{history_qas}\n\n"
        "Write ONE question-answer pair where the user asks what they "
        "previously asked or were told (e.g. 'What did you tell me about "
        "X earlier?'), with the correct answer recalling that exchange. "
        + JSON_QA_FORMAT)


def object_tracking_prompt(entity: str, first_window: str,
                           second_window: str) -> str:
    """Object-Tracking co-reference over annotated appearance windows."""
    return (
        f"The entity '{entity}' appears during {first_window} and again "
        f"during {second_window} of the video. Using the keyframes, write "
        "ONE question-answer pair asked at the second appearance that "
        "refers to the entity by a co-reference ('the same man', 'that "
        "car') and whose answer requires remembering the first "
        "appearance. " + JSON_QA_FORMAT)


def dynamic_updating_prompt() -> str:
    """Dynamic-Updating: a question whose answer changes over time."""
    return (
        "Using the keyframes, write ONE question-answer pair of the form "
        "'What is X doing now?' whose answer is specific to THIS moment "
        "and would have been different earlier in the video. "
        + JSON_QA_FORMAT)


def scoring_prompt(current_q: str, current_a: str,
                   prev_q: str, prev_a: str) -> str:
    """0-7 dependency score of a current QA on a previous QA (C21)."""
    return (
        "Rate how much answering the CURRENT question depends on "
        "information from the PREVIOUS exchange, on a 0-7 scale:\n"
        "0-1: unrelated; 2-3: same topic but independent; 4-5: the "
        "previous exchange provides helpful context; 6-7: the current "
        "answer is impossible or ambiguous without it (shared entities "
        "via co-reference, direct follow-up, cause of the current "
        "state).\n\n"
        f"PREVIOUS exchange:\nQ: {prev_q}\nA: {prev_a}\n\n"
        f"CURRENT question:\nQ: {current_q}\nA: {current_a}\n\n"
        "Reply with ONLY the integer score.")
