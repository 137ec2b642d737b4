"""Evaluation harness of the port: answer generation on the card
(``answer_generate``), the five LLM-judge metrics (``judges``), score
aggregation (``aggregate``) and the NLP metrics (``nlp_metrics``); the
last three are host-only copies of the JAX package's modules."""
