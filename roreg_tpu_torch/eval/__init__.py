"""Evaluation: quality metrics and the scene evaluator."""
