"""Evaluation: quality metrics, the Predator protocol, pose sync and the scene evaluator."""
