"""Evaluation metrics of the port (numpy and scipy; no evaluator networks
yet)."""
