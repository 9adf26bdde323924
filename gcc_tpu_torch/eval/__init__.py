"""Epoch-end and test-time evaluation."""
