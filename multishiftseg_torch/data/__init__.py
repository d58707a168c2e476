"""Evaluation datasets, their transforms and image decoding."""
