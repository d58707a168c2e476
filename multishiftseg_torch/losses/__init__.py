"""Losses of the Mask2Anomaly fine-tuning step: matcher, RCL, set criterion."""
