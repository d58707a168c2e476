"""Datasets (training and evaluation), their transforms, the segment mappers and
the dataset catalog, and image decoding."""
