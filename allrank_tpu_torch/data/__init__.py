"""Datasets and batching: libsvm slates in, fixed-shape slate batches out."""
