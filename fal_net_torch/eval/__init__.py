"""Serving-side evaluation: the batched disparity pipeline."""
