"""Utilities: the device rule and running-average meters."""
