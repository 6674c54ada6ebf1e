"""Stereo pairs of the training steps started in the window, over the
window's seconds, which end when the device has finished them (host clock)."""


def read(run):
    return None if run.pairs is None else run.pairs / run.window_s
