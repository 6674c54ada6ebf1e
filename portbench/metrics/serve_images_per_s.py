"""Frames whose disparities came back to the host in the window, over the
window's seconds (host clock)."""


def read(run):
    return None if run.frames is None else run.frames / run.window_s
