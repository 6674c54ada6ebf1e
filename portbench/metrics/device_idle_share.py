"""Share (%) of the traced window in which no operation ran on the device:
1 - the union of device operation intervals / the window."""


def read(run):
    if not run.trace or not run.trace["window_us"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_us"] / run.trace["window_us"])
