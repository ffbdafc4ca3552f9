"""Share of the traced window's wall time in which no device operation ran,
in percent."""


def read(summary):
    if summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
