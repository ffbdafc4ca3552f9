"""Share of the NTT's roofline: the sum of each NTT wrapper call's bound
(``roofline.ntt_bound`` or ``ntt_small_bound`` at its shapes) over the sum of
the device time the profiler links to those calls, in percent."""


def read(summary):
    calls = [c for c in summary.calls if c.kind == "ntt"]
    spent = sum(c.device_s for c in calls)
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(c.bound_s() for c in calls) / spent
