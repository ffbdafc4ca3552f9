"""Share of ks_inner_product's roofline: the sum of each call's bound
(``roofline.ks_bound`` at its shapes, key rows and epilogue rows) over the
sum of the device time the profiler links to those calls, in percent."""


def read(summary):
    calls = [c for c in summary.calls if c.kind == "ks_inner_product"]
    spent = sum(c.device_s for c in calls)
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(c.bound_s() for c in calls) / spent
