"""Device operations (kernels, copies and fills) a request in the trace."""


def read(summary):
    if summary.requests <= 0:
        return None
    return summary.device_ops / summary.requests
