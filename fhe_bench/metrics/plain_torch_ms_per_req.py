"""Device milliseconds a request of everything launched outside the six
hand-written kernels' wrappers (NTT forward and inverse, both rings;
ks_inner_product; fused_mac_mod): the plain PyTorch RNS, polynomial and LWE
arithmetic."""


def read(summary):
    if summary.requests <= 0:
        return None
    wrapped = sum(c.device_s for c in summary.calls)
    return 1e3 * (summary.device_s - wrapped) / summary.requests
