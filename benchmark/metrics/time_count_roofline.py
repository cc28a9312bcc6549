"""csrc/time_count.cu's share of the bandwidth bound, %: the bytes the
window's GPS-time counts need (8 B a point, every point) at the card's
peak, over the kernel's device time."""

from yardstick.measure import roofline, scan_bytes


def read(run):
    if run.trace is None:
        return None
    n = sum("time_range" in r for r in run.requests)
    return roofline(n * scan_bytes("time", run.dataset),
                    run.trace.kernel_s("time_count_multi_kernel"), run.device_kind)
