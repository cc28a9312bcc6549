"""csrc/class_count.cu's share of the bandwidth bound, %: the bytes the
window's class counts need (1 B a point, every point) at the card's peak,
over the kernel's device time."""

from yardstick.measure import roofline, scan_bytes


def read(run):
    if run.trace is None:
        return None
    n = sum("class" in r for r in run.requests)
    return roofline(n * scan_bytes("class", run.dataset),
                    run.trace.kernel_s("class_count_kernel"), run.device_kind)
