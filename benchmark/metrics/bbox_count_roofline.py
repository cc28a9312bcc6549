"""csrc/bbox_count.cu's share of the bandwidth bound, %: the bytes the
window's box counts need (12 B a point of the files their box meets) at
the card's peak, over the kernel's device time."""

from yardstick.measure import box_bytes, roofline


def read(run):
    if run.trace is None:
        return None
    need = sum(box_bytes(r["bounds"], run.dataset) for r in run.requests
               if "bounds" in r)
    return roofline(need, run.trace.kernel_s("bbox_count_multi_kernel"), run.device_kind)
