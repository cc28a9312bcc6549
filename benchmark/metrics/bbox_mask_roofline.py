"""csrc/mask_bits.cu's box mask's share of the bandwidth bound, %: the bytes
the window's collect and -o box requests need (12 B a point of the files
their box meets, and the bit mask of those points written, 1/8 B) at the
card's peak, over mask_bbox_kernel's device time."""

from yardstick.measure import box_mask_bytes, roofline


def read(run):
    if run.trace is None:
        return None
    need = sum(box_mask_bytes(r["bounds"], run.dataset) for r in run.requests
               if "bounds" in r and (r.get("collect") or r.get("output")))
    return roofline(need, run.trace.kernel_s("mask_bbox_kernel"), run.device_kind)
