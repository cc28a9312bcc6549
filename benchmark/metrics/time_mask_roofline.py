"""csrc/mask_bits.cu's GPS-time mask's share of the bandwidth bound, %: the
bytes the window's collect and -o time requests need (8 B a point, every
point, and its bit of the mask written, 1/8 B) at the card's peak, over
the device time of the raw time mask (mask_packed_kernel on
TimeRawTiles)."""

from yardstick.measure import roofline, time_mask_bytes

KERNEL = "TimeRawTiles"  # the kernel's template argument, in its trace name


def read(run):
    if run.trace is None:
        return None
    n = sum("time_range" in r and bool(r.get("collect") or r.get("output"))
            for r in run.requests)
    return roofline(n * time_mask_bytes(run.dataset), run.trace.kernel_s(KERNEL),
                    run.device_kind)
