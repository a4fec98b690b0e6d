"""The ``ssd_scan`` kernel's share of its roofline: the least time every
call of the window could take at the card's HBM bandwidth (its bytes,
``chipbench.flops.ssd_scan_bytes``: bytes bound it, its FLOPs at the
model's chunk being about a third of that time at mamba2's widths), over
the device time of the kernels whose names carry ``ssd_scan``."""

from chipbench import flops


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    calls = [c for c in ctx.counters.get("ssd_calls", []) if ctx.t0 <= c[0] <= ctx.t1]
    busy = sum(s for name, s in ctx.trace.by_name(ctx.t0, ctx.t1).items() if "ssd_scan" in name)
    if not calls or busy <= 0:
        return None
    least = sum(flops.ssd_scan_bytes(*shape, bc) for _, shape, bc in calls) \
        / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least / busy
