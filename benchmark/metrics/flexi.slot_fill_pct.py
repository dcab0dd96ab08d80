"""``flexi.slot_fill_pct``: the surface cubes of the traced steps over
their ``max_cubes`` slots, in per cent (the port's counter
``flexi_geometry.slot_counts``, read after the traced steps): the share of
the extractor's fixed-capacity cube work that is not padding.  A padded
slot reads the sentinel row, a zero row in the gathers' backward."""


def read(ctx):
    try:
        from gshell_tpu_torch.geometry.flexi_geometry import slot_counts
    except ImportError:  # a program that keeps no such counter
        return None
    lo, hi = ctx.trace.window_ns
    rows = [r for r in slot_counts() if lo <= r["time_ns"] <= hi]
    if not rows:
        return None
    return 100.0 * sum(r["surface_cubes"] for r in rows) / sum(r["max_cubes"] for r in rows)
