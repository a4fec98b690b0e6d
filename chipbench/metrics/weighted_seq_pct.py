"""Share of the sequences that reach the model's ``weighted_loss`` in the
window with a nonzero weight: the rows of the fused pass that carry any
of the decoded gradient.  Padding slots and the slots of workers the
decode leaves out are computed all the same."""


def read(ctx):
    rows = ctx.counters.get("rows", 0)
    return 100.0 * ctx.counters["weighted_rows"] / rows if rows else None
