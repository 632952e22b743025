"""Seconds of the cell's ``precompute`` call and the graph's move to the
card, by the host clock, ending in a synchronize."""


def read(ctx):
    return ctx.get("precompute_s")
