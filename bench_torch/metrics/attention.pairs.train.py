"""``attention.pairs.train``: millions of (query, key) scores the mesh
attention kernel computed a step, forward, recomputed and backward
(``mesh_attention.pairs``, which GenCast's ``Program.step`` hands on and
the configuration's ``evals`` scales): its tiles' area, each pass. None
where the window counted none (the plain version counts nothing)."""


def read(ctx):
    if ctx.get("task") != "train" or not any(ctx.get("evals") or ()):
        return None
    return sum(ctx["evals"]) / len(ctx["evals"])
