"""``interaction.forwards.train``: the interaction networks' passes over
their edges a step, forward and recomputed (GraphCast's
``models.graphcast.interaction_forwards``, which the configuration's
``evals`` hands on): 18 a step with no recomputation, 36 with every conv
recomputed once. None where the window counted none."""


def read(ctx):
    if ctx.get("task") != "train" or not ctx.get("evals"):
        return None
    return sum(ctx["evals"]) / len(ctx["evals"])
