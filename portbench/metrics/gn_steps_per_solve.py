"""gn_steps_per_solve: the Gauss-Newton steps a bundle-adjustment solve
runs (``ba_gn_optimize_sqrt``'s trip count, which the traffic sets where
the float64 reference has converged), averaged over the traced solves; a
later change to the solver's schedule shows here."""


def read(ctx):
    steps = [s["gn_steps"] for s in ctx["solves"] if "gn_steps" in s]
    if not steps:
        return None
    return sum(steps) / len(steps)
