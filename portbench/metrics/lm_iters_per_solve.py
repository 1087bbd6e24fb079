"""lm_iters_per_solve: ``LMResult.iterations`` (the program's count of
outer LM iterations, as ``run_g2o_file`` returns it) averaged over the
traced solves."""


def read(ctx):
    its = [s["lm_iterations"] for s in ctx["solves"] if "lm_iterations" in s]
    if not its:
        return None
    return sum(its) / len(its)
