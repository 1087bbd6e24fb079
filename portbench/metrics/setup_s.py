"""setup_s: from the start of the process to the start of the window:
imports and the card, inputs from the seed, the program's graph and one
warm solve (host clock)."""


def read(ctx):
    return ctx["setup_s"]
