"""Mean τ (``AdaptiveResult.num``, the samples in the checked state) of the
window's queries: what the stopping rule needed."""


def read(run):
    taus = [q["tau"] for q in run.queries if "tau" in q]
    return sum(taus) / len(taus) if taus else None
