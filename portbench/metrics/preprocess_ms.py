"""Mean wall of the benchmark's synchronised call of
``repro_torch.graphs.kadabra.preprocess`` a query, by the host's clock."""


def read(run):
    walls = [q["preprocess_s"] for q in run.queries if "preprocess_s" in q]
    return 1e3 * sum(walls) / len(walls) if walls else None
