"""Host reads of device values (``repro_torch.device.host_syncs``, the
port's own counter) over the window's queries, preprocessing included, per
epoch of the engine (Σ ``AdaptiveResult.epochs``)."""


def read(run):
    syncs = sum(q.get("host_syncs", 0) for q in run.queries)
    epochs = sum(q.get("epochs", 0) for q in run.queries)
    return syncs / epochs if epochs else None
