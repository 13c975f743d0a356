"""Extension batcher (mapping/extbatch.py): fills a flush on the card,
`ext.fills` / `ext.dispatches`."""


def read(run):
    d = run.counters.get("ext.dispatches", 0)
    return run.counters.get("ext.fills", 0) / d if d else None
