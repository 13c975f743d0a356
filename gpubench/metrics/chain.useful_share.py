"""Batch chaining glue (`map_frags_batched`, ops/chain_packed.py): the
real anchors' share of the padded (B, N) slots sent to the chaining
kernels (`chain.anchors` / `chain.padded_anchors`), in %."""


def read(run):
    pad = run.counters.get("chain.padded_anchors", 0)
    if not pad:
        return None
    return 100.0 * run.counters.get("chain.anchors", 0) / pad
