"""Backtrack and post-chain: seconds of the stages `chain.backtrack`
(the host backtrack of each chained row) and `post` (the copied
`_post_chain`: regions, mapq, pairing) a megabase of query."""


def read(run):
    s = run.stage_s("chain.backtrack") + run.stage_s("post")
    return s / run.query_Mb if s > 0 else None
