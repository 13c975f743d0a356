"""Backtrack and post-chain: the share of the stages `chain.backtrack`
and `post` spent in the calls into the native runtime (the
accumulator-only stage `post.native`: `v_carry`, `chain_backtrack`,
`gen_regs_arrays`, `set_parent_select`, `est_err_div`), in %. The rest
is the interpreter's. None where the program times no such call."""


def read(run):
    if "post.native" not in run.stages:
        return None
    s = run.stage_s("chain.backtrack") + run.stage_s("post")
    return 100.0 * run.stage_s("post.native") / s if s > 0 else None
