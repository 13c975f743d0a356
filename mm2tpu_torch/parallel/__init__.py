"""Scale-out over several torch devices: the data-parallel mesh steps
(`mesh`) and their dry run (`dryrun`). Counterpart of `mm2tpu/parallel/`
(`mesh.py`; `__graft_entry__.dryrun_multichip`)."""
