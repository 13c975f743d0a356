"""Scale-out: the data-parallel mesh steps over several torch devices of
one process (`mesh`) and their dry run (`dryrun`), and several host
processes on a `torch.distributed.TCPStore` (`multihost`). Counterpart
of `mm2tpu/parallel/` (`mesh.py`, `multihost.py`;
`__graft_entry__.dryrun_multichip`)."""
