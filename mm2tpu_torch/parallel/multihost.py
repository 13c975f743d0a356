"""Multi-host scale-out: a rendezvous on a `torch.distributed.TCPStore`
and the ordered merge of the hosts' output stripes.

Counterpart of `mm2tpu/parallel/multihost.py`. `HostConfig`,
`part_path`, `merge_parts`, `PartWriter` and `cleanup_parts` are that
module's, verbatim apart from the file that `merge_parts`' error names.
The rendezvous, the barrier and the key-value store, which the JAX
package takes from the `jax.distributed` coordination service, are
rewritten over a `TCPStore`:

- one process per host. Host 0 runs the store's server at
  `--coordinator ADDR:PORT` and waits, at most `--host-timeout` seconds,
  until all `n_hosts` processes have joined; the others connect to it
  under the same bound (`init_distributed`, which returns the host's
  `Coordinator`; the CLI passes it down to `cli.map_all`);
- input striped round-robin by fragment index (host h maps the
  fragments with idx % n_hosts == h), a replicated index on every host,
  and each host's stripe written to its own part file, which host 0
  interleaves round-robin after the `map_done` barrier: byte-identical
  to a single-host run;
- `Coordinator.barrier(name)`: each host adds 1 to `barrier/<name>`;
  the host that brings it to `n_hosts` sets `barrier/<name>/done`, and
  every host waits for that key, at most the timeout;
- `Coordinator.finish()`, after the last barrier: every host but 0
  counts itself out, and host 0 waits for those `n_hosts - 1` counts
  before it lets the store go. The server lives in host 0's process, so
  a host 0 that left first would fail a slower host that is still
  reading the last barrier's key (the counterpart of the JAX runtime's
  shutdown barrier).

No process group is made: the mapping hot path needs no cross-host
collective (pure data parallelism over reads), and each process drives
its own card, or its own local mesh (`parallel/mesh.py`, `--mesh`), as
it would alone. Several host processes may share one card.

SHARED-FILESYSTEM REQUIREMENT: host 0 reads every host's part file, so
`-o OUTPUT` must lie on a filesystem that every host sees (any path on
one machine). Host 0 raises an error naming this requirement when a
part file is missing after the `map_done` barrier. The output goes
through part files, not the store, because it is unbounded while the
store is a control channel.

FAILURE MODE: if a host stops or dies, the others fail at the
rendezvous or at the next barrier within `--host-timeout` seconds, or
at once when the store's server (host 0) is gone; every surviving
process exits non-zero and host 0 removes the merged output, so a
partial result cannot pass for a complete one.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

# ---- copied verbatim from mm2tpu/parallel/multihost.py ----


@dataclass
class HostConfig:
    n_hosts: int = 1
    host_id: int = 0
    coordinator: Optional[str] = None   # "ip:port"; None = single host
    timeout_s: int = 600   # rendezvous + barrier timeout (failure bound)

    @property
    def active(self) -> bool:
        return self.n_hosts > 1


# ---- the port's coordination, over a torch.distributed.TCPStore ----


def open_store(cfg: HostConfig):
    """The run's `TCPStore`: host 0 serves it at `cfg.coordinator` and
    returns once all `cfg.n_hosts` hosts have joined; the others connect
    to it. Either raises after `cfg.timeout_s` seconds."""
    from torch.distributed import TCPStore
    addr, port = cfg.coordinator.rsplit(":", 1)
    return TCPStore(addr, int(port), world_size=cfg.n_hosts,
                    is_master=cfg.host_id == 0,
                    timeout=datetime.timedelta(seconds=max(1, cfg.timeout_s)),
                    wait_for_workers=True)


class Coordinator:
    """One host's barriers, key-value store and count-out over the run's
    `TCPStore` (the JAX module's `barrier`, `kv_set` and `kv_get`, which
    use `jax.distributed`'s client; several hosts may share one process,
    as threads do in a test)."""

    def __init__(self, store, n_hosts: int, host_id: int, timeout_s: int):
        self.store = store
        self.n_hosts, self.host_id = n_hosts, host_id
        self.timeout = datetime.timedelta(seconds=max(1, timeout_s))

    def _wait(self, key: str, timeout_ms: Optional[int]) -> None:
        self.store.wait([key], self.timeout if timeout_ms is None else
                        datetime.timedelta(milliseconds=timeout_ms))

    def barrier(self, name: str, timeout_ms: Optional[int] = None) -> None:
        key = "barrier/" + name
        if self.store.add(key, 1) == self.n_hosts:
            self.store.set(key + "/done", "1")
        self._wait(key + "/done", timeout_ms)

    def kv_set(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def kv_get(self, key: str, timeout_ms: Optional[int] = None) -> str:
        self._wait(key, timeout_ms)
        return self.store.get(key).decode()

    def finish(self) -> None:
        """Host 0 returns once every other host has counted itself out;
        the others count out and return."""
        if self.host_id != 0:
            if self.store.add("finish", 1) == self.n_hosts - 1:
                self.store.set("finish/done", "1")
        else:
            self._wait("finish/done", None)


def init_distributed(cfg: HostConfig) -> Optional[Coordinator]:
    """Join the run's store: this host's `Coordinator`, or None for a
    single host. Host 0's server lives as long as its Coordinator."""
    if not cfg.active:
        return None
    return Coordinator(open_store(cfg), cfg.n_hosts, cfg.host_id,
                       cfg.timeout_s)


# ---- copied verbatim from mm2tpu/parallel/multihost.py ----


def part_path(out_path: str, host_id: int) -> str:
    return "%s.host%04d.part" % (out_path, host_id)


def merge_parts(out_path: str, n_hosts: int, out_fh) -> int:
    """Host 0: interleave the per-host part files round-robin by fragment
    index — the cross-host generalization of the --split-prefix merge
    (map.c:671-714). Each part is a sequence of length-prefixed records,
    one per fragment mapped by that host (in stripe order). Returns the
    total record count."""
    missing = [h for h in range(n_hosts)
               if not os.path.exists(part_path(out_path, h))]
    if missing:
        raise RuntimeError(
            "multi-host merge: part file(s) missing for host(s) %s — "
            "-o OUTPUT must be on a filesystem shared by all hosts "
            "(see mm2tpu_torch/parallel/multihost.py)" % missing)
    readers = [open(part_path(out_path, h), "rb") for h in range(n_hosts)]

    def next_rec(f):
        hdr = f.read(8)
        if len(hdr) < 8:
            return None
        n = int.from_bytes(hdr, "little")
        return f.read(n)

    total = 0
    alive = True
    while alive:
        alive = False
        for f in readers:
            rec = next_rec(f)
            if rec is not None:
                out_fh.write(rec.decode())
                total += 1
                alive = True
    for f in readers:
        f.close()
    return total


class PartWriter:
    """Per-host stripe output: length-prefixed records in fragment order."""

    def __init__(self, out_path: str, host_id: int):
        self._f = open(part_path(out_path, host_id), "wb")

    def write(self, text: str) -> None:
        b = text.encode()
        self._f.write(len(b).to_bytes(8, "little"))
        self._f.write(b)

    def close(self) -> None:
        self._f.close()


def cleanup_parts(out_path: str, n_hosts: int) -> None:
    for h in range(n_hosts):
        try:
            os.remove(part_path(out_path, h))
        except OSError:
            pass
