"""The port's multi-host runs (`python -m mm2tpu_torch.cli --hosts N
--device cpu`, `mm2tpu_torch/parallel/multihost.py`): host processes on
127.0.0.1 joined by a `torch.distributed.TCPStore`, each mapping its
stripe of the reads, host 0 merging the stripes. The merged PAF and SAM
must equal the port's single-host run and `mm2tpu --map-mode batch` on
the same inputs (the JAX package runs in this process), `@PG` aside.
Also: the merge and the store's barrier, key-value store and count-out
in this process (threads as hosts), every refusal of the CLI's
validation, and a stopped peer.

The inputs are the MT pair rebuilt from the repository's goldens
(`test_torch_stream.rebuild_mt`) and reads cut from MT_human."""
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from mm2tpu import cli as jcli
from mm2tpu_torch import cli as tcli
from mm2tpu_torch.parallel import multihost as mh
from test_torch_pipeline import REPO
from test_torch_stream import GOLDEN, no_pg, rebuild_mt


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def mt(tmp_path_factory):
    """MT_orang and reads of MT_human: n reads of 2000-2240 bp at a
    stride of 379 (as tests/test_multihost.py cuts them)."""
    d = tmp_path_factory.mktemp("multihost")
    orang, human = rebuild_mt(d)
    seq = open(human).read().splitlines()[1]
    reads = {}
    for n in (11, 12, 16, 30, 151):
        reads[n] = str(d / ("reads%d.fa" % n))
        with open(reads[n], "w") as f:
            for i in range(n):
                st = (i * 379) % (len(seq) - 2300)
                f.write(">r%d\n%s\n" % (i, seq[st:st + 2000 + (i % 7) * 40]))
    return orang, reads


def spawn_hosts(tmp_path, args, n, out, timeout_s=120):
    """n host processes of one run: (processes, their stderr files)."""
    coord = "127.0.0.1:%d" % free_port()
    procs, errs = [], []
    for h in range(n):
        errs.append(tmp_path / ("host%d.err" % h))
        with open(errs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mm2tpu_torch.cli", *args,
                 "--device", "cpu", "--hosts", str(n), "--host-id", str(h),
                 "--coordinator", coord, "--host-timeout", str(timeout_s),
                 "-o", str(out)],
                cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=err))
    return procs, errs


def port_single(args, out):
    assert tcli.main([*args, "--device", "cpu", "-o", str(out)]) == 0
    return out.read_text()


def jax_batch(args, out):
    assert jcli.main([*args, "--map-mode", "batch", "-o", out]) == 0
    with open(out) as fh:
        return fh.read()


# ---- in this process ----


def test_merge_parts_interleaves_uneven_stripes(tmp_path):
    """Seven fragments over three hosts (3, 2 and 2 records, one of them
    empty, as an unmapped fragment's is): the merge restores input order."""
    out = str(tmp_path / "out.paf")
    recs = ["a\n", "b\n", "", "d\nd2\n", "e\n", "f\n", "g\n"]
    writers = [mh.PartWriter(out, h) for h in range(3)]
    for i, rec in enumerate(recs):
        writers[i % 3].write(rec)
    for w in writers:
        w.close()
    with open(out, "w") as fh:
        assert mh.merge_parts(out, 3, fh) == len(recs)
    assert open(out).read() == "".join(recs)
    mh.cleanup_parts(out, 3)
    assert not list(tmp_path.glob("*.part"))


def test_merge_names_the_shared_filesystem(tmp_path):
    out = str(tmp_path / "out.paf")
    for h in (0, 2):
        mh.PartWriter(out, h).close()
    with pytest.raises(RuntimeError, match=r"host\(s\) \[1\].*shared by all "
                       "hosts"):
        mh.merge_parts(out, 3, open(out, "w"))


def test_store_rendezvous_barrier_kv_and_count_out():
    """Three threads as hosts: the rendezvous, a key-value exchange
    across a barrier, and host 0's count-out, which returns only after
    the slower hosts have counted out."""
    coord = "127.0.0.1:%d" % free_port()
    got, t_out, errors = {}, {}, []

    def host(h):
        try:
            c = mh.Coordinator(mh.open_store(mh.HostConfig(3, h, coord, 30)),
                               3, h, 30)
            c.kv_set("from%d" % h, "value %d" % h)
            c.barrier("exchange")
            got[h] = [c.kv_get("from%d" % j) for j in range(3)]
            c.barrier("read")
            if h:
                time.sleep(0.5 * h)
                t_out[h] = time.monotonic()
            c.finish()
            if not h:
                t_out[0] = time.monotonic()
            # host 0's server stays up until the others have gone
            c.store.set("after%d" % h, "1")
        except Exception as e:   # surfaced on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(h,)) for h in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert got == {h: ["value 0", "value 1", "value 2"] for h in range(3)}
    assert t_out[0] >= max(t_out[1], t_out[2])


def test_barrier_times_out_within_its_bound():
    """A barrier that one of two hosts never reaches raises after its
    timeout; so does a rendezvous that a host never joins."""
    coord = "127.0.0.1:%d" % free_port()
    box = {}
    t = threading.Thread(target=lambda: box.update(
        s0=mh.open_store(mh.HostConfig(2, 0, coord, 30))))
    t.start()
    s1 = mh.open_store(mh.HostConfig(2, 1, coord, 30))
    t.join(30)
    c0 = mh.Coordinator(box["s0"], 2, 0, 30)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="barrier/alone/done"):
        c0.barrier("alone", timeout_ms=1000)
    assert 0.9 < time.monotonic() - t0 < 10
    with pytest.raises(RuntimeError, match="barrier/never/done"):
        mh.Coordinator(s1, 2, 1, 2).barrier("never")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="1/2 clients joined"):
        mh.open_store(mh.HostConfig(2, 0, "127.0.0.1:%d" % free_port(), 2))
    assert time.monotonic() - t0 < 15
    # one host: no store
    assert mh.init_distributed(mh.HostConfig()) is None


@pytest.mark.parametrize("argv,why", [
    (["--hosts", "2", "--host-id", "0", "--coordinator", "127.0.0.1:1"],
     "requires -o OUTPUT"),
    (["--hosts", "2", "--host-id", "0", "-o", "OUT"], "needs --coordinator"),
    (["--hosts", "2", "--host-id", "2", "--coordinator", "127.0.0.1:1",
      "-o", "OUT"], "a valid --host-id"),
    (["--hosts", "2", "--host-id", "0", "--coordinator", "127.0.0.1:1",
      "--split-prefix", "SP", "-o", "OUT"], "--split-prefix is not supported"),
], ids=["no-output", "no-coordinator", "bad-host-id", "split-prefix"])
def test_cli_refuses_before_the_rendezvous(mt, tmp_path, capsys, argv, why):
    """Each refusal of mm2tpu.cli's validation, in its words: exit 1 before
    any rendezvous, and no output file."""
    orang, reads = mt
    out = tmp_path / "out.paf"
    argv = [str(out) if a == "OUT" else str(tmp_path / "sp") if a == "SP"
            else a for a in argv]
    rc = tcli.main(["-x", "map-ont", "--device", "cpu", *argv, orang,
                    reads[11]])
    assert rc == 1
    assert why in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_cli_refuses_a_multi_part_index(tmp_path):
    """A two-part index: both hosts exit 1 after the rendezvous, and host 0
    removes its output."""
    out = tmp_path / "out.paf"
    procs, errs = spawn_hosts(
        tmp_path, ["-x", "sr", str(GOLDEN / "twopart_MT.mmi"),
                   str(GOLDEN / "sr_reads_1.fq")], 2, out)
    assert [p.wait(timeout=300) for p in procs] == [1, 1]
    for e in errs:
        assert "--hosts with a multi-part index is not supported" in \
            e.read_text()
    assert not out.exists() and not list(tmp_path.glob("*.part"))


# ---- host processes ----


@pytest.mark.parametrize("n_hosts,args,extra,n_reads", [
    (2, ("-x", "map-ont", "-c"), ("--map-mode", "batch"), 30),
    (2, ("-x", "map-ont", "-a"), ("--map-mode", "batch"), 11),
    # mini-batches of ~28 reads (-K 60k): the JAX package's buckets keep
    # the row counts of the other cases (B = 16, 32), whose interpret-mode
    # programs this process has compiled; at the default -K its B = 128
    # bucket costs minutes of compile
    (3, ("-x", "map-ont", "-K", "60k"), ("--map-mode", "batch"), 151),
    (2, ("-x", "map-ont", "-c"), ("--map-mode", "batch", "--mesh", "2"), 16),
    (2, ("-x", "map-ont"), ("--map-mode", "stream", "-t", "2"), 30),
], ids=["paf-c", "sam-a", "three-hosts-151", "mesh2", "stream-t2"])
def test_hosts_merge_equals_single_host_and_jax(mt, tmp_path, n_hosts, args,
                                                extra, n_reads):
    """The merged output of n host processes is byte-identical (SAM: @PG
    aside) to the port's single-host run of the same arguments and to
    mm2tpu --map-mode batch; every host exits 0 and no part file is left.
    With --mesh 2 each host splits its buckets over its own two CPU shards;
    151 reads over 3 hosts leave the stripes uneven."""
    orang, reads = mt
    inputs = (orang, reads[n_reads])
    merged = tmp_path / "merged.out"
    procs, errs = spawn_hosts(tmp_path, [*args, *extra, *inputs], n_hosts,
                              merged)
    rcs = [p.wait(timeout=600) for p in procs]
    assert rcs == [0] * n_hosts, [e.read_text()[-2000:] for e in errs]
    assert not list(tmp_path.glob("*.part"))
    got = no_pg(merged.read_text())
    single = no_pg(port_single([*args, *extra, *inputs],
                               tmp_path / "single.out"))
    want = no_pg(jax_batch((*args, *inputs), str(tmp_path / "jax.out")))
    assert got == single == want
    names = {ln.split("\t", 1)[0] for ln in got.splitlines()
             if not ln.startswith("@")}
    assert len(names) >= 0.9 * n_reads


def test_stopped_peer_fails_every_survivor(mt, tmp_path):
    """One of three hosts stopped (SIGSTOP) right after its spawn: both
    survivors exit non-zero within --host-timeout (plus start-up), and no
    merged output is left behind."""
    orang, reads = mt
    merged = tmp_path / "merged.paf"
    procs, errs = spawn_hosts(tmp_path, ["-x", "map-ont", orang, reads[12]],
                              3, merged, timeout_s=10)
    t0 = time.monotonic()
    try:
        time.sleep(0.5)
        procs[2].send_signal(signal.SIGSTOP)
        rcs = [procs[h].wait(timeout=120) for h in range(2)]
        wall = time.monotonic() - t0
    finally:
        procs[2].kill()
        procs[2].wait(timeout=30)
    assert all(rc != 0 for rc in rcs), [e.read_text()[-1000:] for e in errs]
    assert wall < 10 + 30
    assert "[ERROR] multi-host" in errs[0].read_text()
    assert "[ERROR] multi-host" in errs[1].read_text()
    assert not merged.exists(), "partial merged output left behind"
