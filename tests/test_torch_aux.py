"""Port parity for the aux modules: role composition
(`jepsen_tpu_torch/role.py`), lazyfs (`lazyfs.py`), libfaketime
(`faketime.py`) and the control host's file cache (`fs_cache.py`).

The spec is the role, lazyfs, faketime and fs_cache tests of
`tests/test_aux.py`, each run here on the port.  Beside them the two
packages run side by side on the same inputs: the commands each sends
to a `SimRemote`, the FAKETIME specs and seeded rates, the role views
and the cache's paths.

lazyfs and libfaketime change a node's mounts and clock, so they run
only against `SimRemote` here, compared by their commands.  The cache
fetches a ``file://`` URL under `tmp_path` into a cache directory there;
no test reaches the network.
"""

import random

import pytest

from jepsen_tpu import control as jcontrol
from jepsen_tpu import db as jdb
from jepsen_tpu import faketime as jfaketime
from jepsen_tpu import fs_cache as jfs_cache
from jepsen_tpu import lazyfs as jlazyfs
from jepsen_tpu import role as jrole
from jepsen_tpu.control.sim import SimRemote as JSimRemote
from jepsen_tpu.nemesis import core as jnem
from jepsen_tpu_torch import control, core, db, faketime, fs_cache, lazyfs
from jepsen_tpu_torch import role
from jepsen_tpu_torch.checkers.api import Stats
from jepsen_tpu_torch.control.sim import SimRemote
from jepsen_tpu_torch.generator import core as g
from jepsen_tpu_torch.nemesis import core as tnem
from jepsen_tpu_torch.workloads.mem import MemClient

JAX = dict(control=jcontrol, db=jdb, faketime=jfaketime,
           fs_cache=jfs_cache, lazyfs=jlazyfs, role=jrole,
           remote=JSimRemote, nem=jnem)
PORT = dict(control=control, db=db, faketime=faketime, fs_cache=fs_cache,
            lazyfs=lazyfs, role=role, remote=SimRemote, nem=tnem)
SIDES = (JAX, PORT)


# ---------------------------------------------------------------- role

def track_db(db_mod, name):
    class TrackDB(db_mod.DB):
        def __init__(self, name):
            self.name = name
            self.calls = []

        def setup(self, test, node):
            self.calls.append(("setup", node, tuple(test["nodes"])))

        def teardown(self, test, node):
            self.calls.append(("teardown", node, tuple(test["nodes"])))

    return TrackDB(name)


def test_role_of_and_nodes():
    t = {"roles": {"shard-a": ["n1", "n2"], "coord": ["n3"]}}
    assert role.role_of(t, "n1") == "shard-a"
    assert role.role_of(t, "n3") == "coord"
    assert role.role_of(t, "nx") is None
    assert role.nodes_of(t, "shard-a") == ["n1", "n2"]


def test_role_db_dispatch(tmp_path):
    shard_db = track_db(db, "shard")
    coord_db = track_db(db, "coord")
    rdb = role.RoleDB({"shard-a": shard_db, "coord": coord_db})
    remote = SimRemote()
    for n in ("n1", "n2", "n3"):
        remote.node(n).respond("*", "")
    t = {
        "name": "role-test", "nodes": ["n1", "n2", "n3"],
        "roles": {"shard-a": ["n1", "n2"], "coord": ["n3"]},
        "remote": remote, "db": rdb, "client": MemClient(),
        "concurrency": 2, "store-dir": str(tmp_path / "s"),
        "generator": g.clients(g.limit(
            4, lambda t, c: {"f": "read", "value": None})),
        "checker": Stats(),
    }
    done = core.run(t)
    assert done["results"]["valid?"] is True
    # each role db saw only its own nodes, with a restricted node view
    assert {c[1] for c in shard_db.calls} == {"n1", "n2"}
    assert all(c[2] == ("n1", "n2") for c in shard_db.calls)
    assert {c[1] for c in coord_db.calls} == {"n3"}
    assert all(c[2] == ("n3",) for c in coord_db.calls)


def test_role_nemesis_scoped():
    seen = {}

    class Grab(tnem.Nemesis):
        def invoke(self, test, op):
            seen["nodes"] = list(test["nodes"])
            return dict(op, type="info")

    rn = role.RoleNemesis("coord", Grab())
    t = {"nodes": ["n1", "n2", "n3"],
         "roles": {"shard-a": ["n1", "n2"], "coord": ["n3"]}}
    rn = rn.setup(t)
    rn.invoke(t, {"f": "kill", "type": "invoke"})
    assert seen["nodes"] == ["n3"]


ROLES = {"shard-a": ["n1", "n2"], "shard-b": ["n4"], "coord": ["n3"]}


def test_role_views_equal_to_jax():
    """`roles`, `role_of`, `nodes_of`, `restrict_test`, `RoleDB`'s
    dispatch, primaries and log files, a scoped nemesis and a restricted
    client's node mapping: the same on both packages."""
    out = []
    for side in SIDES:
        r, d = side["role"], side["db"]

        class Prim(d.DB, d.Primary, d.LogFiles):
            def __init__(self):
                self.calls = []

            def setup(self, test, node):
                self.calls.append(("setup", node, tuple(test["nodes"])))

            def teardown(self, test, node):
                self.calls.append(("teardown", node, tuple(test["nodes"])))

            def primaries(self, test):
                return list(test["nodes"][:1])

            def setup_primary(self, test, node):
                self.calls.append(("primary", node))

            def log_files(self, test, node):
                return [f"/var/log/{node}.log"]

        class Grab(side["nem"].Nemesis):
            def invoke(self, test, op):
                return dict(op, type="info", value=list(test["nodes"]))

        class Opened:
            def __init__(self, node=None):
                self.node = node

            def open(self, test, node):
                return Opened(node)

            def invoke(self, test, op):
                return dict(op, type="ok", value=(self.node,
                                                  tuple(test["nodes"])))

        t = {"nodes": ["n1", "n2", "n3", "n4", "n5"],
             "roles": r.roles(ROLES)}
        dbs = {"shard-a": Prim(), "coord": track_db(d, "coord")}
        rdb = r.RoleDB(dbs)
        for n in t["nodes"]:
            rdb.setup(t, n)
            rdb.setup_primary(t, n)
        seen = [[r.role_of(t, n) for n in t["nodes"] + ["nx"]],
                [r.nodes_of(t, x) for x in list(ROLES) + ["none"]],
                r.restrict_test(t, "shard-a")["nodes"],
                rdb.primaries(t),
                [rdb.log_files(t, n) for n in t["nodes"]],
                dbs["shard-a"].calls, dbs["coord"].calls]
        nem = r.RoleNemesis("shard-a", Grab()).setup(t)
        seen.append(nem.invoke(t, {"f": "kill", "type": "invoke"}))
        client = r.restrict_client("shard-a", Opened())
        seen.append([client.open(t, n).invoke(t, {"f": "read"})["value"]
                     for n in t["nodes"] + ["nx"]])
        for n in t["nodes"]:
            rdb.teardown(t, n)
        seen.append(dbs["shard-a"].calls[-2:])
        out.append(seen)
    assert out[0] == out[1]


# ---------------------------------------------------------------- lazyfs

def test_lazyfs_mount_commands():
    remote = SimRemote()
    node = remote.node("n1")
    node.respond("*", "")
    fs = lazyfs.LazyFS(dir="/var/lib/db")
    assert fs.data_dir == "/var/lib/db.data"
    assert fs.fifo == "/var/lib/db.fifo"
    with control.with_session("n1", remote.connect("n1")):
        lazyfs.mount(fs)
        lazyfs.lose_unfsynced_writes(fs)
        lazyfs.checkpoint(fs)
        lazyfs.umount(fs)
    cmds = node.cmds()
    assert any("lazyfs" in c and "/var/lib/db" in c for c in cmds)
    assert any("clear-cache" in c for c in cmds)
    assert any("cache-checkpoint" in c for c in cmds)
    assert any("fusermount" in c for c in cmds)


def test_lazyfs_db_wrapper_forwards_facets():
    inner = track_db(db, "inner")
    wrapped = lazyfs.DB(inner, lazyfs.LazyFS(dir="/d"))
    assert wrapped.name == "inner"  # __getattr__ forwarding


@pytest.mark.parametrize("installed", [True, False])
def test_lazyfs_commands_equal_to_jax(installed):
    """`install` (lazyfs built or not), `mount`, the two FIFO faults, a
    failing `umount`, and the DB wrapper's setup and teardown: the same
    commands on both packages' `SimRemote`, and the same config."""
    out = []
    for side in SIDES:
        lz, c = side["lazyfs"], side["control"]
        remote = side["remote"]()
        node = remote.node("n1")
        if not installed:
            node.respond("test -e *", lambda a: c.CmdResult(
                cmd=a.wrapped_cmd(), out="", err="", exit_status=1))
        node.respond("fusermount*", lambda a: c.CmdResult(
            cmd=a.wrapped_cmd(), out="", err="busy", exit_status=1))
        fs = lz.LazyFS(dir="/var/lib/my db", fifo="/run/f.fifo")
        inner = track_db(side["db"], "inner")
        wrapped = lz.DB(inner, fs)
        with c.with_session("n1", remote.connect("n1")):
            lz.install()
            lz.mount(fs)
            lz.lose_unfsynced_writes(fs)
            lz.checkpoint(fs)
            lz.umount(fs)
            wrapped.setup({"nodes": ["n1"]}, "n1")
            wrapped.teardown({"nodes": ["n1"]}, "n1")
        out.append((node.cmds(), lz.config_toml(fs), inner.calls,
                    (fs.dir, fs.data_dir, fs.fifo, fs.config)))
    assert out[0] == out[1]
    assert any("git clone" in cmd for cmd in out[1][0]) is not installed


# ---------------------------------------------------------------- faketime

def test_faketime_spec_and_wrap():
    assert faketime.faketime_spec(5, 2.0) == "+5s x2"
    assert faketime.faketime_spec(-3.5, 0.5) == "-3.5s x0.5"
    remote = SimRemote()
    node = remote.node("n1")
    node.respond("test -e /usr/lib/x86_64-linux-gnu/faketime/*", "")
    node.respond("*", "")
    with control.with_session("n1", remote.connect("n1")):
        cmd = faketime.wrap_cmd(["etcd", "--flag"], offset_s=10, rate=5)
    joined = control.core.join_cmd(cmd)
    assert "LD_PRELOAD=" in joined and "FAKETIME=" in joined
    assert joined.endswith("etcd --flag")


def test_faketime_rand_factor_bounds():
    for _ in range(50):
        f = faketime.rand_factor(random.Random(), max_skew=5.0)
        assert 1 / 5.0 <= f <= 5.0


@pytest.mark.parametrize("seed", range(10))
def test_faketime_spec_and_rand_factor_equal_to_jax(seed):
    """From one seed, `rand_factor` at three skews and `faketime_spec` of
    seeded offsets and rates give the same numbers and strings."""
    out = []
    for side in SIDES:
        ft = side["faketime"]
        rng = random.Random(seed)
        seen = []
        for max_skew in (1.5, 5.0, 100.0):
            rate = ft.rand_factor(rng, max_skew=max_skew)
            offset = round(rng.uniform(-60.0, 60.0), 3)
            seen.append((rate, offset, ft.faketime_spec(offset, rate),
                         ft.faketime_spec(int(offset)),
                         ft.faketime_spec(offset, round(rate, 4))))
        out.append(seen)
    assert out[0] == out[1]


@pytest.mark.parametrize("so", [0, 1, 2, None])
def test_faketime_commands_equal_to_jax(so):
    """`libfaketime_path` probing each of `SO_PATHS` (or none), `install`,
    and `wrap_cmd`'s argv (or its error): the same on both packages'
    `SimRemote`."""
    assert faketime.SO_PATHS == jfaketime.SO_PATHS
    out = []
    for side in SIDES:
        ft, c = side["faketime"], side["control"]
        remote = side["remote"]()
        node = remote.node("n1")
        for i, path in enumerate(ft.SO_PATHS):
            if i != so:
                node.respond(f"test -e {path}", lambda a: c.CmdResult(
                    cmd=a.wrapped_cmd(), out="", err="", exit_status=1))
        with c.with_session("n1", remote.connect("n1")):
            ft.install()
            try:
                wrapped = c.join_cmd(ft.wrap_cmd(["etcd", "--data dir"],
                                                 offset_s=-2.5, rate=0.25))
            except RuntimeError as e:
                wrapped = str(e)
        out.append((node.cmds(), wrapped))
    assert out[0] == out[1]
    assert ("apt-get" in " ".join(out[1][0])) is (so is None)


# ---------------------------------------------------------------- fs_cache

def test_fs_cache_save_and_deploy(tmp_path, monkeypatch):
    monkeypatch.setattr(fs_cache, "CACHE_DIR", str(tmp_path / "cache"))
    src = tmp_path / "artifact.tar"
    src.write_bytes(b"dbdata")
    p = fs_cache.save("etcd-v3.5", str(src))
    assert fs_cache.cached("etcd-v3.5") == p
    assert fs_cache.cached("nope") is None

    remote = SimRemote()
    node = remote.node("n1")
    node.respond("*", "")
    with control.with_session("n1", remote.connect("n1")):
        fs_cache.deploy_remote("etcd-v3.5", "/opt/db/etcd.tar", mode="755")
    cmds = node.cmds()
    assert any("mkdir" in c for c in cmds)
    assert any("chmod 755" in c for c in cmds)
    assert ("/opt/db/etcd.tar", p) in [(d, s) for (s, d) in node.uploads] \
        or node.uploads  # upload recorded


def test_fs_cache_deploy_uncached_raises():
    with pytest.raises(FileNotFoundError):
        fs_cache.deploy_remote("never-cached", "/tmp/x")


def test_fs_cache_equal_to_jax(tmp_path, monkeypatch):
    """With both caches in one directory under `tmp_path`: the same key
    paths, `save` and `cached`, `fetch` of a ``file://`` URL (once, then
    from the cache, then forced), `deploy_remote` of a key and of that
    URL (the same commands and uploads), and the same errors."""
    cache = tmp_path / "cache"
    src = tmp_path / "release v1.tar"
    src.write_bytes(b"v1")
    url = src.as_uri()
    out = []
    for side in SIDES:
        fc, c = side["fs_cache"], side["control"]
        monkeypatch.setattr(fc, "CACHE_DIR", str(cache))
        if cache.exists():
            for f in cache.iterdir():
                f.unlink()
        seen = [fc._key_path(k) for k in ("etcd-v3.5", url, "a/b c?d")]
        seen.append(fc.save("etcd-v3.5", str(src)))
        seen.append(fc.cached("etcd-v3.5"))
        seen.append(fc.cached(url))
        got = fc.fetch(url)
        src.write_bytes(b"v2")
        seen += [got, fc.fetch(url), open(got, "rb").read()]
        seen.append(open(fc.fetch(url, force=True), "rb").read())
        src.write_bytes(b"v1")
        remote = side["remote"]()
        node = remote.node("n1")
        with c.with_session("n1", remote.connect("n1")):
            fc.deploy_remote("etcd-v3.5", "/opt/db/etcd.tar", mode="755")
            fc.deploy_remote(url, "etcd.tar")
            with pytest.raises(FileNotFoundError) as e:
                fc.deploy_remote("never-cached", "/tmp/x")
        seen += [node.cmds(), node.uploads, str(e.value),
                 sorted(f.name for f in cache.iterdir())]
        out.append(seen)
    assert out[0] == out[1]
    assert out[1][8] == b"v1" and out[1][9] == b"v2"
