"""Port parity for the standalone Knossos CLI
(`jepsen_tpu_torch/checkers/knossos/cli.py`) and the REPL helpers
(`jepsen_tpu_torch/repl.py`), against the JAX package's on the CPU.

The specs are `tests/test_knossos.py::test_standalone_cli_json` and
`tests/test_aux.py::test_repl_roundtrip`.  The CLI reads a JSON history
or a stored run; with ``--cpu`` its device leg runs on the CPU, and the
exit code and the printed result equal the JAX CLI's (the race's
``algorithm``, which names its winner, aside).  Without ``--cpu`` and
with no card the device leg raises `NoDeviceError`.  `repl.latest`,
`history`, `summary`, `recheck` and `runs` on a stored run equal the JAX
module's on the same store, an Elle re-check of an injected G1c
included.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import repl as jrepl  # noqa: E402
from jepsen_tpu.checkers import api as japi  # noqa: E402
from jepsen_tpu.checkers.knossos import cli as jkcli  # noqa: E402
from jepsen_tpu.checkers.knossos import memo as jmemo  # noqa: E402
from jepsen_tpu.workloads.append import AppendChecker as JAppend  # noqa: E402
from jepsen_tpu_torch import backend, core, repl, store  # noqa: E402
from jepsen_tpu_torch.checkers import api  # noqa: E402
from jepsen_tpu_torch.checkers.knossos import cli as kcli  # noqa: E402
from jepsen_tpu_torch.checkers.knossos import memo as tmemo  # noqa: E402
from jepsen_tpu_torch.generator import core as g  # noqa: E402
from jepsen_tpu_torch.workloads import synth  # noqa: E402
from jepsen_tpu_torch.workloads.append import AppendChecker  # noqa: E402
from jepsen_tpu_torch.workloads.mem import MemClient  # noqa: E402

GOOD = [
    {"type": "invoke", "process": 0, "f": "write", "value": 1},
    {"type": "ok", "process": 0, "f": "write", "value": 1},
    {"type": "invoke", "process": 1, "f": "read", "value": None},
    {"type": "ok", "process": 1, "f": "read", "value": 1},
]
BAD = GOOD[:2] + [
    {"type": "invoke", "process": 1, "f": "read", "value": None},
    {"type": "ok", "process": 1, "f": "read", "value": 7},
]


def _run(main, argv, capsys):
    rc = main(argv)
    res = json.loads(capsys.readouterr().out)
    res.pop("algorithm", None)  # the race's winner varies run to run
    return rc, res


def _both(argv, capsys):
    """(rc, printed result) of the JAX CLI and of the port's with
    ``--cpu``: equal."""
    j = _run(jkcli.main, argv, capsys)
    t = _run(kcli.main, argv + ["--cpu"], capsys)
    assert t == j
    return t


@pytest.mark.parametrize("algorithm", ["auto", "wgl", "linear",
                                       "competition", "device"])
@pytest.mark.parametrize("case", ["good", "bad"])
def test_standalone_cli_json(tmp_path, capsys, case, algorithm):
    p = tmp_path / f"{case}.json"
    p.write_text(json.dumps(GOOD if case == "good" else BAD))
    rc, res = _both([str(p), "--model", "register", "--algorithm",
                     algorithm], capsys)
    assert rc == (0 if case == "good" else 1)
    assert res["valid?"] is (case == "good")


def _pair(p, f, v_in, v_out):
    return [{"type": "invoke", "process": p, "f": f, "value": v_in},
            {"type": "ok", "process": p, "f": f, "value": v_out}]


#: a short valid history of each model's operations
MODEL_HISTORIES = {
    "register": GOOD,
    "cas-register": GOOD + _pair(0, "cas", [1, 2], [1, 2]),
    "mutex": _pair(0, "acquire", None, None) + _pair(0, "release", None,
                                                     None),
    "fifo-queue": _pair(0, "enqueue", 1, 1) + _pair(1, "dequeue", None, 1),
    "unordered-queue": _pair(0, "enqueue", 1, 1) + _pair(1, "dequeue",
                                                         None, 1),
    "set": _pair(0, "add", 1, 1) + _pair(1, "read", None, [1]),
}


@pytest.mark.parametrize("model", sorted(MODEL_HISTORIES))
def test_cli_models_equal(tmp_path, capsys, monkeypatch, model):
    # queue models reach unboundedly many states: memoizing them raises
    # `StateExplosion` either way, sooner under a lower cap (both
    # packages; the default cap's enumeration takes many GiB)
    monkeypatch.setattr(jmemo.memoize, "__defaults__", (500,))
    monkeypatch.setattr(tmemo.memoize, "__defaults__", (500,))
    assert sorted(kcli.MODELS) == sorted(jkcli.MODELS) == \
        sorted(MODEL_HISTORIES)
    assert kcli.ALGORITHMS == jkcli.ALGORITHMS
    p = tmp_path / "h.json"
    p.write_text(json.dumps(MODEL_HISTORIES[model]))
    rc, res = _both([str(p), "--model", model, "--algorithm", "wgl"],
                    capsys)
    assert rc == 0 and res["valid?"] is True


def test_cli_lin_register_history_and_stored_run(tmp_path, capsys):
    """A cas-register history of the synth generator as a JSON file
    (array order as history order) and as a stored run directory."""
    h = synth.lin_register_history(n_ops=200, concurrency=5, seed=3)
    ds = [op.to_dict() for op in h]
    for d in ds:
        d.pop("index", None)
    p = tmp_path / "lin.json"
    p.write_text(json.dumps(ds))
    rc, res = _both([str(p)], capsys)
    assert rc == 0 and res["valid?"] is True
    t = {"name": "lin", "store-dir": str(tmp_path / "s"), "history": h}
    store.save_0(t)
    assert _both([store.test_dir(t)], capsys) == (rc, res)
    bad = tmp_path / "notalist.json"
    bad.write_text("{}")
    for main in (jkcli.main, kcli.main):
        with pytest.raises(SystemExit):
            main([str(bad)])


def test_cli_without_cpu_needs_the_card(tmp_path, monkeypatch):
    """The device leg runs on the CUDA card unless ``--cpu`` is given;
    with no card it raises `NoDeviceError`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "good.json"
    p.write_text(json.dumps(GOOD))
    with pytest.raises(backend.NoDeviceError):
        kcli.main([str(p), "--model", "register", "--algorithm", "device"])


# ---------------------------------------------------------------- repl

def _stats_run(base):
    return core.run({
        "name": "repl-test", "client": MemClient(), "concurrency": 2,
        "nodes": ["n1"], "store-dir": base,
        "generator": g.clients(g.limit(
            4, lambda t, c: {"f": "read", "value": None})),
        "checker": api.Stats(),
    })


def test_repl_roundtrip(tmp_path, capsys):
    base = str(tmp_path / "s")
    _stats_run(base)
    loaded = repl.latest("repl-test", base=base)
    jloaded = jrepl.latest("repl-test", base=base)
    assert loaded["name"] == jloaded["name"] == "repl-test"
    h, jh = repl.history(loaded), jrepl.history(jloaded)
    assert len(h) == len(jh) == 8
    assert [op.to_dict() for op in h] == [op.to_dict() for op in jh]
    assert repl.runs("repl-test", base=base) == \
        jrepl.runs("repl-test", base=base)
    assert len(repl.runs("repl-test", base=base)) == 1
    repl.summary(loaded)
    out = capsys.readouterr().out
    jrepl.summary(jloaded)
    assert capsys.readouterr().out == out
    re = repl.recheck(loaded, api.Stats())
    jre = jrepl.recheck(jloaded, japi.Stats())
    assert re["results"] == jre["results"]
    assert re["results"]["valid?"] is True
    with pytest.raises(FileNotFoundError):
        repl.latest("no-such-test", base=base)
    with pytest.raises(ValueError):
        repl.history({"name": "x"})


def test_repl_recheck_of_an_injected_g1c(tmp_path):
    """`recheck` with the Elle checker of a stored run that holds a G1c:
    the port's dict (on the CPU) equals the JAX checker's."""
    h = synth.la_history(n_txns=80, n_keys=4, concurrency=4, seed=5)
    assert synth.inject_wr_cycle(h)
    base = str(tmp_path / "s")
    store.save_0({"name": "g1c", "store-dir": base, "history": h})
    t = repl.latest("g1c", base=base)
    jt = jrepl.latest("g1c", base=base)
    r = repl.recheck(t, AppendChecker(device="cpu"))["results"]
    jr = jrepl.recheck(jt, JAppend())["results"]
    assert r == jr
    assert r["valid?"] is False and "G1c" in r["anomaly-types"]
