"""Port parity for the CLI (`jepsen_tpu_torch/cli.py`, `__main__.py`) and
the run's fault plans (`resilience/faults.py`: `parse_spec`,
`seeded_for`, `FaultPlan.from_spec`, `fire_at`, `targets_site`,
`plan_for` and ``JEPSEN_FAULTS``).

Tolerances: the parsed options, test maps, plans and every fire
decision are equal to the JAX package's, the keys of ``--telemetry`` and
``--profile-dir`` included.  `python -m jepsen_tpu_torch --cpu ... test-all`
and `analyze DIR` exit 0 in a subprocess; the same ``test-all`` runs
the queue and kafka demos, whose stored runs `analyze` checks again.
"""

import logging
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from jepsen_tpu import cli as jcli  # noqa: E402
from jepsen_tpu.resilience import faults as jfaults  # noqa: E402
from jepsen_tpu_torch import cli as tcli  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch.__main__ import DEMOS, demo_checker, suite  # noqa: E402
from jepsen_tpu_torch.resilience import faults as tfaults  # noqa: E402
from jepsen_tpu_torch.workloads import append as tappend  # noqa: E402
from jepsen_tpu_torch.workloads import wr as twr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = [
    ["test"],
    ["test", "-n", "a,b", "-n", "c", "-c", "2n"],
    ["--store-dir", "x", "test", "--time-limit", "5", "--ops", "10",
     "--test-count", "2", "--leave-db-running"],
    ["--cpu", "test", "--nodes-file", "{nodes}", "-c", "7",
     "--checker-time-limit", "3"],
    ["test", "--username", "u", "--password", "p", "--private-key-path",
     "k", "--logging-json", "-n", "n1"],
    ["test", "--telemetry", "--profile-dir", "prof", "-n", "n1"],
]


@pytest.mark.parametrize("i", range(len(ARGVS)))
def test_opts_to_test_map_equal_to_jax(tmp_path, i):
    nodes = tmp_path / "nodes.txt"
    nodes.write_text("n4\nn5\n\n")
    argv = [a.format(nodes=nodes) for a in ARGVS[i]]
    fn = (lambda opts: opts)
    (jp, _), (tp, _) = jcli.single_test_cmd(fn), tcli.single_test_cmd(fn)
    jo, to = jp.parse_args(argv), tp.parse_args(argv)
    assert tcli.opts_to_test_map(to) == jcli.opts_to_test_map(jo)
    assert tcli.parse_nodes(to.nodes, to.nodes_file) == \
        jcli.parse_nodes(jo.nodes, jo.nodes_file)


def test_parse_concurrency_equal_to_jax():
    for spec, n in (("30", 5), ("10n", 5), ("3n", 0), (" 4n ", 2), ("1", 9)):
        assert tcli.parse_concurrency(spec, n) == \
            jcli.parse_concurrency(spec, n)
    for bad in ("x2", "n", "2x", ""):
        with pytest.raises(ValueError):
            jcli.parse_concurrency(bad, 3)
        with pytest.raises(ValueError):
            tcli.parse_concurrency(bad, 3)


def test_subcommands_and_demo_checkers(tmp_path, capsys):
    p, _ = tcli.test_all_cmd(DEMOS)
    sub = next(a for a in p._actions if a.dest == "cmd")
    assert sorted(sub.choices) == ["analyze", "tail", "test", "test-all",
                                   "trace"]
    rc = tcli.run(tcli.test_all_cmd(DEMOS), ["test-all", "--only", "nope"])
    assert rc == 2 and "nope" in capsys.readouterr().err
    assert tcli.run(tcli.test_all_cmd(DEMOS), ["test"]) == 2
    chk = demo_checker("demo-append", cpu=True)
    assert isinstance(chk, tappend.AppendChecker) and chk.device == "cpu"
    chk = demo_checker("demo-wr")
    assert isinstance(chk, twr.WrChecker) and chk.device is None
    with pytest.raises(ValueError, match="demo-append"):
        demo_checker("other")
    rc = tcli.run(suite(), ["analyze", str(tmp_path / "missing")])
    assert rc == 2


def test_json_formatter_equal_to_jax():
    rec = logging.LogRecord("jepsen.x", logging.INFO, __file__, 1,
                            'say "%s"\n', ("hi",), None)
    assert tcli._JsonFormatter().format(rec) == \
        jcli._JsonFormatter().format(rec)


def _main(*args, cwd):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "jepsen_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_python_m_test_all_then_analyze_on_the_cpu(tmp_path, capsys):
    base = str(tmp_path / "store")
    res = _main("--cpu", "--store-dir", base, "test-all", "--only", "append",
                "--only", "queue", "--only", "kafka", "--ops", "500",
                cwd=str(tmp_path))
    assert res.returncode == 0, res.stdout + res.stderr
    for name in ("append", "queue", "kafka"):
        assert f"demo-{name} valid? = True" in res.stdout
    d = tstore.latest("demo-append", base=base)
    stored = tstore.load(d)
    assert stored["results"]["valid?"] is True
    assert len(stored["history"]) == 1000
    res = _main("--cpu", "analyze", d, cwd=str(tmp_path))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "re-analysis: valid? = True" in res.stdout
    assert tstore.load(d)["results"] == stored["results"]
    # the queue and kafka runs of the same command, analysed in process
    # by the suite `python -m jepsen_tpu_torch` runs
    for name, checker in (("queue", "total-queue"), ("kafka", "kafka")):
        d = tstore.latest(f"demo-{name}", base=base)
        stored = tstore.load(d)
        assert stored["results"]["valid?"] is True
        assert demo_checker(stored["name"], cpu=True).name() == checker
        assert tcli.run(suite(), ["--cpu", "analyze", d]) == 0
        assert "re-analysis: valid? = True" in capsys.readouterr().out
        assert tstore.load(d)["results"] == stored["results"]


# -- fault plans -------------------------------------------------------------

SPECS = [
    "seed=7,p=0.3,kinds=oom|xla",
    {"p": 0.5, "sites": ["interpreter", "elle.infer"], "seed": 3},
    {"at": {1: "xla", 3: "oom"}},
    "persistent=all",
    {"persistent": ["elle.infer"], "kinds": ["device-lost"]},
    "max_faults=2,p=1",
    " seed=1 , p=0.2 ,",
]
SITES = ("elle.infer", "elle.cycle-sweep", "interpreter")


def _attrs(plan):
    return (plan.seed, plan.p, plan.kinds, plan.at, plan.persistent,
            plan.max_faults, plan.stall_s, plan.sites)


def _decisions(mod, plan):
    out = []
    for i in range(40):
        site = SITES[i % 3]
        for fire in (lambda: plan.fire(site),
                     lambda: plan.fire_at(site, 1_000_003 * (i % 4) + i)):
            try:
                fire()
                out.append(None)
            except mod.FaultInjected as e:
                out.append((e.kind, str(e), e.transient))
    return out, plan.injected, [plan.targets_site(s) for s in SITES]


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_fault_plans_and_decisions_equal_to_jax(spec):
    assert tfaults.parse_spec(spec) == jfaults.parse_spec(spec)
    for salt in (0, 5):
        assert tfaults.seeded_for(spec, salt) == \
            jfaults.seeded_for(spec, salt)
    jp, tp = jfaults.FaultPlan.from_spec(spec), \
        tfaults.FaultPlan.from_spec(spec)
    assert _attrs(tp) == _attrs(jp)
    assert _decisions(tfaults, tp) == _decisions(jfaults, jp)


def test_plan_for_equal_to_jax(monkeypatch):
    for mod in (jfaults, tfaults):
        assert mod.parse_spec("") is None and mod.FaultPlan.from_spec(
            None) is None
        with pytest.raises(ValueError, match="JEPSEN_FAULTS"):
            mod.parse_spec("p")
    # the test map's spec, cached on the map
    for mod in (jfaults, tfaults):
        t = {"faults": "seed=2,p=0.5"}
        plan = mod.plan_for(t)
        assert plan is mod.plan_for(t) is t["faults-plan"]
        assert mod.plan_for({"faults": plan}) is plan
        # the nemesis vocabulary is not a resilience spec
        assert mod.plan_for({"faults": {"partition", "kill"}}) is None
        assert mod.plan_for(None) is None
    # JEPSEN_FAULTS, under an installed plan
    monkeypatch.setenv("JEPSEN_FAULTS", "seed=9,p=0.25,kinds=xla")
    jenv, tenv = jfaults.plan_for({}), tfaults.plan_for({})
    assert _attrs(tenv) == _attrs(jenv)
    assert tfaults.plan_for({}) is tenv
    assert _decisions(tfaults, tenv) == _decisions(jfaults, jenv)
    installed = tfaults.FaultPlan(p=1.0)
    with tfaults.use(installed):
        assert tfaults.plan_for({}) is installed
    # only plan_for reads the variable: a checker called directly injects
    # only what its caller gave or installed
    assert tfaults.active_plan() is None
