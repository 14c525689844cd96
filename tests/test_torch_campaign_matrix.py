"""Port parity for campaigns end to end: `specs/models-matrix.json` run
through the port's CLI (`python -m jepsen_tpu_torch --cpu campaign
run`) on the CPU, each auto-shrink capped at `ROUNDS` rounds, checked
against the JAX package, and the forensics and gate modules on that
store.

Per run id, the JAX checker's verdict on the stored history (its exact
host twin's) equals the port's record, and the JAX CLI's `shrink` of a
copy of every invalid run gives the port's witness digest, fault
windows and anomaly types; a second `campaign run` executes nothing,
and `status` and `report` exit 0.  `forensics.profile_rows_from_dirs`,
`Index.profile`, `run_diff`, their renderers and `gate.run_gate` are
equal on the store, its ledger given a synthesized slower generation.
"""

import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import cli as jcli  # noqa: E402
from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu.campaign import plan as jplan  # noqa: E402
from jepsen_tpu.campaign.index import Index as JIndex  # noqa: E402
from jepsen_tpu.minimize import probe as jprobe  # noqa: E402
from jepsen_tpu.telemetry import forensics as jfor  # noqa: E402
from jepsen_tpu.telemetry import gate as jgate  # noqa: E402
from jepsen_tpu_torch import __main__ as tmain  # noqa: E402
from jepsen_tpu_torch import cli as tcli  # noqa: E402
from jepsen_tpu_torch.campaign import core as tcc  # noqa: E402
from jepsen_tpu_torch.campaign import plan as tplan  # noqa: E402
from jepsen_tpu_torch.campaign.index import Index as TIndex  # noqa: E402
from jepsen_tpu_torch.minimize import probe as tprobe  # noqa: E402
from jepsen_tpu_torch.telemetry import forensics as tfor  # noqa: E402
from jepsen_tpu_torch.telemetry import gate as tgate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: rounds of each auto-shrink: the shipped spec runs to 1-minimality,
#: which a long-fork cell that comes out invalid reaches only after
#: thousands of probes (60 s on one sandbox core)
ROUNDS = 12


@pytest.fixture(scope="module")
def mm_store(tmp_path_factory):
    """`specs/models-matrix.json` with each auto-shrink capped at
    `ROUNDS` rounds, run through the port's CLI on the CPU."""
    base = str(tmp_path_factory.mktemp("mm"))
    with open(os.path.join(REPO, "specs", "models-matrix.json")) as f:
        spec = json.load(f)
    spec["opts"]["shrink"]["rounds"] = ROUNDS
    path = os.path.join(base, "models-matrix.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    rc = tcli.run(tmain.suite(), ["--cpu", "--store-dir", base, "campaign",
                                  "run", path, "--workers", "2"])
    return base, rc, path


def test_models_matrix_through_the_port_cli(mm_store, capsys):
    base, rc, MM = mm_store
    spec = tplan.load_spec(MM)
    idx = TIndex(tcc.index_path(spec["name"], base))
    specs = jplan.expand(MM)
    assert idx.completed_ids() == {r.run_id for r in specs}
    assert rc == (1 if idx.verdict_counts()["false"] else 0)
    for rec in idx.records:
        assert rec["valid?"] in (True, False)  # no unknown on the CPU
        assert tprobe.device_error(rec) is None
        assert rec.get("device-slot") == 0
    bank_skew = [r for r in idx.records
                 if r["workload"] == "bank-skew" and r["valid?"] is False]
    assert bank_skew and "bank-wrong-total" in \
        bank_skew[0]["witness"]["anomaly-types"]
    assert bank_skew[0]["witness"]["fault-windows"]
    # a second run executes nothing; status and report read the index
    assert tcli.run(tmain.suite(), ["--cpu", "--store-dir", base,
                                    "campaign", "run", MM]) == rc
    assert tcli.run(tmain.suite(), ["--store-dir", base, "campaign",
                                    "status", MM]) == 0
    assert tcli.run(tmain.suite(), ["--store-dir", base, "campaign",
                                    "report", MM]) == 0
    out = capsys.readouterr().out
    assert "0 pending" in out and "campaign models-matrix" in out


def test_models_matrix_verdicts_and_witnesses_equal(mm_store, tmp_path):
    """Per run id: the JAX checker's verdict (its host twin's) on the
    stored history
    equals the port's record, and the JAX CLI's `shrink` of a copy of
    each invalid run gives the port's witness digest, fault windows
    and anomaly types."""
    base, _, MM = mm_store
    idx = TIndex(tcc.index_path("models-matrix", base))
    knobs = tplan.load_spec(MM)["opts"]["shrink"]
    n_invalid = 0
    for rec in idx.records:
        d = os.path.join(base, rec["dir"])
        t = jstore.load(d)
        h = t["history"].materialize()
        chk = jprobe.resolve_checker(t, h)
        # the JAX checker's exact host twin: the same verdict without a
        # compile of the JAX device pipeline for every shape
        res = (jprobe.host_equivalent(chk) or chk).check(t, h, {})
        assert res["valid?"] == rec["valid?"], rec["run"]
        if rec["valid?"] is not False:
            continue
        n_invalid += 1
        copy = str(tmp_path / rec["run"])
        shutil.copytree(d, copy, ignore=shutil.ignore_patterns("witness*"))
        argv = ["shrink", copy, "--probe-deadline",
                str(knobs["probe-deadline"]), "--rounds", str(ROUNDS)]
        if knobs.get("host-oracle"):
            argv.append("--host-oracle")
        assert jcli.run(jcli.single_test_cmd(lambda o: o), argv) == 0
        jw = json.load(open(os.path.join(copy, "witness.json")))
        tw = json.load(open(os.path.join(d, "witness.json")))
        assert rec["witness"]["digest"] == jw["digest"] == tw["digest"]
        for k in ("anomaly-types", "fault-windows", "ops", "source-digest",
                  "phases", "rounds", "checker", "probe-checker"):
            assert tw[k] == jw[k], (rec["run"], k)
    assert n_invalid >= 1


def _two_generations(base):
    """The models-matrix ledger plus a synthesized slower generation."""
    p = tcc.index_path("models-matrix", base)
    idx = TIndex(p)
    gen = idx.records[0]["gen"]
    if any(r.get("gen") == "zslow" for r in idx.records):
        return
    for i, r in enumerate([dict(r) for r in idx.records
                           if r.get("gen") == gen]):
        r.update(run=f"slow-{i}", gen="zslow",
                 spans={k: round(v * 1.6 + 1e-6 * i, 6)
                        for k, v in (r.get("spans") or {}).items()},
                 counters={"compile-cache-miss{site=checker}": 40.0 + i})
        idx.append(r)


def test_forensics_and_gate_equal(mm_store):
    base, _, _ = mm_store
    _two_generations(base)
    p = tcc.index_path("models-matrix", base)
    dirs = [r["dir"] for r in TIndex(p).records if r.get("dir")]
    rows = tfor.profile_rows_from_dirs(base, dirs)
    assert rows == jfor.profile_rows_from_dirs(base, dirs)
    assert TIndex(p).profile() == JIndex(p, use_warehouse=False).profile()
    for kw in ({}, {"spans": ["check:*"]}, {"min_runs": 2}):
        assert tfor.run_diff(base, "models-matrix", **kw) == \
            jfor.run_diff(base, "models-matrix", **kw)
    assert tfor.render_diff(tfor.run_diff(base, "models-matrix")) == \
        jfor.render_diff(jfor.run_diff(base, "models-matrix"))
    assert tfor.render_profile(rows) == jfor.render_profile(rows)
    for span in ("check:bank", "run", "absent"):
        for kw in ({}, {"min_runs": 2}, {"from_gen": "zslow",
                                         "to_gen": "zslow"}):
            r = tgate.run_gate(base, "models-matrix", span, **kw)
            assert r == jgate.run_gate(base, "models-matrix", span, **kw)
            assert tgate.render_gate(r) == jgate.render_gate(r)
