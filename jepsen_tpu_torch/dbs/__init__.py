"""Per-database test suites (the port's copy of `jepsen_tpu/dbs/`).

The reference monorepo carries per-DB suites at its top level (etcd,
zookeeper, … — SURVEY.md §2.6 "Per-DB suites"): each wires a DB's
setup/client over the shared workloads.  This package holds ours:
`sqlite`, `regd_suite` with its daemon `regd`, and the in-process
`toyraft`.  `sqlite` is the
suite that runs anywhere (stdlib driver, real ACID engine, real
isolation knobs); suites for networked DBs follow the same shape with
`control`-based DB setup.
"""
