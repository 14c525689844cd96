"""Kafka-style partitioned-log workload (the port's copy of the host
parts of `jepsen_tpu/workloads/kafka.py`).

Equivalent of the reference's `jepsen/src/jepsen/tests/kafka.clj`
(SURVEY.md §2.6): clients send uniquely-valued messages to partitioned
topics ("keys") and poll them back; a consumer's assignment changes over
time via ``assign``/``subscribe`` ops, with consumer-group rebalancing.
Op shapes mirror the reference:

- ``{"f": "send", "value": [("send", k, v)]}`` — completed sends get
  ``("send", k, (offset, v))``;
- ``{"f": "poll", "value": [("poll", None)]}`` — completed polls get
  ``("poll", {k: [(offset, v), ...]})`` for the assigned keys;
- ``{"f": "txn", "value": [mops...]}`` — transactional mix of send and
  poll mops, completed the same way;
- ``{"f": "assign", "value": [k, ...]}`` — self-managed assignment
  (real consumers seek to the last committed position per key);
- ``{"f": "subscribe", "value": [k, ...]}`` — group-managed
  subscription; the broker rebalances partitions round-robin across the
  group's members, and polls resume from the group's committed offsets;
- ``{"f": "crash", ...}`` — client crashes (:info), leaves the group,
  forcing a rebalance.

The checker covers the reference's anomaly taxonomy:

- **lost-write**: a committed send whose offset is below some polled
  offset for that key, yet never polled by anyone;
- **duplicate**: one value at two different offsets of a key;
- **inconsistent-offsets**: two different values observed at one offset;
- **nonmonotonic-poll**: a process's successive polls of a key going
  backwards in offset *without an intervening (re)assignment* — real
  consumers seek back to the committed offset on assign/subscribe, so
  re-delivery across a reassignment is legal (reference behavior);
- **poll-skip**: successive polls of a key by one process jumping over
  offsets that exist, without an intervening reassignment;
- **int-nonmonotonic-poll** / **int-poll-skip**: the same inside a
  single poll batch (never legal);
- **nonmonotonic-send**: one process's acked sends to a key going
  backwards in offset;
- **int-send-skip**: two sends to a key inside one txn landing at
  non-consecutive offsets (another producer interleaved mid-txn);
- **precommitted-read**: a poll observed a value before the send that
  wrote it completed (read-uncommitted behavior);
- **unseen**: committed values never polled by anyone (informational —
  reported but not by itself invalid, matching the reference's
  treatment when final polls may simply not have caught up).

Ported: the generator (`_KafkaGen`, `gen`), the simulated broker
(`KafkaStore`) and client (`KafkaClient`, with every probability knob),
the one-pass fact extraction the packed checker shares (`_observations`)
and the scan twin (`KafkaChecker`).  With the same seeds and knobs the
simulator writes the same history as the JAX one.  Left out: the
`FaultPlan` branch of `KafkaClient._adversary` and its ``client.*``
sites (`faults.plan_for` waits for the port's CLI and fault wiring), so
only the probability knobs fire; the telemetry counter of each
injection; and `final_gen` / `workload()`, which need the generator
framework.
"""

from __future__ import annotations

import itertools
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from jepsen_tpu_torch.checkers import api as checker_api
from jepsen_tpu_torch.client import Client
from jepsen_tpu_torch.history.ops import INFO, INVOKE, OK

#: minimum same-start subscribe-mode batches before a frozen committed
#: offset counts as stale (pinned equal to
#: `checkers.queue.kafka.STALE_MIN_POLLS` by tests so the scan twin and
#: the packed passes can't drift)
STALE_MIN_POLLS = 3


# ---------------------------------------------------------------------------
# Generator


class _KafkaGen:
    """send/poll mix with assign/subscribe churn and optional txns
    (reference kafka gen shape)."""

    def __init__(self, *, key_count: int = 4, poll_frac: float = 0.4,
                 assign_frac: float = 0.1, subscribe_frac: float = 0.0,
                 crash_frac: float = 0.0, txn_frac: float = 0.0,
                 max_txn_mops: int = 4,
                 rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self.key_count = key_count
        self.poll_frac = poll_frac
        self.assign_frac = assign_frac
        self.subscribe_frac = subscribe_frac
        self.crash_frac = crash_frac
        self.txn_frac = txn_frac
        self.max_txn_mops = max_txn_mops
        self.counter = itertools.count()

    def _keys_sample(self):
        n = self.rng.randint(1, self.key_count)
        return sorted(self.rng.sample(range(self.key_count), n))

    def _send_mop(self):
        k = self.rng.randrange(self.key_count)
        return ("send", k, next(self.counter))

    def __call__(self, test, ctx):
        r = self.rng.random()
        if r < self.crash_frac:
            return {"f": "crash", "value": None}
        r = self.rng.random()
        if r < self.assign_frac:
            return {"f": "assign", "value": self._keys_sample()}
        r2 = self.rng.random()
        if r2 < self.subscribe_frac:
            return {"f": "subscribe", "value": self._keys_sample()}
        r3 = self.rng.random()
        if r3 < self.txn_frac:
            mops = [self._send_mop() if self.rng.random() < 0.6
                    else ("poll", None)
                    for _ in range(self.rng.randint(2, self.max_txn_mops))]
            return {"f": "txn", "value": mops}
        if r < self.assign_frac + self.poll_frac:
            return {"f": "poll", "value": [("poll", None)]}
        return {"f": "send", "value": [self._send_mop()]}


def gen(**opts) -> Any:
    return _KafkaGen(**opts)


# ---------------------------------------------------------------------------
# In-memory kafka-ish broker + client (the sim-cluster db)


#: broker-side tombstone for torn writes: the offset exists, the
#: payload is gone (never returned by read_from)
_TOMB = object()


class KafkaStore:
    """Partitioned append-only logs + one consumer group with round-robin
    rebalancing and per-group committed offsets."""

    def __init__(self):
        self.lock = threading.Lock()
        self.logs: Dict[Any, List[Any]] = {}
        self.subs: Dict[int, List[Any]] = {}      # member -> subscribed keys
        self.assign: Dict[int, List[Any]] = {}    # member -> assigned keys
        self.committed: Dict[Any, int] = {}       # key -> committed offset
        self.generation = 0                        # bumped per rebalance
        self._member_ids = itertools.count()
        # fault knob: auto-commits stop advancing — subscribe-mode
        # consumers re-read the same window while the log moves on (the
        # stale-consumer-group shape)
        self.freeze_commits = False

    def new_member(self) -> int:
        return next(self._member_ids)

    def append(self, k, v) -> int:
        log = self.logs.setdefault(k, [])
        log.append(v)
        return len(log) - 1

    def append_lost(self, k) -> int:
        """A torn write: the broker allocates (and acks) the offset but
        the payload never lands — consumers skip the hole, so the acked
        offset sits below later polled offsets without ever being
        polled: the checker's **lost-write** shape."""
        log = self.logs.setdefault(k, [])
        log.append(_TOMB)
        return len(log) - 1

    def read_from(self, k, pos: int, limit: int) -> List[Tuple[int, Any]]:
        log = self.logs.get(k, [])
        return [(i, log[i]) for i in range(pos, min(len(log), pos + limit))
                if log[i] is not _TOMB]

    # -- consumer group (caller holds the lock) --

    def rebalance(self) -> None:
        """Round-robin partition assignment over subscribing members."""
        self.generation += 1
        members = sorted(self.subs)
        self.assign = {m: [] for m in members}
        all_keys = sorted({k for keys in self.subs.values() for k in keys})
        for i, k in enumerate(all_keys):
            owners = [m for m in members if k in self.subs[m]]
            if owners:
                self.assign[owners[i % len(owners)]].append(k)

    def subscribe(self, member: int, keys: Sequence[Any]) -> None:
        self.subs[member] = list(keys)
        self.rebalance()

    def leave(self, member: int) -> None:
        # no-op for non-members: a crash of an assign-mode client moves no
        # partitions, and bumping the generation would reset subscribe-mode
        # checkers' epochs, masking real anomalies
        if member in self.subs:
            self.subs.pop(member)
            self.rebalance()


class KafkaClient(Client):
    """One consumer/producer per process (reference kafka client shape).

    Two consumption modes, as in real Kafka: ``assign`` (self-managed
    positions, seeking to the group's committed offset on assignment) and
    ``subscribe`` (group-managed: the broker rebalances partitions and
    polls resume from committed offsets; positions auto-commit).

    Fault knobs for checker tests: `lose_tail_p` — on send, the broker
    "acks" but drops the message (a lost write); `dup_p` — the append is
    applied twice (a duplicate).

    Adversarial-client shapes — the behaviors real message
    systems break under, each producing an anomaly the matching packed
    checker pass attributes.  Triggered by the probability knobs (seeded
    corpora); the JAX client can also fire them from a seeded `FaultPlan`
    naming ``client.*`` sites, which the port leaves out:

    - `dup_send_p` — the duplicate-request retry: every send mop of the
      op is applied twice (**duplicate**);
    - `reorder_p` — the broker applies one op's sends in reverse arrival
      order; completions still report each mop's true landing offset
      (**int-send-skip** / **nonmonotonic-send**);
    - `zombie_p` — a zombie retry re-appends the client's last ACKED
      message after the fact, invisibly to its own history
      (**duplicate** at a later offset);
    - `torn_p` — a multi-key send is torn: only
      the first key's sends reach the log, the rest are acked with
      fabricated offsets (**lost-write** / **inconsistent-offsets**).
    """

    def __init__(self, store: Optional[KafkaStore] = None, *,
                 poll_limit: int = 8, lose_tail_p: float = 0.0,
                 dup_p: float = 0.0, dup_send_p: float = 0.0,
                 reorder_p: float = 0.0, zombie_p: float = 0.0,
                 torn_p: float = 0.0,
                 rng: Optional[random.Random] = None):
        self.store = store or KafkaStore()
        self.poll_limit = poll_limit
        self.lose_tail_p = lose_tail_p
        self.dup_p = dup_p
        self.dup_send_p = dup_send_p
        self.reorder_p = reorder_p
        self.zombie_p = zombie_p
        self.torn_p = torn_p
        self.rng = rng or random.Random(0)
        self.member = -1
        self.mode = "assign"
        self.assigned: List[Any] = []
        self.pos: Dict[Any, int] = {}
        self._acked: Optional[Tuple[Any, Any]] = None

    def open(self, test, node):
        c = KafkaClient(self.store, poll_limit=self.poll_limit,
                        lose_tail_p=self.lose_tail_p, dup_p=self.dup_p,
                        dup_send_p=self.dup_send_p,
                        reorder_p=self.reorder_p, zombie_p=self.zombie_p,
                        torn_p=self.torn_p, rng=self.rng)
        c.member = self.store.new_member()
        return c

    # -- adversarial shapes --

    def _adversary(self) -> set:
        """Which adversarial shapes apply to THIS op: the probability
        knobs, drawn in the JAX order."""
        shapes = set()
        for p, shape in ((self.dup_send_p, "dup-send"),
                         (self.reorder_p, "reorder-send"),
                         (self.zombie_p, "zombie-resend"),
                         (self.torn_p, "torn-send")):
            if p and self.rng.random() < p:
                shapes.add(shape)
        return shapes

    # -- mop handlers (store lock held) --

    def _do_send(self, mop, dup: bool = False):
        s = self.store
        _kind, k, v = mop
        if self.lose_tail_p and self.rng.random() < self.lose_tail_p:
            # broker acks but drops: offset it claims is bogus
            return ("send", k, (len(s.logs.get(k, [])), v))
        off = s.append(k, v)
        self._acked = (k, v)
        if dup or (self.dup_p and self.rng.random() < self.dup_p):
            s.append(k, v)  # duplicated append
        return ("send", k, (off, v))

    def _do_mops(self, mops, shapes: set):
        """Apply an op's send/poll mops with the adversarial shapes."""
        s = self.store
        mops = list(mops)
        send_idx = [n for n, m in enumerate(mops) if m[0] == "send"]
        apply_order = list(range(len(mops)))
        if "reorder-send" in shapes and len(send_idx) >= 2:
            # reverse arrival order for this op's sends; each mop slot
            # still reports the offset its value actually landed at
            rev = dict(zip(send_idx, reversed(send_idx)))
            apply_order = [rev.get(n, n) for n in apply_order]
        torn_keys: set = set()
        if "torn-send" in shapes:
            keys: List[Any] = []
            for n in send_idx:
                if mops[n][1] not in keys:
                    keys.append(mops[n][1])
            if len(keys) >= 2:
                torn_keys = set(keys[1:])
        dup = "dup-send" in shapes
        out: List[Any] = [None] * len(mops)
        for n in apply_order:
            m = mops[n]
            if m[0] != "send":
                out[n] = self._do_poll()
            elif m[1] in torn_keys:
                # torn: the broker allocates and acks the offset but
                # the payload is lost
                out[n] = ("send", m[1], (s.append_lost(m[1]), m[2]))
            else:
                out[n] = self._do_send(m, dup=dup)
        if "zombie-resend" in shapes and self._acked is not None:
            # a zombie retry of the last acked send, invisible to this
            # client's own completions
            s.append(*self._acked)
        return out

    def _do_poll(self):
        s = self.store
        if self.mode == "subscribe":
            self.assigned = list(s.assign.get(self.member, []))
        batch: Dict[Any, List[Tuple[int, Any]]] = {}
        for k in self.assigned:
            if self.mode == "subscribe":
                pos = s.committed.get(k, 0)
            else:
                pos = self.pos.get(k, 0)
            msgs = s.read_from(k, pos, self.poll_limit)
            if msgs:
                nxt = msgs[-1][0] + 1
                self.pos[k] = nxt
                if self.mode == "subscribe" and not s.freeze_commits:
                    s.committed[k] = nxt      # auto-commit
            batch[k] = msgs
        return ("poll", batch)

    def invoke(self, test, op):
        f = op["f"]
        s = self.store
        with s.lock:
            if f == "send":
                out = self._do_mops(op["value"], self._adversary())
                return dict(op, type="ok", value=out)
            if f == "poll":
                done = dict(op, type="ok", value=[self._do_poll()])
                if self.mode == "subscribe":
                    # consumers learn of rebalances via their listener; the
                    # checker uses this to bound cross-poll comparisons to
                    # one assignment epoch (reference: :rebalance log ops)
                    done["rebalance"] = s.generation
                return done
            if f == "txn":
                out = self._do_mops(op["value"], self._adversary())
                done = dict(op, type="ok", value=out)
                if self.mode == "subscribe":
                    done["rebalance"] = s.generation
                return done
            if f == "assign":
                if self.mode == "subscribe":
                    s.leave(self.member)
                self.mode = "assign"
                self.assigned = list(op["value"])
                for k in self.assigned:
                    # real consumers seek to the committed offset
                    self.pos[k] = max(self.pos.get(k, 0),
                                      s.committed.get(k, 0))
                return dict(op, type="ok")
            if f == "subscribe":
                self.mode = "subscribe"
                s.subscribe(self.member, op["value"])
                return dict(op, type="ok")
            if f == "crash":
                s.leave(self.member)
                self.mode = "assign"
                self.assigned = []
                return dict(op, type="info", error="client crashed")
        raise ValueError(f"unknown kafka op {f!r}")


# ---------------------------------------------------------------------------
# Checker


def _observations(history):
    """Facts from the history, one ordered pass.

    Returns (sends, polls, reassigns) where
    sends:        (k, offset, v, ok-op-index, process)
    polls:        (k, [(off, v), ...], process, op-index, mop-slot,
                   rebalance-generation-or-None)
    reassigns:    (process, op-index) for assign/subscribe/crash completions
    send_invoked: {(k, v): earliest send-invocation op index}.
    """
    sends: List[Tuple[Any, int, Any, int, Any]] = []
    polls: List[Tuple[Any, List[Tuple[int, Any]], Any, int, int, Any]] = []
    reassigns: List[Tuple[Any, int]] = []
    send_invoked: Dict[Tuple[Any, Any], int] = {}
    for op in history:
        if not op.is_client_op():
            continue
        if op.f in ("assign", "subscribe"):
            if op.type == OK:
                reassigns.append((op.process, op.index))
            continue
        if op.f == "crash":
            if op.type in (OK, INFO):
                reassigns.append((op.process, op.index))
            continue
        if op.type == INVOKE and op.f in ("send", "txn"):
            for mop in op.value or ():
                if isinstance(mop, (tuple, list)) and len(mop) == 3 \
                        and mop[0] == "send":
                    send_invoked.setdefault((mop[1], mop[2]), op.index)
            continue
        if op.type != OK or op.f not in ("send", "poll", "txn"):
            continue
        gen = (op.ext or {}).get("rebalance")
        for slot, mop in enumerate(op.value or ()):
            if not isinstance(mop, (tuple, list)) or len(mop) < 2:
                continue
            kind = mop[0]
            if kind == "send" and isinstance(mop[2], tuple):
                off, v = mop[2]
                sends.append((mop[1], int(off), v, op.index, op.process))
            elif kind == "poll" and isinstance(mop[1], dict):
                for k, msgs in mop[1].items():
                    polls.append((k, [(int(o), v) for (o, v) in msgs],
                                  op.process, op.index, slot, gen))
    return sends, polls, reassigns, send_invoked


class KafkaChecker(checker_api.Checker):
    """The reference kafka checker's anomaly taxonomy (module docstring)."""

    def check(self, test, history, opts=None):
        sends, polls, reassigns, send_invoked = _observations(history)
        if not sends and not polls:
            return {"valid?": "unknown"}

        # version map: (k, offset) -> set of values observed there
        at: Dict[Tuple[Any, int], set] = {}
        polled_offsets: Dict[Any, set] = {}
        polled_values: Dict[Any, Dict[Any, set]] = {}
        for (k, off, v, _i, _p) in sends:
            at.setdefault((k, off), set()).add(v)
        for (k, msgs, _p, _i, _s, _g) in polls:
            for (off, v) in msgs:
                at.setdefault((k, off), set()).add(v)
                polled_offsets.setdefault(k, set()).add(off)
                polled_values.setdefault(k, {}).setdefault(v, set()).add(off)

        inconsistent_offsets = sorted(
            (k, off, sorted(vs, key=repr))
            for (k, off), vs in at.items() if len(vs) > 1)

        duplicates = sorted(
            (k, v, sorted(offs))
            for k, vals in polled_values.items()
            for v, offs in vals.items() if len(offs) > 1)

        # lost: committed send below the max polled offset, never polled
        lost = []
        for (k, off, v, i, _p) in sends:
            seen = polled_offsets.get(k, set())
            if not seen:
                continue
            if off < max(seen) and off not in seen:
                lost.append((k, off, v))
        lost = sorted(set(lost))

        # unseen (informational): committed values never polled anywhere
        unseen: Dict[Any, int] = {}
        for (k, off, v, i, _p) in sends:
            if off not in polled_offsets.get(k, set()):
                unseen[k] = unseen.get(k, 0) + 1

        # ---- poll-side order anomalies -----------------------------------
        # reassignment windows: real consumers seek back to the committed
        # offset on (re)assign, so cross-poll tracking resets there — polls
        # are compared only within the same assignment epoch (the reference
        # excludes poll pairs that cross an (re)assignment)
        reassign_by_proc: Dict[Any, List[int]] = {}
        for (p, i) in reassigns:
            reassign_by_proc.setdefault(p, []).append(i)

        def epoch(p, op_index):
            """Count of p's reassignments before this op."""
            import bisect

            lst = reassign_by_proc.get(p, ())
            return bisect.bisect_left(lst, op_index)

        nonmonotonic = []
        skipped = []
        int_nonmono = []
        int_skipped = []
        last_polled: Dict[Tuple[Any, Any], Tuple[int, Any]] = {}
        for (k, msgs, p, i, _s, gen) in sorted(polls, key=lambda t: (t[3], t[4])):
            if not msgs:
                continue
            offs = [o for (o, _v) in msgs]
            # epoch combines the process's own (re)assign count with the
            # broker's rebalance generation (attached by subscribe-mode
            # clients): a rebalance triggered by ANOTHER member also moves
            # partitions, and committed-offset seeks across it are legal
            ep = (epoch(p, i), gen)
            prev = last_polled.get((p, k))
            if prev is not None and prev[1] == ep and offs[0] <= prev[0]:
                nonmonotonic.append({"process": p, "key": k,
                                     "prev": prev[0], "next": offs[0],
                                     "op-index": i})
            if prev is not None and prev[1] == ep and offs[0] > prev[0] + 1 \
                    and any(prev[0] < o < offs[0]
                            for o in polled_offsets.get(k, ())):
                skipped.append({"key": k, "from": prev[0], "to": offs[0],
                                "process": p, "op-index": i})
            for a, b in zip(offs, offs[1:]):
                if b <= a:
                    int_nonmono.append({"key": k, "prev": a, "next": b,
                                        "op-index": i})
                elif b != a + 1 and any(a < o < b
                                        for o in polled_offsets.get(k, ())):
                    int_skipped.append({"key": k, "from": a, "to": b,
                                        "op-index": i})
            last_polled[(p, k)] = (offs[-1], ep)

        # ---- send-side order anomalies -----------------------------------
        nonmono_send = []
        int_send_skip = []
        last_sent: Dict[Tuple[Any, Any], int] = {}
        by_op: Dict[int, List[Tuple[Any, int]]] = {}
        for (k, off, v, i, p) in sorted(sends, key=lambda t: t[3]):
            prev = last_sent.get((p, k))
            if prev is not None and off <= prev:
                nonmono_send.append({"process": p, "key": k, "prev": prev,
                                     "next": off, "op-index": i})
            last_sent[(p, k)] = off
            by_op.setdefault(i, []).append((k, off))
        for i, kos in by_op.items():
            if len(kos) < 2:
                continue
            seen_k: Dict[Any, int] = {}
            for (k, off) in kos:
                if k in seen_k and off != seen_k[k] + 1:
                    int_send_skip.append({"key": k, "from": seen_k[k],
                                          "to": off, "op-index": i})
                seen_k[k] = off

        # ---- precommitted-read -------------------------------------------
        # a poll observed (k, v) at an index before the send of v was even
        # INVOKED.  Comparing completion indices would false-positive:
        # completion recording order can invert relative to broker order
        # under concurrency, so only the invocation gives a sound "this
        # value could not exist yet" bound.
        precommitted = []
        if send_invoked:
            for (k, msgs, p, i, _s, _g) in polls:
                for (off, v) in msgs:
                    j = send_invoked.get((k, v))
                    if j is not None and i < j:
                        precommitted.append({"key": k, "value": v,
                                             "poll-op": i, "send-op": j})

        # ---- stale consumer group ----------------------------------------
        # a frozen committed offset: >= STALE_MIN_POLLS subscribe-mode
        # batches of one (key, rebalance-generation) re-reading the SAME
        # start offset while the key's log has moved past them.  1-2
        # same-start re-reads happen benignly around rebalances; three
        # with the log ahead mean the group's commit stopped advancing.
        key_max: Dict[Any, int] = {}
        for (k, off, _v, _i, _p) in sends:
            key_max[k] = max(key_max.get(k, -1), off)
        for k, offs in polled_offsets.items():
            key_max[k] = max(key_max.get(k, -1), max(offs))
        stale_groups: Dict[Tuple[Any, int, int], List[int]] = {}
        for (k, msgs, _p, _i, _s, gen) in polls:
            if not msgs or gen is None:
                continue
            stale_groups.setdefault(
                (k, gen, msgs[0][0]), []).append(msgs[-1][0])
        stale = []
        for (k, gen, start), lasts in stale_groups.items():
            if len(lasts) < STALE_MIN_POLLS:
                continue
            behind = sum(1 for la in lasts if key_max.get(k, -1) > la)
            if behind:
                stale.append({"key": k, "generation": gen,
                              "start": start, "polls": len(lasts),
                              "behind": behind})
        stale.sort(key=lambda e: (repr(e["key"]), e["generation"],
                                  e["start"]))

        anomalies = {
            "lost-write": lost[:16],
            "duplicate": duplicates[:16],
            "inconsistent-offsets": inconsistent_offsets[:16],
            "nonmonotonic-poll": nonmonotonic[:16],
            "poll-skip": skipped[:16],
            "int-nonmonotonic-poll": int_nonmono[:16],
            "int-poll-skip": int_skipped[:16],
            "nonmonotonic-send": nonmono_send[:16],
            "int-send-skip": int_send_skip[:16],
            "precommitted-read": precommitted[:16],
            "stale-consumer-group": stale[:16],
        }
        found = {k: v for k, v in anomalies.items() if v}
        out = {
            "valid?": not found,
            "anomaly-types": sorted(found),
            "anomalies": found,
            "send-count": len(sends),
            "poll-count": len(polls),
        }
        if unseen:
            out["unseen"] = dict(sorted(unseen.items(), key=repr)[:16])
        return out
