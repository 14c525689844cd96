"""Port parity for the cycle sweep (`jepsen_tpu_torch/ops/cycle_sweep.py`).

The same graphs (numpy, from a seed, or the edges `infer` derives from a
stale-read history) go through the JAX sweep and the port's on the CPU;
has_cycle, witnesses, backward-edge counts and convergence must be equal,
including the budget grow-retries and the all-forward skip; an expired
deadline stops both sweeps, polled at the same points.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import stale_reads  # noqa: E402
from jepsen_tpu.checkers.elle import device_core as jdc  # noqa: E402
from jepsen_tpu.checkers.elle import device_infer as jdi  # noqa: E402
from jepsen_tpu.ops import cycle_sweep as jcs  # noqa: E402
from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch.ops import cycle_sweep as tcs  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402

FIELDS = ("rank", "nc_src", "nc_dst", "nc_mask", "chain_nodes",
          "chain_starts", "chain_mask")


def graphs(n_nodes, arrays):
    """The same graph as a JAX and a port SweepGraph."""
    return (jcs.SweepGraph(n_nodes, **{f: jnp.asarray(arrays[f])
                                       for f in FIELDS}),
            tcs.SweepGraph(n_nodes, **{f: torch.from_numpy(arrays[f])
                                       for f in FIELDS}))


def random_graph(n_nodes, n_edges, seed, n_chain=0):
    """Random ranks and edges (about half backward), plus chains: runs
    of nodes in increasing rank, cut into segments."""
    rng = np.random.default_rng(seed)
    rank = rng.permutation(n_nodes).astype(np.int32)
    chain = np.sort(rng.choice(n_nodes, n_chain, replace=False)) \
        if n_chain else np.zeros(0, np.int64)
    chain = chain[np.argsort(rank[chain], kind="stable")]
    starts = rng.random(len(chain)) < 0.2
    if len(chain):
        starts[0] = True
    return {
        "rank": rank,
        "nc_src": rng.integers(0, n_nodes, n_edges).astype(np.int32),
        "nc_dst": rng.integers(0, n_nodes, n_edges).astype(np.int32),
        "nc_mask": rng.random(n_edges) < 0.9,
        "chain_nodes": chain.astype(np.int32),
        "chain_starts": starts,
        "chain_mask": rng.random(len(chain)) < 0.95,
    }


def path_graph(length):
    """0 -> 1 -> ... -> L as plain forward edges, closed by the backward
    edge L -> 0: the fixpoint needs about L relax rounds."""
    src = np.arange(length + 1, dtype=np.int32)
    dst = np.concatenate([src[1:], [0]]).astype(np.int32)
    return {
        "rank": np.arange(length + 1, dtype=np.int32),
        "nc_src": src, "nc_dst": dst,
        "nc_mask": np.ones(length + 1, bool),
        "chain_nodes": np.zeros(1, np.int32),
        "chain_starts": np.ones(1, bool),
        "chain_mask": np.zeros(1, bool),
    }


def assert_same_result(want, got):
    assert got.has_cycle == want.has_cycle
    assert got.n_backward == want.n_backward
    assert got.converged == want.converged
    np.testing.assert_array_equal(got.witness_edge_ids,
                                  np.asarray(want.witness_edge_ids))


@pytest.mark.parametrize("n_nodes,n_edges,n_chain,seed,max_k", [
    (40, 12, 10, 0, 128),      # few backward edges, chains
    (60, 70, 20, 1, 8),        # backward edges overflow max_k: grow retry
    (30, 90, 0, 2, 16),        # dense, no chains
])
def test_detect_cycles_random_graphs(n_nodes, n_edges, n_chain, seed, max_k):
    arrays = random_graph(n_nodes, n_edges, seed, n_chain)
    gj, gt = graphs(n_nodes, arrays)
    want = jcs.detect_cycles(gj, max_k=max_k)
    got = tcs.detect_cycles(gt, max_k=max_k, device="cpu")
    assert_same_result(want, got)
    if max_k == 8:
        assert got.n_backward > max_k and got.converged


def test_detect_cycles_grows_rounds():
    gj, gt = graphs(21, path_graph(20))
    want = jcs.detect_cycles(gj, max_k=8, max_rounds=2)
    got = tcs.detect_cycles(gt, max_k=8, max_rounds=2, device="cpu")
    assert_same_result(want, got)
    assert got.has_cycle and got.converged
    assert list(got.witness_edge_ids) == [20]


def test_sweep_truncated_by_max_rounds_is_not_converged():
    arrays = path_graph(20)
    args = [arrays[f] for f in FIELDS]
    has, wit, n_back, conv = jcs._sweep(21, 8, 3, *map(jnp.asarray, args))
    t_has, t_wit, t_n_back, t_conv = tcs._sweep_window(
        21, 8, 3, *map(torch.from_numpy, args))
    assert (t_has, t_n_back, t_conv) == (bool(has), int(n_back), bool(conv))
    assert not t_conv and not t_has
    np.testing.assert_array_equal(t_wit.numpy(), np.asarray(wit))


def test_detect_cycles_all_forward_skips_the_sweep():
    arrays = path_graph(20)
    arrays["nc_mask"][-1] = False          # drop the closing back edge
    gj, gt = graphs(21, arrays)
    got = tcs.detect_cycles(gt, device="cpu")
    assert_same_result(jcs.detect_cycles(gj), got)
    assert (got.has_cycle, got.n_backward, got.converged) == (False, 0, True)


def test_detect_cycles_beyond_the_k_cap_is_inexact():
    arrays = random_graph(64, 2 * tcs.MAX_K_CAP + 2000, seed=3)
    gj, gt = graphs(64, arrays)
    got = tcs.detect_cycles(gt, device="cpu")
    assert_same_result(jcs.detect_cycles(gj), got)
    assert got.n_backward > tcs.MAX_K_CAP and not got.converged


def _sweep_inputs(n_txns, n_keys, seed):
    """core_check's sweep inputs (JAX infer output, as writable numpy)."""
    p = stale_reads(synth.packed_la_history(n_txns, n_keys=n_keys,
                                            seed=seed))
    out = jdi.infer(jdi.pad_packed(p), p.n_keys)
    fams = ("ww", "wr", "rw", "tb", "bt")
    e = out["edges"]
    pc, bc = out["chains"]["process"], out["chains"]["barrier"]
    return {
        "n_nodes": 2 * out["ranks"]["txn"].shape[0],
        "rank": np.concatenate([np.asarray(out["ranks"]["txn"]),
                                np.asarray(out["ranks"]["barrier"])]),
        "e_src": np.concatenate([np.asarray(e[f][0]) for f in fams]),
        "e_dst": np.concatenate([np.asarray(e[f][1]) for f in fams]),
        "fam_masks": [np.array(e[f][2]) for f in fams],
        "chain_nodes": np.concatenate([np.asarray(pc[0]),
                                       np.asarray(bc[0])]),
        "chain_starts": np.concatenate([np.asarray(pc[1]),
                                        np.asarray(bc[1])]),
        "chain_masks": [np.array(pc[2]), np.array(bc[2])],
    }


@pytest.mark.parametrize("max_k", [128, 8])
def test_projection_scan_equal_to_jax(max_k):
    a = _sweep_inputs(1043, 130, seed=7)
    inc = np.asarray(jdc.proj_include_stack())
    cinc = np.asarray(jdc.chain_include_stack())
    run = jax.jit(jcs.projection_scan, static_argnums=(0, 1, 2))
    conv, over, bits = run(
        a["n_nodes"], max_k, 64, jnp.asarray(a["rank"]),
        jnp.asarray(a["e_src"]), jnp.asarray(a["e_dst"]),
        [jnp.asarray(m) for m in a["fam_masks"]], jnp.asarray(inc),
        jnp.asarray(a["chain_nodes"]), jnp.asarray(a["chain_starts"]),
        [jnp.asarray(m) for m in a["chain_masks"]], jnp.asarray(cinc))
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in a.items()}
    got = tcs.projection_scan(
        a["n_nodes"], max_k, 64, t["rank"], t["e_src"], t["e_dst"],
        [torch.from_numpy(m) for m in a["fam_masks"]], inc.tolist(),
        t["chain_nodes"], t["chain_starts"],
        [torch.from_numpy(m) for m in a["chain_masks"]], cinc.tolist())
    assert got == (bool(conv), int(over), np.asarray(bits).tolist())
    assert got[2] == [0, 0, 1, 1, 1]
    assert (got[1] > 0) == (max_k == 8)


def test_projection_scan_all_forward():
    a = _sweep_inputs(531, 7, seed=3)
    a["fam_masks"] = [np.zeros_like(m) for m in a["fam_masks"]]
    t = {k: torch.from_numpy(v) for k, v in a.items()
         if isinstance(v, np.ndarray)}
    got = tcs.projection_scan(
        a["n_nodes"], 128, 64, t["rank"], t["e_src"], t["e_dst"],
        [torch.from_numpy(m) for m in a["fam_masks"]],
        np.asarray(jdc.proj_include_stack()).tolist(), t["chain_nodes"],
        t["chain_starts"], [torch.from_numpy(m) for m in a["chain_masks"]],
        np.asarray(jdc.chain_include_stack()).tolist())
    assert got == (True, 0, [0, 0, 0, 0, 0])


def test_detect_cycles_expired_deadline_raises():
    arrays = random_graph(40, 12, 0, 10)
    gj, gt = graphs(40, arrays)
    with pytest.raises(jres.DeadlineExceeded):
        jcs.detect_cycles(gj, deadline=jres.Deadline(0.0))
    with pytest.raises(tres.DeadlineExceeded, match="cycle-sweep"):
        tcs.detect_cycles(gt, deadline=tres.Deadline(0.0), device="cpu")


class Polls:
    """A deadline that records where it was polled and never expires."""

    def __init__(self):
        self.sites = []

    def check(self, what=""):
        self.sites.append(what)


def test_detect_cycles_polls_before_every_grow_retry():
    # max_k = 8 overflows once, max_rounds = 2 is too few: the sweep
    # runs three times, and both packages poll before each run
    arrays = random_graph(60, 70, 1, 20)
    gj, gt = graphs(60, arrays)
    want, got = Polls(), Polls()
    assert_same_result(jcs.detect_cycles(gj, max_k=8, max_rounds=2,
                                         deadline=want),
                       tcs.detect_cycles(gt, max_k=8, max_rounds=2,
                                         deadline=got, device="cpu"))
    assert got.sites == want.sites
    assert len(got.sites) >= 2 and set(got.sites) == {"cycle-sweep"}


@pytest.mark.parametrize("seed", range(12))
def test_windowed_fixpoint_gives_the_full_fixpoints_witnesses(seed):
    # the port reads its fixpoint on rank windows; run to convergence,
    # its witnesses are the JAX sweep's (the full fixpoint)
    n_nodes = 30 + 7 * seed
    arrays = random_graph(n_nodes, 2 * n_nodes, seed, n_chain=n_nodes // 3)
    args = [torch.from_numpy(arrays[f]) for f in FIELDS]
    win = tcs._sweep_window(n_nodes, 128, n_nodes + 1, *args)
    jhas, jwit, jn, jconv = jcs._sweep(n_nodes, 128, n_nodes + 1,
                                       *map(jnp.asarray, arrays.values()))
    assert bool(jconv) and win[3]
    assert (win[0], win[2], win[1].tolist()) == \
        (bool(jhas), int(jn), np.asarray(jwit).tolist())


def local_graph(n_nodes, seed, n_back=40, max_drop=6):
    """A history-like graph: forward edges to the next few nodes in rank
    order, and short backward edges scattered along it, so that the
    windows are many small components."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n_nodes - 2), 2)
    dst = src + np.tile([1, 2], n_nodes - 2)
    keep = rng.random(len(src)) < np.where(dst == src + 1, 0.9, 0.3)
    bsrc = rng.integers(max_drop, n_nodes, n_back)
    bdst = bsrc - rng.integers(0, max_drop, n_back)
    chain = np.arange(0, n_nodes, 7)
    return {
        "rank": np.arange(n_nodes, dtype=np.int32),
        "nc_src": np.concatenate([src[keep], bsrc]).astype(np.int32),
        "nc_dst": np.concatenate([dst[keep], bdst]).astype(np.int32),
        "nc_mask": np.ones(int(keep.sum()) + n_back, bool),
        "chain_nodes": chain.astype(np.int32),
        "chain_starts": np.arange(len(chain)) % 2 == 0,
        "chain_mask": np.ones(len(chain), bool),
    }


@pytest.mark.parametrize("seed", range(6))
def test_windowed_fixpoint_on_local_backward_edges(seed):
    n_nodes = 600
    arrays = local_graph(n_nodes, seed)
    args = [torch.from_numpy(arrays[f]) for f in FIELDS]
    jhas, jwit, jn, jconv = jcs._sweep(
        n_nodes, 128, n_nodes + 1, *[jnp.asarray(arrays[f]) for f in FIELDS])
    full = (bool(jhas), np.asarray(jwit).tolist(), int(jn))
    win = tcs._sweep_window(n_nodes, 128, n_nodes + 1, *args)
    assert bool(jconv) and win[3] and full[0]
    assert 0 < sum(full[1]) < full[2]           # some edges on no cycle
    assert (win[0], win[1].tolist(), win[2]) == full
    # the windows are short: a few rounds give the same witnesses, where
    # the JAX sweep needs more
    few = tcs._sweep_window(n_nodes, 128, 16, *args)
    assert few[3] and few[1].tolist() == full[1]
    assert not bool(jcs._sweep(n_nodes, 128, 16, *[
        jnp.asarray(arrays[f]) for f in FIELDS])[3])


def test_detect_cycles_converges_past_the_round_cap():
    # two short cycles at the head of a 3,000-node path: the full
    # fixpoint runs the labels down the whole path (about 3,000 rounds,
    # past MAX_ROUNDS_CAP, where the JAX sweep stops unconverged); the
    # windowed one converges in a few rounds with the same witnesses
    length = 3000
    arrays = path_graph(length)
    arrays["nc_mask"][-1] = False                 # no closing edge
    for src, dst in ((2, 0), (10, 5)):
        arrays["nc_src"] = np.append(arrays["nc_src"], np.int32(src))
        arrays["nc_dst"] = np.append(arrays["nc_dst"], np.int32(dst))
        arrays["nc_mask"] = np.append(arrays["nc_mask"], True)
    gj, gt = graphs(length + 1, arrays)
    want = jcs.detect_cycles(gj)
    assert want.has_cycle and not want.converged
    got = tcs.detect_cycles(gt, device="cpu")
    assert got.has_cycle and got.converged and got.n_backward == 2
    assert list(got.witness_edge_ids) == [length + 1, length + 2]
    # the JAX fixpoint run to its end agrees
    args = [jnp.asarray(arrays[f]) for f in FIELDS]
    has, wit, n_back, conv = jcs._sweep(length + 1, 8, 4 * length, *args)
    assert bool(conv) and bool(has) and int(n_back) == 2
    assert np.asarray(wit).tolist()[:2] == [1, 1]


def _on_a_cycle(n_nodes, arrays):
    """The plain reference: positions of the backward edges that lie on
    a cycle, those whose ends share a strongly connected component of
    the whole graph (chain edges included)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    m = arrays["nc_mask"]
    src, dst = arrays["nc_src"][m], arrays["nc_dst"][m]
    cn, cs, cm = (arrays["chain_nodes"], arrays["chain_starts"],
                  arrays["chain_mask"])
    live = np.nonzero(cm)[0]
    # a chain segment runs from one start to the next; the masked-out
    # entries drop out of it
    seg = np.cumsum(cs) - 1
    links = [(cn[a], cn[b]) for a, b in zip(live[:-1], live[1:])
             if seg[a] == seg[b]]
    s_all = np.concatenate([src, [a for a, _ in links]]).astype(np.int64)
    d_all = np.concatenate([dst, [b for _, b in links]]).astype(np.int64)
    g = coo_matrix((np.ones(len(s_all)), (s_all, d_all)),
                   shape=(n_nodes, n_nodes))
    _, label = connected_components(g, directed=True, connection="strong")
    rank = arrays["rank"]
    pos = np.nonzero(arrays["nc_mask"] & (rank[arrays["nc_src"]]
                                          >= rank[arrays["nc_dst"]]))[0]
    s, d = arrays["nc_src"][pos], arrays["nc_dst"][pos]
    return pos[(label[s] == label[d])]


@pytest.mark.parametrize("seed", range(3))
def test_detect_cycles_sweeps_components_past_the_k_cap(seed, monkeypatch):
    # past MAX_K_CAP backward edges (lowered to 64 here) the port sweeps
    # the components of their rank intervals in batches: every backward
    # edge on a cycle is found, as the JAX sweep finds them under its
    # own cap and the strongly connected components say
    n_nodes = 2000
    arrays = local_graph(n_nodes, seed, n_back=300, max_drop=4)
    gj, gt = graphs(n_nodes, arrays)
    monkeypatch.setattr(tcs, "MAX_K_CAP", 64)
    got = tcs.detect_cycles(gt, device="cpu")
    want = jcs.detect_cycles(gj)
    assert got.n_backward == 300 and got.converged and want.converged
    assert got.has_cycle == want.has_cycle is True
    assert sorted(got.witness_edge_ids) == sorted(want.witness_edge_ids)
    assert list(got.witness_edge_ids) == list(_on_a_cycle(n_nodes, arrays))
    # one component larger than the cap still leaves it inexact
    monkeypatch.setattr(tcs, "MAX_K_CAP", 8)
    wide = local_graph(200, seed, n_back=300, max_drop=6)
    _, gw = graphs(200, wide)
    res = tcs.detect_cycles(gw, device="cpu")
    assert res.n_backward > 8 and not res.converged
