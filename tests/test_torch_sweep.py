"""Port parity for the cycle sweep (`jepsen_tpu_torch/ops/cycle_sweep.py`).

The same graphs (numpy, from a seed, or the edges `infer` derives from a
stale-read history) go through the JAX sweep and the port's on the CPU;
has_cycle, witnesses, backward-edge counts and convergence must be equal,
including the budget grow-retries and the all-forward skip.
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
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch.ops import cycle_sweep as tcs  # noqa: E402

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
    t_has, t_wit, t_n_back, t_conv = tcs._sweep_arrays(
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
