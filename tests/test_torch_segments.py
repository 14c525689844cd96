"""Port parity for the segment primitives and the plain versions of the
two kernels (`jepsen_tpu_torch/ops/{segments,scan,fill}.py`).

The same numpy inputs (made from a seed) go through the JAX function and
its PyTorch counterpart on the CPU; every comparison is exact, since the
functions are integer and boolean.  On the CPU the wrappers take the plain
versions, so the kernel launch counters stay 0, and the kernel entries
refuse a CPU tensor; the CUDA kernels themselves are compared with these
plain versions on the card by `chip_smoke.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jepsen_tpu.ops import pallas_fill, pallas_scan  # noqa: E402
from jepsen_tpu.ops import segments as jseg  # noqa: E402
from jepsen_tpu_torch.ops import fill, kernels, scan  # noqa: E402
from jepsen_tpu_torch.ops import segments as tseg  # noqa: E402

# the JAX references, jitted: one XLA compile per shape instead of one per
# primitive (eager associative scans cost seconds of compile each)
j_prefix_or = jax.jit(jseg.segmented_prefix_or, static_argnames="exclusive")
j_seg_scan = jax.jit(jseg._seg_scan)
j_seg_scan_loop = jax.jit(jseg._seg_scan_loop)
j_seg_or_blocked = jax.jit(pallas_scan.seg_or_blocked_reference,
                           static_argnames="block")
j_cumsum = jax.jit(jseg.segmented_cumsum, static_argnames="exclusive")
j_cummax = jax.jit(jseg.segmented_cummax,
                   static_argnames=("exclusive", "neutral"))
j_locf = jax.jit(pallas_fill.locf_lax)
j_locf_blocked = jax.jit(pallas_fill.locf_blocked_reference,
                         static_argnames="block")


def _plane(n, k, p_start, seed, first_start=True):
    rng = np.random.default_rng(seed)
    vals = (rng.random((n, k)) < 0.08).astype(np.int8)
    starts = rng.random(n) < p_start
    starts[0] = first_start
    return vals, starts


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the layouts of tests/test_pallas.py: (n, k, p_start, block)
SCAN_CASES = [
    (8, 128, 0.3, 8),          # single tiny block
    (256, 128, 0.1, 64),       # carries cross block boundaries
    (300, 128, 0.05, 64),      # n not a block multiple
    (1024, 128, 0.0, 128),     # one segment spanning every block
    (512, 128, 1.0, 128),      # every row its own segment
    (2048, 16, 0.02, 512),     # narrow lanes
    (777, 100, 0.3, 256),      # K not a multiple of the word
]


#: the port's two ways in: the segment primitive, and the kernel module's
#: plain version that the CUDA kernel is held against on the card
PREFIX_OR_ENTRIES = {
    "segments": tseg.segmented_prefix_or,
    "seg_or_plain": scan.seg_or_plain,
}


@pytest.mark.parametrize("entry", list(PREFIX_OR_ENTRIES))
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("first_start", [True, False])
@pytest.mark.parametrize("n,k,p_start,block", SCAN_CASES)
def test_segmented_prefix_or_matches_jax(n, k, p_start, block, first_start,
                                         exclusive, entry):
    vals, starts = _plane(n, k, p_start, seed=n + k,
                          first_start=first_start)
    want = j_prefix_or(jnp.asarray(vals), jnp.asarray(starts),
                       exclusive=exclusive)
    got = PREFIX_OR_ENTRIES[entry](torch.from_numpy(vals),
                                   torch.from_numpy(starts),
                                   exclusive=exclusive)
    _eq(got, want)


@pytest.mark.parametrize("n,k,p_start,block", SCAN_CASES)
def test_seg_or_plain_matches_jax_scans(n, k, p_start, block):
    vals, starts = _plane(n, k, p_start, seed=7 * n + k)
    got = scan.seg_or_plain(torch.from_numpy(vals), torch.from_numpy(starts))
    v, s = jnp.asarray(vals), jnp.asarray(starts)
    _eq(got, j_seg_scan(v, s))
    _eq(got, j_seg_scan_loop(v, s))
    _eq(got, j_seg_or_blocked(v, s, block=block))


def test_seg_or_carry_and_reset():
    # one start at row 0 and a value only there reaches every row; a start
    # mid-way cuts it off
    n, k = 512, 128
    vals = np.zeros((n, k), np.int8)
    vals[0, 3] = 1
    starts = np.zeros(n, bool)
    starts[0] = True
    starts[130] = True
    got = scan.seg_or_plain(torch.from_numpy(vals), torch.from_numpy(starts))
    assert (got[:130, 3] == 1).all() and (got[130:, 3] == 0).all()
    _eq(got, j_seg_scan(jnp.asarray(vals), jnp.asarray(starts)))


@pytest.mark.parametrize("n", [0, 1, 2, 57, 1000])
def test_segment_starts_from_sorted(n):
    keys = np.sort(np.random.default_rng(n).integers(0, 9, n)).astype(
        np.int32)
    _eq(tseg.segment_starts_from_sorted(torch.from_numpy(keys)),
        jseg.segment_starts_from_sorted(jnp.asarray(keys)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_or_drops_and_wraps_like_jax(seed):
    # indices cover negatives (wrapped once, or still out of range) and
    # indices past the sink row, which a JAX scatter drops
    rng = np.random.default_rng(seed)
    n, k, e = 64, 16, 300
    target = (rng.random((n, k)) < 0.1).astype(np.int8)
    vals = (rng.random((e, k)) < 0.2).astype(np.int8)
    idx = rng.integers(-2 * n - 3, 2 * n + 3, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    want = jseg.scatter_or(jnp.asarray(target), jnp.asarray(idx),
                           jnp.asarray(vals), jnp.asarray(mask))
    got = tseg.scatter_or(torch.from_numpy(target), torch.from_numpy(idx),
                          torch.from_numpy(vals), torch.from_numpy(mask))
    _eq(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_rows_clamps_like_jax(seed):
    rng = np.random.default_rng(seed)
    n, k, e = 50, 8, 200
    src = rng.integers(0, 2, (n, k)).astype(np.int8)
    idx = rng.integers(-2 * n, 2 * n, e).astype(np.int32)
    mask = rng.random(e) < 0.6
    _eq(tseg.gather_rows(torch.from_numpy(src), torch.from_numpy(idx),
                         torch.from_numpy(mask)),
        jseg.gather_rows(jnp.asarray(src), jnp.asarray(idx),
                         jnp.asarray(mask)))


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("first_start", [True, False])
def test_segmented_cumsum_cummax_ids(first_start, exclusive):
    rng = np.random.default_rng(int(first_start) * 2 + int(exclusive))
    n = 333
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    starts = rng.random(n) < 0.1
    starts[0] = first_start
    v, s = torch.from_numpy(vals), torch.from_numpy(starts)
    jv, js = jnp.asarray(vals), jnp.asarray(starts)
    _eq(tseg.segment_ids_from_starts(s), jseg.segment_ids_from_starts(js))
    _eq(tseg.segmented_cumsum(v, s, exclusive=exclusive),
        j_cumsum(jv, js, exclusive=exclusive))
    _eq(tseg.segmented_cummax(v, s, exclusive=exclusive),
        j_cummax(jv, js, exclusive=exclusive))
    _eq(tseg.segmented_cummax(v, s, exclusive=exclusive, neutral=-1),
        j_cummax(jv, js, exclusive=exclusive, neutral=-1))


def test_segmented_cummax_extremes():
    # int32 extremes in one segment and across a reset
    vals = np.array([-2 ** 31, 2 ** 31 - 1, -5, 7, -2 ** 31, 3], np.int32)
    starts = np.array([True, False, False, True, False, False])
    _eq(tseg.segmented_cummax(torch.from_numpy(vals),
                              torch.from_numpy(starts)),
        j_cummax(jnp.asarray(vals), jnp.asarray(starts)))


def _seed_array(rng, n, density, monotone=False):
    x = np.full(n, pallas_fill.HOLE, np.int32)
    pos = rng.random(n) < density
    vals = rng.integers(0, 1_000_000, size=int(pos.sum()))
    if monotone:
        vals = np.sort(vals)
    x[np.nonzero(pos)[0]] = vals
    return x


# the sizes and densities of tests/test_pallas_fill.py
@pytest.mark.parametrize("n", [1, 7, 128, 129, 1000, 4096, 200_000])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_locf_plain_matches_jax(n, density):
    rng = np.random.default_rng(n * 1000 + int(density * 100))
    x = _seed_array(rng, n, density)
    got = fill.locf_plain(torch.from_numpy(x))
    _eq(got, j_locf(jnp.asarray(x)))
    # small blocks exercise the carry; a large n keeps the unrolled block
    # loop short
    _eq(got, j_locf_blocked(jnp.asarray(x), block=8 if n <= 4096 else 1024))


def test_locf_plain_adversarial_layouts():
    hole = pallas_fill.HOLE
    cases = [
        np.full(300, hole, np.int32),                         # all holes
        np.arange(300, dtype=np.int32),                       # no holes
        np.array([hole] * 299 + [5], np.int32),               # one at end
        np.array([5] + [hole] * 299, np.int32),               # one at start
        np.array([v if v % 128 == 0 else hole for v in range(300)],
                 np.int32),                       # only at block starts
        np.zeros(0, np.int32),                                # empty
    ]
    for x in cases:
        _eq(fill.locf_plain(torch.from_numpy(x)),
            j_locf(jnp.asarray(x)) if len(x) else x)


def _monotone_seeds(case):
    """Seeds as `infer` builds them under app_val_mono / rd_start_mono:
    nondecreasing values where the mask holds, the hole -1 elsewhere."""
    rng = np.random.default_rng(7)
    n = 50_000
    if case == "holes":
        x = _seed_array(rng, n, 0.05, monotone=True)
        return x, x != pallas_fill.HOLE
    mask = {"all masked": np.zeros(n, bool),
            "none masked": np.ones(n, bool),
            "unmasked -1": rng.random(n) < 0.05}[case]
    # in the last case the first unmasked values are -1 themselves
    lo = -1 if case == "unmasked -1" else 0
    vals = np.sort(rng.integers(lo, 40, n)).astype(np.int32)
    return np.where(mask, vals, pallas_fill.HOLE).astype(np.int32), mask


@pytest.mark.parametrize("case", ["holes", "unmasked -1", "all masked",
                                  "none masked"])
def test_locf_plain_is_cummax_on_monotone_seeds(case):
    x, mask = _monotone_seeds(case)
    assert (mask & (x == pallas_fill.HOLE)).any() == (case == "unmasked -1")
    got = fill.locf_plain(torch.from_numpy(x))
    _eq(got, torch.cummax(torch.from_numpy(x), 0).values)
    _eq(got, j_locf_blocked(jnp.asarray(x), block=1024))


def test_cpu_tensors_take_the_plain_versions():
    fill.LAUNCHES = scan.LAUNCHES = 0
    x = torch.tensor([-1, 3, -1, 5, -1], dtype=torch.int32)
    assert fill.locf(x).tolist() == [-1, 3, 3, 5, 5]
    v = torch.tensor([[1, 0], [0, 1], [0, 0]], dtype=torch.int8)
    s = torch.tensor([True, False, True])
    assert scan.seg_or(v, s).tolist() == [[1, 0], [1, 1], [0, 0]]
    assert scan.seg_or(v, s, exclusive=True).tolist() == [[0, 0], [1, 0],
                                                           [0, 0]]
    assert tseg.segmented_prefix_or(v, s).tolist() == [[1, 0], [1, 1],
                                                        [0, 0]]
    assert fill.LAUNCHES == 0 and scan.LAUNCHES == 0


def test_kernel_entries_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        fill.locf_cuda(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan.seg_or_cuda(torch.zeros((4, 8), dtype=torch.int8),
                         torch.ones(4, dtype=torch.bool))
    assert fill.LAUNCHES == 0 and scan.LAUNCHES == 0


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert {p.name for p in kernels.sources()} == {"locf.cu", "seg_or.cu"}


# (n, K, value/output address alignment) -> (word, words per row, column
# block, runs, tile rows, row tiles, column blocks)
GEOMETRY_CASES = {
    "K=1": ((5000, 1, 256), (1, 1, 1, 256, 2048, 3, 1)),
    "K=16 ragged": ((4099, 16, 256), (16, 1, 1, 256, 2048, 3, 1)),
    "K=100": ((777, 100, 256), (4, 25, 32, 8, 64, 13, 1)),
    "K=128 sweep": ((1 << 21, 128, 256), (16, 8, 8, 32, 256, 8192, 1)),
    "K=128 4-aligned": ((1000, 128, 4), (4, 32, 32, 8, 64, 16, 1)),
    "K=128 unaligned": ((1000, 128, 1), (1, 128, 128, 2, 16, 63, 1)),
    "K=300 bytes": ((50, 300, 2), (1, 300, 256, 1, 8, 7, 2)),
    "K=8192 ragged": ((4099, 8192, 256), (16, 512, 256, 1, 8, 513, 2)),
    "K=8192 bytes": ((9, 8192, 1), (1, 8192, 256, 1, 8, 2, 32)),
}


@pytest.mark.parametrize("case", list(GEOMETRY_CASES))
def test_seg_or_geometry(case):
    (n, k, align), want = GEOMETRY_CASES[case]
    g = scan.seg_or_geometry(n, k, (1 << 20, (1 << 21) + align))
    assert (g.word, g.nw, g.cbw, g.runs, g.tile_rows, g.row_tiles,
            g.col_blocks) == want
    # one block per tile; a state word per tile after the counter, and
    # each tile's aggregate and inclusive prefix (K = 128 at the sweep's
    # shape: 32 KiB of states, 2 MiB of values)
    assert g.tiles == g.row_tiles * g.col_blocks
    assert g.state_words == 1 + g.tiles
    assert g.value_bytes == 2 * g.tiles * g.cbw * g.word
    # every column word and row is in exactly one tile, and a tile fits
    # one block of THREADS threads
    assert g.cbw * g.runs == scan.THREADS and g.cbw & (g.cbw - 1) == 0
    assert g.tile_rows == g.runs * scan.ITEMS
    assert (g.col_blocks - 1) * g.cbw < g.nw <= g.col_blocks * g.cbw
    assert (g.row_tiles - 1) * g.tile_rows < n <= g.row_tiles * g.tile_rows


@pytest.mark.parametrize("n,tiles", [(1, 1), (4095, 1), (4096, 1),
                                     (4097, 2), ((1 << 24) - 1234, 4096),
                                     (1 << 24, 4096)])
def test_locf_geometry(n, tiles):
    # one status word per tile after the counter: 32 KiB + 8 at 2^24
    assert fill.locf_geometry(n) == (tiles, 1 + tiles)


def test_kernel_digest_keys_nvcc_version(monkeypatch):
    """Another toolkit's nvcc gives another library name, so a library
    another compiler built is never loaded."""
    monkeypatch.setattr(kernels, "_nvcc_version",
                        lambda nvcc: "Cuda compilation tools, release 12.8")
    a = kernels._digest("nvcc")
    monkeypatch.setattr(kernels, "_nvcc_version",
                        lambda nvcc: "Cuda compilation tools, release 13.0")
    assert kernels._digest("nvcc") != a
