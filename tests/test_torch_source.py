"""The port's partition-local loaders (core/graph.py ``load_lux_rows`` and
the ``rows=`` reads, ``save_lux``, ``save_dataset``), its sources
(core/source.py) and its native loader passes (native/rocload.cc) against
the JAX package's, on the CPU.

Every comparison is bit for bit: the same files give the same arrays in
both packages, the native passes give what the JAX package's numpy paths
give, and a FileSource reads only the byte ranges the JAX package's
does.  The JAX package's numpy paths are taken with its native library
switched off in the test (its tests/test_native.py does the same).
"""

import os
import struct

import numpy as np
import pytest

from roc_tpu import native as jnative
from roc_tpu.core import ell as jell
from roc_tpu.core import graph as jgraph
from roc_tpu.core import partition as jpartition
from roc_tpu.core import source as jsource
from roc_tpu_torch import native
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core import partition as tpartition
from roc_tpu_torch.core.partition import partition_col, partition_plan
from roc_tpu_torch.core.source import (ArraySource, FileSource, RowGraph,
                                       as_source)
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         resolve_auto_impl_probed,
                                         resolve_symmetric)

V, F, C = 300, 7, 4


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package with its native library switched off: its numpy
    paths."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A synthetic dataset (self edges, symmetric) in the reference
    layout, written by the JAX package with both feature files, and the
    in-memory datasets of both packages."""
    jds = jgraph.synthetic_dataset(V, 8, in_dim=F, num_classes=C, seed=3)
    tds = tgraph.synthetic_dataset(V, 8, in_dim=F, num_classes=C, seed=3)
    prefix = str(tmp_path_factory.mktemp("ds") / "syn")
    jgraph.save_dataset(jds, prefix)
    return jds, tds, prefix


def test_native_library_is_the_ports_own(monkeypatch):
    """The port builds its own library from its sources into its own
    build directory (never the JAX package's native/librocio.so, whose
    ROC_TPU_NATIVE variable it ignores), at ABI_VERSION, and counts the
    loader passes' calls."""
    assert native.available()
    target = native._target()
    assert os.path.dirname(target) == native.BUILD_DIR
    assert os.path.basename(target).startswith("librocplan_")
    assert [os.path.basename(s) for s in native.SOURCES] == \
        ["rocplan.cc", "rocload.cc"]
    assert native._lib.roc_abi_version() == native.ABI_VERSION == 2
    here = os.path.dirname(native.__file__)
    for name in os.listdir(here):
        if name.endswith((".py", ".cc")):
            with open(os.path.join(here, name)) as f:
                text = f.read()
            assert "librocio" not in text and "environ" not in text, name
    before = native.calls.get("edge_balanced_bounds", 0)
    tpartition.edge_balanced_bounds(np.array([0, 2, 5, 9]), 2)
    assert native.calls["edge_balanced_bounds"] == before + 1


def test_lux_round_trip_both_ways(disk, jax_numpy, tmp_path):
    """A .lux written by the port's native writer reads back in the JAX
    package's numpy reader bit for bit, and one written by the JAX numpy
    writer in the port's native reader; the header reads agree."""
    _, tds, prefix = disk
    g = tds.graph
    p1, p2 = str(tmp_path / "port.lux"), str(tmp_path / "jax.lux")
    tgraph.save_lux(g, p1)
    jgraph.save_lux(jgraph.Graph(g.row_ptr, g.col_idx), p2)
    with open(p1, "rb") as a, open(p2, "rb") as b:
        assert a.read() == b.read()
    for path in (p1, p2):
        jg, tg = jgraph.load_lux(path), tgraph.load_lux(path)
        np.testing.assert_array_equal(tg.row_ptr, jg.row_ptr)
        np.testing.assert_array_equal(tg.col_idx, jg.col_idx)
        assert native.lux_header(path) == tgraph.load_lux_header(path) == \
            jgraph.load_lux_header(path)


@pytest.mark.parametrize("how", ["non_monotone", "bad_end", "truncated"])
def test_corrupt_lux_refused(disk, jax_numpy, tmp_path, how):
    """A corrupt .lux is refused by the native reader as by the JAX
    numpy reader: the same exception class (ValueError for a malformed
    file, IOError for a short one)."""
    _, tds, _ = disk
    path = str(tmp_path / "bad.lux")
    tgraph.save_lux(tds.graph, path)
    with open(path, "r+b") as f:
        if how == "non_monotone":
            f.seek(12 + 8 * 10)
            f.write(struct.pack("<Q", 0))
        elif how == "bad_end":
            f.seek(12 + 8 * (V - 1))
            f.write(struct.pack("<Q", tds.graph.num_edges - 1))
        else:
            f.truncate(12 + 8 * V + 4 * 10)
    with pytest.raises(Exception) as jerr:
        jgraph.load_lux(path)
    with pytest.raises(Exception) as terr:
        tgraph.load_lux(path)
    assert terr.type is jerr.type, (terr.value, jerr.value)


def test_csv_features_full_and_rows(disk, jax_numpy, monkeypatch, tmp_path):
    """The native CSV parser, whole and by rows, gives the JAX package's
    np.loadtxt values (its rows= reads too; an empty range is the
    port's alone: the JAX numpy path refuses it), and so does the port's
    own numpy path with the library off; a wrong width is refused."""
    _, _, prefix = disk
    csv = prefix + ".feats.csv"
    want = np.loadtxt(csv, delimiter=",", dtype=np.float32).reshape(V, F)
    np.testing.assert_array_equal(native.load_features_csv(csv, V, F), want)
    only_csv = str(tmp_path / "c")
    os.symlink(csv, only_csv + ".feats.csv")
    ranges = ((0, V), (0, 1), (17, 140), (299, 300))
    for lo, hi in ranges + ((50, 50),):
        got = native.load_features_csv_rows(csv, lo, hi, F)
        np.testing.assert_array_equal(got, want[lo:hi])
        if hi > lo:
            np.testing.assert_array_equal(
                got, jgraph.load_features(only_csv, V, F, rows=(lo, hi)))
    with pytest.raises(ValueError):
        native.load_features_csv(csv, V, F + 1)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    for lo, hi in ranges + ((50, 50),):
        np.testing.assert_array_equal(
            tgraph.load_features(only_csv, V, F, rows=(lo, hi)),
            want[lo:hi])


def test_mask_bounds_self_edges_widths_native_equal_numpy(disk, jax_numpy):
    """The mask parser, the edge-balanced sweep at P = 1, 2, 4 and 7,
    self-edge insertion and the ELL widths: the native passes against
    the JAX package's numpy paths, bit for bit."""
    jds, tds, prefix = disk
    np.testing.assert_array_equal(native.load_mask(prefix + ".mask", V),
                                  jgraph.load_mask(prefix, V))
    skew = tgraph.zipf_csr(400, 3000, seed=2)
    for g in (tds.graph, skew):
        for P in (1, 2, 4, 7):
            got = [tuple(map(int, b))
                   for b in native.edge_balanced_bounds(g.row_ptr, P)]
            assert got == [tuple(map(int, b)) for b in
                           jpartition.edge_balanced_bounds(g.row_ptr, P)]
            assert tpartition.edge_balanced_bounds(g.row_ptr, P) == got
        np.testing.assert_array_equal(
            native.ell_widths(g.row_ptr, 8),
            jell.row_widths(np.diff(g.row_ptr), 8))
    base = tgraph.from_edge_list(*np.random.RandomState(4).randint(
        0, 200, size=(2, 900)), 200)
    rp, col = native.add_self_edges(base.row_ptr, base.col_idx)
    want = jgraph.add_self_edges(jgraph.Graph(base.row_ptr, base.col_idx))
    np.testing.assert_array_equal(rp, want.row_ptr)
    np.testing.assert_array_equal(col, want.col_idx)


@pytest.mark.parametrize("lo,hi", [(0, V), (0, 1), (1, 2), (37, 191),
                                   (299, 300), (120, 120)])
def test_load_lux_rows_equal_jax(disk, lo, hi):
    """load_lux_rows of any row range equals the JAX package's."""
    _, _, prefix = disk
    path = prefix + ".add_self_edge.lux"
    tp, tc = tgraph.load_lux_rows(path, lo, hi)
    jp, jc = jgraph.load_lux_rows(path, lo, hi)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, jc)
    assert tp.dtype == jp.dtype and tc.dtype == jc.dtype


def test_rows_loaders_equal_jax(disk):
    """The rows= reads of features (.feats.bin), labels and mask equal
    the JAX package's, and the whole reads; a bad range raises."""
    _, _, prefix = disk
    for rows in (None, (0, V), (5, 77), (250, 300)):
        np.testing.assert_array_equal(
            tgraph.load_features(prefix, V, F, rows=rows),
            jgraph.load_features(prefix, V, F, rows=rows))
        np.testing.assert_array_equal(
            tgraph.load_labels(prefix, V, C, rows=rows),
            jgraph.load_labels(prefix, V, C, rows=rows))
        np.testing.assert_array_equal(tgraph.load_mask(prefix, V, rows=rows),
                                      jgraph.load_mask(prefix, V, rows=rows))
    with pytest.raises(ValueError):
        tgraph.load_features(prefix, V, F, rows=(10, V + 1))


def test_save_dataset_writes_the_jax_bytes(disk, tmp_path):
    """save_dataset writes the JAX package's files byte for byte, and
    load_dataset reads them back."""
    jds, tds, prefix = disk
    mine = str(tmp_path / "syn")
    tgraph.save_dataset(tds, mine)
    for ext in (".add_self_edge.lux", ".feats.csv", ".feats.bin", ".label",
                ".mask"):
        with open(prefix + ext, "rb") as a, open(mine + ext, "rb") as b:
            assert a.read() == b.read(), ext
    back = tgraph.load_dataset(mine, F, C)
    np.testing.assert_array_equal(back.features, tds.features)
    np.testing.assert_array_equal(back.graph.col_idx, tds.graph.col_idx)


def test_file_source_matches_array_source_and_jax(disk):
    """FileSource against ArraySource and the JAX package's FileSource on
    every accessor; as_source passes a source through; the RowGraph is
    the graph's O(V) part."""
    jds, tds, prefix = disk
    fs, ars = FileSource(prefix, F, C), as_source(tds)
    jfs = jsource.FileSource(prefix, F, C)
    assert isinstance(ars, ArraySource) and as_source(fs) is fs
    assert (fs.num_nodes, fs.num_edges) == (ars.num_nodes, ars.num_edges) \
        == (jfs.num_nodes, jfs.num_edges)
    np.testing.assert_array_equal(fs.row_ptr(), ars.row_ptr())
    np.testing.assert_array_equal(fs.row_ptr(), jfs.row_ptr())
    for a, b in ((5, 50), (0, 1), (100, 2000)):
        np.testing.assert_array_equal(fs.col_slice(a, b), ars.col_slice(a, b))
        np.testing.assert_array_equal(fs.col_slice(a, b), jfs.col_slice(a, b))
    for get in ("features", "labels", "mask"):
        for lo, hi in ((10, 30), (0, V)):
            got = getattr(fs, get)(lo, hi)
            np.testing.assert_array_equal(got, getattr(ars, get)(lo, hi))
            np.testing.assert_array_equal(got, getattr(jfs, get)(lo, hi))
    rg = fs.graph
    assert isinstance(rg, RowGraph) and not hasattr(rg, "col_idx")
    assert (rg.num_nodes, rg.num_edges) == (V, tds.graph.num_edges)
    np.testing.assert_array_equal(rg.in_degree, tds.graph.in_degree)


@pytest.mark.parametrize("p", [0, 1, 3])
def test_partition_local_reads_touch_only_the_part(disk, monkeypatch, p):
    """The spy of tests/test_source.py on both packages: part p's column
    and feature reads stay inside its byte ranges (the O(V) row-offset
    section is the one global read), and the port reads exactly the
    ranges the JAX package reads."""
    _, tds, prefix = disk
    reads = {"port": [], "jax": []}

    def spy_on(mod, key):
        real = mod._read_slice

        def spy(f, offset, count, dtype):
            reads[key].append((os.path.basename(f.name), int(offset),
                               int(count) * np.dtype(dtype).itemsize))
            return real(f, offset, count, dtype)
        monkeypatch.setattr(mod, "_read_slice", spy)

    spy_on(tgraph, "port")
    spy_on(jgraph, "jax")
    fs, jfs = FileSource(prefix, F, C), jsource.FileSource(prefix, F, C)
    plan = partition_plan(fs.row_ptr(), 4)
    jplan = jpartition.partition_plan(jfs.row_ptr(), 4)
    assert [tuple(map(int, b)) for b in plan.bounds] == \
        [tuple(map(int, b)) for b in jplan.bounds]
    for key in reads:
        reads[key].clear()
    l, r = plan.bounds[p]
    e0, e1 = plan.edge_range(p)
    col = partition_col(plan, fs.col_slice, p)
    feats = fs.features(l, r + 1)
    jpartition.partition_col(jplan, jfs.col_slice, p)
    jfs.features(l, r + 1)
    assert reads["port"] == reads["jax"] and len(reads["port"]) == 2
    col_base = 12 + V * 8
    for name, off, nbytes in reads["port"]:
        lo_b, hi_b = ((col_base + e0 * 4, col_base + e1 * 4)
                      if name.endswith(".lux") else
                      (l * F * 4, (r + 1) * F * 4))
        assert lo_b <= off and off + nbytes <= hi_b, (name, off, nbytes)
    np.testing.assert_array_equal(col[:e1 - e0], tds.graph.col_idx[e0:e1])
    np.testing.assert_array_equal(feats, tds.features[l:r + 1])


def test_a_source_stands_in_only_where_it_can(disk):
    """The single-device Trainer holds the whole graph and refuses a
    DataSource; a source needs ``symmetric`` stated (its check reads
    every column); 'auto' resolves from a RowGraph without the
    block-dense probe."""
    _, tds, prefix = disk
    fs = FileSource(prefix, F, C)
    with pytest.raises(TypeError, match="DistributedTrainer"):
        Trainer(build_gcn([F, 8, C]), fs, TrainConfig(symmetric=True),
                device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        resolve_symmetric(fs, None)
    assert resolve_symmetric(fs, True) is True
    assert resolve_auto_impl_probed(fs.graph) == \
        resolve_auto_impl_probed(tds.graph)
