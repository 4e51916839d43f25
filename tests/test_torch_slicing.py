"""The column slices of the neighbour-sum kernels K3 and K4, and K3's
row_ptr pre-pass, on the CPU.

The slice width is a keyword of the wrappers (kernels/slicing.py); on the
CPU the wrappers run their plain versions, which have no slices, so these
tests hold the keyword's default and validation, and hold the wrappers at
every width to the JAX package's Pallas kernels in interpret mode on the
same inputs made with numpy.  The CUDA instances themselves are held to
the plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from roc_tpu.core.graph import from_edge_list as j_from_edge_list
from roc_tpu.core.partition import padded_edge_list as j_padded_edge_list
from roc_tpu.kernels.spmm import csr_spmm_pallas
from roc_tpu.kernels.ell_spmm import ell_aggregate_pallas
from roc_tpu.core.ell import ell_from_graph as j_ell_from_graph
from roc_tpu_torch.core.ell import ell_from_graph
from roc_tpu_torch.core.graph import from_edge_list
from roc_tpu_torch.core.partition import padded_edge_list
from roc_tpu_torch.kernels import ell_spmm, slicing, spmm

WRAPPERS = {"ell_aggregate": ell_spmm, "csr_spmm": spmm}


def _edges(V=300, seed=0):
    """Random edges, a hub row 1 of 200 extra edges, row 2 of degree 0."""
    rng = np.random.RandomState(seed)
    src = np.concatenate([rng.randint(0, V, 1500), rng.randint(0, V, 200)])
    dst = np.concatenate([rng.randint(0, V, 1500), np.full(200, 1)])
    keep = dst != 2
    return src[keep], dst[keep], V


def _sum_tol(want):
    """Another summation order than the Pallas kernels': fp32 agreement
    to rtol=1e-5, atol=1e-5 * max|row|."""
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name,wide", [("ell_aggregate", 32),
                                       ("csr_spmm", 64)])
@pytest.mark.parametrize("F", [1, 41, 64, 65, 256, 602])
def test_default_slice_cols_is_the_race_choice(name, wide, F):
    """Each kernel's default is a compiled width: unsliced (the F = 41
    winner) up to NARROW_F columns and for fp32 rows that are not whole
    8-byte units (odd F: 65), the kernel's F = 256 winner above (also at
    F = 602, rows of 8-byte units)."""
    got = WRAPPERS[name].default_slice_cols(F)
    assert got in slicing.SLICE_COLS
    assert got == (0 if F <= slicing.NARROW_F or F % 2 else wide)
    assert got == slicing.default_slice_cols(F, wide)


@pytest.mark.parametrize("name,wide", [("ell_aggregate", 64),
                                       ("csr_spmm", 128)])
@pytest.mark.parametrize("F", [41, 64, 65, 256, 260, 602])
def test_bf16_default_slice_cols_is_the_bf16_race_choice(name, wide, F):
    """In bf16 a slice of S columns holds the bytes of an fp32 slice of
    S / 2: the bf16 race's winners at F = 256 are 64 (K4) and 128 (K3),
    unsliced up to NARROW_F and for rows that are not whole 8-byte units
    (F not a multiple of 4: 65, 602) as in fp32; fp32 keeps its own."""
    mod = WRAPPERS[name]
    got = mod.default_slice_cols(F, torch.bfloat16)
    assert got in slicing.SLICE_COLS
    assert got == (0 if F <= slicing.NARROW_F or F % 4 else wide)
    assert mod.default_slice_cols(F, torch.float32) == \
        mod.default_slice_cols(F)


def test_resolve_takes_the_default_only_for_none():
    assert slicing.resolve("k", None, 64) == 64
    assert [slicing.resolve("k", S, 64) for S in slicing.SLICE_COLS] == list(
        slicing.SLICE_COLS)


@pytest.mark.parametrize("bad", [8, 5, -16, 256, True, 32.0, "32"])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_reject_slice_widths_with_no_instance(name, bad):
    """A width with no compiled instance raises, on the CPU as on the
    card, before anything runs."""
    src, dst, V = _edges()
    g = from_edge_list(src, dst, V)
    x = torch.ones(V, 8)
    with pytest.raises(ValueError, match="slice_cols"):
        if name == "ell_aggregate":
            t = ell_from_graph(g.row_ptr, g.col_idx, V)
            ell_spmm.ell_aggregate(
                x, tuple(torch.from_numpy(a[0]) for a in t.idx),
                tuple(torch.from_numpy(a[0]) for a in t.row_id), V,
                slice_cols=bad)
        else:
            es, ed = (torch.from_numpy(a) for a in padded_edge_list(g, 64))
            spmm.csr_spmm(x, es, ed, V, chunk=64, slice_cols=bad)


@pytest.mark.parametrize("S", [None, *slicing.SLICE_COLS])
def test_ell_aggregate_every_width_matches_pallas(S):
    """K4's wrapper at every slice width (the plain version on the CPU)
    against ell_aggregate_pallas in interpret mode; the degree-0 row is
    0."""
    src, dst, V = _edges(seed=1)
    F = 41
    g, jg = from_edge_list(src, dst, V), j_from_edge_list(src, dst, V)
    jt = j_ell_from_graph(jg.row_ptr, jg.col_idx, V)
    tt = ell_from_graph(g.row_ptr, g.col_idx, V)
    feats = np.zeros((V + 1, F), np.float32)
    feats[:V] = np.random.RandomState(2).randn(V, F)
    want = np.asarray(ell_aggregate_pallas(
        jnp.asarray(feats), tuple(jnp.asarray(a[0]) for a in jt.idx),
        jnp.asarray(jt.row_pos[0]), V, interpret=True))
    got = ell_spmm.ell_aggregate(
        torch.from_numpy(feats[:V]),
        tuple(torch.from_numpy(a[0]) for a in tt.idx),
        tuple(torch.from_numpy(a[0]) for a in tt.row_id), V, slice_cols=S)
    np.testing.assert_allclose(got.numpy(), want, **_sum_tol(want))
    assert not got[2].any()


@pytest.mark.parametrize("S", [None, *slicing.SLICE_COLS])
def test_csr_spmm_every_width_matches_pallas(S):
    """K3's wrapper at every slice width (the plain version on the CPU)
    against csr_spmm_pallas in interpret mode, over chunks of 64 edges;
    the hub row spans several chunks, the degree-0 row is 0."""
    src, dst, V = _edges(seed=3)
    F = 36
    g = from_edge_list(src, dst, V)
    es, ed = padded_edge_list(g, multiple=64)
    feats = np.zeros((V + 1, F), np.float32)
    feats[:V] = np.random.RandomState(4).randn(V, F)
    want = np.asarray(csr_spmm_pallas(jnp.asarray(feats), jnp.asarray(es),
                                      jnp.asarray(ed), V, chunk=64,
                                      interpret=True))
    got = spmm.csr_spmm(torch.from_numpy(feats[:V]), torch.from_numpy(es),
                        torch.from_numpy(ed), V, chunk=64, slice_cols=S)
    np.testing.assert_allclose(got.numpy(), want, **_sum_tol(want))
    assert not got[2].any()


def _wrapper_call(name, x, V, seed=0, **kw):
    """``name``'s wrapper on ``x`` over the ragged graph of seed
    ``seed`` (K4 on its ELL tables, K3 on its edge list padded to 64)."""
    src, dst, _ = _edges(V, seed=seed)
    g = from_edge_list(src, dst, V)
    if name == "ell_aggregate":
        t = ell_from_graph(g.row_ptr, g.col_idx, V)
        return ell_spmm.ell_aggregate(
            x, tuple(torch.from_numpy(a[0]) for a in t.idx),
            tuple(torch.from_numpy(a[0]) for a in t.row_id), V, **kw)
    es, ed = (torch.from_numpy(a) for a in padded_edge_list(g, 64))
    return spmm.csr_spmm(x, es, ed, V, chunk=64, **kw)


@pytest.mark.parametrize("F,dtype,code", [
    (66, torch.float32, {"csr_spmm": 64, "ell_aggregate": 32}),
    (67, torch.float32, {"csr_spmm": 0, "ell_aggregate": 0}),
    (41, torch.float32, {"csr_spmm": 0, "ell_aggregate": 0}),
    (66, torch.bfloat16, {"csr_spmm": 0, "ell_aggregate": 0}),
    (68, torch.bfloat16, {"csr_spmm": 128, "ell_aggregate": 64})])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_call_records_its_default_instance(name, F, dtype, code):
    """A call without slice_cols stands for the default instance of its
    shape, whatever its row count (the plain version records it on the
    CPU, as the kernel would launch it on the card): unsliced for rows
    that are not whole 8-byte units, the kernel's wide width else."""
    from roc_tpu_torch.kernels import _build
    S = code[name]
    assert WRAPPERS[name].default_slice_cols(F, dtype) == S
    sfx = _build.DTYPE_SUFFIX[dtype]
    for V in (300, 20):
        before = _build.instances_planned()
        _wrapper_call(name, torch.ones(V, F, dtype=dtype), V)
        got = _build.instances_since(before, _build.instances_planned())
        want = [f"{name}[{sfx}]@{F}/{S}"]
        if name == "csr_spmm":
            want.insert(0, "csr_row_ptr")
        assert got == want, got


@pytest.mark.parametrize("multiple", [1, 64, 512])
def test_csr_row_ptr_matches_jax_graph(multiple):
    """The pre-pass (its plain version on the CPU) over the padded edge
    list equals the JAX package's row_ptr of the same graph, except at
    the end: the padding edges sit on the last row, so its range ends at
    Ep."""
    src, dst, V = _edges(seed=5)
    jg = j_from_edge_list(src, dst, V)
    _, jd = j_padded_edge_list(jg, multiple=multiple)
    es, ed = padded_edge_list(from_edge_list(src, dst, V), multiple)
    assert np.array_equal(ed, jd)
    got = spmm.csr_row_ptr(torch.from_numpy(ed), V)
    assert got.dtype == torch.int64 and got.shape == (V + 1,)
    want = np.asarray(jg.row_ptr, np.int64).copy()
    want[-1] = jd.size
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] - got[2] == 0 and got[2] - got[1] >= 200


def test_csr_row_ptr_cpu_counts_no_launch_and_checks_shape():
    before = (spmm.csr_row_ptr.launches, spmm.csr_spmm.launches)
    ed = torch.tensor([0, 0, 2, 2, 2], dtype=torch.int32)
    np.testing.assert_array_equal(spmm.csr_row_ptr(ed, 3).numpy(),
                                  [0, 2, 2, 5])
    spmm.csr_spmm(torch.ones(3, 4), torch.zeros(5, dtype=torch.int32), ed,
                  3, chunk=5)
    assert (spmm.csr_row_ptr.launches, spmm.csr_spmm.launches) == before
    with pytest.raises(ValueError):
        spmm.csr_row_ptr(ed[None], 3)
