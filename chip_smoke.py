#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (roc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. card: needs CUDA; prints the card's name and power limit and sets
   full-fp32 matmuls;
2. build: compiles the kernels from roc_tpu_torch/kernels/csrc;
3. kernels: builds the 602-256-41 GCN's graph (V = 232,965, average
   degree ~493, Reddit's shape; synthetic, from a seed) and holds each
   CUDA kernel (K1, its relu-masked form, K2, K3 with its row_ptr
   pre-pass, K4) against its plain PyTorch version on the card, at the
   shapes the forward and backward give it (K3 and K4 at their default
   slice width) and on a small ragged case (K3 and K4 at every slice
   width), and times kernel, plain version, one PyTorch library call (for
   the masked K1, the chain of calls the backward ran before it) and the
   card's least time for the same work: kernel and library call by CUDA
   events over back-to-back calls (``ms``, host cost included where it
   exceeds the device's) and by torch.profiler's device time
   (``device_ms``);
   race: every slice width of K3 and K4 (16, 32, 64, 128 and unsliced)
   at F = 256 and F = 41 over the full graph, timed in turns, with its
   gather rate and HBM rate, and the fastest and the ties beside the
   default; all of it again in bf16 (K1 and K2 bit for bit, K3 and K4
   within one bf16 ulp of each row's magnitude, every instance launched
   twice for equal bits);
4. slice (serve): serves ~8 requests across the buckets 1, 8, 64 and
   512 through Server on the kernel route, with the launch counters
   zeroed just before, checks that K1, K2 and K4 ran and that the served
   rows match the same forward on the plain route on the card;
5. train parity: from the same Glorot weights, dropout 0, 3 steps
   through Trainer on 'cuda', 'cuda_csr' and the plain 'ell' route;
   every step's loss within rtol 1e-4 of the plain route's, and the
   weights' max difference and share off by more than 1e-3 printed;
6. train slice: with the counters zeroed just before, 10 epochs with
   dropout 0.5 and an eval every 5 through Trainer on 'cuda' and on
   'cuda_csr'; losses finite, the train loss falling from epoch 4 to
   epoch 9, all four kernels launched, and the masked K1 in every run;
7. train profile: 3 steady steps per kernel route under torch.profiler,
   device time by kernel group, the device's idle share, and every
   kernel of the "other" group with its launches a step;
8. mixed precision, each path with the counters zeroed just before:
   ~8 requests through Server in 'mixed' (K1, K2 and K4 ran in bf16
   only; rows against the plain route in 'mixed' and the fp32 route),
   3 parity steps in 'mixed' on 'cuda', 'cuda_csr' and 'ell', 10 epochs
   in 'mixed' on 'cuda' and 'cuda_csr' and in 'bfloat16' on 'cuda'
   (every bf16 kernel ran, the train loss falls), and a 'mixed' profile;
9. dist_p1, the partitioned trainer (parallel/distributed.py) at world
   size 1 over NCCL in this process, in fp32 and in 'mixed': 3 parity
   steps from the same weights, dropout 0, on 'cuda' and 'cuda_csr', each
   objective within the parity tolerance of Trainer's on the same route;
   then, with the counters zeroed just before, 10 epochs with dropout 0.5
   on both routes (the train loss falls, every kernel of the dtype ran,
   the masked K1 too), ``epoch_ms`` beside Trainer's, and in fp32 the
   step profile of phase 7 (the collectives' device time in its own
   group);
10. dist_p2, two fresh rank processes on this one card over gloo (NCCL
   takes one rank per card), each holding one part of the edge-balanced
   split: K1/K2 on part_nodes rows, K3/K4 reading 2 * part_nodes gathered
   rows, checked against their plain versions at those shapes; 3 steps
   on 'cuda' in fp32 from the same weights, each objective within the
   fp32 parity tolerance of Trainer's, the logits after them within
   1e-4 * max|logit| of Trainer's; the bounds, part shapes, step wall ms
   and the share of it the step's collectives take when timed alone (two
   contexts time-slicing one card and gloo's host staging set that time:
   a layout check, not a speed number);
11. recovery, the checkpoint path (utils/checkpoint.py, resilience/):
   10 epochs with dropout 0.5 through Trainer.train, then from the same
   seed through train_with_recovery with an async keep-3 rotation
   saving every 2 epochs, on 'cuda' in fp32 and on 'cuda_csr' in
   'mixed': params, Adam state and every objective equal bit for bit;
   the kill drill in two fresh processes mapping the dataset from .npy
   (one killed by kill_in_async_save at epoch 4, leaving ck.4 a shard
   without a manifest; the identical job resumes from ck.2 with no
   corrupt_fallback and ends on the uninterrupted fp32 run's bits); the
   nan_grads drill on 'cuda_csr' (one retry, a finite loss); the final
   checkpoint's params (restore_params_only) served through Server,
   each row equal to Trainer.predict's bit for bit; per save block,
   write and commit ms and bytes, async and sync, the finite guard's
   ms, the checkpointed run's wall per steady epoch beside the plain
   run's (run first and again last) and beside rounds ending in the
   guard alone and in guard + snapshot, and the children's set-up;
   every kernel launched, with the counts zeroed before the fp32 path
   and again before the mixed one.

Prints one JSON line per phase, the kernel table line
``{"kernels": [...]}`` (one row per kernel and dtype, e.g.
``ell_aggregate[bf16]``, K1's masked form as ``indegree_norm_masked``;
launches counted over the serve, train and dist slices of that dtype), the
card line, and as the last line
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

V = 232_965          # Reddit's vertex count
# Reddit's average degree; the synthetic graph has E = 111,689,429 after
# dedupe, self edges included
AVG_DEGREE = 493
LAYERS = [602, 256, 41]
SEED = 0
# the reference's Reddit run (example_run.sh): lr, weight decay, lr decay
TRAIN = dict(learning_rate=0.01, weight_decay=1e-4, decay_rate=0.97)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
# the kernels of the path, their sources and the TPU kernels they replace
KERNELS = {
    "indegree_norm": ("roc_tpu_torch/kernels/csrc/graphnorm.cu",
                      "roc_tpu/kernels/graphnorm.py:60"),
    # K1's relu-masked form, the fused backward's pre-scale
    "indegree_norm_masked": ("roc_tpu_torch/kernels/csrc/graphnorm.cu",
                             "roc_tpu/kernels/graphnorm.py:60"),
    "scale_act": ("roc_tpu_torch/kernels/csrc/graphnorm.cu",
                  "roc_tpu/kernels/graphnorm.py:103"),
    "csr_spmm": ("roc_tpu_torch/kernels/csrc/spmm.cu",
                 "roc_tpu/kernels/spmm.py:83"),
    "ell_aggregate": ("roc_tpu_torch/kernels/csrc/ell_spmm.cu",
                      "roc_tpu/kernels/ell_spmm.py:196"),
}
# the launch counters' dtype keys (kernels/_build.py DTYPE_SUFFIX)
F32, BF16 = "f32", "bf16"


def log(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, n, warm=1):
    """Mean ms per call over ``n`` calls (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(torch, fn, n):
    """Device ms per call: the time of every kernel that ``n`` calls of
    ``fn`` launch (after a warm call), summed by torch.profiler, over
    ``n``; None where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / n if us > 0 else None


def bound_ms(nbytes, nops):
    """The card's least time: the larger of bytes over the memory rate
    and operations over the fp32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / FP32_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def close_enough(torch, got, want, rtol, atol):
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def bf16_row_ulp(torch, want):
    """One bf16 ulp of each row's magnitude max|row| (0 for a zero row),
    [rows, 1]: a bf16 sum is its fp32 sum rounded once, and two fp32
    sums a few fp32 ulps apart (another order) round to the same bf16
    value or to neighbours."""
    m = want.float().abs().amax(dim=1, keepdim=True)
    _, e = torch.frexp(m)
    return torch.where(m > 0, torch.ldexp(torch.ones_like(m), e - 8),
                       torch.zeros_like(m))


def within_row_ulp(torch, got, want):
    """``(ok, max_abs_err)``: every element within one bf16 ulp of its
    row's magnitude."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= bf16_row_ulp(torch, want)).all())
    return ok, float(err.max()) if err.numel() else 0.0


def sum_check(torch, got, want):
    """A neighbour sum against its plain version: fp32 within rtol 1e-5,
    atol 1e-5 * max|row| (another summation order); bf16 within one bf16
    ulp of the row's magnitude."""
    if want.dtype == torch.bfloat16:
        return within_row_ulp(torch, got, want)
    return close_enough(torch, got, want, 1e-5,
                        1e-5 * float(want.abs().max()))


def ragged_checks(torch, dev):
    """Small ragged case: unaligned V, a 2048-wide hub row (1500 edges,
    spanning several 512-edge chunks of the edge list), rows of degree 0,
    F that is and is not a multiple of 4; K3 and K4 at every slice
    width, each launched twice for equal bits, and K3's row_ptr pre-pass
    against the graph's own row_ptr."""
    from roc_tpu_torch.core.ell import ell_from_graph
    from roc_tpu_torch.core.graph import from_edge_list
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.kernels import ell_spmm, graphnorm, slicing, spmm
    rng = np.random.RandomState(1)
    n = 1003
    src = np.concatenate([rng.randint(0, n, 9000), rng.randint(0, n, 1500)])
    dst = np.concatenate([rng.randint(0, n, 9000), np.full(1500, 1)])
    keep = dst != 2
    g = from_edge_list(src[keep], dst[keep], n)
    t = ell_from_graph(g.row_ptr, g.col_idx, n)
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    deg = torch.from_numpy(g.in_degree).to(dev)
    esrc, edst = (torch.from_numpy(a).to(dev)
                  for a in padded_edge_list(g, multiple=512))
    # the pre-pass: the graph's row_ptr, the padding edges (on the last
    # row) ending that row's range at Ep
    want_ptr = g.row_ptr.copy()
    want_ptr[-1] = esrc.numel()
    assert np.array_equal(spmm.csr_row_ptr(edst, n).cpu().numpy(), want_ptr)
    cases = ((37, torch.float32), (36, torch.float32),
             (37, torch.bfloat16), (40, torch.bfloat16))
    for F, dt in cases:
        x = torch.from_numpy(rng.randn(n, F).astype(np.float32)).to(dev, dt)
        s = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
        assert torch.equal(graphnorm.indegree_norm(x, deg),
                           graphnorm.indegree_norm_plain(x, deg)), F
        for act in ("none", "relu"):
            assert torch.equal(graphnorm.scale_act(x, s, act),
                               graphnorm.scale_act_plain(x, s, act)), F
        # K4 and K3 at every slice width (sum_check: another summation
        # order); the degree-0 row is 0; no atomics, so two launches give
        # the same bits
        for name, kern, want in (
                ("ell_aggregate",
                 lambda S: ell_spmm.ell_aggregate(x, idx, rid, n,
                                                  slice_cols=S),
                 ell_spmm.ell_aggregate_plain(x, idx, rid, n)),
                ("csr_spmm",
                 lambda S: spmm.csr_spmm(x, esrc, edst, n, slice_cols=S),
                 spmm.csr_spmm_plain(x, esrc, edst, n))):
            for S in slicing.SLICE_COLS:
                got = kern(S)
                ok, err = sum_check(torch, got, want)
                assert ok and not got[2].any(), (name, F, dt, S, err)
                assert torch.equal(got, kern(S)), (name, F, dt, S)
    torch.cuda.synchronize()
    return {"V": n, "widths": list(t.widths), "edges_padded":
            int(esrc.numel()),
            "cases": [[F, str(dt).split(".")[-1]] for F, dt in cases],
            "slice_cols": list(slicing.SLICE_COLS), "ok": True}


def kernel_checks(torch, dev, gctx, adj, num_edges, esrc, edst, dtype):
    """Each kernel in ``dtype`` against its plain version at the shapes
    the forward and backward give it, with times.  ``adj`` is the graph
    as a sparse CSR tensor, the input of K3's and K4's library yardstick
    ``torch.sparse.mm``; ``esrc``/``edst`` the padded edge list K3 reads.
    K1 and K2 must be bit-equal; K3 and K4 pass :func:`sum_check`; every
    kernel gives the same bits on a second launch.  Returns the
    per-kernel table entries."""
    from roc_tpu_torch.kernels import ell_spmm, graphnorm, spmm
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = dtype == torch.bfloat16
    esize = 2 if bf16 else 4
    deg, d = gctx.in_degree, gctx.inv_sqrt_deg
    d_lib = d.to(dtype)   # the library call's scale, in x's dtype
    idx, rid = gctx.ell_idx, gctx.ell_row_id
    idx_entries = sum(int(a.numel()) for a in idx)
    bucket_rows = sum(int(a.numel()) for a in rid)
    padded_edges = int(esrc.numel())
    entries = {name: dict(source=src, replaces=rep)
               for name, (src, rep) in KERNELS.items()}
    for e in entries.values():
        e.update(shapes=[], ms=0.0, device_ms=0.0, plain_ms=0.0,
                 bound_ms=0.0, library_ms=0.0, max_abs_err=0.0, _tb=0.0,
                 _to=0.0)

    def library_call(fn):
        """``fn`` if PyTorch on this card runs it, else None (then the
        kernel's library_ms is null and the reason is logged)."""
        try:
            fn()
            torch.cuda.synchronize()
            return fn
        except RuntimeError as err:
            log({"phase": "kernel", "library_unsupported": str(err)[:300],
                 "dtype": str(dtype)})
            return None

    def add(name, shape, check, fn, plain, lib, nbytes, nops, n,
            lib_call="torch.sparse.mm(adj, x)", copy=None):
        """``copy``: a copy of the same bytes (``out.copy_(x)``), whose
        device time is the streaming rate PyTorch itself reaches."""
        ok, err = check
        ms = time_ms(torch, fn, n)
        dms = device_ms(torch, fn, n)
        pms = time_ms(torch, plain, max(1, n // 4))
        lms = time_ms(torch, lib, n) if lib is not None else None
        ldms = device_ms(torch, lib, n) if lib is not None else None
        b, by = bound_ms(nbytes, nops)
        row = dict(kernel=name, dtype=str(dtype), shape=shape,
                   max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms,
                   library_ms=lms, library_device_ms=ldms,
                   library_call=lib_call, bound_ms=b, bound_by=by, ok=ok)
        if copy is not None:
            row["copy_device_ms"] = device_ms(torch, copy, n)
        log({"phase": "kernel", **row})
        if not ok:
            raise AssertionError(f"{name} {dtype} {shape} disagrees with "
                                 f"its plain version: max_abs_err {err}")
        e = entries[name]
        e["shapes"].append(row)
        e["ms"] += ms
        e["device_ms"] = (None if dms is None or e["device_ms"] is None
                          else e["device_ms"] + dms)
        e["plain_ms"] += pms
        e["library_ms"] = (None if lms is None or e["library_ms"] is None
                           else e["library_ms"] + lms)
        e["bound_ms"] += b
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["_tb"] += nbytes
        e["_to"] += nops

    def exact(got, want):
        return bool(torch.equal(got, want)), float(
            (got.float() - want.float()).abs().max())

    def twice(kern):
        """The kernel's result, held to the same bits on a second
        launch."""
        got = kern()
        if not torch.equal(got, kern()):
            raise AssertionError(f"two launches differ in {dtype}")
        return got

    # K3's row_ptr pre-pass against its plain version (torch.searchsorted
    # on the card): exact; timed alone here, inside K3's time below
    if not bf16:
        got = spmm.csr_row_ptr(edst, V)
        if not torch.equal(got, spmm.csr_row_ptr_plain(edst, V)):
            raise AssertionError("csr_row_ptr disagrees with searchsorted")
        entries["csr_spmm"]["row_ptr_ms"] = time_ms(
            torch, lambda: spmm.csr_row_ptr(edst, V), 20)
        del got

    # the forward's shapes: K1 and K2 at F = 256 (layer 1, K2 with the
    # folded relu) and F = 41 (layer 2, no activation); K3 and K4 at both
    # widths over the real edge list and buckets.  The backward runs the
    # same shapes (K2 with no activation), and at F = 256 the masked K1
    # on the cotangent and the relu output.
    for F, act in ((256, "relu"), (41, "none")):
        x = torch.randn((V, F), generator=gen, device=dev).to(dtype)
        vf = V * F
        buf = torch.empty_like(x)
        # K1: 0 ulp (same fp32 operations and rounding as the plain
        # version)
        add("indegree_norm", [V, F],
            exact(twice(lambda: graphnorm.indegree_norm(x, deg)),
                  graphnorm.indegree_norm_plain(x, deg)),
            lambda: graphnorm.indegree_norm(x, deg),
            lambda: graphnorm.indegree_norm_plain(x, deg),
            lambda: x * d_lib[:, None],
            2 * esize * vf + 4 * V, vf, 50, lib_call="x * d[:, None]",
            copy=lambda: buf.copy_(x))
        # K2: 0 ulp
        lib = ((lambda: torch.relu(x * d_lib[:, None])) if act == "relu"
               else (lambda: x * d_lib[:, None]))
        add("scale_act", [V, F, act],
            exact(twice(lambda: graphnorm.scale_act(x, d, act)),
                  graphnorm.scale_act_plain(x, d, act)),
            lambda: graphnorm.scale_act(x, d, act),
            lambda: graphnorm.scale_act_plain(x, d, act), lib,
            2 * esize * vf + 4 * V, vf * (2 if act == "relu" else 1), 50,
            lib_call=("relu(x * d[:, None])" if act == "relu"
                      else "x * d[:, None]"), copy=lambda: buf.copy_(x))
        if act == "relu":
            # the masked K1 on a cotangent g and the relu output y: 0 ulp;
            # its yardstick is the chain of calls the backward ran before
            # it: mask, cast, multiply, then the scale
            g = torch.randn((V, F), generator=gen, device=dev).to(dtype)
            y = torch.relu(torch.randn((V, F), generator=gen,
                                       device=dev)).to(dtype)
            add("indegree_norm_masked", [V, F],
                exact(twice(lambda: graphnorm.indegree_norm(
                    g, deg, relu_out=y)),
                    graphnorm.indegree_norm_plain(g, deg, relu_out=y)),
                lambda: graphnorm.indegree_norm(g, deg, relu_out=y),
                lambda: graphnorm.indegree_norm_plain(g, deg, relu_out=y),
                lambda: (g * (y > 0).to(dtype)) * d_lib[:, None],
                3 * esize * vf + 4 * V, 2 * vf, 50,
                lib_call="chain of calls: (g * (y > 0).to(dtype)) * "
                         "d[:, None]")
            del g, y
        del buf
        # K4: sum_check (another summation order)
        want = ell_spmm.ell_aggregate_plain(x, idx, rid, V)
        got = twice(lambda: ell_spmm.ell_aggregate(x, idx, rid, V))
        add("ell_aggregate", [V, F, list(a.shape[1] for a in idx),
                              "slice_cols="
                              f"{ell_spmm.default_slice_cols(F, dtype)}"],
            sum_check(torch, got, want),
            lambda: ell_spmm.ell_aggregate(x, idx, rid, V),
            lambda: ell_spmm.ell_aggregate_plain(x, idx, rid, V),
            library_call(lambda: torch.sparse.mm(adj, x)),
            2 * esize * vf + 4 * idx_entries + 4 * bucket_rows,
            num_edges * F, 5)
        # K3 over the padded edge list: the same check; bytes: feats and
        # out once, src and dst once
        want = spmm.csr_spmm_plain(x, esrc, edst, V)
        got = twice(lambda: spmm.csr_spmm(x, esrc, edst, V))
        add("csr_spmm", [V, F, padded_edges,
                         f"slice_cols={spmm.default_slice_cols(F, dtype)}"],
            sum_check(torch, got, want),
            lambda: spmm.csr_spmm(x, esrc, edst, V),
            lambda: spmm.csr_spmm_plain(x, esrc, edst, V),
            library_call(lambda: torch.sparse.mm(adj, x)),
            2 * esize * vf + 8 * padded_edges, num_edges * F, 5)
        del x, want, got
    for e in entries.values():
        e["bound_by"] = ("bytes" if e["_tb"] / HBM_BYTES_PER_S
                         >= e["_to"] / FP32_FLOPS else "operations")
        del e["_tb"], e["_to"]
    return entries


def race(torch, dev, gctx, num_edges, esrc, edst, dtype):
    """Every slice width of K4 and K3 in ``dtype`` at the layer widths
    F = 256 and F = 41 over the full graph, in turns in one process: the
    plain version, each instance, each instance again in reverse order,
    the plain version again (``ms`` is the mean of an instance's two
    readings).  Each instance is first held to the plain version
    (:func:`sum_check`) and launched twice for equal bits.  Prints, per
    instance, the effective gather rate E * F * itemsize / ms and the
    HBM bytes the schedule needs over ms: feats once per launch (K4:
    once per bucket), out once, the ids once per slice (K4: the bucket
    tables; K3: edge_src and row_ptr; the pre-pass's searches are not
    counted); and the fastest instance, the wrappers' default, and the
    ties: the instances whose gap to the fastest is no more than the
    spread of their own or the fastest's two readings.  Returns the
    records."""
    from roc_tpu_torch.kernels import ell_spmm, slicing, spmm
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    esize = 2 if dtype == torch.bfloat16 else 4
    idx, rid = gctx.ell_idx, gctx.ell_row_id
    ell_ids = 4 * sum(int(a.numel()) for a in (*idx, *rid))
    csr_ids = 4 * int(esrc.numel()) + 8 * (V + 1)
    records = []
    for F in (256, 41):
        x = torch.randn((V, F), generator=gen, device=dev).to(dtype)
        fb = esize * V * F
        n = 5 if F > slicing.NARROW_F else 10
        for name, mod, kern, plain, feats_reads, ids_bytes in (
                ("ell_aggregate", ell_spmm,
                 lambda S: ell_spmm.ell_aggregate(x, idx, rid, V,
                                                  slice_cols=S),
                 lambda: ell_spmm.ell_aggregate_plain(x, idx, rid, V),
                 len(idx), ell_ids),
                ("csr_spmm", spmm,
                 lambda S: spmm.csr_spmm(x, esrc, edst, V, slice_cols=S),
                 lambda: spmm.csr_spmm_plain(x, esrc, edst, V),
                 1, csr_ids)):
            want = plain()
            inst = {}
            for S in slicing.SLICE_COLS:
                got = kern(S)
                ok, err = sum_check(torch, got, want)
                if not (ok and torch.equal(got, kern(S))):
                    raise AssertionError(f"{name} {dtype} F={F} "
                                         f"slice_cols={S}: max_abs_err "
                                         f"{err}, or two launches differ")
                slices = -(-F // S) if S else 1
                inst[S] = {"slice_cols": S, "max_abs_err": err,
                           "hbm_bytes": fb * feats_reads + fb
                           + ids_bytes * slices, "readings": []}
                del got
            del want
            plain_ms = [time_ms(torch, plain, 1)]
            for S in (*slicing.SLICE_COLS, *reversed(slicing.SLICE_COLS)):
                inst[S]["readings"].append(
                    time_ms(torch, lambda: kern(S), n))
            plain_ms.append(time_ms(torch, plain, 1))
            for r in inst.values():
                r["ms"] = sum(r["readings"]) / len(r["readings"])
                r["gather_tb_s"] = num_edges * F * esize / r["ms"] / 1e9
                r["hbm_tb_s"] = r["hbm_bytes"] / r["ms"] / 1e9
            fastest = min(inst, key=lambda S: inst[S]["ms"])

            def spread(S):
                return abs(inst[S]["readings"][0] - inst[S]["readings"][1])
            rec = {"phase": "race", "kernel": name, "dtype": str(dtype),
                   "F": F, "plain_ms": plain_ms,
                   "instances": list(inst.values()), "fastest": fastest,
                   "default": mod.default_slice_cols(F, dtype),
                   "ties": [S for S in inst if inst[S]["ms"]
                            - inst[fastest]["ms"]
                            <= max(spread(S), spread(fastest))]}
            log(rec)
            records.append(rec)
        del x
    torch.cuda.synchronize()
    return records


def slice_run(torch, pred, server_cls):
    """~8 requests across the buckets through Server: four one after
    another (1, 8, 64, 512 rows), then four submitted together."""
    rng = np.random.RandomState(SEED + 2)
    lat, results = [], []
    with server_cls(pred, max_wait_ms=2.0, name="chip_smoke") as srv:
        for n in (1, 8, 64, 512):
            ids = rng.randint(0, V, size=n)
            ids[0] = 0
            t0 = time.perf_counter()
            rows = srv.submit(ids).result(timeout=300)
            lat.append({"rows": n, "ms": (time.perf_counter() - t0) * 1e3,
                        "concurrent": False})
            results.append((ids, rows))
        batch = [rng.randint(0, V, size=n) for n in (1, 5, 30, 200)]
        for ids in batch:
            ids[0] = 0
        t0 = time.perf_counter()
        futs = [srv.submit(ids) for ids in batch]
        for ids, f in zip(batch, futs):
            rows = f.result(timeout=300)
            lat.append({"rows": int(ids.size),
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "concurrent": True})
            results.append((ids, rows))
    return lat, results


def _trainer(ds, impl, dropout, params=None, mode="float32", **cfg):
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                             resolve_dtypes)
    dtype, compute_dtype = resolve_dtypes(mode)
    return Trainer(build_gcn(LAYERS, dropout_rate=dropout), ds,
                   TrainConfig(aggr_impl=impl, symmetric=True, seed=SEED,
                               dtype=dtype, compute_dtype=compute_dtype,
                               **TRAIN, **cfg),
                   params=params)


# Each parity step's objective against the plain route's, per dtype mode:
# fp32 sums in another order, compounded over the steps (float32); bf16
# activations rounded at other places (K1 scales by the fp32 d, the plain
# route by d rounded to bf16; rel. 2^-9 a rounding) through two layers,
# and after the first step weights up to ~2 lr apart where a near-zero
# gradient's sign differs between the routes (mixed).
PARITY_RTOL = {"float32": 1e-4, "mixed": 2e-2}


def train_parity(torch, ds, params, mode="float32", steps=3):
    """From the same weights, dropout 0, ``steps`` steps through
    Trainer.train in dtype ``mode`` on each kernel route and on the
    plain 'ell' route on the card.  Each step's objective within
    ``PARITY_RTOL[mode]`` of the plain route's; the weights after the
    steps are reported, not gated: Adam moves a weight by ~lr whatever
    its gradient's size, so a near-zero gradient whose sign differs
    between two summation orders moves it 2 lr apart.  The weights stay
    fp32 in both modes, and in 'mixed' ``feats`` is bf16.  Returns the
    record and the 'cuda' route's logits after the steps (fp32 numpy),
    the yardsticks of the partitioned runs."""
    rtol = PARITY_RTOL[mode]
    losses, weights, step_s = {}, {}, {}
    logits = None
    for impl in ("ell", "cuda", "cuda_csr"):
        tr = _trainer(ds, impl, 0.0, params=params, mode=mode,
                      eval_every=10 ** 6, verbose=False)
        if any(p.dtype != torch.float32 for p in tr.params.values()) or (
                mode == "mixed" and tr.feats.dtype != torch.bfloat16):
            raise AssertionError(f"{impl} {mode}: params "
                                 f"{[p.dtype for p in tr.params.values()]}"
                                 f", feats {tr.feats.dtype}")
        t0 = time.perf_counter()
        tr.train(steps)
        tr.sync()
        step_s[impl] = (time.perf_counter() - t0) / steps
        losses[impl] = torch.stack(tr.losses).double().cpu().numpy()
        weights[impl] = {k: v.detach().clone() for k, v in tr.params.items()}
        if impl == "cuda":
            logits = tr.predict().float().cpu().numpy()
        del tr
        torch.cuda.empty_cache()
    out = {"mode": mode, "steps": steps, "rtol": rtol,
           "plain_losses": losses["ell"].tolist(),
           "plain_step_s": step_s["ell"]}
    for impl in ("cuda", "cuda_csr"):
        rel = np.abs(losses[impl] - losses["ell"]) / np.abs(losses["ell"])
        diffs = [(weights[impl][k] - weights["ell"][k]).abs()
                 for k in weights["ell"]]
        n = sum(int(t.numel()) for t in diffs)
        out[impl] = {
            "losses": losses[impl].tolist(), "max_rel_loss_err":
            float(rel.max()), "step_s": step_s[impl],
            "max_weight_diff": max(float(t.max()) for t in diffs),
            "share_weights_off_1e-3":
            sum(int((t > 1e-3).sum()) for t in diffs) / n}
        if not (np.isfinite(losses[impl]).all() and rel.max() <= rtol):
            raise AssertionError(f"{impl} losses {losses[impl]} differ from "
                                 f"the plain route's {losses['ell']}")
    return out, logits


def train_slice(torch, ds, runs, make=None):
    """10 epochs, dropout 0.5, an eval every 5, through Trainer (or the
    trainer ``make`` builds, :func:`_dist_trainer`) for each ``(kernel
    route, dtype mode)`` of ``runs`` (fresh Glorot weights from SEED).
    Returns the phase record, keyed by route (float32) or route/mode;
    raises on a non-finite loss or a train loss that did not fall from
    epoch 4 to epoch 9."""
    from roc_tpu_torch.kernels.graphnorm import indegree_norm
    from roc_tpu_torch.train.trainer import format_metrics
    out = {}
    for impl, mode in runs:
        key = impl if mode == "float32" else f"{impl}/{mode}"
        t0 = time.perf_counter()
        tr = (make or _trainer)(ds, impl, 0.5, mode=mode, epochs=10,
                                eval_every=5, verbose=False)
        setup_s = time.perf_counter() - t0
        masked = indegree_norm.masked_launches
        hist = tr.train()
        tr.sync()
        masked = indegree_norm.masked_launches - masked
        losses = torch.stack(tr.losses).double().cpu().numpy()
        lines = [format_metrics(m["epoch"], m) for m in hist]
        for ln in lines:
            print(ln, flush=True)
        out[key] = {
            "setup_s": setup_s, "first_step_ms": hist[0]["first_step_ms"],
            "epoch_ms": [m["epoch_ms"] for m in hist],
            "eval_ms": [m["eval_ms"] for m in hist],
            "train_loss": [m["train_loss"] for m in hist],
            "objective": losses.tolist(), "infer": lines,
            "masked_k1_launches": masked}
        if not masked:
            raise AssertionError(f"{key}: the relu backward never ran the "
                                 f"masked K1")
        if not np.isfinite(losses).all() or not all(
                np.isfinite(m["train_loss"]) for m in hist):
            raise AssertionError(f"{key}: non-finite loss {losses}")
        if [m["epoch"] for m in hist] != [4, 9] or not (
                hist[1]["train_loss"] < hist[0]["train_loss"]):
            raise AssertionError(f"{key}: train loss did not fall: "
                                 f"{lines}")
        del tr
        torch.cuda.empty_cache()
    return out


def _kernel_group(name):
    """The part of a training step a device kernel belongs to."""
    for group, keys in (("K3 csr_spmm", ("csr_row_sum", "csr_row_ptr")),
                        ("K4 ell_aggregate", ("ell_bucket_sum",)),
                        ("K1/K2 row scale", ("row_scale_",)),
                        ("matmul", ("gemm", "Gemm", "cutlass", "xmma")),
                        ("collectives, device copies", ("nccl", "Memcpy"))):
        if any(k in name for k in keys):
            return group
    return "other (dropout, loss, Adam, copies)"


def train_profile(torch, ds, mode="float32", steps=3, make=None):
    """Where a steady training step's device time goes, per kernel
    route, in dtype ``mode``: ``steps`` steps (after 2 warm ones, and
    one more under a first profiler session whose trace is discarded and
    whose wall clock is reported as ``warm_profiled_step_ms``) of
    Trainer (or the trainer ``make`` builds) under torch.profiler, kernel
    time summed by group, and the device's idle share of the host wall
    clock (1 - kernel time / wall).  Dropout 0.5, as in the train slice.
    Reports "not measured" if the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"mode": mode}
    for impl in ("cuda", "cuda_csr"):
        tr = (make or _trainer)(ds, impl, 0.5, mode=mode,
                                eval_every=10 ** 6, verbose=False)
        tr.train(2)
        tr.sync()
        with profile(activities=activities):
            t0 = time.perf_counter()
            tr.train(1)
            tr.sync()
            warm_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            tr.train(steps)
            tr.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups, names, other = {}, {}, {}
        for e in prof.key_averages():
            # the device's own kernel events only: a host op's device
            # time repeats that of the kernels it launched, and so does
            # the device-side range of an NCCL call ("nccl:...") that of
            # the copies or kernels it issued
            if e.device_type != torch.autograd.DeviceType.CUDA or \
                    e.key.startswith("nccl:"):
                continue
            us = e.device_time_total
            if us > 0:
                g = _kernel_group(e.key)
                groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
                names[e.key] = names.get(e.key, 0.0) + us / 1e3 / steps
                if g.startswith("other"):
                    # every kernel of the group, with its launches a step
                    other[e.key[:160]] = [us / 1e3 / steps,
                                          e.count / steps]
        busy = sum(groups.values())
        rec = {"wall_ms_per_step": wall_ms / steps,
               "warm_profiled_step_ms": warm_ms}
        if busy <= 0:
            rec["device"] = "not measured"
        else:
            rec.update(
                device_ms_per_step=busy, idle_share=1 - busy * steps / wall_ms,
                groups_ms_per_step=groups,
                group_share={g: v / busy for g, v in groups.items()},
                top_kernels_ms_per_step=sorted(
                    names.items(), key=lambda kv: -kv[1])[:8],
                other_kernels_ms_calls_per_step=sorted(
                    other.items(), key=lambda kv: -kv[1][0]))
        out[impl] = rec
        del tr, prof
        torch.cuda.empty_cache()
    return out


# Served logits against the plain 'ell' route in the same mode on the
# card, as a share of the logit scale: fp32 sums in another order, two
# layers deep (float32); bf16 activations rounded at other places (K1
# scales by the fp32 d, the plain route by d rounded to bf16; rel. 2^-9 a
# rounding) through two layers and two bf16 products (mixed).  And in
# mixed against the fp32 route: bf16 features, weights and activations.
SERVE_TOL = {"float32": 1e-4, "mixed": 3e-2}
SERVE_TOL_VS_FP32 = 5e-2


def serve_check(torch, pred, results, mode, fp32_ref=None):
    """The served rows against the plain 'ell' route in ``mode`` on the
    card (and, given ``fp32_ref``, the fp32 route's logits), finite, of
    the right shape, and the id-0 row the same bits in every request,
    coalesced or not.  Returns the plain route's logits (fp32 numpy)."""
    with torch.inference_mode():
        plain_ctx = dataclasses.replace(pred.gctx, aggr_impl="ell")
        ref = pred.model.apply(pred.params, pred.published().table,
                               plain_ctx, train=False).float().cpu().numpy()
    scale = float(np.abs(ref).max())
    worst = worst32 = 0.0
    row0 = None
    for ids, rows in results:
        rows = np.asarray(rows)
        assert rows.shape == (ids.size, LAYERS[-1]), rows.shape
        assert rows.dtype == np.float32 and np.isfinite(rows).all()
        worst = max(worst, float(np.abs(rows - ref[ids]).max()))
        if fp32_ref is not None:
            worst32 = max(worst32, float(np.abs(rows - fp32_ref[ids]).max()))
        # id 0 rides in every request: coalesced or not, the same bits
        row0 = rows[0] if row0 is None else row0
        assert np.array_equal(rows[0], row0)
    tol = SERVE_TOL[mode] * max(scale, 1.0)
    rec = {"phase": "check", "mode": mode, "max_abs_err": worst,
           "atol": tol, "logit_scale": scale}
    tol32 = None
    if fp32_ref is not None:
        tol32 = SERVE_TOL_VS_FP32 * max(float(np.abs(fp32_ref).max()), 1.0)
        rec.update(max_abs_err_vs_fp32=worst32, atol_vs_fp32=tol32)
    log(rec)
    if not worst <= tol:
        raise AssertionError(f"{mode} served logits differ from the plain "
                             f"route: {worst} > {tol}")
    if tol32 is not None and not worst32 <= tol32:
        raise AssertionError(f"{mode} served logits differ from the fp32 "
                             f"route: {worst32} > {tol32}")
    return ref


def kernel_share(record, entries):
    """The kernels' share of a steady step, from the kernel phase's times
    of the run's dtype: each of the two layers runs its chain once
    forward, once backward, the relu layer's (F = 256) backward with the
    masked K1."""
    k1 = entries["indegree_norm"]
    k1_256 = sum(r["ms"] for r in k1["shapes"] if r["shape"][1] == 256)
    chain = (2 * k1["ms"] - k1_256 + entries["indegree_norm_masked"]["ms"]
             + 2 * entries["scale_act"]["ms"])
    for key, rec in record.items():
        agg = "csr_spmm" if key.startswith("cuda_csr") else "ell_aggregate"
        steady = [ms for ms in rec["epoch_ms"] if ms]
        step_ms = sum(steady) / len(steady)
        est = chain + 2 * entries[agg]["ms"]
        rec.update(kernel_ms_per_step_est=est, kernel_share_est=est / step_ms,
                   aggregate_share_est=2 * entries[agg]["ms"] / step_ms)


def check_train_launches(launches, key):
    """Every kernel of the training path ran in dtype ``key`` and none in
    the other, the masked K1 included; K3's pre-pass once per main
    pass."""
    other = BF16 if key == F32 else F32
    by = {k: v for k, v in launches.items()
          if k not in ("csr_row_ptr", "indegree_norm_masked")}
    if not all(v[key] for v in by.values()) or any(
            v[other] for v in by.values()) or (
            not launches["indegree_norm_masked"]) or (
            launches["csr_row_ptr"] != by["csr_spmm"][key]):
        raise AssertionError(f"a {key} kernel of the training path never "
                             f"ran, or another dtype did: {launches}")


def _dist_trainer(ds, impl, dropout, params=None, mode="float32",
                  num_parts=1, device=None, **cfg):
    """:func:`_trainer`'s partitioned twin: DistributedTrainer over the
    default process group, whose world size is ``num_parts``."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import DistributedTrainer
    from roc_tpu_torch.train.trainer import TrainConfig, resolve_dtypes
    dtype, compute_dtype = resolve_dtypes(mode)
    return DistributedTrainer(
        build_gcn(LAYERS, dropout_rate=dropout), ds, num_parts,
        TrainConfig(aggr_impl=impl, symmetric=True, seed=SEED, dtype=dtype,
                    compute_dtype=compute_dtype, **TRAIN, **cfg),
        params=params, device=device)


def dist_parity(torch, ds, params, parity, mode, steps=3):
    """From the same weights, dropout 0, ``steps`` steps of
    DistributedTrainer (world size 1) on each kernel route in dtype
    ``mode``; each step's objective within ``PARITY_RTOL[mode]`` of
    Trainer's on the same route (``parity``, train_parity's record)."""
    rtol = PARITY_RTOL[mode]
    out = {"mode": mode, "steps": steps, "rtol": rtol}
    for impl in ("cuda", "cuda_csr"):
        t0 = time.perf_counter()
        tr = _dist_trainer(ds, impl, 0.0, params=params, mode=mode,
                           eval_every=10 ** 6, verbose=False)
        setup_s = time.perf_counter() - t0
        tr.train(steps)
        tr.sync()
        got = torch.stack(tr.losses).double().cpu().numpy()
        want = np.asarray(parity[impl]["losses"])
        rel = np.abs(got - want) / np.abs(want)
        out[impl] = {"setup_s": setup_s, "part_nodes": tr.plan.part_nodes,
                     "part_edges": tr.plan.part_edges,
                     "losses": got.tolist(), "trainer_losses": want.tolist(),
                     "max_rel_loss_err": float(rel.max())}
        if not (np.isfinite(got).all() and rel.max() <= rtol):
            raise AssertionError(f"partitioned {impl} {mode} losses {got} "
                                 f"differ from Trainer's {want}")
        del tr
        torch.cuda.empty_cache()
    return out


def _save_dataset(ds, path):
    """The dataset's arrays as .npy files under ``path``, for the rank
    processes of dist_p2 to map."""
    for name, arr in (("row_ptr", ds.graph.row_ptr),
                      ("col_idx", ds.graph.col_idx),
                      ("features", ds.features), ("labels", ds.labels),
                      ("mask", ds.mask)):
        np.save(f"{path}/{name}.npy", arr)


def _map_dataset(path, num_classes):
    from roc_tpu_torch.core.graph import Dataset, Graph

    def load(name):
        return np.load(f"{path}/{name}.npy", mmap_mode="r")
    return Dataset(Graph(load("row_ptr"), load("col_idx")), load("features"),
                   load("labels"), load("mask"), num_classes,
                   name="reddit_shape")


def rank_kernel_checks(torch, tr, ds):
    """This rank's kernels at the shapes of its part against their plain
    versions (the counts are zeroed after): K4, and K3 over the part's
    edge list, reading R = P * part_nodes gathered rows and writing
    part_nodes rows (:func:`sum_check`); K1, the masked K1 and K2 on
    part_nodes rows, bit for bit."""
    from roc_tpu_torch.kernels import ell_spmm, graphnorm, spmm
    from roc_tpu_torch.parallel.distributed import shard_dataset
    d, pn, R = tr.data, tr.plan.part_nodes, tr.plan.padded_num_nodes
    edges = shard_dataset(ds, tr.plan, tr.rank, tr.device,
                          aggr_impl="cuda_csr")
    gen = torch.Generator(device=tr.device).manual_seed(SEED + 7 + tr.rank)
    deg, scale = d.in_degree, tr.gctx.inv_sqrt_deg
    rows = []
    for F, act in ((256, "relu"), (41, "none")):
        x = torch.randn((R, F), generator=gen, device=tr.device)
        xl = x[:pn]
        y = torch.relu(torch.randn((pn, F), generator=gen,
                                   device=tr.device))
        for name, got, want, exact in (
                ("ell_aggregate",
                 ell_spmm.ell_aggregate(x, d.ell_idx, d.ell_row_id, pn),
                 ell_spmm.ell_aggregate_plain(x, d.ell_idx, d.ell_row_id,
                                              pn), False),
                ("csr_spmm",
                 spmm.csr_spmm(x, edges.edge_src, edges.edge_dst, pn),
                 spmm.csr_spmm_plain(x, edges.edge_src, edges.edge_dst, pn),
                 False),
                ("indegree_norm", graphnorm.indegree_norm(xl, deg),
                 graphnorm.indegree_norm_plain(xl, deg), True),
                ("indegree_norm_masked",
                 graphnorm.indegree_norm(xl, deg, relu_out=y),
                 graphnorm.indegree_norm_plain(xl, deg, relu_out=y), True),
                ("scale_act", graphnorm.scale_act(xl, scale, act),
                 graphnorm.scale_act_plain(xl, scale, act), True)):
            if exact:
                ok = bool(torch.equal(got, want))
                err = float((got - want).abs().max())
            else:
                ok, err = sum_check(torch, got, want)
            rows.append({"kernel": name, "F": F, "R": R, "rows": pn,
                         "max_abs_err": err, "ok": ok})
            if not ok:
                raise AssertionError(f"rank {tr.rank}: {name} at F={F}, "
                                     f"R={R}, {pn} rows: max_abs_err {err}")
        del x, xl, y
    del edges
    torch.cuda.synchronize()
    return rows


def time_collectives(torch, tr, n=3):
    """The collectives of one step timed alone, at the step's shapes and
    count (each synchronised, mean of ``n``): two all-gathers of
    ``[part_nodes, 256]`` and two of ``[part_nodes, 41]`` (forward and
    the backward's rerun) and one all-reduce of the gradients and the
    objective."""
    comm, pn = tr.comm, tr.plan.part_nodes
    x256 = torch.zeros((pn, 256), device=tr.device)
    x41 = torch.zeros((pn, 41), device=tr.device)
    flat = torch.zeros(sum(p.numel() for p in tr.params.values()) + 1,
                       device=tr.device)
    ms = {}
    for name, fn in (("all_gather_256", lambda: comm.all_gather(x256)),
                     ("all_gather_41", lambda: comm.all_gather(x41)),
                     ("all_reduce", lambda: comm.all_reduce(flat))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / n
    ms["per_step"] = (2 * ms["all_gather_256"] + 2 * ms["all_gather_41"]
                      + ms["all_reduce"])
    return ms


def dist_rank_job(data_dir, num_classes, params, steps):
    """One rank of dist_p2, in a spawned process on card 0: map the
    dataset, build its part (the 'cuda' route, fp32), check its kernels
    at the part's shapes, then, with the counts zeroed, ``steps`` steps
    from ``params`` (dropout 0), each synchronised; time the step's
    collectives alone; predict.  Returns its record (rank 0 with the
    logits)."""
    import torch
    from roc_tpu_torch.kernels import _build, ell_spmm, graphnorm, spmm
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    set_fp32_matmul_precision()
    t0 = time.perf_counter()
    ds = _map_dataset(data_dir, num_classes)
    tr = _dist_trainer(ds, "cuda", 0.0, num_parts=2, device=dev,
                       params={k: torch.from_numpy(v)
                               for k, v in params.items()},
                       eval_every=10 ** 6, verbose=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    checks = rank_kernel_checks(torch, tr, ds)
    kernels = (graphnorm.indegree_norm, graphnorm.scale_act, spmm.csr_spmm,
               ell_spmm.ell_aggregate)
    _build.zero_launches(*kernels)
    graphnorm.indegree_norm.masked_launches = 0
    step_ms = []
    for _ in range(steps):
        t = time.perf_counter()
        tr.train(1)
        tr.sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {k.__name__: dict(k.launches_by_dtype) for k in kernels}
    launches["indegree_norm_masked"] = graphnorm.indegree_norm.masked_launches
    coll = time_collectives(torch, tr)
    logits = tr.predict().float().cpu().numpy()
    plan = tr.plan
    return {"rank": tr.rank, "backend": tr.comm.backend,
            "bounds": [list(b) for b in plan.bounds],
            "part_nodes": plan.part_nodes, "part_edges": plan.part_edges,
            "real_nodes": plan.real_nodes.tolist(),
            "real_edges": plan.real_edges.tolist(), "setup_s": setup_s,
            "step_ms": step_ms,
            "losses": torch.stack(tr.losses).double().cpu().tolist(),
            "launches": launches, "collectives_ms": coll,
            "kernel_checks": checks,
            "logits": logits if tr.rank == 0 else None}


# dist_p2's logits against Trainer's on the card, as a share of the logit
# scale: fp32 sums in another order, two layers deep, after 3 steps
PREDICT_TOL = 1e-4


def dist_p2(torch, ds, params, parity, trainer_logits, steps=3):
    """Two fresh rank processes on card 0 over gloo (NCCL takes one rank
    per card), each holding one part of the edge-balanced split, the
    'cuda' route in fp32: ``steps`` steps from ``params`` with dropout 0,
    each step's objective within ``PARITY_RTOL['float32']`` of Trainer's
    (``parity``) and the logits after them within ``PREDICT_TOL`` of
    max|logit| of Trainer's (``trainer_logits``).  Returns the record and
    the ranks' launch counts."""
    import tempfile
    from roc_tpu_torch.parallel.distributed import run_ranks
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _save_dataset(ds, tmp)
        save_s = time.perf_counter() - t0
        ranks = run_ranks(dist_rank_job, 2, backend="gloo", timeout_s=900,
                          data_dir=tmp, num_classes=ds.num_classes,
                          params={k: v.detach().cpu().numpy()
                                  for k, v in params.items()},
                          steps=steps)
    wall_s = time.perf_counter() - t0
    rtol = PARITY_RTOL["float32"]
    want = np.asarray(parity["cuda"]["losses"])
    logits = ranks[0].pop("logits")
    ranks[1].pop("logits")
    scale = float(np.abs(trainer_logits).max())
    err = float(np.abs(logits - trainer_logits).max())
    out = {"save_s": save_s, "wall_s": wall_s, "ranks": ranks,
           "trainer_losses": want.tolist(), "rtol": rtol,
           "predict_max_abs_err": err,
           "predict_atol": PREDICT_TOL * max(scale, 1.0),
           "note": "two CUDA contexts time-slice one card and gloo stages "
                   "the collectives through the host: a layout check, "
                   "not a speed number"}
    for r in ranks:
        got = np.asarray(r["losses"])
        rel = np.abs(got - want) / np.abs(want)
        r["max_rel_loss_err"] = float(rel.max())
        steady = r["step_ms"][1:]
        r["steady_step_ms"] = sum(steady) / len(steady)
        r["collective_share"] = (r["collectives_ms"]["per_step"]
                                 / r["steady_step_ms"])
        if not (np.isfinite(got).all() and rel.max() <= rtol):
            raise AssertionError(f"rank {r['rank']}: partitioned losses "
                                 f"{got} differ from Trainer's {want}")
        by = r["launches"]
        if not (by["indegree_norm"][F32] and by["scale_act"][F32]
                and by["ell_aggregate"][F32] and by["indegree_norm_masked"]):
            raise AssertionError(f"rank {r['rank']}: a kernel of the path "
                                 f"never ran: {by}")
    if not (logits.shape == trainer_logits.shape and np.isfinite(
            logits).all() and err <= out["predict_atol"]):
        raise AssertionError(f"partitioned logits differ from Trainer's: "
                             f"{err} > {out['predict_atol']}")
    return out, [r["launches"] for r in ranks]


# ------------------------------------------------------------ 11. recovery

# the recovery runs: 10 epochs, dropout 0.5, an eval every 5, a
# checkpoint every 2 under a keep-3 rotation
RECOVERY_EPOCHS, CKPT_EVERY = 10, 2


def _state_diff(torch, a, b):
    """The names of the state leaves (params, Adam m and v, the step
    scalars, every step's objective) where trainers ``a`` and ``b``
    differ in a single bit."""
    bad = [f"{tree}[{k}]" for tree, x, y in (
        ("params", a.params, b.params), ("m", a.opt_state.m, b.opt_state.m),
        ("v", a.opt_state.v, b.opt_state.v))
        for k in x if not torch.equal(x[k], y[k])]
    for k in ("step", "beta1_t", "beta2_t"):
        if getattr(a.opt_state, k) != getattr(b.opt_state, k):
            bad.append(k)
    if not torch.equal(torch.stack(a.losses), torch.stack(b.losses)):
        bad.append("losses")
    return bad


def _steady_ms(wall_ms, tr):
    """Wall ms per epoch after the first step."""
    return (wall_ms - tr.first_step_ms) / (RECOVERY_EPOCHS - 1)


def _rounds(tr, at_boundary):
    """RECOVERY_EPOCHS epochs in rounds of CKPT_EVERY, ``at_boundary(tr)``
    after each round (train_with_recovery's structure, without it)."""
    hist = []
    while tr.epoch < RECOVERY_EPOCHS:
        hist += tr.train(CKPT_EVERY)
        at_boundary(tr)
    return hist


def recovery_pair(torch, ds, impl, mode, root):
    """``RECOVERY_EPOCHS`` epochs through Trainer.train, then from the
    same seed through train_with_recovery with an async rotation: the
    final params, Adam state and every objective must be equal bit for
    bit (saving must not perturb training).  To split what a save costs
    the step path, the same rounds run twice more without a rotation:
    ending in the finite guard alone (the drain of the launched steps)
    and in the guard and the host snapshot (the step path's whole share
    of an async save, the saver thread's writes left out), each held to
    the same bits.  The variants run in turns, the plain one first and
    again last; each overhead is against the mean of the two plain
    readings.  Returns the record, the first plain trainer and the
    rotation."""
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   check_params_finite,
                                                   train_with_recovery)
    from roc_tpu_torch.utils.checkpoint import snapshot_trainer

    def guard(tr):
        check_params_finite(tr.params, tr.opt_state)

    def snapshot(tr):
        guard(tr)
        snapshot_trainer(tr).wait()

    rot = CheckpointRotation(f"{root}/{impl}_{mode}/ck", keep=3,
                             async_save=True)
    variants = {
        "plain": lambda tr: tr.train(),
        "guard_only": lambda tr: _rounds(tr, guard),
        "snapshot_only": lambda tr: _rounds(tr, snapshot),
        "recovered": lambda tr: train_with_recovery(
            tr, RECOVERY_EPOCHS, rot, checkpoint_every=CKPT_EVERY),
        "plain_again": lambda tr: tr.train()}
    out = {"route": impl, "mode": mode}
    plain, bad = None, {}
    for name, run in variants.items():
        tr = _trainer(ds, impl, 0.5, mode=mode, epochs=RECOVERY_EPOCHS,
                      eval_every=5, verbose=False)
        tr.sync()
        t0 = time.perf_counter()
        hist = run(tr)
        tr.sync()
        wall = (time.perf_counter() - t0) * 1e3
        out[name] = {"wall_ms": wall, "steady_epoch_ms": _steady_ms(wall, tr),
                     "epoch_ms": [m["epoch_ms"] for m in hist],
                     "first_step_ms": tr.first_step_ms,
                     "train_loss": [m["train_loss"] for m in hist]}
        if plain is None:
            plain = tr
        else:
            bad[name] = _state_diff(torch, plain, tr)
            del tr
            torch.cuda.empty_cache()
    base = (out["plain"]["steady_epoch_ms"]
            + out["plain_again"]["steady_epoch_ms"]) / 2
    for name in ("guard_only", "snapshot_only", "recovered"):
        out[name]["overhead_share"] = out[name]["steady_epoch_ms"] / base - 1
    st = rot.save_stats()
    out["saves"] = [{k: s[k] for k in ("epoch", "block_ms", "write_ms",
                                        "commit_ms", "queued_ms", "bytes")}
                    for s in st["saves"]]
    out["superseded"] = st["superseded"]
    out["checkpoints"] = rot.existing()
    out["overhead_share"] = out["recovered"]["overhead_share"]
    out["bit_equal"] = not any(bad.values())
    # every save either committed or was superseded by a newer one while
    # the saver was busy (queue depth 1); the last one committed, and the
    # keep window holds
    ck = rot.existing()
    n_saves = RECOVERY_EPOCHS // CKPT_EVERY
    if any(bad.values()) or not ck or ck[-1] != RECOVERY_EPOCHS or \
            len(ck) > 3 or st["saved"] + st["superseded"] != n_saves:
        raise AssertionError(f"{impl} {mode}: a checkpointed run differs from "
                             f"the uninterrupted one at {bad}, or its "
                             f"checkpoints are {ck} after {st['saved']} saves "
                             f"and {st['superseded']} superseded")
    return out, plain, rot


def save_timings(torch, tr, root, n=3):
    """``n`` sync saves and ``n`` async saves of a trained trainer (each
    async one flushed), and the finite guard timed alone: after a sync,
    and right after a step was launched (then it waits for the step)."""
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   check_params_finite)
    keys = ("block_ms", "write_ms", "commit_ms", "save_ms", "bytes")
    out = {}
    for mode in ("sync", "async"):
        rot = CheckpointRotation(f"{root}/timing_{mode}/ck", keep=n + 1,
                                 async_save=mode == "async")
        calls = []
        for _ in range(n):
            tr.epoch += 1
            t0 = time.perf_counter()
            rot.save(tr)
            calls.append((time.perf_counter() - t0) * 1e3)
            rot.flush()
        rot.drain()
        out[mode] = {"call_ms": calls,
                     "saves": [{k: s[k] for k in keys}
                               for s in rot.save_stats()["saves"]]}
    guard = {"idle_ms": [], "after_step_ms": []}
    for _ in range(n):
        tr.sync()
        t0 = time.perf_counter()
        check_params_finite(tr.params, tr.opt_state)
        guard["idle_ms"].append((time.perf_counter() - t0) * 1e3)
        tr.train(1)
        t0 = time.perf_counter()
        check_params_finite(tr.params, tr.opt_state)
        guard["after_step_ms"].append((time.perf_counter() - t0) * 1e3)
    out["finite_guard"] = guard
    return out


def recovery_child(data_dir, num_classes, prefix, fault, out_path):
    """One recovery run in a fresh process on card 0 (phase 11's kill
    drill): map the dataset, build the 'cuda' fp32 trainer (dropout 0.5,
    ``fault`` armed), resume from the rotation at ``prefix`` and train
    to RECOVERY_EPOCHS; prints ``{"setup_s": ...}`` once set up, and
    saves the final state, the objectives, the epoch resumed from and
    the launch counts to ``out_path``."""
    import torch
    from roc_tpu_torch.kernels import _build, ell_spmm, graphnorm, spmm
    from roc_tpu_torch.obs import events
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   train_with_recovery)
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    events.configure(jsonl_path=f"{out_path}.events.jsonl")
    t0 = time.perf_counter()
    ds = _map_dataset(data_dir, num_classes)
    tr = _trainer(ds, "cuda", 0.5, epochs=RECOVERY_EPOCHS, eval_every=5,
                  verbose=False, fault=fault or None)
    tr.sync()
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    kernels = (graphnorm.indegree_norm, graphnorm.scale_act, spmm.csr_spmm,
               ell_spmm.ell_aggregate)
    _build.zero_launches(*kernels)
    graphnorm.indegree_norm.masked_launches = 0
    rot = CheckpointRotation(prefix, keep=3, async_save=True)
    resumed = rot.restore_latest(tr, only_if_ahead=True)
    train_with_recovery(tr, RECOVERY_EPOCHS, rot, checkpoint_every=CKPT_EVERY)
    tr.sync()
    launches = {k.__name__: dict(k.launches_by_dtype) for k in kernels}
    launches["indegree_norm_masked"] = graphnorm.indegree_norm.masked_launches
    np.savez(out_path, losses=torch.stack(tr.losses).double().cpu().numpy(),
             **{f"{t}.{k}": v.detach().cpu().numpy() for t, tree in (
                 ("params", tr.params), ("m", tr.opt_state.m),
                 ("v", tr.opt_state.v)) for k, v in tree.items()},
             scalars=np.asarray([tr.opt_state.step, tr.opt_state.beta1_t,
                                 tr.opt_state.beta2_t], np.float64),
             meta=np.frombuffer(json.dumps(
                 {"resumed_from": resumed, "launches": launches,
                  "epoch": tr.epoch}).encode(), np.uint8))


def _run_child(root, prefix, fault, tag):
    """:func:`recovery_child` in a fresh Python process; returns its exit
    code, its setup_s and its output file."""
    import os
    out = f"{root}/{tag}.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("ROC_TPU_FAULT", None)
    code = (f"import chip_smoke as s; s.recovery_child({root + '/data'!r}, "
            f"{LAYERS[-1]}, {prefix!r}, {fault!r}, {out!r})")
    r = subprocess.run([sys.executable, "-c", code], cwd=here, env=env,
                       capture_output=True, text=True, timeout=600)
    setup = [json.loads(ln)["setup_s"] for ln in r.stdout.splitlines()
             if ln.startswith('{"setup_s"')]
    return r, (setup[0] if setup else None), out


def kill_drill(torch, ds, root, want):
    """Child 1 runs the fp32 'cuda' recovery run with kill_in_async_save
    at epoch 4 and must die by SIGKILL, leaving ck.4 with a shard and no
    manifest and ck.2 committed; child 2 runs the identical job, resumes
    from ck.2 with no corrupt_fallback event, and must end on ``want``
    (the uninterrupted run's trainer) bit for bit.  Returns the record
    and child 2's launch counts."""
    import os
    import signal
    from roc_tpu_torch.utils.checkpoint import is_committed
    t0 = time.perf_counter()
    os.makedirs(f"{root}/data")
    _save_dataset(ds, f"{root}/data")
    out = {"save_s": time.perf_counter() - t0}
    prefix = f"{root}/drill/ck"
    os.makedirs(f"{root}/drill")
    r1, out["child1_setup_s"], _ = _run_child(root, prefix,
                                              "kill_in_async_save:4", "child1")
    out["child1_rc"] = r1.returncode
    ck4 = sorted(os.listdir(f"{prefix}.4")) if os.path.isdir(
        f"{prefix}.4") else None
    out["ck4_after_kill"] = ck4
    if r1.returncode != -signal.SIGKILL or ck4 != ["shard_00000.npz"] or \
            not is_committed(f"{prefix}.2"):
        raise AssertionError(f"kill drill: child 1 rc {r1.returncode}, ck.4 "
                             f"holds {ck4}, ck.2 committed "
                             f"{is_committed(prefix + '.2')}: "
                             f"{r1.stderr[-3000:]}")
    r2, out["child2_setup_s"], path = _run_child(root, prefix, "", "child2")
    out["child2_rc"] = r2.returncode
    if r2.returncode != 0:
        raise AssertionError(f"kill drill: child 2 failed: "
                             f"{r2.stderr[-3000:]}")
    got = np.load(path)
    meta = json.loads(bytes(got["meta"]))
    evs = [json.loads(ln) for ln in open(f"{path}.events.jsonl")]
    out.update(resumed_from=meta["resumed_from"], epoch=meta["epoch"],
               corrupt_fallbacks=sum(e.get("kind") == "corrupt_fallback"
                                     for e in evs))
    bad = [f"{t}.{k}" for t, tree in (("params", want.params),
                                      ("m", want.opt_state.m),
                                      ("v", want.opt_state.v))
           for k, v in tree.items()
           if not np.array_equal(got[f"{t}.{k}"], v.detach().cpu().numpy())]
    want_losses = torch.stack(want.losses).double().cpu().numpy()
    if not np.array_equal(got["losses"], want_losses[2:]):
        bad.append("losses")
    st = want.opt_state
    if not np.array_equal(got["scalars"], np.asarray(
            [st.step, st.beta1_t, st.beta2_t], np.float64)):
        bad.append("step scalars")
    out["bit_equal"] = not bad
    if bad or meta["resumed_from"] != 2 or out["corrupt_fallbacks"] or \
            meta["epoch"] != RECOVERY_EPOCHS:
        raise AssertionError(f"kill drill: child 2 resumed from "
                             f"{meta['resumed_from']}, "
                             f"{out['corrupt_fallbacks']} fallbacks, differs "
                             f"from the uninterrupted run at {bad}")
    return out, meta["launches"]


def nan_drill(torch, ds, root):
    """nan_grads:3 on 'cuda_csr' fp32 under a sync rotation: the save
    after epoch 3 refuses the poisoned state, the run restores epoch 2,
    retries once and ends with a finite loss."""
    from roc_tpu_torch.obs.events import get_bus
    from roc_tpu_torch.resilience import inject
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   train_with_recovery)
    tr = _trainer(ds, "cuda_csr", 0.5, epochs=6, eval_every=5, verbose=False,
                  fault="nan_grads:3")
    rot = CheckpointRotation(f"{root}/nan/ck", keep=3)
    bus = get_bus()
    n = len(bus.ring)
    try:
        hist = train_with_recovery(tr, 6, rot, checkpoint_every=CKPT_EVERY)
    finally:
        inject.disarm()
    recs = list(bus.ring)[n:]
    retries = [r["epoch"] for r in recs if r.get("kind") == "recovery"]
    faults = [r["site"] for r in recs if r.get("kind") == "fault"]
    final = float(tr.evaluate()["train_loss"])
    out = {"route": "cuda_csr", "retries_at_epoch": retries,
           "faults": faults, "final_train_loss": final,
           "evals": [[m["epoch"], m["train_loss"]] for m in hist],
           "checkpoints": rot.existing()}
    if retries != [4] or faults != ["nan_grads"] or not np.isfinite(final) \
            or tr.epoch != 6:
        raise AssertionError(f"nan_grads drill: {out}")
    del tr
    torch.cuda.empty_cache()
    return out


def serve_from_checkpoint(torch, ds, path, trainer):
    """The checkpoint's params (``restore_params_only``) served through
    build_predictor and Server on the trainer's route and dtype: ~8 ids
    in two requests, each row equal bit for bit to ``trainer.predict``'s
    row."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig
    from roc_tpu_torch.utils.checkpoint import restore_params_only
    params, fp, epoch = restore_params_only(path)
    pred = build_predictor(build_gcn(LAYERS), ds,
                           TrainConfig(aggr_impl=trainer.config.aggr_impl,
                                       symmetric=True, seed=SEED, **TRAIN),
                           params=params, backend="full")
    rng = np.random.RandomState(SEED + 11)
    reqs = [rng.randint(0, V, size=6), rng.randint(0, V, size=2)]
    with Server(pred, max_wait_ms=2.0, name="chip_smoke_ckpt") as srv:
        futs = [srv.submit(ids) for ids in reqs]
        rows = [f.result(timeout=300) for f in futs]
    equal = [bool(np.array_equal(r, trainer.predict(ids).float().cpu()
                                 .numpy())) for ids, r in zip(reqs, rows)]
    out = {"epoch": epoch, "ids": sum(int(ids.size) for ids in reqs),
           "rows_bit_equal": equal, "fingerprint": fp.get("strict")}
    del pred
    torch.cuda.empty_cache()
    if not all(equal) or epoch != RECOVERY_EPOCHS:
        raise AssertionError(f"served rows from the checkpoint differ from "
                             f"Trainer.predict's: {out}")
    return out


def recovery(torch, ds, zero_counts, read_counts):
    """Phase 11: the fp32 path (the 'cuda' pair, its save timings, the
    kill drill's children, the nan_grads drill on 'cuda_csr', serving
    from the checkpoint) with the counts zeroed before and read after,
    then the 'mixed' pair on 'cuda_csr' the same way.  Returns the
    record, the two reads and child 2's launches."""
    import os
    import tempfile
    rec = {}
    with tempfile.TemporaryDirectory() as root:
        # the fault sites' flight records go with the checkpoints
        os.environ["ROC_TPU_FLIGHT_DIR"] = root
        zero_counts()
        rec["cuda_fp32"], plain, rot = recovery_pair(torch, ds, "cuda",
                                                     "float32", root)
        rec["kill_drill"], child = kill_drill(torch, ds, root, plain)
        rec["nan_drill"] = nan_drill(torch, ds, root)
        rec["serve"] = serve_from_checkpoint(torch, ds, rot.path(10), plain)
        f32 = read_counts(F32)
        rec["save_timings"] = save_timings(torch, plain, root)
        del plain
        torch.cuda.empty_cache()
        zero_counts()
        rec["cuda_csr_mixed"], plain, _ = recovery_pair(torch, ds, "cuda_csr",
                                                        "mixed", root)
        bf16 = read_counts(BF16)
        del plain
        torch.cuda.empty_cache()
        os.environ.pop("ROC_TPU_FLIGHT_DIR")
    return rec, f32, bf16, child


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.kernels import _build, ell_spmm, graphnorm, spmm
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig

    # 1. card
    card = card_line()
    set_fp32_matmul_precision()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log({"phase": "card", "card": card, "kind": kind,
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda})

    # 2. build
    _build.library()
    ptxas = [ln.strip() for entry in _build.build_log
             for ln in entry.splitlines() if "registers" in ln
             or "spill" in ln]
    log({"phase": "build", "seconds": _build.build_seconds,
         "ptxas": ptxas})

    # 3. kernels, in fp32 and in bf16
    log({"phase": "ragged", **ragged_checks(torch, dev)})
    t0 = time.perf_counter()
    ds = synthetic_dataset(num_nodes=V, avg_degree=AVG_DEGREE,
                           in_dim=LAYERS[0], num_classes=LAYERS[-1],
                           seed=SEED, name="reddit_shape")
    t_data = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_gcn(LAYERS)
    params = model.init_params(gen, device=dev)
    t0 = time.perf_counter()
    pred = build_predictor(model, ds,
                           TrainConfig(aggr_impl="cuda", symmetric=True),
                           params=params, backend="full")
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    gctx = pred.gctx
    log({"phase": "data", "V": ds.graph.num_nodes,
         "E": ds.graph.num_edges, "in_dim": ds.in_dim,
         "classes": ds.num_classes, "dataset_s": t_data,
         "predictor_s": t_pred,
         "buckets": [list(a.shape) for a in gctx.ell_idx]})
    g = ds.graph

    def csr_adj(dtype):
        return torch.sparse_csr_tensor(
            torch.from_numpy(g.row_ptr).to(dev),
            torch.from_numpy(g.col_idx.astype(np.int64)).to(dev),
            torch.ones(g.num_edges, device=dev, dtype=dtype), size=(V, V),
            check_invariants=False)

    esrc, edst = (torch.from_numpy(a).to(dev)
                  for a in padded_edge_list(g, multiple=512))
    entries = {}
    for key, dtype in ((F32, torch.float32), (BF16, torch.bfloat16)):
        adj = csr_adj(dtype)
        entries[key] = kernel_checks(torch, dev, gctx, adj, g.num_edges,
                                     esrc, edst, dtype)
        del adj
        torch.cuda.empty_cache()
        race(torch, dev, gctx, g.num_edges, esrc, edst, dtype)
        torch.cuda.empty_cache()
    del esrc, edst
    torch.cuda.empty_cache()

    # every main path below is driven with the counts zeroed just before
    # and read just after; counted[dtype][kernel] sums the serve and
    # train slices' launches of that dtype.  The masked K1's launches
    # count in indegree_norm's and apart in masked_launches; the table
    # gives each form its own row, so a path of dtype ``key`` adds its
    # masked launches to "indegree_norm_masked", the rest to
    # "indegree_norm".
    kernels = (graphnorm.indegree_norm, graphnorm.scale_act,
               spmm.csr_spmm, ell_spmm.ell_aggregate)
    counted = {key: {name: 0 for name in KERNELS} for key in (F32, BF16)}

    def zero_counts():
        _build.zero_launches(*kernels)
        graphnorm.indegree_norm.masked_launches = 0
        spmm.csr_row_ptr.launches = 0

    def read_counts(key):
        torch.cuda.synchronize()
        got = {k.__name__: dict(k.launches_by_dtype) for k in kernels}
        masked = graphnorm.indegree_norm.masked_launches
        for name, by in got.items():
            for k in (F32, BF16):
                counted[k][name] += by[k]
        counted[key]["indegree_norm"] -= masked
        counted[key]["indegree_norm_masked"] += masked
        got["indegree_norm_masked"] = masked
        got["csr_row_ptr"] = spmm.csr_row_ptr.launches
        return got

    # 4. serve slice: the serving path, fp32
    zero_counts()
    lat, results = slice_run(torch, pred, Server)
    launches = read_counts(F32)
    log({"phase": "slice", "requests": lat, "launches": launches})
    if not all(launches[k][F32] for k in ("indegree_norm", "scale_act",
                                          "ell_aggregate")):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    ref = serve_check(torch, pred, results, "float32")
    del pred, gctx, results
    torch.cuda.empty_cache()

    # 5. train parity: kernel routes against the plain route on the card
    parity, logits32 = train_parity(torch, ds, params)
    log({"phase": "train_parity", **parity})

    # 6. train slice: the training path, fp32
    zero_counts()
    record32 = record = train_slice(torch, ds, (("cuda", "float32"),
                                                ("cuda_csr", "float32")))
    train_launches = read_counts(F32)
    kernel_share(record, entries[F32])
    log({"phase": "train_slice", **record, "launches": train_launches})
    check_train_launches(train_launches, F32)

    # 7. where a steady step's device time goes (after the counts are
    # read: these steps are not part of the counted run)
    log({"phase": "train_profile", **train_profile(torch, ds)})

    # 8. mixed precision: serve, parity, train slices, profile
    pred = build_predictor(model, ds,
                           TrainConfig(aggr_impl="cuda", symmetric=True,
                                       dtype=torch.float32,
                                       compute_dtype=torch.bfloat16),
                           params=params, backend="full")
    zero_counts()
    lat, results = slice_run(torch, pred, Server)
    launches = read_counts(BF16)
    log({"phase": "slice_mixed", "requests": lat, "launches": launches})
    if not all(launches[k][BF16] for k in ("indegree_norm", "scale_act",
                                           "ell_aggregate")) or any(
            by[F32] for k, by in launches.items()
            if k not in ("csr_row_ptr", "indegree_norm_masked")):
        raise AssertionError(f"the mixed serving path did not run the "
                             f"bf16 kernels alone: {launches}")
    serve_check(torch, pred, results, "mixed", fp32_ref=ref)
    del pred, results, ref
    torch.cuda.empty_cache()
    parity_mixed, _ = train_parity(torch, ds, params, mode="mixed")
    log({"phase": "train_parity_mixed", **parity_mixed})
    zero_counts()
    record = train_slice(torch, ds, (("cuda", "mixed"),
                                     ("cuda", "bfloat16"),
                                     ("cuda_csr", "mixed")))
    train_launches_bf16 = read_counts(BF16)
    kernel_share(record, entries[BF16])
    log({"phase": "train_slice_bf16", **record,
         "launches": train_launches_bf16})
    check_train_launches(train_launches_bf16, BF16)
    log({"phase": "train_profile_mixed",
         **train_profile(torch, ds, mode="mixed")})

    # 9. dist_p1: the partitioned trainer at world size 1 over NCCL, in
    # this process, each dtype's slice with the counts zeroed just before
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            for mode, key, par, ref in (
                    ("float32", F32, parity, record32),
                    ("mixed", BF16, parity_mixed, record)):
                rec = {"mode": mode,
                       "parity": dist_parity(torch, ds, params, par, mode)}
                zero_counts()
                rec["slice"] = train_slice(
                    torch, ds, (("cuda", mode), ("cuda_csr", mode)),
                    make=_dist_trainer)
                rec["launches"] = read_counts(key)
                check_train_launches(rec["launches"], key)
                if mode == "float32":
                    # where the partitioned step's extra time goes
                    rec["profile"] = train_profile(torch, ds,
                                                   make=_dist_trainer)
                for k, r in rec["slice"].items():
                    r["trainer_epoch_ms"] = ref[k]["epoch_ms"]
                log({"phase": "dist_p1", **rec})
        finally:
            dist.destroy_process_group()

    # 10. dist_p2: two ranks on this card over gloo; their launches count
    # with the fp32 paths'
    rec, rank_launches = dist_p2(torch, ds, params, parity, logits32)
    for by in rank_launches:
        for name in ("indegree_norm", "scale_act", "ell_aggregate",
                     "csr_spmm"):
            counted[F32][name] += by[name][F32]
        counted[F32]["indegree_norm"] -= by["indegree_norm_masked"]
        counted[F32]["indegree_norm_masked"] += by["indegree_norm_masked"]
    log({"phase": "dist_p2", **rec})

    # 11. recovery: checkpointed, killed and resumed runs; the fp32 path's
    # and the mixed path's launches each read just after the path, the
    # resumed child's count with the fp32 paths'
    rec, f32, bf16, child = recovery(torch, ds, zero_counts, read_counts)
    for name in ("indegree_norm", "scale_act", "ell_aggregate", "csr_spmm"):
        counted[F32][name] += child[name][F32]
    counted[F32]["indegree_norm"] -= child["indegree_norm_masked"]
    counted[F32]["indegree_norm_masked"] += child["indegree_norm_masked"]
    for key, got in ((F32, f32), (BF16, bf16)):
        if not (all(got[k][key] for k in ("indegree_norm", "scale_act",
                                           "csr_spmm")) and
                got["indegree_norm_masked"]) or (
                key == F32 and not got["ell_aggregate"][F32]):
            raise AssertionError(f"recovery: a {key} kernel of the path never "
                                 f"ran: {got}")
    rec["launches"] = {"float32": f32, "mixed": bf16, "child2": child}
    for tag in ("cuda_fp32", "cuda_csr_mixed"):
        r = rec[tag]
        log({"phase": "recovery_epoch_ms", "run": tag,
             **{f"{v}_steady_epoch_ms": r[v]["steady_epoch_ms"]
                for v in ("plain", "guard_only", "snapshot_only",
                          "recovered", "plain_again")},
             "overhead_share": r["overhead_share"],
             "plain_epoch_ms": r["plain"]["epoch_ms"],
             "recovered_epoch_ms": r["recovered"]["epoch_ms"],
             "async_saves": r["saves"]})
    log({"phase": "recovery_saves", **rec["save_timings"],
         "children_setup_s": [rec["kill_drill"]["child1_setup_s"],
                              rec["kill_drill"]["child2_setup_s"]]})
    log({"phase": "recovery", **rec})

    table = []
    for key, tag in ((F32, "fp32"), (BF16, "bf16")):
        for name, e in entries[key].items():
            table.append({
                "name": f"{name}[{tag}]", "route": "cuda",
                "source": e["source"], "replaces": e["replaces"],
                "launches": counted[key][name],
                "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "device_ms": e["device_ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                **({"row_ptr_ms": e["row_ptr_ms"]}
                   if "row_ptr_ms" in e else {}),
                "shapes": e["shapes"]})
    log({"total_s": time.perf_counter() - t_start,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    log({"kernels": table})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
