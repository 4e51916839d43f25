#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (roc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. card: needs CUDA; prints the card's name and power limit and sets
   full-fp32 matmuls;
2. build: compiles the kernels from roc_tpu_torch/kernels/csrc;
3. kernels: builds the 602-256-41 GCN's graph (V = 232,965, average
   degree ~493, Reddit's shape; synthetic, from a seed) and holds each
   CUDA kernel (K1, K2, K3 with its row_ptr pre-pass, K4) against its
   plain PyTorch version on the card, at the shapes the forward and
   backward give it (K3 and K4 at their default slice width) and on a
   small ragged case (K3 and K4 at every slice width), and times kernel,
   plain version, one PyTorch library call and the card's least time for
   the same work;
   race: every slice width of K3 and K4 (16, 32, 64 and unsliced) at
   F = 256 and F = 41 over the full graph, timed in turns, with its
   gather rate and HBM rate, and the fastest and the ties beside the
   default;
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
   epoch 9, and all four kernels launched;
7. train profile: 3 steady steps per kernel route under torch.profiler,
   device time by kernel group and the device's idle share.

Prints one JSON line per phase, the kernel table line
``{"kernels": [...]}`` (launches counted over the serve and train
slices), the card line, and as the last line
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
    for F in (37, 36):
        x = torch.from_numpy(rng.randn(n, F).astype(np.float32)).to(dev)
        s = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
        assert torch.equal(graphnorm.indegree_norm(x, deg),
                           graphnorm.indegree_norm_plain(x, deg)), F
        for act in ("none", "relu"):
            assert torch.equal(graphnorm.scale_act(x, s, act),
                               graphnorm.scale_act_plain(x, s, act)), F
        # K4 and K3 at every slice width: rtol 1e-5, atol 1e-5 * max|row|
        # (another summation order); the degree-0 row is 0; no atomics,
        # so two launches give the same bits
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
                ok, err = close_enough(torch, got, want, 1e-5,
                                       1e-5 * float(want.abs().max()))
                assert ok and not got[2].any(), (name, F, S, err)
                assert torch.equal(got, kern(S)), (name, F, S)
    torch.cuda.synchronize()
    return {"V": n, "widths": list(t.widths), "edges_padded":
            int(esrc.numel()), "F": [37, 36],
            "slice_cols": list(slicing.SLICE_COLS), "ok": True}


def kernel_checks(torch, dev, gctx, adj, num_edges, esrc, edst):
    """Each kernel against its plain version at the shapes the forward
    and backward give it, with times.  ``adj`` is the graph as a sparse
    CSR tensor, the input of K3's and K4's library yardstick
    ``torch.sparse.mm``; ``esrc``/``edst`` the padded edge list K3 reads.
    Returns the per-kernel table entries."""
    from roc_tpu_torch.kernels import ell_spmm, graphnorm, spmm
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    deg, d = gctx.in_degree, gctx.inv_sqrt_deg
    idx, rid = gctx.ell_idx, gctx.ell_row_id
    idx_entries = sum(int(a.numel()) for a in idx)
    bucket_rows = sum(int(a.numel()) for a in rid)
    padded_edges = int(esrc.numel())
    entries = {
        "indegree_norm": dict(source="roc_tpu_torch/kernels/csrc/graphnorm.cu",
                              replaces="roc_tpu/kernels/graphnorm.py:60"),
        "scale_act": dict(source="roc_tpu_torch/kernels/csrc/graphnorm.cu",
                          replaces="roc_tpu/kernels/graphnorm.py:103"),
        "csr_spmm": dict(source="roc_tpu_torch/kernels/csrc/spmm.cu",
                         replaces="roc_tpu/kernels/spmm.py:83"),
        "ell_aggregate": dict(source="roc_tpu_torch/kernels/csrc/ell_spmm.cu",
                              replaces="roc_tpu/kernels/ell_spmm.py:196"),
    }
    for e in entries.values():
        e.update(shapes=[], ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 library_ms=0.0, max_abs_err=0.0, _tb=0.0, _to=0.0)

    def add(name, shape, got, want, rtol, atol, fn, plain, lib, nbytes,
            nops, n):
        ok, err = close_enough(torch, got, want, rtol, atol)
        ms = time_ms(torch, fn, n)
        pms = time_ms(torch, plain, max(1, n // 4))
        lms = time_ms(torch, lib, n)
        b, by = bound_ms(nbytes, nops)
        row = dict(kernel=name, shape=shape, max_abs_err=err, rtol=rtol,
                   atol=atol, ms=ms, plain_ms=pms, library_ms=lms,
                   bound_ms=b, bound_by=by, ok=ok)
        log({"phase": "kernel", **row})
        if not ok:
            raise AssertionError(f"{name} {shape} disagrees with its plain "
                                 f"version: max_abs_err {err}")
        e = entries[name]
        e["shapes"].append(row)
        e["ms"] += ms
        e["plain_ms"] += pms
        e["library_ms"] += lms
        e["bound_ms"] += b
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["_tb"] += nbytes
        e["_to"] += nops

    # K3's row_ptr pre-pass against its plain version (torch.searchsorted
    # on the card): exact; timed alone here, inside K3's time below
    got = spmm.csr_row_ptr(edst, V)
    if not torch.equal(got, spmm.csr_row_ptr_plain(edst, V)):
        raise AssertionError("csr_row_ptr disagrees with searchsorted")
    entries["csr_spmm"]["row_ptr_ms"] = time_ms(
        torch, lambda: spmm.csr_row_ptr(edst, V), 20)
    del got

    # the forward's shapes: K1 and K2 at F = 256 (layer 1, K2 with the
    # folded relu) and F = 41 (layer 2, no activation); K3 and K4 at both
    # widths over the real edge list and buckets.  The backward runs the
    # same shapes (K2 with no activation).
    for F, act in ((256, "relu"), (41, "none")):
        x = torch.randn((V, F), generator=gen, device=dev)
        vf = V * F
        # K1: 0 ulp (same fp32 operations as the plain version)
        add("indegree_norm", [V, F],
            graphnorm.indegree_norm(x, deg),
            graphnorm.indegree_norm_plain(x, deg), 0.0, 0.0,
            lambda: graphnorm.indegree_norm(x, deg),
            lambda: graphnorm.indegree_norm_plain(x, deg),
            lambda: x * d[:, None],
            8 * vf + 4 * V, vf, 50)
        # K2: 0 ulp
        lib = ((lambda: torch.relu(x * d[:, None])) if act == "relu"
               else (lambda: x * d[:, None]))
        add("scale_act", [V, F, act],
            graphnorm.scale_act(x, d, act),
            graphnorm.scale_act_plain(x, d, act), 0.0, 0.0,
            lambda: graphnorm.scale_act(x, d, act),
            lambda: graphnorm.scale_act_plain(x, d, act), lib,
            8 * vf + 4 * V, vf * (2 if act == "relu" else 1), 50)
        # K4: rtol 1e-5, atol 1e-5 * max|row| (another summation order)
        want = ell_spmm.ell_aggregate_plain(x, idx, rid, V)
        got = ell_spmm.ell_aggregate(x, idx, rid, V)
        add("ell_aggregate", [V, F, list(a.shape[1] for a in idx),
                              f"slice_cols={ell_spmm.default_slice_cols(F)}"],
            got, want, 1e-5, 1e-5 * float(want.abs().max()),
            lambda: ell_spmm.ell_aggregate(x, idx, rid, V),
            lambda: ell_spmm.ell_aggregate_plain(x, idx, rid, V),
            lambda: torch.sparse.mm(adj, x),
            8 * vf + 4 * idx_entries + 4 * bucket_rows, num_edges * F, 5)
        # K3 over the padded edge list: the same tolerance (another
        # summation order); bytes: feats and out once, src and dst once
        want = spmm.csr_spmm_plain(x, esrc, edst, V)
        got = spmm.csr_spmm(x, esrc, edst, V)
        add("csr_spmm", [V, F, padded_edges,
                         f"slice_cols={spmm.default_slice_cols(F)}"],
            got, want, 1e-5, 1e-5 * float(want.abs().max()),
            lambda: spmm.csr_spmm(x, esrc, edst, V),
            lambda: spmm.csr_spmm_plain(x, esrc, edst, V),
            lambda: torch.sparse.mm(adj, x),
            8 * vf + 8 * padded_edges, num_edges * F, 5)
        del x, want, got
    for e in entries.values():
        e["bound_by"] = ("bytes" if e["_tb"] / HBM_BYTES_PER_S
                         >= e["_to"] / FP32_FLOPS else "operations")
        del e["_tb"], e["_to"]
    return entries


def race(torch, dev, gctx, num_edges, esrc, edst):
    """Every slice width of K4 and K3 at the layer widths F = 256 and
    F = 41 over the full graph, in turns in one process: the plain
    version, each instance, each instance again in reverse order, the
    plain version again (``ms`` is the mean of an instance's two
    readings).  Each instance is first held to the plain version (rtol
    1e-5, atol 1e-5 * max|row|) and launched twice for equal bits.
    Prints, per instance, the effective gather rate E * F * 4 / ms and
    the HBM bytes the schedule needs over ms: feats once per launch (K4:
    once per bucket), out once, the ids once per slice (K4: the bucket
    tables; K3: edge_src and row_ptr; the pre-pass's searches are not
    counted); and the fastest instance, the wrappers' default, and the
    ties: the instances whose gap to the fastest is no more than the
    spread of their own or the fastest's two readings.  Returns the
    records."""
    from roc_tpu_torch.kernels import ell_spmm, slicing, spmm
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    idx, rid = gctx.ell_idx, gctx.ell_row_id
    ell_ids = 4 * sum(int(a.numel()) for a in (*idx, *rid))
    csr_ids = 4 * int(esrc.numel()) + 8 * (V + 1)
    records = []
    for F in (256, 41):
        x = torch.randn((V, F), generator=gen, device=dev)
        fb = 4 * V * F
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
            atol = 1e-5 * float(want.abs().max())
            inst = {}
            for S in slicing.SLICE_COLS:
                got = kern(S)
                ok, err = close_enough(torch, got, want, 1e-5, atol)
                if not (ok and torch.equal(got, kern(S))):
                    raise AssertionError(f"{name} F={F} slice_cols={S}: "
                                         f"max_abs_err {err}, or two "
                                         f"launches differ")
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
                r["gather_tb_s"] = num_edges * F * 4 / r["ms"] / 1e9
                r["hbm_tb_s"] = r["hbm_bytes"] / r["ms"] / 1e9
            fastest = min(inst, key=lambda S: inst[S]["ms"])

            def spread(S):
                return abs(inst[S]["readings"][0] - inst[S]["readings"][1])
            rec = {"phase": "race", "kernel": name, "F": F,
                   "plain_ms": plain_ms, "instances": list(inst.values()),
                   "fastest": fastest, "default": mod.default_slice_cols(F),
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


def _trainer(ds, impl, dropout, params=None, **cfg):
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import TrainConfig, Trainer
    return Trainer(build_gcn(LAYERS, dropout_rate=dropout), ds,
                   TrainConfig(aggr_impl=impl, symmetric=True, seed=SEED,
                               **TRAIN, **cfg),
                   params=params)


def train_parity(torch, ds, params, steps=3):
    """From the same weights, dropout 0, ``steps`` steps through
    Trainer.train on each kernel route and on the plain 'ell' route on
    the card.  Each step's objective within rtol 1e-4 of the plain
    route's (fp32 sums in another order, compounded over the steps);
    the weights after the steps are reported, not gated: Adam moves a
    weight by ~lr whatever its gradient's size, so a near-zero gradient
    whose sign differs between two summation orders moves it 2 lr
    apart."""
    losses, weights, step_s = {}, {}, {}
    for impl in ("ell", "cuda", "cuda_csr"):
        tr = _trainer(ds, impl, 0.0, params=params,
                      eval_every=10 ** 6, verbose=False)
        t0 = time.perf_counter()
        tr.train(steps)
        tr.sync()
        step_s[impl] = (time.perf_counter() - t0) / steps
        losses[impl] = torch.stack(tr.losses).double().cpu().numpy()
        weights[impl] = {k: v.detach().clone() for k, v in tr.params.items()}
        del tr
        torch.cuda.empty_cache()
    out = {"steps": steps, "plain_losses": losses["ell"].tolist(),
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
        if not (np.isfinite(losses[impl]).all() and rel.max() <= 1e-4):
            raise AssertionError(f"{impl} losses {losses[impl]} differ from "
                                 f"the plain route's {losses['ell']}")
    return out


def train_slice(torch, ds):
    """10 epochs, dropout 0.5, an eval every 5, through Trainer on each
    kernel route (fresh Glorot weights from SEED).  Returns the phase
    record; raises on a non-finite loss or a train loss that did not
    fall from epoch 4 to epoch 9."""
    from roc_tpu_torch.train.trainer import format_metrics
    out = {}
    for impl in ("cuda", "cuda_csr"):
        t0 = time.perf_counter()
        tr = _trainer(ds, impl, 0.5, epochs=10, eval_every=5,
                      verbose=False)
        setup_s = time.perf_counter() - t0
        hist = tr.train()
        tr.sync()
        losses = torch.stack(tr.losses).double().cpu().numpy()
        lines = [format_metrics(m["epoch"], m) for m in hist]
        for ln in lines:
            print(ln, flush=True)
        out[impl] = {
            "setup_s": setup_s, "first_step_ms": hist[0]["first_step_ms"],
            "epoch_ms": [m["epoch_ms"] for m in hist],
            "eval_ms": [m["eval_ms"] for m in hist],
            "train_loss": [m["train_loss"] for m in hist],
            "objective": losses.tolist(), "infer": lines}
        if not np.isfinite(losses).all() or not all(
                np.isfinite(m["train_loss"]) for m in hist):
            raise AssertionError(f"{impl}: non-finite loss {losses}")
        if [m["epoch"] for m in hist] != [4, 9] or not (
                hist[1]["train_loss"] < hist[0]["train_loss"]):
            raise AssertionError(f"{impl}: train loss did not fall: "
                                 f"{lines}")
        del tr
        torch.cuda.empty_cache()
    return out


def _kernel_group(name):
    """The part of a training step a device kernel belongs to."""
    for group, keys in (("K3 csr_spmm", ("csr_row_sum", "csr_row_ptr")),
                        ("K4 ell_aggregate", ("ell_bucket_sum",)),
                        ("K1/K2 row scale", ("row_scale_",)),
                        ("matmul", ("gemm", "Gemm", "cutlass", "xmma"))):
        if any(k in name for k in keys):
            return group
    return "other (dropout, loss, Adam, copies)"


def train_profile(torch, ds, steps=3):
    """Where a steady training step's device time goes, per kernel
    route: ``steps`` steps (after 2 warm ones) under torch.profiler,
    kernel time summed by group, and the device's idle share of the
    host wall clock (1 - kernel time / wall).  Dropout 0.5, as in the
    train slice.  Reports "not measured" if the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for impl in ("cuda", "cuda_csr"):
        tr = _trainer(ds, impl, 0.5, eval_every=10 ** 6,
                      verbose=False)
        tr.train(2)
        tr.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train(steps)
            tr.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups, names = {}, {}
        for e in prof.key_averages():
            # the device's own kernel events only: a host op's device
            # time repeats that of the kernels it launched
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.device_time_total
            if us > 0:
                g = _kernel_group(e.key)
                groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
                names[e.key] = names.get(e.key, 0.0) + us / 1e3 / steps
        busy = sum(groups.values())
        rec = {"wall_ms_per_step": wall_ms / steps}
        if busy <= 0:
            rec["device"] = "not measured"
        else:
            rec.update(
                device_ms_per_step=busy, idle_share=1 - busy * steps / wall_ms,
                groups_ms_per_step=groups,
                group_share={g: v / busy for g, v in groups.items()},
                top_kernels_ms_per_step=sorted(
                    names.items(), key=lambda kv: -kv[1])[:8])
        out[impl] = rec
        del tr, prof
        torch.cuda.empty_cache()
    return out


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

    # 3. kernels
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
    adj = torch.sparse_csr_tensor(
        torch.from_numpy(g.row_ptr).to(dev),
        torch.from_numpy(g.col_idx.astype(np.int64)).to(dev),
        torch.ones(g.num_edges, device=dev), size=(V, V),
        check_invariants=False)
    esrc, edst = (torch.from_numpy(a).to(dev)
                  for a in padded_edge_list(g, multiple=512))
    entries = kernel_checks(torch, dev, gctx, adj, g.num_edges, esrc, edst)
    del adj
    torch.cuda.empty_cache()
    race(torch, dev, gctx, g.num_edges, esrc, edst)
    del esrc, edst
    torch.cuda.empty_cache()

    # 4. serve slice: the serving path, counts zeroed just before
    kernels = (graphnorm.indegree_norm, graphnorm.scale_act,
               spmm.csr_spmm, ell_spmm.ell_aggregate)
    for k in kernels:
        k.launches = 0
    lat, results = slice_run(torch, pred, Server)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    log({"phase": "slice", "requests": lat, "launches": launches})
    if not all(launches[k] for k in ("indegree_norm", "scale_act",
                                     "ell_aggregate")):
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    with torch.inference_mode():
        plain_ctx = dataclasses.replace(gctx, aggr_impl="ell")
        ref = pred.model.apply(pred.params, pred.published().table,
                               plain_ctx, train=False).cpu().numpy()
    scale = float(np.abs(ref).max())
    worst = 0.0
    row0 = None
    for ids, rows in results:
        rows = np.asarray(rows)
        assert rows.shape == (ids.size, LAYERS[-1]), rows.shape
        assert np.isfinite(rows).all()
        worst = max(worst, float(np.abs(rows - ref[ids]).max()))
        # id 0 rides in every request: coalesced or not, the same bits
        row0 = rows[0] if row0 is None else row0
        assert np.array_equal(rows[0], row0)
    # served logits vs the plain route on the card: fp32 sums in another
    # order, two layers deep -> rtol-style bound 1e-4 of the logit scale
    tol = 1e-4 * max(scale, 1.0)
    log({"phase": "check", "max_abs_err": worst, "atol": tol,
         "logit_scale": scale})
    if not worst <= tol:
        raise AssertionError(f"served logits differ from the plain route: "
                             f"{worst} > {tol}")
    del pred, gctx, plain_ctx, ref, results
    torch.cuda.empty_cache()

    # 5. train parity: kernel routes against the plain route on the card
    log({"phase": "train_parity", **train_parity(torch, ds, params)})

    # 6. train slice: the training path, counts zeroed just before
    for k in (*kernels, spmm.csr_row_ptr):
        k.launches = 0
    record = train_slice(torch, ds)
    torch.cuda.synchronize()
    train_launches = {k.__name__: k.launches for k in kernels}
    # K3's pre-pass runs once per main pass
    train_launches["csr_row_ptr"] = spmm.csr_row_ptr.launches
    # the kernels' share of a steady step, from the kernel phase's times:
    # each of the two layers runs its chain once forward, once backward
    chain = 2 * (entries["indegree_norm"]["ms"] + entries["scale_act"]["ms"])
    for impl, agg in (("cuda", "ell_aggregate"), ("cuda_csr", "csr_spmm")):
        steady = [ms for ms in record[impl]["epoch_ms"] if ms]
        step_ms = sum(steady) / len(steady)
        est = chain + 2 * entries[agg]["ms"]
        record[impl].update(kernel_ms_per_step_est=est,
                            kernel_share_est=est / step_ms,
                            aggregate_share_est=2 * entries[agg]["ms"]
                            / step_ms)
    log({"phase": "train_slice", **record, "launches": train_launches})
    if not all(train_launches.values()) or (
            train_launches["csr_row_ptr"] != train_launches["csr_spmm"]):
        raise AssertionError(f"a kernel of the training path never ran: "
                             f"{train_launches}")

    # 7. where a steady step's device time goes (after the counts are
    # read: these steps are not part of the counted run)
    log({"phase": "train_profile", **train_profile(torch, ds)})

    table = []
    for name, e in entries.items():
        table.append({"name": name, "route": "cuda", "source": e["source"],
                      "replaces": e["replaces"],
                      "launches": launches[name] + train_launches[name],
                      "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                      "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                      "bound_by": e["bound_by"],
                      "library_ms": e["library_ms"],
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
