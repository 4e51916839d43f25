r"""Convert public graph datasets to the reference on-disk layout.

    python -m roc_tpu_torch.convert_dataset --dataset NAME --out PREFIX
        [--raw-dir DIR] [--no-csv]

The reference trains from ``<prefix>.add_self_edge.lux`` +
``.feats.csv``/``.feats.bin`` + ``.label`` + ``.mask`` files
(``load_task.cu:25-199``; canonical run ``example_run.sh:1`` uses
``dataset/reddit-dgl``).  This module produces that layout from the
standard public distributions:

  cora / citeseer / pubmed   Planetoid raw files (``ind.<name>.x`` ...
                             ``ind.<name>.test.index``) in --raw-dir —
                             the format shipped by the original GCN
                             release and every Planetoid mirror.
  reddit                     DGL's ``reddit_data.npz`` +
                             ``reddit_graph.npz`` in --raw-dir.
  ogbn-arxiv / ogbn-products OGB (requires the ``ogb`` package, which
                             downloads on first use).
  cora-synth                 No inputs: a deterministic Cora-shaped
                             synthetic citation graph (2708 nodes, 1433
                             sparse features, 7 classes, 140/500/1000
                             Planetoid-style split).  The offline
                             stand-in: it exercises the exact same file
                             path + CLI + convergence gate when the
                             real raw files are unavailable.
  karate                     No inputs: Zachary's karate club (34
                             members, the club's real split).

All graphs are symmetrized and given self edges (the reference's
``.add_self_edge`` convention, ``gnn.cc:756``).

The port's copy of the JAX package's ``scripts/convert_dataset.py``,
with its names, flags and output: every file it writes is byte for byte
the one that script writes from the same raw input (both go through
``save_dataset`` and the same edge ordering).  It imports numpy and
``roc_tpu_torch.core.graph`` alone (``pickle`` and ``scipy.sparse`` when
a raw format needs them): no torch, and nothing of the JAX package, so
it runs on a machine without JAX.

Example (the BASELINE.md config-1 run):
  python -m roc_tpu_torch.convert_dataset --dataset cora --raw-dir raw/ \
      --out data/cora
  python -m roc_tpu_torch.train.cli -file data/cora -layers 1433-16-7 \
      -lr 0.01 -decay 5e-4 -dropout 0.5 -e 200
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .core.graph import (MASK_NONE, MASK_TEST, MASK_TRAIN, MASK_VAL,
                         Dataset, add_self_edges, from_edge_list,
                         save_dataset)


# ---------------------------------------------------------------- planetoid

def convert_planetoid(raw_dir: str, name: str) -> Dataset:
    """Parse the Planetoid raw distribution (``ind.<name>.{x,y,tx,ty,
    allx,ally,graph,test.index}``) — pickled scipy matrices + an
    adjacency dict.  Includes the standard citeseer fix (isolated test
    nodes missing from ``test.index`` get zero rows)."""
    import pickle
    import scipy.sparse as sp

    def load(ext):
        path = os.path.join(raw_dir, f"ind.{name}.{ext}")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found — download the Planetoid raw files "
                f"for {name!r} into {raw_dir!r}")
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, y, tx, ty, allx, ally, graph = (
        load(e) for e in ("x", "y", "tx", "ty", "allx", "ally", "graph"))
    # tx/ty rows follow test.index's PERMUTED order; the reorder swap
    # below moves each row to its node id.  reorder = as-read ids,
    # range = sorted — keep BOTH distinct (overwriting reorder turns
    # the swap into a no-op and scrambles every test node).
    test_reorder = np.loadtxt(
        os.path.join(raw_dir, f"ind.{name}.test.index"), dtype=np.int64)
    test_range = np.sort(test_reorder)

    if name == "citeseer":
        # some test ids are missing (isolated vertices): extend tx/ty
        # onto the full contiguous range, placing real rows at their
        # sorted slots; gap nodes get zero features and NO test mask
        full = np.arange(test_range[0], test_range[-1] + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_range - test_range[0]] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]), dtype=ty.dtype)
        ty_ext[test_range - test_range[0]] = ty
        ty = ty_ext

    feats = sp.vstack((allx, tx)).tolil()
    feats[test_reorder] = feats[test_range]
    onehot = np.vstack((ally, ty))
    onehot[test_reorder] = onehot[test_range]
    labels = onehot.argmax(axis=1).astype(np.int32)

    num_nodes = feats.shape[0]
    src = np.fromiter((s for s, nbrs in graph.items() for _ in nbrs),
                      dtype=np.int64)
    dst = np.fromiter((d for _, nbrs in graph.items() for d in nbrs),
                      dtype=np.int64)
    keep = (src < num_nodes) & (dst < num_nodes)
    g = add_self_edges(from_edge_list(src[keep], dst[keep], num_nodes,
                                      symmetrize=True))

    mask = np.full(num_nodes, MASK_NONE, dtype=np.int32)
    mask[:y.shape[0]] = MASK_TRAIN                      # 140 for cora
    # next 500 after train, clipped to the allx region (val never
    # reaches into the test tail)
    mask[y.shape[0]:min(y.shape[0] + 500, ally.shape[0])] = MASK_VAL
    mask[test_reorder] = MASK_TEST  # only REAL test ids (1000 for
    #                                 cora; citeseer gap nodes stay None)
    return Dataset(graph=g,
                   features=np.asarray(feats.todense(), dtype=np.float32),
                   labels=labels, mask=mask,
                   num_classes=int(onehot.shape[1]), name=name)


# ---------------------------------------------------------------- reddit

def convert_dgl_reddit(raw_dir: str) -> Dataset:
    """Parse DGL's Reddit distribution: ``reddit_data.npz`` (feature /
    label / node_types where 1=train, 2=val, 3=test) and
    ``reddit_graph.npz`` (scipy sparse adjacency)."""
    import scipy.sparse as sp
    data_p = os.path.join(raw_dir, "reddit_data.npz")
    graph_p = os.path.join(raw_dir, "reddit_graph.npz")
    for p in (data_p, graph_p):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found — download DGL's Reddit files into "
                f"{raw_dir!r}")
    data = np.load(data_p)
    adj = sp.load_npz(graph_p).tocoo()
    num_nodes = data["feature"].shape[0]
    g = add_self_edges(from_edge_list(
        adj.row.astype(np.int64), adj.col.astype(np.int64), num_nodes,
        symmetrize=True))
    types = data["node_types"]
    mask = np.full(num_nodes, MASK_NONE, dtype=np.int32)
    mask[types == 1] = MASK_TRAIN
    mask[types == 2] = MASK_VAL
    mask[types == 3] = MASK_TEST
    labels = data["label"].astype(np.int32)
    return Dataset(graph=g,
                   features=data["feature"].astype(np.float32),
                   labels=labels, mask=mask,
                   num_classes=int(labels.max()) + 1, name="reddit")


# ---------------------------------------------------------------- ogbn

def convert_ogbn(name: str, root: str) -> Dataset:
    """ogbn-arxiv / ogbn-products via the ``ogb`` package (gated: the
    package downloads its own raw data)."""
    try:
        from ogb.nodeproppred import NodePropPredDataset
    except ImportError as e:
        raise SystemExit(
            f"converting {name} needs the 'ogb' package (pip install "
            f"ogb on a connected machine); alternatively convert from "
            f"Planetoid/DGL files or use --dataset cora-synth") from e
    ds = NodePropPredDataset(name=name, root=root)
    split = ds.get_idx_split()
    g0, labels = ds[0]
    num_nodes = int(g0["num_nodes"])
    src, dst = g0["edge_index"][0], g0["edge_index"][1]
    g = add_self_edges(from_edge_list(
        src.astype(np.int64), dst.astype(np.int64), num_nodes,
        symmetrize=True))
    mask = np.full(num_nodes, MASK_NONE, dtype=np.int32)
    mask[split["train"]] = MASK_TRAIN
    mask[split["valid"]] = MASK_VAL
    mask[split["test"]] = MASK_TEST
    labels = labels.reshape(-1).astype(np.int32)
    return Dataset(graph=g, features=g0["node_feat"].astype(np.float32),
                   labels=labels, mask=mask,
                   num_classes=int(labels.max()) + 1, name=name)


# ---------------------------------------------------------------- synthetic

def synthetic_cora(seed: int = 7) -> Dataset:
    """Cora-shaped deterministic citation graph: 2708 nodes, 1433
    binary bag-of-words features, 7 classes, ~5300 undirected citation
    edges (homophilous), Planetoid split (140 train / 500 val / 1000
    test, rest unlabeled).  Labels correlate with both topic-word
    features and neighborhoods, so a 2-layer GCN's semi-supervised
    accuracy is meaningfully above a features-only classifier —
    the same qualitative behavior the real Cora exhibits."""
    V, F, C = 2708, 1433, 7
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, C, size=V).astype(np.int32)
    # citation edges: mostly intra-class (homophily 0.81, the real
    # Cora's measured edge homophily)
    n_edges = 5278
    src = rng.randint(0, V, size=n_edges).astype(np.int64)
    by_class = [np.flatnonzero(labels == c) for c in range(C)]
    same = rng.rand(n_edges) < 0.81
    dst = rng.randint(0, V, size=n_edges).astype(np.int64)
    for c in range(C):
        sel = same & (labels[src] == c)
        dst[sel] = by_class[c][rng.randint(len(by_class[c]),
                                           size=int(sel.sum()))]
    g = add_self_edges(from_edge_list(src, dst, V, symmetrize=True))
    # sparse binary bag-of-words, deliberately weak per-node signal
    # (~4 topic words vs ~22 noise words per doc): a features-only
    # classifier plateaus well below the GCN, so the accuracy gate
    # actually tests aggregation — like the real Cora, where the graph
    # carries ~10 points of test accuracy
    feats = np.zeros((V, F), dtype=np.float32)
    topic_words = rng.randint(0, F, size=(C, 40))
    for v in range(V):
        own = topic_words[labels[v]][rng.rand(40) < 0.10]
        noise = rng.randint(0, F, size=22)
        feats[v, own] = 1.0
        feats[v, noise] = 1.0
    mask = np.full(V, MASK_NONE, dtype=np.int32)
    order = rng.permutation(V)
    mask[order[:140]] = MASK_TRAIN
    mask[order[140:640]] = MASK_VAL
    mask[order[640:1640]] = MASK_TEST
    return Dataset(graph=g, features=feats, labels=labels, mask=mask,
                   num_classes=C, name="cora-synth")


# ---------------------------------------------------------------- karate

# Zachary's karate club (W. W. Zachary, "An Information Flow Model for
# Conflict and Fission in Small Groups", J. Anthropological Research
# 33(4):452-473, 1977): 34 members, 78 friendship edges, and the
# club's REAL post-fission faction split — the smallest real public
# graph dataset, vendored verbatim (public-domain observational data
# shipped by every network-analysis toolkit).  0-indexed; node 0 is
# the instructor ("Mr. Hi"), node 33 the club officer.
_KARATE_EDGES = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
    (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21),
    (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19),
    (1, 21), (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13),
    (2, 27), (2, 28), (2, 32), (3, 7), (3, 12), (3, 13), (4, 6),
    (4, 10), (5, 6), (5, 10), (5, 16), (6, 16), (8, 30), (8, 32),
    (8, 33), (9, 33), (13, 33), (14, 32), (14, 33), (15, 32),
    (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32),
    (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29),
    (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33),
    (30, 32), (30, 33), (31, 32), (31, 33), (32, 33))

# the documented post-split membership (Zachary's "club" attribute):
# these 17 members joined the officer's club, the rest followed Mr. Hi
_KARATE_OFFICER = frozenset(
    (9, 14, 15, 18, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33))


def karate_club() -> Dataset:
    """The real karate club as a semi-supervised 2-class node
    classification task (the classic GCN demo setup): identity
    features, only the two faction LEADERS labeled for training, a
    2-node val split, the remaining 30 members held out as test —
    predicting the real fission from the topology alone."""
    V = 34
    e = np.asarray(_KARATE_EDGES, dtype=np.int64)
    g = add_self_edges(from_edge_list(e[:, 0], e[:, 1], V,
                                      symmetrize=True))
    labels = np.fromiter((1 if v in _KARATE_OFFICER else 0
                          for v in range(V)), dtype=np.int32, count=V)
    feats = np.eye(V, dtype=np.float32)
    mask = np.full(V, MASK_TEST, dtype=np.int32)
    mask[[0, 33]] = MASK_TRAIN
    mask[[1, 32]] = MASK_VAL
    return Dataset(graph=g, features=feats, labels=labels, mask=mask,
                   num_classes=2, name="karate")


# ---------------------------------------------------------------- main

CONVERTERS = ("cora", "citeseer", "pubmed", "reddit", "ogbn-arxiv",
              "ogbn-products", "cora-synth", "karate")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True, choices=CONVERTERS)
    ap.add_argument("--raw-dir", default="raw",
                    help="directory with the public raw files")
    ap.add_argument("--out", required=True,
                    help="output prefix (writes <out>.add_self_edge.lux "
                         "etc.)")
    ap.add_argument("--no-csv", action="store_true",
                    help="skip the (large) .feats.csv; .feats.bin is "
                         "always written and preferred by the loader")
    args = ap.parse_args(argv)

    if args.dataset in ("cora", "citeseer", "pubmed"):
        ds = convert_planetoid(args.raw_dir, args.dataset)
    elif args.dataset == "reddit":
        ds = convert_dgl_reddit(args.raw_dir)
    elif args.dataset.startswith("ogbn-"):
        ds = convert_ogbn(args.dataset, args.raw_dir)
    elif args.dataset == "karate":
        ds = karate_club()
    else:
        ds = synthetic_cora()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_dataset(ds, args.out, csv=not args.no_csv)
    print(f"# wrote {args.out}.add_self_edge.lux  V={ds.graph.num_nodes} "
          f"E={ds.graph.num_edges} in_dim={ds.in_dim} "
          f"classes={ds.num_classes} "
          f"split={int((ds.mask == MASK_TRAIN).sum())}/"
          f"{int((ds.mask == MASK_VAL).sum())}/"
          f"{int((ds.mask == MASK_TEST).sum())}")
    print(f"# train: python -m roc_tpu_torch.train.cli -file {args.out} "
          f"-layers {ds.in_dim}-16-{ds.num_classes} -lr 0.01 "
          f"-decay 5e-4 -dropout 0.5 -e 200")
    return 0


if __name__ == "__main__":
    sys.exit(main())
