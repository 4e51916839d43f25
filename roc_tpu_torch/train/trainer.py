"""Single-device training (``roc_tpu/train/trainer.py``): the config, the
fuse rule, the graph context, :class:`Trainer` and the reference's epoch
loop (``gnn.cc:99-111``): per epoch staircase lr decay, forward,
backward, Adam update; every ``eval_every`` epochs an inference pass
printing train loss and train/val/test accuracy in the reference's
format (``softmax_kernel.cu:141-152``).

The subset ported is one device, features resident on the device, no
rematerialisation, no mesh, no streamed head; the metrics registry and
the timeline are not ported.  The epoch loop carries the resilience
hooks (resilience/inject.py drill sites, the preemption check), and the
trainer the state a checkpoint needs besides weights and Adam state
(utils/checkpoint.py): the dataset's identity and the dropout
generator's state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.ell import ell_from_graph
from ..core.graph import Dataset, check_symmetric
from ..core.partition import padded_edge_list
from ..models.builder import (AGGR_IMPLS, EDGE_IMPLS, KERNEL_IMPLS,
                              GraphContext, Model)
from ..obs.events import emit
from ..ops.loss import perf_metrics, summarize_metrics
from ..ops.norm import inv_sqrt_degree
from .optimizer import AdamConfig, adam_init, adam_update, decayed_lr


@dataclass
class TrainConfig:
    """The ported subset of the JAX package's ``TrainConfig`` (the
    reference's ``Config`` struct and CLI defaults, ``gnn.h:105-113``,
    ``gnn.cc:30-41``).

    aggr_impl: 'cuda' (the hand-written ELL kernels, the JAX package's
      'pallas'), 'cuda_csr' (the hand-written CSR kernel K3, its
      'pallas_csr'), or the plain 'ell' / 'segment'.
    chunk: edge-list padding multiple of the edge routes.
    aggr_fuse: 'auto' | 'on' | 'off', see :func:`resolve_fuse`.
    symmetric: None = check the graph; False differentiates the plain
      routes exactly and is refused by the kernel routes.
    dropout_rate: recorded for the CLI; the model carries its own rate.
    dtype: the params' and Adam state's dtype (fp32 master weights in
      the mixed mode); compute_dtype: when set (bf16, the mixed mode),
      features, activations and the aggregation run in it while params
      stay in ``dtype`` and are cast inside the step (gradients flow
      back through the cast as fp32; the loss is reduced in fp32,
      ops/loss.py; no loss scaling).  :func:`resolve_dtypes` maps the
      mode names to the two fields.
    async_save: 'auto' | 'on' | 'off' (or a bool), the recovery
      rotation's saver mode, see :func:`resolve_async_save`.
    fault: one drill fault to arm, ``site:epoch[:proc]``
      (resilience/inject.py); None arms none (``ROC_TPU_FAULT`` is the
      out-of-band switch).
    """
    learning_rate: float = 0.01
    weight_decay: float = 0.05
    dropout_rate: float = 0.5
    decay_rate: float = 1.0
    decay_steps: int = 100
    epochs: int = 200
    seed: int = 1
    eval_every: int = 5
    verbose: bool = True
    aggr_impl: str = "cuda"
    chunk: int = 512
    aggr_fuse: str = "auto"
    symmetric: Optional[bool] = None
    dtype: torch.dtype = torch.float32
    compute_dtype: Optional[torch.dtype] = None
    async_save: Any = "auto"
    fault: Optional[str] = None


def resolve_async_save(config: TrainConfig) -> bool:
    """``TrainConfig.async_save`` -> the saver mode of the recovery
    rotation (the CLI's ``--async-save`` goes through this too).  'auto'
    is on for a world of one and off otherwise, as in the JAX package
    (rank 0 alone writes, so async would be safe with more ranks, but the
    choice follows the reference); 'on'/'off' and bools are literal."""
    v = config.async_save
    if isinstance(v, bool):
        return v
    if v == "on":
        return True
    if v == "off":
        return False
    if v == "auto":
        import torch.distributed as dist
        return not (dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() > 1)
    raise ValueError(f"unknown async_save {v!r}; expected 'auto', "
                     "'on', or 'off'")


def derived_seed(*words: int) -> int:
    """A 63-bit seed drawn from ``SeedSequence(words)``: the same words
    give the same seed in every process."""
    return int(np.random.SeedSequence(tuple(int(w) for w in words))
               .generate_state(1, np.uint64)[0] >> 1)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another.  Raises when no card is present and none was
    asked for; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")


def resolve_fuse(model: Model, config: TrainConfig) -> Model:
    """'off' leaves the model alone; 'auto'/'on' rewrite its fusable
    ``norm -> aggregate -> norm [-> relu]`` chains into fused ops.
    Returns the ORIGINAL object when nothing fused."""
    if config.aggr_fuse == "off":
        return model
    if config.aggr_fuse not in ("auto", "on"):
        raise ValueError(f"unknown aggr_fuse {config.aggr_fuse!r}; "
                         "expected 'auto', 'on', or 'off'")
    fused = model.fuse_norm_aggregate()
    if fused.num_fused_aggregates() <= model.num_fused_aggregates():
        return model
    return fused


def resolve_symmetric(dataset: Dataset, symmetric: Optional[bool]) -> bool:
    if symmetric is None:
        return check_symmetric(dataset.graph)
    return bool(symmetric)


DTYPE_MODES = ("float32", "bfloat16", "mixed")


def resolve_dtypes(name: str):
    """Dtype-mode name (the CLI's ``--dtype``) -> ``(dtype,
    compute_dtype)``, the JAX package's mapping: 'float32' is fp32
    throughout, 'bfloat16' bf16 throughout (params too; the Adam moments
    stay fp32), 'mixed' fp32 params with bf16 compute."""
    if name == "float32":
        return torch.float32, None
    if name == "bfloat16":
        return torch.bfloat16, None
    if name == "mixed":
        return torch.float32, torch.bfloat16
    raise ValueError(f"unknown dtype mode {name!r}; expected "
                     "'float32', 'bfloat16', or 'mixed'")


def compute_dtype_of(config: TrainConfig) -> torch.dtype:
    """``compute_dtype`` when set (mixed precision), else ``dtype``."""
    return (config.compute_dtype if config.compute_dtype is not None
            else config.dtype)


def cast_floats(params: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Floating-point entries cast to ``dtype``; others pass through."""
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in params.items()}


def make_graph_context(dataset: Dataset, aggr_impl: str = "cuda",
                       symmetric: Optional[bool] = None,
                       device=None, chunk: int = 512) -> GraphContext:
    """Single-device GraphContext on ``device`` (the card unless
    ``device`` says otherwise).  The ELL routes get the degree-bucketed
    tables (core/ell.py), the edge routes the edge list padded to a
    ``chunk`` multiple (core/partition.py); neither builds the other's
    (at Reddit scale the edge list alone is ~0.9 GB of int32)."""
    if aggr_impl not in AGGR_IMPLS:
        raise ValueError(f"aggr_impl {aggr_impl!r} is not ported; "
                         f"expected one of {AGGR_IMPLS}")
    device = resolve_device(device)
    g = dataset.graph

    def dev(a):
        return torch.from_numpy(a).to(device)

    in_degree = dev(g.in_degree)
    if aggr_impl in EDGE_IMPLS:
        src, dst = padded_edge_list(g, multiple=chunk)
        tables = dict(edge_src=dev(src), edge_dst=dev(dst), chunk=chunk)
    else:
        table = ell_from_graph(g.row_ptr, g.col_idx, g.num_nodes)
        tables = dict(ell_idx=tuple(dev(a[0]) for a in table.idx),
                      ell_row_pos=dev(table.row_pos[0]),
                      ell_row_id=tuple(dev(a[0]) for a in table.row_id))
    return GraphContext(
        in_degree=in_degree, inv_sqrt_deg=inv_sqrt_degree(in_degree),
        num_rows=g.num_nodes, aggr_impl=aggr_impl,
        symmetric=resolve_symmetric(dataset, symmetric), **tables)


class Trainer:
    """Owns the parameters, the optimizer state and the step.

    ``params`` (optional) are the starting weights, copied onto the
    device (e.g. carried from the JAX package with convert.py); without
    them Glorot weights are drawn from a generator seeded with
    ``config.seed``, which also draws every dropout mask.  ``device``
    is the card unless the caller passes another (``'cpu'``).

    A subclass that holds one part of the graph (parallel/distributed.py
    ``DistributedTrainer``) overrides :meth:`_place`, :meth:`_reduce` and
    :meth:`predict`; the step, the epoch loop and the eval are shared."""

    def __init__(self, model: Model, dataset: Dataset,
                 config: TrainConfig = TrainConfig(),
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None):
        self.device = resolve_device(device)
        model = resolve_fuse(model, config)
        self.model = model
        self.config = config
        self.compute = compute_dtype_of(config)
        self.epoch = 0
        # the dataset's identity, in the checkpoint's strict fingerprint
        # (utils/checkpoint.trainer_fingerprint)
        self._fp_dataset = {"V": int(dataset.graph.num_nodes),
                            "E": int(dataset.graph.num_edges)}
        symmetric = resolve_symmetric(dataset, config.symmetric)
        if not symmetric and config.aggr_impl in KERNEL_IMPLS:
            raise NotImplementedError(
                f"aggr_impl={config.aggr_impl!r} trains by the symmetric "
                "trick only and this graph is not symmetric; use 'ell' "
                "or 'segment'")
        self._place(dataset, symmetric)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        if params is None:
            params = model.init_params(self.generator, dtype=config.dtype,
                                       device=self.device)
        else:
            params = {k: v.detach().to(self.device, config.dtype).clone()
                      .requires_grad_(True) for k, v in params.items()}
        self.params: Dict[str, torch.Tensor] = dict(params)
        self.opt_state = adam_init(self.params)
        self.adam_cfg = AdamConfig(weight_decay=config.weight_decay)
        self.num_edges = int(dataset.graph.num_edges)
        # the objective of every step, as 0-d device tensors (no sync)
        self.losses: List[torch.Tensor] = []
        self._stepped = False
        # the first step's ms (run_epoch_loop), kept for a caller whose
        # first train() call ends before an eval
        self.first_step_ms: Optional[float] = None

    def _place(self, dataset: Dataset, symmetric: bool) -> None:
        """Put the rows this trainer computes on the device: ``feats``
        (in the compute dtype), ``labels``, ``mask`` and the graph
        context ``gctx``; here the whole graph."""
        self.feats = torch.as_tensor(dataset.features,
                                     dtype=self.compute).to(self.device)
        self.labels = torch.from_numpy(dataset.labels).to(self.device)
        self.mask = torch.from_numpy(dataset.mask).to(self.device)
        self.gctx = make_graph_context(dataset, self.config.aggr_impl,
                                       symmetric=symmetric,
                                       device=self.device,
                                       chunk=self.config.chunk)

    def _reduce(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sums over every trainer of a run: ``tensors`` themselves
        on one device."""
        return tensors

    def loss_and_grads(self) -> Tuple[torch.Tensor,
                                      Dict[str, torch.Tensor]]:
        """The objective (summed masked CE) and its gradients at the
        current weights, summed by :meth:`_reduce`: one forward and
        backward through the model (dropout draws from
        ``generator``)."""
        names = list(self.params)
        loss, _ = self.model.loss_fn(cast_floats(self.params, self.compute),
                                     self.feats, self.labels, self.mask,
                                     self.gctx, generator=self.generator,
                                     train=True)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        *grads, loss = self._reduce([*grads, loss.detach()])
        return loss, dict(zip(names, grads))

    def step(self, lr: float) -> torch.Tensor:
        """One training step at learning rate ``lr``: forward, backward,
        Adam update.  Returns the objective (summed masked CE) before the
        update, on the device."""
        loss, grads = self.loss_and_grads()
        self.params, self.opt_state = adam_update(
            self.params, grads, self.opt_state, lr, self.adam_cfg)
        self.losses.append(loss)
        return loss

    def train(self, epochs: Optional[int] = None) -> List[Dict[str, float]]:
        """Run ``epochs`` more epochs (``config.epochs`` by default); the
        epoch counter persists across calls, so lr decay and the eval
        cadence continue."""
        return run_epoch_loop(self, epochs, self.step, self.evaluate)

    def sync(self) -> None:
        """Block until every launched step has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the checkpoint's view of the trainer (utils/checkpoint.py)

    def rng_states(self) -> np.ndarray:
        """The dropout generators' states, one uint8 row per rank
        (``torch.Generator.get_state()``); here one row."""
        return self.generator.get_state().numpy()[None].copy()

    def restore_rng(self, states: Optional[np.ndarray]) -> None:
        """Set this rank's dropout generator from a checkpoint's states
        (:meth:`rng_states`).  Where they hold no row for this rank, or a
        row of another generator (a JAX checkpoint, whose PRNG key cannot
        drive torch's dropout; one saved on another device type), the
        generator is reseeded from the seed and the restored epoch
        (:meth:`reseed`) and a ``resilience`` event says so."""
        rank = getattr(self, "rank", 0)
        n = self.generator.get_state().numel()
        if states is not None and states.ndim == 2 and \
                rank < states.shape[0] and states.shape[1] == n:
            self.generator.set_state(torch.from_numpy(
                np.ascontiguousarray(states[rank], dtype=np.uint8)))
            return
        self.reseed(self.epoch)
        emit("resilience",
             f"checkpoint holds no dropout generator state for rank "
             f"{rank} (a JAX checkpoint, or one saved on another device "
             f"or rank count): reseeded from seed {self.config.seed} and "
             f"epoch {self.epoch}", kind="rng_reseed", epoch=self.epoch,
             rank=rank)

    def reseed(self, *words: int) -> None:
        """Seed the dropout generator with :func:`derived_seed`
        ``(config.seed, rank, *words)``."""
        self.generator.manual_seed(derived_seed(
            self.config.seed, getattr(self, "rank", 0), *words))

    def agree(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's ``value`` on every rank of the run: ``value`` itself
        on one device."""
        return value

    @torch.no_grad()
    def _logits(self) -> torch.Tensor:
        """Inference-mode logits of this trainer's rows."""
        return self.model.apply(cast_floats(self.params, self.compute),
                                self.feats, self.gctx, train=False)

    def predict(self, node_ids=None) -> torch.Tensor:
        """Inference-mode logits ``[V, C]`` on the device, or the rows
        ``node_ids`` of them."""
        logits = self._logits()
        if node_ids is None:
            return logits
        ids = torch.as_tensor(node_ids, dtype=torch.long).reshape(-1)
        V = logits.shape[0]
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= V):
            raise ValueError(f"node ids out of range [0, {V})")
        return logits.index_select(0, ids.to(logits.device))

    def evaluate(self) -> Dict[str, float]:
        """The reference's inference pass: the metric sums, summed by
        :meth:`_reduce`, as :func:`summarize_metrics` gives them, fetched
        in one device sync."""
        m = perf_metrics(self._logits(), self.labels, self.mask)
        keys = list(m)
        return summarize_metrics(dict(zip(keys,
                                          self._reduce([m[k]
                                                        for k in keys]))))


def run_epoch_loop(tr: Trainer, epochs: Optional[int], do_step,
                   do_eval) -> List[Dict[str, float]]:
    """The reference epoch loop (``gnn.cc:99-111``): staircase lr decay,
    one step per epoch, an eval every ``eval_every`` epochs (on
    ``epoch % eval_every == eval_every - 1``, so each eval closes a full
    burst of steps), each printed with :func:`format_metrics` when
    ``config.verbose``.

    Timing: steps are launched without waiting; the loop synchronises
    before each eval, so ``epoch_ms`` is the steps' wall clock over the
    steps since the last eval, and ``eval_ms`` is the eval pass on its
    own.  The first step of a trainer (cold kernels, allocator and
    library handles) is synchronised and reported apart, as
    ``first_step_ms`` on the first eval's record; ``epoch_ms`` counts
    steady steps only, and is None when an eval follows the first step
    with no steady step between.  Each eval record is also emitted as an
    ``epoch`` event (off the console).

    Resilience hooks, where the JAX loop has them: the loop notes each
    epoch for the fault sites (``inject.note_epoch``), and after each
    epoch's step has been launched runs the epoch-boundary drill sites
    (``inject.epoch_hooks``) and the preemption check
    (``preempt.raise_if_preempted``)."""
    from ..resilience import inject, preempt
    cfg = tr.config
    if cfg.fault:
        inject.arm(cfg.fault)
    epochs = cfg.epochs if epochs is None else epochs
    history: List[Dict[str, float]] = []
    t_last = time.perf_counter()
    e_last = tr.epoch
    first_ms: Optional[float] = None
    for _ in range(epochs):
        epoch = tr.epoch
        inject.note_epoch(epoch)
        do_step(float(decayed_lr(cfg.learning_rate, epoch, cfg.decay_rate,
                                 cfg.decay_steps)))
        if not tr._stepped:
            tr.sync()
            now = time.perf_counter()
            first_ms = tr.first_step_ms = (now - t_last) * 1e3
            t_last, e_last = now, epoch + 1
            tr._stepped = True
        if epoch % cfg.eval_every == cfg.eval_every - 1:
            tr.sync()
            now = time.perf_counter()
            m = do_eval()
            t_eval_end = time.perf_counter()
            span = epoch + 1 - e_last
            m["epoch"] = epoch
            m["epoch_ms"] = (now - t_last) * 1e3 / span if span > 0 else None
            m["eval_ms"] = (t_eval_end - now) * 1e3
            if first_ms is not None:
                m["first_step_ms"] = first_ms
                first_ms = None
            if span > 0:
                m["edges_per_s"] = tr.num_edges / (m["epoch_ms"] / 1e3)
            t_last, e_last = t_eval_end, epoch + 1
            history.append(m)
            emit("epoch", f"epoch {epoch}: train_loss {m['train_loss']}",
                 console=False, **m)
            if cfg.verbose:
                print(format_metrics(epoch, m), flush=True)
        tr.epoch += 1
        inject.epoch_hooks(tr, epoch)
        preempt.raise_if_preempted(epoch)
    return history


def format_metrics(epoch: int, m: Dict[str, float]) -> str:
    """The reference's infer-mode print line (``softmax_kernel.cu:146``)."""
    return ("[INFER][%d] train_loss: %.4f  train_accuracy: %.2f%%(%d/%d)  "
            "val_accuracy: %.2f%%(%d/%d)  test_accuracy: %.2f%%(%d/%d)"
            % (epoch, m["train_loss"],
               m["train_acc"] * 100.0, m["train_correct"], m["train_cnt"],
               m["val_acc"] * 100.0, m["val_correct"], m["val_cnt"],
               m["test_acc"] * 100.0, m["test_correct"], m["test_cnt"]))
