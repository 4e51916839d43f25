"""Checkpoint and resume (``roc_tpu/utils/checkpoint.py``), format v3,
read and written by both packages.

A checkpoint is a directory:

.. code-block:: text

    <path>/                      (e.g. ck.40/)
      shard_00000.npz            the state's arrays, one npz member each
      MANIFEST.json              the commit record

Each shard holds a ``__header__`` member, JSON bytes: ``version``,
``process``, ``epoch``, ``crc32`` (per member), ``arrays`` (per array:
global shape, dtype, per-dimension mesh-axis spec) and ``pieces`` (per
member: the array it is a piece of and the piece's index ranges, None
for the whole array).  The members are named by the JAX package's tree
paths — ``params['<name>']``, ``opt.step``, ``opt.beta1_t``,
``opt.beta2_t``, ``opt.m['<name>']``, ``opt.v['<name>']`` — plus
``__epoch__``; in JAX's dtypes (``opt.step`` int32 0-d, the betas
float32 0-d, ``__epoch__`` int64 0-d).  The port adds ``__torch_rng__``,
the dropout generators' states (``torch.Generator.get_state()``, one
uint8 row per rank): the JAX loaders read only the members they ask
for, so its files load there; the JAX package's ``__key__`` (a PRNG key)
cannot drive torch's dropout, so restoring a JAX checkpoint reseeds the
generator (``Trainer.restore_rng``).

**bf16** is written as the JAX package writes it: numpy has no bf16, so
``np.savez`` stores the raw 16-bit bytes as the void type ``|V2``, and
the header's ``arrays`` says ``"bfloat16"``.  The loaders read such a
member through a 16-bit view by that header dtype, never by numpy's
(neither direction needs ``ml_dtypes``).  The JAX package's own loader
cannot restore a bf16 checkpoint (its ``jnp.asarray`` of a ``|V2``
array raises), so bf16 files cross from JAX to the port only.

**Two-phase commit**, as the JAX package has it (``write_snapshot``):
un-commit a replayed epoch (remove its manifest, fsync the directory);
land the shard via tmp → fsync → rename → directory fsync; then publish
``MANIFEST.json`` — shard list, byte counts, whole-file CRC32s, epoch,
fingerprint — by the same steps.  A directory without a committed
manifest is invisible to the rotation, so a death at any byte of a save
leaves the previous complete checkpoint or the new one, never a torn
read.  Restore validates the manifest, every listed shard's bytes and
file CRC, every member's CRC and every array's coverage before anything
touches the trainer.

**Writers**: on the 1-D mesh the params are replicated on every rank,
so rank 0 alone writes (``writer_procs == [0]``).  On the ``(parts,
model)`` mesh (parallel/distributed.py ``DistributedTrainer``) the
params and Adam moments are sharded over a part's model ranks: the owners
of a sharded leaf are the ranks of part 0's model row (the JAX package's
``replica_id == 0`` rule), each writing ``shard_<rank>.npz`` with its
pieces ``<member>@0`` and their index ranges; whole leaves and the
scalars belong to rank 0.  With more than one writer every rank runs
:func:`write_snapshot`, whose un-commit barrier and commit barrier
(``parallel/multihost.checkpoint_commit_barrier``, over the trainer's own
gloo group) order the renames after rank 0's un-commit and the manifest
after every shard.  The loader gathers pieces into whole arrays, so a
checkpoint of any (P, M) layout, the JAX package's included, restores
into a trainer of any other, each rank keeping its slice.

v1 (a bare npz) and v2 (one npz with a CRC header) files still load,
each with a ``resilience`` event.  The async saver
(``resilience/async_save.py``) takes :func:`snapshot_trainer` on the
step path and runs :func:`write_snapshot` on its thread.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import tempfile
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import aggr_impl_to_jax
from ..obs.events import emit, process_index
from ..train.optimizer import AdamState

CHECKPOINT_VERSION = 3
_HEADER_KEY = "__header__"
MANIFEST_NAME = "MANIFEST.json"
EPOCH_KEY = "__epoch__"
RNG_KEY = "__torch_rng__"
BF16 = "bfloat16"
# how np.savez stores a bf16 leaf: its raw bytes as a 2-byte void
_BF16_DISK = np.dtype("V2")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity (CRC32, structure, coverage) or the
    strict fingerprint check.  The rotation catches this and falls back
    to the previous checkpoint."""


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``float32``,
    ``bfloat16``), the JAX package's spelling."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def state_leaves(params: Dict[str, Any], opt_state: AdamState
                 ) -> List[Tuple[str, Any]]:
    """``(member name, leaf)`` for the whole training state, in the JAX
    tree's order (dict keys sorted): params, then ``opt.step``,
    ``opt.beta1_t``, ``opt.beta2_t``, ``opt.m``, ``opt.v``.  The step and
    the betas are host scalars here, converted to JAX's dtypes."""
    out: List[Tuple[str, Any]] = [(f"params[{k!r}]", params[k])
                                  for k in sorted(params)]
    out += [("opt.step", np.asarray(opt_state.step, dtype=np.int32)),
            ("opt.beta1_t", np.asarray(opt_state.beta1_t, dtype=np.float32)),
            ("opt.beta2_t", np.asarray(opt_state.beta2_t, dtype=np.float32))]
    for name, tree in (("m", opt_state.m), ("v", opt_state.v)):
        out += [(f"opt.{name}[{k!r}]", tree[k]) for k in sorted(tree)]
    return out


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_dir(d: str) -> None:
    """Make a completed rename durable: the rename is on disk only once
    the directory entry is."""
    dfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def params_signature(params: Dict[str, Any]) -> str:
    """The param-tree identity hash, the JAX package's string: for each
    name in sorted order ``"['<name>']:(<shape>):<dtype>"``, joined by
    ``|``, sha1, the first 16 hex digits."""
    sigs = [f"[{k!r}]:{tuple(int(d) for d in params[k].shape)}:"
            f"{dtype_name(params[k].dtype)}" for k in sorted(params)]
    return hashlib.sha1("|".join(sigs).encode()).hexdigest()[:16]


def trainer_fingerprint(trainer) -> Dict[str, Any]:
    """The trainer's identity, the JAX package's two halves:

    - ``strict`` — what a checkpoint never survives changing: the
      param signature, ``dtype`` and ``compute_dtype`` (numpy names),
      and the dataset's ``{V, E}``; a mismatch is CheckpointCorrupt;
    ``elastic`` — what a restart may change: the partition count and
      the plan's part shapes, and the route (by its JAX name,
      ``convert.aggr_impl_to_jax``), the halo ('gather' or 'ring'), the
      feature residency (``config.features``, 'hbm' or 'host') and the
      mesh (``config.mesh``); a mismatch restores and emits
      ``elastic_restore``.

    The param signature is of the whole params, on a sharded trainer
    too (``trainer.sharding``)."""
    cfg = trainer.config
    strict: Dict[str, Any] = {
        "params_sig": params_signature(_whole_meta(trainer)),
        "dtype": dtype_name(cfg.dtype),
        "compute_dtype": (None if cfg.compute_dtype is None
                          else dtype_name(cfg.compute_dtype))}
    ds = getattr(trainer, "_fp_dataset", None)
    if ds:
        strict["dataset"] = {k: int(v) for k, v in ds.items()}
    plan = getattr(trainer, "plan", None)
    elastic: Dict[str, Any] = {
        "num_parts": int(plan.num_parts) if plan is not None else 1,
        "part_nodes": int(plan.part_nodes) if plan is not None else None,
        "part_edges": int(plan.part_edges) if plan is not None else None,
        "aggr_impl": aggr_impl_to_jax(cfg.aggr_impl), "halo": cfg.halo,
        "features": cfg.features, "mesh": str(cfg.mesh)}
    return {"strict": strict, "elastic": elastic}


@dataclass
class _Meta:
    """A leaf's whole shape, dtype and device, without its values."""
    shape: Tuple[int, ...]
    dtype: Any
    device: Any = "cpu"


def _whole_meta(trainer) -> Dict[str, Any]:
    """The trainer's params as whole-shaped :class:`_Meta` on a sharded
    trainer (``trainer.sharding``), else the params themselves."""
    sh = getattr(trainer, "sharding", None)
    if sh is None:
        return trainer.params
    return {k: _Meta(sh.full_shapes[k], v.dtype)
            for k, v in trainer.params.items()}


# ---------------------------------------------------------- host snapshot

def shard_file_name(proc: int) -> str:
    return f"shard_{int(proc):05d}.npz"


@dataclass
class _Piece:
    """One block of one array (``index`` the per-dimension ``[lo, hi)``
    ranges; None = the whole array).  ``data`` is a host tensor until
    :meth:`Snapshot.wait`, a numpy array after."""
    member: str
    key: str
    index: Optional[List[List[int]]]
    data: Any


@dataclass
class Snapshot:
    """A host copy of the training state, decoupled from the trainer:
    :func:`write_snapshot` can run it on the saver thread while training
    goes on.  ``ready`` is the CUDA event after the device-to-host
    copies; :meth:`wait` blocks on it.  ``group``: the process group of
    the commit barriers when ``writer_procs`` has more than one rank."""
    epoch: int
    proc: int
    writer_procs: List[int]
    pieces: List[_Piece]
    arrays: Dict[str, Dict[str, Any]]
    fingerprint: Dict[str, Any]
    block_ms: float = 0.0
    stats: Dict[str, Any] = field(default_factory=dict)
    ready: Any = None
    # the process group of the commit barriers (None: the default)
    group: Any = None

    def wait(self) -> None:
        """Block until the copies have landed; the pieces become numpy
        arrays (bf16 as ``|V2``, as ``np.savez`` writes JAX's)."""
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        for p in self.pieces:
            if isinstance(p.data, torch.Tensor):
                p.data = _tensor_to_numpy(p.data)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_DISK)
    return t.numpy()


def _host_copy(leaf):
    """A host copy of ``leaf`` that the next in-place Adam step cannot
    touch.  A CUDA tensor is copied into fresh pinned memory with
    ``non_blocking`` on the current stream: stream order puts the copy
    before any later kernel on that stream, so it reads the values as of
    this call (the caller records ``Snapshot.ready`` after)."""
    if isinstance(leaf, np.ndarray):
        return leaf
    t = leaf.detach()
    if t.device.type == "cuda":
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf
    return t.clone()


_PARAM_NAME = re.compile(r"\['([^']+)'\]$")


def snapshot_state(params: Dict[str, torch.Tensor], opt_state: AdamState,
                   epoch: int, rng: Optional[np.ndarray] = None,
                   fingerprint: Optional[Dict[str, Any]] = None,
                   sharding=None, group=None) -> Snapshot:
    """Host snapshot of the full training state, the only part of a save
    on the step path.  ``rng``: the generators' states, ``[ranks, n]``
    uint8.

    Without ``sharding`` (replicated params) rank 0 copies every leaf
    (asynchronously from the card) and other ranks copy nothing.  With a
    ``parallel.ModelSharding`` (the params and moments given are this
    rank's slices) a sharded leaf's owners are the ranks of part 0, each
    copying its slice as piece ``<member>@0`` with its index ranges; a
    whole leaf and the scalars are rank 0's; ``writer_procs`` lists the
    owners and ``group`` rides along for the barriers."""
    t0 = time.perf_counter()
    proc = process_index()
    pieces: List[_Piece] = []
    arrays: Dict[str, Dict[str, Any]] = {}
    writers = {0}
    leaves = state_leaves(params, opt_state)
    leaves.append((EPOCH_KEY, np.asarray(epoch, dtype=np.int64)))
    if rng is not None:
        leaves.append((RNG_KEY, np.asarray(rng, dtype=np.uint8)))
    cuda = None
    for k, leaf in leaves:
        name = _PARAM_NAME.search(k)
        index = (sharding.index(name.group(1))
                 if sharding is not None and name is not None
                 and isinstance(leaf, torch.Tensor) else None)
        shape = [int(d) for d in leaf.shape]
        spec: List[Any] = [None] * len(shape)
        if index is None:
            mine = proc == 0
            member = k
        else:
            shape = list(sharding.full_shapes[name.group(1)])
            d = sharding.dims[name.group(1)]
            spec[d] = "model"
            owners = range(sharding.model)  # part 0's model row
            writers.update(owners)
            mine = sharding.part == 0
            member = f"{k}@0"
        arrays[k] = {"shape": shape, "dtype": dtype_name(leaf.dtype),
                     "spec": spec}
        if mine:
            pieces.append(_Piece(member=member, key=k, index=index,
                                 data=_host_copy(leaf)))
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                cuda = leaf.device
    ready = None
    if cuda is not None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(cuda))
    return Snapshot(epoch=int(epoch), proc=proc,
                    writer_procs=sorted(writers), pieces=pieces,
                    arrays=arrays, fingerprint=fingerprint or {},
                    block_ms=(time.perf_counter() - t0) * 1e3, ready=ready,
                    group=group)


def snapshot_trainer(trainer) -> Snapshot:
    """Trainer state → :class:`Snapshot` (the async saver's payload).
    Every rank calls it (the generators' states are gathered); the
    finite guard is the caller's job."""
    return snapshot_state(trainer.params, trainer.opt_state, trainer.epoch,
                          rng=trainer.rng_states(),
                          fingerprint=trainer_fingerprint(trainer),
                          sharding=getattr(trainer, "sharding", None),
                          group=getattr(trainer, "_ckpt_group", None))


def writes(snap: Snapshot) -> bool:
    """Whether this rank runs :func:`write_snapshot` for ``snap``: rank 0
    always; every rank when more than one writes (the barriers need
    them all)."""
    return snap.proc == 0 or len(snap.writer_procs) > 1


# ------------------------------------------------ write + two-phase commit

def _write_shard(d: str, snap: Snapshot) -> Tuple[str, bytes]:
    """Serialize this process's pieces and land them as
    ``shard_<proc>.npz`` via tmp → fsync → rename; returns the name and
    the exact bytes (the manifest CRCs these, with no re-read)."""
    from ..resilience import inject
    name = shard_file_name(snap.proc)
    data = {p.member: p.data for p in snap.pieces}
    header = {
        "version": CHECKPOINT_VERSION,
        "process": snap.proc,
        "epoch": snap.epoch,
        "crc32": {m: _crc(a) for m, a in data.items()},
        "arrays": snap.arrays,
        "pieces": {p.member: {"key": p.key, "index": p.index}
                   for p in snap.pieces},
    }
    data[_HEADER_KEY] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **data)
    raw = buf.getvalue()
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        # drill site: a SIGKILL here leaves only the .npz.tmp, which
        # restore never picks up
        inject.maybe_kill_in_save(snap.epoch)
        os.replace(tmp, os.path.join(d, name))
        _fsync_dir(d)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return name, raw


def commit_manifest(d: str, snap: Snapshot,
                    shards: List[Dict[str, Any]]) -> None:
    """Phase two: publish ``MANIFEST.json`` (tmp → fsync → rename →
    directory fsync).  Until it lands the checkpoint does not exist."""
    doc = {"version": CHECKPOINT_VERSION,
           "epoch": snap.epoch,
           "fingerprint": snap.fingerprint,
           "shards": shards}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, MANIFEST_NAME))
        _fsync_dir(d)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def write_snapshot(path: str, snap: Snapshot) -> Dict[str, Any]:
    """The full save of a taken snapshot — wait for its copies, CRC,
    shard write, manifest commit — on the calling thread (the saver's,
    in async mode), in the JAX package's order: rank 0 un-commits a
    replayed epoch; the un-commit barrier; each writer's shard renamed
    into place; the ``kill_in_commit`` drill site; the commit barrier;
    rank 0 reads the peers' shards, CRCs them and publishes the manifest.
    The barriers run only with more than one writer (every rank then
    calls this, :func:`writes`).  Returns the save's stats:
    ``block_ms`` (the step path's part), ``write_ms`` (copies landed,
    un-commit, shard), ``commit_ms`` (barrier and manifest),
    ``save_ms``, ``bytes``, ``shards``."""
    from ..parallel.multihost import checkpoint_commit_barrier
    from ..resilience import inject
    t0 = time.perf_counter()
    d = os.path.abspath(path)
    os.makedirs(d, exist_ok=True)
    man = os.path.join(d, MANIFEST_NAME)
    many = len(snap.writer_procs) > 1
    if snap.proc == 0 and os.path.exists(man):
        # re-saving a replayed epoch: un-commit first, so a crash mid-
        # rewrite leaves an invisible directory, never a manifest over
        # half-replaced shards
        os.remove(man)
        _fsync_dir(d)
    if many:
        # no writer renames its shard while a previous manifest may still
        # name the old bytes
        checkpoint_commit_barrier(
            f"{os.path.basename(d)}:{snap.epoch}:uncommit", snap.group)
    snap.wait()
    my_name = my_raw = None
    if snap.pieces:
        my_name, my_raw = _write_shard(d, snap)
    t_write = time.perf_counter()
    # drill site: shards renamed into place, manifest not yet published
    inject.maybe_kill_in_commit(snap.epoch)
    if many:
        checkpoint_commit_barrier(f"{os.path.basename(d)}:{snap.epoch}",
                                  snap.group)
    if snap.proc == 0:
        shards = []
        for p in snap.writer_procs:
            name = shard_file_name(p)
            if name == my_name:
                raw = my_raw
            else:
                # a peer's shard, landed before the barrier above
                with open(os.path.join(d, name), "rb") as f:
                    raw = f.read()
            shards.append({"file": name, "process": int(p),
                           "bytes": len(raw),
                           "crc32": zlib.crc32(raw) & 0xFFFFFFFF})
        commit_manifest(d, snap, shards)
    t_commit = time.perf_counter()
    stats = {"epoch": snap.epoch, "path": d,
             "block_ms": round(snap.block_ms, 3),
             "write_ms": round((t_write - t0) * 1e3, 3),
             "commit_ms": round((t_commit - t_write) * 1e3, 3),
             "save_ms": round((t_commit - t0) * 1e3 + snap.block_ms, 3),
             "bytes": len(my_raw) if my_raw is not None else 0,
             "shards": len(snap.writer_procs)}
    snap.stats = stats
    return stats


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    opt_state: AdamState, epoch: int,
                    rng: Optional[np.ndarray] = None,
                    fingerprint: Optional[Dict[str, Any]] = None) -> None:
    """Synchronous save: snapshot, CRC, shard write and commit on the
    calling thread (rank 0 writes; other ranks return)."""
    snap = snapshot_state(params, opt_state, epoch, rng=rng,
                          fingerprint=fingerprint)
    if snap.proc == 0:
        write_snapshot(path, snap)


# ---------------------------------------------------------------- loaders

def _read_checkpoint(path: str) -> Dict[str, np.ndarray]:
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:
        # torn write, zip CRC failure, truncation: one corruption class
        raise CheckpointCorrupt(
            f"{path}: unreadable ({type(e).__name__}: {e})") from e


def _parse_header(data: Dict[str, np.ndarray],
                  path: str) -> Optional[Dict[str, Any]]:
    raw = data.pop(_HEADER_KEY, None)
    if raw is None:
        return None
    try:
        return json.loads(bytes(
            np.asarray(raw, dtype=np.uint8)).decode("utf-8"))
    except Exception as e:
        raise CheckpointCorrupt(
            f"{path}: integrity header unparseable "
            f"({type(e).__name__}: {e})") from e


def _validate_integrity(data: Dict[str, np.ndarray],
                        header: Dict[str, Any], path: str) -> None:
    crcs = header.get("crc32") or {}
    missing = sorted(set(crcs) - set(data))
    extra = sorted(set(data) - set(crcs))
    if missing or extra:
        raise CheckpointCorrupt(
            f"{path}: array set mismatch (missing={missing}, "
            f"unexpected={extra})")
    for name, want in crcs.items():
        got = _crc(data[name])
        if got != int(want):
            raise CheckpointCorrupt(
                f"{path}: CRC32 mismatch at {name!r} "
                f"({got:#010x} != {int(want):#010x})")


def _validate_fingerprint(header: Dict[str, Any],
                          expect: Optional[Dict[str, Any]],
                          path: str) -> None:
    saved = header.get("fingerprint") or {}
    if not expect or not saved:
        return
    ss, es = saved.get("strict") or {}, expect.get("strict") or {}
    bad = sorted(k for k in set(ss) & set(es) if ss[k] != es[k])
    if bad:
        raise CheckpointCorrupt(
            f"{path}: config fingerprint mismatch at {bad} — this "
            f"checkpoint belongs to a different model/dataset/dtype "
            f"(saved {({k: ss[k] for k in bad})}, "
            f"restoring {({k: es[k] for k in bad})})")
    sv, ev = saved.get("elastic") or {}, expect.get("elastic") or {}
    if sv and ev and sv != ev:
        emit("resilience",
             f"elastic restore: checkpoint partition "
             f"P={sv.get('num_parts')} "
             f"({sv.get('part_nodes')}x{sv.get('part_edges')}) -> "
             f"current P={ev.get('num_parts')} "
             f"({ev.get('part_nodes')}x{ev.get('part_edges')}); "
             f"restored arrays are gathered to full host layout, the "
             f"partition is rebuilt from the current plan",
             kind="elastic_restore", saved=sv, current=ev)


def read_manifest(path: str) -> Dict[str, Any]:
    """The committed manifest of a v3 directory, or CheckpointCorrupt —
    an uncommitted directory is in the corruption class."""
    man = os.path.join(path, MANIFEST_NAME)
    try:
        with open(man) as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise CheckpointCorrupt(
            f"{path}: no committed manifest (save died before the "
            f"commit, or not a checkpoint directory)") from None
    except Exception as e:
        raise CheckpointCorrupt(
            f"{man}: manifest unreadable "
            f"({type(e).__name__}: {e})") from e
    if not isinstance(doc, dict) or \
            doc.get("version") != CHECKPOINT_VERSION or \
            not isinstance(doc.get("shards"), list) or not doc["shards"]:
        raise CheckpointCorrupt(f"{man}: malformed manifest")
    return doc


def is_committed(path: str) -> bool:
    """Cheap commit test for rotation scans (full validation happens on
    the restore attempt)."""
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, MANIFEST_NAME))


def _host_view(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A member's bytes as a numpy array: bf16 (``|V2`` on disk) as
    uint16, every other dtype as stored."""
    if dtype == BF16:
        return arr.view(np.uint16)
    return arr


def _load_v3(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any],
                                 Dict[str, str]]:
    """Validate and gather a v3 directory to full host arrays: every
    manifest-listed shard's existence, byte count, file CRC32, member
    CRC32s and every array's coverage are checked before anything is
    returned.  Returns ``(arrays, manifest, dtype names)``."""
    doc = read_manifest(path)
    pieces: Dict[str, List[Tuple[Optional[List[List[int]]],
                                 np.ndarray]]] = {}
    metas: Dict[str, Dict[str, Any]] = {}
    for sh in doc["shards"]:
        fp = os.path.join(path, str(sh.get("file")))
        try:
            with open(fp, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise CheckpointCorrupt(
                f"{path}: manifest lists {sh.get('file')} but the "
                f"shard is missing/unreadable ({e})") from e
        if len(raw) != int(sh.get("bytes", -1)) or \
                (zlib.crc32(raw) & 0xFFFFFFFF) != int(sh.get("crc32", -1)):
            raise CheckpointCorrupt(
                f"{fp}: shard bytes/CRC32 do not match the committed "
                f"manifest")
        try:
            with np.load(io.BytesIO(raw)) as z:
                data = {k: z[k] for k in z.files}
        except Exception as e:
            raise CheckpointCorrupt(
                f"{fp}: unreadable ({type(e).__name__}: {e})") from e
        header = _parse_header(data, fp)
        if header is None:
            raise CheckpointCorrupt(f"{fp}: shard has no header")
        _validate_integrity(data, header, fp)
        metas.update(header.get("arrays") or {})
        for member, pm in (header.get("pieces") or {}).items():
            pieces.setdefault(pm["key"], []).append(
                (pm.get("index"), data[member]))
    out: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, meta in metas.items():
        dt = dtypes[key] = str(meta["dtype"])
        ps = pieces.get(key, [])
        shape = tuple(int(d) for d in meta["shape"])
        total = int(np.prod(shape)) if shape else 1
        if len(ps) == 1 and ps[0][0] is None:
            out[key] = _host_view(ps[0][1], dt)
            continue
        full = np.zeros(shape, dtype=np.uint16 if dt == BF16 else dt)
        covered = 0
        for index, arr in ps:
            arr = _host_view(arr, dt)
            if index is None:
                full[...] = arr
            else:
                full[tuple(slice(lo, hi) for lo, hi in index)] = arr
            covered += int(arr.size)
        if covered != total:
            # pieces are disjoint by construction, so count equality
            # means every element was restored exactly once
            raise CheckpointCorrupt(
                f"{path}: array {key!r} gathered {covered}/{total} "
                f"elements from the saved shards (incomplete sharded "
                f"save)")
        out[key] = full
    return out, doc, dtypes


def _legacy_dtypes(data: Dict[str, np.ndarray]) -> Dict[str, str]:
    """v1/v2 files record no dtypes: a 2-byte void member is a bf16 leaf
    (the only thing ``np.savez`` writes so), read through uint16."""
    out = {}
    for k, a in data.items():
        if a.dtype == _BF16_DISK:
            out[k] = BF16
            data[k] = a.view(np.uint16)
        else:
            out[k] = a.dtype.name
    return out


def _load_legacy_file(path: str) -> Tuple[Dict[str, np.ndarray],
                                          Dict[str, Any], Dict[str, str]]:
    """v1/v2 single-file loader, each with its resilience event."""
    data = _read_checkpoint(path)
    header = _parse_header(data, path)
    if header is None:
        emit("resilience",
             f"{os.path.basename(path)}: v1 checkpoint (no integrity "
             f"header) — loading WITHOUT CRC/fingerprint validation",
             kind="v1_checkpoint", path=path)
        return data, {}, _legacy_dtypes(data)
    emit("resilience",
         f"{os.path.basename(path)}: legacy v2 single-file "
         f"checkpoint — loading (validated); the next save writes "
         f"the sharded v3 directory format",
         kind="legacy_checkpoint", path=path, version=2)
    _validate_integrity(data, header, path)
    return data, header, _legacy_dtypes(data)


def _load_any(path: str):
    if os.path.isdir(path):
        return _load_v3(path)
    return _load_legacy_file(path)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array (bf16 as uint16) → a CPU tensor of ``dtype``."""
    if dtype == BF16:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _leaf(data, dtypes, key: str, tmpl: torch.Tensor,
          path: str) -> torch.Tensor:
    if key not in data:
        raise CheckpointCorrupt(f"{path}: missing array {key!r} "
                                f"(template/checkpoint mismatch)")
    arr = data[key]
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise CheckpointCorrupt(f"{path}: shape mismatch at {key}: "
                                f"{tuple(arr.shape)} vs {tuple(tmpl.shape)}")
    return _to_tensor(arr, dtypes.get(key, arr.dtype.name)).to(
        device=tmpl.device, dtype=tmpl.dtype)


def _scalar(data, key: str, path: str) -> np.ndarray:
    if key not in data:
        raise CheckpointCorrupt(f"{path}: missing array {key!r}")
    return data[key]


def load_checkpoint(path: str, params_template: Dict[str, Any],
                    opt_template: AdamState,
                    expect_fingerprint: Optional[Dict[str, Any]] = None
                    ) -> Tuple[Dict[str, torch.Tensor], AdamState, int,
                               Optional[np.ndarray]]:
    """Restore against templates (a trainer's params and Adam state, or
    :class:`_Meta` leaves of the whole shapes):
    every leaf checked for presence and shape, every byte against the
    stored CRC32s, the strict fingerprint half against
    ``expect_fingerprint`` — any failure raises CheckpointCorrupt before
    anything is returned.  Returns ``(params, opt_state, epoch, rng)``:
    new tensors on the templates' devices and dtypes, and the generators'
    states (``[ranks, n]`` uint8) or None (a JAX checkpoint)."""
    data, header, dtypes = _load_any(path)
    _validate_fingerprint(header, expect_fingerprint, path)
    params = {k: _leaf(data, dtypes, f"params[{k!r}]", t, path)
              for k, t in params_template.items()}
    m, v = ({k: _leaf(data, dtypes, f"opt.{name}[{k!r}]", t, path)
             for k, t in tree.items()}
            for name, tree in (("m", opt_template.m),
                               ("v", opt_template.v)))
    opt_state = AdamState(
        step=int(_scalar(data, "opt.step", path)),
        beta1_t=np.float32(_scalar(data, "opt.beta1_t", path)),
        beta2_t=np.float32(_scalar(data, "opt.beta2_t", path)), m=m, v=v)
    epoch = int(_scalar(data, EPOCH_KEY, path))
    return params, opt_state, epoch, data.get(RNG_KEY)


def restore_params_only(path: str
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                                   int]:
    """``(params, fingerprint, epoch)`` without a trainer: the flat name
    → CPU tensor dict ``init_params`` produces, integrity-validated; the
    optimizer state is read past.  A server loads weights through this
    (``build_predictor(params=...)``) without building a trainer."""
    data, header, dtypes = _load_any(path)
    params: Dict[str, torch.Tensor] = {}
    # one single-quoted bracket segment only: a nested tree's
    # params['a']['b'] must hit the error below, not be mangled
    key_re = re.compile(r"^params\['([^']+)'\]$")
    bad = []
    for k, arr in data.items():
        if not k.startswith("params"):
            continue
        m = key_re.match(k)
        if m:
            params[m.group(1)] = _to_tensor(arr, dtypes.get(k,
                                                            arr.dtype.name))
        else:
            bad.append(k)
    if bad or not params:
        raise CheckpointCorrupt(
            f"{path}: expected flat params['<name>'] arrays — not a "
            f"trainer checkpoint, or a non-flat param tree this loader "
            f"does not speak" + (f" (unparsed keys: {bad[:3]})"
                                 if bad else ""))
    epoch = int(data[EPOCH_KEY]) if EPOCH_KEY in data else 0
    fingerprint = (header or {}).get("fingerprint") or {}
    return params, fingerprint, epoch


def restore_trainer(trainer, path: str) -> None:
    """Resume a Trainer or DistributedTrainer in place.  The loader
    gathers whatever layout was saved to full host arrays, so a
    checkpoint from another partition count or mesh restores (elastic
    restart); a sharded trainer (``trainer.sharding``, the 2-D mesh)
    keeps its slice of each.  The values are written into the trainer's
    existing leaves with ``copy_`` (Adam updates params, ``m`` and ``v``
    in place and the trainer holds those leaves); the step scalars, the
    epoch and the dropout generator (``Trainer.restore_rng``) follow."""
    sh = getattr(trainer, "sharding", None)
    whole = _whole_meta(trainer)
    opt = trainer.opt_state
    tmpl = opt if sh is None else opt._replace(
        m={k: _Meta(sh.full_shapes[k], torch.float32) for k in opt.m},
        v={k: _Meta(sh.full_shapes[k], torch.float32) for k in opt.v})
    params, opt_state, epoch, rng = load_checkpoint(
        path, whole, tmpl, expect_fingerprint=trainer_fingerprint(trainer))

    def mine(k, t):
        return t if sh is None else sh.local(k, t)

    with torch.no_grad():
        for k, p in trainer.params.items():
            p.copy_(mine(k, params[k]))
        for have, got in ((trainer.opt_state.m, opt_state.m),
                          (trainer.opt_state.v, opt_state.v)):
            for k, t in have.items():
                t.copy_(mine(k, got[k]))
    trainer.opt_state = trainer.opt_state._replace(
        step=opt_state.step, beta1_t=opt_state.beta1_t,
        beta2_t=opt_state.beta2_t)
    trainer.epoch = epoch
    trainer.restore_rng(rng)


def checkpoint_trainer(trainer, path: str) -> Optional[Dict[str, Any]]:
    """Save a trainer's state synchronously.  Every trainer save passes
    the finite guard first (params and Adam state, one host sync,
    ``resilience/recovery.check_params_finite``): a poisoned state never
    persists.  Every rank calls it; the ranks that run
    :func:`write_snapshot` (:func:`writes`) get the save's stats, the
    others None."""
    from ..resilience.recovery import check_params_finite
    check_params_finite(trainer.params, trainer.opt_state)
    snap = snapshot_trainer(trainer)
    return write_snapshot(path, snap) if writes(snap) else None
