"""Quantized serving tables (``roc_tpu/serve/quant.py``): symmetric
per-row int8 / fp8-e4m3 codes with fp32 scales, the params codec and the
accuracy drift gate.

- **Scheme**: ``scale[r] = amax(|x[r]|) / Q`` (all-zero rows take 1.0)
  and ``q[r] = clip(rint(x[r] / scale[r]), -Q, Q)``, ``Q = 127`` for
  int8; fp8-e4m3 stores the scaled row itself, ``Q = 448`` (the format's
  finite max).  Per-row, because after ``S^k`` a hub row carries orders
  of magnitude more mass than a leaf.
- **Round trip**: a row's largest element maps to exactly ±Q, so
  ``quantize(dequantize(quantize(x))) == quantize(x)`` bit for bit; an
  artifact that stores ``(q, scale)`` rebuilds the exact device table.
- **Dequantize the gathered rows only**: the serve step gathers
  ``[bucket, F]`` code rows and their scales and widens those
  (serve/predictor.py); the ``[V, F]`` table never exists in fp32 on the
  card.
- **Drift gate**: export measures argmax agreement and the relative max
  |Δlogit| against the fp32 reference on a held-out node sample and
  refuses (:class:`QuantDriftError`) past the thresholds, before any
  file is written; a refreshed row whose scale leaves the envelope
  recorded at build refuses to publish.

The host codec is numpy with the JAX package's arithmetic.  fp8 goes
through ``torch.float8_e4m3fn`` (round to nearest even, as ``ml_dtypes``
does); its codes persist and travel as their ``uint8`` bytes.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

QMODES = ("off", "int8", "fp8")

INT8_QMAX = 127.0
FP8_QMAX = 448.0          # float8_e4m3fn finite max

# drift-gate defaults (the export CLI's --drift-* flags override them):
# argmax agreement on the sample, and max |Δlogit| relative to
# max(1, max |ref logit|)
DRIFT_ARGMAX_MIN = 0.99
DRIFT_DLOGIT_MAX = 0.02
DRIFT_SAMPLE = 512        # held-out node sample size (deterministic)

# a refreshed row may grow (new edges add mass), but one whose scale
# passes the build-time max times this slack refuses to publish
SCALE_GUARD_SLACK = 4.0


class QuantDriftError(RuntimeError):
    """Quantized serving would drift past the gate: export refuses to
    write the artifact; invalidation refuses to publish the version."""


class QuantSpec(NamedTuple):
    """The serialised quantization contract an artifact carries."""
    mode: str                     # "off" | "int8" | "fp8"
    scheme: str = "symmetric-per-row"

    def to_json(self) -> Dict[str, Any]:
        return {"mode": self.mode, "scheme": self.scheme}

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "QuantSpec":
        if not d:
            return cls("off")
        return cls(str(d.get("mode", "off")),
                   str(d.get("scheme", "symmetric-per-row")))


def check_mode(mode: str) -> str:
    if mode not in QMODES:
        raise ValueError(f"unknown quant mode {mode!r}; have {QMODES}")
    if mode == "fp8" and not fp8_supported():
        raise ValueError("quant mode 'fp8' needs torch.float8_e4m3fn; "
                         "int8 is the portable floor")
    return mode


def fp8_supported() -> bool:
    return hasattr(torch, "float8_e4m3fn")


def storage_dtype(mode: str) -> np.dtype:
    """The host storage dtype of one quantized table: int8, or the
    fp8 codes' bytes as uint8."""
    if mode == "int8":
        return np.dtype(np.int8)
    if mode == "fp8":
        return np.dtype(np.uint8)
    raise ValueError(f"no storage dtype for quant mode {mode!r}")


def qmax_of(mode: str) -> float:
    return INT8_QMAX if mode == "int8" else FP8_QMAX


def _fp8_encode(scaled: np.ndarray) -> np.ndarray:
    """fp32 → fp8-e4m3 codes as uint8 bytes (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(scaled)).to(
        torch.float8_e4m3fn).view(torch.uint8).numpy()


def _fp8_decode(raw: np.ndarray) -> np.ndarray:
    """uint8 fp8-e4m3 bytes → their exact fp32 values."""
    return torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8)).view(
        torch.float8_e4m3fn).to(torch.float32).numpy()


# -------------------------------------------------------- core codec

def row_scales(x: np.ndarray, mode: str) -> np.ndarray:
    """fp32 ``[V]`` per-row scales; all-zero rows get 1.0 (their codes
    are exactly zero)."""
    amax = np.max(np.abs(np.asarray(x, dtype=np.float32)), axis=1)
    scale = amax / qmax_of(mode)
    scale[scale == 0.0] = 1.0
    return scale.astype(np.float32)


def quantize_rows(x: np.ndarray, mode: str,
                  scale: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``(q, scale)`` for an fp32 ``[V, F]`` table: int8 codes, or fp8
    codes as uint8 bytes, under the per-row scales :func:`row_scales`
    derives, or under ``scale`` when given (a re-encode under a pinned
    envelope; the round-trip identity needs the derived scales)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError(f"quantize_rows wants [V, F], got {x.shape}")
    if scale is None:
        scale = row_scales(x, mode)
    scaled = x / scale[:, None]
    if mode == "int8":
        q = np.clip(np.rint(scaled), -INT8_QMAX,
                    INT8_QMAX).astype(np.int8)
    elif mode == "fp8":
        q = _fp8_encode(scaled)
    else:
        raise ValueError(f"cannot quantize to mode {mode!r}")
    return q, scale


def code_values(q: np.ndarray) -> np.ndarray:
    """The fp32 values of a code array: int8 as is, uint8 read as fp8
    bytes."""
    q = np.asarray(q)
    if q.dtype == np.uint8:
        return _fp8_decode(q)
    return q.astype(np.float32)


def dequantize_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Host fp32 reconstruction (build and load paths only: the serve
    step dequantizes the gathered rows on the device)."""
    return code_values(q) * np.asarray(scale, dtype=np.float32)[:, None]


# ---------------------------------------------------- persistence aid

def to_storage_bytes(q: np.ndarray) -> np.ndarray:
    """npz form of a quantized payload: its bytes as uint8, the JAX
    package's member format for int8 and fp8 alike."""
    return np.asarray(q).view(np.uint8)


def from_storage_bytes(raw: np.ndarray, mode: str) -> np.ndarray:
    return np.asarray(raw, dtype=np.uint8).view(storage_dtype(mode))


# ----------------------------------------------------------- params

PARAMS_SCALE_SUFFIX = "::scale"


def quantize_params(host_params: Dict[str, np.ndarray], mode: str
                    ) -> Tuple[Dict[str, np.ndarray],
                               Dict[str, np.ndarray], List[str]]:
    """Per-row quantization of the exportable params: every float leaf
    of two or more dims quantizes along its leading axis (a companion
    ``<key>::scale`` carries the scales); the rest stays verbatim.
    Returns ``(store, roundtrip, quantized_keys)``: ``store`` is what
    ``params.npz`` holds, ``roundtrip`` the dequantized params the
    export-time predictor serves with, so export and cold load serve the
    same values."""
    store: Dict[str, np.ndarray] = {}
    roundtrip: Dict[str, np.ndarray] = {}
    qkeys: List[str] = []
    for k, v in host_params.items():
        v = np.asarray(v)
        if v.ndim >= 2 and np.issubdtype(v.dtype, np.floating):
            mat = v.reshape(v.shape[0], -1).astype(np.float32)
            q, sc = quantize_rows(mat, mode)
            store[k] = to_storage_bytes(q).reshape(v.shape)
            store[k + PARAMS_SCALE_SUFFIX] = sc
            roundtrip[k] = dequantize_rows(q, sc) \
                .reshape(v.shape).astype(v.dtype)
            qkeys.append(k)
        else:
            store[k] = v
            roundtrip[k] = v
    return store, roundtrip, qkeys


def dequantize_params(raw: Dict[str, np.ndarray], mode: str
                      ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`quantize_params` for a loaded ``params.npz``
    (storage bytes + ``::scale`` companions → fp32)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in raw.items():
        if k.endswith(PARAMS_SCALE_SUFFIX):
            continue
        sk = k + PARAMS_SCALE_SUFFIX
        if sk in raw:
            q = from_storage_bytes(
                np.asarray(v).reshape(v.shape[0], -1), mode)
            out[k] = dequantize_rows(q, raw[sk]) \
                .reshape(v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


# ------------------------------------------------------- measurement

def table_bytes(shape: Tuple[int, int], mode: str) -> int:
    """Bytes of ONE ``[V, F]`` table under ``mode`` (quantized modes
    carry their fp32 per-row scales)."""
    v, f = int(shape[0]), int(shape[1])
    if mode == "off":
        return v * f * 4
    return v * f * storage_dtype(mode).itemsize + v * 4


def scale_stats(scale: np.ndarray) -> Dict[str, float]:
    s = np.asarray(scale, dtype=np.float64)
    return {"min": round(float(s.min()), 8),
            "max": round(float(s.max()), 8),
            "mean": round(float(s.mean()), 8)}


def drift_report(ref_logits: np.ndarray, q_logits: np.ndarray,
                 argmax_min: float = DRIFT_ARGMAX_MIN,
                 dlogit_max: float = DRIFT_DLOGIT_MAX
                 ) -> Dict[str, Any]:
    """Drift of the quantized path against the fp32 reference on one
    node sample: argmax agreement and max |Δlogit|, with the verdict."""
    ref = np.asarray(ref_logits, dtype=np.float32)
    got = np.asarray(q_logits, dtype=np.float32)
    if ref.shape != got.shape:
        raise ValueError(f"drift shapes differ: {ref.shape} vs "
                         f"{got.shape}")
    n = max(ref.shape[0], 1)
    agree, dmax, refmax = 1.0, 0.0, 0.0
    if ref.size:
        eq = ref.argmax(axis=1) == got.argmax(axis=1)
        agree = float(np.mean(eq))
        dmax = float(np.abs(ref - got).max())
        refmax = float(np.abs(ref).max())
    rel = dmax / max(1.0, refmax)
    return {"sample": int(n),
            "argmax_agreement": round(agree, 6),
            "max_abs_dlogit": round(dmax, 6),
            "ref_max_logit": round(refmax, 6),
            "rel_dlogit": round(rel, 6),
            "argmax_min": argmax_min,
            "dlogit_max": dlogit_max,
            "ok": bool(agree >= argmax_min and rel <= dlogit_max)}


def require_drift_ok(report: Dict[str, Any], where: str) -> None:
    """Raise :class:`QuantDriftError`, with the measurement, when the
    gate failed."""
    if not report.get("ok"):
        raise QuantDriftError(
            f"{where}: quantization drift gate FAILED — argmax "
            f"agreement {report['argmax_agreement']} (need >= "
            f"{report['argmax_min']}), relative max |dlogit| "
            f"{report['rel_dlogit']} (need <= {report['dlogit_max']}; "
            f"abs {report['max_abs_dlogit']} on ref magnitude "
            f"{report['ref_max_logit']}) on {report['sample']} "
            f"sampled node(s); export/serve fp32 or relax the "
            f"thresholds deliberately")


def drift_sample(num_nodes: int, n: int = DRIFT_SAMPLE,
                 seed: int = 0) -> np.ndarray:
    """The held-out node sample, deterministic per (V, n, seed): the
    JAX package's draw."""
    rng = np.random.RandomState(seed)
    n = min(int(n), int(num_nodes))
    return np.sort(rng.choice(num_nodes, size=n,
                              replace=False)).astype(np.int32)


# ----------------------------------------------------- capture hook

class QuantizingCapture:
    """A ``stream_prefix_to_host`` capture sink that encodes each stage
    as it streams: the walk hands the sink arrays it owns alone, so the
    fp32 stage can go as soon as its ``(q, scale)`` pair is taken, and
    the host holds one fp32 stage instead of all k (the export of a
    graph whose stages do not fit in host memory together).

    ``keep_fp32_last`` also keeps the last stage in fp32 (the drift
    gate's reference)."""

    def __init__(self, mode: str, keep_fp32_last: bool = False):
        self.mode = check_mode(mode)
        if self.mode == "off":
            raise ValueError("QuantizingCapture needs a quantized mode; "
                             "pass a plain list for fp32")
        self.keep_fp32_last = keep_fp32_last
        self.stages: list = []          # (q, scale) per stage
        self.last_fp32: Optional[np.ndarray] = None

    def append(self, x: np.ndarray) -> None:
        self.stages.append(quantize_rows(x, self.mode))
        if self.keep_fp32_last:
            self.last_fp32 = x

    def dequantized(self) -> list:
        return [dequantize_rows(q, s) for q, s in self.stages]
