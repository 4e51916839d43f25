"""Column slices of the neighbour-sum kernels K3 and K4.

Both kernels (csrc/row_gather.cuh) split the F columns of ``feats`` into
slices of ``slice_cols`` columns and walk them slice-major, so that the
slice being gathered from stays in the card's L2; ``slice_cols=0`` is
one slice of all F, the unsliced schedule.  Each width in
:data:`SLICE_COLS` is one compiled instance, in fp32 and in bf16.  What
L2 holds is bytes, ``V * slice_cols * itemsize``: a bf16 slice of 64
columns is the size of an fp32 slice of 32, so the widths run to 128 for
bf16 to reach the fp32 widths' bytes.  Which one is fastest depends on F
and the dtype: each wrapper's ``default_slice_cols`` is the choice of the
race of all instances in ``chip_smoke.py`` on an H100 at the two layer
widths of the 602-256-41 GCN (``PERF.md``), applied to every F by
:func:`default_slice_cols`.
"""

from __future__ import annotations

from typing import Optional

SLICE_COLS = (0, 16, 32, 64, 128)

# The widest F that takes the narrow layer's choice: up to 64 columns a
# 64-column slice is the whole row, so slicing has nothing to split.
NARROW_F = 64


def default_slice_cols(F: int, wide: int) -> int:
    """The slice width for F columns: 0 (unsliced: a warp per row
    walking all of F, its row in back-to-back loads) up to
    :data:`NARROW_F`, where it beats every sliced instance at F = 41;
    ``wide``, the kernel's winner at F = 256, above."""
    return 0 if F <= NARROW_F else wide


def resolve(name: str, slice_cols: Optional[int], default: int) -> int:
    """``slice_cols``, or ``default`` where it is None; raises on a width
    with no compiled instance."""
    if slice_cols is None:
        return default
    if (isinstance(slice_cols, bool) or not isinstance(slice_cols, int)
            or slice_cols not in SLICE_COLS):
        raise ValueError(f"{name}: slice_cols must be one of {SLICE_COLS} "
                         f"or None, got {slice_cols!r}")
    return slice_cols
