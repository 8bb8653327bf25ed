"""Fused SoA row lookup.

`take_rows` gathers rows from MANY parallel SoA arrays with ONE fused
`jnp.take`: all fields are packed column-wise into a single [M, K] f32
matrix — packing is loop-invariant, so XLA hoists it out of the bounce
loop — and one gather fetches every field of the row, instead of one
gather per field. (A one-hot [N, M] @ [M, K] matmul form lost to the
gather on an H100 at every table size measured, 8 to 4096 rows; see
PERF.md.)

Int/bool columns round-trip through f32: exact for |value| < 2^24, which
holds for every id/enum table in the scene (validate_int_tables guards it
at build time).

Reference analog: the pointer-chasing `getObjectMatPtr`/`Material` copies
(shapes/shapes.cpp:316, util/shaderec.h:7-19) — "follow a pointer per
hit" becomes one batched row fetch.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_INT_EXACT_LIMIT = 1 << 24


def take_rows(idx, arrays):
    """Gather row `idx[i]` from every array in `arrays` as ONE fused lookup.

    idx: [N] int. arrays: sequence of [M] / [M, k] / [M, k1, k2] arrays
    sharing leading dim M. Returns a tuple of [N, ...] arrays with each
    input's dtype and trailing shape. Out-of-range indices are clamped
    (jnp.take semantics). Gradients flow into float table entries.
    """
    arrays = tuple(arrays)
    m = int(arrays[0].shape[0])
    n = idx.shape[0]

    if m == 1:
        # Degenerate table: the row is a broadcast, no lookup needed.
        return tuple(jnp.broadcast_to(a[0], (n,) + a.shape[1:]) for a in arrays)

    cols = []
    widths = []
    for a in arrays:
        if a.shape[0] != m:
            raise ValueError("take_rows arrays must share a leading dim")
        flat = a.reshape(m, -1).astype(jnp.float32)
        cols.append(flat)
        widths.append(flat.shape[1])
    packed = cols[0] if len(cols) == 1 else jnp.concatenate(cols, axis=1)

    idx_c = jnp.clip(idx, 0, m - 1).astype(jnp.int32)
    out = jnp.take(packed, idx_c, axis=0)

    res = []
    c = 0
    for a, w in zip(arrays, widths):
        col = out[:, c:c + w]
        c += w
        col = col.reshape((n,) + a.shape[1:])
        if a.dtype == jnp.bool_:
            col = col != 0.0
        elif col.dtype != a.dtype:
            col = col.astype(a.dtype)
        res.append(col)
    return tuple(res)


def validate_int_tables(*arrays) -> None:
    """Build-time guard: every integer SoA table routed through take_rows
    must stay below the f32-exact limit."""
    for a in arrays:
        a = np.asarray(a)
        if a.size and np.issubdtype(a.dtype, np.integer):
            if np.abs(a).max() >= _INT_EXACT_LIMIT:
                raise ValueError(
                    f"integer table value {np.abs(a).max()} exceeds the "
                    f"f32-exact take_rows limit {_INT_EXACT_LIMIT}")
