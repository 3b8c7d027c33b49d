"""Row-partitioned block-ELL operator with explicit halo exchange.

The distributed-memory layer the reference never had (SURVEY.md §2.3: MPI is
linked but unexercised).  Design:

- nodes are RCM/band ordered, block-rows split into `n_devices` contiguous
  chunks of L rows each (padded with identity rows),
- the band property bounds every chunk's column references to its own rows
  plus `halo` rows on each side, so one bidirectional `lax.ppermute` per SpMV
  moves exactly the 2*halo boundary rows between devices — the minimum
  communication for a banded operator,
- column indices are stored as position-invariant offsets `delta = col - row`
  (|delta| <= halo), so ghost rows received from a neighbor use the same
  gather arithmetic as own rows — no per-partition rebasing tables,
- inside `shard_map` each device gathers from its (L + 2*halo, 4) window and
  runs the same 4x4-block einsum as the single-chip kernel,
- Krylov dots/norms on the globally-sharded vectors are partitioned by XLA
  into local reductions + `psum` automatically.

Matrix powers: `partitioned_spmv_power` computes A^k x with ONE k*halo-deep
exchange of x *and* of the boundary operator rows, then k local sweeps that
redundantly compute a shrinking ghost region — the communication-avoiding
A^k x of the reference's mpk suite (`Generate1stlayer`,
`mpk/SpMVmulti0.cpp:22-40`) re-expressed as ghost-layer tiling across
devices.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


@dataclasses.dataclass
class RowPartition:
    """Static partition layout (host-side)."""

    n_devices: int
    rows_per_dev: int            # L (block rows per device)
    halo: int                    # H (block rows exchanged per side)
    nb: int                      # true block rows
    nb_pad: int                  # n_devices * L
    slots: int
    delta_indices: np.ndarray    # (nb_pad, S) int32: col - row in [-H, H]
    pad_diag_slot: int = 0       # slot holding identity in padding rows


def build_row_partition(
    ell_indices: np.ndarray, n_devices: int, halo: int | None = None
) -> RowPartition:
    """Partition a block-ELL pattern into contiguous row chunks.

    Requires the banded property max |col - row| <= halo <= L.
    Padding rows reference themselves (delta 0).
    """
    nb, slots = ell_indices.shape
    L = -(-nb // n_devices)
    nb_pad = L * n_devices

    rows = np.arange(nb, dtype=np.int64)[:, None]
    delta = ell_indices.astype(np.int64) - rows
    bw = int(np.abs(delta).max()) if nb else 0
    if halo is None:
        halo = bw
    if bw > halo:
        raise ValueError(f"block bandwidth {bw} exceeds halo {halo}")
    if halo > L:
        raise ValueError(
            f"halo {halo} exceeds rows-per-device {L}: too many devices for "
            "this mesh bandwidth (refine the mesh or reduce n_devices)"
        )

    delta_pad = np.zeros((nb_pad, slots), dtype=np.int32)
    delta_pad[:nb] = delta
    return RowPartition(
        n_devices=n_devices,
        rows_per_dev=L,
        halo=halo,
        nb=nb,
        nb_pad=nb_pad,
        slots=slots,
        delta_indices=delta_pad,
    )


def pad_ell_values(part: RowPartition, values: jnp.ndarray) -> jnp.ndarray:
    """(nb, S, 4, 4) -> (nb_pad, S, 4, 4) with identity blocks in pad rows."""
    n_pad = part.nb_pad - part.nb
    if n_pad == 0:
        return values
    pad = jnp.zeros((n_pad, part.slots, 4, 4), dtype=values.dtype)
    pad = pad.at[:, part.pad_diag_slot].set(jnp.eye(4, dtype=values.dtype))
    return jnp.concatenate([values, pad], axis=0)


def pad_vector(part: RowPartition, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.pad(x, (0, 4 * (part.nb_pad - part.nb)))


def unpad_vector(part: RowPartition, x: jnp.ndarray) -> jnp.ndarray:
    return x[: 4 * part.nb]


def _exchange(arr, depth: int, axis: str, n_dev: int):
    """Fetch `depth` leading/trailing rows of `arr` from each neighbor.

    arr: (L, ...) local rows.  Returns (L + 2*depth, ...); edge devices get
    zero ghosts (never referenced under the band property).
    """
    if depth == 0:
        return arr
    pad_shape = (depth,) + arr.shape[1:]
    if n_dev == 1:
        pad = jnp.zeros(pad_shape, arr.dtype)
        return jnp.concatenate([pad, arr, pad])
    right_shift = [(i, i + 1) for i in range(n_dev - 1)]
    left_shift = [(i + 1, i) for i in range(n_dev - 1)]
    from_left = jax.lax.ppermute(arr[-depth:], axis, right_shift)
    from_right = jax.lax.ppermute(arr[:depth], axis, left_shift)
    return jnp.concatenate([from_left, arr, from_right])


def partitioned_spmv(
    part: RowPartition,
    mesh: Mesh,
    axis: str,
    delta_indices: jnp.ndarray,   # (nb_pad, S) device array
    values: jnp.ndarray,          # (nb_pad, S, 4, 4)
    x: jnp.ndarray,               # (4 * nb_pad,)
) -> jnp.ndarray:
    """y = A x with one bidirectional halo exchange."""
    n_dev, H, L = part.n_devices, part.halo, part.rows_per_dev

    def body(delta_loc, vals_loc, x_loc):
        xw = _exchange(x_loc, H, axis, n_dev)           # (L + 2H, 4)
        q = jax.lax.broadcasted_iota(jnp.int32, (L, 1), 0)
        gather_at = q + delta_loc + H                   # (L, S), in [0, L+2H)
        g = xw[gather_at]                               # (L, S, 4)
        return jnp.einsum("rsab,rsb->ra", vals_loc, g,
                          precision=jax.lax.Precision.HIGHEST)

    y4 = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None, None, None), P(axis, None)),
        out_specs=P(axis, None),
    )(delta_indices, values, x.reshape(part.nb_pad, 4))
    return y4.reshape(-1)


def partitioned_spmv_dia(
    mesh: Mesh,
    axis: str,
    offsets: tuple,
    data: jnp.ndarray,     # (K, n_pad) scalar-DIA data, zero-padded columns
    x: jnp.ndarray,        # (n_pad,)
    n_devices: int,
) -> jnp.ndarray:
    """Scalar-DIA SpMV over a device mesh: one bidirectional halo exchange of
    max|offset| boundary scalars, then the same unrolled shifted multiply-adds
    as the single-chip fast path (`ops.spmv.spmv_dia`) on each local chunk.

    Requires n_pad % n_devices == 0 and halo <= rows-per-device.  Padding
    rows must carry zero data columns (they then stay identically zero).
    """
    n_pad = data.shape[1]
    if n_pad % n_devices:
        raise ValueError("n_pad must divide evenly across devices")
    L = n_pad // n_devices
    h = max(max(abs(d) for d in offsets), 1)
    if h > L:
        raise ValueError(f"scalar halo {h} exceeds rows-per-device {L}")

    def body(data_loc, x_loc):
        xw = _exchange(x_loc, h, axis, n_devices)       # (L + 2h,)
        y = jnp.zeros(L, x_loc.dtype)
        for k, d in enumerate(offsets):
            y = y + data_loc[k] * jax.lax.dynamic_slice(xw, (h + d,), (L,))
        return y

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=P(axis),
    )(data, x)


def partitioned_spmv_plane(
    mesh: Mesh,
    axis: str,
    node_offsets: tuple,
    planes: jnp.ndarray,   # (n_out, NT, nbp) plane data, nodes sharded
    x: jnp.ndarray,        # (n_in * nbp,) flat plane-major
    n_devices: int,
) -> jnp.ndarray:
    """Component-plane SpMV over a device mesh: nodes are row-partitioned,
    each device holds its slice of ALL planes, and one bidirectional
    ppermute of the node halo (per plane, batched as an (n_in, h) exchange)
    feeds the per-shard plane SpMV (`ops.plane_dia.spmv_planes`).  This
    keeps the 0.74x-bytes layout intact under distribution — vectors stay
    plane-major end to end; only the halo moves between devices.
    """
    from navierstokes_tpu.ops.plane_dia import plane_halo, spmv_planes

    n_out, nt, nbp = planes.shape
    n_in = nt // len(node_offsets)
    if nbp % n_devices:
        raise ValueError("padded node count must divide evenly across devices")
    Lb = nbp // n_devices
    h = plane_halo(node_offsets)
    if h > Lb:
        raise ValueError(f"node halo {h} exceeds nodes-per-device {Lb}")

    def body(p_loc, x_loc):
        # x_loc: (n_in, Lb).  Exchange along the node axis for all planes at
        # once (leading-axis exchange on the transposed view).
        xw = _exchange(x_loc.T, h, axis, n_devices).T   # (n_in, Lb + 2h)
        y = spmv_planes(node_offsets, p_loc, xw.reshape(-1), x_prehalo=True)
        return y.reshape(n_out, Lb)

    y = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, None, axis), P(None, axis)),
        out_specs=P(None, axis),
    )(planes, x.reshape(n_in, nbp))
    return y.reshape(-1)


def partitioned_spmv_dia_power(
    mesh: Mesh,
    axis: str,
    offsets: tuple,
    data: jnp.ndarray,     # (K, n_pad)
    x: jnp.ndarray,        # (n_pad,)
    n_devices: int,
    k: int,
    return_all: bool = False,
    shifts: tuple = None,
):
    """Communication-avoiding A^j x (j = 1..k) on the scalar-DIA layout:
    ONE k*h-deep halo exchange of x and a (k-1)*h-deep exchange of the
    operator columns, then k masked local sweeps.  Own rows stay valid after
    every sweep, so `return_all=True` yields the full one-exchange s-step
    Krylov power stack (n_pad, k).  Requires k * h <= rows-per-device.

    `shifts` (k floats) turns the sweeps into the Newton-basis products
    prod_j (A - shifts[j] I) x (solvers/sstep.py): the shift is a local
    elementwise subtraction, so the one-exchange communication structure
    is unchanged.
    """
    K, n_pad = data.shape
    if n_pad % n_devices:
        raise ValueError("n_pad must divide evenly across devices")
    L = n_pad // n_devices
    h = max(max(abs(d) for d in offsets), 1)
    D = k * h
    if D > L:
        raise ValueError(f"k*halo = {D} exceeds rows-per-device {L}")
    ghost = D - h

    def body(data_loc, x_loc):
        xw = _exchange(x_loc, D, axis, n_devices)               # (L + 2D,)
        data_ext = _exchange(data_loc.T, ghost, axis, n_devices).T
        ext = L + 2 * D
        inner = ext - 2 * h                                     # rows computed
        pos = jax.lax.broadcasted_iota(jnp.int32, (ext, 1), 0).squeeze(-1)

        cur = xw
        own = []
        for s in range(k):
            y = jnp.zeros(inner, x_loc.dtype)
            for kk, d in enumerate(offsets):
                y = y + data_ext[kk] * jax.lax.dynamic_slice(
                    cur, (h + d,), (inner,)
                )
            if shifts is not None:
                y = y - shifts[s] * jax.lax.dynamic_slice(cur, (h,), (inner,))
            y = jnp.pad(y, (h, h))
            valid = (pos >= (s + 1) * h) & (pos < ext - (s + 1) * h)
            cur = jnp.where(valid, y, 0.0)
            if return_all:
                own.append(cur[D : D + L])
        if return_all:
            return jnp.stack(own, axis=-1)                      # (L, k)
        return cur[D : D + L]

    out_spec = P(axis, None) if return_all else P(axis)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=out_spec,
    )(data, x)


def partitioned_spmv_power(
    part: RowPartition,
    mesh: Mesh,
    axis: str,
    delta_indices: jnp.ndarray,
    values: jnp.ndarray,
    x: jnp.ndarray,
    k: int,
    return_all: bool = False,
    shifts: tuple = None,
) -> jnp.ndarray:
    """Communication-avoiding A^k x: one k*H-deep exchange + k local sweeps.

    Ghost rows are recomputed redundantly (the classic CA compute/comm
    trade): sweep s computes valid rows at window offsets
    [(s+1)*H, L + 2*D - (s+1)*H), so after k sweeps exactly the own rows
    [D, D + L) remain — all from a single exchange of x and of the D-H deep
    boundary *operator* rows.  Requires k * H <= L.

    return_all=True returns the stacked powers [A x, ..., A^k x] with shape
    (4*nb_pad, k) — the own rows stay valid after every sweep, which is what
    makes a one-exchange s-step Krylov basis possible (`solvers/sstep.py`).
    `shifts` (k floats) produces the Newton-basis products
    prod_j (A - shifts[j] I) x instead (see partitioned_spmv_dia_power).
    """
    n_dev, H, L = part.n_devices, part.halo, part.rows_per_dev
    D = k * H
    if D > L:
        raise ValueError(f"k*halo = {D} exceeds rows-per-device {L}")
    if shifts is None and k == 1 and not return_all:
        return partitioned_spmv(part, mesh, axis, delta_indices, values, x)

    ghost = D - H  # operator rows needed beyond own (stencil depth H less)

    def body(delta_loc, vals_loc, x_loc):
        xw = _exchange(x_loc, D, axis, n_dev)                  # (L+2D, 4)
        delta_ext = _exchange(delta_loc, ghost, axis, n_dev)   # (L+2(D-H), S)
        vals_ext = _exchange(vals_loc, ghost, axis, n_dev)

        ext = L + 2 * D
        q = jax.lax.broadcasted_iota(jnp.int32, (ext - 2 * H, 1), 0)
        # Row at window offset p in [H, ext-H) uses operator row p-H of the
        # ext arrays and gathers at p + delta.
        gather_at = jnp.clip(q + H + delta_ext, 0, ext - 1)    # (ext-2H, S)

        cur = xw
        own = []
        for s in range(k):
            g = cur[gather_at]                                  # (ext-2H, S, 4)
            y = jnp.einsum("rsab,rsb->ra", vals_ext, g,
                           precision=jax.lax.Precision.HIGHEST)
            if shifts is not None:
                y = y - shifts[s] * cur[H:ext - H]
            y = jnp.pad(y, ((H, H), (0, 0)))                    # back to (ext, 4)
            off = jax.lax.broadcasted_iota(jnp.int32, (ext, 1), 0)
            valid = (off >= (s + 1) * H) & (off < ext - (s + 1) * H)
            cur = jnp.where(valid, y, 0.0)
            if return_all:
                own.append(cur[D : D + L])
        if return_all:
            return jnp.stack(own, axis=-1)                      # (L, 4, k)
        return cur[D : D + L]

    out_spec = P(axis, None, None) if return_all else P(axis, None)
    y4 = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None, None, None), P(axis, None)),
        out_specs=out_spec,
    )(delta_indices, values, x.reshape(part.nb_pad, 4))
    if return_all:
        return y4.reshape(4 * part.nb_pad, k)
    return y4.reshape(-1)


# ---------------------------------------------------------------------------
# Partitioned assembly (sharded setup — no per-device replication)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ElementPartition:
    """Static per-shard element ranges for distributed DIA assembly.

    Elements are assigned to the device owning their minimum scalar row;
    an element's row span is bounded by the scalar halo (the max |col-row|
    of the DIA pattern covers every intra-element node pair), so each
    device's scatter targets fit a (K, L + halo) local buffer and ONE
    right-neighbor ppermute of the halo columns completes the assembly.
    The reference assembles serially into one address space
    (`src/solve_newton.c:200-615`); this is its domain-decomposed analog.
    """

    n_devices: int
    L: int                        # scalar rows per device
    halo: int
    n_pad: int                    # n_devices * L
    e_max: int                    # padded elements per device
    perm: np.ndarray              # (P*e_max,) element id, clipped for pads
    local_map: np.ndarray         # (P*e_max, 256) scatter map into (K, L+halo)
    K: int
    ndof: int


def build_element_partition(
    tets: np.ndarray, dia_elem_map: np.ndarray, ndof: int, K: int,
    halo: int, n_devices: int,
) -> ElementPartition:
    ne = tets.shape[0]
    P_ = n_devices
    L = max(-(-ndof // P_), halo)
    n_pad = P_ * L
    Lh = L + halo

    min_row = 4 * np.asarray(tets).min(axis=1).astype(np.int64)
    dev = np.minimum(min_row // L, P_ - 1)
    order = np.argsort(dev, kind="stable")
    counts = np.bincount(dev, minlength=P_)
    e_max = max(int(counts.max()), 1)

    perm = np.zeros(P_ * e_max, dtype=np.int64)
    sacrificial = np.full(256, K * Lh, dtype=np.int64)
    local_map = np.tile(sacrificial, (P_ * e_max, 1))
    gmap = np.asarray(dia_elem_map).reshape(ne, 256)
    pos = 0
    for d in range(P_):
        c = int(counts[d])
        ids = order[pos:pos + c]
        pos += c
        sl = slice(d * e_max, d * e_max + c)
        perm[sl] = ids
        g = gmap[ids]
        k = g // ndof
        r = g % ndof
        local_map[sl] = k * Lh + (r - d * L)
    return ElementPartition(
        n_devices=P_, L=L, halo=halo, n_pad=n_pad, e_max=e_max,
        perm=perm, local_map=local_map, K=K, ndof=ndof,
    )


def partitioned_assemble_dia(
    epart: ElementPartition,
    mesh: Mesh,
    axis: str,
    grad_p, vol_p, h_p, UL_p, map_p,
    dt, reynolds, delta,
    *, terms, chunk: int = 16384,
):
    """Sharded DIA assembly: each device scatters only ITS elements.

    Inputs are the element arrays pre-permuted by `ElementPartition.perm`
    (leading dim P*e_max, sharded over `axis`); padded element rows carry an
    all-sacrificial scatter map so their (possibly garbage) blocks never
    land in real slots.  Returns the (K, n_pad) global DIA data sharded
    over its row dimension — slice [:, :ndof] for the API view.
    """
    from navierstokes_tpu.fem import elements as el

    K, L, halo, n_dev = epart.K, epart.L, epart.halo, epart.n_devices
    Lh = L + halo
    e_max = epart.e_max
    dtype = vol_p.dtype

    def one(g, v, hh, ul):
        return el.element_node_blocks(
            g, v, hh, ul, dt, reynolds, delta, terms=terms
        ).reshape(256)

    def body(g, v, hh, ul, m):
        flat = jnp.zeros(K * Lh + 1, dtype=dtype)
        if e_max <= chunk:
            blocks = jax.vmap(one)(g, v, hh, ul)
            flat = flat.at[m.reshape(-1)].add(blocks.reshape(-1))
        else:
            n_chunks = -(-e_max // chunk)
            pad = n_chunks * chunk - e_max
            g2 = jnp.pad(g, ((0, pad), (0, 0), (0, 0)))
            v2 = jnp.pad(v, (0, pad))
            h2 = jnp.pad(hh, (0, pad))
            ul2 = jnp.pad(ul, ((0, pad), (0, 0), (0, 0)))
            m2 = jnp.pad(m, ((0, pad), (0, 0)), constant_values=K * Lh)

            def cbody(c, acc):
                s = c * chunk
                blocks = jax.vmap(one)(
                    jax.lax.dynamic_slice_in_dim(g2, s, chunk),
                    jax.lax.dynamic_slice_in_dim(v2, s, chunk),
                    jax.lax.dynamic_slice_in_dim(h2, s, chunk),
                    jax.lax.dynamic_slice_in_dim(ul2, s, chunk),
                )
                mm = jax.lax.dynamic_slice_in_dim(m2, s, chunk)
                return acc.at[mm.reshape(-1)].add(blocks.reshape(-1))

            # the carry becomes device-varying after the first scatter
            flat = jax.lax.fori_loop(
                0, n_chunks, cbody, jax.lax.pcast(flat, (axis,), to="varying")
            )
        loc = flat[:-1].reshape(K, Lh)
        own, overflow = loc[:, :L], loc[:, L:]
        if n_dev > 1:
            recv = jax.lax.ppermute(
                overflow, axis, [(i, i + 1) for i in range(n_dev - 1)]
            )
            own = own.at[:, :halo].add(recv)
        return own

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(None, axis),
    )(grad_p, vol_p, h_p, UL_p, map_p)
