"""Macro-element block-dense form of the per-step velocity operator F.

The matrix-free element apply of F moves one row per cell-node SLOT
through a gather and a node reduce (~2.2M rows each way at 965k DoF).
This module cuts the ROW COUNT (chosen before the H100 port, for a
backend whose gathers were row-rate bound; not yet measured on the H100
-- ROADMAP S3a):

  * cells (already RCM-sorted) are grouped into fixed-size macro blocks
    of `c_blk` consecutive cells whose UNIQUE node count fits in U=128
    (on the 965k bench mesh: c_blk=20 -> max 125 unique, mean 80,
    overlap beta = 2.83 block-slots per node);
  * each block's dense [U, U] operator Ft_b is assembled ON DEVICE per
    step from the folded per-element matrices F_e (component-scalar
    [E, 10, 10]) by two one-hot contractions -- assembly WITHOUT a
    scatter, at ~40 G MACs for the whole 965k operator;
  * the apply is then: one [B, U]-row gather (beta*n ~ 0.9M rows instead
    of 2.2M slots), one batched dense matvec over the [B, U, U] value
    stream, and one valence-bucketed reduce of beta contributions per
    node (ops/scatter.py machinery).

F~ is EXACTLY the assembled F (same values, different summation order):
the step's Krylov operator stays the reference's semi-implicit
linearisation (ref: src/NavierStokes2D.cpp:253), equality-tested against
apply_F to fp tolerance.  One-hot operands are exact in bfloat16, so
precision="highest" keeps the assembly at f32 fidelity.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MacroPlan:
    """Static block structure (values are rebuilt per step)."""

    uidx: jax.Array  # [B, U] int32 global node per block slot (pad -> n)
    onehot: jax.Array  # [B, c_blk, nloc, U] bf16 one-hot of local slots
    plan: object  # GatherPlan: flat [B*U] block-slot contribs -> [n]
    # Two-level (windowed) form of the slot gather: block rows are RCM-
    # ordered so each chunk's nodes live in small vertex/edge windows
    # (chosen before the H100 port, for a source-working-set-bound gather
    # rate; not yet measured on the H100).  Pad slots are remapped to the
    # block's first node (their Ft rows/columns are zero, so the gathered
    # value is never consumed).
    wgather: object | None
    n: int = dataclasses.field(metadata=dict(static=True))
    B: int = dataclasses.field(metadata=dict(static=True))
    U: int = dataclasses.field(metadata=dict(static=True))
    c_blk: int = dataclasses.field(metadata=dict(static=True))
    E: int = dataclasses.field(metadata=dict(static=True))  # real cells


def build_macro_plan(
    cells_u: np.ndarray, n_unodes: int, U: int = 128, c_blk: int = 20,
    n_vertices: int | None = None,
) -> MacroPlan:
    """Group RCM-consecutive cells into blocks of `c_blk` with <= U unique
    nodes each (c_blk auto-shrinks if any block overflows).  Pass
    `n_vertices` (the P2 vertex/edge numbering split) to enable the
    windowed two-level slot gather."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        build_gather_plan_grouped,
        build_windowed_gather,
    )

    cells = np.asarray(cells_u, dtype=np.int64)
    E, nloc = cells.shape
    while c_blk > 1:
        B = -(-E // c_blk)
        pad = B * c_blk - E
        cp = np.concatenate(
            [cells, np.full((pad, nloc), cells[0, 0], np.int64)], axis=0
        ).reshape(B, c_blk, nloc)
        uidx = np.full((B, U), n_unodes, np.int64)
        lidx = np.empty((B, c_blk, nloc), np.int64)
        ok = True
        for b in range(B):
            uniq, inv = np.unique(cp[b], return_inverse=True)
            if len(uniq) > U:
                ok = False
                break
            uidx[b, : len(uniq)] = uniq
            lidx[b] = inv.reshape(c_blk, nloc)
        if ok:
            break
        c_blk -= 2
    else:
        raise ValueError("macro blocks cannot satisfy U even at c_blk=2")

    # One-hot materialised ON DEVICE (557 MB at 965k; only the 2 MB slot
    # table crosses from the host).  int8 covers local slots 0..127 exactly at U=128; wider blocks need
    # int16 (int8 would silently wrap above 127).
    idt = jnp.int8 if U <= 128 else jnp.int16
    lidx8 = jnp.asarray(lidx, idt)
    valid = np.ones((B, c_blk), np.bool_)
    if pad:
        valid.reshape(-1)[E:] = False
    onehot = (
        (lidx8[..., None] == jnp.arange(U, dtype=idt))
        & jnp.asarray(valid)[:, :, None, None]
    ).astype(jnp.bfloat16)

    # Valence buckets for the 965k bench mesh: block overlap beta is small
    # (most nodes appear in 1-4 blocks), so fine low-valence buckets cut
    # the K_max padding waste (1.07M -> 898k gathered rows).
    plan = build_gather_plan_grouped(
        uidx.reshape(-1),
        n_unodes,
        thresholds=(1, 2, 3, 4, 6, 8),
        drop_row=n_unodes,
        mode="columns",
    )
    wgather = None
    if n_vertices is not None:
        ug = uidx.copy()
        padslots = ug == n_unodes
        ug[padslots] = np.broadcast_to(ug[:, :1], ug.shape)[padslots]
        wgather = build_windowed_gather(
            ug, n_vertices, n_unodes, cells_per_block=256, align=512
        )
        if wgather.window_rows > max(n_unodes // 4, 4096):
            wgather = None  # degenerate windows (unordered mesh)
    return MacroPlan(
        uidx=jnp.asarray(uidx, jnp.int32),
        onehot=jnp.asarray(onehot, jnp.bfloat16),
        plan=plan,
        wgather=wgather,
        n=n_unodes,
        B=B,
        U=U,
        c_blk=c_blk,
        E=E,
    )


def build_macro_values(
    mp: MacroPlan, F_e: jax.Array, precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Per-step block-dense values Ft [B, U, U] from the folded
    per-element matrices F_e [E, nloc, nloc].

    Two one-hot contractions (no scatter): stage 1 places each element
    row at its block slot (each output is a SINGLE F_e value -- exact);
    stage 2 sums the <= c_blk per-(u, v) contributions in f32.  The
    one-hot operand is exact in bf16; precision="highest" keeps the F_e
    side at f32 fidelity."""
    B, c, U = mp.B, mp.c_blk, mp.U
    nloc = F_e.shape[1]
    pad = B * c - F_e.shape[0]
    F_ep = jnp.concatenate(
        [F_e, jnp.zeros((pad, nloc, nloc), F_e.dtype)], axis=0
    ).reshape(B, c, nloc, nloc)
    P = mp.onehot.astype(F_e.dtype)
    # Intermediate laid out [B, c, nloc, U] with the wide U axis minor.
    A = jnp.einsum("bciu,bcij->bcju", P, F_ep, precision=precision)
    return jnp.einsum("bcju,bcjv->buv", A, P, precision=precision)


def _split3_bf16(F: jax.Array):
    """3-way bf16 split of an f32 array: F ~= hi + mid + lo with each part
    exactly representable in bfloat16 (8+8+8 mantissa bits cover f32's 24
    up to alignment tails ~1e-8 relative).  Lets matmuls against an
    EXACT-bf16 operand (the one-hot tables) run as 3 native bf16 products
    with f32 accumulation, with the error class of a full f32 product
    (products exact, sums in f32).

    MUST use lax.reduce_precision, not astype round-trips: under XLA's
    --xla_allow_excess_precision (on by default) f32->bf16->f32 cast pairs
    may be elided -- the astype form then silently degenerates to
    (hi=F, mid=lo=0), i.e. a plain bf16 truncation of the operand
    (rel err ~1.7e-3, the stepper-destabilising class)."""
    hi = jax.lax.reduce_precision(F, 8, 7)
    r1 = F - hi
    mid = jax.lax.reduce_precision(r1, 8, 7)
    lo = jax.lax.reduce_precision(r1 - mid, 8, 7)
    return (
        hi.astype(jnp.bfloat16),
        mid.astype(jnp.bfloat16),
        lo.astype(jnp.bfloat16),
    )


def build_macro_values_split3(mp: MacroPlan, F_e: jax.Array) -> jax.Array:
    """Exact-split build: same values as build_macro_values (to f32
    summation order) from bf16 operands only.

    The F_e side is split into three exactly-bf16 parts (hi/mid/lo
    covering the f32 mantissa); stage 1 places each part against the
    exact-bf16 one-hot (every output is a SINGLE split value -- exact in
    bf16), stage 2 contracts the bf16 pair accumulating f32.  Summing the three f32
    partials reconstructs the HIGHEST-precision result (equality-tested in
    tests/test_macro.py)."""
    B, c, U = mp.B, mp.c_blk, mp.U
    nloc = F_e.shape[1]
    pad = B * c - F_e.shape[0]
    F_ep = jnp.concatenate(
        [F_e, jnp.zeros((pad, nloc, nloc), F_e.dtype)], axis=0
    ).reshape(B, c, nloc, nloc)
    P = mp.onehot  # bf16, exact
    acc = None
    for Fk in _split3_bf16(F_ep):
        # stage 1: exact placement -- each output is one split value, so
        # the bf16 result is exact; accumulate type only guards the sum
        # of the (disjoint) one-hot terms.
        Ak = jnp.einsum(
            "bciu,bcij->bcju", P, Fk, preferred_element_type=jnp.bfloat16
        )
        part = jnp.einsum(
            "bcju,bcjv->buv", Ak, P, preferred_element_type=jnp.float32
        )
        acc = part if acc is None else acc + part
    return acc


def macro_build_fn(kind: str):
    """Resolve the configured macro value-assembly engine
    (NumericsConfig.macro_build / macro_conv_build)."""
    if kind == "auto":
        kind = "highest"  # chosen before the H100 port; not yet measured there
    if kind == "split3":
        return build_macro_values_split3
    if kind == "highest":
        return build_macro_values
    if kind == "default":
        # Backend-default precision: ~1.7e-3 value error where the
        # backend truncates operands -- valid ONLY for the convection-only
        # part under the K/C split, where the error lands on C's ~1/30
        # share of F (the constant mass/stiffness blocks stay exact).
        return functools.partial(
            build_macro_values, precision=jax.lax.Precision.DEFAULT
        )
    raise ValueError(f"unknown macro_build: {kind}")


def slot_gather(mp: MacroPlan, x: jax.Array) -> jax.Array:
    """[n, C] -> [B, U, C] block-slot view (windowed when available)."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        apply_windowed_gather,
    )

    if mp.wgather is not None:
        return apply_windowed_gather(mp.wgather, x)
    xb = jnp.concatenate(
        [x, jnp.zeros((1, x.shape[1]), x.dtype)], axis=0
    )
    return xb[mp.uidx]


def slot_expand_elem(mp: MacroPlan, x_b: jax.Array) -> jax.Array:
    """[B, U, C] slot view -> [E, nloc, C] element view via the one-hot
    placement tables -- the forward element gather without the gather.

    When the field is ALREADY in the macro slot view (riding the step's
    one slot gather), each element-local value is a one-hot selection
    from its block's U-slot panel, so the 2.2M-row forward gather at 965k
    becomes ONE bf16 einsum streaming the 556 MB of placement tables
    (chosen before the H100 port, for row-rate-bound gathers; a plain
    gather is the H100 baseline to beat -- ROADMAP S3c).

    Exact for f32 inputs: the channel payload is 3-way bf16 split
    (hi/mid/lo, each exactly representable -- _split3_bf16) riding as
    extra channels through the same einsum; every output is a SINGLE
    split value (one-hot row), so the bf16 products are exact and the
    f32 recombination hi+mid+lo restores the input bits (the parts'
    mantissas do not overlap).  Equality-tested against gather_u in
    tests/test_macro.py."""
    B, c, nloc, U = mp.onehot.shape
    C = x_b.shape[-1]
    P = mp.onehot.reshape(B, c * nloc, U)
    if x_b.dtype == jnp.float32:
        hi, mid, lo = _split3_bf16(x_b)
        xs = jnp.concatenate([hi, mid, lo], axis=-1)  # [B, U, 3C] bf16
        y = jnp.einsum(
            "bpu,buk->bkp", P, xs, preferred_element_type=jnp.float32
        )
        y = y[:, :C] + y[:, C:2 * C] + y[:, 2 * C:]
    else:
        y = jnp.einsum(
            "bpu,buk->bkp", P.astype(x_b.dtype), x_b,
            precision=jax.lax.Precision.HIGHEST,
        )
    y = jnp.moveaxis(y, 1, 2).reshape(B * c, nloc, C)
    return y[: mp.E]


def apply_rhs_and_r0_macro(
    mp: MacroPlan, Mt: jax.Array, Ft: jax.Array, hist: jax.Array,
    u0: jax.Array, extra: jax.Array | None = None,
    x_b: jax.Array | None = None,
):
    """(M hist, F u0[, F extra]) in ONE slot gather + ONE wide reduce.

    The macro counterpart of ops.apply_rhs_and_r0's element pass (the
    projection momentum rhs b = M hist - G p and warm-start residual
    r0 = b - F u0; the G p term and Dirichlet masking stay at the call
    site): the per-step macro values Ft already encode F exactly and `Mt`
    is the setup-time macro form of the constant velocity mass, so both
    products ride the SAME beta*n-row slot gather and node reduce -- both
    row-rate-bound phases are paid once for the two operators, and the
    element pass (gather + quadrature contractions + reduce over 2.2M
    slot rows) is retired.  Exactly M hist / F u0 up to summation order
    (equality-tested in tests/test_macro.py).

    `extra` [n, m] rides additional channels through the SAME gather,
    Ft matvec, and reduce: fresh exact images F extra for the velocity
    warm-start pool (cfg.precond.f_warmstart).

    `x_b` short-circuits the slot gather with a PRE-GATHERED slot view
    (channels [hist | u0 | extra...]) -- the step's fused up-front gather
    (models/base.py) shares one beta*n-row gather between this pass and
    the convection fold's element view.
    Ref: the rhs rebuild in src/NavierStokes2D.cpp:414-488."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

    d = hist.shape[1]
    if x_b is None:
        xs = [hist, u0] if extra is None else [hist, u0, extra]
        x_b = slot_gather(mp, jnp.concatenate(xs, axis=1))
    y_b = jnp.concatenate(
        [
            jnp.einsum(
                "buv,bvc->buc", Mt, x_b[..., :d],
                precision=jax.lax.Precision.HIGHEST,
            ),
            jnp.einsum(
                "buv,bvc->buc", Ft, x_b[..., d:],
                precision=jax.lax.Precision.HIGHEST,
            ),
        ],
        axis=-1,
    )
    y = apply_gather_plan(mp.plan, y_b.reshape(mp.B * mp.U, x_b.shape[-1]))
    if extra is None:
        return y[:, :d], y[:, d:]
    return y[:, :d], y[:, d:2 * d], y[:, 2 * d:]


def split3_values(Ft: jax.Array):
    """3-way exact-bf16 split (hi, mid, lo) of block values, computed once
    per step (or at setup for constant blocks) so every apply can stream
    bf16 parts instead of the f32 array."""
    return _split3_bf16(Ft)


def apply_macro_split3(mp: MacroPlan, Ft3, u: jax.Array) -> jax.Array:
    """y = F u from PRE-SPLIT bf16 value parts: an f32-class macro matvec
    from bf16 operands.

    The values are split ONCE into exactly-bf16 (hi, mid, lo) parts
    (split3_values; half the bytes each) and the u-side parts ride as
    channels, so the six significance products (hh, hm, hl, mh, mm, lh)
    cost ONE stream of each part.  Products of exact-bf16 operands accumulate in f32; the
    error class equals the split3 build's (~1e-8 relative vs HIGHEST,
    equality-tested in tests/test_macro.py)."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

    C = u.shape[1]
    u_b = slot_gather(mp, u)  # [B, U, C] f32
    uh, um, ul = _split3_bf16(u_b)
    U3 = jnp.concatenate([uh, um, ul], axis=-1)  # [B, U, 3C] bf16
    fh, fm, fl = Ft3
    f32 = jnp.float32
    Yh = jnp.einsum("buv,bvc->buc", fh, U3, preferred_element_type=f32)
    Ym = jnp.einsum(
        "buv,bvc->buc", fm, U3[..., : 2 * C], preferred_element_type=f32
    )
    Yl = jnp.einsum(
        "buv,bvc->buc", fl, U3[..., :C], preferred_element_type=f32
    )
    y = (
        (Yh[..., :C] + (Yh[..., C:2 * C] + Ym[..., :C]))
        + (Yh[..., 2 * C:] + (Ym[..., C:] + Yl))
    )
    return apply_gather_plan(mp.plan, y.reshape(mp.B * mp.U, C))


def apply_macro(mp: MacroPlan, Ft: jax.Array, u: jax.Array) -> jax.Array:
    """y = F u via the block-dense values: [n, C] -> [n, C]."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

    C = u.shape[1]
    u_b = slot_gather(mp, u)  # [B, U, C] -- beta*n rows, not slot rows
    # Batched matvec at HIGHEST precision (full f32 products).
    y_b = jnp.einsum(
        "buv,bvc->buc", Ft, u_b, precision=jax.lax.Precision.HIGHEST
    )
    return apply_gather_plan(mp.plan, y_b.reshape(mp.B * mp.U, C))
