"""Ensemble (parameter-sweep) parallelism via vmap.

A capability the reference does not have (each run is a separate `mpirun`
launch; SURVEY.md section 2c): `vmap` the full semi-implicit step over a batch
of viscosities (i.e. Reynolds numbers) so one XLA program advances the whole
sweep -- optionally with the batch axis sharded across devices.
"""

from __future__ import annotations

import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def run_ensemble(solver, nus, n_steps: int, sharding=None):
    """Advance `n_steps` for an ensemble of viscosities.

    Args:
      solver: a NavierStokesSolver (its problem's other parameters are shared).
      nus: [B] array of kinematic viscosities.
      n_steps: number of time steps.
      sharding: optional NamedSharding for the batch axis (e.g. over a
        device mesh) -- data-parallel ensemble execution.

    Returns (batched final State, batched stacked StepDiagnostics [B, T]).
    """
    nus = jnp.asarray(nus, solver.dtype)
    B = nus.shape[0]
    state0 = solver.initial_state()
    bstate = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)), state0
    )
    if sharding is not None:
        bstate = jax.tree.map(lambda x: jax.device_put(x, sharding), bstate)
        nus = jax.device_put(nus, sharding)

    # The setup-time F spectral bound was computed for the solver's base nu
    # (convection-free); ensemble members solve with DIFFERENT nus, and the
    # damped smoothers (richardson/chebyshev/pmg) diverge if lam_max is
    # underestimated.  Drop the cached bound so build_precond_state falls
    # back to its per-step power iteration, which vmaps per member.
    import dataclasses as _dc

    dev_run = solver._dev
    if dev_run.f_lam0 is not None:
        dev_run = _dc.replace(dev_run, f_lam0=None)
    if dev_run.op.contraction != "einsum":
        # The broadcast contraction relies on XLA fusing an
        # [E, i, j, c] product; under a wide vmapped batch that becomes
        # [B, E, i, j, c] -- keep the einsum lowering for ensembles.
        dev_run = _dc.replace(
            dev_run, op=_dc.replace(dev_run.op, contraction="einsum")
        )
    if dev_run.op.wgather_u is not None:
        # The windowed forward gather scans dynamic slices -- under vmap
        # that lowers poorly, and ensemble members are small enough that
        # the plain gather is the fast path anyway (wide payloads already
        # amortise the row cost).
        dev_run = _dc.replace(
            dev_run, op=_dc.replace(dev_run.op, wgather_u=None)
        )
    if dev_run.op.gradt is not None:
        # Keep the element-pass gradient under vmap: ensemble members'
        # node arrays are small (below the source-working-set knee) and
        # the wide batched payload already amortises the reduce rows.
        dev_run = _dc.replace(
            dev_run, op=_dc.replace(dev_run.op, gradt=None)
        )
    if (dev_run.imex is not None or dev_run.kbsr is not None
            or dev_run.macro is not None):
        # Constant-K BSR is built for the solver's base nu (ensemble
        # members sweep nu), the fine-subset pass materialises a
        # [B, E_f, nloc, nloc] fold under vmap, and the macro-element
        # block assembly would build a [B, Bm, U, U] value array per
        # step: fall back to the masked element fold (identical
        # operator, nu-correct).
        dev_run = _dc.replace(
            dev_run, imex=None, kbsr=None, macro=None, macro_mass=None,
            macro_stiff=None,
        )
    if dev_run.aux_div:
        # The fgmres-aux divergence reuse stores every Krylov apply's
        # element view into a [restart+1, B, E, nloc, d] basis under
        # vmap -- extra device-memory traffic at ensemble member sizes;
        # the element divergence pass is used instead.
        dev_run = _dc.replace(dev_run, aux_div=False)
    if dev_run.op.dbsr is not None or dev_run.op.gbsr is not None:
        # Same reasoning for the supernode BSR D/G forms: the batched
        # element passes already gather wide rows, and the BSR broadcast
        # product would materialise a [B, NB, W, bs, C, bs, C] intermediate
        # under vmap.
        dev_run = _dc.replace(
            dev_run, op=_dc.replace(dev_run.op, dbsr=None, gbsr=None)
        )

    vstep = jax.vmap(
        lambda st, nu, dev: solver.step(st, nu=nu, dev=dev),
        in_axes=(0, 0, None),
    )

    # Chunk the scan like NavierStokesSolver.run: one device program per
    # chunk, with the diagnostics brought back between chunks.
    spc = max(1, int(solver.config.numerics.steps_per_chunk))

    @partial(jax.jit, static_argnames=("length",))
    def run_chunk(dev, bstate, nus, length):
        def body(st, _):
            st, d = vstep(st, nus, dev)
            return st, d

        return jax.lax.scan(body, bstate, None, length=length)

    chunks = []
    done = 0
    chunk_walls = []  # (steps, seconds) per chunk; [0] includes compile
    while done < n_steps:
        length = min(spc, n_steps - done)
        t0 = time.perf_counter()
        bstate, d = run_chunk(dev_run, bstate, nus, length)
        jax.block_until_ready(bstate.u)
        chunk_walls.append((length, time.perf_counter() - t0))
        chunks.append(d)
        done += length
    if len(chunk_walls) > 1:
        warm_steps = sum(k for k, _ in chunk_walls[1:])
        warm_secs = sum(s for _, s in chunk_walls[1:])
        print(
            f"[ensemble] sustained {B * warm_steps / warm_secs:.2f} "
            f"member-steps/s (B={B}, {warm_steps} steps after the "
            f"compile chunk; first chunk {chunk_walls[0][1]:.1f}s)",
            file=sys.stderr, flush=True,
        )
    diags = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *chunks)
    # [T, B] -> [B, T]
    diags = jax.tree.map(lambda x: np.moveaxis(np.asarray(x), 0, 1), diags)
    return bstate, diags
