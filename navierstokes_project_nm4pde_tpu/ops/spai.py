"""Sparse approximate inverse (SPAI) preconditioner for the Schur block.

Every device op has a fixed launch cost, so a Jacobi-CG inner solve
(~15 ops/iteration x 10-25 iterations) can pay more in launches than in
arithmetic.  A Frobenius-norm SPAI turns the Schur
solve into ONE ELL SpMV:

    M = argmin ||M S - I||_F  restricted to S's own sparsity pattern

(classic Grote-Huckle row-wise least squares), computed at setup from the
time-independent part of diag(F) (= diag(M)/dt + nu diag(A)).  Convection
perturbs diag(F) only mildly and the outer solver is *flexible* GMRES, so
the frozen M stays an effective approximate solve; "spai_cg" additionally
runs a few CG iterations with M as the preconditioner.

This plays the ILU role of the reference's inner Schur solves
(ref: include/Preconditioners.hpp:92-98,148) without a sequential
triangular solve.
"""

from __future__ import annotations

import numpy as np


def _slot_layout(schur):
    """Original (row, col, mask) of every flat value slot, host-side."""
    unperm = np.asarray(schur.row_unperm)
    grouped_rows = np.argsort(unperm, kind="stable")  # grouped pos -> row id
    rows, cols, mask = [], [], []
    pos = 0
    for b, cols_tab in enumerate(schur.cols):
        cols_tab = np.asarray(cols_tab)
        mask_tab = np.asarray(schur.mask[b])
        rb, Wb = cols_tab.shape
        rows.append(np.repeat(grouped_rows[pos:pos + rb], Wb))
        cols.append(cols_tab.reshape(-1))
        mask.append(mask_tab.reshape(-1) > 0)
        pos += rb
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(mask),
    )


def build_spai_values(op, host: dict, nu: float, dt: float) -> np.ndarray:
    """SPAI values on S~'s pattern, flat bucketed layout (feed to
    `schur_ell_matvec`).  Uses the convection-free diag(F).  `host` is the
    numpy assembly dict from `build_operator(want_host_schur=True)` (carries
    the ELL rows of D, which never live on device)."""
    import scipy.sparse as sp

    schur = op.schur
    n_p = schur.n_rows
    mask_u = np.asarray(op.dirichlet_mask)
    dF0 = np.asarray(op.diagM, dtype=np.float64) / dt + nu * np.asarray(
        op.diagA, dtype=np.float64
    )
    inv = np.where(mask_u, 0.0, 1.0 / dF0)

    # S~ = D diag(inv) D^T from the host ELL rows of D.
    D_cols = np.asarray(host["D_cols"])  # [n_p, Wd]
    D_vals = np.asarray(host["D_vals"], dtype=np.float64)  # [n_p, Wd, dim]
    n_u = inv.shape[0]
    dim = D_vals.shape[2]
    rows = np.repeat(np.arange(n_p), D_cols.shape[1] * dim)
    cols = (
        np.repeat(D_cols, dim, axis=1) * dim
        + np.tile(np.arange(dim), (n_p, D_cols.shape[1]))
    ).reshape(-1)
    Dsp = sp.csr_matrix(
        (D_vals.reshape(-1), (rows, cols)), shape=(n_p, n_u * dim)
    )
    W = sp.diags(np.repeat(inv, dim))
    S = (Dsp @ W @ Dsp.T).tocsr()
    S.eliminate_zeros()

    # Row-wise Frobenius SPAI on S's own pattern: for row i solve
    # min || S[:, J]^T m - e_i || over J = pattern(i) (S symmetric).
    indptr, indices = S.indptr, S.indices
    m_rows, m_cols, m_vals = [], [], []
    for i in range(n_p):
        J = indices[indptr[i]:indptr[i + 1]]
        sub = S[J]  # rows J
        I = np.unique(sub.indices)
        A = sub[:, I].toarray().T  # [|I|, |J|] = S[I, J]
        e = (I == i).astype(np.float64)
        m, *_ = np.linalg.lstsq(A, e, rcond=None)
        m_rows.append(np.full(len(J), i))
        m_cols.append(J)
        m_vals.append(m)
    m_rows = np.concatenate(m_rows)
    m_cols = np.concatenate(m_cols)
    m_vals = np.concatenate(m_vals)

    # Pack into the bucketed flat layout by (row, col) key lookup.
    srow, scol, smask = _slot_layout(schur)
    mkeys = m_rows.astype(np.int64) * n_p + m_cols
    order = np.argsort(mkeys, kind="stable")
    mkeys_s, mvals_s = mkeys[order], m_vals[order]
    skeys = srow.astype(np.int64) * n_p + scol
    pos = np.searchsorted(mkeys_s, skeys)
    pos = np.minimum(pos, len(mkeys_s) - 1)
    hit = (mkeys_s[pos] == skeys) & smask
    out = np.zeros(len(skeys))
    out[hit] = mvals_s[pos[hit]]
    return out
