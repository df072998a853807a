"""Position estimation from TDOA values (hyperbolic multilateration).

Each TDOA constrains the transmitter to a hyperbola; position is the
bounded nonlinear least-squares solution over all receiver pairs, with
DOP (dilution of precision) from the geometry matrix (reference
thrifty/pos_est.py:31-125).

Two solver paths:
- :func:`solve_group` -- scipy trust-region solver per group (host).
- :func:`solve_groups_batched` -- fixed-iteration damped Gauss-Newton
  vmapped over many groups at once in JAX, for high-rate positioning
  streams (groups padded to a common pair count and masked).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import scipy.optimize

from thrifty_tpu.pipeline import tdoa as tdoa_mod

SPEED_OF_LIGHT = tdoa_mod.SPEED_OF_LIGHT
MAX_DIST = 10e3  # search bounds beyond the receiver extent

POSITION_FIELDS = ("group_id", "timestamp", "tx", "dop", "snr", "x", "y", "z")


def position_dtype(dims):
    """Structured dtype of a .pos record with `dims` coordinates
    (group_id/tx i4, timestamp/dop/snr/coords f8)."""
    return np.dtype(
        [(f, "f8" if i > 2 else ("i4" if f != "timestamp" else "f8"))
         for i, f in enumerate(POSITION_FIELDS[:5 + dims])])


class EstimationError(Exception):
    pass


def solve_1d(tdoas, rx_pos):
    """Closed-form 1-D position for exactly two receivers."""
    missing = _missing_receivers(tdoas, rx_pos)
    if missing:
        # Validate at the same depth as solve_group/_geometry: without
        # this, a stale 1-D coordinate config would silently position
        # an unrelated receiver pair's TDOA between rx_pos's own two
        # coordinates (previously only rescued downstream by dop()'s
        # incidental KeyError).
        raise EstimationError(
            "receiver(s) {} not in coordinate config".format(
                sorted(missing)))
    rxids = sorted(rx_pos)
    r0, r1 = rx_pos[rxids[0]][0], rx_pos[rxids[1]][0]
    tdoa_m = float(tdoas["tdoa"][0]) * SPEED_OF_LIGHT
    if r0 > r1:
        position = (r0 + r1 - tdoa_m) / 2
    else:
        position = (r0 + r1 + tdoa_m) / 2
    return np.array([position]), float(tdoas["snr"][0])


def _geometry(tdoas, rx_pos):
    missing = _missing_receivers(tdoas, rx_pos)
    if missing:
        raise EstimationError(
            "receiver(s) {} not in coordinate config".format(
                sorted(missing)))
    rx0 = np.array([rx_pos[int(r)] for r in tdoas["rx0"]], dtype=np.float64)
    rx1 = np.array([rx_pos[int(r)] for r in tdoas["rx1"]], dtype=np.float64)
    return rx0, rx1


def _missing_receivers(tdoas, rx_pos):
    """Receiver ids referenced by the TDOA rows but absent from the
    coordinate config (stale pos-rx.cfg, extra receiver)."""
    return {int(r) for r in np.concatenate([tdoas["rx0"], tdoas["rx1"]])
            if int(r) not in rx_pos}


def solve_group(tdoas, rx_pos, weighted=False):
    """Bounded nonlinear least squares with the analytic Jacobian.

    With ``weighted``, residuals are scaled by sqrt(snr) normalized to
    unit mean -- TDOA noise variance goes as 1/SNR, so this is the
    maximum-likelihood weighting (resolves the reference's TODO at
    pos_est.py:59 "use SNR ... as weight").
    """
    dims = len(next(iter(rx_pos.values())))
    uniq = np.unique(np.concatenate([tdoas["rx0"], tdoas["rx1"]]))
    if len(uniq) < dims + 1:
        raise EstimationError("underdetermined")

    rx0, rx1 = _geometry(tdoas, rx_pos)
    coords = np.array(list(rx_pos.values()), dtype=np.float64)
    lo = coords.min(axis=0) - MAX_DIST
    hi = coords.max(axis=0) + MAX_DIST
    # Start at the receiver centroid: always inside the bounds box even
    # for projected coordinates far from the origin (a fixed origin
    # guess would make scipy reject the bounds).
    x0 = coords.mean(axis=0)
    measured = tdoas["tdoa"] * SPEED_OF_LIGHT
    if weighted:
        w = np.sqrt(np.maximum(tdoas["snr"], 1e-12))
        w = w / np.mean(w)
    else:
        w = np.ones(len(tdoas))

    def residuals(pos):
        d0 = np.linalg.norm(rx0 - pos, axis=1)
        d1 = np.linalg.norm(rx1 - pos, axis=1)
        return w * (measured - (d0 - d1))

    def jac(pos):
        p0, p1 = rx0 - pos, rx1 - pos
        d0 = np.linalg.norm(p0, axis=1)
        d1 = np.linalg.norm(p1, axis=1)
        return w[:, None] * (p0 / d0[:, None] - p1 / d1[:, None])

    res = scipy.optimize.least_squares(
        residuals, x0, jac=jac, bounds=(lo, hi))
    return res.x, float(np.mean(tdoas["snr"]))


def dop_matrix(pos, rx_pos, rx_pairs):
    """Covariance-shape matrix inv(G^T G) of the linearized geometry."""
    pos = np.asarray(pos, dtype=np.float64)
    rx0 = np.array([rx_pos[int(a)] for a, _ in rx_pairs], dtype=np.float64)
    rx1 = np.array([rx_pos[int(b)] for _, b in rx_pairs], dtype=np.float64)
    p0, p1 = rx0 - pos, rx1 - pos
    d0 = np.linalg.norm(p0, axis=1)
    d1 = np.linalg.norm(p1, axis=1)
    g = p0 / d0[:, None] - p1 / d1[:, None]
    try:
        return np.linalg.inv(g.T @ g)
    except np.linalg.LinAlgError:
        return None


def dop(pos, rx_pos, rx_pairs):
    """Dilution of precision: sqrt(trace(inv(G^T G))); -1 if singular."""
    m = dop_matrix(pos, rx_pos, rx_pairs)
    if m is None:
        return -1.0
    return float(np.sqrt(np.trace(m)))


def solve_batched(tdoa_groups, rx_pos, iters=30, weighted=False,
                  verbose=True):
    """Solve many TDOA groups at once with the JAX Gauss-Newton solver.

    Groups are padded to a common pair count and solved as one jitted
    program (one device dispatch for thousands of fixes); DOP and SNR
    are filled in on host.  Underdetermined groups are skipped like in
    :func:`solve`.  Accuracy matches the scipy path to well under the
    measurement noise (see tests).  With ``weighted``, residuals are
    scaled by sqrt(SNR) normalized to unit mean per group -- the same
    maximum-likelihood weighting as :func:`solve_group` (reference TODO
    thrifty/pos_est.py:59).

    ``verbose=False`` silences the per-group failure lines: the live
    server deliberately retries not-yet-solvable groups (a lagging
    receiver may complete them) every step, and would otherwise
    re-print the same diagnostic dozens of times per group.
    """
    dims = len(next(iter(rx_pos.values())))
    usable = []
    for g in tdoa_groups:
        missing = _missing_receivers(g.tdoas, rx_pos)
        if missing:
            if verbose:
                print("Failed to estimate group #{}: receiver(s) {} not "
                      "in coordinate config".format(
                          g.group_id, sorted(missing)), file=sys.stderr)
            continue
        uniq = np.unique(np.concatenate([g.tdoas["rx0"], g.tdoas["rx1"]]))
        if len(uniq) >= dims + 1:
            usable.append(g)
        elif verbose:
            print("Failed to estimate group #{}: underdetermined".format(
                g.group_id), file=sys.stderr)
    dtype = position_dtype(dims)
    if not usable:
        return np.zeros(0, dtype=dtype)

    pmax = max(len(g.tdoas) for g in usable)
    n = len(usable)
    tdoa_pad = np.zeros((n, pmax))
    mask = np.zeros((n, pmax), dtype=bool)
    weights = np.zeros((n, pmax))
    rx0 = np.zeros((n, pmax, dims))
    rx1 = np.zeros((n, pmax, dims))
    for i, g in enumerate(usable):
        k = len(g.tdoas)
        tdoa_pad[i, :k] = g.tdoas["tdoa"]
        mask[i, :k] = True
        if weighted:
            w = np.sqrt(np.maximum(g.tdoas["snr"], 1e-12))
            weights[i, :k] = w / np.mean(w)
        else:
            weights[i, :k] = 1.0
        rx0[i, :k] = [rx_pos[int(a)] for a in g.tdoas["rx0"]]
        rx1[i, :k] = [rx_pos[int(b)] for b in g.tdoas["rx1"]]
        # Padded rows reuse the first pair's geometry (masked anyway,
        # but keeps the Jacobian finite).
        rx0[i, k:] = rx0[i, 0]
        rx1[i, k:] = rx1[i, 0]

    coords = np.array(list(rx_pos.values()), dtype=np.float64)
    bounds = (coords.min(axis=0) - MAX_DIST, coords.max(axis=0) + MAX_DIST)
    positions = np.asarray(solve_groups_batched(
        tdoa_pad, mask, rx0, rx1, bounds, iters=iters,
        weights=weights if weighted else None))

    dops = _dop_batched(positions, rx0, rx1, mask)
    results = []
    for i, g in enumerate(usable):
        results.append(
            (g.group_id, g.timestamp, g.tx, dops[i],
             float(np.mean(g.tdoas["snr"]))) + tuple(positions[i]))
    return np.array(results, dtype=dtype)


def _dop_batched(positions, rx0, rx1, mask):
    """Vectorized DOP over padded groups; -1 where GtG is singular.

    Semantics match :func:`dop`: only an *exactly* singular /
    non-finite geometry reports -1 -- near-singular geometry returns
    the (huge) finite DOP so downstream weighting (e.g. the Kalman
    tracker's R = (std*dop)^2) de-weights the fix instead of trusting
    it.
    """
    p0 = rx0 - positions[:, None, :]
    p1 = rx1 - positions[:, None, :]
    d0 = np.maximum(np.linalg.norm(p0, axis=-1), 1e-12)
    d1 = np.maximum(np.linalg.norm(p1, axis=-1), 1e-12)
    g = (p0 / d0[..., None] - p1 / d1[..., None]) * mask[..., None]
    gtg = np.einsum("gpi,gpj->gij", g, g)
    with np.errstate(all="ignore"):
        dets = np.linalg.det(gtg)
    ok = np.isfinite(dets) & (dets != 0.0)
    dims = gtg.shape[-1]
    safe = np.where(ok[:, None, None], gtg, np.eye(dims))
    inv = np.linalg.inv(safe)
    traces = np.trace(inv, axis1=-2, axis2=-1)
    ok &= np.isfinite(traces) & (traces >= 0.0)
    return np.where(ok, np.sqrt(np.where(ok, traces, 1.0)), -1.0)


def solve(tdoa_groups, rx_pos, weighted=False, verbose=True):
    """Solve every TDOA group; returns a structured array of positions.

    ``verbose=False`` silences the per-group failure lines (see
    :func:`solve_batched`).
    """
    num_rx = len(rx_pos)
    dims = len(next(iter(rx_pos.values())))
    results = []
    for group in tdoa_groups:
        try:
            if num_rx == 2 and dims == 1:
                coords, snr = solve_1d(group.tdoas, rx_pos)
            else:
                coords, snr = solve_group(group.tdoas, rx_pos,
                                          weighted=weighted)
            pairs = list(zip(group.tdoas["rx0"], group.tdoas["rx1"]))
            dop_est = dop(coords, rx_pos, pairs)
            results.append(
                (group.group_id, group.timestamp, group.tx, dop_est, snr)
                + tuple(coords))
        except (EstimationError, ValueError, KeyError,
                np.linalg.LinAlgError) as e:
            # One pathological group must not abort the whole run.
            # (Both paths report unknown receivers as EstimationError;
            # KeyError stays caught as defense in depth for dop()'s
            # rx_pos lookups.)
            if verbose:
                print("Failed to estimate group #{}: {}".format(
                    group.group_id, e), file=sys.stderr)
    dtype = position_dtype(dims)
    if not results:
        return np.zeros(0, dtype=dtype)
    return np.array(results, dtype=dtype)


import functools


@functools.lru_cache(maxsize=32)
def _make_batched_solver(dims, iters, damping):
    """Jitted fixed-iteration GN solver, cached per (dims, iters,
    damping) so repeated calls (the live server, one per step) reuse
    the compiled executable for each padded shape bucket."""
    import jax
    import jax.numpy as jnp

    def run(measured, wgt, mask_f, r0, r1, lo, hi):
        def residuals(pos):
            p0 = r0[:, None] - pos[:, :, None, :]
            p1 = r1[:, None] - pos[:, :, None, :]
            d0 = jnp.maximum(jnp.linalg.norm(p0, axis=-1), 1e-6)
            d1 = jnp.maximum(jnp.linalg.norm(p1, axis=-1), 1e-6)
            resid = (measured[:, None] - (d0 - d1)) * wgt[:, None]
            return resid, p0, p1, d0, d1

        def step(state, _):
            # pos: [G, K, D] -- K independent starts per group; lam:
            # [G, K] per-start Marquardt damping.  A fixed damping
            # stalls in the long narrow valleys of ill-conditioned
            # geometry (near-coplanar arrays barely observe z), so
            # this is real Levenberg-Marquardt: try the damped step,
            # accept it only if the residual decreased (lam /= 4),
            # otherwise stay and raise lam x8 -- all per (group,
            # start) via where, keeping the scan fixed-iteration.
            pos, lam = state
            resid, p0, p1, d0, d1 = residuals(pos)
            cost = jnp.sum(resid * resid, axis=-1)
            jacmat = (p0 / d0[..., None] - p1 / d1[..., None]) \
                * wgt[:, None, :, None]
            jtj = jnp.einsum("gkpi,gkpj->gkij", jacmat, jacmat,
                             precision=jax.lax.Precision.HIGHEST)
            diag = jnp.diagonal(jtj, axis1=-2, axis2=-1)
            jtj = jtj + lam[..., None, None] * (diag + 1e-9)[..., None] \
                * jnp.eye(dims)
            jtr = jnp.einsum("gkpi,gkp->gki", jacmat, resid,
                             precision=jax.lax.Precision.HIGHEST)
            # jacmat is d(residual)/d(pos), so the Gauss-Newton step is
            # pos - (J^T J)^-1 J^T r.
            delta = jnp.linalg.solve(jtj, jtr[..., None])[..., 0]
            cand = jnp.clip(pos - delta, lo, hi)
            cand_resid, _, _, _, _ = residuals(cand)
            cand_cost = jnp.sum(cand_resid * cand_resid, axis=-1)
            accept = cand_cost < cost
            pos = jnp.where(accept[..., None], cand, pos)
            lam = jnp.clip(jnp.where(accept, lam * 0.25, lam * 8.0),
                           1e-9, 1e9)
            return (pos, lam), None

        # MULTI-START: the TDOA objective has mirror local minima when
        # the receiver array is (near-)collinear/coplanar, and the
        # receiver centroid sits exactly on the symmetry manifold --
        # one start can roll into the wrong basin and converge there
        # (a scipy trust-region run from a luckier basin then
        # disagrees by kilometers).  Start from the centroid AND the
        # corners of the involved receivers' bounding box (which
        # straddle any symmetry line/plane), run all starts through
        # the same fixed-iteration scan, keep the lowest-residual
        # solution.  K = 2^dims + 1 starts cost a few extra tiny
        # matrix solves per group -- noise next to the dispatch.
        denom = jnp.maximum(jnp.sum(mask_f, axis=-1), 1.0)[..., None]
        mids = 0.5 * (r0 + r1)
        centroid = jnp.sum(mids * mask_f[..., None], axis=1) / denom
        big = jnp.where(mask_f[..., None] > 0, mids, -jnp.inf)
        small = jnp.where(mask_f[..., None] > 0, mids, jnp.inf)
        rx_hi = jnp.max(big, axis=1)
        rx_lo = jnp.min(small, axis=1)
        corners = []
        for c in range(1 << dims):
            corner = jnp.stack(
                [jnp.where((c >> d) & 1, rx_hi[:, d], rx_lo[:, d])
                 for d in range(dims)], axis=-1)
            # Inflate away from the centroid so starts separate even
            # for small arrays.
            corners.append(centroid + 1.5 * (corner - centroid))
        init = jnp.stack([centroid] + corners, axis=1)
        init = jnp.clip(init.astype(measured.dtype), lo, hi)

        lam0 = jnp.full(init.shape[:2], damping, init.dtype)
        (pos, _), _ = jax.lax.scan(step, (init, lam0), None,
                                   length=iters)

        # Pick the start with the lowest weighted residual norm.
        p0 = r0[:, None] - pos[:, :, None, :]
        p1 = r1[:, None] - pos[:, :, None, :]
        d0 = jnp.maximum(jnp.linalg.norm(p0, axis=-1), 1e-6)
        d1 = jnp.maximum(jnp.linalg.norm(p1, axis=-1), 1e-6)
        resid = (measured[:, None] - (d0 - d1)) * wgt[:, None]
        score = jnp.sum(resid * resid, axis=-1)
        best = jnp.argmin(score, axis=1)
        return jnp.take_along_axis(
            pos, best[:, None, None], axis=1)[:, 0]

    return jax.jit(run)


def _next_pow2(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def solve_groups_batched(tdoa_padded, mask, rx0_pos, rx1_pos, bounds,
                         iters=25, damping=1e-2, weights=None):
    """Batched damped Gauss-Newton multilateration in JAX.

    All arrays are padded to [G, Pmax]: ``tdoa_padded`` in seconds,
    ``mask`` marks valid pairs, ``rx0_pos``/``rx1_pos`` are [G, Pmax, D]
    receiver coordinates, ``bounds`` = (lo [D], hi [D]).  Returns
    positions [G, D].  Fixed iteration count, no data-dependent control
    flow -- runs as one fused XLA program for thousands of groups.
    ``weights`` ([G, Pmax], zero on padding) scales residual and
    Jacobian rows (sqrt-SNR maximum-likelihood weighting).

    Shapes are padded up to power-of-2 buckets so a long-running caller
    (the live positioning server) hits the jit cache instead of
    recompiling for every distinct group count.
    """
    lo, hi = bounds
    measured = np.asarray(tdoa_padded, dtype=np.float64) * SPEED_OF_LIGHT
    mask_f = np.asarray(mask, dtype=np.float64)
    wgt = mask_f if weights is None \
        else np.asarray(weights, dtype=np.float64) * mask_f
    r0 = np.asarray(rx0_pos, dtype=np.float64)
    r1 = np.asarray(rx1_pos, dtype=np.float64)
    dims = r0.shape[-1]

    g, p = measured.shape
    gp, pp = _next_pow2(g), _next_pow2(p)
    if (gp, pp) != (g, p):
        pad2 = ((0, gp - g), (0, pp - p))
        measured = np.pad(measured, pad2)
        mask_f = np.pad(mask_f, pad2)
        wgt = np.pad(wgt, pad2)
        r0 = np.pad(r0, pad2 + ((0, 0),))
        r1 = np.pad(r1, pad2 + ((0, 0),))

    solver = _make_batched_solver(dims, int(iters), float(damping))
    pos = solver(measured, wgt, mask_f, r0, r1,
                 np.asarray(lo, dtype=np.float64),
                 np.asarray(hi, dtype=np.float64))
    return np.asarray(pos)[:g]


def save_positions(stream_or_path, results):
    """Write .pos lines: group_id timestamp tx dop snr x y [z]."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "w") as f:
            return save_positions(f, results)
    for row in results:
        fields = list(row)
        fields[1] = "{:.6f}".format(fields[1])
        stream_or_path.write(" ".join(str(x) for x in fields) + "\n")


def load_positions(stream_or_path):
    import warnings

    with warnings.catch_warnings():
        # An empty .pos (no fixes yet) is a normal state, not a warning.
        warnings.filterwarnings(
            "ignore", message=".*Empty input file.*")
        data = np.genfromtxt(stream_or_path, dtype=np.float64)
    if data.size == 0:
        # Empty .pos (no fixes yet): 2-D layout by default.
        dims = 2
        dtype = position_dtype(dims)
        return np.zeros(0, dtype=dtype)
    data = np.atleast_2d(data)
    dims = data.shape[1] - 5
    dtype = position_dtype(dims)
    out = np.zeros(len(data), dtype=dtype)
    for i, name in enumerate(out.dtype.names):
        out[name] = data[:, i]
    return out


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("tdoa", nargs="?", type=str, default="data.tdoa")
    parser.add_argument("-o", "--output", type=str, default="data.pos")
    parser.add_argument("-r", "--rx-coordinates", dest="rx_pos",
                        type=str, default="pos-rx.cfg")
    parser.add_argument("--weighted", action="store_true",
                        help="weight residuals by sqrt(SNR)")
    parser.add_argument("--batched", action="store_true",
                        help="solve all groups in one batched device "
                             "program (high fix rates)")
    args = parser.parse_args(argv)

    groups = tdoa_mod.load_tdoa_groups(
        sys.stdin if args.tdoa == "-" else args.tdoa)
    rx_pos = tdoa_mod.load_pos_config(args.rx_pos)
    if args.batched:
        results = solve_batched(groups, rx_pos, weighted=args.weighted)
    else:
        results = solve(groups, rx_pos, weighted=args.weighted)
    print("Estimated {} position(s)".format(len(results)))
    if args.output == "-":
        save_positions(sys.stdout, results)
    else:
        save_positions(args.output, results)


if __name__ == "__main__":
    sys.exit(_main())
