"""One Harmony integration in plain PyTorch, float64 by default: the
benchmark's reference.

It follows the published algorithm (Korsunsky et al., Nat Methods 2019;
the R package's ``harmony`` C++ engine): k-means centroids seeded by a
distance-weighted race and refined by Lloyd rounds, then up to
``max_iter`` iterations of a clustering phase (soft k-means with the
diversity penalty, updated block by block) and a mixture-of-experts ridge
correction, stopping when the objective improves by less than
``epsilon_harmony``. The blocks are those of the program's schedule:
on ``permute`` a fresh permutation of the cells a round, cut into the
reference's blocks; on ``rotate`` the cells in their ingest order, cut
into tiles, the tiles rotated and grouped into contiguous blocks, visited
in a random order (``ingest.py``, ``draws.py``). Every block sees the
statistics with its own old assignments removed.

It keeps R (K, N) whole and computes each step the plain way: no per-tile
tables, no fused moments, no graph, no kernel of the program; the ridge
systems are solved by ``torch.linalg.solve``. It imports nothing of the
program. ``dtype=torch.float32`` with TF32 products is the control
(``benchmark/tests/test_control.py``).
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple

import numpy as np
import torch

from . import draws
from .ingest import Geometry

TINY32 = torch.finfo(torch.float32).tiny


class Settings(NamedTuple):
    """The run's settings, the reference package's defaults unless a
    configuration says otherwise."""

    K: int
    sigma: float = 0.1
    theta: float = 2.0
    alpha: float = 0.2  # lambda = alpha * E (lambda estimation)
    batch_prop_cutoff: float = 1e-5
    epsilon_harmony: float = 1e-2
    max_iter: int = 10
    rounds: int = 4  # max_iter_cluster; the window test cannot stop 4 rounds
    kmeans_iterations: int = 10
    block_size: float = 0.05
    shuffle: str = "rotate"


class Result(NamedTuple):
    """One integration, in engine order (the ingest order's positions)."""

    objective_harmony: np.ndarray  # init, then the last round's of each iteration
    iterations: int
    Y: torch.Tensor  # (d, K) final centroids
    R: torch.Tensor  # (K, N) the last round's assignments
    Z_corr: torch.Tensor  # (d, N) the last correction


def _l2(X: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    return X / torch.where(n == 0, torch.ones_like(n), n)


def _xlogx(R: torch.Tensor) -> torch.Tensor:
    return torch.where(R > 0, R * torch.log(R), torch.zeros_like(R))


def _batch_sums(R: torch.Tensor, codes: torch.Tensor, B: int) -> torch.Tensor:
    """O[k, b] = sum of R[k, n] over the cells n of batch b."""
    return torch.zeros((R.shape[0], B), dtype=R.dtype, device=R.device).index_add_(
        1, codes, R)


@contextlib.contextmanager
def _precision(tf32: bool):
    """TF32 products on (the control) or off (the reference) while inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class _Run:
    def __init__(self, Z: torch.Tensor, codes: torch.Tensor, B: int, st: Settings,
                 geo: Geometry, dtype):
        self.st, self.geo, self.dt = st, geo, dtype
        dev = Z.device
        perm = None if geo.perm is None else torch.as_tensor(geo.perm, device=dev)
        # engine order: position p holds input cell perm[p]
        Ze = Z if perm is None else Z.index_select(0, perm)
        self.codes = (codes if perm is None else codes.index_select(0, perm)).long()
        self.Z_orig = Ze.t().to(dtype).contiguous()  # (d, N)
        self.N, self.B, self.K = Ze.shape[0], B, st.K
        self.sizes = torch.bincount(self.codes, minlength=B).to(dtype)
        self.Pr = self.sizes / self.N
        self.nc = 2000.0 / self.N
        self.kterms: List[List[float]] = []

    # ---- objective -------------------------------------------------------
    def _push(self, kerr, ent, O, E):
        st = self.st
        pen_log = st.theta * torch.log((O + E + 1.0) / (2.0 * E + 1.0))
        cross = (st.sigma * pen_log * O).sum()
        self.kterms.append([float(kerr) * self.nc, float(ent) * self.nc,
                            float(cross) * self.nc])

    def _softmax_stats(self, Zn, Y):
        dist = 2.0 * (1.0 - Y.t() @ Zn)
        R = torch.softmax(-dist / self.st.sigma, dim=0)
        O = _batch_sums(R, self.codes, self.B)
        E = R.sum(dim=1, keepdim=True) * self.Pr[None, :]
        return dist, R, O, E

    # ---- k-means init ----------------------------------------------------
    def kmeans(self, X: torch.Tensor, g: torch.Generator) -> torch.Tensor:
        """Seed K centroids by the exponential race on the distances to K
        random starting cells (chosen cells excluded), then Lloyd rounds;
        an empty cluster keeps its centroid."""
        K, N = self.K, self.N
        starts = draws.kmeans_starts(g, N, K)
        D = torch.abs(2.0 * (1.0 - X[:, starts].t() @ X))  # (K, N)
        chosen = torch.zeros(N, dtype=torch.bool, device=X.device)
        picks = []
        for k in range(K):
            u = draws.kmeans_uniform(g, N).to(torch.float64)
            prob = -torch.log(u) / torch.clamp(D[k].to(torch.float64), min=TINY32)
            prob = torch.where(chosen, torch.full_like(prob, float("inf")), prob)
            i = torch.argmin(prob)
            chosen[i] = True
            picks.append(i)
        del D
        Y = X[:, torch.stack(picks)]
        for _ in range(self.st.kmeans_iterations):
            sq = (Y * Y).sum(dim=0)
            assign = torch.argmin(sq[:, None] - 2.0 * (Y.t() @ X), dim=0)
            sums = torch.zeros_like(Y).index_add_(1, assign, X)
            counts = torch.bincount(assign, minlength=K).to(X.dtype)
            Y = torch.where(counts[None, :] > 0, sums / torch.clamp(counts, min=1.0), Y)
        return _l2(Y)

    # ---- clustering ------------------------------------------------------
    def _blocks(self, g: torch.Generator):
        """Each round's blocks of cells, in visiting order."""
        st, geo, dev = self.st, self.geo, self.Z_orig.device
        if st.shuffle == "permute":
            nb = geo.n_blocks
            cpb = int(self.N * (0.2 if self.N < 40 else st.block_size))
            return [[p[i * cpb:(i + 1) * cpb if i < nb - 1 else self.N] for i in range(nb)]
                    for p in draws.permutations(g, st.rounds, self.N)]
        T, NT, nb = geo.tile, geo.n_tiles, geo.n_blocks
        base, rem = divmod(NT, nb)
        szs = [base + (i < rem) for i in range(nb)]
        vstart = [sum(szs[:i]) for i in range(nb)]
        lane = torch.arange(T, device=dev)
        out = []
        for rt, order in draws.rotate_schedule(g, st.rounds, NT, nb):
            blocks = []
            for blk in order:
                tiles = torch.tensor([(vstart[blk] + j + rt) % NT for j in range(szs[blk])],
                                     device=dev)
                pos = (tiles[:, None] * T + lane[None, :]).reshape(-1)
                blocks.append(pos[pos < self.N])
            out.append(blocks)
        return out

    def cluster(self, Zn, Y, R, O, E, g):
        """One clustering phase of ``rounds`` rounds from (R, O, E)."""
        st = self.st
        codes = self.codes
        for blocks in self._blocks(g):
            kerr = ent = 0.0
            for cells in blocks:
                Rb = R[:, cells]
                cb = codes[cells]
                E = E - Rb.sum(dim=1, keepdim=True) * self.Pr[None, :]
                O = O - _batch_sums(Rb, cb, self.B)
                pen = ((2.0 * E + 1.0) / (O + E + 1.0)) ** st.theta
                dist = 2.0 * (1.0 - Y.t() @ Zn[:, cells])
                w = torch.exp(-dist / st.sigma) * pen[:, cb]
                Rn = w / w.sum(dim=0, keepdim=True)
                R[:, cells] = Rn
                E = E + Rn.sum(dim=1, keepdim=True) * self.Pr[None, :]
                O = O + _batch_sums(Rn, cb, self.B)
                kerr = kerr + (Rn * dist).sum()
                ent = ent + (st.sigma * _xlogx(Rn)).sum()
            self._push(kerr, ent, O, E)
        return R, O, E

    # ---- correction ------------------------------------------------------
    def correct(self, R, O, E, Y):
        """The mixture-of-experts ridge correction with lambda = alpha E;
        a batch whose share of a cluster is at or under the cutoff, and a
        cluster with fewer than two such batches, is left out as the
        reference leaves it out."""
        st, B, K, dev = self.st, self.B, self.K, R.device
        keep = (O / self.sizes[None, :]) > st.batch_prop_cutoff
        active = keep.sum(dim=1) > 1
        keep = keep & active[:, None]
        keepf = keep.to(self.dt)
        Zaug = torch.cat([self.Z_orig, torch.ones_like(self.Z_orig[:1])])  # (d+1, N)
        M = torch.zeros((K, B, Zaug.shape[0]), dtype=self.dt, device=dev)
        order = torch.argsort(self.codes)
        bounds = torch.cumsum(torch.bincount(self.codes, minlength=B), 0).tolist()
        lo = 0
        for b, hi in enumerate(bounds):
            idx = order[lo:hi]
            if len(idx):
                M[:, b, :] = R[:, idx] @ Zaug[:, idx].t()
            lo = hi
        Ob = M[:, :, -1] * keepf
        rhs_b = M[:, :, :-1] * keepf[:, :, None]
        G = torch.zeros((K, B + 1, B + 1), dtype=self.dt, device=dev)
        G[:, 0, 0] = Ob.sum(dim=1) + torch.where(active, 0.0, 1.0).to(self.dt)
        G[:, 0, 1:] = Ob
        G[:, 1:, 0] = Ob
        diag = torch.arange(1, B + 1, device=dev)
        G[:, diag, diag] = Ob + torch.where(keep, st.alpha * E, torch.ones_like(E))
        rhs = torch.cat([rhs_b.sum(dim=1, keepdim=True), rhs_b], dim=1)  # (K, B+1, d)
        W = torch.linalg.solve(G, rhs)
        Y_new = _l2(torch.where(active[None, :], W[:, 0, :].t(), Y))
        Z_corr = self.Z_orig.clone()
        lo = 0
        for b, hi in enumerate(bounds):
            idx = order[lo:hi]
            if len(idx):
                Z_corr[:, idx] -= W[:, 1 + b, :].t() @ R[:, idx]
            lo = hi
        return Z_corr, Y_new


def settings(conf: dict, N: int, shuffle: str) -> Settings:
    """The settings of a configuration's ``harmony`` block (``nclust``,
    ``theta``, ``sigma``, ``max_iter``, ``early_stop`` and the advanced
    ``options``) over the reference package's defaults."""
    from .ingest import default_nclust

    o = conf.get("options", {})
    for k in o:
        if k not in ("alpha", "block_size", "max_iter_cluster", "epsilon_harmony",
                     "batch_prop_cutoff"):
            raise ValueError(f"the reference has no option {k!r}")
    K = conf.get("nclust")
    return Settings(
        K=default_nclust(N) if K is None else int(K),
        sigma=float(conf.get("sigma", 0.1)),
        theta=2.0 if conf.get("theta") is None else float(conf["theta"]),
        alpha=float(o.get("alpha", 0.2)),
        batch_prop_cutoff=float(o.get("batch_prop_cutoff", 1e-5)),
        epsilon_harmony=(float(o.get("epsilon_harmony", 1e-2)) if conf.get("early_stop", True)
                         else float("-inf")),
        max_iter=int(conf.get("max_iter", 10)),
        rounds=int(o.get("max_iter_cluster", 4)),
        block_size=float(o.get("block_size", 0.05)),
        shuffle=shuffle)


def integrate(Z: torch.Tensor, codes: torch.Tensor, B: int, st: Settings, geo: Geometry,
              seed: int, dtype=torch.float64,
              tf32: bool = False) -> Result:
    """One whole integration of ``Z`` (N, d) with batch ``codes`` (N,) as
    the program runs it from the job's ``seed``: k-means init, then up to
    ``st.max_iter`` iterations with the early stop."""
    with _precision(tf32), torch.no_grad():
        run = _Run(Z, codes, B, st, geo, dtype)
        g = draws.generator(seed, Z.device)
        X = _l2(run.Z_orig)
        Y = run.kmeans(X, g)
        dist, R, O, E = run._softmax_stats(X, Y)
        run._push((R * dist).sum(), (st.sigma * _xlogx(R)).sum(), O, E)
        del dist
        harmony = [sum(run.kterms[-1])]
        Z_corr = X
        it = 0
        while it < st.max_iter:
            # the phase's entry: Z_corr normalised, assignments recomputed
            Zn = _l2(Z_corr)
            if it > 0:
                _, R, O, E = run._softmax_stats(Zn, Y)
            R, O, E = run.cluster(Zn, Y, R, O, E, g)
            del Zn
            harmony.append(sum(run.kterms[-1]))
            Z_corr, Y = run.correct(R, O, E, Y)
            it += 1
            old, new = harmony[-2], harmony[-1]
            if (old - new) / abs(old) < st.epsilon_harmony:
                break
        return Result(objective_harmony=np.asarray(harmony), iterations=it, Y=Y, R=R,
                      Z_corr=Z_corr)
