"""Sequential reference-exact oracle sampler (numpy, host-side).

A proposal-by-proposal mirror of the reference's sequential engine —
SingleThreadedGibbsSampler (reference:
src/gibbs_sampler/SingleThreadedGibbsSampler.h:95-257) over the dense
normal model (src/gibbs_sampler/DenseNormalModel.cpp) and the true
2^64-position atomic domain (src/atomic/AtomicDomain.cpp) — used as a
DISTRIBUTION-level oracle for the batched engine.

This sampler keeps every reference behavior the batched engine
re-designs, so the two can be compared at equilibrium to validate the
batching deltas:
  * moves relocate within the neighbor-bounded interval
    (h:192-223) — the engine uses a symmetric local window;
  * exchanges pair with the DOMAIN SUCCESSOR, wrapping to front()
    (h:228-257) — the engine pairs with a uniform other atom;
  * same-bin exchanges are ignored (h:247 "ignore exchanges in the
    same bin") — the engine applies the async queue's gamma
    redistribution (ProposalQueue.cpp:267-277);
  * alpha parameters are evaluated per proposal against the CURRENT
    state — the engine evaluates batches against the sweep-start state
    with same-row sequential corrections.

Everything here is plain numpy float32 (like the reference's C++98
floats); no JAX, no jit — it is a test oracle, not a production path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.special import ndtr, ndtri

EPSILON = 1.0e-10


class _Domain:
    """Sorted atomic domain over [0, domain_length) with python-int
    positions (numpy uint64 arithmetic wraps silently; positions fit
    python ints exactly). Mirrors src/atomic/AtomicDomain.cpp."""

    def __init__(self, domain_length: int):
        self.L = domain_length
        self.pos: list = []  # sorted python ints
        self.mass: list = []

    def size(self) -> int:
        return len(self.pos)

    def random_free_position(self, rng) -> int:
        while True:
            p = int(rng.integers(0, self.L, dtype=np.uint64))
            if p not in self.pos:  # rejection sample (cpp:41-49)
                return p

    def random_index(self, rng) -> int:
        return int(rng.integers(0, len(self.pos)))

    def insert(self, p: int, m: float) -> None:
        import bisect
        i = bisect.bisect_left(self.pos, p)
        self.pos.insert(i, p)
        self.mass.insert(i, np.float32(m))

    def erase(self, i: int) -> None:
        del self.pos[i]
        del self.mass[i]

    def move(self, i: int, p: int) -> None:
        m = self.mass[i]
        self.erase(i)
        self.insert(p, m)

    def neighbors(self, i: int):
        """(lbound, rbound) for a move (reference: h:198-201)."""
        lb = self.pos[i - 1] if i > 0 else 0
        rb = self.pos[i + 1] if i + 1 < len(self.pos) else self.L
        return lb, rb


class _DenseModel:
    """DenseNormalModel over one factor (reference:
    src/gibbs_sampler/DenseNormalModel.cpp). `D` is (n, m); `M` is the
    sampled factor (n, k); `other` the frozen partner (m, k); `AP` the
    cached product (n, m), shared (transposed) between samplers."""

    def __init__(self, D, S, M, other, AP, lam, max_gibbs_mass):
        self.D = D
        self.invS2 = (1.0 / (S * S)).astype(np.float32)
        self.M = M
        self.other = other
        self.AP = AP
        self.lam = np.float32(lam)
        self.mgm = np.float32(max_gibbs_mass / lam)  # h:79-81
        self.temp = np.float32(1.0)

    def col_nz(self, c: int) -> bool:
        return bool(np.max(self.other[:, c]) > 0.0)

    def alpha(self, r: int, c: int):
        w = self.invS2[r]
        o = self.other[:, c]
        s = float(np.dot(o * o, w))
        smu = float(np.dot(o * (self.D[r] - self.AP[r]), w))
        return s, smu

    def alpha_pair(self, r1, c1, r2, c2):
        """Two-element alpha (cpp:186-214): same-row joint form equals
        (s1+s2-2x, smu1-smu2); cross-row is the '+' composition."""
        s1, smu1 = self.alpha(r1, c1)
        s2, smu2 = self.alpha(r2, c2)
        if r1 == r2:
            w = self.invS2[r1]
            x = float(np.dot(self.other[:, c1] * self.other[:, c2], w))
            return s1 + s2 - 2.0 * x, smu1 - smu2
        return s1 + s2, smu1 - smu2

    def change(self, r, c, d):
        """changeMatrix + updateAPMatrix (cpp:105-123, 243-258)."""
        self.M[r, c] += np.float32(d)
        self.AP[r] += np.float32(d) * self.other[:, c]

    def safely_change(self, r, c, d):
        actual = max(self.M[r, c] + d, 0.0) - self.M[r, c]
        self.change(r, c, actual)


def _gibbs_mass(rng, s, smu, a, b, lam=None) -> Optional[float]:
    """AlphaParameters.cpp:27-48 + Random.cpp:178-191 far-tail failure."""
    if s <= EPSILON:
        return None
    mean = ((smu - lam) if lam is not None else smu) / s
    sd = 1.0 / np.sqrt(s)
    plo = ndtr((a - mean) / sd)
    pup = ndtr((b - mean) / sd)
    if plo > 0.95 or pup < 0.05:
        return None
    u = rng.uniform()
    q = np.clip(plo + u * (pup - plo), 1e-7, 1.0 - 1e-7)
    return float(np.clip(mean + sd * ndtri(q), a, b))


class SequentialOracle:
    """The reference's full two-phase run (GapsRunner.cpp:273-327) with
    the sequential sampler, on host numpy."""

    def __init__(self, D: np.ndarray, k: int, S=None, alpha=0.01,
                 max_gibbs_mass=100.0, seed: int = 0):
        D = np.asarray(D, np.float32)
        if S is None:
            S = np.maximum(0.1 * D, 0.1).astype(np.float32)
        G, Sn = D.shape
        self.k = k
        self.rng = np.random.default_rng(seed)
        nz = D[D > 0]
        lam = alpha * np.sqrt(k / float(nz.mean())) if nz.size else alpha
        self.M_a = np.zeros((G, k), np.float32)
        self.M_p = np.zeros((Sn, k), np.float32)
        AP = np.zeros((G, Sn), np.float32)
        self.model_a = _DenseModel(D, S, self.M_a, self.M_p, AP, lam,
                                   max_gibbs_mass)
        self.model_p = _DenseModel(D.T.copy(), S.T.copy(), self.M_p,
                                   self.M_a, AP.T, lam, max_gibbs_mass)
        self.dom_a = _Domain(((2**64) // (G * k)) * (G * k))
        self.dom_p = _Domain(((2**64) // (Sn * k)) * (Sn * k))
        self.alpha_param = alpha
        self.chisq_hist = []
        self.atom_hist = []

    # ------------------------------------------------------------------
    def _rc(self, dom: _Domain, model, pos: int):
        bin_len = dom.L // (model.M.shape[0] * self.k)
        b = pos // bin_len
        return int(b // self.k), int(b % self.k)

    def _step(self, dom: _Domain, model: _DenseModel):
        rng = self.rng
        n = dom.size()
        # getUpdateType (h:95-111)
        if n < 2:
            t = "B"
        else:
            u1 = rng.uniform()
            if u1 < 0.5:
                numer = n * float(dom.L)
                dp = numer / (numer + self.alpha_param
                              * (model.M.shape[0] * self.k)
                              * (float(dom.L) - n))
                t = "D" if rng.uniform() < dp else "B"
            else:
                t = "M" if u1 < 0.75 else "E"
        getattr(self, "_" + t)(dom, model)

    def _B(self, dom, model):  # birth (h:131-149)
        pos = dom.random_free_position(self.rng)
        r, c = self._rc(dom, model, pos)
        if model.col_nz(c):
            s, smu = model.alpha(r, c)
            mass = _gibbs_mass(self.rng, s * model.temp, smu * model.temp,
                               0.0, model.mgm, model.lam)
        else:
            mass = float(self.rng.exponential(1.0 / model.lam))
        if mass is not None and mass > EPSILON:
            dom.insert(pos, mass)
            model.change(r, c, mass)

    def _D(self, dom, model):  # death (h:154-188)
        i = dom.random_index(self.rng)
        r, c = self._rc(dom, model, dom.pos[i])
        m = float(dom.mass[i])
        s, smu = model.alpha(r, c)
        s_t = s * model.temp
        smu_t = (smu + m * s) * model.temp  # withChange(-m)
        rebirth = m
        if model.col_nz(c):
            gm = _gibbs_mass(self.rng, s_t, smu_t, 0.0, model.mgm,
                             model.lam)
            if gm is not None:
                rebirth = gm
        dll = rebirth * (smu_t - s_t * rebirth / 2.0)
        if np.log(max(self.rng.uniform(), 1e-37)) < dll:
            if rebirth != m:
                model.safely_change(r, c, rebirth - m)
                dom.mass[i] = np.float32(rebirth)
        else:
            model.safely_change(r, c, -m)
            dom.erase(i)

    def _M(self, dom, model):  # move (h:192-223)
        i = dom.random_index(self.rng)
        lb, rb = dom.neighbors(i)
        if rb - 1 < lb + 1:
            return
        pos = int(self.rng.integers(lb + 1, max(rb - 1, lb + 2),
                                    dtype=np.uint64))
        r1, c1 = self._rc(dom, model, dom.pos[i])
        r2, c2 = self._rc(dom, model, pos)
        if r1 == r2 and c1 == c2:
            dom.move(i, pos)
            return
        m = float(dom.mass[i])
        s, smu = model.alpha_pair(r1, c1, r2, c2)
        dll = -m * (smu * model.temp + s * model.temp * m / 2.0)
        if np.log(max(self.rng.uniform(), 1e-37)) < dll:
            dom.move(i, pos)
            model.safely_change(r1, c1, -m)
            model.change(r2, c2, m)

    def _E(self, dom, model):  # exchange (h:228-257)
        i = dom.random_index(self.rng)
        j = i + 1 if i + 1 < dom.size() else 0  # right neighbor / front
        r1, c1 = self._rc(dom, model, dom.pos[i])
        r2, c2 = self._rc(dom, model, dom.pos[j])
        if (r1 == r2 and c1 == c2) or not (model.col_nz(c1)
                                           or model.col_nz(c2)):
            return  # same-bin exchanges ignored (h:247)
        m1, m2 = float(dom.mass[i]), float(dom.mass[j])
        s, smu = model.alpha_pair(r1, c1, r2, c2)
        d = _gibbs_mass(self.rng, s * model.temp, smu * model.temp,
                        -m1, m2)
        if d is None:
            return
        nm1, nm2 = m1 + d, m2 - d
        if nm1 > EPSILON and nm2 > EPSILON:
            model.safely_change(r1, c1, nm1 - m1)
            model.safely_change(r2, c2, nm2 - m2)
            dom.mass[i] = np.float32(nm1)
            dom.mass[j] = np.float32(nm2)

    # ------------------------------------------------------------------
    def chisq(self) -> float:
        m = self.model_a
        return float(np.sum((m.D - m.AP) ** 2 * m.invS2))

    def run(self, n_iterations: int, record_every: int = 0):
        """Two phases (equilibration with annealing, then sampling),
        Poisson(max(n,10)) updates per matrix per iteration
        (GapsRunner.cpp:285-296)."""
        for phase in (0, 1):
            for it in range(n_iterations):
                temp = (min(1.0, 2.0 * it / n_iterations) if phase == 0
                        else 1.0)
                self.model_a.temp = np.float32(temp)
                self.model_p.temp = np.float32(temp)
                n_a = int(self.rng.poisson(max(self.dom_a.size(), 10)))
                n_p = int(self.rng.poisson(max(self.dom_p.size(), 10)))
                for _ in range(n_a):
                    self._step(self.dom_a, self.model_a)
                for _ in range(n_p):
                    self._step(self.dom_p, self.model_p)
                if record_every and (it + 1) % record_every == 0:
                    self.chisq_hist.append(self.chisq())
                    self.atom_hist.append((self.dom_a.size(),
                                           self.dom_p.size()))
        return self
