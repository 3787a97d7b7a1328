"""Declarative scan space of the offline autotuner — counterpart of
``repro.tuner.space``.

A :class:`ScanSpace` names the five-knob design space of the paper's ALSH
schemes — ``family × K × L × W × n_probes × window`` — crossed with the
:class:`DataProfile` axes (rows ``n``, dims ``d``, weight skew, data
source). ``ScanSpace.trials()`` enumerates it into concrete
:class:`TrialSpec` points with the reference's rules (invalid corners
dropped, knobs a family ignores collapsed), in the reference's order.

Every trial is content-addressed: ``TrialSpec.trial_id`` and
``ScanSpace.space_id`` hash pure-Python dicts, so they equal the
reference's for the same space, byte for byte, and a trial store or tuning
table written by either package is read by the other. A trial's seed
derives from its id.

The data a trial measures on (:func:`profile_data`, :func:`profile_queries`,
:func:`profile_weights`) is drawn from seeded CPU ``torch.Generator``s and
then moved to the device, so a trial gives the same records on every
device; the reference draws with ``jax.random``, so the two packages' trials
run on different data.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import torch

from repro_torch.core.families import get_family, n_flip_subsets

__all__ = [
    "DataProfile",
    "TrialSpec",
    "ScanSpace",
    "grid",
    "log_range",
    "seeded_choice",
    "profile_data",
    "profile_queries",
    "profile_weights",
]

# l2 trials may ask for the planner-style anchored bucket width instead of a
# fixed float; the executor resolves it per trial (see scan.resolve_width)
AUTO_WIDTH = "auto"


def grid(*values):
    """An explicit axis: the values, deduplicated, in the given order."""
    out = []
    for v in values:
        if v not in out:
            out.append(v)
    return tuple(out)


def log_range(lo: int, hi: int, num: int) -> tuple:
    """``num`` geometrically spaced ints in [lo, hi], deduplicated."""
    if lo <= 0 or hi < lo or num <= 0:
        raise ValueError(f"log_range needs 0 < lo <= hi and num > 0; "
                         f"got lo={lo}, hi={hi}, num={num}")
    if num == 1:
        return (int(lo),)
    ratio = (hi / lo) ** (1.0 / (num - 1))
    vals = [int(round(lo * ratio**i)) for i in range(num)]
    return grid(*vals)


def seeded_choice(values, num: int, seed: int = 0) -> tuple:
    """A deterministic random subsample of an axis (ScanLHA's random-scan
    mode): ``num`` values drawn without replacement, order-stable given
    ``seed``. Returns all of ``values`` when ``num`` covers them."""
    values = grid(*values)
    if num >= len(values):
        return values
    # seeded Fisher-Yates via a tiny splitmix-style LCG — no numpy import,
    # no global RNG state, identical on every host
    state = (seed * 0x9E3779B97F4A7C15 + 0xBF58476D1CE4E5B9) & (2**64 - 1)
    pool = list(values)
    out = []
    for _ in range(num):
        state = (state * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)
        out.append(pool.pop((state >> 33) % len(pool)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class DataProfile:
    """One point on the data axes of the scan.

    Attributes:
      n: database rows the trial index is built over.
      d: dimensionality.
      skew: weight-distribution shape — trial weights are drawn as
        ``|N(0,1)|**skew + 0.1`` per dim, so ``skew=1.0`` reproduces the
        planner's reference profile
        (:func:`repro_torch.api.planner.default_calibration_weights`), ``skew>1``
        concentrates mass on few dims (heavy-tailed tenant weights) and
        ``skew<1`` flattens it.
      source: "uniform" (iid U[0,1) rows), "clustered" (seeded Gaussian
        mixture in the unit cube — the correlated stand-in), or "sampled"
        (rows drawn from the real dataset handed to the scan executor).
    """

    n: int
    d: int
    skew: float = 1.0
    source: str = "uniform"

    def __post_init__(self):
        if self.source not in ("uniform", "clustered", "sampled"):
            raise ValueError(
                f"DataProfile.source must be 'uniform' | 'clustered' | "
                f"'sampled', got {self.source!r}"
            )
        for field in ("n", "d"):
            v = getattr(self, field)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(
                    f"DataProfile.{field} must be a positive int, got {v!r}"
                )
        if not self.skew > 0:
            raise ValueError(f"DataProfile.skew must be > 0, got {self.skew!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DataProfile":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """One fully concrete scan point: a data profile plus the five knobs.

    ``W`` is a float, or the string ``"auto"`` for l2 trials that should
    resolve the planner-style anchored width on their own data (the record
    written to the trial store carries the resolved float). ``seed`` is
    DERIVED from ``trial_id`` — never set it by hand.
    """

    profile: DataProfile
    family: str
    K: int
    L: int
    W: object  # float | "auto"
    n_probes: int
    max_flips: int
    window: int  # query-time per-table candidate window (== build C)
    k: int
    queries: int  # held-out queries measured per trial
    M: int = 32
    shards: int = 1
    base_seed: int = 0
    early_exit: bool = False
    exit_group: int = 8
    exit_slack: float = 0.0

    def payload(self) -> dict:
        """The semantic content the trial id hashes (everything that can
        change a deterministic metric)."""
        return {
            "profile": self.profile.to_dict(),
            "family": self.family,
            "K": self.K,
            "L": self.L,
            "W": self.W,
            "n_probes": self.n_probes,
            "max_flips": self.max_flips,
            "window": self.window,
            "k": self.k,
            "queries": self.queries,
            "M": self.M,
            "shards": self.shards,
            "base_seed": self.base_seed,
            "early_exit": self.early_exit,
            "exit_group": self.exit_group,
            "exit_slack": self.exit_slack,
        }

    @property
    def trial_id(self) -> str:
        digest = hashlib.sha1(
            json.dumps(self.payload(), sort_keys=True).encode()
        ).hexdigest()
        return digest[:16]

    @property
    def seed(self) -> int:
        """Per-trial PRNG seed: the first 31 bits of the content hash, so a
        rerun of the same trial (any process, any host) draws identical
        data/queries/weights."""
        return int(self.trial_id[:8], 16) & 0x7FFFFFFF

    def to_dict(self) -> dict:
        return self.payload()

    @classmethod
    def from_dict(cls, d: dict) -> "TrialSpec":
        d = dict(d)
        d["profile"] = DataProfile.from_dict(d["profile"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ScanSpace:
    """The declarative spec the executor enumerates.

    Axes are plain tuples (build them with :func:`grid` /
    :func:`log_range` / :func:`seeded_choice`); the cross product is
    filtered down to valid, non-duplicate trials by :meth:`trials`.
    """

    profiles: tuple
    families: tuple = ("theta", "l2")
    K: tuple = (8, 12, 16)
    L: tuple = (16, 32, 64)
    W: tuple = (AUTO_WIDTH,)
    n_probes: tuple = (1, 4, 16)
    window: tuple = (256,)
    k: int = 10
    queries: int = 64
    M: int = 32
    shards: int = 1
    base_seed: int = 0
    early_exit: tuple = (False,)
    exit_group: tuple = (8,)
    exit_slack: float = 0.1

    def __post_init__(self):
        # normalize axes to tuples so the space hashes/serializes stably
        for f in ("profiles", "families", "K", "L", "W", "n_probes", "window",
                  "early_exit", "exit_group"):
            object.__setattr__(self, f, tuple(getattr(self, f)))
        if not self.profiles:
            raise ValueError("ScanSpace.profiles must name at least one DataProfile")
        for fam in self.families:
            get_family(fam)  # raises on unknown names

    @property
    def space_id(self) -> str:
        """Content hash of the whole space — the trial store records it so a
        resume against the wrong store fails loudly instead of merging two
        unrelated scans."""
        return hashlib.sha1(
            json.dumps(self.to_dict(), sort_keys=True).encode()
        ).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "profiles": [p.to_dict() for p in self.profiles],
            "families": list(self.families),
            "K": list(self.K),
            "L": list(self.L),
            "W": list(self.W),
            "n_probes": list(self.n_probes),
            "window": list(self.window),
            "k": self.k,
            "queries": self.queries,
            "M": self.M,
            "shards": self.shards,
            "base_seed": self.base_seed,
            "early_exit": list(self.early_exit),
            "exit_group": list(self.exit_group),
            "exit_slack": self.exit_slack,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScanSpace":
        d = dict(d)
        d["profiles"] = tuple(DataProfile.from_dict(p) for p in d["profiles"])
        for f in ("families", "K", "L", "W", "n_probes", "window"):
            d[f] = tuple(d[f])
        for f in ("early_exit", "exit_group"):
            if f in d:
                d[f] = tuple(d[f])
        return cls(**d)

    def trials(self) -> tuple:
        """Enumerate the valid, deduplicated trial grid (stable order).

        Collapsing rules (each avoids measuring the same program twice):
          * theta ignores W — every W value collapses to the config default.
          * l2 has no probing sequence — n_probes collapses to 1.
          * n_probes beyond ``n_flip_subsets(K, max_flips)`` duplicates
            buckets — those points are dropped, matching the facade's
            probe-reach gate.
          * K above a family's cap (theta: 31) is dropped.
          * windows below k, and profiles smaller than the held-out query
            draw, are dropped.
          * early-exit points whose L·n_probes lattice spans fewer than two
            ``exit_group`` groups are dropped (the engine's normalization
            folds them onto the monolithic program — measuring them would
            duplicate the early_exit=False point); when early exit is off
            the group/slack knobs collapse to their defaults for the same
            reason.
        """
        out, seen = [], set()
        for profile in self.profiles:
            for fam in self.families:
                fam_obj = get_family(fam)
                for K in self.K:
                    if fam_obj.max_K is not None and K > fam_obj.max_K:
                        continue
                    max_flips = min(3, K)
                    for L in self.L:
                        for W in self.W:
                            if fam != "l2":
                                W = 4.0  # unused by theta; collapse
                            for p in self.n_probes:
                                if not fam_obj.supports_multiprobe:
                                    p = 1  # collapse: no probing sequence
                                if p > 1 and p > n_flip_subsets(K, max_flips):
                                    continue
                                for C in self.window:
                                    if C < self.k or self.k >= profile.n:
                                        continue
                                    for early in self.early_exit:
                                        for G in self.exit_group:
                                            if not early:
                                                G, slack = 8, 0.0  # collapse
                                            else:
                                                slack = self.exit_slack
                                                if L * p < 2 * G:
                                                    continue  # folds to off
                                            t = TrialSpec(
                                                profile=profile, family=fam,
                                                K=K, L=L, W=W, n_probes=p,
                                                max_flips=(
                                                    max_flips if p > 1 else 0
                                                ),
                                                window=C, k=self.k,
                                                queries=self.queries, M=self.M,
                                                shards=self.shards,
                                                base_seed=self.base_seed,
                                                early_exit=early, exit_group=G,
                                                exit_slack=slack,
                                            )
                                            if t.trial_id not in seen:
                                                seen.add(t.trial_id)
                                                out.append(t)
        return tuple(out)


# ---------------------------------------------------------------------------
# profile data generation (seeded CPU generators, then the device)
# ---------------------------------------------------------------------------


def _mixture(generator: torch.Generator, m: int, d: int, centers: int = 8) -> torch.Tensor:
    """Seeded Gaussian mixture clipped to the unit cube."""
    mu = torch.rand((centers, d), generator=generator) * 0.7 + 0.15
    assign = torch.randint(0, centers, (m,), generator=generator)
    rows = mu[assign] + 0.06 * torch.randn((m, d), generator=generator)
    return torch.clamp(rows, 0.0, 1.0 - 1e-6)


def profile_data(profile: DataProfile, generator: torch.Generator, real_data=None,
                 device=None) -> torch.Tensor:
    """The trial database: (n, d) f32 rows drawn per ``profile.source`` on
    the CPU from ``generator``, then moved to ``device``."""
    n, d = profile.n, profile.d
    if profile.source == "uniform":
        rows = torch.rand((n, d), generator=generator)
    elif profile.source == "clustered":
        rows = _mixture(generator, n, d)
    else:
        if real_data is None:
            raise ValueError(
                "DataProfile.source='sampled' needs a real dataset — pass "
                "real_data=(rows, d) to the scan executor"
            )
        real = torch.as_tensor(real_data, dtype=torch.float32).cpu()
        if real.ndim != 2 or real.shape[1] != d:
            raise ValueError(
                f"real_data must be (rows, d={d}); got shape {tuple(real.shape)}"
            )
        if real.shape[0] < n:
            idx = torch.randint(0, real.shape[0], (n,), generator=generator)
        else:
            idx = torch.randperm(real.shape[0], generator=generator)[:n]
        rows = real[idx]
    return rows.to(device) if device is not None else rows


def profile_queries(profile: DataProfile, generator: torch.Generator, b: int, real_data=None,
                    device=None) -> torch.Tensor:
    """Held-out queries: fresh draws from the profile's distribution (for
    ``sampled``, real rows jittered by one lattice cell of M=32 so their
    bucket keys decouple from the indexed copies)."""
    rows = profile_data(dataclasses.replace(profile, n=b), generator, real_data)
    if profile.source == "sampled":
        rows = rows + (torch.rand(rows.shape, generator=generator) * (2 / 32) - 1 / 32)
    return rows.to(device) if device is not None else rows


def profile_weights(generator: torch.Generator, shape, skew: float = 1.0,
                    device=None) -> torch.Tensor:
    """Per-query weights ``|N(0,1)|**skew + 0.1`` — skew=1.0 is the
    planner's reference distribution."""
    w = torch.randn(tuple(shape), generator=generator).abs() ** skew + 0.1
    return w.to(device) if device is not None else w
