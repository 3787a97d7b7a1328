"""Plain reference of weighted-L1 (d_w^l1, theta)-ALSH search over rows
stored as bfloat16.

A copy of ``wl1_alsh`` (reference files import nothing but torch; a test
holds the copy to the original) with one change: the hash levels, keys,
sorted tables, probe windows and candidate sets come from the raw float32
rows, as an encoded index hashes before it encodes, while ``distances``,
``topk`` and ``exact`` measure the rows rounded to bfloat16
(``rows.to(torch.bfloat16)``), widened to the reference's precision:
float64 for the reference (exact: a bfloat16 value is a float64 value),
bfloat16 for the control (``precision="bf16"``), which also hashes in
bfloat16 as ``wl1_alsh``'s control does. The query and weights are the
raw float32 ones. A configuration of any other storage raises.

It runs on the CUDA card when one is present, whatever device the rows
come from (an encoded deployment hands them over from host memory); its
methods take tensors on any device and answer on the device of their
first tensor argument.

The semantics (Hu & Li 2021, §3-§4, with the sorted-window index):

* levels ``u = clamp(floor((x - lo) * t), 0, M)`` per coordinate;
* H = K·L Gaussian projections over the unary transforms, folded into a
  table ``b'[h, i, m]`` (Eq 28), so that ``a^T P(o) = sum_i b'[h, i, o_i]``
  and ``a^T Q_w(q) = sum_i w_i b'[h, i, q_i]``;
* a theta hash bit is ``a^T x >= 0``; table l's key packs bits
  ``l·K .. l·K+K-1`` little end first;
* each table lists its rows by (key, row id); a probe of key ``c`` takes
  the first C rows of that bucket;
* multiprobe (Lv et al.) also probes the keys that flip the bit subsets of
  at most ``max_flips`` bits with the least total |margin|, ordered by that
  sum, ties to the subset that comes first by size then lexicographically;
* a query's candidates are the distinct rows of its L·P windows, and its
  answer the k candidates of least ``sum_i w_i |bf16(x_i) - q_i|``, ties to
  the lower row id, padded with (inf, -1).

The draw of the tables is a frozen copy of the seed's use: a CPU
``torch.Generator`` seeded with the index seed draws ``randn(H, 2d, M)``
in float32, cosine rows first; theta draws nothing else that the query
reads.
"""

from __future__ import annotations

import itertools
import math

import torch

PRECISIONS = {"f64": torch.float64, "bf16": torch.bfloat16}
ONEHOT_ELEMS = 1 << 27  # values of one one-hot block
DIST_ELEMS = 1 << 27  # values of one (queries, rows, d) distance block


class Geometry:
    """The index geometry of a configuration file's ``index`` group."""

    def __init__(self, d: int, index: dict):
        self.d = d
        self.M = int(index["M"])
        self.K = int(index["K"])
        self.L = int(index["L"])
        self.C = int(index["max_candidates"])
        self.lo, self.hi, self.t = (float(v) for v in index["space"])
        if index["family"] != "theta":
            raise NotImplementedError(f"reference covers the theta family, not {index['family']!r}")

    @property
    def H(self) -> int:
        return self.K * self.L


def draw_folded(seed: int, g: Geometry) -> torch.Tensor:
    """The folded tables (H, d, M+1) float32 on the CPU, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((g.H, 2 * g.d, g.M), generator=gen, dtype=torch.float32)
    cos_rows, sin_rows = a[:, : g.d], a[:, g.d :]
    zeros = torch.zeros((g.H, g.d, 1), dtype=torch.float32)
    suffix = torch.cat([torch.cumsum(cos_rows.flip(-1), dim=-1).flip(-1), zeros], dim=-1)
    prefix = torch.cat([zeros, torch.cumsum(sin_rows, dim=-1)], dim=-1)
    return suffix + prefix


def levels_of(x: torch.Tensor, g: Geometry) -> torch.Tensor:
    """Lattice levels (n, d) int64 of float32 points."""
    lv = torch.floor((x.float() - g.lo) * g.t).to(torch.int64)
    return lv.clamp(0, int((g.hi - g.lo) * g.t))


def project(levels: torch.Tensor, table: torch.Tensor, g: Geometry,
            weights: torch.Tensor | None = None) -> torch.Tensor:
    """sum_i w_i b'[h, i, levels_i] for every row: (n, d) -> (n, H), in the
    dtype of ``table`` ((d·(M+1), H)), as a one-hot product in blocks."""
    n, d = levels.shape
    width = d * (g.M + 1)
    out = torch.empty((n, g.H), dtype=table.dtype, device=table.device)
    step = max(1, ONEHOT_ELEMS // width)
    cols = torch.arange(d, device=table.device) * (g.M + 1)
    for s in range(0, n, step):
        lv = levels[s : s + step].to(table.device)
        onehot = torch.zeros((lv.shape[0], width), dtype=table.dtype, device=table.device)
        val = (torch.ones_like(lv, dtype=table.dtype) if weights is None
               else weights[s : s + step].to(device=table.device, dtype=table.dtype))
        onehot.scatter_(1, lv + cols, val)
        out[s : s + step] = onehot @ table
    return out


def pack_keys(proj: torch.Tensor, g: Geometry) -> torch.Tensor:
    """Theta table keys (n, L) int64 from projections (n, H)."""
    bits = (proj >= 0).to(torch.int64).reshape(-1, g.L, g.K)
    return (bits << torch.arange(g.K, device=proj.device)).sum(-1)


def flip_masks(K: int, max_flips: int) -> torch.Tensor:
    """Bit-flip subsets of size <= max_flips as (S, K) bool, by size, then
    lexicographically; the empty subset first."""
    subsets = [()]
    for r in range(1, max_flips + 1):
        subsets.extend(itertools.combinations(range(K), r))
    masks = torch.zeros((len(subsets), K), dtype=torch.bool)
    for i, s in enumerate(subsets):
        masks[i, list(s)] = True
    return masks


def probe_keys(proj: torch.Tensor, g: Geometry, n_probes: int, max_flips: int) -> torch.Tensor:
    """(b, L, P) keys: each table's own key, then (multiprobe) the flipped
    keys of least total |margin|."""
    b = proj.shape[0]
    base = pack_keys(proj, g)
    if n_probes <= 1:
        return base[:, :, None]
    masks = flip_masks(g.K, max_flips).to(proj.device)
    P = min(n_probes, masks.shape[0])
    margins = proj.abs().reshape(b, g.L, g.K)
    scores = margins @ masks.T.to(margins.dtype)  # (b, L, S)
    pick = torch.sort(scores, dim=-1, stable=True).indices[..., :P]
    shifts = torch.ones((), dtype=torch.int64, device=proj.device) << torch.arange(
        g.K, device=proj.device)
    flips = (masks.to(torch.int64) * shifts).sum(-1)
    return torch.bitwise_xor(base[:, :, None], flips[pick])


STORED = torch.bfloat16  # the stored rows' dtype


def reference_device(data: torch.Tensor) -> torch.device:
    """The CUDA card when one is present, else the rows' device."""
    return torch.device("cuda") if torch.cuda.is_available() else data.device


class Reference:
    """The reference index over ``data`` (n, d) float32, built from ``seed``,
    answering over the rows stored as bfloat16.

    ``precision`` is "f64" (the reference) or "bf16" (the control): the
    dtype of the tables, projections, weights and distances.
    """

    def __init__(self, data: torch.Tensor, seed: int, d: int, index: dict,
                 precision: str = "f64"):
        if index["storage"] != "bf16":
            raise ValueError(f"wl1_alsh_stored answers over bf16 rows, not {index['storage']!r}")
        self.g = Geometry(d, index)
        self.dtype = PRECISIONS[precision]
        self.n = data.shape[0]
        dev = reference_device(data)
        raw = data.to(dev)
        folded = draw_folded(seed, self.g)  # (H, d, M+1)
        self.table = folded.permute(1, 2, 0).reshape(-1, self.g.H).to(device=dev, dtype=self.dtype)
        keys = pack_keys(project(levels_of(raw, self.g), self.table, self.g), self.g)  # (n, L)
        rows = torch.arange(self.n, dtype=torch.int64, device=dev)
        # each table's rows by (key, row id): one sort of key·n + row
        self.sorted = torch.sort((keys * self.n + rows[:, None]).T.contiguous(), dim=1).values
        self.data = raw.to(STORED)  # the stored rows; the raw ones are dropped
        del raw, keys

    @property
    def device(self) -> torch.device:
        return self.sorted.device

    def keys(self, q: torch.Tensor, w: torch.Tensor, n_probes: int = 1,
             max_flips: int = 0) -> torch.Tensor:
        """(b, L, P) probe keys of a query batch."""
        out = q.device
        q, w = q.to(self.device), w.to(self.device)
        proj = project(levels_of(q, self.g), self.table, self.g, weights=w)
        return probe_keys(proj, self.g, n_probes, max_flips).to(out)

    def candidates(self, keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Distinct candidate rows of each query, ascending and padded with
        ``n``: (b, L, P) keys -> ((b, L·P·C) int64, (b,) counts)."""
        out = keys.device
        keys = keys.to(self.device)
        b, L, P = keys.shape
        n, C = self.n, self.g.C
        lo_v = (keys * n).permute(1, 0, 2).reshape(L, b * P).contiguous()
        start = torch.searchsorted(self.sorted, lo_v)
        end = torch.searchsorted(self.sorted, lo_v + n)
        pos = start[:, :, None] + torch.arange(C, device=keys.device)
        ids = torch.gather(self.sorted, 1, pos.clamp(max=n - 1).reshape(L, -1)).reshape(pos.shape)
        ids = torch.where(pos < end[:, :, None], ids % n, torch.full_like(ids, n))
        cand = ids.reshape(L, b, P * C).permute(1, 0, 2).reshape(b, L * P * C)
        cand = torch.sort(cand, dim=1).values
        first = torch.ones_like(cand, dtype=torch.bool)
        first[:, 1:] = cand[:, 1:] != cand[:, :-1]
        valid = first & (cand < n)
        packed = torch.sort(torch.where(valid, cand, torch.full_like(cand, n)), dim=1).values
        return packed.to(out), valid.sum(dim=1).to(out)

    def distances(self, q: torch.Tensor, w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """sum_i w_i |bf16(x_i) - q_i| of rows ``ids`` (b, m) per query, inf
        where an id is not a row, in the reference's dtype."""
        out_dev = q.device
        q, w, ids = q.to(self.device), w.to(self.device), ids.to(self.device)
        b, m = ids.shape
        d = self.g.d
        out = torch.empty((b, m), dtype=self.dtype, device=ids.device)
        step = max(1, DIST_ELEMS // max(1, m * d))
        for s in range(0, b, step):
            cid = ids[s : s + step]
            ok = (cid >= 0) & (cid < self.n)
            rows = self.data[cid.clamp(0, self.n - 1)].to(self.dtype)
            qs = q[s : s + step, None, :].to(self.dtype)
            ws = w[s : s + step, None, :].to(self.dtype)
            dist = (ws * (rows - qs).abs()).sum(-1)
            out[s : s + step] = torch.where(ok, dist, torch.full_like(dist, math.inf))
        return out.to(out_dev)

    def topk(self, q: torch.Tensor, w: torch.Tensor, cand: torch.Tensor,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The k nearest of each query's ascending candidates: ((b, k) dists,
        (b, k) ids), (inf, -1) past the last candidate."""
        out_dev = q.device
        q, w, cand = q.to(self.device), w.to(self.device), cand.to(self.device)
        width = max(int((cand < self.n).sum(dim=1).max()), 1) if cand.numel() else 1
        cand = cand[:, :width]
        dist = self.distances(q, w, cand)
        order = torch.sort(dist, dim=1, stable=True).indices[:, :k]
        top_d = torch.gather(dist, 1, order)
        top_i = torch.gather(cand, 1, order)
        top_i = torch.where(torch.isinf(top_d), torch.full_like(top_i, -1), top_i)
        if top_d.shape[1] < k:
            pad = k - top_d.shape[1]
            top_d = torch.cat([top_d, torch.full((q.shape[0], pad), math.inf, dtype=top_d.dtype,
                                                 device=top_d.device)], dim=1)
            top_i = torch.cat([top_i, torch.full((q.shape[0], pad), -1, dtype=top_i.dtype,
                                                 device=top_i.device)], dim=1)
        return top_d.to(out_dev), top_i.to(out_dev)

    def exact(self, q: torch.Tensor, w: torch.Tensor, k: int,
              rows_per_block: int = 1 << 17) -> tuple[torch.Tensor, torch.Tensor]:
        """The k nearest of all n rows (brute force, in row blocks)."""
        out_dev = q.device
        q, w = q.to(self.device), w.to(self.device)
        b = q.shape[0]
        dev = q.device
        best_d = torch.full((b, 0), math.inf, dtype=self.dtype, device=dev)
        best_i = torch.full((b, 0), -1, dtype=torch.int64, device=dev)
        for s in range(0, self.n, rows_per_block):
            e = min(s + rows_per_block, self.n)
            ids = torch.arange(s, e, device=dev)[None, :].expand(b, -1)
            dist = self.distances(q, w, ids)
            cat_d = torch.cat([best_d, dist], dim=1)
            cat_i = torch.cat([best_i, ids], dim=1)
            order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
            best_d, best_i = torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)
        return best_d.to(out_dev), best_i.to(out_dev)
