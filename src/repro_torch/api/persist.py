"""Self-describing index directories — counterpart of ``repro.api.persist``,
in the reference's format (version 5; versions 1–5 read).

Layout (one directory per index):

    <dir>/index.json               — format tag, IndexConfig, UpdateSpec,
                                     codec, segment manifest, plans, tuning
    <dir>/step_000000000/…         — the array leaves (``repro_torch.ckpt``:
                                     msgpack + zstd or zlib, atomic COMMIT)

The payload commits first and ``index.json`` is replaced last, so a save
that crashed leaves a directory that ``load_index`` refuses by name.

The leaves are positional, as the reference's pytrees flatten them, and are
written in its order, so either package reads what the other wrote and the
re-saved payload of an index loaded from a reference directory equals the
reference's byte for byte:

    build_key                       uint32 (2,)
    delta/0 … delta/3               delta data, levels, keys, fill (int32 ())
    state/0/0, state/0/1            tables.folded, tables.offsets
    state/1 … state/5               mixers, sorted_keys, perm, data, levels
    state/6                         scales (int8 storage only)
    tombstones                      bool (n + capacity,)

A version-1 directory has no ``delta`` or ``tombstones`` and loads as an
immutable index; pre-v3 directories have no ``plans``, pre-v4 no
``tuning``, pre-v5 no ``storage`` (they load as f32). The plan memo is the
manifest's list of {quality, planned} records (``plans_to_list``); it loads
as a dict ``QualitySpec -> PlannedSpec`` (``plans_from_list``), and floats
round-trip exactly through JSON, so a reloaded plan compares equal. The
tuning stamp is carried as plain JSON.

``build_key`` is the JAX PRNG key the reference drew its tables from. A key
loaded from a reference directory is carried through as opaque bytes. An
index this package built drew its tables with the torch RNG and has no such
key: it writes the marker ``PORT_BUILT_KEY`` = [0xFFFFFFFF, 0xFFFFFFFF],
which ``jax.random.PRNGKey(seed)`` never gives for a seed below 2**32. The
reference loads such a directory and answers from the stored tables, but
its ``Index.shard()`` re-derives the tables from the key, so it must not
shard a directory this package built. This package's ``Index.shard()``
shards with the stored tables, whichever package wrote them.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.api.spec import PlannedSpec, QualitySpec, UpdateSpec
from repro_torch.core.hash_families import PrefixTables
from repro_torch.core.index import ALSHIndex, DeltaSegment, IndexConfig
from repro_torch.core.transforms import BoundedSpace
from repro_torch.quant import get_codec

FORMAT = "repro.api.index"
VERSION = 5
_READABLE_VERSIONS = (1, 2, 3, 4, 5)
_META = "index.json"
PORT_BUILT_KEY = np.array([0xFFFFFFFF, 0xFFFFFFFF], dtype=np.uint32)

_STATE_FIELDS = ("mixers", "sorted_keys", "perm", "data", "levels")  # state/1 … state/5
_DELTA_FIELDS = ("data", "levels", "keys")  # delta/0 … delta/2; delta/3 is the fill


def config_to_dict(cfg: IndexConfig) -> dict:
    return {
        "d": cfg.d,
        "M": cfg.M,
        "K": cfg.K,
        "L": cfg.L,
        "family": cfg.family,
        "W": cfg.W,
        "max_candidates": cfg.max_candidates,
        "space": {"lo": cfg.space.lo, "hi": cfg.space.hi, "t": cfg.space.t},
        "storage": cfg.storage,
    }


def config_from_dict(d: dict) -> IndexConfig:
    space = d["space"]
    return IndexConfig(
        d=d["d"],
        M=d["M"],
        K=d["K"],
        L=d["L"],
        family=d["family"],
        W=d["W"],
        max_candidates=d["max_candidates"],
        space=BoundedSpace(space["lo"], space["hi"], space["t"]),
        storage=d.get("storage", "f32"),  # pre-v5 directories: full precision
    )


def update_to_dict(update: UpdateSpec) -> dict:
    return {
        "delta_capacity": update.delta_capacity,
        "compact_threshold": update.compact_threshold,
    }


def update_from_dict(d: dict) -> UpdateSpec:
    return UpdateSpec(
        delta_capacity=d["delta_capacity"],
        compact_threshold=d.get("compact_threshold", 0.75),
    )


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.bfloat16`` -> "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _leaf_names(scaled: bool, lifecycle: bool) -> list:
    names = ["build_key"]
    if lifecycle:
        names += [f"delta/{i}" for i in range(4)]
    names += ["state/0/0", "state/0/1"] + [f"state/{i}" for i in range(1, 6)]
    if scaled:
        names.append("state/6")
    if lifecycle:
        names.append("tombstones")
    return names


def plans_to_list(plans: dict) -> list:
    """The manifest's ``plans`` entry: one {quality, planned} record per
    memoized resolution, dataclass fields in declaration order."""
    return [
        {"quality": dataclasses.asdict(q), "planned": dataclasses.asdict(p)}
        for q, p in plans.items()
    ]


def plans_from_list(entries: list) -> dict:
    return {QualitySpec(**e["quality"]): PlannedSpec(**e["planned"]) for e in entries}


def save_index(
    directory: str | os.PathLike,
    state: ALSHIndex,
    build_key,
    cfg: IndexConfig,
    update: UpdateSpec = UpdateSpec(),
    delta: DeltaSegment | None = None,
    tombstones: torch.Tensor | None = None,
    plans: dict | None = None,
    tuning: dict | None = None,
) -> str:
    """Write a self-describing index directory (format version 5); a
    ``build_key`` of None writes ``PORT_BUILT_KEY``. The payload commits
    first and ``index.json`` is replaced last."""
    directory = os.fspath(directory)
    if delta is None:
        delta = DeltaSegment.empty(cfg, update.delta_capacity, dtype=state.data.dtype)
    if tombstones is None:
        tombstones = torch.zeros((state.n + delta.capacity,), dtype=torch.bool)
    key = PORT_BUILT_KEY if build_key is None else np.asarray(build_key)
    leaves = {"build_key": key}
    for i, f in enumerate(_DELTA_FIELDS):
        leaves[f"delta/{i}"] = ckpt.host_copy(getattr(delta, f))
    leaves["delta/3"] = np.asarray(delta.fill, dtype=np.int32)
    leaves["state/0/0"] = ckpt.host_copy(state.tables.folded)
    leaves["state/0/1"] = ckpt.host_copy(state.tables.offsets)
    for i, f in enumerate(_STATE_FIELDS, start=1):
        leaves[f"state/{i}"] = ckpt.host_copy(getattr(state, f))
    if state.scales is not None:
        leaves["state/6"] = ckpt.host_copy(state.scales)
    leaves["tombstones"] = ckpt.host_copy(tombstones)
    os.makedirs(directory, exist_ok=True)
    ckpt.save_checkpoint(directory, 0, leaves)
    codec = get_codec(cfg.storage)
    meta = {
        "format": FORMAT,
        "version": VERSION,
        "config": config_to_dict(cfg),
        "update": update_to_dict(update),
        "codec": {
            "storage": codec.name,
            "dtype": dtype_name(codec.dtype),
            "bytes_per_value": codec.bytes_per_value,
            "scaled": codec.scaled,
        },
        "segments": [
            {"kind": "main", "rows": int(state.n), "sealed": True},
            {
                "kind": "delta",
                "capacity": int(delta.capacity),
                "fill": int(delta.fill),
                "sealed": False,
            },
        ],
        "tombstone_count": int(leaves["tombstones"].sum()),
        "plans": plans_to_list(plans or {}),
        "tuning": tuning,
    }
    tmp = os.path.join(directory, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
        f.write("\n")
    os.replace(tmp, os.path.join(directory, _META))
    return directory


def load_index(directory: str | os.PathLike, device):
    """Restore (state, build_key, config, update, delta, tombstones, plans,
    tuning) from a directory alone, every tensor on ``device``;
    ``build_key`` stays a numpy array, ``plans`` a dict ``QualitySpec ->
    PlannedSpec``."""
    directory = os.fspath(directory)
    meta_path = os.path.join(directory, _META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{directory!r} is not a repro.api index directory (no {_META}); "
            "was it written by Index.save()?"
        )
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{meta_path} has format {meta.get('format')!r}, expected {FORMAT!r}"
        )
    version = meta.get("version")
    if version not in _READABLE_VERSIONS:
        raise ValueError(
            f"{meta_path} is format version {version!r}; this build reads "
            f"versions {_READABLE_VERSIONS} — migrate the directory or upgrade"
        )
    cfg = config_from_dict(meta["config"])
    step = ckpt.latest_step(directory)
    if step is None:
        raise FileNotFoundError(
            f"no committed checkpoint step under {directory!r} (aborted save?)"
        )
    leaves = ckpt.restore_checkpoint(
        directory, step, _leaf_names(get_codec(cfg.storage).scaled, version >= 2)
    )
    state = ALSHIndex(
        tables=PrefixTables(ckpt.leaf_tensor(leaves["state/0/0"]).to(device),
                            ckpt.leaf_tensor(leaves["state/0/1"]).to(device)),
        scales=ckpt.leaf_tensor(leaves["state/6"]).to(device) if "state/6" in leaves else None,
        **{f: ckpt.leaf_tensor(leaves[f"state/{i}"]).to(device)
           for i, f in enumerate(_STATE_FIELDS, 1)},
    )
    if version >= 2:
        update = update_from_dict(meta["update"])
        delta = DeltaSegment(
            *(ckpt.leaf_tensor(leaves[f"delta/{i}"]).to(device) for i in range(3)),
            fill=leaves["delta/3"].item(),
        )
        tombstones = ckpt.leaf_tensor(leaves["tombstones"]).to(device)
    else:  # pre-lifecycle directory: immutable, no delta, nothing deleted
        update = UpdateSpec()
        delta = DeltaSegment.empty(cfg, 0, dtype=state.data.dtype, device=device)
        tombstones = torch.zeros((state.n,), dtype=torch.bool, device=device)
    _check_consistent(state, delta, tombstones, cfg, update, meta, meta_path)
    plans = plans_from_list(meta.get("plans", [])) if version >= 3 else {}
    tuning = meta.get("tuning") if version >= 4 else None
    return state, leaves["build_key"], cfg, update, delta, tombstones, plans, tuning


def _check_consistent(
    state: ALSHIndex,
    delta: DeltaSegment,
    tombstones: torch.Tensor,
    cfg: IndexConfig,
    update: UpdateSpec,
    meta: dict,
    meta_path: str,
) -> None:
    """Reject directories whose manifest and payload disagree (a torn
    overwrite with another geometry or another codec), with the
    reference's messages."""
    n = state.data.shape[0]
    cap = delta.capacity
    codec = get_codec(cfg.storage)
    want_dtype = dtype_name(codec.dtype)
    for leaf, dtype in (("data", state.data.dtype), ("delta.data", delta.data.dtype)):
        if dtype != codec.dtype:
            raise ValueError(
                f"{meta_path} declares storage={cfg.storage!r} (payload dtype "
                f"{want_dtype}) but the stored {leaf} array is {dtype_name(dtype)} — the "
                f"directory mixes codecs (torn overwrite or hand-edited "
                f"manifest); re-save the index"
            )
    if codec.scaled:
        if state.scales is None or tuple(state.scales.shape) != (cfg.d,):
            got = None if state.scales is None else tuple(state.scales.shape)
            raise ValueError(
                f"{meta_path} declares the scaled codec {cfg.storage!r} but "
                f"the stored decode scales are {got} (need ({cfg.d},)) — "
                f"the scale leaf is missing or truncated; re-save the index"
            )
    elif state.scales is not None:
        raise ValueError(
            f"{meta_path} declares the unscaled codec {cfg.storage!r} but the "
            f"payload carries a decode-scale leaf — the directory mixes "
            f"codecs; re-save the index"
        )
    mcodec = meta.get("codec")
    if mcodec is not None and mcodec.get("storage") != cfg.storage:
        raise ValueError(
            f"{meta_path} codec entry says {mcodec.get('storage')!r} but the "
            f"config says storage={cfg.storage!r} — the manifest is "
            f"internally inconsistent; re-save the index"
        )
    want = {
        "tables.folded": ((cfg.n_hashes, cfg.d, cfg.M + 1), state.tables.folded.shape),
        "tables.offsets": ((cfg.n_hashes,), state.tables.offsets.shape),
        "mixers": ((cfg.L, cfg.K), state.mixers.shape),
        "sorted_keys": ((cfg.L, n), state.sorted_keys.shape),
        "perm": ((cfg.L, n + cfg.max_candidates), state.perm.shape),
        "data": ((n, cfg.d), state.data.shape),
        "levels": ((n, cfg.d), state.levels.shape),
        "delta.data": ((update.delta_capacity, cfg.d), delta.data.shape),
        "delta.levels": ((update.delta_capacity, cfg.d), delta.levels.shape),
        "delta.keys": ((cfg.L, update.delta_capacity), delta.keys.shape),
        "tombstones": ((n + cap,), tombstones.shape),
    }
    bad = {k: v for k, v in want.items() if tuple(v[1]) != v[0]}
    if bad:
        detail = "; ".join(
            f"{k}: stored {tuple(v[1])}, config implies {v[0]}" for k, v in bad.items()
        )
        raise ValueError(
            f"{meta_path} does not describe the stored arrays ({detail}) — "
            "the directory was probably partially overwritten; re-save the index"
        )
    if meta.get("version", 1) >= 2:
        seg = {s["kind"]: s for s in meta.get("segments", [])}
        fill = int(delta.fill)
        mseg = seg.get("delta", {})
        if (
            mseg.get("capacity") != cap
            or not (0 <= fill <= cap)
            or mseg.get("fill") != fill
        ):
            raise ValueError(
                f"{meta_path} segment manifest disagrees with the stored delta "
                f"(manifest capacity/fill {mseg.get('capacity')}/{mseg.get('fill')}, "
                f"stored {cap}/{fill}) — the directory was probably partially "
                "overwritten; re-save the index"
            )
        if seg.get("main", {}).get("rows") != n:
            raise ValueError(
                f"{meta_path} segment manifest says {seg.get('main', {}).get('rows')} "
                f"main rows but the payload stores {n} — re-save the index"
            )
