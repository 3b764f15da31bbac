"""Lookup-table checkpointing: save and resume traced-ray tables.

The counterpart of `light_path_tracer_tpu.checkpoint`, in two layers:

  * Whole-table cache: the per-pixel (final_alpha float32, winding uint16)
    tables of a frame, keyed by every input that affects them
    (`cache_key`), so a re-render with another background image skips the
    trace (`cached_precompute`). The key is the JAX package's hash over
    the same payload (the two packages' SceneConfig and RenderConfig have
    the same fields), and the `.npz` layout is its layout (final_alpha
    float32, winding uint16, meta as JSON): a lookup file written by
    either package loads in the other.
  * Chunk-level resume: with `resume=True` (needs cfg.chunk_size) each
    completed trace chunk is written as it finishes (`ChunkStore`, one
    `.npz` a chunk by an atomic os.replace), so an interrupted precompute
    resumes from its last completed chunk.

Render sessions (`save_session` / `load_session`) write the tables
through torch.distributed.checkpoint, PyTorch's counterpart of the JAX
package's orbax StandardCheckpointer (one process, no process group),
beside the JAX package's `session.json`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import warnings

import numpy as np
import torch

from light_path_tracer_tpu_torch.ops.types import TraceResult
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

CACHE_VERSION = 2

# RenderConfig knobs that cannot change the traced tables: scheduling and
# verbosity (chunk boundaries do not change the assembled result) and the
# renderer-only wrap. Everything else stays in the key.
_RESULT_IRRELEVANT_KNOBS = frozenset({
    "render_loop_around",
    "progress",
    "chunk_size",
    "sort_by_difficulty",
})


def cache_key(scene: SceneConfig, cfg: RenderConfig, image_dimension,
              fov) -> str:
    """Deterministic key over everything that affects the traced tables:
    the JAX package's sha256 over the same JSON payload, first 16 hex."""
    payload = {
        "v": CACHE_VERSION,
        "scene": dataclasses.asdict(scene),
        "render": {k: v for k, v in dataclasses.asdict(cfg).items()
                   if k not in _RESULT_IRRELEVANT_KNOBS},
        "dim": list(image_dimension),
        "fov": [float(f) for f in fov],
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def cache_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"lookup_{key}.npz")


def _numpy(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.uint16:      # NumPy conversion needs int32
            x = x.to(torch.int32)
        x = x.numpy()
    return np.asarray(x).astype(dtype, copy=False)


def save_lookup(path: str, final_alpha, winding, meta: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        final_alpha=_numpy(final_alpha, np.float32),
        winding=_numpy(winding, np.uint16),
        meta=json.dumps(meta or {}))


def load_lookup(path: str, device="cpu"):
    """Returns (final_alpha, winding, meta) with the tables as tensors on
    `device` (float32, uint16), or None if the file is absent or
    corrupt."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            fa = torch.from_numpy(np.asarray(z["final_alpha"], np.float32))
            w = torch.from_numpy(np.asarray(z["winding"], np.uint16))
            meta = json.loads(str(z["meta"]))
        return fa.to(device), w.to(device), meta
    except Exception:
        return None


class ChunkStore:
    """On-disk store of completed trace chunks, keyed by chunk start index.

    ops/batch.trace_batch asks the store for each chunk before tracing it
    and puts each traced chunk into it as it completes (one small .npz a
    chunk, written to a temporary name and renamed, so a kill mid-write
    never leaves a corrupt chunk). A chunk is identified by the trace
    parameters' key and its start index; trace_batch's difficulty sort is
    deterministic, so a resumed run re-derives identical chunk contents.
    `get` returns the chunk on the CPU; trace_batch moves it to the rays'
    device.
    """

    def __init__(self, directory: str, key: str):
        self.directory = directory
        self.key = key
        os.makedirs(directory, exist_ok=True)

    def _path(self, start: int) -> str:
        return os.path.join(self.directory,
                            f"chunks_{self.key}_{start}.npz")

    def get(self, start: int):
        path = self._path(start)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                return TraceResult(
                    torch.from_numpy(z["final_alpha"]),
                    torch.from_numpy(z["n_half_orbits"]),
                    torch.from_numpy(z["status"]),
                    torch.tensor(int(z["n_steps"]), dtype=torch.int64))
        except Exception:
            return None

    def put(self, start: int, res: TraceResult):
        path = self._path(start)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:   # a file object: savez keeps the name
            np.savez(f,
                     final_alpha=res.final_alpha.cpu().numpy(),
                     n_half_orbits=res.n_half_orbits.cpu().numpy(),
                     status=res.status.cpu().numpy(),
                     n_steps=np.asarray(int(res.n_steps), np.int64))
        os.replace(tmp, path)

    def chunk_starts(self):
        """Start indices of all completed chunks on disk."""
        prefix = f"chunks_{self.key}_"
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(prefix) and name.endswith(".npz"):
                try:
                    out.append(int(name[len(prefix):-4]))
                except ValueError:
                    pass
        return sorted(out)

    def clear(self):
        for start in self.chunk_starts():
            try:
                os.remove(self._path(start))
            except OSError:
                pass


def cached_precompute(scene: SceneConfig, cfg: RenderConfig,
                      image_dimension, fov, cache_dir: str = "lookup_cache",
                      resume: bool = False, device="cuda"):
    """precompute_final_alpha with transparent on-disk caching.

    resume=True (needs cfg.chunk_size) also keeps every completed chunk
    on disk, so an interrupted run restarts from its last completed
    chunk; the chunk files are removed once the whole table is saved.
    A hit loads the tables onto `device`.

    Returns (PrecomputeResult, hit: bool).
    """
    from light_path_tracer_tpu_torch.pipeline import (
        PrecomputeResult, precompute_final_alpha)

    key = cache_key(scene, cfg, image_dimension, fov)
    path = cache_path(cache_dir, key)
    hit = load_lookup(path, device)
    if hit is not None:
        fa, w, meta = hit
        if tuple(fa.shape) == tuple(image_dimension):
            return PrecomputeResult(
                fa, w, int(meta.get("total_rays", fa.numel())),
                int(meta.get("traced_rays", fa.numel())),
                torch.tensor(int(meta.get("integrator_steps", 0)),
                             dtype=torch.int64, device=device)), True

    store = None
    if resume:
        if cfg.chunk_size is None:
            raise ValueError("resume=True requires cfg.chunk_size")
        store = ChunkStore(cache_dir, key)

    pre = precompute_final_alpha(scene, cfg, image_dimension, fov,
                                 device=device, chunk_store=store)
    save_lookup(path, pre.final_alpha, pre.winding,
                dict(total_rays=pre.total_rays,
                     traced_rays=pre.traced_rays,
                     integrator_steps=pre.steps))
    if store is not None:
        store.clear()
    return pre, False


# ---- render sessions through torch.distributed.checkpoint ----

def _dcp(call, state, path):
    """dcp.save or dcp.load of `state` at `path` in this one process,
    without the warning that it assumes a single process."""
    import torch.distributed.checkpoint as dcp
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=".*assuming the intent is to .* in a single "
                              "process")
        getattr(dcp, call)(state, checkpoint_id=path)


def save_session(directory: str, scene: SceneConfig, cfg: RenderConfig,
                 pre, image_dimension, fov) -> str:
    """Persist a whole render session; returns its cache key.

    The traced tables go through torch.distributed.checkpoint into
    `<directory>/tables` (replacing a session there); the scene and render
    configuration and the cache key go beside them as `session.json`, the
    JAX package's layout, so a restore can check that it matches the
    requesting configuration. Complements the `.npz` whole-table cache
    (`cached_precompute`) where the artifact should be a durable,
    self-describing directory.
    """
    directory = os.path.abspath(directory)
    key = cache_key(scene, cfg, image_dimension, fov)
    state = {
        "final_alpha": torch.from_numpy(_numpy(pre.final_alpha,
                                               np.float32)),
        "winding": torch.from_numpy(_numpy(pre.winding, np.uint16)),
    }
    tables = os.path.join(directory, "tables")
    shutil.rmtree(tables, ignore_errors=True)
    os.makedirs(directory, exist_ok=True)
    _dcp("save", state, tables)
    meta = {
        "key": key,
        "scene": dataclasses.asdict(scene),
        "render": dataclasses.asdict(cfg),
        "dim": list(image_dimension),
        "fov": [float(f) for f in fov],
        "total_rays": int(pre.total_rays),
        "traced_rays": int(pre.traced_rays),
        "integrator_steps": int(pre.steps),
    }
    with open(os.path.join(directory, "session.json"), "w") as fh:
        json.dump(meta, fh, indent=2, sort_keys=True)
    return key


def load_session(directory: str, scene: SceneConfig | None = None,
                 cfg: RenderConfig | None = None,
                 image_dimension=None, fov=None, device="cpu"):
    """Restore a render session; returns (PrecomputeResult, meta), the
    tables on `device`.

    When scene/cfg/dim/fov are given, the stored cache key must match:
    a mismatch raises instead of serving another configuration's tables.
    """
    from light_path_tracer_tpu_torch.pipeline import PrecomputeResult

    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "session.json")) as fh:
        meta = json.load(fh)
    if scene is not None:
        if cfg is None or image_dimension is None or fov is None:
            raise ValueError(
                "key verification needs scene, cfg, image_dimension "
                "AND fov (or none of them for an unverified restore)")
        expect = cache_key(scene, cfg, image_dimension, fov)
        if expect != meta["key"]:
            raise ValueError(
                f"session key mismatch: stored {meta['key']}, "
                f"requested {expect} — the session was produced by a "
                f"different scene/render configuration")
    dim = tuple(int(d) for d in meta["dim"])
    # dcp.load fills tensors that already exist.
    state = {"final_alpha": torch.zeros(dim, dtype=torch.float32),
             "winding": torch.zeros(dim, dtype=torch.uint16)}
    _dcp("load", state, os.path.join(directory, "tables"))
    pre = PrecomputeResult(
        state["final_alpha"].to(device), state["winding"].to(device),
        meta["total_rays"], meta["traced_rays"],
        torch.tensor(int(meta["integrator_steps"]), dtype=torch.int64,
                     device=device))
    return pre, meta
